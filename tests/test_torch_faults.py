"""The port's fault tolerance on the async-SSP tier: the reference's
scenarios of ``tests/test_faults.py`` against the port's service, client,
``FaultProxy`` and retry policy (backoff, liveness eviction, exactly-once
replay, malformed frames contained, drop/truncate/sever/delay/throttle
rules, permanent failure surfacing, the chaos kill-and-rejoin), the port's
``AsyncSSPTier`` over a train step's arena (restart resumes the push
stream, the loop-flush cadence, the first gate's own timeout), and a
steady version of the sever-group atomicity check that reads the tagged
count under the proxy's lock.
"""

import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest

from poseidon_tpu_torch.parallel.async_ssp import (WIRE_CODEC_VERSION,
                                                   AsyncSSPClient,
                                                   ParamService, _recv_msg,
                                                   _send_msg,
                                                   run_async_ssp_worker)
from poseidon_tpu_torch.runtime.faults import FaultProxy, FaultRule
from poseidon_tpu_torch.runtime.retry import retry_with_backoff

# tight knobs so every reconnect/eviction resolves in test time
FAST = dict(heartbeat_s=0.1, reconnect_deadline_s=5.0,
            backoff_base_s=0.01, backoff_cap_s=0.1)


def _zeros_params(shape=(2, 2)):
    return {"fc": {"w": np.zeros(shape, np.float32)}}


def _one(shape=(2, 2)):
    return {"fc": {"w": np.ones(shape, np.float32)}}


def _counting_step(worker):
    def step(params, it):
        out = {l: {p: v + 1.0 for p, v in ps.items()}
               for l, ps in params.items()}
        return out, 0.0
    return step


def _wait_for(pred, timeout_s=10.0, what="condition"):
    deadline = time.time() + timeout_s
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# --------------------------------------------------------------------------- #
# retry helper
# --------------------------------------------------------------------------- #

def test_retry_with_backoff_policy():
    """Succeeds after transient failures; re-raises the LAST retryable
    error on deadline exhaustion; non-retryable errors propagate
    immediately (no sleep, no swallow)."""
    import random
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("not yet")
        return 42

    assert retry_with_backoff(flaky, deadline=5.0, base=0.001, cap=0.01,
                              rng=random.Random(0)) == 42
    assert len(calls) == 3

    def always() -> None:
        raise ConnectionRefusedError("down")

    t0 = time.monotonic()
    with pytest.raises(ConnectionRefusedError):
        retry_with_backoff(always, deadline=0.2, base=0.01, cap=0.05)
    assert time.monotonic() - t0 < 2.0

    def bug() -> None:
        raise ValueError("not transient")

    t0 = time.monotonic()
    with pytest.raises(ValueError):
        retry_with_backoff(bug, deadline=5.0)
    assert time.monotonic() - t0 < 1.0


# --------------------------------------------------------------------------- #
# service-side liveness / exactly-once / frame containment
# --------------------------------------------------------------------------- #

def test_gate_unblocks_after_liveness_eviction():
    """The acceptance property: a worker that hangs (socket open, no
    traffic) is evicted at the liveness timeout and the survivor's gate
    unblocks — where the reference would hang until the 120 s backstop."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=2, liveness_timeout_s=0.4)
    hung = socket.create_connection(("127.0.0.1", svc.port))
    try:
        _send_msg(hung, {"kind": "hello", "worker": 1})
        _recv_msg(hung)
        cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                             n_workers=2, **FAST)
        try:
            cli.push(_one())
            # s=0: gate(1) needs worker 1 at clock >= 0; it is hung at -1
            waited = cli.gate(1, timeout_s=30.0)
            assert 0.1 < waited < 10.0, waited
            assert 1 in cli.failed
            assert 1 in svc.failed_workers
            assert svc.evictions == 1
        finally:
            cli.close()
    finally:
        hung.close()
        svc.close()


def test_duplicate_push_applied_once():
    """A replayed flush whose ack was lost must not double-apply: the
    service dedups on the per-worker sequence number and acks the
    duplicate without touching the anchor."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    sk = socket.create_connection(("127.0.0.1", svc.port))
    try:
        _send_msg(sk, {"kind": "hello", "worker": 0})
        _recv_msg(sk)
        msg = {"kind": "push", "worker": 0, "clock": 0, "seq": 0,
               "delta": _one()}
        _send_msg(sk, msg)
        ack1 = _recv_msg(sk)
        _send_msg(sk, msg)          # the retry after a lost ack
        ack2 = _recv_msg(sk)
        assert ack1["dup"] is False
        assert ack2["dup"] is True
        np.testing.assert_allclose(svc.anchor["fc"]["w"], 1.0)
        assert svc.applied_seq[0] == 0
        assert svc.clocks[0] == 0
    finally:
        sk.close()
        svc.close()


def test_malformed_frames_do_not_kill_service():
    """A torn header, a mid-message EOF, and an undecodable payload each
    cost one connection and one logged counter — never the service: a
    well-behaved client keeps training through all three."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    try:
        # mid-message EOF: header promises 50 bytes, peer sends 10 and dies
        bad = socket.create_connection(("127.0.0.1", svc.port))
        bad.sendall(struct.pack("!Q", 50) + b"0123456789")
        bad.close()
        # undecodable payload: complete frame, garbage bytes
        bad2 = socket.create_connection(("127.0.0.1", svc.port))
        bad2.sendall(struct.pack("!Q", 4) + b"\x00\x01\x02\x03")
        bad2.close()
        # absurd length header (a stray HTTP probe, say)
        bad3 = socket.create_connection(("127.0.0.1", svc.port))
        bad3.sendall(b"GET / HT")
        bad3.close()
        _wait_for(lambda: svc.bad_frames >= 3, what="bad_frames >= 3")

        cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                             n_workers=1, **FAST)
        try:
            cli.push(_one())
            cli._drain()
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 1.0)
        finally:
            cli.close()
    finally:
        svc.close()


def test_bad_request_shape_is_contained():
    """A structurally-valid pickle with an unknown kind drops only its
    own connection (logged), not the per-connection thread's stack into
    the service."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    sk = socket.create_connection(("127.0.0.1", svc.port))
    try:
        _send_msg(sk, {"kind": "no-such-rpc", "worker": 0})
        _wait_for(lambda: svc.bad_frames >= 1, what="bad request counted")
        cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                             n_workers=1, **FAST)
        try:
            cli.push(_one())
            cli._drain()
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 1.0)
        finally:
            cli.close()
    finally:
        sk.close()
        svc.close()


# --------------------------------------------------------------------------- #
# fault-proxy scenarios (drop / truncate / sever / delay / partition)
# --------------------------------------------------------------------------- #

def test_proxy_drop_rule_exercises_connect_backoff():
    """drop: the first two dial attempts see accept-then-close; the
    client's backoff loop redials and lands the third — training output
    identical to a clean run."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    proxy.add_rule(FaultRule(action="drop", max_conns=2))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             retry_s=10.0, **FAST)
        try:
            cli.push(_one())
            cli._drain()
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 1.0)
            assert proxy.dropped == 2
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_proxy_truncated_frame_is_replayed_exactly_once():
    """truncate: the push channel is cut 12 bytes into the first PUSH
    frame. The service contains the torn frame (FrameError, logged, no
    crash); the client reconnects and replays; the seq dedup guarantees
    the anchor gets the increment exactly once."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    hello = pickle.dumps({"kind": "hello", "worker": 0},
                         protocol=pickle.HIGHEST_PROTOCOL)
    wire_neg = pickle.dumps({"kind": "wire", "codec": WIRE_CODEC_VERSION},
                            protocol=pickle.HIGHEST_PROTOCOL)
    # budget: the whole hello + codec-negotiation frames + 12 bytes —
    # deterministically inside the first push frame (conn 0 is the push
    # channel: it dials first)
    proxy.add_rule(FaultRule(action="truncate", conn=0,
                             after_bytes=len(hello) + 8
                             + len(wire_neg) + 8 + 12))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             **FAST)
        try:
            cli.push(_one())
            cli._drain(timeout_s=10.0)
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 1.0)
            assert svc.applied_seq[0] == 0
            assert svc.bad_frames >= 1      # the torn frame was seen+logged
            assert cli.reconnects >= 1
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_reconnect_after_sever_resumes_correct_values():
    """sever_all: a hard mid-run partition of every live connection. Both
    channels redial through the proxy; the un-acked flush replays; pull
    traffic resumes; parameter values are exactly a clean run's."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             **FAST)
        try:
            cli.push(_one())
            cli._drain()
            assert proxy.sever_all() >= 1
            cli.push(_one())            # hits the dead socket -> reconnect
            cli._drain(timeout_s=10.0)
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 2.0)
            assert svc.applied_seq[0] == 1
            assert cli.reconnects >= 1
            cache, clocks = cli.refresh()   # pull channel recovers too
            np.testing.assert_allclose(cache["fc"]["w"], 2.0)
            assert clocks[0] == 1
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_proxy_delay_slow_is_not_dead():
    """delay: a congested path adds latency to every chunk; heartbeats
    still flow, so the liveness monitor must NOT evict the slow-but-alive
    worker (slow != dead)."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.8)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    proxy.add_rule(FaultRule(action="delay", delay_s=0.05))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             **FAST)
        try:
            for _ in range(3):
                cli.push(_one())
            cli._drain(timeout_s=10.0)
            time.sleep(1.2)             # > liveness timeout of idle silence
            assert 0 not in svc.failed_workers
            assert svc.evictions == 0
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 3.0)
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_permanent_failure_surfaces_to_training_loop():
    """When the partition outlives the reconnect deadline the failure
    must reach the TRAINING LOOP as an exception — never a silently dead
    sender thread quietly dropping oplogs."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             heartbeat_s=0.05, reconnect_deadline_s=0.3,
                             backoff_base_s=0.01, backoff_cap_s=0.05)
        try:
            cli.push(_one())
            cli._drain()
            proxy.refuse_new()          # the partition persists...
            proxy.sever_all()           # ...and cuts every live channel
            cli.push(_one())            # sender hits the wall
            _wait_for(lambda: cli.dead is not None, timeout_s=10.0,
                      what="sender thread to surface permanent failure")
            with pytest.raises(RuntimeError, match="never applied"):
                cli.push(_one())
            with pytest.raises(RuntimeError):
                cli.gate(3)
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_drain_timeout_raises_never_swallows():
    """_drain expiry must RAISE: a quiet return would let mark_done()/
    close() declare the run complete while the final flush is still
    un-acked — silent update loss. (The sender here is mid-reconnect with
    a LONG deadline, so self.dead stays None and only the drain's own
    timeout can fire.)"""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             heartbeat_s=0.05, reconnect_deadline_s=30.0,
                             backoff_base_s=0.01, backoff_cap_s=0.05)
        try:
            cli.push(_one())
            cli._drain()
            proxy.refuse_new()
            proxy.sever_all()
            cli.push(_one())            # un-ackable while refused
            with pytest.raises(RuntimeError, match="un-acked"):
                cli._drain(timeout_s=0.5)
            proxy.refuse_new(False)     # lift: the replay lands after all
            cli._drain(timeout_s=10.0)
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 2.0)
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_refused_connections_do_not_consume_rule_budget():
    """Determinism: reconnect attempts landing inside a refuse_new window
    must burn neither a rule's max_conns budget nor its conn index — the
    conn=0 rule fires on the first FORWARDED connection after the window
    lifts, replay after replay."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    rule = proxy.add_rule(FaultRule(action="drop", conn=0, max_conns=1))
    proxy.refuse_new()
    try:
        for _ in range(3):              # retries inside the refusal window
            s = socket.create_connection(proxy.addr)
            assert s.recv(1) == b""     # refused: accept-then-close
            s.close()
        assert rule.hits == 0           # budget untouched
        proxy.refuse_new(False)
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=1,
                             **FAST)    # first dial eats the drop rule
        try:
            assert rule.hits == 1
            cli.push(_one())
            cli._drain()
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 1.0)
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_fault_config_defaults_resolve_into_service_and_client():
    """`config.set_fault_config` (the programmatic knob surface the
    ARCHITECTURE doc advertises) must be what None-valued constructor
    knobs resolve against, and must reject unknown knob names."""
    from poseidon_tpu_torch import config

    defaults = config.FaultConfig()
    config.set_fault_config(liveness_timeout_s=0.25, heartbeat_s=0.05)
    try:
        svc = ParamService(_zeros_params(), n_workers=1)
        try:
            assert svc.liveness_timeout_s == 0.25
            cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                                 n_workers=1)
            try:
                assert cli.heartbeat_s == 0.05
                assert cli.reconnect_deadline_s == \
                    defaults.reconnect_deadline_s
            finally:
                cli.close()
        finally:
            svc.close()
        with pytest.raises(AttributeError):
            config.set_fault_config(no_such_knob=1.0)
    finally:
        config.set_fault_config(
            heartbeat_s=defaults.heartbeat_s,
            liveness_timeout_s=defaults.liveness_timeout_s)


# --------------------------------------------------------------------------- #
# the end-to-end chaos scenario (acceptance criteria)
# --------------------------------------------------------------------------- #

def test_chaos_kill_one_of_three_mid_run_then_rejoin():
    """One of three workers is hard-dropped mid-run (sever + persistent
    refusal — the proxy-level SIGKILL): survivors' gates unblock via
    eviction and they complete all clocks; the victim's training loop
    gets the failure as an exception; a restarted process rejoins from
    the anchor and contributes its remaining clocks. Exactly-once apply
    makes the final anchor deterministic: every (worker, clock) pair
    lands exactly once — 3 workers x 12 clocks = 36 increments."""
    n, n_clocks = 3, 12
    params = _zeros_params()
    svc = ParamService(params, n_workers=n, liveness_timeout_s=0.6)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    opts = dict(heartbeat_s=0.1, reconnect_deadline_s=0.3,
                backoff_base_s=0.01, backoff_cap_s=0.05)
    results, errs = {}, {}

    def go(w, **kw):
        try:
            results[w] = run_async_ssp_worker(
                w, n, params, _counting_step(w), n_clocks, staleness=2,
                client_opts=opts, **kw)
        except Exception as e:  # noqa: BLE001 — the simulated process death
            errs[w] = e

    threads = {
        0: threading.Thread(target=go, args=(0,),
                            kwargs={"service": svc}),
        1: threading.Thread(target=go, args=(1,),
                            kwargs={"service": svc}),
        # the doomed worker routes through the proxy, slightly slow so the
        # cut lands mid-run
        2: threading.Thread(target=go, args=(2,),
                            kwargs={"service_addr": proxy.addr,
                                    "slow_s": 0.03}),
    }
    try:
        for t in threads.values():
            t.start()
        _wait_for(lambda: svc.clocks[2] >= 2, timeout_s=30.0,
                  what="worker 2 to apply a few clocks")
        proxy.refuse_new()
        proxy.sever_all()
        for t in threads.values():
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads.values())

        # survivors completed every clock — their gates excluded the
        # evicted worker instead of wedging on its frozen clock
        assert 0 in results and 1 in results, errs
        assert results[0]["final_clock"] == n_clocks - 1
        assert results[1]["final_clock"] == n_clocks - 1
        # the victim's loop got the failure as an exception
        assert isinstance(errs[2], (RuntimeError, OSError))
        assert 2 in svc.failed_workers
        applied = svc.clocks[2]
        assert 0 <= applied < n_clocks - 1

        # "restart the process": lift the partition, rejoin, finish
        proxy.refuse_new(False)
        res2 = run_async_ssp_worker(
            2, n, params, _counting_step(2), n_clocks, staleness=2,
            service_addr=proxy.addr, rejoin=True, client_opts=opts)
        assert res2["start_clock"] == applied + 1
        assert res2["final_clock"] == n_clocks - 1
        assert 2 not in svc.failed_workers
        assert svc.rejoins >= 1
        np.testing.assert_allclose(svc.anchor["fc"]["w"],
                                   np.full((2, 2), float(n * n_clocks)))
    finally:
        proxy.close()
        svc.close()


# --------------------------------------------------------------------------- #
# the port's tier over a train step's arena: restart, flush cadence, gates
# --------------------------------------------------------------------------- #


def _free_port():
    import socket as _socket

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tier_step(params):
    """A train step as the tier sees it: the arena of ``params`` (f32) and
    the flat parameter buffer it owns, on the CPU."""
    import types

    import torch

    from poseidon_tpu_torch.core.arena import ArenaLayout, ArenaSlot
    slots, off = [], 0
    for l, ps in params.items():
        for p, v in ps.items():
            n = int(np.asarray(v).size)
            slots.append(ArenaSlot(l, p, tuple(np.shape(v)), off, n, 1.0,
                                   1.0))
            off += n
    arena = ArenaLayout(slots, None)
    flat = torch.zeros(off)
    arena.pack({l: {p: torch.from_numpy(np.asarray(v, np.float32))
                    for p, v in ps.items()} for l, ps in params.items()},
               flat)
    return types.SimpleNamespace(arena=arena, flat_w=flat)


def _tier_engine(step, **kw):
    import types
    return types.SimpleNamespace(train_step=step, **kw)


def _tier_tree(step):
    """The step's parameters as numpy, by leaf."""
    return {l: {p: v.numpy().copy() for p, v in ps.items()}
            for l, ps in step.arena.unpack(step.flat_w).items()}


def _tier_env(monkeypatch, rank, world):
    monkeypatch.setenv("POSEIDON_PROC_ID", str(rank))
    monkeypatch.setenv("POSEIDON_NUM_PROCS", str(world))
    monkeypatch.delenv("POSEIDON_COORDINATOR", raising=False)
    monkeypatch.delenv("POSEIDON_ASYNC_SERVICE", raising=False)


def test_async_tier_restart_resumes_push_stream(monkeypatch):
    """A relaunched ``train --async_ssp`` process: a fresh tier resumes
    this worker's push-seq stream past the service's applied mark (a
    restart at seq 0 would have every flush swallowed by the dedup), and
    the anchor it joins at lands in the new step's arena."""
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier

    params = _zeros_params()
    svc = ParamService(params, n_workers=2, liveness_timeout_s=0.0)
    _tier_env(monkeypatch, 1, 2)
    try:
        step = _tier_step(params)
        tier = AsyncSSPTier(step, staleness=10, service_port=svc.port)
        try:
            assert tier.client.clock == -1          # nothing applied yet
            step.flat_w += 1.0
            tier.after_iters(_tier_engine(step), 1)  # clock 0 (seq 0)
            tier.client._drain()
            assert svc.applied_seq[1] == 0
        finally:
            # preemption: sockets torn down, no bye, no done
            tier.client._stop.set()
            tier.client._sender.join(timeout=5.0)
            tier.client._push_sock.close()
            tier.client._pull_sock.close()
        step2 = _tier_step(params)
        tier2 = AsyncSSPTier(step2, staleness=10, service_port=svc.port)
        try:
            assert tier2.client.clock == 0
            assert tier2.client._acked_clock == 0
            np.testing.assert_allclose(_tier_tree(step2)["fc"]["w"], 1.0)
            step2.flat_w += 1.0
            tier2.after_iters(_tier_engine(step2), 1)   # clock 1 (seq 1)
            tier2.client._drain()
            assert svc.applied_seq[1] == 1          # NOT deduped
            np.testing.assert_allclose(svc.anchor["fc"]["w"], 2.0)
        finally:
            tier2.client.close()
    finally:
        svc.close()


def test_after_iters_loop_flush_cadence(monkeypatch):
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier

    _tier_env(monkeypatch, 0, 1)
    step = _tier_step(_zeros_params())
    tier = AsyncSSPTier(step, staleness=10, sync_every=2,
                        service_port=_free_port())
    try:
        eng = _tier_engine(step)
        step.flat_w += 1.0
        assert tier.due(2) and not tier.due(1)
        # 5 iterations at sync_every=2 -> exactly 2 clocks, carry 1
        tier.after_iters(eng, 5)
        tier.client._drain()
        assert tier.client.clock == 1
        assert tier._iters_since == 1
        # the anchor saw the whole delta ONCE (second flush was empty)
        np.testing.assert_allclose(tier.service.anchor["fc"]["w"], 1.0)
        # one more iteration completes the next window -> clock 2
        tier.after_iters(eng, 1)
        tier.client._drain()
        assert tier.client.clock == 2
        assert tier._iters_since == 0
        # sub-window dispatches accumulate without flushing
        tier.after_iters(eng, 1)
        assert tier.client.clock == 2
        assert tier._iters_since == 1
        out = tier.finish(eng)
        assert out["async_final_clock"] == 3.0
        # three flushes carried the four clocks
        assert tier.timings["flushes"] == 3
    finally:
        if tier.service is not None:
            tier.service.close()


def test_tier_refresh_writes_the_arena_in_place(monkeypatch):
    """The flush reads the arena by one copy and writes the refreshed
    cache back into the SAME storage: the step's leaves (views of it)
    see the peers' updates with no new tensor; each phase is timed."""
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier

    params = _zeros_params()
    svc = ParamService(params, n_workers=2, liveness_timeout_s=0.0)
    _tier_env(monkeypatch, 1, 2)
    peer = None
    try:
        step = _tier_step(params)
        ptr = step.flat_w.data_ptr()
        leaf = step.arena.views(step.flat_w)[0]
        tier = AsyncSSPTier(step, staleness=10, service_port=svc.port)
        peer = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=10,
                              n_workers=2, **FAST)
        peer.push({"fc": {"w": np.full((2, 2), 2.0, np.float32)}})
        peer._drain()
        step.flat_w += 1.0
        tier.after_iters(_tier_engine(step), 1)
        assert step.flat_w.data_ptr() == ptr
        np.testing.assert_allclose(leaf.numpy(), 3.0)   # own 1 + peer 2
        assert tier.timings["flushes"] == 1
        assert all(tier.timings[k] >= 0.0 for k in
                   ("d2h_s", "push_s", "refresh_s", "gate_s", "h2d_s"))
        tier.client.close()
    finally:
        if peer is not None:
            peer.close()
        svc.close()


def test_first_clock_gate_survives_slow_building_peer(monkeypatch):
    """A peer still building its step at clock 0 must not time out a
    healthy run: the FIRST gate has its own, longer timeout; later gates
    use the configured backstop and fail fast."""
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier

    _tier_env(monkeypatch, 0, 2)
    params = _zeros_params()
    step = _tier_step(params)
    tier = AsyncSSPTier(step, staleness=0, sync_every=1,
                        service_port=_free_port(), gate_timeout_s=0.4,
                        first_gate_timeout_s=30.0)
    try:
        peer_err = []

        def slow_peer():
            try:
                cli = AsyncSSPClient(1, ("127.0.0.1", tier.client._addr[1]),
                                     staleness=0, n_workers=2)
                time.sleep(1.5)  # "building its step"
                cli.push({l: {p: np.zeros_like(v) for p, v in ps.items()}
                          for l, ps in params.items()})
                cli._drain()
                time.sleep(3.0)  # never reaches clock 1 in this test
                cli.close()
            except Exception as e:  # noqa: BLE001
                peer_err.append(e)

        t = threading.Thread(target=slow_peer, daemon=True)
        t.start()
        eng = _tier_engine(step)
        t0 = time.time()
        tier.after_iters(eng, 1)  # gate(1) needs peer clock >= 0
        assert time.time() - t0 >= 1.0, "the gate should have blocked"
        assert tier._gated_once
        t0 = time.time()
        with pytest.raises(TimeoutError):
            tier.after_iters(eng, 1)
        assert time.time() - t0 < 10.0
        t.join(timeout=10)
        assert not peer_err, peer_err
    finally:
        tier.client._stop.set()
        if tier.service is not None:
            tier.service.close()


def test_first_gate_timeout_default_scales_generously(monkeypatch):
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier

    _tier_env(monkeypatch, 0, 1)
    for gate, least in ((120.0, 1800.0), (600.0, 6000.0)):
        tier = AsyncSSPTier(_tier_step(_zeros_params()), staleness=0,
                            gate_timeout_s=gate, service_port=_free_port())
        try:
            assert tier.first_gate_timeout_s >= least
            assert tier.gate_timeout_s == gate
        finally:
            tier.client._stop.set()
            tier.service.close()


def test_service_address_resolution(monkeypatch):
    """host:port and tcp:// coordinators listen on port + 1 (JAX's rule);
    a file:// coordinator names no port and needs the env or the port;
    POSEIDON_ASYNC_SERVICE wins, and an explicit port replaces the
    port."""
    from poseidon_tpu_torch.runtime.async_tier import resolve_service_addr

    monkeypatch.delenv("POSEIDON_ASYNC_SERVICE", raising=False)
    assert resolve_service_addr("10.0.0.2:4000") == ("10.0.0.2", 4001)
    assert resolve_service_addr("tcp://h:4000") == ("h", 4001)
    assert resolve_service_addr(None) == ("127.0.0.1", None)
    assert resolve_service_addr("file:///s", service_port=9) == (
        "127.0.0.1", 9)
    with pytest.raises(ValueError, match="POSEIDON_ASYNC_SERVICE"):
        resolve_service_addr("file:///shared/store")
    monkeypatch.setenv("POSEIDON_ASYNC_SERVICE", "127.0.0.1:5100")
    assert resolve_service_addr("file:///shared/store") == (
        "127.0.0.1", 5100)
    assert resolve_service_addr("h:1", service_port=7) == ("127.0.0.1", 7)


# --------------------------------------------------------------------------- #
# bandwidth shaping: the throttle rule + delay billing granularity
# --------------------------------------------------------------------------- #

def _echo_server():
    """Loopback echo upstream for pure data-plane shaping tests."""
    srv = socket.create_server(("127.0.0.1", 0))

    def accept_loop():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return

            def serve(c=c):
                try:
                    while True:
                        d = c.recv(65536)
                        if not d:
                            return
                        c.sendall(d)
                except OSError:
                    pass
            threading.Thread(target=serve, daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    return srv


def _roundtrip(addr, payload: bytes) -> float:
    """Send payload through the proxy to the echo server and read it all
    back; returns elapsed seconds."""
    c = socket.create_connection(addr)
    try:
        t0 = time.monotonic()
        c.sendall(payload)
        got = 0
        while got < len(payload):
            chunk = c.recv(65536)
            if not chunk:
                raise AssertionError(f"connection cut at {got} bytes")
            got += len(chunk)
        return time.monotonic() - t0
    finally:
        c.close()


def test_throttle_rule_shapes_bandwidth_deterministically():
    """The token-bucket throttle: 250 kB through a 200 kB/s link with a
    50 kB burst must take >= (250-50)/200 = 1.0 s — and the same run
    again lands in the same envelope (deterministic shaping, not jitter).
    An unthrottled control through the same proxy machinery stays fast."""
    srv = _echo_server()
    try:
        control = FaultProxy(srv.getsockname())
        try:
            fast = _roundtrip(control.addr, b"x" * 250_000)
        finally:
            control.close()
        proxy = FaultProxy(srv.getsockname())
        proxy.add_rule(FaultRule(action="throttle", rate_bps=200_000,
                                 burst_bytes=50_000))
        try:
            walls = [_roundtrip(proxy.addr, b"x" * 250_000)
                     for _ in range(2)]
        finally:
            proxy.close()
        assert fast < min(walls), (fast, walls)
        for w in walls:
            # c2s pays (250-50)/200 >= 1.0 s; the echoed s2c direction has
            # its own bucket and overlaps, so the floor is one direction
            assert w >= 0.9, walls
    finally:
        srv.close()


def test_throttle_rule_rejects_zero_rate():
    with pytest.raises(ValueError, match="rate_bps"):
        FaultRule(action="throttle")


def test_delay_billing_per_frame_vs_per_chunk():
    """The delay-billing fix: one 1 MB wire frame crosses ~16 recv chunks,
    so the legacy per-chunk mode bills delay_s ~16x while per-frame bills
    it once — one rule now models the SAME latency for small and large
    frames. (Both directions carry the rule; the echo pays it twice.)"""
    srv = _echo_server()
    frame = struct.pack("!Q", 1_000_000) + b"y" * 1_000_000
    try:
        per_frame = FaultProxy(srv.getsockname())
        per_frame.add_rule(FaultRule(action="delay", delay_s=0.2,
                                     delay_per="frame"))
        try:
            w_frame = _roundtrip(per_frame.addr, frame)
        finally:
            per_frame.close()
        per_chunk = FaultProxy(srv.getsockname())
        per_chunk.add_rule(FaultRule(action="delay", delay_s=0.2))
        try:
            w_chunk = _roundtrip(per_chunk.addr, frame)
        finally:
            per_chunk.close()
    finally:
        srv.close()
    # per-frame: ~2 x 0.2 s (one per direction); per-chunk: >= 16 x 0.2 s
    # on the c2s direction alone. Upper bounds stay loose (a loaded CI
    # runner adds scheduling jitter); the per-chunk LOWER bound is the
    # load-immune half of the discrimination
    assert w_frame < 2.4, w_frame
    assert w_chunk > 3.0, w_chunk
    assert w_chunk > 1.25 * w_frame, (w_chunk, w_frame)


def test_delay_billing_once_per_connection():
    """delay_per='once': connection-setup latency — two frames through
    one connection pay delay_s once per direction, not per frame."""
    srv = _echo_server()
    try:
        proxy = FaultProxy(srv.getsockname())
        proxy.add_rule(FaultRule(action="delay", delay_s=0.3,
                                 delay_per="once"))
        try:
            frame = struct.pack("!Q", 100) + b"z" * 100
            c = socket.create_connection(proxy.addr)
            try:
                t0 = time.monotonic()
                for _ in range(3):
                    c.sendall(frame)
                    got = 0
                    while got < len(frame):
                        got += len(c.recv(65536))
                wall = time.monotonic() - t0
            finally:
                c.close()
        finally:
            proxy.close()
    finally:
        srv.close()
    # one 0.3 s bill per direction = ~0.6 s total, NOT 3 x 2 x 0.3 = 1.8
    # (bound loose enough for CI scheduling jitter, tight enough to catch
    # per-frame billing)
    assert wall < 1.5, wall


def test_delay_per_frame_models_small_and_large_frames_alike():
    """The motivating bug: under per-chunk billing a 100-byte frame and a
    1 MB frame saw wildly different injected latencies from ONE rule.
    Per-frame billing makes them equal (within scheduling noise)."""
    srv = _echo_server()
    try:
        proxy = FaultProxy(srv.getsockname())
        proxy.add_rule(FaultRule(action="delay", delay_s=0.25,
                                 delay_per="frame"))
        try:
            small = _roundtrip(proxy.addr, struct.pack("!Q", 100)
                               + b"a" * 100)
            big = _roundtrip(proxy.addr, struct.pack("!Q", 900_000)
                             + b"b" * 900_000)
        finally:
            proxy.close()
    finally:
        srv.close()
    # per-chunk billing would put big ~15 x 0.25 s ahead of small; per-
    # frame keeps them within scheduling noise (loose CI-safe bound)
    assert abs(big - small) < 1.2, (small, big)


# --------------------------------------------------------------------------- #
# group severing: kill a whole slice in one atomic event
# --------------------------------------------------------------------------- #

def test_sever_group_cuts_only_the_targeted_workers():
    """sever_group must cut EVERY connection of the targeted worker-id
    set (both the push and pull channels) and NONE of the others — the
    deterministic 'preempt one slice' event the fabric chaos suite is
    built on."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=3, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    clients = {}
    try:
        for w in range(3):
            clients[w] = AsyncSSPClient(w, proxy.addr, staleness=2,
                                        n_workers=3, **FAST)
            clients[w].push(_one())
        # every hello has crossed the proxy: all 6 pairs carry a tag
        _wait_for(lambda: sum(1 for p in proxy._pairs
                              if p.worker is not None) >= 6,
                  what="worker-tagged pairs")
        cut = proxy.sever_group({0, 1})
        assert cut == 4, cut           # 2 workers x (push + pull)
        # the survivor's channels still work end to end: a fresh push
        # on worker 2 is acked without any reconnect
        before = clients[2].reconnects
        clients[2].push(_one())
        _wait_for(lambda: clients[2]._acked_clock == clients[2].clock,
                  what="survivor push ack")
        assert clients[2].reconnects == before
        # the severed workers' clients REDIAL (new proxied pairs) and
        # replay their un-acked stream exactly once
        for w in (0, 1):
            clients[w].push(_one())
            _wait_for(lambda w=w: clients[w]._acked_clock
                      == clients[w].clock, what=f"worker {w} replay ack")
        assert dict(svc.clocks) == {0: 1, 1: 1, 2: 1}
    finally:
        for c in clients.values():
            c.close()
        proxy.close()
        svc.close()


def test_sever_group_is_atomic_and_ignores_unknown_ids():
    """The victim set is chosen under one lock acquisition: ids with no
    live tagged pairs cut nothing, an empty set cuts nothing, and the cut
    count is exactly the tagged count read under the proxy's lock (the
    pair list shrinks by it; no survivor is collateral damage)."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=2, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    try:
        cli = AsyncSSPClient(0, proxy.addr, staleness=0, n_workers=2,
                             **FAST)
        try:
            cli.push(_one())
            _wait_for(lambda: sum(1 for p in proxy._pairs
                                  if p.worker == 0) >= 2,
                      what="tagged pairs for worker 0")
            assert proxy.sever_group(set()) == 0
            assert proxy.sever_group({7, 8, 9}) == 0
            with proxy._lock:
                n_before = len(proxy._pairs)
                tagged = sum(1 for p in proxy._pairs if p.worker == 0)
            assert tagged >= 2
            assert proxy.sever_group({0}) == tagged
            with proxy._lock:
                assert len(proxy._pairs) == n_before - tagged
        finally:
            cli.close()
    finally:
        proxy.close()
        svc.close()


def test_sever_group_untagged_connections_never_match():
    """A connection whose first frame is not a worker hello stays
    untagged and must survive every sever_group call (None is never a
    member of the id set) — severing by slice only ever kills identified
    members."""
    srv = _echo_server()
    try:
        proxy = FaultProxy(srv.getsockname())
        try:
            c = socket.create_connection(proxy.addr)
            try:
                # a raw frame whose payload is not a pickled hello dict
                c.sendall(struct.pack("!Q", 5) + b"xxxxx")
                _wait_for(lambda: len(proxy._pairs) == 1,
                          what="pair registered")
                _wait_for(lambda: proxy._pairs[0].sniffed,
                          what="sniff to give up")
                assert proxy._pairs[0].worker is None
                assert proxy.sever_group({0, 1, 2}) == 0
                # the link still works after the no-op sever
                got = c.recv(65536)
                assert got  # echo came back
            finally:
                c.close()
        finally:
            proxy.close()
    finally:
        srv.close()
