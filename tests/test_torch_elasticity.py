"""The port's elastic membership on the async-SSP tier: the reference's
scenarios of ``tests/test_elasticity.py`` against the port's service,
client and ``FaultProxy`` (admit at the anchor clock, idempotent admits,
re-admission past the seq mark, retire, one-shot rules, the 1 -> 3 -> 2
chaos scale, the worker driver's join and retire, member-keyed shards,
the counters), then the port's Engine resharding its data and the port's
``AsyncSSPTier`` following membership and admitting an elastic joiner.
"""

import socket
import threading
import time

import numpy as np
import pytest

from poseidon_tpu_torch.data.workload import (Shard, elastic_shard_indices,
                                              member_shard)
from poseidon_tpu_torch.parallel.async_ssp import (AsyncSSPClient,
                                                   ParamService,
                                                   run_async_ssp_worker)
from poseidon_tpu_torch.runtime.faults import FaultProxy, FaultRule

# tight knobs so every reconnect/eviction resolves in test time
FAST = dict(heartbeat_s=0.1, reconnect_deadline_s=5.0,
            backoff_base_s=0.01, backoff_cap_s=0.1)


def _zeros64(shape=(2, 2)):
    # float64 anchor: sums of DISTINCT powers of two (the test deltas) are
    # exact for exponents spanning < 53 bits, so the final anchor is a
    # bit-exact set-membership record of applied (worker, clock) pairs
    return {"fc": {"w": np.zeros(shape, np.float64)}}


def _delta(w, c, shape=(2, 2)):
    """The (worker, clock) increment: a unique power of two per pair."""
    assert 0 <= c < 16 and 0 <= w < 3
    return {"fc": {"w": np.full(shape, 2.0 ** (w * 16 + c), np.float64)}}


def _expected(pairs, shape=(2, 2)):
    total = sum(2.0 ** (w * 16 + c) for w, c in pairs)
    return np.full(shape, total, np.float64)


def _wait_for(pred, timeout_s=10.0, what="condition"):
    deadline = time.time() + timeout_s
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# --------------------------------------------------------------------------- #
# admit: rendezvous at the anchor clock
# --------------------------------------------------------------------------- #

def test_admit_new_worker_joins_at_anchor_clock():
    """A worker id outside n_workers joins mid-run: the service picks the
    join clock (min applied clock over live members), hands back anchor +
    clocks + member list, and the joiner's pushes apply exactly once from
    join_clock + 1. Both sides' gates run over the grown member set."""
    svc = ParamService(_zeros64(), n_workers=1, liveness_timeout_s=0.0)
    cli0 = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=1,
                          n_workers=1, **FAST)
    cli1 = None
    try:
        for c in range(3):
            cli0.gate(c, timeout_s=10.0)
            cli0.push(_delta(0, c))
        cli0._drain()
        assert svc.clocks[0] == 2

        cli1 = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=1,
                              n_workers=1, **FAST)
        cache, clocks = cli1.join()
        # rendezvous anchor clock = min live clock = w0's clock
        assert cli1.clock == 2 and cli1._acked_clock == 2
        assert clocks[1] == 2
        assert cli1.members == {0, 1}
        assert svc.members == {0, 1}
        assert svc.admissions == 1
        # the joiner's cache is the anchor: every applied increment visible
        np.testing.assert_array_equal(
            cache["fc"]["w"], _expected([(0, 0), (0, 1), (0, 2)]))

        # joiner contributes from join_clock + 1; exactly-once
        cli1.gate(3, timeout_s=10.0)
        cli1.push(_delta(1, 3))
        cli1._drain()
        assert svc.clocks[1] == 3 and svc.applied_seq[1] == 3
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"],
            _expected([(0, 0), (0, 1), (0, 2), (1, 3)]))

        # w0's next ack folds the new member into its gate view
        cli0.push(_delta(0, 3))
        cli0._drain()
        assert cli0.members == {0, 1}
        # gate within the window returns immediately for both
        assert cli0.gate(4, timeout_s=10.0) == 0.0
        assert cli1.gate(4, timeout_s=10.0) == 0.0
    finally:
        for c in (cli0, cli1):
            if c is not None:
                c.close()
        svc.close()


def test_admit_is_idempotent_for_existing_member():
    """join() by an id that is already a member degenerates to the rejoin
    pull: resume at the applied clock, no admissions bump — one join path
    serves fresh workers, restarts, and true admissions alike."""
    svc = ParamService(_zeros64(), n_workers=2, liveness_timeout_s=0.0)
    cli0 = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                          n_workers=2, **FAST)
    try:
        cli0.push(_delta(0, 0))
        cli0._drain()
        cache, clocks = cli0.join()
        assert cli0.clock == 0 and cli0._acked_clock == 0
        assert svc.admissions == 0
        assert svc.members == {0, 1}
        np.testing.assert_array_equal(cache["fc"]["w"],
                                      _expected([(0, 0)]))
    finally:
        cli0.close()
        svc.close()


def test_readmitted_id_resumes_past_its_seq_high_water_mark():
    """A previously retired id that is admitted again must resume its
    push-seq stream PAST everything it ever flushed — otherwise the
    exactly-once dedup would swallow its post-readmission flushes (the
    healthy-looking-but-contributing-nothing failure mode)."""
    svc = ParamService(_zeros64(), n_workers=2, liveness_timeout_s=0.0)
    cli1 = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=0,
                          n_workers=2, **FAST)
    try:
        for c in range(5):
            cli1.push(_delta(1, c))
        cli1.leave()
        assert svc.members == {0} and svc.retired == {1}
        cli1.close()

        # the same id comes back while the fleet idles at lower clocks
        cli1 = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=0,
                              n_workers=2, **FAST)
        cli1.join()
        # NOT the anchor min (worker 0 sits at -1): its own high-water mark
        assert cli1.clock == 4
        cli1.push(_delta(1, 5))
        cli1._drain()
        assert svc.applied_seq[1] == 5  # applied, not swallowed
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"],
            _expected([(1, c) for c in range(6)]))
    finally:
        cli1.close()
        svc.close()


# --------------------------------------------------------------------------- #
# retire: the slot leaves the gates
# --------------------------------------------------------------------------- #

def test_retire_removes_slot_from_gates():
    """After a deliberate departure the survivor's gate stops counting the
    retired slot IMMEDIATELY (no liveness timeout involved): a gate that
    the retired worker's frozen clock would violate unblocks as soon as
    the survivor's poll sees the shrunken member list."""
    svc = ParamService(_zeros64(), n_workers=2, liveness_timeout_s=0.0)
    cli0 = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                          n_workers=2, **FAST)
    cli1 = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=0,
                          n_workers=2, **FAST)
    try:
        cli1.push(_delta(1, 0))
        cli1.leave()   # drains, then retires the slot
        assert svc.retired == {1} and svc.members == {0}

        for c in range(4):
            cli0.push(_delta(0, c))
        # s=0, clock 4: needs every OTHER member at >= 3; worker 1 is
        # frozen at 0, so pre-retire this would block to the timeout
        waited = cli0.gate(4, poll_s=0.01, timeout_s=5.0)
        assert waited < 2.0, f"gate did not unblock on retirement: {waited}"
        assert 1 not in cli0.members
    finally:
        cli0.close()
        cli1.close()
        svc.close()


# --------------------------------------------------------------------------- #
# one-shot nth fault rule
# --------------------------------------------------------------------------- #

def test_one_shot_nth_rule_fires_on_exactly_the_nth_match():
    """FaultRule(nth=N) fires on exactly the Nth connection passing its
    filters, then expires: earlier connections pass untouched, later ones
    too — the targeting primitive count-based rules cannot express."""
    # minimal echo upstream
    srv = socket.create_server(("127.0.0.1", 0))
    stop = threading.Event()

    def echo_loop():
        srv.settimeout(0.1)
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return

            def pump(c):
                try:
                    while True:
                        d = c.recv(1024)
                        if not d:
                            return
                        c.sendall(d)
                except OSError:
                    pass
                finally:
                    c.close()

            threading.Thread(target=pump, args=(conn,), daemon=True).start()

    threading.Thread(target=echo_loop, daemon=True).start()
    proxy = FaultProxy(srv.getsockname())
    rule = proxy.add_rule(FaultRule(action="drop", nth=2))
    try:
        outcomes = []
        for i in range(5):
            sk = socket.create_connection(proxy.addr, timeout=5.0)
            try:
                sk.sendall(b"ping")
                sk.settimeout(2.0)
                outcomes.append(sk.recv(4) == b"ping")
            except OSError:
                outcomes.append(False)
            finally:
                sk.close()
        # exactly the 3rd (0-based nth=2) connection died
        assert outcomes == [True, True, False, True, True], outcomes
        assert rule.expired and rule.hits == 1
        assert proxy.dropped == 1
    finally:
        stop.set()
        proxy.close()
        srv.close()


def test_one_shot_nth_rule_kills_admit_handshake_specifically():
    """Target the rejoin/admit handshake: after a partition, the FIRST
    redial carries the admit rendezvous — nth selects exactly it (the
    client's earlier setup dials already consumed indices 0 and 1, which
    conn=/max_conns= rules would need to predict). The client's backoff
    absorbs the kill and the admission still lands exactly once."""
    svc = ParamService(_zeros64(), n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    # heartbeats off: the only post-sever connection is join()'s redial,
    # so the accepted-connection order is fully deterministic
    opts = dict(FAST, heartbeat_s=0.0)
    cli1 = AsyncSSPClient(1, proxy.addr, staleness=1, n_workers=1, **opts)
    try:
        rule = proxy.add_rule(FaultRule(action="drop", nth=0))
        # rule armed AFTER setup: nth counts from here — the next dial IS
        # the admit handshake's reconnect
        assert proxy.sever_all() == 2
        cache, _ = cli1.join()   # pull channel dead -> redial (killed once)
        assert rule.expired and proxy.dropped == 1
        assert svc.admissions == 1          # exactly once, despite the kill
        assert svc.members == {0, 1}
        assert cli1.clock == -1             # fresh job: anchor clock -1
        cli1.push(_delta(1, 0))
        cli1._drain()
        assert svc.applied_seq[1] == 0
    finally:
        cli1.close()
        proxy.close()
        svc.close()


# --------------------------------------------------------------------------- #
# THE acceptance scenario: 1 -> 3 -> 2 under chaos
# --------------------------------------------------------------------------- #

def test_chaos_scale_1_3_2_exactly_once_with_fixed_membership_replay():
    """Scale a live async-SSP job 1 -> 3 -> 2 through the FaultProxy, with
    a one-shot nth kill of worker 2's first dial and a full mid-run
    partition (sever_all) thrown in. Acceptance properties, all pinned
    bit-exactly because every (worker, clock) delta is a distinct power
    of two:

    - every clock applied exactly once (the anchor sum IS the applied
      set; a dup or drop changes it);
    - no SSP gate deadlock across admissions and the retirement (every
      gate completes within its timeout, and the post-shrink gates that
      worker 1's frozen clock WOULD have violated unblock);
    - loss continuity: each worker's per-clock losses are the expected
      unbroken sequence across every membership change;
    - final params identical to a fixed-membership (3-worker) service fed
      the same dispatched step sequence — bitwise."""
    s = 2
    svc = ParamService(_zeros64(), n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    losses = {0: [], 1: [], 2: []}
    clis = {}

    def step(w, cli, c):
        """One clock for worker w: gate, 'train' (record the loss), push
        the (w, c) increment. Returns the gate wait."""
        waited = cli.gate(c, timeout_s=20.0)
        losses[w].append(float(c))     # deterministic 'loss' = the clock
        cli.push(_delta(w, c))
        return waited

    try:
        # ---- phase 1: one worker, clocks 0..3 --------------------------- #
        clis[0] = AsyncSSPClient(0, proxy.addr, staleness=s, n_workers=1,
                                 **FAST)
        for c in range(4):
            step(0, clis[0], c)
        clis[0]._drain()

        # ---- scale up 1 -> 3: admit w1 then w2 -------------------------- #
        clis[1] = AsyncSSPClient(1, proxy.addr, staleness=s, n_workers=1,
                                 **FAST)
        cache1, _ = clis[1].join()
        assert clis[1].clock == 3                 # the anchor clock
        np.testing.assert_array_equal(
            cache1["fc"]["w"], _expected([(0, c) for c in range(4)]))

        # chaos: kill w2's very first dial (its next accepted connection)
        kill = proxy.add_rule(FaultRule(action="drop", nth=0))
        clis[2] = AsyncSSPClient(2, proxy.addr, staleness=s, n_workers=1,
                                 **FAST)
        cache2, _ = clis[2].join()
        assert kill.expired and proxy.dropped >= 1
        assert clis[2].clock == 3
        assert svc.admissions == 2
        assert svc.members == {0, 1, 2}

        # ---- phase 2: three workers, clocks 4..6 ------------------------ #
        for c in range(4, 7):
            for w in (0, 1, 2):
                step(w, clis[w], c)
            if c == 5:
                # chaos: full mid-run partition; every channel reconnects
                # and replays, the seq dedup keeps the applied set exact
                proxy.sever_all()

        # ---- scale down 3 -> 2: w1 departs deliberately ----------------- #
        clis[1].leave()
        assert svc.retired == {1}
        assert svc.members == {0, 2}

        # ---- phase 3: two workers, clocks 7..11 ------------------------- #
        # w1 froze at clock 6; by clock 10 (> 6 + s + 1) its slot would
        # deadlock every gate were it still a member
        for c in range(7, 12):
            for w in (0, 2):
                waited = step(w, clis[w], c)
                assert waited < 15.0
        clis[0].mark_done()
        clis[2].mark_done()

        # ---- acceptance: exactly-once, spread bound, loss continuity ---- #
        applied = ([(0, c) for c in range(12)]
                   + [(1, c) for c in range(4, 7)]
                   + [(2, c) for c in range(4, 12)])
        np.testing.assert_array_equal(svc.anchor["fc"]["w"],
                                      _expected(applied))
        assert svc.max_spread <= s + 1
        assert losses[0] == [float(c) for c in range(12)]
        assert losses[1] == [4.0, 5.0, 6.0]
        assert losses[2] == [float(c) for c in range(4, 12)]
        done, failed = clis[0].wait_all_done(None, timeout_s=10.0)
        assert done == {0, 2} and not failed

        # ---- fixed-membership replay of the same dispatched sequence ---- #
        svc2 = ParamService(_zeros64(), n_workers=3, liveness_timeout_s=0.0)
        replay = {w: AsyncSSPClient(w, ("127.0.0.1", svc2.port), staleness=s,
                                    n_workers=3, **FAST) for w in (0, 1, 2)}
        try:
            for w, cli in replay.items():
                start = {0: 0, 1: 4, 2: 4}[w]
                cli.clock = start - 1
                cli._acked_clock = start - 1
                end = {0: 12, 1: 7, 2: 12}[w]
                for c in range(start, end):
                    cli.push(_delta(w, c))
                cli._drain()
            np.testing.assert_array_equal(svc2.anchor["fc"]["w"],
                                          svc.anchor["fc"]["w"])
        finally:
            for cli in replay.values():
                cli.close()
            svc2.close()
    finally:
        for cli in clis.values():
            cli.close()
        proxy.close()
        svc.close()


def test_worker_driver_join_and_retire_modes():
    """run_async_ssp_worker's elastic modes: join=True rendezvous via
    admit and trains from join_clock + 1; retire_at_clock scales down
    cleanly (drain + retire, survivors keep training)."""
    svc = ParamService(_zeros64(), n_workers=1, liveness_timeout_s=0.0)
    opts = dict(heartbeat_s=0.1, reconnect_deadline_s=5.0,
                backoff_base_s=0.01, backoff_cap_s=0.05)

    def local_step(w):
        def f(cache, it):
            out = {l: {p: v + _delta(w, it % 16)[l][p] for p, v in
                       ps.items()} for l, ps in cache.items()}
            return out, float(it)
        return f

    cli0 = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=4,
                          n_workers=1, **opts)
    try:
        for c in range(3):
            cli0.gate(c, timeout_s=10.0)
            cli0.push(_delta(0, c))
        cli0._drain()

        out = run_async_ssp_worker(
            1, 1, _zeros64(), local_step(1), n_clocks=7, staleness=4,
            service_addr=("127.0.0.1", svc.port), join=True,
            retire_at_clock=5, client_opts=opts)
        # joined at anchor clock 2 -> trained clocks 3..5, then retired
        assert out["start_clock"] == 3
        assert out["retired"] is True
        assert out["losses"] == [3.0, 4.0, 5.0]
        assert svc.retired == {1} and svc.members == {0}
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"],
            _expected([(0, 0), (0, 1), (0, 2),
                       (1, 3), (1, 4), (1, 5)]))
        cli0.mark_done()
    finally:
        cli0.close()
        svc.close()


# --------------------------------------------------------------------------- #
# resharded data assignment: keyed by (member list, epoch)
# --------------------------------------------------------------------------- #

def test_elastic_shard_partitions_cleanly_across_1_3_2():
    """For every membership of a 1 -> 3 -> 2 scale sequence the shards are
    disjoint and cover [0, n); the epoch permutation is shared (keyed by
    epoch, membership-independent), so a scale event re-cuts the SAME
    permutation into the new number of ranges."""
    n = 101
    for members in ([0], [0, 1, 2], [0, 2]):
        for epoch in (0, 3):
            parts = [elastic_shard_indices(n, w, members, epoch=epoch)
                     for w in members]
            flat = np.concatenate(parts)
            assert len(flat) == n
            assert set(flat.tolist()) == set(range(n)), \
                f"members={members} epoch={epoch} does not cover [0, n)"
    # position-in-sorted-list mapping: worker 2 is the SECOND of {0, 2}
    assert member_shard([0, 2], 2) == Shard(1, 2)
    assert member_shard([0, 1, 2], 1) == Shard(1, 3)
    # membership sets (not launch ranks) key the cut: {5, 9} works too
    assert member_shard({9, 5}, 9) == Shard(1, 2)
    with pytest.raises(ValueError):
        member_shard([0, 2], 1)
    # epoch keying: different epochs permute differently, same cover
    e0 = elastic_shard_indices(n, 0, [0, 1], epoch=0)
    e1 = elastic_shard_indices(n, 0, [0, 1], epoch=1)
    assert not np.array_equal(e0, e1)


# --------------------------------------------------------------------------- #
# membership telemetry export
# --------------------------------------------------------------------------- #

def test_membership_counters_export_and_format():
    """ParamService churn counters surface through comm_stats (the
    engine's display + stats.yaml path) — no log-grepping required."""
    from poseidon_tpu_torch.runtime.comm_stats import (format_membership,
                                                       membership_counters)

    svc = ParamService(_zeros64(), n_workers=1, liveness_timeout_s=0.0)
    cli1 = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=0,
                          n_workers=1, **FAST)
    try:
        cli1.join()
        c = membership_counters(service=svc)
        assert c["admissions"] == 1.0
        assert c["members"] == 2.0
        assert c["evictions"] == 0.0 and c["rejoins"] == 0.0
        assert c["retired"] == 0.0
        line = format_membership(c)
        assert "admissions = 1" in line and "members = 2" in line

        cli1.leave()
        c = membership_counters(service=svc)
        assert c["members"] == 1.0 and c["retired"] == 1.0

        # client-side view (every non-zero rank)
        cc = membership_counters(client=cli1)
        assert cc["members"] == 1.0 and "reconnects" in cc
    finally:
        cli1.close()
        svc.close()


# --------------------------------------------------------------------------- #
# the port's Engine and tier
# --------------------------------------------------------------------------- #

_SMALLNET = """
name: "ElasticNet"
layers { name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 1 height: 12 width: 12 } }
layers { name: "ip1" type: INNER_PRODUCT bottom: "data" top: "ip1"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""


def _memory_data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(n, 1, 12, 12).astype(np.float32),
            "label": rs.randint(0, 5, n)}


def _small_engine(tmp_path, **kw):
    from poseidon_tpu_torch.proto.messages import (SolverParameter,
                                                   load_net_from_string)
    from poseidon_tpu_torch.runtime.engine import Engine
    sp = SolverParameter(train_net_param=load_net_from_string(_SMALLNET),
                         base_lr=0.01, lr_policy="fixed", momentum=0.9,
                         display=0, max_iter=kw.pop("max_iter", 4),
                         random_seed=3)
    return Engine(sp, memory_data=_memory_data(), device="cpu",
                  output_dir=str(tmp_path), **kw)


def test_engine_reshard_data_rebuilds_pipelines(tmp_path):
    """reshard_data re-keys the TRAIN assignment mid-run: pipelines are
    rebuilt against the new contiguous range and training keeps going."""
    eng = _small_engine(tmp_path, max_iter=2)
    try:
        eng.train()
        old_pipes = list(eng.train_pipelines)
        assert eng._data_shard == Shard(0, 1)
        assert eng.reshard_data(Shard(0, 2)) is True
        assert eng._data_shard == Shard(0, 2)
        assert eng.train_pipelines[0] is not old_pipes[0]
        assert eng.reshard_data(Shard(0, 2)) is False   # no-op on same
        eng.train(max_iter=4)   # two more iterations on the new shard
        assert eng.iteration() == 4
    finally:
        eng.close()


def test_tier_membership_change_reshards_engine(monkeypatch):
    """An admission lands, and the NEXT flush reshards the engine's data
    by the grown member list; a retirement re-cuts it back."""
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier
    from test_torch_faults import _tier_engine, _tier_env, _tier_step

    _tier_env(monkeypatch, 0, 1)
    resharded = []
    step = _tier_step({"fc": {"w": np.zeros((2, 2), np.float32)}})
    eng = _tier_engine(step, reshard_data=resharded.append)
    tier = AsyncSSPTier(step, staleness=50, service_port=0)
    joiner = None
    try:
        assert tier.data_shard() == Shard(0, 1)
        joiner = AsyncSSPClient(1, ("127.0.0.1", tier.service.port),
                                staleness=50, n_workers=1, **FAST)
        joiner.join()
        assert tier.service.admissions == 1
        tier.after_iters(eng, 1)
        assert resharded and resharded[-1] == Shard(0, 2)
        assert tier.membership_counters()["admissions"] == 1.0
        joiner.leave()
        tier.after_iters(eng, 1)
        assert resharded[-1] == Shard(0, 1)
        tier.finish(eng)
    finally:
        if joiner is not None:
            joiner.close()
        if tier.service is not None:
            tier.service.close()


def test_joiner_tier_is_admitted_without_operator_action(monkeypatch):
    """A process launched with POSEIDON_PROC_ID >= POSEIDON_NUM_PROCS
    builds its tier, is ADMITTED at the anchor clock, finds the anchor in
    its arena, computes its member-keyed shard and flushes."""
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier
    from test_torch_faults import _tier_engine, _tier_env, _tier_step

    params = {"fc": {"w": np.zeros((2, 2), np.float32)}}
    svc = ParamService(params, n_workers=2, liveness_timeout_s=0.0)
    cli0 = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=50,
                          n_workers=2, **FAST)
    tier = None
    try:
        cli0.push({"fc": {"w": np.full((2, 2), 4.0, np.float32)}})
        cli0._drain()
        _tier_env(monkeypatch, 2, 2)
        step = _tier_step(params)
        tier = AsyncSSPTier(step, staleness=50, service_port=svc.port)
        assert svc.admissions == 1
        assert svc.members == {0, 1, 2}
        assert tier.client.clock == -1      # worker 1's -1: the anchor
        np.testing.assert_array_equal(step.flat_w.numpy(), 4.0)
        assert tier.data_shard() == Shard(2, 3)
        tier.after_iters(_tier_engine(step), 1)
        tier.client._drain()
        assert svc.applied_seq[2] == 0
    finally:
        if tier is not None:
            tier.client.close()
        cli0.close()
        svc.close()
