"""The port's serving faults and shutdown against the JAX package's, on the
CPU: the counterparts of the batcher, wire, fault and shutdown tests of
``tests/test_serving.py`` that ``tests/test_torch_serving.py`` lacks.

Each scenario runs on the port's batcher, server, client, wire and
``runtime/faults.FaultProxy`` and, where it is deterministic, on JAX's
with the same inputs: the outcomes (replies, refusal messages and flags,
flushed batch sizes, counters) must be the same. The fault-proxy chaos
and the kill mid-request run on the port's stack only (JAX's chaos test
fails intermittently); their replies are held against JAX's executor on
the same rows. Replies of the two packages' executors (the same deploy
net, JAX's weights carried into the port) agree at rtol 1e-4, atol 1e-5,
the serving tolerance of ``tests/test_torch_serving.py``.

Every socket wait has its own limit: raw sockets time out after 5 s, and
each client call runs under ``_bounded``, which fails the test instead of
hanging the sweep.
"""

import pickle
import socket
import struct
import threading
import time
import types

import jax
import numpy as np
import pytest

import poseidon_tpu.proto.wire as jax_wire
import poseidon_tpu.runtime.faults as jax_faults
import poseidon_tpu.serving.batcher as jax_batcher
import poseidon_tpu.serving.client as jax_client
import poseidon_tpu.serving.server as jax_server
import poseidon_tpu_torch.proto.wire as port_wire
import poseidon_tpu_torch.runtime.faults as port_faults
import poseidon_tpu_torch.serving.batcher as port_batcher
import poseidon_tpu_torch.serving.client as port_client
import poseidon_tpu_torch.serving.server as port_server

RTOL, ATOL = 1e-4, 1e-5
CALL_S = 20.0          # the longest any one client call may take here

PKG = {
    "jax": types.SimpleNamespace(batcher=jax_batcher, server=jax_server,
                                 client=jax_client, faults=jax_faults,
                                 wire=jax_wire),
    "port": types.SimpleNamespace(batcher=port_batcher, server=port_server,
                                  client=port_client, faults=port_faults,
                                  wire=port_wire),
}

DEPLOY_NET = """
name: "servnet"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "fc" type: INNER_PRODUCT bottom: "conv" top: "fc"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
"""


@pytest.fixture(scope="module")
def executors():
    """The deploy net in both packages, the port's with JAX's weights."""
    from poseidon_tpu.core.net import Net as JaxNet
    from poseidon_tpu.proto.messages import load_net_from_string as jload
    from poseidon_tpu.serving.executor import \
        BucketedExecutor as JaxExecutor
    from poseidon_tpu_torch.core.net import Net, params_from_jax
    from poseidon_tpu_torch.proto.messages import load_net_from_string
    from poseidon_tpu_torch.serving.executor import BucketedExecutor

    jnet = JaxNet(jload(DEPLOY_NET), "TEST")
    jparams = jnet.init(jax.random.PRNGKey(7))
    net = Net(load_net_from_string(DEPLOY_NET), "TEST", device="cpu")
    params_from_jax(net, {l: {p: np.asarray(v) for p, v in d.items()}
                          for l, d in jparams.items()})
    return {"jax": JaxExecutor(jnet, jparams, buckets=(1, 2, 4)),
            "port": BucketedExecutor(net, buckets=(1, 2, 4))}


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 8, 8).astype(np.float32)


def _bounded(fn, timeout_s=CALL_S):
    """fn() on a daemon thread; its result, its exception re-raised, or a
    test failure after ``timeout_s`` (never a hang)."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        pytest.fail(f"call did not return within {timeout_s}s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _wait_for(cond, timeout_s=5.0, what=""):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _raw_socket(addr):
    sk = socket.create_connection(addr, timeout=5.0)
    sk.settimeout(5.0)
    return sk


def _dropped(sk) -> bool:
    """The server closed this connection (a clean FIN or a reset)."""
    try:
        return sk.recv(1) == b""
    except ConnectionError:
        return True


class FakeExecutor:
    """Duck-typed executor (JAX's test double): records flushed batch
    sizes, optionally stalls each call to hold the flush thread busy."""

    def __init__(self, max_batch=4, delay_s=0.0):
        self.input_names = ["x"]
        self.max_batch = max_batch
        self.delay_s = delay_s
        self.batch_rows = []
        self.calls = {max_batch: 0}
        self.rows_served = 0
        self.rows_padded = 0
        self.params_version = 0

    def validate_request(self, inputs):
        if "x" not in inputs:
            raise ValueError("request missing input 'x'")
        return int(np.shape(inputs["x"])[0])

    def infer(self, inputs):
        if self.delay_s:
            time.sleep(self.delay_s)
        rows = int(np.shape(inputs["x"])[0])
        self.batch_rows.append(rows)
        self.rows_served += rows
        self.calls[self.max_batch] += 1
        return {"y": np.asarray(inputs["x"], np.float32) * 2.0}


def _both(scenario):
    """The scenario's outcome on each package's stack."""
    return {side: scenario(PKG[side]) for side in ("jax", "port")}


# --------------------------------------------------------------------------- #
# batcher: flush triggers, backpressure, deadlines
# --------------------------------------------------------------------------- #

def test_batcher_flushes_on_size_trigger():
    """A full batch dispatches at once: with a 30 s deadline only the size
    trigger explains a fast flush; each caller gets its own rows."""
    def scenario(pkg):
        ex = FakeExecutor(max_batch=4)
        b = pkg.batcher.DynamicBatcher(ex, max_delay_s=30.0, max_queue=16)
        try:
            results = [None] * 4
            ts = [threading.Thread(
                target=lambda i=i: results.__setitem__(
                    i, b.submit({"x": np.full((1, 2), i, np.float32)},
                                timeout_s=CALL_S)), daemon=True)
                for i in range(4)]
            t0 = time.monotonic()
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=10.0)
            waited = time.monotonic() - t0
            return {"fast": waited < 5.0,
                    "results": [r["y"].tolist() for r in results],
                    "largest_batch": max(ex.batch_rows)}
        finally:
            b.close()

    out = _both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["fast"] and out["port"]["largest_batch"] == 4
    assert out["port"]["results"] == [[[2.0 * i] * 2] for i in range(4)]


def test_batcher_flushes_on_deadline_trigger():
    def scenario(pkg):
        ex = FakeExecutor(max_batch=64)
        b = pkg.batcher.DynamicBatcher(ex, max_delay_s=0.05, max_queue=16)
        try:
            t0 = time.monotonic()
            out = b.submit({"x": np.ones((1, 2), np.float32)},
                           timeout_s=CALL_S)
            return {"shape": out["y"].shape,
                    "fast": time.monotonic() - t0 < 2.0,
                    "batches": ex.batch_rows,
                    "partial": b.fill_ratio() < 1.0}
        finally:
            b.close()

    out = _both(scenario)
    assert out["port"] == out["jax"] == {"shape": (1, 2), "fast": True,
                                         "batches": [1], "partial": True}


def test_full_queue_sheds_explicitly_not_a_hang():
    """The flush thread held busy and the queue at max_queue: the next
    submit raises ShedError at once, with JAX's message."""
    def scenario(pkg):
        ex = FakeExecutor(max_batch=1, delay_s=0.6)
        b = pkg.batcher.DynamicBatcher(ex, max_delay_s=0.0, max_queue=2)
        try:
            threads = []
            for _ in range(3):        # 1 in flight (popped) + 2 queued
                t = threading.Thread(
                    target=lambda: b.submit(
                        {"x": np.ones((1, 1), np.float32)},
                        timeout_s=CALL_S), daemon=True)
                t.start()
                threads.append(t)
                time.sleep(0.08)      # the flush thread pops the first
            t0 = time.monotonic()
            with pytest.raises(pkg.batcher.ShedError) as ei:
                b.submit({"x": np.ones((1, 1), np.float32)})
            fast = time.monotonic() - t0 < 0.5
            for t in threads:
                t.join(timeout=10.0)
            return {"message": str(ei.value), "fast": fast,
                    "shed": b.shed_count,
                    "served": sorted(ex.batch_rows)}
        finally:
            b.close()

    out = _both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["message"] == "queue full (2 requests queued)"
    assert out["port"]["fast"] and out["port"]["shed"] == 1
    assert out["port"]["served"] == [1, 1, 1]


def test_request_deadline_expires_in_queue():
    def scenario(pkg):
        ex = FakeExecutor(max_batch=1, delay_s=0.3)
        b = pkg.batcher.DynamicBatcher(ex, max_delay_s=0.0, max_queue=8)
        try:
            blocker = threading.Thread(
                target=lambda: b.submit({"x": np.ones((1, 1), np.float32)},
                                        timeout_s=CALL_S), daemon=True)
            blocker.start()
            time.sleep(0.05)
            with pytest.raises(pkg.batcher.DeadlineError) as ei:
                b.submit({"x": np.ones((1, 1), np.float32)},
                         deadline_s=0.01, timeout_s=CALL_S)
            blocker.join(timeout=10.0)
            return {"expired": b.deadline_expired,
                    "says": str(ei.value).startswith("deadline expired "
                                                     "after "),
                    "served": ex.batch_rows}
        finally:
            b.close()

    out = _both(scenario)
    assert out["port"] == out["jax"] == {"expired": 1, "says": True,
                                         "served": [1]}


def test_oversized_request_rejected():
    def scenario(pkg):
        b = pkg.batcher.DynamicBatcher(FakeExecutor(max_batch=2),
                                       max_delay_s=0.0)
        try:
            with pytest.raises(ValueError, match="split it client-side") \
                    as ei:
                b.submit({"x": np.ones((3, 1), np.float32)})
            with pytest.raises(ValueError) as missing:
                b.submit({"y": np.ones((1, 1), np.float32)})
            return (str(ei.value), str(missing.value))
        finally:
            b.close()

    out = _both(scenario)
    assert out["port"] == out["jax"]


# --------------------------------------------------------------------------- #
# the wire: containment of bad frames and bad requests
# --------------------------------------------------------------------------- #

def _serve(pkg, executor, **kw):
    return pkg.server.InferenceServer(
        executor, max_delay_s=kw.pop("max_delay_s", 0.002), **kw)


def _infer(pkg, addr, inputs, **kw):
    cli = pkg.client.ServingClient(addr, **kw)
    try:
        return _bounded(lambda: cli.infer(inputs))
    finally:
        cli.close()


def test_malformed_frame_drops_one_connection_not_the_server(executors):
    """Garbage from one peer kills its connection; the next client is
    served, with the JAX server's reply."""
    def scenario(side):
        pkg = PKG[side]
        srv = _serve(pkg, executors[side])
        try:
            sk = _raw_socket(srv.addr)
            sk.sendall(b"GET / HTTP/1.1\r\nHost: nope\r\n\r\n")
            dropped = _dropped(sk)
            sk.close()
            out = _infer(pkg, srv.addr, {"data": _rows(1)})
            _wait_for(lambda: srv.bad_frames >= 1, what="bad_frames")
            return dropped, out["prob"]
        finally:
            srv.shutdown()

    (jd, jprob), (pd, pprob) = scenario("jax"), scenario("port")
    assert jd and pd
    assert pprob.shape == (1, 3)
    np.testing.assert_allclose(pprob, jprob, rtol=RTOL, atol=ATOL)


def test_absurd_length_prefix_rejected_before_allocation(executors,
                                                         monkeypatch):
    """A header claiming 2**62 bytes is refused at the cap check, before
    any allocation; the cap resolves env > default in both packages; the
    send side refuses an over-cap frame with an error that names the knob
    and is no ConnectionError; an unusable env value warns."""
    for side in ("jax", "port"):
        wire = PKG[side].wire
        monkeypatch.delenv(wire.MAX_FRAME_ENV, raising=False)
        assert wire.MAX_FRAME_ENV == jax_wire.MAX_FRAME_ENV
        assert wire.max_frame_bytes() == jax_wire.DEFAULT_MAX_FRAME
        monkeypatch.setenv(wire.MAX_FRAME_ENV, "4096")
        assert wire.max_frame_bytes() == 4096

        class _FakeSock:
            def sendall(self, data):
                raise AssertionError("oversized frame reached the socket")

            def sendmsg(self, bufs):
                raise AssertionError("oversized frame reached the socket")

        monkeypatch.setenv(wire.MAX_FRAME_ENV, "64")
        with pytest.raises(wire.FrameTooLargeError,
                           match="POSEIDON_MAX_FRAME"):
            wire.send_frame(_FakeSock(), b"x" * 1024)
        assert not issubclass(wire.FrameTooLargeError, ConnectionError)
        for bad in ("0", "2GB"):
            monkeypatch.setenv(wire.MAX_FRAME_ENV, bad)
            with pytest.warns(RuntimeWarning, match="not a positive integer"):
                assert wire.max_frame_bytes() == wire.DEFAULT_MAX_FRAME
        monkeypatch.delenv(wire.MAX_FRAME_ENV)

        pkg = PKG[side]
        srv = _serve(pkg, executors[side])
        try:
            sk = _raw_socket(srv.addr)
            sk.sendall(struct.pack("!Q", 1 << 62))
            assert _dropped(sk)
            sk.close()
            out = _infer(pkg, srv.addr, {"data": _rows(1)})
            assert out["prob"].shape == (1, 3)
            _wait_for(lambda: srv.bad_frames >= 1, what="bad_frames")
        finally:
            srv.shutdown()


def test_unknown_kind_gets_error_reply(executors):
    """An unknown request kind gets JAX's error reply, and the connection
    survives a bad request (only torn frames drop it)."""
    def scenario(side):
        pkg = PKG[side]
        srv = _serve(pkg, executors[side])
        try:
            sk = _raw_socket(srv.addr)
            pkg.wire.send_frame(sk, {"kind": "no-such-op"})
            reply = pkg.wire.recv_frame(sk)
            pkg.wire.send_frame(sk, {"kind": "health"})
            health = pkg.wire.recv_frame(sk)
            sk.close()
            return reply, health["ok"]
        finally:
            srv.shutdown()

    (jr, jh), (pr, ph) = scenario("jax"), scenario("port")
    assert pr["ok"] is False and "no-such-op" in pr["error"]
    assert pr["error"] == jr["error"]
    assert {k: v for k, v in pr.items()} == {k: v for k, v in jr.items()}
    assert jh is True and ph is True


def test_shed_response_is_explicit_over_the_wire():
    """Backpressure reaches the client as a flagged shed reply, fast."""
    def scenario(pkg):
        ex = FakeExecutor(max_batch=1, delay_s=0.6)
        srv = pkg.server.InferenceServer(ex, max_delay_s=0.0, max_queue=2)
        try:
            hammers = []
            for _ in range(3):
                c = pkg.client.ServingClient(srv.addr)
                t = threading.Thread(
                    target=lambda c=c: c.infer(
                        {"x": np.ones((1, 1), np.float32)}), daemon=True)
                t.start()
                hammers.append((c, t))
                time.sleep(0.08)
            cli = pkg.client.ServingClient(srv.addr)
            t0 = time.monotonic()
            with pytest.raises(pkg.client.ServingError) as ei:
                _bounded(lambda: cli.infer({"x": np.ones((1, 1),
                                                         np.float32)}))
            fast = time.monotonic() - t0 < 0.5
            shed = _bounded(cli.stats)["shed"]
            cli.close()
            for c, t in hammers:
                t.join(timeout=10.0)
                c.close()
            return {"shed_flag": ei.value.shed, "message": str(ei.value),
                    "fast": fast, "stats_shed": shed >= 1}
        finally:
            srv.shutdown()

    out = _both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["shed_flag"] and out["port"]["fast"]


def test_malformed_request_rejected_at_admission_not_cobatched(executors):
    """A wrong-shaped request is refused with its own error at submit
    time; a valid request in the same flush window is served."""
    def scenario(side):
        pkg = PKG[side]
        srv = _serve(pkg, executors[side], max_delay_s=0.05)
        good = pkg.client.ServingClient(srv.addr)
        bad = pkg.client.ServingClient(srv.addr)
        try:
            results = {}
            t = threading.Thread(target=lambda: results.__setitem__(
                "good", good.infer({"data": _rows(2)})), daemon=True)
            t.start()
            with pytest.raises(pkg.client.ServingError, match="row shape") \
                    as ei:
                _bounded(lambda: bad.infer(
                    {"data": np.zeros((1, 3, 4, 4), np.float32)}))
            t.join(timeout=10.0)
            return str(ei.value), results["good"]["prob"]
        finally:
            good.close()
            bad.close()
            srv.shutdown()

    (jm, jprob), (pm, pprob) = scenario("jax"), scenario("port")
    assert pm == jm
    assert pprob.shape == (2, 3)
    np.testing.assert_allclose(pprob, jprob, rtol=RTOL, atol=ATOL)


def test_executor_failure_is_server_error_not_bad_frame():
    class ExplodingExecutor(FakeExecutor):
        def infer(self, inputs):
            raise RuntimeError("XLA device exploded")

    def scenario(pkg):
        srv = pkg.server.InferenceServer(ExplodingExecutor(max_batch=2),
                                         max_delay_s=0.0)
        cli = pkg.client.ServingClient(srv.addr)
        try:
            with pytest.raises(pkg.client.ServingError, match="exploded") \
                    as ei:
                _bounded(lambda: cli.infer({"x": np.ones((1, 1),
                                                         np.float32)}))
            return {"message": str(ei.value), "shed": ei.value.shed,
                    "deadline": ei.value.deadline_exceeded,
                    "server_errors": srv.server_errors,
                    "bad_frames": srv.bad_frames}
        finally:
            cli.close()
            srv.shutdown()

    out = _both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["server_errors"] == 1
    assert out["port"]["bad_frames"] == 0


# --------------------------------------------------------------------------- #
# faults: the port's FaultProxy between the port's client and server
# --------------------------------------------------------------------------- #

def test_server_survives_fault_proxy_chaos(executors):
    """drop + delay + truncate + sever between client and server: the
    client retries through every cut, a delayed hop is not read as dead,
    the server contains the torn frame and keeps serving; every reply is
    JAX's executor's on the same rows."""
    pkg = PKG["port"]
    x = _rows(1)
    want = executors["jax"].infer({"data": x})["prob"]
    srv = _serve(pkg, executors["port"])
    proxy = pkg.faults.FaultProxy(srv.addr)
    FaultRule = pkg.faults.FaultRule
    proxy.add_rule(FaultRule(action="drop", conn=0))
    proxy.add_rule(FaultRule(action="delay", conn=1, delay_s=0.05))
    proxy.add_rule(FaultRule(action="truncate", conn=2, after_bytes=40))
    cli = pkg.client.ServingClient(proxy.addr, retry_deadline_s=10.0,
                                   backoff_base_s=0.01, backoff_cap_s=0.05)
    try:
        out1 = _bounded(lambda: cli.infer({"data": x}))
        np.testing.assert_allclose(out1["prob"], want, rtol=RTOL, atol=ATOL)
        reconnects = cli.reconnects
        out_slow = _bounded(lambda: cli.infer({"data": x}))
        np.testing.assert_array_equal(out_slow["prob"], out1["prob"])
        assert cli.reconnects == reconnects, \
            "a delayed (slow but alive) channel must not reconnect"
        proxy.sever_all()
        out2 = _bounded(lambda: cli.infer({"data": x}))
        np.testing.assert_array_equal(out2["prob"], out1["prob"])
        assert proxy.accepted >= 4
        # the torn frame is counted on the server's own thread
        _wait_for(lambda: srv.bad_frames >= 1, what="the torn frame")
        direct = _infer(pkg, srv.addr, {"data": x})
        np.testing.assert_array_equal(direct["prob"], out1["prob"])
    finally:
        cli.close()
        proxy.close()
        srv.shutdown()


def test_kill_mid_request_client_reconnects_and_completes(executors):
    """The first connection dies 40 bytes into the request frame (past
    the codec negotiation); the client redials, resends and completes."""
    pkg = PKG["port"]
    neg = pickle.dumps({"kind": "wire", "codec": pkg.wire.WIRE_CODEC_VERSION},
                       protocol=pickle.HIGHEST_PROTOCOL)
    srv = _serve(pkg, executors["port"])
    proxy = pkg.faults.FaultProxy(srv.addr)
    proxy.add_rule(pkg.faults.FaultRule(action="sever", conn=0,
                                        after_bytes=len(neg) + 8 + 40))
    cli = pkg.client.ServingClient(proxy.addr, retry_deadline_s=10.0,
                                   backoff_base_s=0.01, backoff_cap_s=0.05)
    try:
        x = _rows(2, seed=3)
        out = _bounded(lambda: cli.infer({"data": x}))
        np.testing.assert_allclose(
            out["prob"], executors["jax"].infer({"data": x})["prob"],
            rtol=RTOL, atol=ATOL)
        assert cli.reconnects >= 1
    finally:
        cli.close()
        proxy.close()
        srv.shutdown()


# --------------------------------------------------------------------------- #
# graceful shutdown
# --------------------------------------------------------------------------- #

def test_graceful_shutdown_drains_no_request_silently_dropped():
    """Every request admitted before the stop gets a reply; the listener
    refuses new connections afterwards."""
    def scenario(pkg):
        ex = FakeExecutor(max_batch=1, delay_s=0.15)
        srv = pkg.server.InferenceServer(ex, max_delay_s=0.0, max_queue=32)
        results, errors = [], []

        def one_request():
            c = pkg.client.ServingClient(srv.addr, retry_deadline_s=1.0)
            try:
                results.append(c.infer({"x": np.ones((1, 1), np.float32)}))
            except Exception as e:  # noqa: BLE001 — the assertion
                errors.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=one_request, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        srv.request_stop()
        _bounded(lambda: srv.shutdown(drain=True))
        for t in threads:
            t.join(timeout=15.0)
        refused = False
        try:
            socket.create_connection(srv.addr, timeout=0.5).close()
        except OSError:
            refused = True
        return {"errors": [repr(e) for e in errors],
                "replies": sorted(r["y"].shape for r in results),
                "served": len(ex.batch_rows), "refused": refused}

    out = _both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"] == {"errors": [], "replies": [(1, 1)] * 4,
                           "served": 4, "refused": True}


def test_submissions_after_stop_get_shed_reply():
    def scenario(pkg):
        b = pkg.batcher.DynamicBatcher(FakeExecutor(max_batch=2),
                                       max_delay_s=0.0)
        b.close(drain=True)
        with pytest.raises(pkg.batcher.ShedError, match="shutting down") \
                as ei:
            b.submit({"x": np.ones((1, 1), np.float32)})
        return type(ei.value).__name__, str(ei.value)

    out = _both(scenario)
    assert out["port"] == out["jax"]
