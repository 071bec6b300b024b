"""The port's serving fleet on the CPU: least-loaded routing, replica
health and failover, rolling hot reload, the fleet reloader, per-replica
stats and the metrics endpoint, the open-loop load generator and device
resolution (one counterpart of each test of ``tests/test_fleet.py``), then
the port held against the JAX package on the same inputs: the stats
renderings, a JAX-written LeNet snapshot served and rolled by a port fleet
(rtol 1e-4, atol 1e-5 against JAX's ``BucketedExecutor``: f32 on both
sides, conv and GEMM sums in other orders), and JAX's client against the
port's fleet server.

Port 0 on loopback only, daemon threads only. The routing tests drive
duck-typed fake executors (no timing races); the kill-1-of-3 scenario runs
real sockets through the port's ``runtime/faults.py`` proxy and asserts
the invariant (no accepted request lost, only explicit sheds).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.proto.messages import load_net_from_string
from poseidon_tpu_torch.serving.executor import BucketedExecutor

pytestmark = pytest.mark.serving

RTOL, ATOL = 1e-4, 1e-5
LENET = "examples/mnist/lenet_deploy.prototxt"

DEPLOY_NET = """
name: "fleetnet"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "fc" type: INNER_PRODUCT bottom: "conv" top: "fc"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
"""


def _rows(n, seed=0, shape=(3, 8, 8)):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def _build_executor(buckets=(1, 2, 4), seed=7):
    net = Net(load_net_from_string(DEPLOY_NET), "TEST", device="cpu")
    params = net.init(torch.Generator().manual_seed(seed))
    return BucketedExecutor(net, params, buckets=buckets)


def _scaled(params, k):
    return {l: {p: v * k for p, v in d.items()} for l, d in params.items()}


class FakeExecutor:
    """Duck-typed replica engine: optional per-call stall, a poison switch
    (``die.set()`` -> every dispatch raises, the replica-death lever), an
    optional gate the dispatch blocks on, and a per-instance count."""

    def __init__(self, max_batch=4, delay_s=0.0):
        self.input_names = ["x"]
        self.max_batch = max_batch
        self.delay_s = delay_s
        self.die = threading.Event()
        self.gate = None
        self.rows_served = 0
        self.params_version = 0
        self.infers = 0

    def validate_request(self, inputs):
        if "x" not in inputs:
            raise ValueError("request missing input 'x'")
        return int(np.shape(inputs["x"])[0])

    def infer(self, inputs):
        if self.gate is not None:
            self.gate.wait(10.0)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.die.is_set():
            raise RuntimeError("device lost")
        self.rows_served += int(np.shape(inputs["x"])[0])
        self.infers += 1
        return {"y": np.asarray(inputs["x"], np.float32) * 2.0}

    def swap_params(self, new_params):
        self.params_version += 1
        return self.params_version


def _fake_fleet(n=3, delay_s=0.0, **kw):
    from poseidon_tpu_torch.serving.fleet import ReplicaManager
    exs = [FakeExecutor(delay_s=delay_s) for _ in range(n)]
    return ReplicaManager(exs, **kw), exs


def _hold_replica(mgr, exs, i):
    """Gate replica i's executor and park one request in its dispatch;
    returns the blocked submitter's thread."""
    exs[i].gate = threading.Event()
    blocker = threading.Thread(
        target=lambda: mgr.replicas[i].batcher.submit(
            {"x": np.ones((1, 2), np.float32)}), daemon=True)
    blocker.start()
    deadline = time.monotonic() + 5.0
    while mgr.replicas[i].load() == 0.0:
        assert time.monotonic() < deadline, "blocker never dispatched"
        time.sleep(0.002)
    return blocker


def _release(exs):
    for ex in exs:
        if ex.gate is not None:
            ex.gate.set()


# --------------------------------------------------------------------------- #
# routing
# --------------------------------------------------------------------------- #

def test_least_loaded_routing_skews_to_idle_replica():
    mgr, exs = _fake_fleet(3)
    try:
        blocker = _hold_replica(mgr, exs, 0)
        for i in range(20):
            out, rep = mgr.submit({"x": np.full((1, 2), i, np.float32)})
            assert rep.index != 0, "router sent work to the busy replica"
            np.testing.assert_array_equal(out["y"], np.full((1, 2), 2.0 * i))
        assert exs[1].infers + exs[2].infers == 20
        with mgr.replicas[0]._lock:
            assert mgr.replicas[0].routed == 0
        exs[0].gate.set()
        blocker.join(timeout=10.0)
    finally:
        _release(exs)
        mgr.shutdown()


def test_routing_excludes_warming_draining_and_dead():
    from poseidon_tpu_torch.serving.batcher import ShedError
    from poseidon_tpu_torch.serving.fleet import DRAINING

    mgr, exs = _fake_fleet(3)
    try:
        mgr._transition(mgr.replicas[0], DRAINING, reason="test")
        mgr._transition(mgr.replicas[2], DRAINING, reason="test")
        for _ in range(5):
            _, rep = mgr.submit({"x": np.ones((1, 2), np.float32)})
            assert rep.index == 1
        mgr._transition(mgr.replicas[1], DRAINING, reason="test")
        t0 = time.monotonic()
        with pytest.raises(ShedError, match="no serving replica"):
            mgr.submit({"x": np.ones((1, 2), np.float32)})
        assert time.monotonic() - t0 < 0.5, "fleet shed must be immediate"
        assert mgr.fleet_sheds == 1
    finally:
        mgr.shutdown()


def test_full_fleet_queues_shed_explicitly():
    from poseidon_tpu_torch.serving.batcher import ShedError
    from poseidon_tpu_torch.serving.fleet import ReplicaManager

    exs = [FakeExecutor() for _ in range(2)]
    for ex in exs:
        ex.gate = threading.Event()
    mgr = ReplicaManager(exs, max_queue=1)
    threads = []
    try:
        # one in flight + one queued a replica: both queues full
        for rep in mgr.replicas:
            for _ in range(2):
                t = threading.Thread(
                    target=lambda rep=rep: rep.batcher.submit(
                        {"x": np.ones((1, 2), np.float32)}), daemon=True)
                t.start()
                threads.append(t)
                time.sleep(0.05)
        with pytest.raises(ShedError, match="queue capacity"):
            mgr.submit({"x": np.ones((1, 2), np.float32)})
    finally:
        _release(exs)
        for t in threads:
            t.join(timeout=10.0)
        mgr.shutdown()


# --------------------------------------------------------------------------- #
# failure detection + failover
# --------------------------------------------------------------------------- #

def test_replica_death_fails_over_without_losing_requests():
    from poseidon_tpu_torch.serving.fleet import DEAD, SERVING

    mgr, exs = _fake_fleet(2)
    try:
        exs[0].gate = threading.Event()
        exs[0].die.set()                     # dies on its next dispatch
        results, errors = [], []

        def one(i):
            try:
                results.append(mgr.submit(
                    {"x": np.full((1, 2), i, np.float32)}))
            except BaseException as e:  # noqa: BLE001 — the assertion
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        exs[0].gate.set()
        for t in threads:
            t.join(timeout=10.0)
        assert not errors, f"request lost to a replica death: {errors[0]}"
        assert len(results) == 6
        states = mgr.state_counts()
        assert states[DEAD] == 1 and states[SERVING] == 1
        assert mgr.failovers >= 1
        assert "device lost" in mgr.replicas[0].death_reason
        for _ in range(4):
            _, rep = mgr.submit({"x": np.ones((1, 2), np.float32)})
            assert rep.index == 1
    finally:
        _release(exs)
        mgr.shutdown()


def test_kill_one_of_three_chaos_under_load():
    """3 replicas under socket load through the fault proxy; one replica
    dies mid-run, then every connection is severed. Every request either
    completes or is an explicit shed, and p99 stays bounded."""
    from poseidon_tpu_torch.runtime.faults import FaultProxy
    from poseidon_tpu_torch.serving.client import run_load
    from poseidon_tpu_torch.serving.fleet import DEAD
    from poseidon_tpu_torch.serving.server import InferenceServer

    mgr, exs = _fake_fleet(3, delay_s=0.002)
    srv = InferenceServer(fleet=mgr)
    proxy = FaultProxy(srv.addr)
    try:
        box = {}

        def load():
            box["result"] = run_load(
                proxy.addr, lambda i: {"x": np.ones((2, 3), np.float32)},
                n_requests=150, concurrency=6)

        t = threading.Thread(target=load, daemon=True)
        t.start()
        # the death and the partition land mid-load, whatever the pace
        _wait_until(lambda: sum(ex.infers for ex in exs) >= 30,
                    "load never started")
        exs[0].die.set()
        _wait_until(lambda: sum(ex.infers for ex in exs) >= 60,
                    "load stalled after the death")
        proxy.sever_all()
        t.join(timeout=60.0)
        assert not t.is_alive(), "load generator wedged"
        r = box["result"]
        assert r["error"] == 0 and r["deadline"] == 0, r
        assert r["ok"] + r["shed"] == 150, r
        assert r["ok"] > 0
        assert r["p99_ms"] is not None and r["p99_ms"] < 5000.0
        assert mgr.state_counts()[DEAD] == 1
        assert mgr.deaths == 1 and mgr.failovers >= 1
        assert exs[1].infers + exs[2].infers > 0
    finally:
        proxy.close()
        srv.shutdown()


def test_failover_deadline_is_absolute_across_reroutes():
    from poseidon_tpu_torch.serving.batcher import DeadlineError

    mgr, exs = _fake_fleet(2)
    timer = None
    try:
        exs[0].gate = threading.Event()
        exs[0].die.set()
        exs[1].gate = threading.Event()      # the survivor cannot answer
        t0 = time.monotonic()
        timer = threading.Timer(0.25, exs[0].gate.set)
        timer.daemon = True
        with pytest.raises(DeadlineError):
            timer.start()
            mgr.submit({"x": np.ones((1, 2), np.float32)}, deadline_s=0.1)
        assert time.monotonic() - t0 < 5.0
    finally:
        _release(exs)
        if timer is not None:
            timer.join(timeout=5.0)
        mgr.shutdown()


# --------------------------------------------------------------------------- #
# rolling hot-reload
# --------------------------------------------------------------------------- #

def _draining_never_overlaps(transitions):
    from poseidon_tpu_torch.serving.fleet import DRAINING
    draining = 0
    for _, old, new in transitions:
        if new == DRAINING:
            draining += 1
            assert draining <= 1, "two replicas draining at once"
        elif old == DRAINING:
            draining -= 1


def test_rolling_reload_invariant_under_load():
    """A whole-fleet reload under socket load: at most ONE replica
    draining at any instant (proved from the transition log), no request
    fails, every replica on the new params afterwards, replies flip."""
    from poseidon_tpu_torch.serving.client import ServingClient
    from poseidon_tpu_torch.serving.fleet import ReplicaManager
    from poseidon_tpu_torch.serving.server import InferenceServer

    exs = [_build_executor() for _ in range(3)]
    transitions = []
    tr_lock = threading.Lock()

    def observer(index, old, new, reason):
        with tr_lock:
            transitions.append((index, old, new))

    mgr = ReplicaManager(exs, on_transition=observer)
    srv = InferenceServer(fleet=mgr)
    x = _rows(2)
    errors = []
    stop = threading.Event()

    def hammer():
        c = ServingClient(srv.addr)
        try:
            while not stop.is_set():
                try:
                    c.infer({"data": x})
                except Exception as e:  # noqa: BLE001 — the assertion
                    errors.append(e)
                    return
        finally:
            c.close()

    cli = ServingClient(srv.addr)
    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    try:
        before = cli.infer({"data": x})["prob"]
        for t in threads:
            t.start()
        time.sleep(0.05)
        swapped = mgr.rolling_reload(_scaled(exs[0]._params, 2.0))
        after = cli.infer({"data": x})["prob"]
        time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        assert not errors, f"request failed during the reload: {errors[0]}"
        assert swapped == 3
        assert mgr.max_concurrent_draining == 1
        _draining_never_overlaps(transitions)
        assert not np.allclose(before, after)
        for rep in mgr.replicas:
            assert rep.reload_generation == 1
            assert rep.executor.params_version == 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        cli.close()
        srv.shutdown()


def _port_snapshot(prefix, ex, params, it):
    """A ``<prefix>_iter_<it>`` snapshot pair written by the port's
    checkpoint writer."""
    from poseidon_tpu_torch.parallel.trainer import init_train_state
    from poseidon_tpu_torch.runtime.checkpoint import snapshot
    state = init_train_state(params)
    return snapshot(prefix, ex.net, params,
                    state._replace(solver=state.solver._replace(it=it)))


def test_fleet_reloader_rolls_snapshot_through_every_replica(tmp_path):
    """One discovery, one load, then the roll: every replica lands on the
    new snapshot, the server's ``reload`` op drives it, and an older
    snapshot never rolls the fleet backwards."""
    from poseidon_tpu_torch.serving.client import ServingClient
    from poseidon_tpu_torch.serving.fleet import ReplicaManager
    from poseidon_tpu_torch.serving.reloader import FleetReloader
    from poseidon_tpu_torch.serving.server import InferenceServer

    exs = [_build_executor(buckets=(1, 2)) for _ in range(3)]
    mgr = ReplicaManager(exs)
    prefix = str(tmp_path / "snap" / "fleetnet")
    _, seed_path = _port_snapshot(prefix, exs[0], exs[0]._params, 1)
    rel = FleetReloader(mgr, prefix, start=False, current_path=seed_path)
    assert rel.check_now() is False
    srv = InferenceServer(fleet=mgr, reloader=rel)
    cli = ServingClient(srv.addr)
    try:
        _port_snapshot(prefix, exs[0], _scaled(exs[0]._params, 2.0), 5)
        reply = cli.reload()
        assert reply["ok"] and reply["reloaded"] is True
        assert reply["reload_generation"] == 1
        assert rel.reloads == 1
        for rep in mgr.replicas:
            assert rep.executor.params_version == 1
            assert rep.reload_generation == 1
        _port_snapshot(prefix, exs[0], exs[0]._params, 3)
        assert rel.check_now() is False and rel.reloads == 1
    finally:
        cli.close()
        srv.shutdown()


def test_partial_reload_raises_typed_error_with_swapped_count():
    from poseidon_tpu_torch.serving.fleet import PartialReloadError, SERVING

    mgr, exs = _fake_fleet(2)
    try:
        blocker = _hold_replica(mgr, exs, 0)    # replica 0 cannot drain
        with pytest.raises(PartialReloadError) as ei:
            mgr.rolling_reload({"w": np.zeros(1, np.float32)},
                               drain_timeout_s=0.1)
        assert ei.value.swapped == 1 and len(ei.value.errors) == 1
        assert exs[0].params_version == 0
        assert exs[1].params_version == 1
        with mgr.replicas[0]._lock:
            assert mgr.replicas[0].state == SERVING
        exs[0].gate.set()
        blocker.join(timeout=10.0)
    finally:
        _release(exs)
        mgr.shutdown()


def test_rolling_reload_skips_dead_replicas():
    from poseidon_tpu_torch.serving.fleet import DEAD

    mgr, exs = _fake_fleet(3)
    try:
        mgr._mark_dead(mgr.replicas[1], "test kill")
        assert mgr.rolling_reload({"w": np.zeros(1, np.float32)}) == 2
        assert exs[0].params_version == 1 and exs[2].params_version == 1
        assert exs[1].params_version == 0
        with mgr.replicas[1]._lock:
            assert mgr.replicas[1].state == DEAD
    finally:
        mgr.shutdown()


# --------------------------------------------------------------------------- #
# warming
# --------------------------------------------------------------------------- #

def _wait_until(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_build_warms_replicas_through_warming_state():
    from poseidon_tpu_torch.serving.batcher import ShedError
    from poseidon_tpu_torch.serving.fleet import (ReplicaManager, SERVING,
                                                  WARMING)

    release = threading.Event()

    def factory(device):
        release.wait(10.0)
        return FakeExecutor()

    mgr = ReplicaManager.build(factory, 2, warm_async=True)
    try:
        assert mgr.state_counts()[WARMING] == 2
        with pytest.raises(ShedError, match="no serving replica"):
            mgr.submit({"x": np.ones((1, 2), np.float32)})
        release.set()
        _wait_until(lambda: mgr.state_counts()[SERVING] == 2,
                    "replicas never warmed")
        out, _ = mgr.submit({"x": np.ones((1, 2), np.float32)})
        assert out["y"].shape == (1, 2)
    finally:
        release.set()
        mgr.shutdown()


def test_late_warming_replica_catches_up_to_rolled_params():
    from poseidon_tpu_torch.serving.fleet import ReplicaManager, SERVING

    release = threading.Event()
    slow_ex = FakeExecutor()
    first = {"v": True}

    def factory(device):
        if first["v"]:
            first["v"] = False
            return FakeExecutor()
        release.wait(10.0)
        return slow_ex

    mgr = ReplicaManager.build(factory, 2, warm_async=True)
    try:
        _wait_until(lambda: mgr.state_counts()[SERVING] >= 1,
                    "first replica never warmed")
        mgr.rolling_reload({"w": np.ones(1, np.float32)})
        assert mgr.replicas[0].reload_generation == 1
        release.set()                        # replica 1 warms after the roll
        _wait_until(lambda: slow_ex.params_version >= 1,
                    "late replica never caught up to the rolled params")
        _wait_until(lambda: mgr.replicas[1].reload_generation >= 1,
                    "late replica's generation never caught up")
    finally:
        release.set()
        mgr.shutdown()


def test_failed_warmup_is_a_dead_replica_not_a_dead_fleet():
    from poseidon_tpu_torch.serving.fleet import DEAD, ReplicaManager, SERVING

    calls = {"n": 0}

    def factory(device):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("out of memory during the bucket warm-up")
        return FakeExecutor()

    mgr = ReplicaManager.build(factory, 2)
    try:
        states = mgr.state_counts()
        assert states[DEAD] == 1 and states[SERVING] == 1
        assert "warm-up failed" in mgr.replicas[0].death_reason
        out, rep = mgr.submit({"x": np.ones((1, 2), np.float32)})
        assert out["y"].shape == (1, 2) and rep.index == 1
        assert mgr.stats_snapshot()["deaths"] == 1
    finally:
        mgr.shutdown()


# --------------------------------------------------------------------------- #
# stats surface
# --------------------------------------------------------------------------- #

def test_fleet_stats_has_per_replica_rows_and_aggregates():
    from poseidon_tpu_torch.serving.client import ServingClient
    from poseidon_tpu_torch.serving.server import InferenceServer

    mgr, _ = _fake_fleet(3)
    srv = InferenceServer(fleet=mgr)
    cli = ServingClient(srv.addr)
    try:
        for _ in range(6):
            cli.infer({"x": np.ones((1, 2), np.float32)})
        st = cli.stats()
        assert st["n_replicas"] == 3
        assert set(st["replicas"]) == {"0", "1", "2"}
        for row in st["replicas"].values():
            for key in ("state", "queue_depth", "batch_fill", "shed",
                        "reload_generation", "load", "routed", "failures",
                        "latency"):
                assert key in row, f"replica row missing {key}"
        assert sum(r["routed"] for r in st["replicas"].values()) == 6
        for key in ("states", "routing", "latency", "replica_latency",
                    "reload_generation", "max_concurrent_draining",
                    "deaths", "bad_frames", "connections", "uptime_s"):
            assert key in st, f"fleet stats missing {key}"
        assert st["routing"]["routed"] == 6
        assert st["replica_latency"]["count"] == 6
        h = cli.health()
        assert h["ok"] and h["states"]["SERVING"] == 3
    finally:
        cli.close()
        srv.shutdown()


def test_fleet_stats_flatten_on_metrics_endpoint():
    import urllib.request

    from poseidon_tpu_torch.runtime.metrics import MetricsServer
    from poseidon_tpu_torch.serving.server import InferenceServer

    mgr, _ = _fake_fleet(2)
    srv = InferenceServer(fleet=mgr)
    msrv = MetricsServer(srv.stats, port=0)
    try:
        mgr.submit({"x": np.ones((1, 2), np.float32)})
        srv.stats_snapshot()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{msrv.port}/", timeout=5.0).read().decode()
        assert "serving.replicas.0.queue_depth=" in body
        assert "serving.replicas.1.reload_generation=0" in body
        assert "serving.routing.routed=1" in body
        yaml = urllib.request.urlopen(
            f"http://127.0.0.1:{msrv.port}/yaml", timeout=5.0).read().decode()
        assert yaml == srv.stats.render_yaml()
    finally:
        msrv.close()
        srv.shutdown()


def test_server_requires_exactly_one_backend():
    from poseidon_tpu_torch.serving.server import InferenceServer

    with pytest.raises(ValueError, match="exactly one"):
        InferenceServer()
    mgr, _ = _fake_fleet(1)
    try:
        with pytest.raises(ValueError, match="exactly one"):
            InferenceServer(executor=FakeExecutor(), fleet=mgr)
    finally:
        mgr.shutdown()


def test_merged_latency_summary_pools_windows():
    from poseidon_tpu_torch.runtime.metrics import LatencyWindow

    a, b = LatencyWindow(), LatencyWindow()
    for v in (0.010, 0.020, 0.030):
        a.record(v)
    b.record(0.100)
    merged = LatencyWindow.merged_summary([a, b])
    assert merged["count"] == 4
    assert merged["p50_ms"] == pytest.approx(20.0, abs=10.001)
    assert merged["p99_ms"] == pytest.approx(100.0)
    assert a.percentile(50) == pytest.approx(0.020)
    assert LatencyWindow().percentile(50) is None
    assert LatencyWindow.merged_summary([]) == {"count": 0}


# --------------------------------------------------------------------------- #
# open-loop load generator
# --------------------------------------------------------------------------- #

def test_open_loop_load_generator_paces_offered_rate():
    from poseidon_tpu_torch.serving.client import run_load
    from poseidon_tpu_torch.serving.server import InferenceServer

    srv = InferenceServer(executor=FakeExecutor(), max_delay_s=0.0)
    try:
        r = run_load(srv.addr, lambda i: {"x": np.ones((1, 2), np.float32)},
                     n_requests=30, concurrency=8, offered_rps=100.0)
        assert r["ok"] == 30 and r["error"] == 0
        assert r["offered_rps"] == 100.0
        assert r["wall_s"] >= 0.25, "the open loop did not pace arrivals"
        assert "late_fires" in r and "achieved_rps" in r
        assert r["goodput_rps"] <= 130.0
        r2 = run_load(srv.addr,
                      lambda i: {"x": np.ones((1, 2), np.float32)},
                      n_requests=20, concurrency=4)
        assert "offered_rps" not in r2 and r2["goodput_rps"] > 0
        with pytest.raises(ValueError, match="offered_rps"):
            run_load(srv.addr,
                     lambda i: {"x": np.ones((1, 2), np.float32)},
                     n_requests=5, offered_rps=0.0)
    finally:
        srv.shutdown()


# --------------------------------------------------------------------------- #
# device placement + build_serving_fleet
# --------------------------------------------------------------------------- #

def test_executor_device_pinning_places_params_and_matches(tmp_path):
    """An executor placed by ``_build_serving_executor`` holds its params
    on that device, answers as an unplaced one does, and a swap lands
    there too (the CPU is the one device here)."""
    from poseidon_tpu_torch.runtime.cli import _build_serving_executor

    model = tmp_path / "deploy.prototxt"
    model.write_text(DEPLOY_NET)
    pinned = _build_serving_executor(str(model), "", "1,2", device="cpu")
    free = BucketedExecutor(pinned.net, pinned._params, buckets=(1, 2))
    leaf = pinned._params["conv"]["w"]
    assert leaf.device == torch.device("cpu")
    x = _rows(2)
    np.testing.assert_array_equal(pinned.infer({"data": x})["prob"],
                                  free.infer({"data": x})["prob"])
    pinned.swap_params({l: {p: v.numpy() * 2.0 for p, v in d.items()}
                        for l, d in free._params.items()})
    assert pinned._params["conv"]["w"].device == torch.device("cpu")
    assert pinned.params_version == 1


def test_build_serving_fleet_pins_round_robin_and_validates(tmp_path):
    """Device resolution over a given device count (no GPU here), its
    refusals word for word against the JAX package's on its 8 virtual
    devices, and a CPU fleet built through ``build_serving_fleet``."""
    from poseidon_tpu.runtime import cli as jax_cli
    from poseidon_tpu_torch.runtime.cli import (_resolve_fleet_devices,
                                                build_serving_fleet)

    cuda = [torch.device("cuda", i) for i in range(8)]
    assert _resolve_fleet_devices("0,2", 2, n_devices=3) == [cuda[0],
                                                             cuda[2]]
    assert _resolve_fleet_devices("0,0", 2, n_devices=1) == [cuda[0]] * 2
    assert _resolve_fleet_devices("", 3, n_devices=2) == cuda[:2]
    assert _resolve_fleet_devices("", 1, n_devices=2) == []
    n_jax = len(jax.devices())
    for spec in ("99", "a,b", "-1"):
        with pytest.raises(SystemExit) as want:
            jax_cli._resolve_fleet_devices(spec, 2)
        with pytest.raises(SystemExit) as got:
            _resolve_fleet_devices(spec, 2, n_devices=n_jax)
        assert str(got.value) == str(want.value)
    assert _resolve_fleet_devices("", 2, device="cpu") == [
        torch.device("cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        _resolve_fleet_devices("0", 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            _resolve_fleet_devices("", 2)

    model = tmp_path / "deploy.prototxt"
    model.write_text(DEPLOY_NET)
    mgr = build_serving_fleet(str(model), "", "1,2", 3, device="cpu")
    try:
        assert [rep.device_label for rep in mgr.replicas] == ["cpu"] * 3
        for rep in mgr.replicas:
            assert rep.executor._params["fc"]["w"].device.type == "cpu"
        out, _ = mgr.submit({"data": _rows(2)})
        assert out["prob"].shape == (2, 3)
    finally:
        mgr.shutdown()


def test_fleet_roundtrip_reports_serving_replica():
    import socket as _socket

    from poseidon_tpu_torch.proto.wire import recv_frame, send_frame
    from poseidon_tpu_torch.serving.server import InferenceServer

    mgr, _ = _fake_fleet(2)
    srv = InferenceServer(fleet=mgr)
    try:
        sk = _socket.create_connection(srv.addr)
        send_frame(sk, {"kind": "infer",
                        "inputs": {"x": np.ones((1, 2), np.float32)}})
        reply = recv_frame(sk)
        assert reply["ok"] is True
        assert reply["replica"] in (0, 1)
        assert reply["params_version"] == 0
        sk.close()
    finally:
        srv.shutdown()


def test_launch_counter_is_exact_across_threads():
    """Replicas launch kernels from several batcher threads: the one
    counting helper of the kernel modules loses no count when 8 threads
    hammer one entry, and every module counts through it."""
    import inspect
    import re

    from poseidon_tpu_torch.ops import _build, flash, lrn, pool, sgd

    table = {"k": 0}
    n_threads, per = 8, 20000
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(per):
            _build.count_launch(table, "k")

    threads = [threading.Thread(target=work, daemon=True)
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert table["k"] == n_threads * per
    for mod in (flash, lrn, pool, sgd):
        src = inspect.getsource(mod)
        assert not re.search(r"LAUNCHES\[[^]]+\]\s*\+=", src), mod.__name__
        assert "_build.count_launch(LAUNCHES" in src, mod.__name__


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #

def _fill_registry(reg, section):
    reg.add("steps", 3)
    reg.add("bytes", 2.5)
    reg.add_time("step", 0.125)
    reg.set_gauge("loss", 0.75)
    reg.set_gauge("iter", 12)
    reg.set_section("serving", section)


def test_stats_renderings_and_merged_summary_equal_jax():
    from poseidon_tpu.runtime.metrics import LatencyWindow as JaxWindow
    from poseidon_tpu.runtime.metrics import StatsRegistry as JaxRegistry
    from poseidon_tpu_torch.runtime.metrics import (LatencyWindow,
                                                    StatsRegistry)

    section = {"n_replicas": 2, "states": {"SERVING": 2, "DEAD": 0},
               "draining": False, "reloader": None,
               "replicas": {"0": {"state": "SERVING", "load": 0.25,
                                  "latency": {"count": 0}},
                            "1": {"state": "DRAINING", "load": 1.0,
                                  "batch_fill": None}},
               "latency": {"count": 4, "p50_ms": 1.5}}
    ours, theirs = StatsRegistry(), JaxRegistry()
    _fill_registry(ours, section)
    _fill_registry(theirs, section)
    assert ours.render_text() == theirs.render_text()
    assert ours.render_yaml() == theirs.render_yaml()

    samples = np.random.RandomState(4).exponential(0.01, (3, 40))
    ports = [LatencyWindow(maxlen=32) for _ in range(3)]
    jaxs = [JaxWindow(maxlen=32) for _ in range(3)]
    for row, p, j in zip(samples, ports, jaxs):
        for v in row:
            p.record(v)
            j.record(v)
    assert LatencyWindow.merged_summary(ports) == \
        JaxWindow.merged_summary(jaxs)
    for q in (0, 50, 99, 100):
        assert ports[0].percentile(q) == jaxs[0].percentile(q)


def _jax_lenet_snapshots(prefix):
    """Two JAX-written LeNet snapshots under ``prefix`` (iterations 1 and
    2, the second from other weights); returns (net, [(params, path)])."""
    import jax.numpy as jnp
    from poseidon_tpu.core.net import Net as JaxNet
    from poseidon_tpu.parallel.trainer import init_train_state
    from poseidon_tpu.proto.messages import load_net as jax_load_net
    from poseidon_tpu.runtime.checkpoint import snapshot

    jnet = JaxNet(jax_load_net(LENET), "TEST", conv_layout="NCHW")
    out = []
    for it, seed in ((1, 5), (2, 6)):
        params = jnet.init(jax.random.PRNGKey(seed))
        state = init_train_state(params)
        state = state._replace(solver=state.solver._replace(
            it=jnp.asarray(it, jnp.int32)))
        _, path = snapshot(prefix, jnet, params, state)
        out.append((params, path))
    return jnet, out


def test_port_fleet_serves_and_rolls_jax_snapshots(tmp_path):
    """Two port replicas serve a JAX-written LeNet snapshot; the fleet
    reloader rolls them to a second JAX snapshot. Every reply, from each
    replica, before and after the roll, is within rtol 1e-4, atol 1e-5 of
    JAX's BucketedExecutor on the same snapshot."""
    from poseidon_tpu.serving.executor import \
        BucketedExecutor as JaxExecutor
    from poseidon_tpu.serving.executor import \
        load_serving_params as jax_load
    from poseidon_tpu_torch.runtime.cli import build_serving_fleet
    from poseidon_tpu_torch.serving.client import ServingClient
    from poseidon_tpu_torch.serving.reloader import FleetReloader
    from poseidon_tpu_torch.serving.server import InferenceServer

    prefix = str(tmp_path / "lenet")
    jnet, snaps = _jax_lenet_snapshots(prefix)
    (p1, path1), (p2, path2) = snaps
    want = []
    for params, path in snaps:
        jex = JaxExecutor(jnet, jax_load(jnet, params, path), buckets=(1, 4))
        want.append(jex)
    mgr = build_serving_fleet(LENET, path1, "1,4", 2, device="cpu")
    rel = FleetReloader(mgr, prefix, start=False, current_path=path1)
    srv = InferenceServer(fleet=mgr, reloader=rel)
    cli = ServingClient(srv.addr)
    try:
        def check(jex, tag):
            for i, n in enumerate((1, 3, 4)):
                x = _rows(n, seed=50 + i, shape=(1, 28, 28))
                ref = jex.infer({"data": x})["prob"]
                for rep in mgr.replicas:
                    got = rep.batcher.submit({"data": x})["prob"]
                    np.testing.assert_allclose(got, ref, rtol=RTOL,
                                               atol=ATOL, err_msg=tag)
                np.testing.assert_allclose(cli.infer({"data": x})["prob"],
                                           ref, rtol=RTOL, atol=ATOL,
                                           err_msg=tag)

        check(want[0], "the first snapshot")
        reply = cli.reload()
        assert reply["reloaded"] is True and reply["path"] == path2
        assert all(rep.reload_generation == 1 for rep in mgr.replicas)
        check(want[1], "after the roll")
        assert mgr.max_concurrent_draining == 1
    finally:
        cli.close()
        srv.shutdown()


def test_jax_client_reload_and_stats_against_port_fleet(tmp_path):
    """JAX's ServingClient speaks to the port's fleet server unchanged:
    infer (with the serving replica in the reply), stats with the
    per-replica rows, and the reload op."""
    from poseidon_tpu.serving.client import ServingClient as JaxClient
    from poseidon_tpu_torch.serving.fleet import ReplicaManager
    from poseidon_tpu_torch.serving.reloader import FleetReloader
    from poseidon_tpu_torch.serving.server import InferenceServer

    exs = [_build_executor(buckets=(1, 2)) for _ in range(2)]
    mgr = ReplicaManager(exs)
    prefix = str(tmp_path / "snap" / "fleetnet")
    rel = FleetReloader(mgr, prefix, start=False)
    srv = InferenceServer(fleet=mgr, reloader=rel)
    cli = JaxClient(srv.addr)
    try:
        x = _rows(2, seed=9)
        before = cli.infer({"data": x})["prob"]
        reply = cli.reload()
        assert reply["ok"] and reply["reloaded"] is False
        _port_snapshot(prefix, exs[0], _scaled(exs[0]._params, 0.5), 4)
        reply = cli.reload()
        assert reply["ok"] and reply["reloaded"] is True
        assert reply["reload_generation"] == 1
        after = cli.infer({"data": x})["prob"]
        assert not np.allclose(before, after)
        st = cli.stats()
        assert st["reloads"] == 1 and st["n_replicas"] == 2
        assert st["reloader"]["current_path"].endswith(
            "fleetnet_iter_4.solverstate.npz")
        assert {r["reload_generation"] for r in st["replicas"].values()} \
            == {1}
    finally:
        cli.close()
        srv.shutdown()
