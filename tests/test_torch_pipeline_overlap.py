"""The port's pipelined training loop on the CPU: the device prefetch stage,
the in-flight dispatch window with its off-thread metric drain and NaN
abort, background snapshots, host spans, and the uint8 split.

The pipeline is numerics-neutral by construction — it moves where the host
blocks, never the dispatched steps — so the anchor tests hold the final
parameters BITWISE across ``max_in_flight`` 1, 2 and 4, with the
prefetcher forced threaded, against the serial loop (prefetch off, window
1), on MEMORY_DATA and on native LMDB batches. The port's step on native
batches is held against the JAX step on the JAX package's native batches
(the same batches, bit for bit) at the train parity tolerance of
``tests/test_torch_train.py``: rtol 1e-4, atol 1e-6 on parameters and
momentum after 3 steps, losses rtol 1e-5.
"""

import functools
import glob
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.data.pipeline import BatchPipeline as JaxPipeline
from poseidon_tpu.parallel.trainer import build_train_step as jax_step
from poseidon_tpu.parallel.trainer import init_train_state as jax_state
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.data.lmdb_reader import LMDBWriter
from poseidon_tpu_torch.data.pipeline import BatchPipeline, DevicePrefetcher
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto import wire
from poseidon_tpu_torch.proto.messages import (SolverParameter,
                                               load_net_from_string)
from poseidon_tpu_torch.runtime import checkpoint as ckpt
from poseidon_tpu_torch.runtime import engine as engine_mod
from poseidon_tpu_torch.runtime import metrics
from poseidon_tpu_torch.runtime.engine import Engine, TrainingDivergedError
from poseidon_tpu_torch.runtime.spans import recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5

BODY = """
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers {
  name: "ip1" type: INNER_PRODUCT bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""
SMALLNET = """
name: "PipeNet"
layers {
  name: "mnist" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 1 height: 12 width: 12 }
}
""" + BODY
# the same body over an LMDB of 3x12x12 bytes: crop 10, mirror, a mean
# value per channel and a scale (what --device_transform moves on card)
LMDBNET = """
name: "LmdbNet"
layers { name: "d" type: DATA top: "data" top: "label"
  data_param { source: "%s" batch_size: 8 backend: LMDB }
  transform_param { crop_size: 10 mirror: true mean_value: 120
                    mean_value: 110 mean_value: 100 scale: 0.0078125 } }
""" + BODY


def _solver(net=SMALLNET, max_iter=30, **kw):
    return SolverParameter(train_net_param=load_net_from_string(net),
                           base_lr=0.05, lr_policy="fixed", momentum=0.9,
                           weight_decay=5e-4, display=10, max_iter=max_iter,
                           random_seed=3, **kw)


def _memory_data(n=256, seed=0, poison=False):
    rs = np.random.RandomState(seed)
    templates = rs.randn(5, 1, 12, 12).astype(np.float32)
    labels = rs.randint(0, 5, size=n)
    data = templates[labels] + \
        0.25 * rs.randn(n, 1, 12, 12).astype(np.float32)
    if poison:
        data[:] = np.nan
    return {"data": data, "label": labels}


@pytest.fixture(scope="module")
def lmdb_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loop") / "lmdb")
    rs = np.random.RandomState(5)
    templates = rs.randint(0, 256, size=(5, 3, 12, 12))
    w = LMDBWriter(path)
    for i in range(64):
        label = int(rs.randint(5))
        img = np.clip(templates[label] + rs.randint(-30, 31, (3, 12, 12)),
                      0, 255).astype(np.uint8)
        w.put(f"{i:08d}".encode(), wire.encode_datum(wire.Datum(
            3, 12, 12, img.tobytes(), label=label)))
    w.close()
    return path


def _threaded(monkeypatch):
    """Force the prefetcher's thread (the CUDA stage's path) on the CPU."""
    monkeypatch.setattr(engine_mod, "DevicePrefetcher", functools.partial(
        DevicePrefetcher, passthrough=False))


def _train(tmp_path, sub, sp=None, **kw):
    out = tmp_path / sub
    out.mkdir()
    kw.setdefault("memory_data", _memory_data())
    eng = Engine(sp or _solver(), output_dir=str(out), device="cpu", **kw)
    try:
        last = eng.train()
        leaves = {f"{l}/{p}": v.clone() for l, d in eng.params.items()
                  for p, v in d.items()}
        feed = eng._device_feed
        threads = [t for t in (feed._thread if feed else None,) if t]
        return last, leaves, eng, feed, threads
    finally:
        eng.close()


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mif", [1, 2, 4])
def test_windowed_loop_is_the_serial_loop_bitwise(tmp_path, monkeypatch,
                                                  mif):
    last_s, serial, _, _, _ = _train(tmp_path, "serial", device_prefetch=0,
                                     max_in_flight=1)
    assert np.isfinite(last_s["loss"])
    _threaded(monkeypatch)
    last, leaves, eng, feed, threads = _train(
        tmp_path, f"mif{mif}", device_prefetch=2, max_in_flight=mif)
    assert feed is not None and not feed.passthrough
    _assert_bitwise(serial, leaves)
    assert last == last_s
    assert threads and not any(t.is_alive() for t in threads)
    assert eng.stats.counters["train_iters"] == 30
    assert 1.0 <= eng.stats.counters["steps_in_flight"] <= mif


@pytest.mark.parametrize("device_transform", [False, True])
@pytest.mark.parametrize("mif", [1, 2, 4])
def test_windowed_loop_on_native_batches_is_serial_bitwise(
        tmp_path, monkeypatch, lmdb_path, mif, device_transform):
    """Native LMDB batches (f32, or uint8 normalized in the step): the
    pipelined loop against the serial loop on the same native batches."""
    sp = lambda: _solver(LMDBNET % lmdb_path, max_iter=12)  # noqa: E731
    _, serial, eng, _, _ = _train(tmp_path, "serial", sp(), memory_data=None,
                                  device_prefetch=0, max_in_flight=1)
    _threaded(monkeypatch)
    _, leaves, eng, feed, _ = _train(
        tmp_path, "piped", sp(), memory_data=None, device_prefetch=2,
        max_in_flight=mif, device_transform=device_transform)
    assert not feed.passthrough
    assert (eng._input_transform is not None) == device_transform
    _assert_bitwise(serial, leaves)


def test_routes_are_logged(tmp_path, lmdb_path, capsys):
    eng = Engine(_solver(LMDBNET % lmdb_path, max_iter=1),
                 output_dir=str(tmp_path), device="cpu",
                 device_transform=True)
    try:
        assert [p.route for p in eng.train_pipelines] == ["native-u8"]
    finally:
        eng.close()
    assert "via the native-u8 path" in capsys.readouterr().out
    eng = Engine(_solver(max_iter=1), output_dir=str(tmp_path),
                 device="cpu", memory_data=_memory_data(),
                 device_transform=True)
    try:
        assert [p.route for p in eng.train_pipelines] == ["python"]
        assert eng._input_transform is None
    finally:
        eng.close()
    out = capsys.readouterr().out
    assert "via the python path" in out
    assert "WARNING: --device_transform requested" in out


def test_device_transform_with_mean_file_keeps_the_host_path(
        tmp_path, lmdb_path, capsys):
    mean = str(tmp_path / "mean.binaryproto")
    with open(mean, "wb") as f:
        f.write(wire.encode_blob(np.full((1, 3, 12, 12), 100, np.float32)))
    net = (LMDBNET % lmdb_path).replace(
        "mean_value: 120\n                    mean_value: 110 "
        "mean_value: 100", f'mean_file: "{mean}"')
    assert "mean_file" in net
    eng = Engine(_solver(net, max_iter=2), output_dir=str(tmp_path),
                 device="cpu", device_transform=True)
    try:
        assert [p.route for p in eng.train_pipelines] == ["native"]
        assert eng._input_transform is None
        assert np.isfinite(eng.train()["loss"])
    finally:
        eng.close()
    assert "WARNING: --device_transform requested" in capsys.readouterr().out


def _native_batches(lmdb_path, n):
    """n batches of the LMDB net's data layer from both packages' native
    pipelines (asserted equal): numpy dicts."""
    text = LMDBNET % lmdb_path
    lp = load_net_from_string(text).layers[0]
    jlp = jax_load_str(text).layers[0]
    port = BatchPipeline(lp, "TRAIN", 8, seed=0)
    ref = JaxPipeline(jlp, "TRAIN", 8, seed=0, use_native=True)
    try:
        assert port.route == "native" and ref.native is not None
        out = []
        for _ in range(n):
            a, b = next(port), next(ref)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
            out.append(a)
        return out
    finally:
        port.close()
        ref.close()


def test_native_fed_step_matches_jax(lmdb_path):
    """The port's step on the port's native batches against the JAX step
    on JAX's native batches (bitwise the same), 3 steps: the JAX Engine
    multiplies the batch by conftest's 8 virtual devices, so the steps are
    compared directly, on a one-device mesh, as test_torch_train.py does."""
    text = LMDBNET % lmdb_path
    shapes = {"data": (8, 3, 10, 10), "label": (8,)}
    jnet = JaxNet(jax_load_str(text), "TRAIN", conv_layout="NCHW",
                  source_shapes=shapes)
    net = Net(load_net_from_string(text), "TRAIN", device="cpu",
              source_shapes=shapes)
    jparams = jnet.init(jax.random.PRNGKey(3))
    params = params_from_jax(net, {l: {p: np.asarray(v) for p, v in d.items()}
                                   for l, d in jparams.items()})
    batches = _native_batches(lmdb_path, 3)
    solver = dict(base_lr=0.05, momentum=0.9, weight_decay=5e-4,
                  lr_policy="fixed")
    ts = jax_step(jnet, JaxSolver(**solver),
                  Mesh(np.array(jax.devices()[:1]), ("data",)))
    jstate = jax_state(jparams)
    step = build_train_step(net, SolverParameter(**solver))
    params, state = step.load(params, init_train_state(params))
    for b in batches:
        jparams, jstate, jm = ts.step(jparams, jstate, b,
                                      jax.random.PRNGKey(0))
        params, state, m = step.step(params, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    for tree, jtree in ((params, jparams),
                        (state.solver.history, jstate.solver.history)):
        for l in jtree:
            for p in jtree[l]:
                np.testing.assert_allclose(tree[l][p].numpy(),
                                           np.asarray(jtree[l][p]),
                                           **PARAM_TOL, err_msg=f"{l}/{p}")


# ----------------------------------------------------------------------- #
# NaN abort rides the drain
# ----------------------------------------------------------------------- #

@pytest.mark.parametrize("mif", [1, 4])
def test_nan_abort_names_the_producing_step(tmp_path, mif):
    eng = Engine(_solver(), memory_data=_memory_data(poison=True),
                 output_dir=str(tmp_path), device="cpu", max_in_flight=mif)
    try:
        with pytest.raises(TrainingDivergedError) as exc:
            eng.train()
        assert exc.value.iteration == 0 and exc.value.key == "loss"
        assert eng.stats.counters["train_iters"] <= \
            exc.value.iteration + 1 + mif
    finally:
        eng.close()


@pytest.mark.parametrize("mif", [1, 3])
def test_nan_mid_run_names_its_iteration(tmp_path, mif):
    """Params poisoned after 4 clean steps: the first non-finite loss is
    step 4's, whatever the window dispatched past it."""
    sp = _solver(max_iter=4)
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", max_in_flight=mif)
    try:
        eng.train()
        eng.params["ip1"]["w"].fill_(float("nan"))
        with pytest.raises(TrainingDivergedError) as exc:
            eng.train(max_iter=12)
        assert exc.value.iteration == 4
    finally:
        eng.close()


def test_nan_is_never_snapshotted(tmp_path):
    sp = _solver(max_iter=30, snapshot=2, snapshot_prefix="snap/poison")
    eng = Engine(sp, memory_data=_memory_data(poison=True),
                 output_dir=str(tmp_path), device="cpu", max_in_flight=4)
    try:
        with pytest.raises(TrainingDivergedError):
            eng.train()
    finally:
        eng.close()
    assert glob.glob(str(tmp_path / "snap" / "*")) == []


class _Gated(metrics._Pending):
    """A dispatch whose metrics are not ready until ``gate`` opens (a step
    still running on the card)."""

    gate = threading.Event()

    def ready(self):
        return self.gate.is_set()

    def row(self):
        assert self.gate.wait(timeout=10.0)
        return super().row()


def test_fetcher_window_blocks_and_tags_divergence(monkeypatch):
    """Window 2: the first put returns with its entry pending, the second
    blocks until the first is read; the drain tags the diverged step."""
    monkeypatch.setattr(metrics, "_Pending", _Gated)
    _Gated.gate.clear()
    f = metrics.AsyncScalarFetcher(max_in_flight=2)
    try:
        t0 = time.monotonic()
        f.put(0, {"loss": torch.tensor(1.0)})
        assert time.monotonic() - t0 < 5.0
        done = threading.Event()

        def second():
            f.put(1, {"loss": torch.tensor(float("nan"))})
            done.set()

        t = threading.Thread(target=second, daemon=True)
        t.start()
        time.sleep(0.2)
        assert not done.is_set(), "window 2 must block the second put"
        _Gated.gate.set()
        t.join(timeout=10.0)
        assert done.is_set()
        rows = f.sync()
        assert [it for it, _ in rows] == [0, 1]
        assert f.divergence is not None and f.divergence[0] == 1
        assert f.mean_in_flight() == 1.5
    finally:
        f.close()
    assert not f._thread.is_alive()


def test_fetcher_window_one_is_serial():
    f = metrics.AsyncScalarFetcher(max_in_flight=1)
    try:
        for i in range(3):
            f.put(i, {"loss": torch.tensor(float(i)),
                      "accuracy": torch.tensor(0.5)})
            assert f.take_drained() == [(i, {"accuracy": 0.5,
                                             "loss": float(i)})]
    finally:
        f.close()


def test_fetcher_surfaces_a_drain_failure(monkeypatch):
    class Dying(metrics._Pending):
        def ready(self):
            return False

        def row(self):
            raise RuntimeError("device lost")

    monkeypatch.setattr(metrics, "_Pending", Dying)
    f = metrics.AsyncScalarFetcher(max_in_flight=1)
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            f.put(0, {"loss": torch.tensor(1.0)})
        with pytest.raises(RuntimeError, match="device lost"):
            f.sync()
    finally:
        f.close()


# ----------------------------------------------------------------------- #
# async snapshots
# ----------------------------------------------------------------------- #

def test_async_snapshot_equals_sync_snapshot(tmp_path):
    sp = _solver(max_iter=6, snapshot_prefix="snap/pipe",
                 snapshot_after_train=True)
    paths = {}
    for mode in ("sync", "async"):
        out = tmp_path / mode
        out.mkdir()
        eng = Engine(sp, memory_data=_memory_data(), output_dir=str(out),
                     device="cpu", async_snapshot=(mode == "async"))
        try:
            eng.train()
        finally:
            eng.close()
        paths[mode] = out / "snap" / "pipe_iter_6"
    for suffix in (".caffemodel",):
        with open(f"{paths['sync']}{suffix}", "rb") as f:
            a = f.read()
        with open(f"{paths['async']}{suffix}", "rb") as f:
            b = f.read()
        assert a == b
    a = np.load(f"{paths['sync']}.solverstate.npz")
    b = np.load(f"{paths['async']}.solverstate.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_async_snapshot_auto_resumes(tmp_path):
    sp = _solver(max_iter=20, snapshot=10, snapshot_prefix="snap/pipe")
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", async_snapshot=True)
    try:
        eng.train()
        want = {l: {p: v.clone() for p, v in d.items()}
                for l, d in eng.params.items()}
    finally:
        eng.close()
    assert (tmp_path / "snap" / "pipe_iter_10.solverstate.npz").exists()
    eng2 = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                  device="cpu", async_snapshot=True)
    try:
        restored = eng2.auto_resume()
        assert restored.endswith("pipe_iter_20.solverstate.npz")
        assert eng2.iteration() == 20
        for l in want:
            for p in want[l]:
                assert torch.equal(eng2.params[l][p], want[l][p])
    finally:
        eng2.close()


def test_torn_async_writer_leaves_no_partial_file(tmp_path, monkeypatch):
    sp = _solver()
    shapes = {"data": (8, 1, 12, 12), "label": (8,)}
    net = Net(sp.train_net_param, "TRAIN", device="cpu", source_shapes=shapes)
    params = net.init(torch.Generator().manual_seed(0))
    state = init_train_state(params)
    prefix = str(tmp_path / "snap" / "torn")
    real_savez = np.savez

    def dying_savez(f, **arrays):
        f.write(b"partial bytes that must never land at the real name")
        raise IOError("disk vanished mid-write")

    monkeypatch.setattr(ckpt.np, "savez", dying_savez)
    w = ckpt.AsyncSnapshotWriter()
    w.submit(prefix, net, params, state)
    with pytest.raises(IOError):
        w.wait()
    assert glob.glob(f"{prefix}*.solverstate.npz") == []
    assert glob.glob(f"{prefix}*.tmp.*"), "the torn write leaves its tmp"
    monkeypatch.setattr(ckpt.np, "savez", real_savez)
    w.submit(prefix, net, params, state)
    model, statef = w.wait()
    assert os.path.exists(model) and os.path.exists(statef)
    w.close()


def test_async_snapshot_failure_aborts_at_next_sync_boundary(tmp_path,
                                                             monkeypatch):
    def dying_savez(f, **arrays):
        raise IOError("disk vanished mid-write")

    monkeypatch.setattr(ckpt.np, "savez", dying_savez)
    sp = _solver(max_iter=30, snapshot=5, snapshot_prefix="snap/die")
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", async_snapshot=True)
    try:
        with pytest.raises(IOError, match="disk vanished"):
            eng.train()
        assert eng.iteration() <= 10
    finally:
        eng.close()


# ----------------------------------------------------------------------- #
# device prefetcher
# ----------------------------------------------------------------------- #

class _DyingPipe:
    def __init__(self):
        self.n = 0

    def __next__(self):
        self.n += 1
        if self.n > 2:
            raise IOError("record store vanished")
        return {"data": np.full((8, 4), self.n, np.float32)}


@pytest.mark.parametrize("passthrough", [False, True])
def test_device_prefetcher_surfaces_source_failure(passthrough):
    feed = DevicePrefetcher([_DyingPipe()], "cpu", depth=2,
                            passthrough=passthrough)
    try:
        seen = []
        with pytest.raises(IOError, match="vanished"):
            for _ in range(4):
                seen.append(float(next(feed)["data"][0, 0]))
        assert seen == [1.0, 2.0]
        # sticky: a retried dequeue re-raises at once
        with pytest.raises(IOError, match="vanished"):
            next(feed)
    finally:
        feed.close()
    if feed._thread is not None:
        assert not feed._thread.is_alive()


def test_device_prefetcher_merges_pipes_in_order():
    class Counter:
        def __init__(self, key):
            self.key, self.n = key, 0

        def __next__(self):
            self.n += 1
            return {self.key: np.full((2,), self.n, np.int32)}

    feed = DevicePrefetcher([Counter("a"), Counter("b")], "cpu", depth=3,
                            passthrough=False)
    try:
        for i in range(1, 8):
            b = next(feed)
            assert sorted(b) == ["a", "b"]
            assert int(b["a"][0]) == int(b["b"][0]) == i
    finally:
        feed.close()
    assert not feed._thread.is_alive()


# ----------------------------------------------------------------------- #
# spans, stats, CLI
# ----------------------------------------------------------------------- #

def test_trace_out_writes_the_host_spans(tmp_path):
    sp = _solver(max_iter=12, snapshot=10, snapshot_prefix="snap/s")
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", trace_out="trace.json")
    try:
        assert recorder.enabled
        eng.train()
    finally:
        eng.close()
    assert not recorder.enabled
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"prefetch_wait", "dispatch", "dispatch_window", "hard_sync",
            "snapshot"} <= names
    syncs = sorted(e["args"]["boundary"] for e in doc["traceEvents"]
                   if e["name"] == "hard_sync")
    assert syncs == ["display", "final", "snapshot"]
    assert sum(e["name"] == "dispatch" for e in doc["traceEvents"]) == 12


def test_cli_train_pipeline_flags(tmp_path):
    from poseidon_tpu_torch.runtime.cli import build_parser
    args = build_parser().parse_args(["train", "--solver=s"])
    assert (args.device_prefetch, args.max_in_flight, args.async_snapshot,
            args.device_transform, args.trace_out) == (None, None, None,
                                                       False, "")
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")}"\n'
        'test_iter: 1\ntest_interval: 4\nbase_lr: 0.01\nmomentum: 0.9\n'
        'lr_policy: "fixed"\ndisplay: 2\nmax_iter: 4\nsnapshot: 2\n'
        f'snapshot_prefix: "{tmp_path / "lenet"}"\n')
    out = subprocess.run(
        [sys.executable, "-m", "poseidon_tpu_torch", "train",
         f"--solver={solver}", "--output_dir", str(tmp_path), "--device",
         "cpu", "--device_prefetch", "3", "--max_in_flight", "4",
         "--async_snapshot", "--trace_out", "spans.json"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "via the native path" in out.stdout
    assert "Snapshotting (async)" in out.stdout
    assert (tmp_path / "lenet_iter_2.solverstate.npz").exists()
    assert (tmp_path / "lenet_iter_4.solverstate.npz").exists()
    with open(tmp_path / "spans.json") as f:
        assert json.load(f)["traceEvents"]
