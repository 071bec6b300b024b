"""The trace half of the port's attribution (``runtime/attribution.py``,
``train --profile``) against the JAX package's, mirroring the trace tests
of JAX's ``tests/test_attribution.py``:

- ``attribute`` and ``format_table`` fed the same canned events and scope
  map give JAX's table exactly: rows, ms, coverage, the residual, self
  time never double-counted, decorated device names, module and step
  lines ignored, the tracer's overhead stripped;
- the join on a canned card trace in torch's Chrome JSON: kernels to the
  op that launched them (by correlation id), forward ops in their layer's
  range, backward kernels (an aten op's and one launched through ctypes
  from a Function's backward) under the autograd node whose sequence
  number names the forward op, the update under ``optimizer_update``,
  copies over the host link out of the op time;
- a real CPU ``torch.profiler`` trace of a LeNet train step: every layer
  with params has fwd and bwd rows;
- ``measure_then_trace`` times before it traces (one warm-up step of
  the session, then the traced one);
- ``train --profile 2 --steps_per_dispatch 4`` single-steps inside its
  window, writes the trace and the table, and is bitwise to the same run
  without ``--profile``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from poseidon_tpu.runtime import attribution as JA
from poseidon_tpu_torch.runtime import attribution as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET = os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")


def _ev(name, t0, dur, line="t0", hlo=True, plane="p"):
    return {"name": name, "t0_us": t0, "dur_us": dur, "plane": plane,
            "line": line, "stats": {"hlo_op": name} if hlo else {}}


# the JAX tests' canned cases: (events, scope map, attribute kwargs)
CANNED = {
    "stable_table": (
        [_ev("dot.1", 0, 100), _ev("dot.2", 200, 300),
         _ev("fusion.1", 600, 100), _ev("mystery.9", 800, 100),
         {"name": "python_noise", "t0_us": 0, "dur_us": 99999,
          "plane": "p", "line": "t9", "stats": {}}],
        {"dot.1": ("conv1", "fwd"), "dot.2": ("conv1", "bwd"),
         "fusion.1": ("ip1", "fwd")},
        dict(cost_table={"conv1": {"flops": 4e9, "bytes": 1e6,
                                   "intensity": 4000.0}},
             peak_flops=1e12)),
    "self_time": (
        [_ev("while.1", 0, 1000), _ev("body.1", 100, 600),
         _ev("other.1", 2000, 500)],
        {"while.1": ("pool1", "bwd"), "body.1": ("pool1", "bwd"),
         "other.1": ("conv1", "fwd")}, {}),
    "decorated": (
        [{"name": "%fusion.3", "t0_us": 0, "dur_us": 100,
          "plane": "/device:TPU:0", "line": "XLA Ops", "stats": {}},
         {"name": "fusion.3.7", "t0_us": 200, "dur_us": 100,
          "plane": "/device:TPU:0", "line": "XLA Ops", "stats": {}}],
        {"fusion.3": ("conv1", "fwd")}, {}),
    "module_lines": (
        [{"name": "dot.1", "t0_us": 0, "dur_us": 100,
          "plane": "/device:TPU:0", "line": "XLA Ops", "stats": {}},
         {"name": "unknown.9", "t0_us": 200, "dur_us": 50,
          "plane": "/device:TPU:0", "line": "XLA Ops", "stats": {}},
         {"name": "jit_train_step", "t0_us": 0, "dur_us": 10_000,
          "plane": "/device:TPU:0", "line": "XLA Modules", "stats": {}},
         {"name": "step 3", "t0_us": 0, "dur_us": 10_000,
          "plane": "/device:TPU:0", "line": "Steps", "stats": {}}],
        {"dot.1": ("conv1", "fwd")}, {}),
    "tracer_overhead": (
        [_ev("a.1", 0, 100), _ev("b.1", 200, 100)],
        {"a.1": ("l1", "fwd"), "b.1": ("l2", "fwd")},
        dict(tracer_overhead_ms=0.1, steps=2)),
}


@pytest.mark.parametrize("case", sorted(CANNED))
def test_attribute_equals_jax_on_canned_events(case):
    events, smap, kw = CANNED[case]
    got = A.attribute(copy.deepcopy(events), dict(smap), **kw)
    want = JA.attribute(copy.deepcopy(events), dict(smap), **kw)
    assert got == want
    assert A.format_table(got, title=case) == \
        JA.format_table(want, title=case)
    assert A.RESIDUAL == JA.RESIDUAL
    if case == "self_time":
        assert got["total_ms"] == pytest.approx(1.5)
    if case == "stable_table":
        assert got["coverage"] == pytest.approx(5 / 6, abs=1e-3)
        assert got["residual"]["top_ops"][0]["op"] == "mystery.9"


# --------------------------------------------------------------------------- #
# the join on a canned card trace
# --------------------------------------------------------------------------- #

def _x(name, cat, ts, dur, pid, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _canned_card_trace():
    """One step of a conv1 -> norm1 net as torch writes it on the card:
    the main thread's forward (an aten conv and a ctypes LRN launch under
    each layer's range), the autograd thread's backward nodes (an aten
    conv backward; the LRN Function's backward launching its kernel
    through ctypes), AccumulateGrad (no sequence number), the update, a
    batch's host-to-device copy."""
    M, B, D = 10, 11, 7           # main thread, autograd thread, stream
    ev = [
        _x("conv1", "user_annotation", 0, 100, 1, M),
        _x("aten::conv2d", "cpu_op", 5, 90, 1, M, **{"Sequence number": 40,
                                                    "External id": 2}),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 5, 1, M, correlation=100,
           **{"External id": 2}),
        _x("norm1", "user_annotation", 120, 60, 1, M),
        _x("LRNFunction", "cpu_op", 125, 50, 1, M,
           **{"Sequence number": 41, "External id": 4}),
        _x("cudaLaunchKernel", "cuda_runtime", 130, 5, 1, M,
           correlation=101),
        _x("autograd::engine::evaluate_function: LRNFunctionBackward",
           "cpu_op", 300, 80, 1, B, **{"Sequence number": 41}),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 5, 1, B,
           correlation=102),
        _x("autograd::engine::evaluate_function: ConvolutionBackward0",
           "cpu_op", 400, 80, 1, B, **{"Sequence number": 40}),
        _x("ConvolutionBackward0", "cpu_op", 401, 78, 1, B,
           **{"Sequence number": 40}),
        _x("aten::convolution_backward", "cpu_op", 405, 70, 1, B),
        _x("cudaLaunchKernel", "cuda_runtime", 410, 5, 1, B,
           correlation=103),
        _x("autograd::engine::evaluate_function: "
           "torch::autograd::AccumulateGrad", "cpu_op", 500, 20, 1, B),
        _x("cudaLaunchKernel", "cuda_runtime", 505, 5, 1, B,
           correlation=104),
        _x("optimizer_update", "user_annotation", 600, 40, 1, M),
        _x("cudaLaunchKernel", "cuda_runtime", 610, 5, 1, M,
           correlation=105),
        _x("cudaMemcpyAsync", "cuda_runtime", 700, 5, 1, M, correlation=106),
        # the device's work
        _x("cudnn_conv_fprop", "kernel", 20, 30, 0, D, correlation=100),
        _x("lrn_nhwc_fwd_kernel", "kernel", 140, 10, 0, D, correlation=101),
        _x("lrn_nhwc_bwd_kernel", "kernel", 320, 20, 0, D, correlation=102),
        _x("cudnn_conv_dgrad", "kernel", 420, 40, 0, D, correlation=103),
        _x("add_kernel", "kernel", 510, 5, 0, D, correlation=104),
        _x("sgd_update_kernel", "kernel", 620, 15, 0, D, correlation=105),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 710, 500, 0, 8,
           correlation=106),
    ]
    return {"traceEvents": ev}


def test_card_trace_joins_kernels_to_layers_and_phases(tmp_path):
    path = tmp_path / "rank0.trace.json"
    path.write_text(json.dumps(_canned_card_trace()))
    events = A.load_trace_events(str(tmp_path))
    assert len(events) == 24
    smap = A.trace_scope_map(events, {"conv1", "norm1"})
    by_kernel = {e["name"]: smap.get(e["stats"].get("hlo_op"))
                 for e in events if e["stats"]["cat"] == "kernel"}
    assert by_kernel == {
        "cudnn_conv_fprop": ("conv1", "fwd"),
        "lrn_nhwc_fwd_kernel": ("norm1", "fwd"),
        "lrn_nhwc_bwd_kernel": ("norm1", "bwd"),
        "cudnn_conv_dgrad": ("conv1", "bwd"),
        "add_kernel": None,
        "sgd_update_kernel": ("optimizer_update", "misc")}
    out = A.attribute(events, smap)
    rows = {r["layer"]: r for r in out["rows"]}
    assert rows["conv1"]["fwd_ms"] == pytest.approx(0.03)
    assert rows["conv1"]["bwd_ms"] == pytest.approx(0.04)
    assert rows["norm1"]["fwd_ms"] == pytest.approx(0.01)
    assert rows["norm1"]["bwd_ms"] == pytest.approx(0.02)
    # the host-link copy is not op time; AccumulateGrad's add is residual
    assert out["total_ms"] == pytest.approx(0.12)
    assert out["residual"]["top_ops"] == [{"op": "add_kernel",
                                           "ms": 0.005}]
    assert out["coverage"] == pytest.approx(1 - 5 / 120, abs=1e-4)


# --------------------------------------------------------------------------- #
# a real CPU trace and the capture discipline
# --------------------------------------------------------------------------- #

def _lenet_step(batch=4):
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.models import zoo
    from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import SolverParameter

    net = Net(zoo.lenet(with_accuracy=False), "TRAIN", device="cpu",
              source_shapes=zoo.lenet_shapes(batch))
    params = net.init(torch.Generator().manual_seed(0))
    step = build_train_step(net, SolverParameter(base_lr=0.01,
                                                 momentum=0.9))
    holder = list(step.load(params, init_train_state(params)))
    rs = np.random.RandomState(0)
    batch = {"data": torch.from_numpy(rs.randn(batch, 1, 28, 28).astype(
        np.float32)), "label": torch.zeros(batch)}

    def run():
        holder[0], holder[1], _ = step.step(holder[0], holder[1], batch)

    return net, run


def test_real_cpu_trace_of_a_lenet_step_has_every_layers_rows(tmp_path):
    net, run = _lenet_step()
    timing = A.measure_then_trace(run, str(tmp_path), iters=2)
    assert os.path.exists(timing["trace"])
    events = A.load_trace_events(str(tmp_path))
    smap = A.trace_scope_map(events, {l.name for l in net.layers})
    out = A.attribute(events, smap, cost_table=A.layer_cost_table(net))
    rows = {r["layer"]: r for r in out["rows"]}
    for layer in net.param_defs:
        assert rows[layer]["fwd_ms"] > 0, layer
        assert rows[layer]["bwd_ms"] > 0, layer
        assert rows[layer]["flops"] > 0
    assert rows["optimizer_update"]["total_ms"] > 0
    assert out["coverage"] > 0.5, out["residual"]["top_ops"]
    # outside a profiler no range opens
    assert not A.profiling()
    assert type(A.scope("conv1")).__name__ == "nullcontext"


def test_trace_capture_stays_after_timing(tmp_path, monkeypatch):
    order = []
    class Session:
        def step(self):
            pass

    monkeypatch.setattr(A, "start_trace",
                        lambda *a, **k: order.append("trace_start")
                        or Session())
    monkeypatch.setattr(A, "stop_trace",
                        lambda *a, **k: order.append("trace_stop") or "")
    timing = A.measure_then_trace(lambda: order.append("step"),
                                  str(tmp_path), iters=3)
    # the session's own warm-up step, then the traced one
    assert order == ["step"] * 3 + ["trace_start", "step", "step",
                                    "trace_stop"]
    assert timing["step_ms"] >= 0


# --------------------------------------------------------------------------- #
# train --profile
# --------------------------------------------------------------------------- #

def _solver(tmp_path, sub):
    out = tmp_path / sub
    out.mkdir()
    solver = out / "solver.prototxt"
    solver.write_text(
        f'net: "{LENET}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 4\n'
        'max_iter: 12\nsnapshot_after_train: true\n'
        f'snapshot_prefix: "{out / "lenet"}"\n')
    return str(solver), out


def _state(out):
    path = next(p for p in os.listdir(out) if p.endswith(".solverstate.npz"))
    with np.load(os.path.join(out, path)) as z:
        return {k: z[k].copy() for k in z.files}


def test_train_profile_single_steps_its_window_and_is_bitwise(
        tmp_path, capsys, monkeypatch):
    from poseidon_tpu_torch.parallel.trainer import TrainStep
    from poseidon_tpu_torch.runtime import cli

    monkeypatch.chdir(REPO)
    calls = []
    real_step, real_multi = TrainStep.step, TrainStep.multi_step

    def step(self, params, state, batch):
        calls.append(("step", int(state.solver.it)))
        return real_step(self, params, state, batch)

    def multi(self, params, state, batch):
        calls.append(("multi", int(state.solver.it)))
        return real_multi(self, params, state, batch)

    monkeypatch.setattr(TrainStep, "step", step)
    monkeypatch.setattr(TrainStep, "multi_step", multi)
    runs = {}
    for arm, extra in (("profiled", ["--profile", "2"]), ("plain", [])):
        calls.clear()
        solver, out = _solver(tmp_path, arm)
        assert cli.main(["train", f"--solver={solver}", "--output_dir",
                         str(out), "--device", "cpu", "--tuned_plan", "off",
                         "--steps_per_dispatch", "4"] + extra) == 0
        runs[arm] = (list(calls), _state(out), out)
    log = capsys.readouterr().out
    # the traced steps are the third and fourth (the session opens at
    # the second for its warm-up step): single steps until they end,
    # then chunks of 4
    assert runs["profiled"][0] == [("step", 0), ("step", 1), ("step", 2),
                                   ("step", 3), ("multi", 4),
                                   ("multi", 8)]
    assert runs["plain"][0] == [("multi", 0), ("multi", 4), ("multi", 8)]
    a, b = runs["profiled"][1], runs["plain"][1]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = runs["profiled"][2]
    assert f"Wrote profiler trace to {out / 'profile'}" in log
    assert "[profile] per-layer attribution over 2 steps" in log
    assert os.listdir(out / "profile") == ["rank0.trace.json"]
    stats = (out / "stats.yaml").read_text()
    assert "profile:" in stats and "coverage:" in stats
    assert "profile:" not in (runs["plain"][2] / "stats.yaml").read_text()
