"""The measured remat planner and per-layer CNN remat in the port, on the
CPU, against the JAX package (``tests/test_remat.py``'s properties).

- The analytic cost model: ``runtime/attribution.layer_cost_table`` equals
  JAX's exactly, every column, on the zoo's LeNet, AlexNet and GoogLeNet
  (TRAIN nets at batch 2; the port's ``Net.blob_shapes`` and
  ``param_defs`` against JAX's).
- The knapsack: ``plan_remat`` chooses JAX's layers, in JAX's order, with
  JAX's byte and FLOP claims, over several budgets of each net's table
  and peak; its edge cases (a zero budget is maximal, a budget at the peak
  is the identity, lower budgets give supersets) and ``to_doc``/
  ``from_doc`` as JAX's.
- Remat arms bitwise to stored arms: 3 max-remat LeNet steps; 2 steps of a
  narrow AlexNet (widths cut 16-fold, 67x67 inputs) with both DROPOUT
  layers in the plan, whose recomputed masks must be the forward's;
  ``train --remat`` through the engine; a 4-process gloo ``--mesh
  dp2,fsdp2`` remat arm against its no-remat arm (this file run as a
  script, one process a rank).
- The measured side: 0 on the CPU, so the plan's source is ``analytic``,
  as in JAX; ``--hbm_budget_gb`` < 0 warns and plans nothing there; under
  SSP the flags warn and are ignored, JAX's words; unknown layers refuse.
- The modules stand alone: ``runtime/attribution.py`` and
  ``core/remat.py`` import neither jax nor poseidon_tpu.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # run as a script: the rank workers
    sys.path.insert(0, REPO)

from poseidon_tpu_torch.core import remat as R  # noqa: E402
from poseidon_tpu_torch.core.net import Net  # noqa: E402
from poseidon_tpu_torch.models import zoo  # noqa: E402
from poseidon_tpu_torch.parallel.trainer import (  # noqa: E402
    build_train_step, init_train_state)
from poseidon_tpu_torch.proto.messages import SolverParameter  # noqa: E402
from poseidon_tpu_torch.runtime import cluster  # noqa: E402
from poseidon_tpu_torch.runtime.attribution import layer_cost_table  # noqa: E402,E501

SOLVER = dict(base_lr=0.01, lr_policy="inv", gamma=1e-4, power=0.75,
              momentum=0.9, weight_decay=5e-4)
MESH_WORLD = 4
MESH_STEPS = 2
WORKER_TIMEOUT_S = 90


def _narrow_alexnet(mod):
    """AlexNet with every width but fc8's cut 16-fold, 10 classes; both
    DROPOUT layers kept."""
    net = mod.alexnet(num_classes=10, with_accuracy=False)
    for lp in net.layers:
        if lp.type == "CONVOLUTION":
            lp.convolution_param.num_output //= 16
        elif lp.type == "INNER_PRODUCT" and lp.name != "fc8":
            lp.inner_product_param.num_output //= 16
    return net


def _np_tree(t):
    return {l: {p: v.detach().clone().numpy() for p, v in d.items()}
            for l, d in t.items()}


def _equal(got, want, what):
    assert set(got) == set(want)
    for l in want:
        for p in want[l]:
            np.testing.assert_array_equal(got[l][p], want[l][p],
                                          err_msg=f"{what} {l}/{p}")


# --------------------------------------------------------------------- #
# the 4-rank mesh worker

def _worker(rank: int, world: int, store: str, d: str) -> int:
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.parallel import spmd
    cfg = MeshConfig.parse("dp2,fsdp2")
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}",
                                     mesh_cfg=cfg)
    try:
        from poseidon_tpu_torch.parallel import strategies as S
        net = Net(zoo.lenet(with_accuracy=False), "TRAIN", device="cpu",
                  source_shapes=zoo.lenet_shapes(2))
        comm = S.CommConfig()
        plan = spmd.ShardingPlan.build(net, cfg, comm)
        rplan = R.plan_remat(layer_cost_table(net), 0, 0,
                             candidates=R.remat_candidates(net))
        rs = np.random.RandomState(0)
        rows = 2 * group.mesh.batch_index
        batch = {"data": torch.from_numpy(
            rs.randn(8, 1, 28, 28).astype(np.float32)[rows:rows + 2]),
            "label": torch.from_numpy(rs.randint(0, 10, size=8).astype(
                np.float32)[rows:rows + 2])}
        out = {}
        for arm, rp in (("stored", None), ("remat", rplan)):
            params = net.init(torch.Generator().manual_seed(0))
            step = build_train_step(net, SolverParameter(**SOLVER), group,
                                    comm, plan=plan, remat_plan=rp)
            assert step.remat == (rp.layer_set if rp else None)
            p, s = step.load(params, init_train_state(params, comm,
                                                      plan.n_dp))
            for _ in range(MESH_STEPS):
                p, s, m = step.step(p, s, batch)
            cp, _ = step.export(p, s)
            out.update({f"{arm}/{l}/{k}": v for l, dv in
                        _np_tree(cp).items() for k, v in dv.items()})
            out[f"{arm}/loss"] = np.float32(m["loss"])
        np.savez(os.path.join(d, f"mesh.rank{rank}.npz"), **out)
        with open(os.path.join(d, f"mesh.rank{rank}.json"), "w") as f:
            json.dump({"layers": list(rplan.layers)}, f)
    finally:
        group.close()
    return 0


if __name__ == "__main__":
    # a rank worker: it stops here, before the reference side's imports
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4]))


# --------------------------------------------------------------------- #
# the reference side

import jax  # noqa: E402

from poseidon_tpu.core import remat as JR  # noqa: E402
from poseidon_tpu.core.net import Net as JaxNet  # noqa: E402
from poseidon_tpu.models import zoo as jzoo  # noqa: E402
from poseidon_tpu.runtime.attribution import \
    layer_cost_table as jax_cost_table  # noqa: E402

NETS = {
    "lenet": (lambda m: m.lenet(with_accuracy=False),
              lambda m: m.lenet_shapes(2)),
    "alexnet": (lambda m: m.alexnet(with_accuracy=False),
                lambda m: m.alexnet_shapes(2)),
    "googlenet": (lambda m: m.googlenet(with_accuracy=False),
                  lambda m: m.googlenet_shapes(2)),
}


def _nets(name):
    build, shapes = NETS[name]
    port = Net(build(zoo), "TRAIN", device="cpu", source_shapes=shapes(zoo))
    jnet = JaxNet(build(jzoo), "TRAIN", conv_layout="NCHW",
                  source_shapes=shapes(jzoo))
    return port, jnet


@pytest.fixture(scope="module")
def tables():
    out = {}
    for name in NETS:
        port, jnet = _nets(name)
        out[name] = (layer_cost_table(port), jax_cost_table(jnet),
                     R.remat_candidates(port), JR.remat_candidates(jnet))
    return out


@pytest.mark.parametrize("name", list(NETS))
def test_layer_cost_table_equals_jax(tables, name):
    got, want, _, _ = tables[name]
    assert list(got) == list(want)
    assert got == want
    assert sum(r["act_bytes"] for r in got.values()) > 0


@pytest.mark.parametrize("name", list(NETS))
def test_plan_remat_chooses_jaxs_layers(tables, name):
    got_t, want_t, got_c, want_c = tables[name]
    assert got_c == want_c
    peak = sum(r["act_bytes"] for r in want_t.values())
    budgets = [peak, int(peak * 0.9), int(peak * 0.6), int(peak * 0.3),
               1, 0, -5]
    prev = set()
    for budget in budgets:
        for src in ("analytic", "measured"):
            got = R.plan_remat(got_t, budget, peak, candidates=got_c,
                               source=src)
            want = JR.plan_remat(want_t, budget, peak, candidates=want_c,
                                 source=src)
            assert got.to_doc() == want.to_doc(), (name, budget)
            assert got.describe() == want.describe()
        layers = set(got.layers)
        assert layers >= prev, (budget, layers, prev)
        prev = layers
    assert not R.plan_remat(got_t, peak, peak, candidates=got_c).active
    assert set(R.plan_remat(got_t, 0, peak, candidates=got_c).layers) == {
        n for n in got_c if got_t[n]["act_bytes"] > 0}


# tests/test_remat.py's table (flops are the 3x-forward convention)
_TABLE = {
    "cheap_big": {"act_bytes": 1000, "flops": 300.0},    # 0.1 flop/byte
    "mid": {"act_bytes": 500, "flops": 1500.0},          # 1 flop/byte
    "dear_small": {"act_bytes": 100, "flops": 3000.0},   # 10 flop/byte
    "scalar_head": {"act_bytes": 0, "flops": 9.0},       # never picked
}


@pytest.mark.parametrize("budget,peak,want", [
    (0, 1600, ("cheap_big", "mid", "dear_small")),     # maximal
    (1600, 1600, ()),                                  # identity
    (10**9, 1600, ()),
    (1200, 1600, ("cheap_big",)),                      # greedy order
    (600, 1600, ("cheap_big",)),
    (100, 1600, ("cheap_big", "mid")),
])
def test_knapsack_edges_match_jax(budget, peak, want):
    got = R.plan_remat(_TABLE, budget, peak)
    assert got.layers == want
    assert got.to_doc() == JR.plan_remat(_TABLE, budget, peak).to_doc()
    assert got.active == bool(want)


def test_plan_doc_roundtrip_and_describe_match_jax():
    plan = R.plan_remat(_TABLE, 1200, 1600, lm_policy="dots_saveable",
                        source="measured")
    assert R.RematPlan.from_doc(plan.to_doc()) == plan
    jplan = JR.plan_remat(_TABLE, 1200, 1600, lm_policy="dots_saveable",
                          source="measured")
    assert plan.to_doc() == jplan.to_doc()
    assert plan.describe() == jplan.describe()
    assert plan.recompute_flops == pytest.approx(100.0)   # 300 / 3
    assert R.RematPlan().describe() == JR.RematPlan().describe()
    doc = {"layers": ["a"], "lm_policy": True}
    assert R.RematPlan.from_doc(doc).to_doc() == \
        JR.RematPlan.from_doc(doc).to_doc()


# --------------------------------------------------------------------- #
# bitwise arms

def _steps(np_, shapes, remat_plan, batches, seed=3):
    net = Net(np_, "TRAIN", device="cpu", source_shapes=shapes)
    net.manual_seed(seed)
    params = net.init(torch.Generator().manual_seed(seed))
    step = build_train_step(net, SolverParameter(**SOLVER),
                            remat_plan=remat_plan)
    p, s = step.load(params, init_train_state(params))
    losses = []
    for b in batches:
        p, s, m = step.step(p, s, b)
        losses.append(float(m["loss"]))
    return _np_tree(p), _np_tree(s.solver.history), losses, net


def _max_plan(np_, shapes):
    net = Net(np_, "TRAIN", device="cpu", source_shapes=shapes)
    return R.plan_remat(layer_cost_table(net), 0, 0,
                        candidates=R.remat_candidates(net))


def _batches(shape, classes, n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": torch.from_numpy(rs.randn(*shape).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, classes, size=shape[0])
                                       .astype(np.float32))}
            for _ in range(n)]


def test_lenet_steps_bitwise_under_max_remat():
    shapes = zoo.lenet_shapes(4)
    plan = _max_plan(zoo.lenet(with_accuracy=False), shapes)
    assert plan.active and "conv1" in plan.layers
    batches = _batches(shapes["data"], 10, 3)
    p0, h0, l0, _ = _steps(zoo.lenet(with_accuracy=False), shapes, None,
                           batches)
    p1, h1, l1, _ = _steps(zoo.lenet(with_accuracy=False), shapes, plan,
                           batches)
    assert l0 == l1
    _equal(p1, p0, "param")
    _equal(h1, h0, "momentum")


def test_narrow_alexnet_remat_with_both_dropouts_is_bitwise():
    shapes = {"data": (2, 3, 67, 67), "label": (2,)}
    plan = _max_plan(_narrow_alexnet(zoo), shapes)
    assert {"drop6", "drop7", "norm1", "pool1"} <= set(plan.layers)
    batches = _batches(shapes["data"], 10, 2, seed=1)
    p0, h0, l0, _ = _steps(_narrow_alexnet(zoo), shapes, None, batches)
    p1, h1, l1, net = _steps(_narrow_alexnet(zoo), shapes, plan, batches)
    assert l0 == l1
    _equal(p1, p0, "param")
    _equal(h1, h0, "momentum")
    # both arms leave the dropout stream at the same place
    p2, _, _, net0 = _steps(_narrow_alexnet(zoo), shapes, None, batches)
    assert torch.equal(net.generator.get_state(), net0.generator.get_state())


def test_recomputed_dropout_replays_its_forward_mask():
    """A checkpointed DROPOUT's backward: the input gradient is zero
    exactly where the forward dropped, although the generator moved on
    between the forward and the backward."""
    np_ = zoo.lenet(with_accuracy=False)
    at = [lp.name for lp in np_.layers].index("relu1") + 1
    np_.layers.insert(at, zoo.dropout("drop1", "ip1"))
    net = Net(np_, "TRAIN", device="cpu", source_shapes=zoo.lenet_shapes(4))
    net.manual_seed(5)
    params = net.init(torch.Generator().manual_seed(0))
    x = torch.randn(4, 500, requires_grad=True)
    drop = net._layer_by_name["drop1"]
    (top,) = net._checkpointed(drop, {}, [x], True, None)
    torch.rand(1000, generator=net.generator)      # the stream moves on
    after = net.generator.get_state()
    top.sum().backward()
    assert torch.equal(x.grad != 0, top != 0)
    assert torch.equal(net.generator.get_state(), after)
    assert params


def test_unknown_remat_layer_refuses():
    net = Net(zoo.lenet(with_accuracy=False), "TRAIN", device="cpu",
              source_shapes=zoo.lenet_shapes(2))
    params = net.init(torch.Generator().manual_seed(0))
    b = _batches((2, 1, 28, 28), 10, 1)[0]
    with pytest.raises(ValueError, match="remat names unknown layers"):
        net.apply(params, b, train=True, remat={"not_a_layer"})


def test_measured_side_on_the_cpu():
    net = Net(zoo.lenet(with_accuracy=False), "TRAIN", device="cpu",
              source_shapes=zoo.lenet_shapes(2))
    params = net.init(torch.Generator().manual_seed(0))
    b = _batches((2, 1, 28, 28), 10, 1)[0]
    assert R.measured_peak_bytes(net, params, b) == 0
    assert R.default_budget_bytes("cpu") == 0
    plan = R.plan_for_net_step(net, params, b, 1)
    assert plan.source == "analytic" and plan.active
    table = layer_cost_table(net)
    assert plan.measured_peak_bytes == sum(r["act_bytes"]
                                           for r in table.values())
    roomy = R.plan_for_net_step(net, params, b, 10**12)
    assert not roomy.active


# --------------------------------------------------------------------- #
# the engine

SMALL_NET = """
name: "SmallNet"
layers {
  name: "mnist" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 1 height: 12 width: 12 }
}
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers {
  name: "ip1" type: INNER_PRODUCT bottom: "conv1" top: "ip1"
  inner_product_param { num_output: 16
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "drop1" type: DROPOUT bottom: "ip1" top: "ip1"
  dropout_param { dropout_ratio: 0.4 } }
layers {
  name: "ip2" type: INNER_PRODUCT bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip2" bottom: "label"
  top: "loss" }
"""


def _small_sp(max_iter=8):
    from poseidon_tpu_torch.proto.messages import load_net_from_string
    return SolverParameter(train_net_param=load_net_from_string(SMALL_NET),
                           base_lr=0.05, lr_policy="fixed", momentum=0.9,
                           weight_decay=0.0005, display=4,
                           max_iter=max_iter, random_seed=3)


def _memory_data():
    rs = np.random.RandomState(0)
    return {"data": rs.randn(64, 1, 12, 12).astype(np.float32),
            "label": rs.randint(0, 5, size=64)}


def test_engine_remat_flag_is_bitwise_to_no_remat(tmp_path):
    from poseidon_tpu_torch.runtime.engine import Engine
    finals = {}
    for arm, remat in (("stored", None), ("remat", "conv1,ip1,drop1"),
                       ("auto", "auto")):
        d = tmp_path / arm
        d.mkdir()
        eng = Engine(_small_sp(), memory_data=_memory_data(),
                     output_dir=str(d), device="cpu", remat=remat)
        try:
            eng.train()
            finals[arm] = _np_tree(eng.params)
            plan = eng.remat_plan
            if arm == "remat":
                assert plan.source == "flag"
                assert set(plan.layers) == {"conv1", "ip1", "drop1"}
                assert eng.train_step.remat == plan.layer_set
            elif arm == "auto":
                # no budget: maximal remat, planned analytically
                assert plan.source == "analytic"
                assert "drop1" in plan.layers
            else:
                assert plan is None and eng.train_step.remat is None
        finally:
            eng.close()
        if arm != "stored":
            import yaml
            doc = yaml.safe_load((d / "stats.yaml").read_text())
            assert doc["remat"] == plan.to_doc()
    _equal(finals["remat"], finals["stored"], "engine params (flag)")
    _equal(finals["auto"], finals["stored"], "engine params (auto)")


def test_engine_remat_budget_rules(tmp_path, capsys):
    from poseidon_tpu_torch.runtime.engine import Engine

    def run(**kw):
        d = tmp_path / str(len(list(tmp_path.iterdir())))
        d.mkdir()
        eng = Engine(_small_sp(max_iter=1), memory_data=_memory_data(),
                     output_dir=str(d), device="cpu", **kw)
        try:
            return eng.remat_plan, eng.train_step.remat
        finally:
            eng.close()

    capsys.readouterr()
    plan, _ = run(hbm_budget_gb=-1)
    assert plan is None
    plan, _ = run(hbm_budget_gb=1e-9, remat="auto")
    assert plan.source == "analytic" and plan.active
    assert plan.budget_bytes == int(1e-9 * 2**30)
    plan, _ = run(hbm_budget_gb=100.0)          # fits: identity, dropped
    assert plan is None
    plan, layers = run(remat="conv1", staleness=1)
    assert plan is None and layers is None
    with pytest.raises(ValueError, match="unknown layers"):
        run(remat="conv1,nope")
    warnings = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("WARNING")]
    assert warnings == [
        "WARNING: --hbm_budget_gb auto needs device memory stats (none on "
        "this backend); pass an explicit budget — skipping remat planning",
        "WARNING: --hbm_budget_gb/--remat are ignored under SSP staleness "
        "(the local-step path has no remat wiring yet)"]
    import inspect
    from poseidon_tpu.runtime import engine as jax_engine
    src = inspect.getsource(jax_engine)
    assert '"WARNING: --hbm_budget_gb/--remat are ignored under SSP "' in src
    assert '"WARNING: --hbm_budget_gb auto needs device memory "' in src


def test_cli_passes_remat_flags(tmp_path, monkeypatch):
    from poseidon_tpu_torch.runtime import cli, engine
    seen = {}

    class FakeEngine:
        def __init__(self, sp, **kw):
            seen.update(kw)

        def train(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(engine, "Engine", FakeEngine)
    sp = tmp_path / "solver.prototxt"
    sp.write_text('net: "x.prototxt"\nbase_lr: 0.1\nmax_iter: 1\n')
    args = cli.build_parser().parse_args(
        ["train", "--solver", str(sp), "--device", "cpu", "--remat", "auto",
         "--hbm_budget_gb", "-1"])
    cli.cmd_train(args)
    assert seen["remat"] == "auto" and seen["hbm_budget_gb"] == -1.0
    args = cli.build_parser().parse_args(
        ["train", "--solver", str(sp), "--device", "cpu"])
    cli.cmd_train(args)
    # unset flags resolve through the tuned plan to the built-in defaults
    # (no remat, a budget of 0: none), as in the JAX CLI
    assert seen["remat"] is None and seen["hbm_budget_gb"] == 0.0


# --------------------------------------------------------------------- #
# the mesh

def test_mesh_dp2_fsdp2_remat_arm_is_bitwise(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(MESH_WORLD),
         str(tmp_path / "store"), str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    ranks = []
    for r in range(MESH_WORLD):
        with np.load(tmp_path / f"mesh.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(tmp_path / f"mesh.rank{r}.json") as f:
            assert json.load(f)["layers"]
        stored = {k[len("stored/"):]: v for k, v in arrays.items()
                  if k.startswith("stored/")}
        remat = {k[len("remat/"):]: v for k, v in arrays.items()
                 if k.startswith("remat/")}
        assert set(stored) == set(remat) and len(stored) > 1
        for k in stored:
            np.testing.assert_array_equal(remat[k], stored[k],
                                          err_msg=f"rank {r} {k}")
        ranks.append(stored)
    for r in range(1, MESH_WORLD):
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][k], v)


_IMPORT = r"""
import sys
from poseidon_tpu_torch.runtime import attribution
from poseidon_tpu_torch.core import remat
assert attribution.layer_cost_table and remat.plan_for_net_step
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "poseidon_tpu"))
assert not bad, bad
"""


def test_planner_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
