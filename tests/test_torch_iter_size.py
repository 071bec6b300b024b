"""Gradient accumulation (``iter_size`` K > 1) in the port against the JAX
package's, on the CPU, on LeNet (no dropout: the two packages' random
streams differ).

- The port at K=2, batch B against JAX's ``build_train_step(iter_size=2)``
  on a one-device mesh (weights through ``params_from_jax``, the same
  numpy micro-batches) and against the port at K=1, batch 2B on the same
  rows: parameters and momentum after 2 steps at PARAM_TOL (rtol 1e-4,
  atol 1e-6, ``tests/test_torch_train.py``'s: XLA's and PyTorch's CPU
  convolutions and GEMMs sum in other orders), losses at rtol 1e-5.
- TOPK on the accumulated gradient: the residual against JAX's row at
  PARAM_TOL.
- A 2-rank gloo job (this file run as a script, one process a rank): K=2
  with DENSE and with SFB layers against one rank at K=1 over all the
  rows and against JAX's 2-device mesh at K=2, at PARAM_TOL; the DENSE
  buckets are issued once a step, after the accumulation (no hook
  registered, no bucket issued mid-backward), and the SFB warning is
  JAX's, word for word.
- The engine's rules, JAX's words: iter_size runs 1, with a warning, under
  SSP staleness, an active ``--mesh`` and HDF5_OUTPUT in the TRAIN net; an
  engine at K=2 trains JAX's ``tests/test_runtime.py`` task to its bar.
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

from poseidon_tpu_torch.core.net import Net, params_from_jax  # noqa: E402
from poseidon_tpu_torch.parallel import strategies as S  # noqa: E402
from poseidon_tpu_torch.parallel.trainer import (  # noqa: E402
    build_train_step, init_train_state)
from poseidon_tpu_torch.proto.messages import (  # noqa: E402
    SolverParameter, load_net)
from poseidon_tpu_torch.runtime import cluster  # noqa: E402

LENET = "examples/mnist/lenet_train_test.prototxt"
B = 4            # rows of one micro-batch on one rank
K = 2
WORLD = 2
STEPS = 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)
WORKER_TIMEOUT_S = 60
RUNS = {"dense": {}, "sfb": {"ip1": S.SFB, "ip2": S.SFB}}


def _shapes(rows):
    return {"data": (rows, 1, 28, 28), "label": (rows,)}


def _port_net(rows):
    return Net(load_net(os.path.join(REPO, LENET)), "TRAIN", device="cpu",
               source_shapes=_shapes(rows))


def _tensors(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _run_port(params, batches, iter_size, rows, comm=None):
    """One-device port steps over ``batches`` (each (K, rows, ...)
    arrays): under iter_size K each step takes the K micro-batches, under
    1 the concatenation of every micro-batch's rows."""
    sp = SolverParameter(**SOLVER, iter_size=iter_size)
    step = build_train_step(_port_net(rows), sp, None, comm)
    params, state = step.load(params, init_train_state(params, comm))
    losses = []
    for b in batches:
        if iter_size > 1:
            x = [_tensors({t: v[m] for t, v in b.items()})
                 for m in range(iter_size)]
        else:
            x = _tensors({t: v.reshape((-1,) + v.shape[2:])
                          for t, v in b.items()})
        params, state, m = step.step(params, state, x)
        losses.append(float(m["loss"]))
    clone = lambda t: {l: {p: v.detach().clone().numpy()  # noqa: E731
                           for p, v in d.items()} for l, d in t.items()}
    return (clone(params), clone(state.solver.history), losses,
            clone(state.comm_error), step)


# --------------------------------------------------------------------- #
# the 2-rank worker

def _worker(rank: int, world: int, store: str, d: str) -> int:
    import io
    from contextlib import redirect_stdout
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        with np.load(os.path.join(d, "in.npz")) as z:
            params = {}
            for k in z.files:
                if k.startswith("params/"):
                    _, l, p = k.split("/")
                    params.setdefault(l, {})[p] = torch.from_numpy(z[k])
            batches = [{t: z[f"batch{s}/{t}"] for t in ("data", "label")}
                       for s in range(STEPS)]
        report = {}
        for case, strategies in RUNS.items():
            comm = S.CommConfig(layer_strategies=dict(strategies))
            out = io.StringIO()
            with redirect_stdout(out):
                step = build_train_step(
                    _port_net(B), SolverParameter(**SOLVER, iter_size=K),
                    group, comm)
            sync = step.sync
            n_issued = [0]
            orig = sync._issue

            def issue(bucket, orig=orig, n_issued=n_issued):
                n_issued[0] += 1
                return orig(bucket)

            sync._issue = issue
            pt, st = step.load({l: {k: v.clone() for k, v in dv.items()}
                                for l, dv in params.items()},
                               init_train_state(params, comm, world))
            losses, trace = [], []
            for b in batches:
                x = [_tensors({t: v[m, rank * B:(rank + 1) * B]
                               for t, v in b.items()}) for m in range(K)]
                n_issued[0] = 0
                pt, st, m = step.step(pt, st, x)
                losses.append(float(m["loss"]))
                trace.append({"issue_calls": n_issued[0],
                              "issued": list(sync.issued),
                              "mid_backward": sync.issued_mid_backward})
            arrays = {f"params/{l}/{k}": v.detach().numpy()
                      for l, dv in pt.items() for k, v in dv.items()}
            arrays.update({f"history/{l}/{k}": v.numpy()
                           for l, dv in st.solver.history.items()
                           for k, v in dv.items()})
            np.savez(os.path.join(d, f"{case}.rank{rank}.npz"), **arrays)
            report[case] = {
                "losses": losses, "trace": trace,
                "n_hooked": len(sync.hooked), "n_fused": len(sync.fused),
                "hooks_registered": any(
                    getattr(leaf, "_post_accumulate_grad_hooks", None)
                    for leaf in step.leaves),
                "warnings": [ln for ln in out.getvalue().splitlines()
                             if ln.startswith("WARNING")]}
        with open(os.path.join(d, f"report.rank{rank}.json"), "w") as f:
            json.dump(report, f)
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
from jax.sharding import Mesh  # noqa: E402

from poseidon_tpu.core.net import Net as JaxNet  # noqa: E402
from poseidon_tpu.parallel import strategies as JS  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402
from poseidon_tpu.parallel.trainer import build_train_step as jax_step  # noqa: E402,E501
from poseidon_tpu.parallel.trainer import init_train_state as jax_state  # noqa: E402,E501
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver  # noqa: E402,E501
from poseidon_tpu.proto.messages import load_net as jax_load_net  # noqa: E402


def _inputs(seed, rows_total):
    """(params as numpy from JAX's init, STEPS batches of (K, rows_total,
    ...) arrays)."""
    jnet = JaxNet(jax_load_net(os.path.join(REPO, LENET)), "TRAIN",
                  conv_layout="NCHW", source_shapes=_shapes(B))
    params = jax.tree_util.tree_map(np.asarray,
                                    jnet.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 100)
    batches = [{"data": rs.randn(K, rows_total, 1, 28, 28)
                .astype(np.float32),
                "label": rs.randint(0, 10, size=(K, rows_total))
                .astype(np.float32)} for _ in range(STEPS)]
    return params, batches


def _run_jax(params, batches, n_dev, comm=None):
    jnet = JaxNet(jax_load_net(os.path.join(REPO, LENET)), "TRAIN",
                  conv_layout="NCHW", source_shapes=_shapes(B))
    mesh = (make_mesh(n_dev) if n_dev > 1
            else Mesh(np.array(jax.devices()[:1]), ("data",)))
    ts = jax_step(jnet, JaxSolver(**SOLVER), mesh, comm, iter_size=K,
                  donate=False)
    state = jax_state(params, comm, n_dev) if comm is not None \
        else jax_state(params)
    losses = []
    for b in batches:
        params, state, m = ts.step(params, state, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (np_tree(params), np_tree(state.solver.history), losses,
            np_tree(state.comm_error))


def _assert_trees_close(got, want, what, **tol):
    assert set(got) == set(want)
    for l in want:
        for p in want[l]:
            np.testing.assert_allclose(np.asarray(got[l][p]),
                                       np.asarray(want[l][p]),
                                       **(tol or PARAM_TOL),
                                       err_msg=f"{what} {l}/{p}")


def _port_params(params):
    return params_from_jax(_port_net(B), params)


def test_iter_size_matches_jax_and_the_double_batch():
    params, batches = _inputs(seed=3, rows_total=B)
    jp, jh, jl, _ = _run_jax(params, batches, 1)
    pp, ph, pl, _, step = _run_port(_port_params(params), batches, K, B)
    bp, bh, bl, _, _ = _run_port(_port_params(params), batches, 1, K * B)
    assert step.iter_size == K and step.sync is None
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pl, bl, rtol=LOSS_RTOL)
    assert pl[1] != pl[0]
    _assert_trees_close(pp, jp, "param vs JAX")
    _assert_trees_close(ph, jh, "momentum vs JAX")
    _assert_trees_close(pp, bp, "param vs the double batch")
    _assert_trees_close(ph, bh, "momentum vs the double batch")


def test_iter_size_topk_residual_matches_jax():
    params, batches = _inputs(seed=5, rows_total=B)
    jcomm = JS.CommConfig(default_strategy="topk", topk_fraction=0.1)
    comm = S.CommConfig(default_strategy=S.TOPK, topk_fraction=0.1)
    jp, jh, jl, je = _run_jax(params, batches, 1, jcomm)
    pp, ph, pl, pe, _ = _run_port(_port_params(params), batches, K, B, comm)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    _assert_trees_close(pp, jp, "param")
    _assert_trees_close(ph, jh, "momentum")
    assert set(pe) == set(je) == set(params)
    for l in je:
        for p in je[l]:
            assert pe[l][p].shape == je[l][p].shape
            assert np.abs(je[l][p]).sum() > 0      # something was held back
    _assert_trees_close(pe, je, "TOPK residual")


def test_iter_size_step_refusals():
    net = _port_net(B)
    step = build_train_step(net, SolverParameter(**SOLVER, iter_size=K))
    params, state = step.load(net.init(torch.Generator().manual_seed(0)),
                              init_train_state(net.init(
                                  torch.Generator().manual_seed(0))))
    mb = _tensors({"data": np.zeros((B, 1, 28, 28), np.float32),
                   "label": np.zeros((B,), np.float32)})
    with pytest.raises(ValueError, match="takes 2 micro-batches a step, "
                                         "got 1"):
        step.step(params, state, [mb])
    step.dump_blobs = ("ip1",)
    with pytest.raises(ValueError, match="incompatible with dump_blobs"):
        step.step(params, state, [mb, mb])


@pytest.fixture(scope="module")
def iter_size_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("iter_size")
    params, batches = _inputs(seed=11, rows_total=WORLD * B)
    arrays = {f"params/{l}/{p}": v for l, lv in params.items()
              for p, v in lv.items()}
    for s, b in enumerate(batches):
        arrays.update({f"batch{s}/{t}": v for t, v in b.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(d / "store"), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
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
    for r in range(WORLD):
        with open(d / f"report.rank{r}.json") as f:
            rep = json.load(f)
        for case in RUNS:
            with np.load(d / f"{case}.rank{r}.npz") as z:
                rep[case]["arrays"] = {k: z[k] for k in z.files}
        ranks.append(rep)
    return params, batches, ranks


def _split(arrays, kind):
    out = {}
    for k, v in arrays.items():
        if k.startswith(kind + "/"):
            _, l, p = k.split("/")
            out.setdefault(l, {})[p] = v
    return out


@pytest.mark.parametrize("case", list(RUNS))
def test_two_rank_iter_size_matches_one_rank_and_jax(iter_size_run, case):
    params, batches, ranks = iter_size_run
    bp, bh, bl, _, _ = _run_port(_port_params(params), batches, 1,
                                 K * WORLD * B)
    jcomm = JS.CommConfig(layer_strategies=dict(RUNS[case]))
    jp, jh, jl, _ = _run_jax(params, batches, WORLD, jcomm)
    for r, rep in enumerate(ranks):
        got = rep[case]
        np.testing.assert_allclose(got["losses"], bl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL)
        p, h = _split(got["arrays"], "params"), _split(got["arrays"],
                                                        "history")
        _assert_trees_close(p, bp, f"rank {r} {case} param vs one rank")
        _assert_trees_close(h, bh, f"rank {r} {case} momentum vs one rank")
        _assert_trees_close(p, jp, f"rank {r} {case} param vs JAX")
        _assert_trees_close(h, jh, f"rank {r} {case} momentum vs JAX")
    # the two ranks end bitwise equal
    for k, v in ranks[0][case]["arrays"].items():
        np.testing.assert_array_equal(v, ranks[1][case]["arrays"][k])


@pytest.mark.parametrize("case", list(RUNS))
def test_dense_sync_issued_once_a_step_after_accumulation(iter_size_run,
                                                          case):
    _, _, ranks = iter_size_run
    for rep in ranks:
        got = rep[case]
        assert not got["hooks_registered"]
        assert got["n_hooked"] >= 1
        # SFB: one post-accumulation bucket a leaf of ip1 and ip2
        assert got["n_fused"] == (4 if case == "sfb" else 0)
        for t in got["trace"]:
            assert t["issued"] == list(range(got["n_hooked"]))
            assert t["issue_calls"] == got["n_hooked"] + got["n_fused"]
            assert t["mid_backward"] == 0


def test_sfb_warning_is_jaxs(iter_size_run, capsys):
    _, _, ranks = iter_size_run
    jnet = JaxNet(jax_load_net(os.path.join(REPO, LENET)), "TRAIN",
                  conv_layout="NCHW", source_shapes=_shapes(B))
    capsys.readouterr()
    jax_step(jnet, JaxSolver(**SOLVER), make_mesh(WORLD),
             JS.CommConfig(layer_strategies=dict(RUNS["sfb"])), iter_size=K)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("WARNING")]
    assert len(want) == 1 and "SFB layers" in want[0]
    assert ranks[0]["sfb"]["warnings"] == want
    assert ranks[1]["sfb"]["warnings"] == []     # rank 0 logs
    assert ranks[0]["dense"]["warnings"] == []


# --------------------------------------------------------------------- #
# the engine's rules

SMALL_NET = """
name: "SmallNet"
layers {
  name: "mnist" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: %(batch)d channels: 1 height: 12 width: 12 }
}
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2
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
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label" top: "loss" }
layers { name: "acc" type: ACCURACY bottom: "ip1" bottom: "label" top: "accuracy"
  include { phase: TEST } }
"""
SMALL_SOLVER = """
net: "%(net)s"
base_lr: 0.05
lr_policy: "fixed"
momentum: 0.9
weight_decay: 0.0005
display: 10
max_iter: %(max_iter)d
test_iter: 4
test_interval: 15
test_initialization: false
snapshot: 0
iter_size: 2
"""


def _memory_data(n=256, seed=0):
    """tests/test_runtime.py's task: 5 class templates plus noise."""
    rs = np.random.RandomState(seed)
    templates = rs.randn(5, 1, 12, 12).astype(np.float32)
    labels = rs.randint(0, 5, size=n)
    data = templates[labels] + 0.25 * rs.randn(n, 1, 12, 12).astype(
        np.float32)
    return {"data": data, "label": labels}


def _small_solver(tmp_path, batch=64, max_iter=30):
    from poseidon_tpu_torch.proto.messages import load_solver_from_string
    net = tmp_path / "net.prototxt"
    net.write_text(SMALL_NET % {"batch": batch})
    return load_solver_from_string(SMALL_SOLVER % {"net": net,
                                                   "max_iter": max_iter})


def test_engine_trains_at_iter_size_2_as_jaxs_test(tmp_path):
    """tests/test_runtime.py::test_engine_iter_size's task and bar: the
    JAX engine's 8 devices x batch 8 x K 2 rows a step are the port's
    batch 64 x K 2; the loss falls below 0.3 and the test accuracy
    passes 0.9, the test pass between steps included."""
    from poseidon_tpu_torch.runtime.engine import Engine
    eng = Engine(_small_solver(tmp_path), memory_data=_memory_data(),
                 output_dir=str(tmp_path), device="cpu")
    calls = []
    orig = eng.train_step.step
    eng.train_step.step = lambda p, s, b: (calls.append(len(b)),
                                           orig(p, s, b))[1]
    try:
        assert eng.iter_size == 2 and eng.train_step.iter_size == 2
        last = eng.train()
        assert last["loss"] < 0.3, f"did not converge: {last}"
        assert eng.test(0)["accuracy"] > 0.9
    finally:
        eng.close()
    assert calls == [2] * 30
    assert eng.iteration() == 30


def _jax_engine_source():
    import inspect
    from poseidon_tpu.runtime import engine as jax_engine
    return inspect.getsource(jax_engine)


def _iter_size_warnings(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("WARNING") and "iter_size" in ln]


def test_engine_runs_iter_size_1_under_staleness(tmp_path, capsys):
    from poseidon_tpu_torch.runtime.engine import Engine
    capsys.readouterr()
    eng = Engine(_small_solver(tmp_path, batch=8, max_iter=2),
                 memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", staleness=1)
    try:
        assert eng.iter_size == 1
        eng.train()
    finally:
        eng.close()
    got = _iter_size_warnings(capsys)
    assert got == ["WARNING: iter_size > 1 ignored under SSP staleness "
                   "(increase batch_size instead)"]
    src = _jax_engine_source()
    assert '"WARNING: iter_size > 1 ignored under SSP staleness "' in src
    assert '"(increase batch_size instead)"' in src


def test_engine_runs_iter_size_1_under_an_active_mesh(tmp_path, capsys):
    """The --mesh rule, on the engine's resolver (an active mesh needs a
    world of its devices; tests/test_torch_spmd.py drives those)."""
    from poseidon_tpu_torch.runtime.engine import Engine
    eng = Engine(_small_solver(tmp_path, batch=8, max_iter=1),
                 memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu")
    try:
        capsys.readouterr()
        eng.plan = object()       # what an active --mesh leaves here
        assert eng._resolve_iter_size(False) == 1
        eng.plan = None
        assert eng._resolve_iter_size(False) == 2
    finally:
        eng.close()
    want = ("WARNING: iter_size > 1 does not compose with --mesh sharding "
            "yet; running iter_size=1")
    assert _iter_size_warnings(capsys) == [want]
    src = _jax_engine_source()
    assert '"WARNING: iter_size > 1 does not compose with --mesh "' in src


def test_engine_runs_iter_size_1_with_train_hdf5_output(tmp_path, capsys):
    pytest.importorskip("h5py")
    from poseidon_tpu_torch.runtime.engine import Engine
    sp = _small_solver(tmp_path, batch=8, max_iter=2)
    net = tmp_path / "net.prototxt"
    net.write_text(net.read_text() + (
        'layers { name: "dump" type: HDF5_OUTPUT bottom: "ip1" '
        'include { phase: TRAIN } hdf5_output_param '
        '{ file_name: "dumps/f.h5" } }\n'))
    capsys.readouterr()
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu")
    try:
        assert eng.iter_size == 1 and eng.train_step.iter_size == 1
        eng.train()
    finally:
        eng.close()
    assert _iter_size_warnings(capsys) == [
        "WARNING: iter_size > 1 ignored with HDF5_OUTPUT in the TRAIN net "
        "(per-iteration dump semantics)"]
    assert (tmp_path / "dumps/f.h5").exists()
