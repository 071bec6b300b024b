"""K train steps a dispatch (``steps_per_dispatch``, JAX's ``scan_steps``)
in the port, on the CPU, where ``TrainStep.multi_step`` runs the K steps
one after another (the plain version of the card's CUDA graph, which
``chip_smoke.py``'s ``[dispatch]`` holds bitwise to eager steps).

- Against JAX: the port's K=4 dispatch on LeNet against JAX's
  ``build_train_step(scan_steps=4)`` on a one-device mesh (weights through
  ``params_from_jax``, the same numpy batches), under DENSE, SFB and TOPK:
  per-step losses at rtol 1e-5, parameters and momentum at PARAM_TOL (rtol
  1e-4, atol 1e-6: XLA's and PyTorch's CPU convolutions and GEMMs sum in
  other orders), the TOPK residual too.
- Against single steps, bitwise: K=4 chunks against 4 single steps on a
  LeNet with a DROPOUT layer (the masks come from the same stream), at
  iter_size 1 and 2 (``[K, iter_size, ...]`` inputs); ``reuse_batch``
  against K copies of one batch; the rates of an ``inv`` policy.
- The engine: ``steps_per_dispatch`` 4 against 1 across display, test and
  snapshot boundaries that do not fall on chunk edges, bitwise (final
  params, momentum, every display row, every test row, every snapshot);
  chunks run only between boundaries.
- The refusals, JAX's words: steps_per_dispatch runs 1, with a warning,
  under SSP staleness, an active ``--mesh`` and HDF5_OUTPUT in the TRAIN
  net; gloo ranks on the card (``graph_refusal``, the decision function)
  and the TOPK policies that pick by the host's counter are refused.
- A 2-rank gloo job (this file run as a script, one process a rank): the
  K=4 dispatch over DENSE buckets against JAX's ``scan_steps=4`` on its
  2-device virtual mesh at PARAM_TOL, the ranks bitwise to each other.
- The fetcher reads a dispatch's [K] metrics as K rows.
"""

import dataclasses
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
from poseidon_tpu_torch.models import zoo  # noqa: E402
from poseidon_tpu_torch.parallel import strategies as S  # noqa: E402
from poseidon_tpu_torch.parallel.trainer import (  # noqa: E402
    build_train_step, init_train_state)
from poseidon_tpu_torch.proto.messages import SolverParameter  # noqa: E402
from poseidon_tpu_torch.runtime import cluster  # noqa: E402

B = 4            # rows of one step's batch on one rank
K = 4
WORLD = 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)
WORKER_TIMEOUT_S = 60
COMMS = {"dense": {},
         "sfb": {"layer_strategies": {"ip1": S.SFB}},
         "topk": {"layer_strategies": {"ip2": S.TOPK},
                  "topk_fraction": 0.25}}


def _port_net(rows, dropout=False):
    np_ = zoo.lenet(with_accuracy=False)
    if dropout:
        at = [lp.name for lp in np_.layers].index("relu1") + 1
        np_.layers.insert(at, zoo.dropout("drop1", "ip1"))
    return Net(np_, "TRAIN", device="cpu", source_shapes=zoo.lenet_shapes(rows))


def _tensors(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _np_tree(t):
    return {l: {p: v.detach().clone().numpy() for p, v in d.items()}
            for l, d in t.items()}


def _stacked(rs, k, rows, lead=()):
    return {"data": rs.randn(k, *lead, rows, 1, 28, 28).astype(np.float32),
            "label": rs.randint(0, 10, size=(k, *lead, rows))
            .astype(np.float32)}


# --------------------------------------------------------------------- #
# the 2-rank worker

def _worker(rank: int, world: int, store: str, d: str) -> int:
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
            stack = {t: z[t][:, rank * B:(rank + 1) * B] for t in
                     ("data", "label")}
        step = build_train_step(_port_net(B), SolverParameter(**SOLVER),
                                group, S.CommConfig(), steps_per_dispatch=K)
        p, s = step.load(params, init_train_state(params, S.CommConfig(),
                                                  world))
        p, s, m = step.multi_step(p, s, _tensors(stack))
        arrays = {f"params/{l}/{k}": v
                  for l, dv in _np_tree(p).items() for k, v in dv.items()}
        arrays.update({f"history/{l}/{k}": v for l, dv in
                       _np_tree(s.solver.history).items()
                       for k, v in dv.items()})
        np.savez(os.path.join(d, f"out.rank{rank}.npz"), **arrays)
        with open(os.path.join(d, f"report.rank{rank}.json"), "w") as f:
            json.dump({"losses": m["loss"].tolist(), "it": s.solver.it}, f)
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
from poseidon_tpu.models import zoo as jzoo  # noqa: E402
from poseidon_tpu.parallel import strategies as JS  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402
from poseidon_tpu.parallel.trainer import build_train_step as jax_step  # noqa: E402,E501
from poseidon_tpu.parallel.trainer import init_train_state as jax_state  # noqa: E402,E501
from poseidon_tpu.parallel.trainer import stack_batches  # noqa: E402
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver  # noqa: E402,E501


def _jax_params(seed):
    jnet = JaxNet(jzoo.lenet(with_accuracy=False), "TRAIN",
                  conv_layout="NCHW", source_shapes=jzoo.lenet_shapes(B))
    return jax.tree_util.tree_map(np.asarray,
                                  jnet.init(jax.random.PRNGKey(seed)))


def _run_jax_scan(params, stack, n_dev, comm_kw):
    jnet = JaxNet(jzoo.lenet(with_accuracy=False), "TRAIN",
                  conv_layout="NCHW", source_shapes=jzoo.lenet_shapes(B))
    mesh = (make_mesh(n_dev) if n_dev > 1
            else Mesh(np.array(jax.devices()[:1]), ("data",)))
    comm = JS.CommConfig(**{k: (dict(v) if isinstance(v, dict) else v)
                            for k, v in comm_kw.items()})
    ts = jax_step(jnet, JaxSolver(**SOLVER), mesh, comm, scan_steps=K,
                  donate=False)
    batches = stack_batches([{t: v[i] for t, v in stack.items()}
                             for i in range(K)], ts.batch_sharding)
    p, s, m = ts.step(params, jax_state(params, comm, n_dev), batches,
                      jax.random.PRNGKey(0))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (np_tree(p), np_tree(s.solver.history), np.asarray(m["loss"]),
            np_tree(s.comm_error), int(s.solver.it))


def _close(got, want, what, **tol):
    assert set(got) == set(want)
    for l in want:
        for p in want[l]:
            np.testing.assert_allclose(np.asarray(got[l][p]),
                                       np.asarray(want[l][p]),
                                       **(tol or PARAM_TOL),
                                       err_msg=f"{what} {l}/{p}")


def _equal(got, want, what):
    assert set(got) == set(want)
    for l in want:
        for p in want[l]:
            np.testing.assert_array_equal(np.asarray(got[l][p]),
                                          np.asarray(want[l][p]),
                                          err_msg=f"{what} {l}/{p}")


@pytest.mark.parametrize("case", list(COMMS))
def test_k_step_dispatch_matches_jax_scan(case):
    params = _jax_params(seed=3)
    stack = _stacked(np.random.RandomState(103), K, B)
    jp, jh, jl, je, jit = _run_jax_scan(params, stack, 1, COMMS[case])
    net = _port_net(B)
    comm = S.CommConfig(**{k: (dict(v) if isinstance(v, dict) else v)
                           for k, v in COMMS[case].items()})
    step = build_train_step(net, SolverParameter(**SOLVER), None, comm,
                            steps_per_dispatch=K)
    pt = params_from_jax(net, params)
    p, s = step.load(pt, init_train_state(pt, comm))
    p, s, m = step.multi_step(p, s, _tensors(stack))
    assert m["loss"].shape == (K,) and s.solver.it == jit == K
    np.testing.assert_allclose(m["loss"].numpy(), jl, rtol=LOSS_RTOL)
    assert len(set(m["loss"].tolist())) == K         # the steps moved
    _close(_np_tree(p), jp, "param")
    _close(_np_tree(s.solver.history), jh, "momentum")
    if case == "topk":
        got = _np_tree(s.comm_error)
        assert set(got) == set(je) == {"ip2"}
        assert np.abs(je["ip2"]["w"]).sum() > 0
        _close(got, je, "TOPK residual")


def _single_vs_chunked(iter_size, dropout=True, reuse=False):
    """K single steps against one K-chunk of the same batches and masks;
    -> (single, chunked) each (params, history, losses)."""
    rs = np.random.RandomState(7)
    lead = (iter_size,) if iter_size > 1 else ()
    stack = (_stacked(rs, 1, B, lead) if reuse
             else _stacked(rs, K, B, lead))
    if reuse:
        stack = {t: v[0] for t, v in stack.items()}
    sp = SolverParameter(**SOLVER, iter_size=iter_size)
    out = []
    for chunked in (False, True):
        net = _port_net(B, dropout)
        net.manual_seed(11)
        params = net.init(torch.Generator().manual_seed(5))
        step = build_train_step(net, sp, steps_per_dispatch=K if chunked
                                else 1, reuse_batch=reuse)
        p, s = step.load(params, init_train_state(params))
        if chunked:
            p, s, m = step.multi_step(p, s, _tensors(stack))
            losses = m["loss"].tolist()
        else:
            losses = []
            for i in range(K):
                row = stack if reuse else {t: v[i] for t, v in
                                           stack.items()}
                b = _tensors(row)
                if iter_size > 1:
                    b = [{t: v[j] for t, v in b.items()}
                         for j in range(iter_size)]
                p, s, mi = step.step(p, s, b)
                losses.append(float(mi["loss"]))
        assert s.solver.it == K
        out.append((_np_tree(p), _np_tree(s.solver.history), losses))
    return out


@pytest.mark.parametrize("iter_size", [1, 2])
def test_k_chunked_is_bitwise_k_single_steps_with_dropout(iter_size):
    (p1, h1, l1), (pk, hk, lk) = _single_vs_chunked(iter_size)
    assert l1 == lk
    _equal(pk, p1, "param")
    _equal(hk, h1, "momentum")


def test_reuse_batch_matches_a_repeated_batch():
    (p1, h1, l1), (pk, hk, lk) = _single_vs_chunked(1, dropout=False,
                                                   reuse=True)
    assert l1 == lk and len(set(l1)) == K
    _equal(pk, p1, "param")
    _equal(hk, h1, "momentum")


def test_multi_step_refuses_wrong_lead_axes_and_dump_blobs():
    net = _port_net(B)
    step = build_train_step(net, SolverParameter(**SOLVER),
                            steps_per_dispatch=K)
    params = net.init(torch.Generator().manual_seed(0))
    p, s = step.load(params, init_train_state(params))
    bad = _tensors(_stacked(np.random.RandomState(0), K - 1, B))
    with pytest.raises(ValueError, match=r"leading axes \(4,\)"):
        step.multi_step(p, s, bad)
    step.dump_blobs = ("ip1",)
    good = _tensors(_stacked(np.random.RandomState(0), K, B))
    with pytest.raises(ValueError, match="incompatible with dump_blobs"):
        step.multi_step(p, s, good)


def test_device_rate_forms_are_bitwise_to_the_host_rate():
    """Every flat-rule arm at a rate given as a 0-d tensor (the graph's
    form) against the host float, and ``learning_rates`` against
    ``learning_rate`` step by step."""
    from poseidon_tpu_torch.ops.sgd import sgd_update_plain_
    from poseidon_tpu_torch.solvers.updates import (learning_rate,
                                                    learning_rates,
                                                    make_flat_update_rule)
    sp = SolverParameter(**SOLVER, max_iter=100)
    for policy in ("inv", "poly", "exp", "sigmoid", "step"):
        sp.lr_policy, sp.stepsize = policy, 7
        rates = learning_rates(sp, 3, 5)
        assert rates.dtype == torch.float32
        assert rates.tolist() == [learning_rate(sp, 3 + i) for i in range(5)]
    rs = np.random.RandomState(1)
    n = 1003
    w, g, h = (torch.from_numpy(rs.randn(n).astype(np.float32))
               for _ in range(3))
    lr = torch.from_numpy(rs.choice([1.0, 2.0], n).astype(np.float32))
    dec = torch.from_numpy(rs.choice([0.0, 5e-4], n).astype(np.float32))
    rate = learning_rate(sp, 9)
    for solver in ("SGD", "NESTEROV", "ADAGRAD"):
        for reg in ("L2", "L1"):
            rule = make_flat_update_rule(SolverParameter(
                **SOLVER, solver_type=solver, regularization_type=reg))
            got, want = [], []
            for r, out in ((torch.tensor(rate), got), (rate, want)):
                ww, hh = w.clone(), h.abs().clone()
                rule(ww, g, hh, r, lr, dec)
                out += [ww, hh]
            for a, b in zip(got, want):
                assert torch.equal(a, b), (solver, reg)
    ww, hh = w.clone(), h.clone()
    sgd_update_plain_(ww, g, hh, torch.tensor(rate), lr, dec, 0.9)
    w2, h2 = w.clone(), h.clone()
    sgd_update_plain_(w2, g, h2, rate, lr, dec, 0.9)
    assert torch.equal(ww, w2) and torch.equal(hh, h2)


def test_fetcher_reads_k_rows_from_one_dispatch():
    from poseidon_tpu_torch.runtime.metrics import AsyncScalarFetcher
    f = AsyncScalarFetcher(max_in_flight=2)
    try:
        f.put(0, {"loss": torch.tensor(1.5)})
        f.put(1, {"loss": torch.tensor([1.0, 2.0, float("nan"), 4.0]),
                  "acc": torch.tensor([0.5, 0.25, 0.0, 1.0])})
        rows = f.sync()
    finally:
        f.close()
    assert [it for it, _ in rows] == [0, 1, 2, 3, 4]
    assert rows[0][1] == {"loss": 1.5}
    assert rows[2][1] == {"acc": 0.25, "loss": 2.0}
    assert rows[4][1] == {"acc": 1.0, "loss": 4.0}
    assert f.divergence[:2] == (3, "loss")


def test_graph_refusal_decision():
    """The card's rule: gloo ranks cannot be captured, NCCL ranks and one
    device can; the CPU makes no graph; TOPK's host-counter policies are
    the ones a graph would freeze."""
    from poseidon_tpu_torch.parallel.mesh import DataGroup
    from poseidon_tpu_torch.parallel.trainer import (HOST_COUNTER_POLICIES,
                                                     graph_refusal)
    cuda = torch.device("cuda")
    gloo = DataGroup(rank=0, world=2, device=cuda, backend="gloo",
                     pg=object())
    nccl = DataGroup(rank=0, world=2, device=cuda, backend="nccl",
                     pg=object())
    reason = graph_refusal(gloo, cuda)
    assert reason and "gloo" in reason and "NCCL" in reason
    assert graph_refusal(nccl, cuda) is None
    assert graph_refusal(None, cuda) is None
    assert graph_refusal(DataGroup.single(cuda), cuda) is None
    cpu = dataclasses.replace(gloo, device=torch.device("cpu"))
    assert graph_refusal(cpu, "cpu") is None
    assert set(HOST_COUNTER_POLICIES) == {"random", "fixed_order"}
    # the policies the port's topk_compress reads the step counter for
    with pytest.raises(ValueError, match="step counter"):
        S.topk_compress(torch.ones(8), 0.5, torch.zeros(8), "random")
    with pytest.raises(ValueError, match="step counter"):
        S.topk_compress(torch.ones(8), 0.5, torch.zeros(8), "fixed_order")
    S.topk_compress(torch.ones(8), 0.5, torch.zeros(8), "magnitude")


# --------------------------------------------------------------------- #
# the 2-rank job

@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dispatch")
    params = _jax_params(seed=13)
    stack = _stacked(np.random.RandomState(113), K, WORLD * B)
    arrays = {f"params/{l}/{p}": v for l, lv in params.items()
              for p, v in lv.items()}
    arrays.update(stack)
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
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
        with np.load(d / f"out.rank{r}.npz") as z:
            rep["arrays"] = {k: z[k] for k in z.files}
        ranks.append(rep)
    return params, stack, ranks


def _split(arrays, kind):
    out = {}
    for k, v in arrays.items():
        if k.startswith(kind + "/"):
            _, l, p = k.split("/")
            out.setdefault(l, {})[p] = v
    return out


def test_two_rank_dispatch_matches_jax_scan_on_the_virtual_mesh(gloo_run):
    params, stack, ranks = gloo_run
    jp, jh, jl, _, _ = _run_jax_scan(params, stack, WORLD, {})
    for r, rep in enumerate(ranks):
        assert rep["it"] == K
        np.testing.assert_allclose(rep["losses"], jl, rtol=LOSS_RTOL)
        _close(_split(rep["arrays"], "params"), jp, f"rank {r} param")
        _close(_split(rep["arrays"], "history"), jh, f"rank {r} momentum")
    for k, v in ranks[0]["arrays"].items():
        np.testing.assert_array_equal(v, ranks[1]["arrays"][k])


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
  blobs_lr: 1 blobs_lr: 2
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers {
  name: "ip1" type: INNER_PRODUCT bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 16
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "drop1" type: DROPOUT bottom: "ip1" top: "ip1"
  dropout_param { dropout_ratio: 0.3 } }
layers {
  name: "ip2" type: INNER_PRODUCT bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip2" bottom: "label" top: "loss" }
layers { name: "acc" type: ACCURACY bottom: "ip2" bottom: "label" top: "accuracy"
  include { phase: TEST } }
"""
SMALL_SOLVER = """
net: "%(net)s"
base_lr: 0.05
lr_policy: "inv"
gamma: 0.01
power: 0.75
momentum: 0.9
weight_decay: 0.0005
display: 10
max_iter: %(max_iter)d
test_iter: 2
test_interval: 12
test_initialization: false
snapshot: 9
snapshot_prefix: "snap/small"
random_seed: 4
"""


def _memory_data(n=128, seed=0):
    rs = np.random.RandomState(seed)
    templates = rs.randn(5, 1, 12, 12).astype(np.float32)
    labels = rs.randint(0, 5, size=n)
    data = templates[labels] + 0.25 * rs.randn(n, 1, 12, 12).astype(
        np.float32)
    return {"data": data, "label": labels}


def _small_solver(d, max_iter=26, extra=""):
    from poseidon_tpu_torch.proto.messages import load_solver_from_string
    d.mkdir(parents=True, exist_ok=True)
    net = d / "net.prototxt"
    net.write_text(SMALL_NET + extra)
    return load_solver_from_string(SMALL_SOLVER % {"net": net,
                                                   "max_iter": max_iter})


def _engine_run(d, spd):
    from poseidon_tpu_torch.runtime.checkpoint import restore
    from poseidon_tpu_torch.runtime.engine import Engine
    eng = Engine(_small_solver(d), memory_data=_memory_data(),
                 output_dir=str(d), device="cpu", steps_per_dispatch=spd)
    calls = []
    orig = eng.train_step.multi_step
    eng.train_step.multi_step = lambda p, s, b: (
        calls.append(int(s.solver.it)), orig(p, s, b))[1]
    try:
        assert eng.steps_per_dispatch == spd
        eng.train()
        out = {"params": _np_tree(eng.params),
               "history": _np_tree(eng.state.solver.history),
               "train": eng.metrics.rows, "tests": eng.test_metrics[0].rows,
               "chunks": calls}
    finally:
        eng.close()
    out["snaps"] = {}
    for it in (9, 18):
        p, st = restore(str(d / f"snap/small_iter_{it}.solverstate.npz"))
        out["snaps"][it] = (p, st.solver.history, int(st.solver.it))
    return out


def test_engine_steps_per_dispatch_4_is_bitwise_to_1(tmp_path):
    """Display every 10, a test every 12, a snapshot every 9, 26 steps: at
    K=4 the chunks start at 0, 4, 12 and 20 and single steps fill up to
    each boundary; everything the run leaves is the K=1 run's."""
    one = _engine_run(tmp_path / "k1", 1)
    four = _engine_run(tmp_path / "k4", 4)
    assert one["chunks"] == [] and four["chunks"] == [0, 4, 12, 20]
    _equal(four["params"], one["params"], "param")
    _equal(four["history"], one["history"], "momentum")
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"}  # noqa: E731,E501
                          for r in rows]
    assert strip(four["train"]) == strip(one["train"])
    assert [r["iter"] for r in one["train"]] == [10, 20]
    assert strip(four["tests"]) == strip(one["tests"])
    assert [r["iter"] for r in one["tests"]] == [12, 24]
    for it in (9, 18):
        p4, h4, i4 = four["snaps"][it]
        p1, h1, i1 = one["snaps"][it]
        assert i4 == i1 == it
        _equal(p4, p1, f"snapshot {it} param")
        _equal(h4, h1, f"snapshot {it} momentum")


def _jax_engine_source():
    import inspect
    from poseidon_tpu.runtime import engine as jax_engine
    return inspect.getsource(jax_engine)


def _spd_warnings(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("WARNING") and "steps_per_dispatch" in ln]


def test_engine_runs_steps_per_dispatch_1_under_staleness(tmp_path, capsys):
    from poseidon_tpu_torch.runtime.engine import Engine
    capsys.readouterr()
    eng = Engine(_small_solver(tmp_path, max_iter=2),
                 memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", staleness=1, steps_per_dispatch=4)
    try:
        assert eng.steps_per_dispatch == 1
        eng.train()
    finally:
        eng.close()
    want = ("WARNING: steps_per_dispatch ignored under SSP staleness (the "
            "SSP step already batches local steps)")
    assert _spd_warnings(capsys) == [want]
    src = _jax_engine_source()
    assert '"WARNING: steps_per_dispatch ignored under SSP "' in src
    assert '"staleness (the SSP step already batches local steps)"' in src


def test_engine_runs_steps_per_dispatch_1_under_an_active_mesh(tmp_path,
                                                               capsys):
    """The --mesh rule, on the engine's resolver (an active mesh needs a
    world of its devices; tests/test_torch_spmd.py drives those)."""
    from poseidon_tpu_torch.runtime.engine import Engine
    eng = Engine(_small_solver(tmp_path, max_iter=1),
                 memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", steps_per_dispatch=4)
    try:
        capsys.readouterr()
        eng.plan = object()       # what an active --mesh leaves here
        assert eng._resolve_steps_per_dispatch(False) == 1
        eng.plan = None
        assert eng._resolve_steps_per_dispatch(False) == 4
    finally:
        eng.close()
    assert _spd_warnings(capsys) == [
        "WARNING: steps_per_dispatch ignored under --mesh sharding"]
    src = _jax_engine_source()
    assert '"WARNING: steps_per_dispatch ignored under --mesh "' in src


def test_engine_runs_steps_per_dispatch_1_with_train_hdf5_output(tmp_path,
                                                                 capsys):
    pytest.importorskip("h5py")
    from poseidon_tpu_torch.runtime.engine import Engine
    sp = _small_solver(tmp_path, max_iter=2, extra=(
        'layers { name: "dump" type: HDF5_OUTPUT bottom: "ip2" '
        'include { phase: TRAIN } hdf5_output_param '
        '{ file_name: "dumps/f.h5" } }\n'))
    capsys.readouterr()
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(tmp_path),
                 device="cpu", steps_per_dispatch=4)
    try:
        assert eng.steps_per_dispatch == 1
        assert eng.train_step.steps_per_dispatch == 1
        eng.train()
    finally:
        eng.close()
    want = ("WARNING: steps_per_dispatch ignored with HDF5_OUTPUT in the "
            "TRAIN net (per-iteration dump semantics)")
    assert _spd_warnings(capsys) == [want]
    assert (tmp_path / "dumps/f.h5").exists()
    src = _jax_engine_source()
    assert '"WARNING: steps_per_dispatch ignored with HDF5_OUTPUT "' in src


def test_engine_warns_and_runs_1_over_gloo_on_the_card(tmp_path, capsys):
    """Gloo ranks sharing the card: the engine's resolver asks
    ``graph_refusal`` and runs single steps with a warning naming why."""
    from poseidon_tpu_torch.parallel.mesh import DataGroup
    from poseidon_tpu_torch.runtime import engine as E
    eng = E.Engine(_small_solver(tmp_path, max_iter=1),
                   memory_data=_memory_data(), output_dir=str(tmp_path),
                   device="cpu", steps_per_dispatch=4)
    group, device = eng.group, eng.device
    cuda = torch.device("cuda")
    gloo = DataGroup(rank=0, world=2, device=cuda, backend="gloo",
                     pg=object())
    try:
        capsys.readouterr()
        eng.group, eng.device = gloo, cuda
        assert eng._resolve_steps_per_dispatch(False) == 1
        eng.group = dataclasses.replace(gloo, backend="nccl")
        assert eng._resolve_steps_per_dispatch(False) == 4
    finally:
        eng.group, eng.device = group, device
        eng.close()
    got = _spd_warnings(capsys)
    assert len(got) == 1 and "gloo" in got[0] and "single steps" in got[0]


def test_cli_passes_steps_per_dispatch(tmp_path, monkeypatch):
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
    sp_path = tmp_path / "solver.prototxt"
    _small_solver(tmp_path)
    sp_path.write_text(SMALL_SOLVER % {"net": tmp_path / "net.prototxt",
                                       "max_iter": 1})
    args = cli.build_parser().parse_args(
        ["train", "--solver", str(sp_path), "--device", "cpu",
         "--steps_per_dispatch", "4"])
    assert cli.cmd_train(args) == 0
    assert seen["steps_per_dispatch"] == 4
    args = cli.build_parser().parse_args(
        ["train", "--solver", str(sp_path), "--device", "cpu"])
    cli.cmd_train(args)
    assert seen["steps_per_dispatch"] == 1
