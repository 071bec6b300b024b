"""The port's training slice against the JAX package's, on the CPU.

Step parity: the same weights (carried across with ``params_from_jax``),
the same numpy batches and the same solver through the port's
``build_train_step`` and the JAX ``build_train_step`` on a one-device mesh
(the JAX Engine would multiply the batch by conftest's 8 virtual devices,
so parity is held at the step). Nets without dropout: the two packages'
random streams differ.

Tolerances: losses rtol 1e-5; parameters and momentum after 3 steps rtol
1e-4, atol 1e-6 — XLA's and PyTorch's CPU convolutions and GEMMs sum in
different orders, and the difference carries through the updates;
gradients of one step rtol 1e-4, atol 1e-6 for the same reason.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.parallel.trainer import build_train_step as jax_step
from poseidon_tpu.parallel.trainer import init_train_state as jax_state
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu.runtime import checkpoint as jax_ckpt
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.ops import lrn, pool, sgd
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto.messages import (SolverParameter, load_net,
                                               load_net_from_string,
                                               load_solver)
from poseidon_tpu_torch.runtime import checkpoint
from poseidon_tpu_torch.runtime.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET = "examples/mnist/lenet_train_test.prototxt"
LENET_SHAPES = {"data": (4, 1, 28, 28), "label": (4,)}
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)

_P = """blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0"""
# AlexNet-shaped and narrow: group-2 convs, LRN n=5 and the even n=4,
# ceil-mode max pools, an AVE pool with pad, fc, lr_mult 1/2 and
# decay_mult 1/0, SOFTMAX_LOSS and ACCURACY; input blobs, no dropout
NARROW_ALEXNET_TRAIN = """
name: "NarrowAlexNetTrain"
input: "data" input_dim: 4 input_dim: 3 input_dim: 35 input_dim: 35
input: "label" input_dim: 4 input_dim: 1 input_dim: 1 input_dim: 1
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1" %(p)s
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 } }
layers { name: "pool1" type: POOLING bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv2" type: CONVOLUTION bottom: "pool1" top: "conv2" %(p)s
  convolution_param { num_output: 16 pad: 2 kernel_size: 5 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu2" type: RELU bottom: "conv2" top: "conv2" }
layers { name: "norm2" type: LRN bottom: "conv2" top: "norm2"
  lrn_param { local_size: 4 alpha: 0.5 beta: 0.75 } }
layers { name: "pool2" type: POOLING bottom: "norm2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv3" type: CONVOLUTION bottom: "pool2" top: "conv3" %(p)s
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu3" type: RELU bottom: "conv3" top: "conv3" }
layers { name: "pool5" type: POOLING bottom: "conv3" top: "pool5"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool5" top: "fc6" %(p)s
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "fc8" type: INNER_PRODUCT bottom: "fc6" top: "fc8" %(p)s
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "accuracy" type: ACCURACY bottom: "fc8" bottom: "label"
  top: "accuracy" }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "loss" }
""" % {"p": _P}


def _nets(name):
    if name == "narrow_alexnet":
        jnet = JaxNet(jax_load_str(NARROW_ALEXNET_TRAIN), "TRAIN",
                      conv_layout="NCHW")
        net = Net(load_net_from_string(NARROW_ALEXNET_TRAIN), "TRAIN",
                  device="cpu")
    else:
        jnet = JaxNet(jax_load_net(LENET), "TRAIN", conv_layout="NCHW",
                      source_shapes=LENET_SHAPES)
        net = Net(load_net(LENET), "TRAIN", device="cpu",
                  source_shapes=LENET_SHAPES)
    return jnet, net


def _batches(jnet, n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        shape = jnet.blob_shapes["data"]
        lshape = jnet.blob_shapes["label"]
        out.append({"data": rs.randn(*shape).astype(np.float32),
                    "label": rs.randint(0, 10, size=lshape)
                    .astype(np.float32)})
    return out


def _np(tree):
    return {l: {p: np.asarray(v) for p, v in d.items()}
            for l, d in tree.items()}


def _run_jax(jnet, params, batches, state=None):
    ts = jax_step(jnet, JaxSolver(**SOLVER),
                  Mesh(np.array(jax.devices()[:1]), ("data",)))
    state = jax_state(params) if state is None else state
    losses = []
    for b in batches:
        params, state, m = ts.step(params, state, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return params, state, losses


def _run_port(net, params, batches, state=None):
    step = build_train_step(net, SolverParameter(**SOLVER))
    state = init_train_state(params) if state is None else state
    params, state = step.load(params, state)
    losses = []
    for b in batches:
        params, state, m = step.step(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return params, state, losses


def _assert_trees_close(port, ref, what):
    assert set(port) == set(ref)
    for l in ref:
        for p in ref[l]:
            np.testing.assert_allclose(
                np.asarray(port[l][p]), np.asarray(ref[l][p]), **PARAM_TOL,
                err_msg=f"{what} {l}/{p}")


@pytest.mark.parametrize("name", ["narrow_alexnet", "lenet"])
def test_three_step_parity_with_jax(name):
    jnet, net = _nets(name)
    jparams = jnet.init(jax.random.PRNGKey(3))
    params = params_from_jax(net, _np(jparams))
    batches = _batches(jnet, 3, seed=4)
    jp, js, jl = _run_jax(jnet, jparams, batches)
    pp, ps, pl = _run_port(net, params, batches)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pl[2] != pl[0]       # the steps moved the loss
    _assert_trees_close(pp, jp, "param")
    _assert_trees_close(ps.solver.history, js.solver.history, "momentum")
    assert ps.solver.it == int(js.solver.it) == 3


def test_gradients_through_fused_relu_conv_match_jax():
    """One backward through the narrow net, whose convs carry the in-place
    ReLU folded into their epilogue (clamp_min_ on the conv's fresh
    output): every parameter gradient against jax.grad of the JAX net."""
    jnet, net = _nets("narrow_alexnet")
    assert all(l.fused_relu_slope == 0.0 for l in net.layers
               if l.TYPE == "CONVOLUTION")
    jparams = jnet.init(jax.random.PRNGKey(5))
    batch = _batches(jnet, 1, seed=6)[0]
    ref = jax.jit(jax.grad(
        lambda p: jnet.apply(p, batch, train=True).loss))(jparams)
    params = {l: {p: torch.from_numpy(np.array(v)).requires_grad_(True)
                  for p, v in d.items()} for l, d in _np(jparams).items()}
    out = net.apply(params, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, train=True)
    out.loss.backward()
    _assert_trees_close({l: {p: v.grad for p, v in d.items()}
                         for l, d in params.items()}, ref, "grad")


def test_snapshots_cross_load_both_ways(tmp_path):
    jnet, net = _nets("lenet")
    init = _np(jnet.init(jax.random.PRNGKey(7)))
    as_jax = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    batches = _batches(jnet, 2, seed=8)
    # JAX snapshot -> port restore (the JAX step donates its inputs)
    jp, js, _ = _run_jax(jnet, as_jax(init), batches[:1])
    _, jpath = jax_ckpt.snapshot(str(tmp_path / "jax"), jnet, jp, js)
    params, state = checkpoint.restore(jpath)
    assert state.solver.it == 1
    _assert_trees_close(params, _np(jp), "restored param")
    # port snapshot -> JAX restore
    pp, ps, _ = _run_port(net, params_from_jax(net, init), batches[:1])
    model, ppath = checkpoint.snapshot(str(tmp_path / "port"), net, pp, ps)
    assert model.endswith("_iter_1.caffemodel")
    rparams, rstate = jax_ckpt.restore(ppath)
    assert int(rstate.solver.it) == 1
    for l in pp:
        for p in pp[l]:
            np.testing.assert_array_equal(np.asarray(rparams[l][p]),
                                          pp[l][p].numpy())
            np.testing.assert_array_equal(
                np.asarray(rstate.solver.history[l][p]),
                ps.solver.history[l][p].numpy())
    # one step from either restored state gives the same params
    jp2, _, _ = _run_jax(jnet, rparams, batches[1:], state=rstate)
    pp2, _, _ = _run_port(net, params, batches[1:], state=state)
    _assert_trees_close(pp2, jp2, "param after resumed step")
    # the port's .caffemodel loads into the JAX net
    loaded = jax_ckpt.load_caffemodel(model, jnet, as_jax(init))
    for l in pp:
        for p in pp[l]:
            np.testing.assert_array_equal(np.asarray(loaded[l][p]),
                                          pp[l][p].numpy())


def _lenet_solver(tmp_path, max_iter=20):
    sp = load_solver(os.path.join(REPO, "examples/mnist/lenet_solver.prototxt"))
    sp.net = os.path.join(REPO, sp.net)
    sp.max_iter, sp.display, sp.test_interval = max_iter, 5, 10
    sp.test_iter, sp.snapshot = [2], 0
    return sp


def test_engine_trains_lenet_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    before = (dict(lrn.LAUNCHES), dict(pool.LAUNCHES), dict(sgd.LAUNCHES))
    eng = Engine(_lenet_solver(tmp_path), output_dir=str(tmp_path),
                 device="cpu")
    pipes = [*eng.train_pipelines, *sum(eng.test_pipelines, [])]
    try:
        eng.train()
    finally:
        eng.close()
    assert eng.iteration() == 20
    assert len(pipes) == 2
    assert all(not p._thread.is_alive() for p in pipes)
    with open(tmp_path / "LeNet_train_outputs.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["iter"]) for r in rows] == [5, 10, 15, 20]
    assert float(rows[-1]["loss"]) < float(rows[0]["loss"])
    with open(tmp_path / "LeNet_test0_outputs.csv") as f:
        head = f.readline().strip()
        test_rows = list(csv.reader(f))
    assert head == "iter,time,accuracy,loss"
    assert [r[0] for r in test_rows] == ["0", "10", "20"]
    assert (tmp_path / "examples/mnist/lenet_iter_20.solverstate.npz").exists()
    # the CPU ran the plain versions: no kernel launched
    assert (dict(lrn.LAUNCHES), dict(pool.LAUNCHES),
            dict(sgd.LAUNCHES)) == before


def test_engine_restore_resumes_and_divergence_aborts(tmp_path, monkeypatch):
    from poseidon_tpu_torch.runtime.engine import TrainingDivergedError
    monkeypatch.chdir(REPO)
    sp = _lenet_solver(tmp_path, max_iter=4)
    eng = Engine(sp, output_dir=str(tmp_path), device="cpu")
    try:
        eng.train()
        snap = eng.snapshot_now()
        fresh = Engine(sp, output_dir=str(tmp_path), device="cpu")
        try:
            assert fresh.auto_resume() == snap
            assert fresh.iteration() == 4
            for l in eng.params:
                for p in eng.params[l]:
                    assert torch.equal(fresh.params[l][p], eng.params[l][p])
            fresh.params["conv1"]["w"].fill_(float("nan"))
            with pytest.raises(TrainingDivergedError) as err:
                fresh.train(max_iter=6)
            assert err.value.iteration == 4
        finally:
            fresh.close()
    finally:
        eng.close()


def test_iter_size_raises():
    """The flat step accumulates (tests/test_torch_iter_size.py); the SSP
    and SPMD steps still refuse iter_size > 1, naming the engine's rule
    (it runs iter_size 1 under staleness and --mesh)."""
    from poseidon_tpu_torch.parallel.spmd import SpmdTrainStep
    from poseidon_tpu_torch.parallel.trainer import SSPTrainStep
    sp = SolverParameter(**SOLVER, iter_size=2)
    _, net = _nets("lenet")
    assert build_train_step(net, sp).iter_size == 2
    with pytest.raises(ValueError, match="runs iter_size 1 under SSP "
                                         "staleness"):
        SSPTrainStep(net, sp, staleness=1)
    with pytest.raises(ValueError, match="runs iter_size 1 under --mesh"):
        SpmdTrainStep(net, sp, None, None)


def test_cli_train_subprocess_on_cpu(tmp_path):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, LENET)}"\n'
        'test_iter: 1\ntest_interval: 3\nbase_lr: 0.01\nmomentum: 0.9\n'
        'weight_decay: 0.0005\nlr_policy: "inv"\ngamma: 0.0001\n'
        'power: 0.75\ndisplay: 3\nmax_iter: 3\n'
        f'snapshot_prefix: "{tmp_path / "lenet"}"\n')
    out = subprocess.run(
        [sys.executable, "-m", "poseidon_tpu_torch", "train",
         f"--solver={solver}", "--output_dir", str(tmp_path),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Iteration 3" in out.stdout
    assert (tmp_path / "lenet_iter_3.caffemodel").exists()
    assert (tmp_path / "LeNet_test0_outputs.csv").exists()
