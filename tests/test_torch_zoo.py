"""The port's model zoo (``poseidon_tpu_torch/models/zoo.py``) against the
JAX package's, on the CPU.

- Every builder, at its defaults and with its options, writes the same
  prototxt text as JAX's, and every ``*_shapes`` gives JAX's shapes; the
  ``ZOO`` tables name the same builders.
- LeNet, CIFAR-10 quick and full, and a narrow CaffeNet (the builder's net
  with every width cut 16-fold, 10 classes, 67x67 inputs, dropout 0):
  every blob of a TEST forward from the same numpy weights at rtol 1e-4,
  atol 1e-5 (the forward tolerance of ``tests/test_torch_net.py``), and
  one training step against JAX's step on a one-device mesh (loss rtol
  1e-5, parameters and momentum rtol 1e-4, atol 1e-6, the train-step
  tolerance of ``tests/test_torch_train.py``).
- GoogLeNet with its aux heads, 1000 classes, at batch 1: the layer
  types, blob shapes and parameter shapes of JAX's ``Net``, and the three
  losses and the classifier of a forward from the same numpy weights at
  the forward tolerance.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.models import zoo as jax_zoo
from poseidon_tpu.parallel.trainer import build_train_step as jax_step
from poseidon_tpu.parallel.trainer import init_train_state as jax_state
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.models import zoo
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto.messages import SolverParameter

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)

BUILDS = {
    "lenet": ("lenet", {}),
    "lenet_no_acc": ("lenet", {"with_accuracy": False}),
    "cifar10_quick": ("cifar10_quick", {}),
    "cifar10_full": ("cifar10_full", {}),
    "cifar10_full_no_acc": ("cifar10_full", {"with_accuracy": False}),
    "alexnet": ("alexnet", {}),
    "alexnet_10": ("alexnet", {"num_classes": 10, "with_accuracy": False}),
    "googlenet": ("googlenet", {}),
    "googlenet_no_aux": ("googlenet", {"aux_heads": False,
                                       "num_classes": 20}),
    "caffenet": ("caffenet", {}),
    "caffenet_head": ("caffenet", {"classifier_name": "fc_x",
                                   "num_classes": 7}),
    "rcnn_ilsvrc13": ("rcnn_ilsvrc13", {}),
    "finetune_flickr_style": ("finetune_flickr_style", {}),
}
SHAPES = ["lenet_shapes", "cifar10_shapes", "alexnet_shapes",
          "googlenet_shapes", "caffenet_shapes"]


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_prototxt_text_equals_jax(case):
    fn, kw = BUILDS[case]
    got = zoo.to_prototxt(getattr(zoo, fn)(**kw))
    assert got == jax_zoo.to_prototxt(getattr(jax_zoo, fn)(**kw))
    assert "layers {" in got


@pytest.mark.parametrize("fn", SHAPES)
def test_shapes_equal_jax(fn):
    for batch in (1, 32):
        assert getattr(zoo, fn)(batch) == getattr(jax_zoo, fn)(batch)


def test_zoo_tables_name_the_same_builders():
    assert list(zoo.ZOO) == list(jax_zoo.ZOO)
    for k, (build, shapes) in zoo.ZOO.items():
        jb, js = jax_zoo.ZOO[k]
        assert (build.__name__, shapes.__name__) == (jb.__name__,
                                                     js.__name__)


def _narrow_caffenet(mod):
    net = mod.caffenet(num_classes=10)
    for lp in net.layers:
        if lp.type == "CONVOLUTION":
            lp.convolution_param.num_output //= 16
        elif lp.type == "INNER_PRODUCT" and lp.name != "fc8":
            lp.inner_product_param.num_output //= 16
        elif lp.type == "DROPOUT":
            lp.dropout_param.dropout_ratio = 0.0
    return net


NETS = {
    "lenet": (lambda m: m.lenet(), lambda m: m.lenet_shapes(4), 10),
    "cifar10_quick": (lambda m: m.cifar10_quick(),
                      lambda m: m.cifar10_shapes(4), 10),
    "cifar10_full": (lambda m: m.cifar10_full(),
                     lambda m: m.cifar10_shapes(4), 10),
    "narrow_caffenet": (_narrow_caffenet,
                        lambda m: {"data": (2, 3, 67, 67), "label": (2,)},
                        10),
}


def _pair(name, phase):
    build, shapes, _ = NETS[name]
    jnet = JaxNet(build(jax_zoo), phase, conv_layout="NCHW",
                  source_shapes=shapes(jax_zoo))
    net = Net(build(zoo), phase, device="cpu", conv_layout="NCHW",
              source_shapes=shapes(zoo))
    return jnet, net


def _weights(net, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for l, defs in net.param_defs.items():
        out[l] = {}
        for p in defs:
            fan_in = max(1, p.count // p.shape[0])
            out[l][p.name] = (rs.randn(*p.shape) / np.sqrt(fan_in)
                              ).astype(np.float32)
    return out


def _batch(net, classes, seed):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(*net.blob_shapes["data"]).astype(np.float32),
            "label": rs.randint(0, classes, size=net.blob_shapes["label"])
            .astype(np.float32)}


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_jax(name):
    jnet, net = _pair(name, "TEST")
    init = _weights(net, 1)
    batch = _batch(net, NETS[name][2], 2)
    want = jnet.apply(jax.tree_util.tree_map(np.array, init), batch,
                      train=False, keep_blobs=True)
    with torch.no_grad():
        got = net.apply(params_from_jax(net, init),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        keep_blobs=True)
    assert set(got.blobs) == set(want.blobs)
    for k in want.blobs:
        np.testing.assert_allclose(got.blobs[k].numpy(),
                                   np.asarray(want.blobs[k]), **FWD_TOL,
                                   err_msg=f"{name} blob {k}")
    np.testing.assert_allclose(float(got.loss), float(want.loss), **FWD_TOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_one_step_matches_jax(name):
    jnet, net = _pair(name, "TRAIN")
    init = _weights(net, 3)
    batch = _batch(net, NETS[name][2], 4)
    ts = jax_step(jnet, JaxSolver(**SOLVER),
                  Mesh(np.array(jax.devices()[:1]), ("data",)))
    jinit = jax.tree_util.tree_map(np.array, init)
    jp, js, jm = ts.step(jinit, jax_state(jinit), batch,
                         jax.random.PRNGKey(0))
    step = build_train_step(net, SolverParameter(**SOLVER))
    params = params_from_jax(net, init)
    params, state = step.load(params, init_train_state(params))
    pp, ps, pm = step.step(params, state, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for tree, ref, what in ((pp, jp, "param"),
                            (ps.solver.history, js.solver.history,
                             "momentum")):
        for l in ref:
            for p in ref[l]:
                np.testing.assert_allclose(
                    tree[l][p].numpy(), np.asarray(ref[l][p]), **PARAM_TOL,
                    err_msg=f"{name} {what} {l}/{p}")


def test_googlenet_batch_1_matches_jax():
    shapes = zoo.googlenet_shapes(1)
    jnet = JaxNet(jax_zoo.googlenet(), "TRAIN", conv_layout="NCHW",
                  source_shapes=jax_zoo.googlenet_shapes(1))
    net = Net(zoo.googlenet(), "TRAIN", device="cpu", conv_layout="NCHW",
              source_shapes=shapes)
    assert ([(l.name, l.TYPE) for l in net.layers]
            == [(l.name, l.TYPE) for l in jnet.layers])
    assert net.blob_shapes == jnet.blob_shapes
    assert ({l: [p.shape for p in d] for l, d in net.param_defs.items()}
            == {l: [p.shape for p in d] for l, d in jnet.param_defs.items()})
    assert net.param_count() == jnet.param_count()
    pools = [l for l in net.layers if l.TYPE == "POOLING"]
    assert ([l.method for l in pools].count("MAX"),
            [l.method for l in pools].count("AVE")) == (13, 3)
    assert [l.TYPE for l in net.layers].count("LRN") == 2
    init = _weights(net, 5)
    batch = _batch(net, 1000, 6)
    want = jax.jit(lambda p, b: jnet.apply(p, b, train=False).outputs)(
        jax.tree_util.tree_map(np.array, init), batch)
    with torch.no_grad():
        got = net.apply(params_from_jax(net, init),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        train=False, keep_blobs=True)
    assert set(want) == {"loss1/loss", "loss2/loss", "loss3"}
    for k in want:
        np.testing.assert_allclose(float(got.outputs[k]), float(want[k]),
                                   **FWD_TOL, err_msg=k)
    # the aux heads weigh 0.3 each in the objective
    np.testing.assert_allclose(
        float(got.loss), float(want["loss3"]) + 0.3 * (
            float(want["loss1/loss"]) + float(want["loss2/loss"])),
        **FWD_TOL)
