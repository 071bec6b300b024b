"""Shared (named) parameters in the port against the JAX package's, on the
CPU.

- The siamese example net (``examples/siamese``: SLICE, CONTRASTIVE_LOSS,
  both branches sharing conv1, ip1 and feat by name) builds with the
  owners alone in ``param_defs``, the arena and the params tree, and
  trains 3 steps from the same numpy weights and batches as JAX's step on
  a one-device mesh: losses at rtol 1e-5, parameters and momentum at
  rtol 1e-4, atol 1e-6 (the train-step tolerance of
  ``tests/test_torch_train.py``: XLA's and PyTorch's CPU convolutions and
  GEMMs sum in different orders).
- Snapshots cross-load both ways with the JAX package's checkpoint code,
  and the .caffemodel carries Caffe's layout (every sharer repeats its
  owner's blobs) in both directions.
- STRICT shape, PERMISSIVE count (V1 ``blob_share_mode`` and V2
  ``share_mode``) and lr/decay multiplier refusals raise JAX's messages;
  a PERMISSIVE share of another shape runs forward as JAX's does.
- The DWBP bucket of a shared leaf goes out once, after both sharers'
  gradients landed: its leaf's accumulation hook runs once a backward
  (a hook count), on the summed gradient, and ``auto_strategies`` picks
  for the sharer layers what JAX's picks.
- ``examples/feature_extraction/extract.prototxt`` (SILENCE) builds and
  runs forward as JAX's net does.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.parallel.strategies import \
    auto_strategies as jax_auto_strategies
from poseidon_tpu.parallel.trainer import build_train_step as jax_step
from poseidon_tpu.parallel.trainer import init_train_state as jax_state
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu.runtime import checkpoint as jax_ckpt
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.parallel import strategies as S
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto.messages import (SolverParameter, load_net,
                                               load_net_from_string)
from poseidon_tpu_torch.proto.wire import decode_caffemodel
from poseidon_tpu_torch.runtime import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIAMESE = os.path.join(REPO, "examples/siamese/mnist_siamese_train_test"
                             ".prototxt")
EXTRACT = os.path.join(REPO, "examples/feature_extraction/extract.prototxt")
SIAMESE_SHAPES = {"pair_data": (4, 2, 28, 28), "sim": (4,)}
OWNERS = ["conv1", "ip1", "feat"]
SHARERS = {"conv1_p": "conv1", "ip1_p": "ip1", "feat_p": "feat"}
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)


def _siamese():
    jnet = JaxNet(jax_load_net(SIAMESE), "TRAIN", conv_layout="NCHW",
                  source_shapes=SIAMESE_SHAPES)
    net = Net(load_net(SIAMESE), "TRAIN", device="cpu",
              source_shapes=SIAMESE_SHAPES)
    return jnet, net


def _weights(net, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    return {l: {p.name: (scale * rs.randn(*p.shape)).astype(np.float32)
                for p in defs} for l, defs in net.param_defs.items()}


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    return [{"pair_data": rs.rand(4, 2, 28, 28).astype(np.float32),
             "sim": rs.randint(0, 2, size=(4,)).astype(np.float32)}
            for _ in range(n)]


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
    return params, state, losses, step


def _assert_trees_close(port, ref, what, tol=PARAM_TOL):
    assert set(port) == set(ref)
    for l in ref:
        assert set(port[l]) == set(ref[l])
        for p in ref[l]:
            np.testing.assert_allclose(
                np.asarray(port[l][p]), np.asarray(ref[l][p]), **tol,
                err_msg=f"{what} {l}/{p}")


def test_siamese_net_builds_with_owners_only():
    jnet, net = _siamese()
    assert list(net.param_defs) == list(jnet.param_defs) == OWNERS
    assert net._storage_of == jnet._storage_of
    for sharer, owner in SHARERS.items():
        for p in ("w", "b"):
            assert net._storage_of[(sharer, p)] == (owner, p)
    arena = net.arena_layout()
    assert {s.layer for s in arena.slots} == set(OWNERS)
    assert arena.total == net.param_count() == jnet.param_count()
    # DWBP order: reverse forward order of the owners
    assert [s.layer for s in arena.slots] == ["feat", "feat", "ip1", "ip1",
                                              "conv1", "conv1"]


def test_siamese_three_steps_match_jax():
    jnet, net = _siamese()
    init = _weights(net, 3)
    params = params_from_jax(net, init)
    batches = _batches(3, 4)
    jp, js, jl = _run_jax(jnet, jax.tree_util.tree_map(np.array, init),
                          batches)
    pp, ps, pl, step = _run_port(net, params, batches)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pl[2] != pl[0]
    _assert_trees_close(pp, jp, "param")
    _assert_trees_close(ps.solver.history, js.solver.history, "momentum")
    # the sharers read the owners' leaves: one tensor each
    leaves = step._leaf_tree
    for sharer, owner in SHARERS.items():
        lp = net._layer_params(leaves, net._layer_by_name[sharer])
        for p in ("w", "b"):
            assert lp[p] is leaves[owner][p]


def test_siamese_gradients_sum_both_branches_as_jax():
    jnet, net = _siamese()
    init = _weights(net, 5)
    batch = _batches(1, 6)[0]
    ref = jax.grad(lambda p: jnet.apply(p, batch, train=True).loss)(
        jax.tree_util.tree_map(np.array, init))
    params = {l: {p: torch.from_numpy(v.copy()).requires_grad_(True)
                  for p, v in d.items()} for l, d in init.items()}
    out = net.apply(params, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, train=True)
    out.loss.backward()
    _assert_trees_close({l: {p: v.grad for p, v in d.items()}
                         for l, d in params.items()}, ref, "grad")


def test_siamese_snapshots_cross_load_both_ways(tmp_path):
    jnet, net = _siamese()
    init = _weights(net, 7)
    as_jax = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    batches = _batches(2, 8)
    # JAX snapshot -> port restore and .caffemodel load
    jp, js, _ = _run_jax(jnet, as_jax(init), batches[:1])
    jmodel, jpath = jax_ckpt.snapshot(str(tmp_path / "jax"), jnet, jp, js)
    params, state = checkpoint.restore(jpath)
    assert state.solver.it == 1
    _assert_trees_close(params, jp, "restored param", tol=dict(rtol=0,
                                                               atol=0))
    loaded = checkpoint.load_caffemodel(jmodel, net,
                                        params_from_jax(net, init))
    _assert_trees_close(loaded, jp, "caffemodel param",
                        tol=dict(rtol=0, atol=0))
    # port snapshot -> JAX restore and .caffemodel load
    pp, ps, _, _ = _run_port(net, params_from_jax(net, init), batches[:1])
    model, ppath = checkpoint.snapshot(str(tmp_path / "port"), net, pp, ps)
    rparams, rstate = jax_ckpt.restore(ppath)
    assert int(rstate.solver.it) == 1
    assert set(rparams) == set(OWNERS)
    for l in pp:
        for p in pp[l]:
            np.testing.assert_array_equal(np.asarray(rparams[l][p]),
                                          pp[l][p].numpy())
            np.testing.assert_array_equal(
                np.asarray(rstate.solver.history[l][p]),
                ps.solver.history[l][p].numpy())
    jloaded = jax_ckpt.load_caffemodel(model, jnet, as_jax(init))
    for l in pp:
        for p in pp[l]:
            np.testing.assert_array_equal(np.asarray(jloaded[l][p]),
                                          pp[l][p].numpy())
    # Caffe's layout: every sharer's blobs repeat its owner's, in both
    # packages' files
    for path in (model, jmodel):
        with open(path, "rb") as f:
            blobs = decode_caffemodel(f.read())
        assert set(blobs) == set(OWNERS) | set(SHARERS)
        for sharer, owner in SHARERS.items():
            for a, b in zip(blobs[sharer], blobs[owner]):
                np.testing.assert_array_equal(a, b)
    # one step from either restored state gives the same params
    jp2, _, _ = _run_jax(jnet, rparams, batches[1:], state=rstate)
    pp2, _, _, _ = _run_port(net, params, batches[1:], state=state)
    _assert_trees_close(pp2, jp2, "param after resumed step")


def test_export_and_load_weights_follow_caffe_layout():
    _, net = _siamese()
    params = params_from_jax(net, _weights(net, 9))
    exported = net.export_weights(params)
    assert list(exported) == ["conv1", "ip1", "feat", "conv1_p", "ip1_p",
                              "feat_p"]
    # a file whose sharer blob differs: the last one read wins, as
    # Caffe's CopyTrainedLayersFrom writes through the shared storage
    exported["ip1_p"][0] = exported["ip1_p"][0] + 1.0
    loaded = net.load_weights(params, exported)
    np.testing.assert_array_equal(loaded["ip1"]["w"].numpy(),
                                  exported["ip1_p"][0])
    assert set(loaded) == set(OWNERS)


SHARE_BASE = """
name: "share"
input: "x" input_dim: 2 input_dim: 3 input_dim: 2 input_dim: 2
input: "z" input_dim: 2 input_dim: 8 input_dim: 1 input_dim: 1
"""
V1_OWNER = """
layers { name: "a" type: INNER_PRODUCT bottom: "x" top: "ya" param: "w"
  inner_product_param { num_output: 6 weight_filler { type: "xavier" } } }
"""


def _refusals():
    return {
        "strict_shape": SHARE_BASE + V1_OWNER + """
layers { name: "b" type: INNER_PRODUCT bottom: "z" top: "yb" param: "w"
  inner_product_param { num_output: 9 } }""",
        "permissive_count_v1": SHARE_BASE + V1_OWNER + """
layers { name: "b" type: INNER_PRODUCT bottom: "z" top: "yb" param: "w"
  blob_share_mode: PERMISSIVE inner_product_param { num_output: 8 } }""",
        "multipliers": SHARE_BASE + V1_OWNER + """
layers { name: "b" type: INNER_PRODUCT bottom: "x" top: "yb" param: "w"
  blobs_lr: 2 inner_product_param { num_output: 6 } }""",
        "permissive_count_v2": SHARE_BASE + """
layer { name: "a" type: "InnerProduct" bottom: "x" top: "ya"
  param { name: "w" } inner_product_param { num_output: 6 } }
layer { name: "b" type: "InnerProduct" bottom: "z" top: "yb"
  param { name: "w" share_mode: PERMISSIVE }
  inner_product_param { num_output: 7 } }""",
        "strict_v2": SHARE_BASE + """
layer { name: "a" type: "InnerProduct" bottom: "x" top: "ya"
  param { name: "w" lr_mult: 1 decay_mult: 0 }
  inner_product_param { num_output: 6 } }
layer { name: "b" type: "InnerProduct" bottom: "z" top: "yb"
  param { name: "w" lr_mult: 1 decay_mult: 0 }
  inner_product_param { num_output: 9 } }""",
        "multipliers_v2": SHARE_BASE + """
layer { name: "a" type: "InnerProduct" bottom: "x" top: "ya"
  param { name: "w" lr_mult: 1 decay_mult: 0 }
  inner_product_param { num_output: 6 } }
layer { name: "b" type: "InnerProduct" bottom: "x" top: "yb"
  param { name: "w" lr_mult: 1 decay_mult: 1 }
  inner_product_param { num_output: 6 } }""",
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_share_refusals_give_jax_messages(case):
    text = _refusals()[case]
    with pytest.raises(ValueError) as want:
        JaxNet(jax_load_str(text), "TEST")
    with pytest.raises(ValueError) as got:
        Net(load_net_from_string(text), "TEST", device="cpu")
    assert str(got.value) == str(want.value)
    assert "shared param 'w'" in str(got.value)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_permissive_share_of_another_shape_runs_as_jax(version):
    """(6, 12) stored once, read as (9, 8) by the PERMISSIVE sharer."""
    if version == "v1":
        text = SHARE_BASE + V1_OWNER + """
layers { name: "b" type: INNER_PRODUCT bottom: "z" top: "yb" param: "w"
  blob_share_mode: PERMISSIVE inner_product_param { num_output: 9 } }"""
    else:
        text = SHARE_BASE + """
layer { name: "a" type: "InnerProduct" bottom: "x" top: "ya"
  param { name: "w" } inner_product_param { num_output: 6 } }
layer { name: "b" type: "InnerProduct" bottom: "z" top: "yb"
  param { name: "w" share_mode: PERMISSIVE }
  inner_product_param { num_output: 9 } }"""
    jnet = JaxNet(jax_load_str(text), "TEST")
    net = Net(load_net_from_string(text), "TEST", device="cpu")
    assert net.param_defs["a"][0].shape == (6, 12)
    assert [p.shape for p in net.param_defs["b"]] == [(9,)]
    init = _weights(net, 11, scale=0.5)
    rs = np.random.RandomState(12)
    feeds = {"x": rs.randn(2, 3, 2, 2).astype(np.float32),
             "z": rs.randn(2, 8, 1, 1).astype(np.float32)}
    want = jnet.apply(jax.tree_util.tree_map(np.array, init), feeds).outputs
    got = net.apply(params_from_jax(net, init),
                    {k: torch.from_numpy(v) for k, v in feeds.items()}
                    ).outputs
    for k in ("ya", "yb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **FWD_TOL)
    exported = net.export_weights()
    assert exported["b"][0].shape == (9, 8)
    np.testing.assert_array_equal(exported["b"][0].reshape(-1),
                                  exported["a"][0].reshape(-1))


class _RecordingGroup:
    """A stand-in data group: each all-reduce records a copy of its
    buffer (a world of one leaves the values as they are)."""
    world = 1

    def __init__(self):
        self.sent = []

    def all_reduce_(self, buf, async_op=False):
        self.sent.append(buf.detach().clone())
        return None


def test_dwbp_issues_a_shared_leaf_once_after_both_sharers():
    _, net = _siamese()
    params = params_from_jax(net, _weights(net, 13))
    step = build_train_step(net, SolverParameter(**SOLVER))
    step.load(params, init_train_state(params))
    cfg = S.CommConfig(bucket_mb=0)     # one bucket a leaf
    group = _RecordingGroup()
    sync = S.BucketSync(group, cfg, step.arena.slots,
                        S.sync_kinds(net, cfg), step.leaves, step.flat_g)
    assert len(sync.hooked) == len(step.leaves) == 6
    fired = {i: 0 for i in range(len(step.leaves))}
    for i, leaf in enumerate(step.leaves):
        leaf.register_post_accumulate_grad_hook(
            lambda _l, i=i: fired.__setitem__(i, fired[i] + 1))
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, 14)[0].items()}
    # the summed gradient, from a separate autograd pass over copies
    ref = {l: {p: v.detach().clone().requires_grad_(True)
               for p, v in d.items()} for l, d in params.items()}
    net.apply(ref, batch, train=True).loss.backward()
    with torch.no_grad():
        step.flat_g.zero_()
    sync.begin()
    net.apply(step._leaf_tree, batch, train=True).loss.backward()
    sync.finish()
    # each leaf's accumulation ran once, on the sum of both branches
    assert list(fired.values()) == [1] * 6
    assert sync.issued == list(range(6))
    for b, bucket in enumerate(sync.hooked):
        (i,) = bucket.leaves
        s = step.arena.slots[i]
        np.testing.assert_allclose(
            group.sent[b].numpy(),
            ref[s.layer][s.pname].grad.reshape(-1).numpy(), rtol=1e-6,
            atol=1e-7, err_msg=f"{s.layer}/{s.pname}")
    # the owners' gradients differ from one branch's alone
    one = {l: {p: v.detach().clone().requires_grad_(True)
               for p, v in d.items()} for l, d in params.items()}
    out = net.apply(one, batch, train=True, keep_blobs=True)
    torch.autograd.backward(out.blobs["feat"], torch.ones_like(
        out.blobs["feat"]))
    assert not torch.allclose(one["conv1"]["w"].grad,
                              ref["conv1"]["w"].grad)


def test_auto_strategies_pick_for_sharers_as_jax():
    jnet, net = _siamese()
    assert S.auto_strategies(net) == jax_auto_strategies(jnet)
    assert {"ip1", "ip1_p"} <= set(S.auto_strategies(net))


def test_extract_prototxt_builds_and_runs_forward_as_jax():
    shapes = {"data": (4, 3, 32, 32), "label": (4,)}
    jnet = JaxNet(jax_load_net(EXTRACT), "TEST", conv_layout="NCHW",
                  source_shapes=shapes)
    net = Net(load_net(EXTRACT), "TEST", device="cpu", source_shapes=shapes)
    assert [l.TYPE for l in net.layers][-2:] == ["SILENCE", "SILENCE"]
    init = _weights(net, 15)
    rs = np.random.RandomState(16)
    feeds = {"data": rs.rand(*shapes["data"]).astype(np.float32),
             "label": rs.randint(0, 3, size=(4,)).astype(np.float32)}
    want = jnet.apply(jax.tree_util.tree_map(np.array, init), feeds,
                      keep_blobs=True)
    got = net.apply(params_from_jax(net, init),
                    {k: torch.from_numpy(v) for k, v in feeds.items()},
                    keep_blobs=True)
    assert set(got.outputs) == set(want.outputs) == set()
    np.testing.assert_allclose(got.blobs["feat"].numpy(),
                               np.asarray(want.blobs["feat"]), **FWD_TOL)
