"""The channels-last (NHWC) CNN graph of the port against its NCHW graph and
against the JAX package's ``conv_layout="NHWC"`` Net, on the CPU.

- The plain LRN forward and backward on channels-last tensors against the
  JAX Pallas kernels K4/K5 run in interpret mode with ``layout="NHWC"``
  (f32 rtol 1e-5, atol 1e-6: ``pow`` may differ by an ulp; bf16 one
  rounding step, rtol 2^-7, as ``tests/test_torch_lrn.py``), and the plain
  pooling backward on channels-last tensors against the JAX taps arm with
  ``layout="NHWC"`` (bitwise: the same f32 adds in the same order).
- Every plain version and the forward of pooling keep the input's memory
  format, and give the NCHW results bitwise.
- Nets: the cases of ``tests/test_layout_parity.py`` the port's layer set
  covers (grouped conv, MAX/AVE/global pooling, both LRN regions, concat
  with an in-graph softmax, dropout), a narrow AlexNet and LeNet: the
  loss and every gradient of the port's NHWC net against its NCHW net and
  against JAX's NHWC net, then 3 training steps at the train-step
  tolerance (rtol 1e-4, atol 1e-6; losses rtol 1e-5): the conv sums of the
  two layouts, and of XLA and torch, run in other orders.
- Memory formats: every 4-D blob of the NHWC net is channels-last from the
  data entry to the FC boundary, its gradients too; the arena's
  gradients are the OIHW views they were, written in place.
- A 4-D dropout drops the same units in both layouts; snapshots load
  across layouts, both ways, and JAX's NHWC snapshots load into the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.ops import nn as JNN
from poseidon_tpu.ops.pallas_kernels import lrn_fused, lrn_fused_bwd
from poseidon_tpu.parallel.trainer import build_train_step as jax_step
from poseidon_tpu.parallel.trainer import init_train_state as jax_state
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu.runtime import checkpoint as jax_ckpt
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.numeric import memory_format
from poseidon_tpu_torch.ops import elementwise as E
from poseidon_tpu_torch.ops import lrn as port_lrn
from poseidon_tpu_torch.ops import pool as port_pool
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto.messages import (SolverParameter,
                                               load_net_from_string)
from poseidon_tpu_torch.runtime import checkpoint

CL = torch.channels_last


def is_channels_last(t: torch.Tensor) -> bool:
    return memory_format(t) == CL
ALPHA, BETA, K = 0.7, 0.75, 1.3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)


def _cl(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).contiguous(
        memory_format=CL)


# --------------------------------------------------------------------------- #
# the plain versions on channels-last tensors
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("local_size", [3, 4, 5])
@pytest.mark.parametrize("channels", [7, 16])
def test_plain_lrn_channels_last_matches_pallas_nhwc(local_size, channels):
    rs = np.random.RandomState(local_size * 100 + channels)
    x = rs.randn(2, channels, 5, 6).astype(np.float32)
    g = rs.randn(2, channels, 5, 6).astype(np.float32)
    xh, gh = x.transpose(0, 2, 3, 1), g.transpose(0, 2, 3, 1)
    ref = np.asarray(lrn_fused(jnp.asarray(xh), local_size, ALPHA, BETA, K,
                               interpret=True, layout="NHWC"))
    ref_dx = np.asarray(lrn_fused_bwd(jnp.asarray(xh), jnp.asarray(gh),
                                      local_size, ALPHA, BETA, K,
                                      interpret=True, layout="NHWC"))
    y = port_lrn.lrn_across_channels_plain(_cl(x), local_size, ALPHA, BETA,
                                           K)
    dx = port_lrn.lrn_bwd_plain(_cl(x), _cl(g), local_size, ALPHA, BETA, K)
    assert is_channels_last(y) and is_channels_last(dx)
    np.testing.assert_allclose(y.numpy(), ref.transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), ref_dx.transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local_size", [4, 5])
def test_plain_lrn_channels_last_bf16_matches_pallas_nhwc(local_size):
    """bf16 in, f32 compute, bf16 out on both sides: one bf16 rounding step
    (2^-7 relative) where an ulp of pow flips a rounding."""
    rs = np.random.RandomState(30 + local_size)
    xb = torch.from_numpy(rs.randn(2, 16, 5, 6).astype(np.float32)).to(
        torch.bfloat16)
    gb = torch.from_numpy(rs.randn(2, 16, 5, 6).astype(np.float32)).to(
        torch.bfloat16)
    xh = jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)
    gh = jnp.asarray(gb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)
    ref = np.asarray(lrn_fused(xh, local_size, ALPHA, BETA, K,
                               interpret=True, layout="NHWC")
                     .astype(jnp.float32)).transpose(0, 3, 1, 2)
    ref_dx = np.asarray(lrn_fused_bwd(xh, gh, local_size, ALPHA, BETA, K,
                                      interpret=True, layout="NHWC")
                        .astype(jnp.float32)).transpose(0, 3, 1, 2)
    y = port_lrn.lrn_across_channels_plain(xb.contiguous(memory_format=CL),
                                           local_size, ALPHA, BETA, K)
    dx = port_lrn.lrn_bwd_plain(xb.contiguous(memory_format=CL),
                                gb.contiguous(memory_format=CL), local_size,
                                ALPHA, BETA, K)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert is_channels_last(y) and is_channels_last(dx)
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(dx.float().numpy(), ref_dx, rtol=2 ** -7,
                               atol=1e-6)


GEOMS = [((3, 3), (2, 2), (0, 0), 11), ((3, 3), (2, 2), (1, 1), 9),
         ((2, 2), (2, 2), (0, 0), 8), ((3, 3), (1, 1), (1, 1), 7),
         ((2, 2), (3, 3), (0, 0), 10), ((3, 3), (2, 2), (0, 0), 13)]


@pytest.mark.parametrize("method", ["max", "ave"])
@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_pool_bwd_channels_last_matches_jax_taps_nhwc(
        method, geom, dtype, monkeypatch):
    monkeypatch.setenv("POSEIDON_POOL_BWD", "taps")
    kern, s, p, h = geom
    rs = np.random.RandomState(h * 10 + kern[0] + s[0])
    x = torch.from_numpy(rs.randn(2, 5, h, h).astype(np.float32)).to(dtype)
    if method == "max":
        x[0, 1, :3] = -math.inf          # rows of -inf: flat index 0
        x[1, 2] = 0.25                   # a constant plane: ties
    oh = port_pool.pool_out_size(h, kern[0], s[0], p[0])
    g = torch.from_numpy(rs.randn(2, 5, oh, oh).astype(np.float32)).to(dtype)
    xc, gc = x.contiguous(memory_format=CL), g.contiguous(memory_format=CL)
    got = port_pool.pool_bwd_plain(xc, gc, kern, s, p, method)
    assert got.dtype == dtype and is_channels_last(got)
    # the NCHW plain version, bitwise
    assert torch.equal(got, port_pool.pool_bwd_plain(x, g, kern, s, p,
                                                     method))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xh = jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1), jdt)
    gh = jnp.asarray(g.float().numpy().transpose(0, 2, 3, 1), jdt)
    fn = JNN.max_pool if method == "max" else JNN.ave_pool
    y_ref, vjp = jax.vjp(lambda x_: fn(x_, kern, s, p, "NHWC"), xh)
    ref = np.asarray(vjp(gh)[0].astype(jnp.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    y = port_pool.pool_forward(xc, kern, s, p, method)
    y_ref = np.asarray(y_ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    if method == "max":
        np.testing.assert_array_equal(y.float().numpy(), y_ref)
    elif dtype == torch.float32:
        np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=1e-6,
                                   atol=1e-7)
    else:
        # XLA sums a bf16 window in bf16, a rounding an add; torch sums in
        # f32 and rounds once: a few bf16 steps of the window's sum apart
        np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=2 ** -6,
                                   atol=2 ** -6)


@pytest.mark.parametrize("method", ["max", "ave"])
def test_pool_forward_keeps_memory_format(method):
    """The Caffe pad, the crop to the windows' extent and torch's pooling
    all keep channels-last: the pooled output is channels-last, and equal
    to the NCHW forward bitwise."""
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2, 6, 9, 9).astype(np.float32))
    xc = x.contiguous(memory_format=CL)
    xp = port_pool._pool_pad_crop(xc, (3, 3), (2, 2), (1, 1), 4, 4, 0.0)
    assert xp.is_contiguous(memory_format=CL) or is_channels_last(
        xp.contiguous(memory_format=CL)) and xp.stride()[1] == 1
    y = port_pool.pool_forward(xc, (3, 3), (2, 2), (1, 1), method)
    assert is_channels_last(y)
    assert torch.equal(y, port_pool.pool_forward(x, (3, 3), (2, 2), (1, 1),
                                                 method))


@pytest.mark.parametrize("kind", ["lrn", "max", "ave"])
def test_functions_keep_the_memory_format_on_cpu(kind):
    """The LRN and pooling Functions give a channels-last output and input
    gradient for a channels-last input, equal to the NCHW run bitwise."""
    x0 = torch.from_numpy(np.random.RandomState(11).randn(
        2, 6, 9, 9).astype(np.float32))
    outs = {}
    for fmt in (torch.contiguous_format, CL):
        x = x0.clone().contiguous(memory_format=fmt).requires_grad_(True)
        if kind == "lrn":
            y = port_lrn.lrn_across_channels(x, 5, ALPHA, BETA, K)
        elif kind == "max":
            y = port_pool.max_pool(x, (3, 3), (2, 2), (0, 0))
        else:
            y = port_pool.ave_pool(x, (3, 3), (2, 2), (1, 1))
        (y * y).sum().backward()
        outs[fmt] = (y.detach(), x.grad)
    y, dx = outs[CL]
    assert is_channels_last(y) and is_channels_last(dx)
    y0, dx0 = outs[torch.contiguous_format]
    if kind == "lrn":
        # torch's CPU pow takes its vectorised or its scalar path by where
        # an element falls in the memory order: an ulp apart (the card's
        # pow is per element, and the kernels are held bitwise there)
        torch.testing.assert_close(y, y0, rtol=1e-6, atol=0)
        torch.testing.assert_close(dx, dx0, rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(y, y0) and torch.equal(dx, dx0)


# --------------------------------------------------------------------------- #
# nets: the port's NHWC graph against its NCHW graph and JAX's NHWC graph
# --------------------------------------------------------------------------- #

_CONV = """layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" }
    bias_filler { type: "constant" value: 0.1 } } }
"""
_HEAD = """layers { name: "fc" type: INNER_PRODUCT bottom: "%s" top: "fc"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc" bottom: "label"
  top: "loss" }
"""
_INPUT = """input: "data" input_dim: 2 input_dim: 4 input_dim: 9 input_dim: 9
input: "label" input_dim: 2 input_dim: 1 input_dim: 1 input_dim: 1
"""
_OPS = {
    "conv_group": """layers { name: "op" type: CONVOLUTION bottom: "conv"
  top: "op" convolution_param { num_output: 8 kernel_size: 3 pad: 1
    group: 2 weight_filler { type: "xavier" } } }""",
    "pool_max": """layers { name: "op" type: POOLING bottom: "conv" top: "op"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 pad: 1 } }""",
    "pool_ave": """layers { name: "op" type: POOLING bottom: "conv" top: "op"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }""",
    "pool_global": """layers { name: "op" type: POOLING bottom: "conv"
  top: "op" pooling_param { pool: AVE global_pooling: true } }""",
    "lrn_across": """layers { name: "op" type: LRN bottom: "conv" top: "op"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }""",
    "lrn_within": """layers { name: "op" type: LRN bottom: "conv" top: "op"
  lrn_param { local_size: 3 alpha: 0.0001 beta: 0.75
    norm_region: WITHIN_CHANNEL } }""",
    # the structural seam: concat on channels and an in-graph softmax on a
    # 4-D blob, inside the NHWC region
    "concat_softmax": """layers { name: "relu" type: RELU bottom: "conv"
  top: "r" }
layers { name: "cat" type: CONCAT bottom: "conv" bottom: "r" top: "cat"
  concat_param { concat_dim: 1 } }
layers { name: "op" type: SOFTMAX bottom: "cat" top: "op" }""",
}


def _case_text(case: str) -> str:
    return ('name: "t"\n' + _INPUT + _CONV + _OPS[case] + "\n"
            + _HEAD % "op")


def _feed(seed: int, data_shape, n_classes: int = 5):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(*data_shape).astype(np.float32),
            "label": rs.randint(0, n_classes, size=(data_shape[0], 1, 1, 1))
            .astype(np.float32)}


def _port_loss_and_grads(net, params, batch, train=True, seed=None):
    leaves = {l: {p: v.clone().requires_grad_(True) for p, v in d.items()}
              for l, d in params.items()}
    if seed is not None:
        net.generator.manual_seed(seed)
    out = net.apply(leaves, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, train=train, keep_blobs=True)
    out.loss.backward()
    return out, {l: {p: v.grad for p, v in d.items()}
                 for l, d in leaves.items()}


def _close(a, b, what, **tol):
    tol = tol or PARAM_TOL
    for l in b:
        for p in b[l]:
            np.testing.assert_allclose(np.asarray(a[l][p]),
                                       np.asarray(b[l][p]), **tol,
                                       err_msg=f"{what} {l}/{p}")


@pytest.mark.parametrize("case", sorted(_OPS))
def test_layer_type_parity(case):
    text = _case_text(case)
    jnet = JaxNet(jax_load_str(text), "TRAIN", conv_layout="NHWC")
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jnet.init(jax.random.PRNGKey(0)))
    batch = _feed(42, (2, 4, 9, 9))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnet.apply(p, batch, train=True).loss)(jparams)
    got = {}
    for layout in ("NCHW", "NHWC"):
        net = Net(load_net_from_string(text), "TRAIN", device="cpu",
                  conv_layout=layout)
        assert net.conv_layout == layout
        params = params_from_jax(net, jparams)
        got[layout] = _port_loss_and_grads(net, params, batch)
    (out_c, g_c), (out_h, g_h) = got["NCHW"], got["NHWC"]
    np.testing.assert_allclose(float(out_h.loss), float(out_c.loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(out_h.loss), float(jloss),
                               rtol=LOSS_RTOL)
    _close(g_h, g_c, f"{case}: NHWC vs NCHW grad")
    _close(g_h, jgrads, f"{case}: NHWC vs JAX NHWC grad")
    # every 4-D blob of the spatial region is channels-last, the FC
    # boundary gathers the canonical order
    for name in ("conv", "op"):
        blob = out_h.blobs[name]
        if blob.dim() == 4 and blob.shape[1] > 1 and blob.shape[2:].numel() > 1:
            assert is_channels_last(blob), (case, name)


NARROW_ALEXNET = """
name: "NarrowAlexNet"
input: "data" input_dim: 4 input_dim: 3 input_dim: 35 input_dim: 35
input: "label" input_dim: 4 input_dim: 1 input_dim: 1 input_dim: 1
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 } }
layers { name: "pool1" type: POOLING bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv2" type: CONVOLUTION bottom: "pool1" top: "conv2"
  convolution_param { num_output: 16 pad: 2 kernel_size: 5 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu2" type: RELU bottom: "conv2" top: "conv2" }
layers { name: "norm2" type: LRN bottom: "conv2" top: "norm2"
  lrn_param { local_size: 4 alpha: 0.5 beta: 0.75 } }
layers { name: "pool2" type: POOLING bottom: "norm2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv3" type: CONVOLUTION bottom: "pool2" top: "conv3"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu3" type: RELU bottom: "conv3" top: "conv3" }
layers { name: "pool5" type: POOLING bottom: "conv3" top: "pool5"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool5" top: "fc6"
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "fc8" type: INNER_PRODUCT bottom: "fc6" top: "fc8"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "accuracy" type: ACCURACY bottom: "fc8" bottom: "label"
  top: "accuracy" }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "loss" }
"""
SPATIAL_BLOBS = ("conv1", "norm1", "pool1", "conv2", "norm2", "pool2",
                 "conv3", "pool5")


def _torch_batches(n, seed):
    out = []
    for i in range(n):
        b = _feed(seed + i, (4, 3, 35, 35), 10)
        out.append(b)
    return out


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


def _run_jax(jnet, params, batches, state=None):
    ts = jax_step(jnet, JaxSolver(**SOLVER),
                  Mesh(np.array(jax.devices()[:1]), ("data",)))
    state = jax_state(params) if state is None else state
    losses = []
    for b in batches:
        params, state, m = ts.step(params, state, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return params, state, losses


def _np(tree):
    return {l: {p: np.array(v) for p, v in d.items()} for l, d in
            tree.items()}


def test_narrow_alexnet_three_steps_nhwc_vs_nchw_vs_jax():
    jnet = JaxNet(jax_load_str(NARROW_ALEXNET), "TRAIN", conv_layout="NHWC")
    init = _np(jnet.init(jax.random.PRNGKey(3)))
    batches = _torch_batches(3, seed=4)
    results = {}
    for layout in ("NCHW", "NHWC"):
        net = Net(load_net_from_string(NARROW_ALEXNET), "TRAIN",
                  device="cpu", conv_layout=layout)
        results[layout] = _run_port(net, params_from_jax(net, init),
                                    batches)
    jp, js, jl = _run_jax(jnet, _np(init), batches)
    (pc, sc, lc, _), (ph, sh, lh, _) = results["NCHW"], results["NHWC"]
    np.testing.assert_allclose(lh, lc, rtol=LOSS_RTOL)
    np.testing.assert_allclose(lh, jl, rtol=LOSS_RTOL)
    assert lh[2] != lh[0]
    _close(ph, pc, "NHWC vs NCHW param")
    _close(sh.solver.history, sc.solver.history, "NHWC vs NCHW momentum")
    _close(ph, jp, "NHWC vs JAX NHWC param")
    _close(sh.solver.history, js.solver.history, "NHWC vs JAX momentum")


def test_blobs_and_grads_channels_last_to_the_fc_boundary():
    net = Net(load_net_from_string(NARROW_ALEXNET), "TRAIN", device="cpu",
              conv_layout="NHWC")
    jnet = JaxNet(jax_load_str(NARROW_ALEXNET), "TRAIN")
    params = params_from_jax(net, _np(jnet.init(jax.random.PRNGKey(1))))
    batch = {k: torch.from_numpy(v)
             for k, v in _torch_batches(1, seed=2)[0].items()}
    seen = {}

    def keep(name):
        return lambda g: seen.__setitem__(name, g)

    leaves = {l: {p: v.clone().requires_grad_(True) for p, v in d.items()}
              for l, d in params.items()}
    out = net.apply(leaves, batch, train=True, keep_blobs=True)
    for name in SPATIAL_BLOBS:
        assert is_channels_last(out.blobs[name]), name
        out.blobs[name].register_hook(keep(name))
    assert out.blobs["fc6"].dim() == 2
    out.loss.backward()
    for name in SPATIAL_BLOBS[:-1]:
        assert is_channels_last(seen[name]), f"d{name}"
    # the FC's flatten is the boundary: its input's gradient comes back in
    # the canonical order (the pooling backward takes it to channels-last)
    assert seen["pool5"].is_contiguous()
    # the arena's gradients: views of one flat buffer, OIHW, in place
    step = build_train_step(net, SolverParameter(**SOLVER))
    p, s = step.load(params, init_train_state(params))
    ptrs = [leaf.grad.data_ptr() for leaf in step.leaves]
    step.step(p, s, batch)
    for leaf, ptr in zip(step.leaves, ptrs):
        assert leaf.grad.data_ptr() == ptr
        assert leaf.grad.is_contiguous()
    g = {sl.layer + "/" + sl.pname: step.flat_g[sl.offset:sl.offset
                                                + sl.size].view(sl.shape)
         for sl in step.arena.slots}
    ref_net = Net(load_net_from_string(NARROW_ALEXNET), "TRAIN",
                  device="cpu", conv_layout="NCHW")
    _, ref = _port_loss_and_grads(ref_net, params, {
        k: v.numpy() for k, v in batch.items()})
    for l in ref:
        for pn in ref[l]:
            np.testing.assert_allclose(g[f"{l}/{pn}"].numpy(),
                                       ref[l][pn].numpy(), **PARAM_TOL,
                                       err_msg=f"arena grad {l}/{pn}")


def test_dropout_mask_is_the_same_in_both_layouts():
    x = torch.from_numpy(np.random.RandomState(5).randn(
        3, 6, 5, 7).astype(np.float32)) + 2.0
    outs = []
    for fmt in (torch.contiguous_format, CL):
        gen = torch.Generator().manual_seed(17)
        outs.append(E.dropout(x.contiguous(memory_format=fmt), 0.5, True,
                              gen))
    assert torch.equal(outs[0], outs[1])
    assert bool((outs[0] == 0).any()) and bool((outs[0] != 0).any())
    # and through a net: train-mode losses bitwise across the plans
    text = ('name: "t"\n' + _INPUT + _CONV + """layers { name: "drop"
  type: DROPOUT bottom: "conv" top: "conv"
  dropout_param { dropout_ratio: 0.5 } }
""" + _HEAD % "conv")
    jnet = JaxNet(jax_load_str(text), "TRAIN")
    jparams = _np(jnet.init(jax.random.PRNGKey(0)))
    batch = _feed(7, (2, 4, 9, 9))
    losses = []
    for layout in ("NCHW", "NHWC"):
        net = Net(load_net_from_string(text), "TRAIN", device="cpu",
                  conv_layout=layout)
        out, _ = _port_loss_and_grads(net, params_from_jax(net, jparams),
                                      batch, seed=23)
        losses.append(float(out.loss))
    assert losses[0] == losses[1]


def test_snapshots_load_across_layouts(tmp_path):
    """A snapshot of the NHWC-trained port net restores into the NCHW net
    and into JAX's NHWC net (canonical arrays); one step from it agrees
    across all three; JAX's NHWC snapshot restores into the port's NHWC
    net."""
    jnet = JaxNet(jax_load_str(NARROW_ALEXNET), "TRAIN", conv_layout="NHWC")
    init = _np(jnet.init(jax.random.PRNGKey(7)))
    batches = _torch_batches(2, seed=8)
    nets = {lay: Net(load_net_from_string(NARROW_ALEXNET), "TRAIN",
                     device="cpu", conv_layout=lay)
            for lay in ("NCHW", "NHWC")}
    pp, ps, _, _ = _run_port(nets["NHWC"], params_from_jax(nets["NHWC"],
                                                           init),
                             batches[:1])
    _, path = checkpoint.snapshot(str(tmp_path / "port"), nets["NHWC"], pp,
                                  ps)
    params, state = checkpoint.restore(path)
    for l in pp:
        for p in pp[l]:
            assert params[l][p].is_contiguous()
            assert torch.equal(params[l][p], pp[l][p])
    rparams, rstate = jax_ckpt.restore(path)
    after = {lay: _run_port(nets[lay], params, batches[1:], state=state)[0]
             for lay in ("NCHW", "NHWC")}
    jp2, _, _ = _run_jax(jnet, rparams, batches[1:], state=rstate)
    _close(after["NHWC"], after["NCHW"], "resumed NHWC vs NCHW")
    _close(after["NHWC"], jp2, "resumed port vs JAX NHWC")
    # JAX's NHWC snapshot into the port's NHWC net
    jp, js, _ = _run_jax(jnet, _np(init), batches[:1])
    _, jpath = jax_ckpt.snapshot(str(tmp_path / "jax"), jnet, jp, js)
    params2, state2 = checkpoint.restore(jpath)
    assert state2.solver.it == 1
    _close(params2, _np(jp), "JAX NHWC snapshot in the port")
    got, _, _, _ = _run_port(nets["NHWC"], params2, batches[1:],
                             state=state2)
    _close(got, jp2, "port NHWC resumed from JAX's snapshot")


def test_conv_layout_default_and_auto_on_the_cpu():
    net = Net(load_net_from_string(_case_text("pool_max")), "TRAIN",
              device="cpu")
    assert net.conv_layout == "NCHW"
    net = Net(load_net_from_string(_case_text("pool_max")), "TRAIN",
              device="cpu", conv_layout="auto")
    assert net.conv_layout == "NCHW"
    with pytest.raises(ValueError):
        Net(load_net_from_string(_case_text("pool_max")), "TRAIN",
            device="cpu", conv_layout="NWHC")
