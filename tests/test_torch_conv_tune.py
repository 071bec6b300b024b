"""The port's im2col conv lowering and its measured per-layer conv tuner
(``ops/nn.py``, ``ops/conv_tune.py``, ``core/net.py``) against the JAX
package's, on seeded numpy inputs:

- the im2col conv (patches in Caffe's column order and one GEMM) against
  JAX's ``conv2d(strategy="im2col")`` and ``jax.vjp`` in both layouts,
  strides and pads above 1: f32 at rtol 1e-5, atol 1e-5; bf16 without the
  ReLU epilogue (whose mask flips where a bf16 output rounds to 0), each
  element within 2^-7 of the L1 bound of its sum (the f32-accumulated
  sums of exact bf16 products round to bf16 in both packages, in another
  order). A channels-last input keeps a channels-last output; a grouped
  conv takes the direct path; "auto" reaching ``conv2d`` raises JAX's
  ValueError;
- net-wide ``conv_strategy="im2col"`` on a narrow AlexNet (its grouped
  convs fall back to direct) for 3 steps against JAX's (losses rtol
  1e-5, params and momentum rtol 1e-4, atol 1e-6);
- ``conv_tune.resolve``'s order memo -> persisted -> measured, and
  only-candidate; shape-equal layers measure once; the key's parts; the
  ``[conv_strategy]`` table of a net built under "auto".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu import config as jconfig
from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.ops import nn as JNN
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch import numeric as tnum
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.numeric import memory_format
from poseidon_tpu_torch.ops import conv_tune
from poseidon_tpu_torch.ops import nn as NN
from poseidon_tpu_torch.proto.messages import load_net_from_string
from test_torch_layout import (LOSS_RTOL, NARROW_ALEXNET, _close, _np,
                               _run_jax, _run_port, _torch_batches)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2 ** -7

# (channels, height, width, out, kernel, stride, pad)
GEOMS = [(3, 13, 14, 5, 5, 2, 2), (4, 9, 9, 6, 3, 1, 1),
         (2, 11, 10, 3, 4, 3, 0), (6, 8, 8, 4, 1, 1, 0)]


def _inputs(geom, seed=0):
    c, h, w, o, k, _, _ = geom
    rs = np.random.RandomState(seed)
    return (rs.randn(2, c, h, w).astype(np.float32),
            (rs.randn(o, c, k, k) * 0.3).astype(np.float32),
            (rs.randn(o) * 0.1).astype(np.float32),
            rs.randn(2, o, (h + 2 * geom[6] - k) // geom[5] + 1,
                     (w + 2 * geom[6] - k) // geom[5] + 1).astype(np.float32))


def _jax_conv(x, w, b, g, stride, pad, layout, strategy, act="relu"):
    """JAX's conv2d output and vjp (dx, dw, db), NCHW-ordered arrays."""
    if layout == "NHWC":
        x = np.transpose(x, (0, 2, 3, 1))
        g = np.transpose(g, (0, 2, 3, 1))

    def f(x_, w_, b_):
        return JNN.conv2d(x_, w_, b_, (stride, stride), (pad, pad), 1,
                          layout=layout, act=act, strategy=strategy)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g).astype(y.dtype))
    y, dx = np.asarray(y.astype(jnp.float32)), np.asarray(
        dx.astype(jnp.float32))
    if layout == "NHWC":
        y, dx = np.transpose(y, (0, 3, 1, 2)), np.transpose(dx, (0, 3, 1, 2))
    return [y, dx, np.asarray(dw.astype(jnp.float32)),
            np.asarray(db.astype(jnp.float32))]


def _port_conv(x, w, b, g, stride, pad, layout, strategy, act="relu"):
    xt = torch.from_numpy(x)
    if layout == "NHWC":
        xt = xt.contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = NN.conv2d(xt, wt, bt, (stride, stride), (pad, pad), 1, act=act,
                  strategy=strategy)
    assert memory_format(y) == memory_format(xt) or y.shape[2:] == (1, 1)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt),
                                     torch.from_numpy(g).to(y.dtype))
    return [t.detach().float().numpy() for t in (y, dx, dw, db)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_im2col_conv_matches_jax_and_vjp(geom, layout, dtype):
    x, w, b, g = _inputs(geom)
    stride, pad = geom[5], geom[6]
    if dtype == "float32":
        want = _jax_conv(x, w, b, g, stride, pad, layout, "im2col")
        got = _port_conv(x, w, b, g, stride, pad, layout, "im2col")
        for name, a, e in zip(("y", "dx", "dw", "db"), got, want):
            np.testing.assert_allclose(a, e, **F32_TOL, err_msg=name)
        return
    with jconfig.policy_scope(compute_dtype=jnp.bfloat16):
        want = _jax_conv(x, w, b, g, stride, pad, layout, "im2col", None)
    with tnum.policy_scope(compute_dtype=torch.bfloat16):
        got = _port_conv(x, w, b, g, stride, pad, layout, "im2col", None)
    for name, a, e, bound in zip(("y", "dx", "dw", "db"), got, want,
                                 _l1_bounds(x, w, b, g, stride, pad)):
        assert np.all(np.abs(a - e) <= BF16_RTOL * bound), (
            name, float(np.max(np.abs(a - e) / np.maximum(bound, 1e-30))))


def _l1_bounds(x, w, b, g, stride, pad):
    """Each output element's L1 bound (the sum of its terms' magnitudes)
    for y, dx, dw and db, in f64."""
    ax, aw = torch.from_numpy(np.abs(x)).double(), \
        torch.from_numpy(np.abs(w)).double()
    ag = torch.from_numpy(np.abs(g)).double()
    ax.requires_grad_(True)
    aw.requires_grad_(True)
    y = torch.nn.functional.conv2d(ax, aw, None, stride, pad)
    dx, dw = torch.autograd.grad((y * ag).sum(), (ax, aw))
    y = y.detach() + torch.from_numpy(np.abs(b)).double().view(1, -1, 1, 1)
    return [t.numpy() for t in (y, dx, dw, ag.sum(dim=(0, 2, 3)))]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_im2col_equals_the_direct_conv(layout):
    """The port's two lowerings of one conv agree (f32 sums in another
    order), and im2col keeps x's memory format."""
    x, w, b, g = _inputs(GEOMS[0], seed=3)
    im = _port_conv(x, w, b, g, 2, 2, layout, "im2col")
    direct = _port_conv(x, w, b, g, 2, 2, layout, "direct")
    for name, a, e in zip(("y", "dx", "dw", "db"), im, direct):
        np.testing.assert_allclose(a, e, **F32_TOL, err_msg=name)


def test_grouped_im2col_takes_direct_and_auto_raises():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 4, 7, 7).astype(np.float32))
    w = torch.from_numpy(rs.randn(6, 2, 3, 3).astype(np.float32))
    got = NN.conv2d(x, w, None, (1, 1), (1, 1), 2, strategy="im2col")
    want = NN.conv2d(x, w, None, (1, 1), (1, 1), 2, strategy="direct")
    assert torch.equal(got, want)
    assert not NN.conv_strategy_applicable("im2col", x, w, (1, 1), 2)
    assert NN.conv_strategy_applicable("im2col", x, w, (1, 1), 1)
    jx = jnp.asarray(x.numpy())
    for bad in ("auto", "winograd"):
        with pytest.raises(ValueError) as jerr:
            JNN.conv2d(jx, jnp.asarray(w.numpy()), None, (1, 1), (1, 1), 2,
                       strategy=bad)
        with pytest.raises(ValueError) as terr:
            NN.conv2d(x, w, None, (1, 1), (1, 1), 2, strategy=bad)
        assert str(terr.value) == str(jerr.value)


def test_net_wide_im2col_narrow_alexnet_three_steps_vs_jax():
    jnet = JaxNet(jax_load_str(NARROW_ALEXNET), "TRAIN",
                  conv_strategy="im2col")
    init = _np(jnet.init(jax.random.PRNGKey(5)))
    batches = _torch_batches(3, seed=6)
    net = Net(load_net_from_string(NARROW_ALEXNET), "TRAIN", device="cpu",
              conv_strategy="im2col")
    assert net.conv_strategy_plan() == jnet.conv_strategy_plan()
    p, s, losses, _ = _run_port(net, params_from_jax(net, init), batches)
    jp, js, jl = _run_jax(jnet, _np(init), batches)
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    assert losses[2] != losses[0]
    _close(p, jp, "im2col param")
    _close(s.solver.history, js.solver.history, "im2col momentum")


# --------------------------------------------------------------------------- #
# the measured per-layer choice
# --------------------------------------------------------------------------- #

TUNE_NET = """
name: "TuneNet"
input: "data" input_dim: 2 input_dim: 3 input_dim: 16 input_dim: 16
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 4 stride: 2
    weight_filler { type: "xavier" } } }
layers { name: "convA" type: CONVOLUTION bottom: "conv1" top: "convA"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layers { name: "convB" type: CONVOLUTION bottom: "conv1" top: "convB"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layers { name: "convG" type: CONVOLUTION bottom: "convA" top: "convG"
  convolution_param { num_output: 4 kernel_size: 3 group: 2
    weight_filler { type: "xavier" } } }
"""


def test_key_parts_name_the_device_dtype_and_framework():
    dev = torch.device("cpu")
    parts = conv_tune._key_parts(3, 16, 16, (4, 4), (2, 2), (0, 0), 1, 4,
                                 "NCHW", 2, dev)
    assert parts["device_type"] == "cpu" and parts["device_name"] == "cpu"
    assert parts["compute_dtype"] == "float32"
    assert parts["framework"] == "torch"
    with tnum.policy_scope(compute_dtype=torch.bfloat16):
        bf = conv_tune._key_parts(3, 16, 16, (4, 4), (2, 2), (0, 0), 1, 4,
                                  "NCHW", 2, dev)
    assert conv_tune.strategy_key(bf) != conv_tune.strategy_key(parts)
    # the constants are JAX's
    from poseidon_tpu.ops import conv_tune as jct
    for name in ("CANDIDATES", "MICRO_BATCH", "MICRO_ITERS",
                 "TRIAL_WINDOWS", "TRIAL_WARMUP"):
        assert getattr(conv_tune, name) == getattr(jct, name), name


def test_resolve_memo_persisted_measured_only_candidate(tmp_path,
                                                         monkeypatch):
    from poseidon_tpu_torch.runtime import tuned_plan as tp

    calls = []
    real = tp.interleaved_min_ms

    def spy(fns, **kw):
        calls.append((sorted(fns), kw))
        return real(fns, **kw)

    monkeypatch.setattr(tp, "interleaved_min_ms", spy)
    conv_tune.clear_memo()
    geo = dict(c=3, h=10, w=10, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
               group=1, out_ch=4, layout="NCHW", batch=8,
               cache_dir=str(tmp_path), device="cpu")
    try:
        first = conv_tune.resolve("convH", **geo)
        assert first["source"] == "measured"
        assert first["winner"] == min(first["timings_ms"],
                                      key=first["timings_ms"].get)
        # the candidates s2d cannot lower drop out (3 channels, stride 2,
        # kernel >= stride: all three apply here)
        assert calls[0][0] == sorted(first["timings_ms"]) == \
            sorted(conv_tune.CANDIDATES)
        assert calls[0][1] == {"windows": conv_tune.TRIAL_WINDOWS,
                               "iters": conv_tune.MICRO_ITERS,
                               "warmup": conv_tune.TRIAL_WARMUP}
        assert first["parts"]["micro_batch"] == conv_tune.MICRO_BATCH
        assert conv_tune.resolve("again", **geo)["source"] == "memo"
        conv_tune.clear_memo()
        second = conv_tune.resolve("restart", **geo)
        assert second["source"] == "persisted"
        assert second["winner"] == first["winner"]
        assert len(calls) == 1
        # a grouped conv has direct alone: no measurement, nothing saved
        grouped = conv_tune.resolve("convG", **dict(geo, group=3, c=3,
                                                    out_ch=3))
        assert grouped["source"] == "only-candidate"
        assert grouped["winner"] == "direct" and len(calls) == 1
    finally:
        conv_tune.clear_memo()


def test_auto_net_measures_each_geometry_once(tmp_path, monkeypatch,
                                              capsys):
    from poseidon_tpu_torch import config
    from poseidon_tpu_torch.runtime import tuned_plan as tp

    measured = []
    real = conv_tune._measure_candidates

    def spy(cands, x, *a, **k):
        measured.append(tuple(x.shape))
        return real(cands, x, *a, **k)

    monkeypatch.setattr(conv_tune, "_measure_candidates", spy)
    saved = config.compile_cache_config().cache_dir
    config.set_compile_cache_config(cache_dir=str(tmp_path))
    conv_tune.clear_memo()
    try:
        for layout in ("NCHW", "NHWC"):
            net = Net(load_net_from_string(TUNE_NET), "TEST", device="cpu",
                      conv_layout=layout, conv_strategy="auto")
            plan = net.conv_strategy_plan()
            assert set(plan) == {"conv1", "convA", "convB", "convG"}
            assert plan["convG"] == "direct"
            assert plan["convA"] == plan["convB"]
            assert all(v in conv_tune.CANDIDATES for v in plan.values())
            net.init(torch.Generator().manual_seed(0))
            y = net.forward({"data": torch.randn(2, 3, 16, 16)})["convB"]
            assert torch.isfinite(y).all()
        # conv1 and the convA/convB geometry, once a layout; convG alone
        assert len(measured) == 4
        out = capsys.readouterr().out
        # a line a conv layer and layout; a memo hit names the layer that
        # measured its geometry (JAX's describe)
        assert out.count("[conv_strategy] ") == 8
        assert "[conv_strategy] convA: -> " in out and "[memo]" in out
        assert "[conv_strategy] convG: -> direct [only-candidate]" in out
        files = sorted(p.name for p in (tmp_path / "tuned").iterdir())
        assert len(files) == 4 and all(
            n.startswith("conv_strategy-") for n in files)
        # no store configured and no plan loaded: nothing persists
        config.set_compile_cache_config(cache_dir="")
        assert tp.active_store_dir() == ""
    finally:
        config.set_compile_cache_config(cache_dir=saved)
        conv_tune.clear_memo()
