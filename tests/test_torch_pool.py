"""The port's pooling (ops/pool.py) against the JAX package's.

Forward and backward of MAX and AVE pooling, through the autograd Function
the POOLING layer calls (its backward is the plain taps version on the
CPU), held against ``jax.vjp`` of the JAX ``max_pool``/``ave_pool`` with
the backward forced to each JAX arm by ``POSEIDON_POOL_BWD``:

- ``taps`` (the JAX package's CPU arm, the formulation the port's plain
  version mirrors): bitwise;
- ``pallas`` (the TPU kernel ``pool_bwd_plane`` in interpret mode) and
  ``sas`` (select-and-scatter autodiff): rtol 1e-5, atol 1e-6 — they add a
  position's contributions from overlapping windows in another order.

MAX forward outputs are bitwise; AVE forward outputs are held at rtol
1e-6, atol 1e-7: XLA may add a window's terms in another order (it does
for 2x2 stride-2 windows on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import nn as JNN
from poseidon_tpu_torch.ops import pool as port_pool

GEOMS = [
    ((3, 3), (2, 2), (0, 0), 13),   # AlexNet's 3x3 stride 2
    ((3, 3), (2, 2), (1, 1), 8),    # padded + ceil-mode clamp
    ((2, 2), (2, 2), (0, 0), 8),    # LeNet non-overlapping
    ((5, 5), (3, 3), (2, 2), 11),   # larger window, uneven coverage
    ((3, 3), (1, 1), (1, 1), 7),    # stride 1 (the WITHIN_CHANNEL LRN path)
    ((2, 2), (2, 2), (1, 1), 13),   # pad 1, the last window clamped
]


def _inputs(shape, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(dtype)


def _port(method, x, g, k, s, p):
    fn = port_pool.max_pool if method == "max" else port_pool.ave_pool
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt, k, s, p)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy()


def _jax(method, x, g, k, s, p):
    fn = JNN.max_pool if method == "max" else JNN.ave_pool
    y, vjp = jax.vjp(lambda x_: fn(x_, k, s, p), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("method", ["max", "ave"])
@pytest.mark.parametrize("geom", GEOMS)
def test_pool_matches_jax_every_backward_arm(method, geom, monkeypatch):
    k, s, p, h = geom
    x = _inputs((2, 3, h, h), seed=h * 10 + k[0])
    oh = port_pool.pool_out_size(h, k[0], s[0], p[0])
    g = _inputs((2, 3, oh, oh), seed=h * 10 + k[0] + 1)
    y, dx = _port(method, x, g, k, s, p)
    for arm in ("taps", "pallas", "sas"):
        monkeypatch.setenv("POSEIDON_POOL_BWD", arm)
        y_ref, dx_ref = _jax(method, x, g, k, s, p)
        if method == "max":
            np.testing.assert_array_equal(y, y_ref)
        else:
            np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-7)
        if arm == "taps":
            np.testing.assert_array_equal(dx, dx_ref, err_msg=arm)
        else:
            np.testing.assert_allclose(dx, dx_ref, rtol=1e-5, atol=1e-6,
                                       err_msg=arm)


@pytest.mark.parametrize("arm", ["taps", "pallas", "sas"])
def test_max_pool_ties_first_max_wins(arm, monkeypatch):
    """A constant input ties in every window: Caffe routes each window's
    cotangent to its FIRST tap (strict `>` over row-major taps); any other
    argmax rule shows up bitwise."""
    x = np.full((1, 3, 8, 8), 0.25, np.float32)
    g = _inputs((1, 3, 5, 5), seed=5)
    _, dx = _port("max", x, g, (3, 3), (2, 2), (1, 1))
    monkeypatch.setenv("POSEIDON_POOL_BWD", arm)
    _, dx_ref = _jax("max", x, g, (3, 3), (2, 2), (1, 1))
    np.testing.assert_array_equal(dx, dx_ref)


def test_alexnet_pools_narrow_channels(monkeypatch):
    """AlexNet's pool1/pool2/pool5 geometry (3x3 stride 2 over 55, 27, 13)
    on 4 channels, against the JAX taps arm: bitwise."""
    monkeypatch.setenv("POSEIDON_POOL_BWD", "taps")
    for i, h in enumerate((55, 27, 13)):
        x = _inputs((2, 4, h, h), seed=40 + i)
        oh = port_pool.pool_out_size(h, 3, 2, 0)
        g = _inputs((2, 4, oh, oh), seed=50 + i)
        y, dx = _port("max", x, g, (3, 3), (2, 2), (0, 0))
        y_ref, dx_ref = _jax("max", x, g, (3, 3), (2, 2), (0, 0))
        np.testing.assert_array_equal(y, y_ref)
        np.testing.assert_array_equal(dx, dx_ref)


@pytest.mark.parametrize("method", ["max", "ave"])
def test_pool_bwd_bf16_matches_jax_taps(method, monkeypatch):
    """bf16 x and g, the argmax and the sums in f32, dx rounded to bf16 on
    both sides: bitwise against the taps arm."""
    monkeypatch.setenv("POSEIDON_POOL_BWD", "taps")
    x = _inputs((2, 4, 9, 9), seed=60)
    g = _inputs((2, 4, 4, 4), seed=61)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got = port_pool.pool_bwd_plain(xb, gb, (3, 3), (2, 2), (0, 0), method)
    assert got.dtype == torch.bfloat16
    fn = JNN.max_pool if method == "max" else JNN.ave_pool
    _, vjp = jax.vjp(lambda x_: fn(x_, (3, 3), (2, 2), (0, 0)),
                     jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    ref = vjp(jnp.asarray(gb.float().numpy(), jnp.bfloat16))[0]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("method", ["max", "ave"])
def test_pool_function_gradcheck_f64(method):
    x = torch.from_numpy(_inputs((1, 2, 7, 7), seed=70).astype(np.float64))
    x.requires_grad_(True)
    fn = port_pool.max_pool if method == "max" else port_pool.ave_pool
    assert torch.autograd.gradcheck(
        lambda t: fn(t, (3, 3), (2, 2), (1, 1)), (x,), eps=1e-6, atol=1e-7)


def test_pool_on_cpu_launches_nothing_and_refuses_cuda_entry():
    x = torch.from_numpy(_inputs((1, 2, 9, 9), seed=80)).requires_grad_(True)
    before = dict(port_pool.LAUNCHES)
    port_pool.max_pool(x, (3, 3), (2, 2), (0, 0)).sum().backward()
    assert port_pool.LAUNCHES == before
    g = torch.ones(1, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        port_pool.pool_bwd_cuda(x.detach(), g, (3, 3), (2, 2), (0, 0), "max")


def test_reference_functions_match_on_cpu():
    """The plain-backward references chip_smoke.py swaps in on the card
    compute the same forward and backward as the layer's Functions."""
    x = torch.from_numpy(_inputs((2, 3, 11, 11), seed=90))
    for fn, ref in ((port_pool.max_pool, port_pool.max_pool_reference),
                    (port_pool.ave_pool, port_pool.ave_pool_reference)):
        a = x.clone().requires_grad_(True)
        b = x.clone().requires_grad_(True)
        ya, yb = fn(a, (3, 3), (2, 2), (1, 1)), ref(b, (3, 3), (2, 2), (1, 1))
        assert torch.equal(ya, yb)
        ya.sum().backward()
        yb.sum().backward()
        assert torch.equal(a.grad, b.grad)
