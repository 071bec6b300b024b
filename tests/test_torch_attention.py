"""The port's attention ops on the CPU against the JAX package: the dense
``attention`` and the block accumulator, the flash forward's and backward's
plain versions against the Pallas ``_flash_fwd`` and ``_flash_bwd`` in
interpret mode, an f64 ``gradcheck`` of the Function, ``pick_block``, and
the routing rules (the CPU path launches nothing; the CUDA entries refuse
CPU tensors).

Tolerances: f32 rtol 1e-5, atol 1e-6 against the JAX functions (both sides
compute in f32; the dense plain version sums the softmax in one pass where
the Pallas kernel folds blocks, so last bits differ); bf16 outputs within
one bf16 rounding step (rtol 2^-7) of the JAX kernel, lse as f32. The
backward's dq, dk, dv likewise (f32 rtol 1e-5, atol 1e-6; bf16 rtol 2^-7,
atol 1e-5).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import pallas_kernels as jax_pk
from poseidon_tpu_torch.ops import attention as port_attention
from poseidon_tpu_torch.ops import flash as port_flash

# the module, not the function that poseidon_tpu.ops re-exports by its name
jax_attention = importlib.import_module("poseidon_tpu.ops.attention")

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2 ** -7
# the backward: the plain version sums each gradient over all rows in one
# product, the Pallas kernels fold tiles into their accumulators
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6


def _qkv(shape, seed=0, scale=0.5):
    rs = np.random.RandomState(seed)
    return tuple((rs.randn(*shape) * scale).astype(np.float32)
                 for _ in range(3))


def _jax_flash(q, k, v, causal, block, mode=None, dtype=jnp.float32):
    out, lse = jax_pk._flash_fwd(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        q.shape[-1] ** -0.5, causal, block, block, True, mode=mode)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _port_flash(q, k, v, causal, mode=None, dtype=torch.float32):
    out, lse = port_flash.flash_attention_fwd(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), causal, None, mode)
    assert out.dtype == dtype and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("shape,block", [((2, 3, 48, 16), 16),
                                         ((1, 2, 128, 32), 32),
                                         ((1, 2, 128, 32), 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas_interpret(shape, block, causal):
    q, k, v = _qkv(shape, seed=block)
    want_o, want_l = _jax_flash(q, k, v, causal, block)
    got_o, got_l = _port_flash(q, k, v, causal)
    assert got_o.shape == shape and got_l.shape == shape[:3]
    np.testing.assert_allclose(got_o, want_o, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [1, 0, -1])
def test_flash_plain_chunk_modes_match_pallas_interpret(mode):
    """Ring-chunk masking: +1 all live, 0 the in-chunk triangle, -1 all
    masked (every score -1e30: out is the mean of V, lse -1e30 + log S)."""
    q, k, v = _qkv((2, 3, 48, 16), seed=3)
    want_o, want_l = _jax_flash(q, k, v, True, 16, mode=jnp.int32(mode))
    got_o, got_l = _port_flash(q, k, v, True, mode=mode)
    np.testing.assert_allclose(got_o, want_o, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
    if mode == -1:
        np.testing.assert_allclose(got_o, np.broadcast_to(
            v.mean(axis=2, keepdims=True), v.shape), rtol=1e-5, atol=1e-6)
        assert np.all(got_l == np.float32(-1e30))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_bf16_matches_pallas_interpret(causal):
    q, k, v = _qkv((1, 2, 128, 32), seed=5)
    want_o, want_l = _jax_flash(q, k, v, causal, 32, dtype=jnp.bfloat16)
    got_o, got_l = _port_flash(q, k, v, causal, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_o, want_o, rtol=BF16_RTOL, atol=1e-5)
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax(causal):
    q, k, v = _qkv((2, 3, 20, 8), seed=7)
    want = np.asarray(jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = port_attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_attention_causal_cross_length_mask_matches_jax():
    """q shorter than k: the mask is tril(k=sk-sq), the last query row
    sees every key."""
    rs = np.random.RandomState(8)
    q = rs.randn(1, 2, 4, 8).astype(np.float32)
    k = rs.randn(1, 2, 10, 8).astype(np.float32)
    v = rs.randn(1, 2, 10, 8).astype(np.float32)
    want = np.asarray(jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = port_attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_block_accumulator_matches_jax():
    """Fold K/V in three blocks, then finalize: the JAX recurrence and the
    port's agree, and both equal dense attention."""
    q, k, v = _qkv((2, 2, 12, 8), seed=9)
    scale = 8 ** -0.5
    js = jax_attention.init_block_acc(2, 2, 12, 8)
    ps = port_attention.init_block_acc(2, 2, 12, 8)
    for lo in (0, 4, 8):
        sl = slice(lo, lo + 4)
        js = jax_attention.block_attend(js, jnp.asarray(q),
                                        jnp.asarray(k[:, :, sl]),
                                        jnp.asarray(v[:, :, sl]), scale)
        ps = port_attention.block_attend(ps, torch.from_numpy(q),
                                         torch.from_numpy(k[:, :, sl]),
                                         torch.from_numpy(v[:, :, sl]), scale)
    for name in ("acc", "m", "l"):
        np.testing.assert_allclose(getattr(ps, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    got = port_attention.finalize_block_acc(ps, torch.float32).numpy()
    want = np.asarray(jax_attention.finalize_block_acc(js, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    dense = port_attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)


def test_finalize_keeps_empty_rows_finite():
    st = port_attention.init_block_acc(1, 1, 3, 4)
    out = port_attention.finalize_block_acc(st, torch.float32)
    assert torch.equal(out, torch.zeros(1, 1, 3, 4))
    assert port_attention.NEG_INF == jax_attention.NEG_INF


def test_pick_block_equals_jax():
    for s in range(1, 1101):
        assert port_flash.pick_block(s) == jax_pk.pick_block(s), s


def test_cpu_routing_launches_nothing_and_routes_like_jax():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 48, 16), seed=11))
    before = dict(port_flash.LAUNCHES)
    flashed = port_flash.maybe_flash_attention(q, k, v, causal=True)
    plain, _ = port_flash.flash_attention_fwd_plain(q, k, v, True)
    assert torch.equal(flashed, plain)              # 48 tiles by 16: flash
    q7, k7, v7 = (t[:, :, :7] for t in (q, k, v))   # no tile: dense
    dense = port_flash.maybe_flash_attention(q7, k7, v7, causal=True)
    assert torch.equal(dense, port_attention.attention(q7, k7, v7,
                                                       causal=True))
    cross = port_flash.maybe_flash_attention(q[:, :, :16], k, v)
    assert torch.equal(cross, port_attention.attention(q[:, :, :16], k, v))
    assert port_flash.LAUNCHES == before


def test_cuda_entry_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 16, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        port_flash.flash_fwd_cuda(q, k, v, True)


def _jax_flash_bwd(q, k, v, g, causal, block, mode=None, delta=None,
                   dtype=jnp.float32):
    """(out, lse) of the Pallas forward and (dq, dk, dv) of the Pallas
    ``_flash_bwd``, both in interpret mode, as numpy."""
    qj, kj, vj, gj = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    jmode = None if mode is None else jnp.int32(mode)
    out, lse = jax_pk._flash_fwd(qj, kj, vj, scale, causal, block, block,
                                 True, mode=jmode)
    grads = jax_pk._flash_bwd(
        qj, kj, vj, out, lse, gj, scale, causal, block, block, True,
        mode=jmode, delta=None if delta is None else jnp.asarray(delta))
    return ((np.asarray(out.astype(jnp.float32)), np.asarray(lse))
            + tuple(np.asarray(t.astype(jnp.float32)) for t in grads))


def _port_flash_bwd(q, k, v, out, lse, g, causal, mode=None, delta=None,
                    dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.array(a)).to(dtype)  # noqa: E731
    grads = port_flash.flash_attention_bwd(
        t(q), t(k), t(v), t(out), torch.from_numpy(np.array(lse)), t(g),
        causal, None,
        mode, None if delta is None else torch.from_numpy(delta))
    assert all(x.dtype == dtype for x in grads)
    return tuple(x.float().numpy() for x in grads)


@pytest.mark.parametrize("shape,block", [((2, 3, 48, 16), 16),
                                         ((1, 2, 128, 32), 32),
                                         ((1, 2, 128, 32), 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_pallas_interpret(shape, block, causal):
    """dq, dk, dv of the plain backward (dense, from the saved lse) against
    the Pallas dQ and dK/dV kernels in interpret mode, on the Pallas
    forward's out and lse."""
    q, k, v = _qkv(shape, seed=20 + block)
    g = np.random.RandomState(block).randn(*shape).astype(np.float32)
    out, lse, *want = _jax_flash_bwd(q, k, v, g, causal, block)
    got = _port_flash_bwd(q, k, v, out, lse, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == shape
        np.testing.assert_allclose(a, b, rtol=BWD_RTOL, atol=BWD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", [1, 0, -1])
def test_flash_bwd_plain_chunk_modes_match_pallas_interpret(mode):
    """Ring-chunk backward with ``delta`` passed in (the ring's global
    rowsum). Mode -1: every score is -1e30 and so is the saved lse, so p is
    exactly 1 for every key (not the forward's 1/S)."""
    shape = (2, 3, 48, 16)
    q, k, v = _qkv(shape, seed=30)
    rs = np.random.RandomState(31)
    g = rs.randn(*shape).astype(np.float32)
    delta = (rs.randn(*shape[:3]) * 0.1).astype(np.float32)
    out, lse, *want = _jax_flash_bwd(q, k, v, g, True, 16, mode=mode,
                                     delta=delta)
    got = _port_flash_bwd(q, k, v, out, lse, g, True, mode=mode, delta=delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=BWD_RTOL, atol=BWD_ATOL,
                                   err_msg=name)
    if mode == -1:
        # p == 1: dv[j] = sum_i dO[i], summed over all 48 query rows
        np.testing.assert_allclose(got[2], np.broadcast_to(
            g.sum(axis=2, keepdims=True), g.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_bf16_matches_pallas_interpret(causal):
    shape = (1, 2, 128, 32)
    q, k, v = _qkv(shape, seed=40)
    g = np.random.RandomState(41).randn(*shape).astype(np.float32)
    out, lse, *want = _jax_flash_bwd(q, k, v, g, causal, 32,
                                     dtype=jnp.bfloat16)
    got = _port_flash_bwd(q, k, v, out, lse, g, causal,
                          dtype=torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_gradcheck_f64(causal):
    """The Function's backward (the plain versions on the CPU, computed in
    f64 for f64 input) against finite differences of its forward."""
    rs = np.random.RandomState(50)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 4)).requires_grad_(True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: port_flash.flash_attention(a, b, c, causal),
        (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_flash_function_backward_routes_to_plain_on_cpu():
    """Autograd through ``flash_attention`` on CPU tensors equals the plain
    backward on the saved residuals and launches no kernel."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv((1, 2, 16, 8), seed=51))
    g = torch.from_numpy(np.random.RandomState(52).randn(1, 2, 16, 8)
                         .astype(np.float32))
    before = dict(port_flash.LAUNCHES)
    out = port_flash.flash_attention(q, k, v, True)
    out.backward(g)
    _, lse = port_flash.flash_attention_fwd_plain(q, k, v, True)
    want = port_flash.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), lse, g, True)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)
    assert port_flash.LAUNCHES == before


def test_cuda_bwd_entry_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 16, 8)))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port_flash.flash_bwd_cuda(q, k, v, q, lse, lse, True)
