"""The port's attention ops on the CPU against the JAX package: the dense
``attention`` and the block accumulator, the flash forward's plain version
against the Pallas ``_flash_fwd`` in interpret mode, ``pick_block``, and
the routing rules (the CPU path launches nothing; the CUDA entry refuses a
CPU tensor).

Tolerances: f32 rtol 1e-5, atol 1e-6 against the JAX functions (both sides
compute in f32; the dense plain version sums the softmax in one pass where
the Pallas kernel folds blocks, so last bits differ); bf16 outputs within
one bf16 rounding step (rtol 2^-7) of the JAX kernel, lse as f32.
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


def test_flash_backward_raises_naming_the_training_slice():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv((1, 2, 16, 8)))
    out = port_flash.flash_attention(q, k, v, True)
    with pytest.raises(NotImplementedError, match="LM-training slice"):
        out.sum().backward()
