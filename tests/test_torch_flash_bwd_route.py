"""The numeric route of the tensor-core flash backward (``csrc/flash_bwd.cu``)
on the CPU, against the Pallas ``_flash_bwd`` in interpret mode.

The CUDA kernels run only on the card. This file pins the rounding they
apply to their operands, with a test-local torch emulation of their
arithmetic at their tile heights (64 own rows; 32 streamed rows in f32, 64
in bf16 for D <= 64) and f32 accumulation:

- f32: every S x S x D product as 3xTF32. Each operand is split into a TF32
  ``big = rna(x)``, rounded as ``cvt.rna.tf32`` rounds (on the int32 view:
  ``(bits + 0x1000) & ~0x1FFF``, ties away from zero), and the remainder
  ``small = x - big`` as the tensor core reads it, truncated to TF32
  (``bits & ~0x1FFF``); three products are summed in f32, small.big +
  big.small first, then big.big.
- bf16: q, k, v, dO are bf16 and the first products (s, dp) take them as
  they are; p and ds, f32 in the accumulators, are split into a bf16 big
  part and a bf16 small remainder for the second products (dv, dk, dq).

The emulation pins the rounding of the operands, not the order of the
tensor core's internal adder: the card check (``chip_smoke.py``,
``tests/test_torch_gpu.py``) stays the judge. Tolerances: f32 rtol 1e-4,
atol 1e-5 and bf16 rtol 2^-7, atol 1e-3, the kernels' own pairs on the card.
Two tests show why the route takes more than one pass: a single TF32 pass,
and p and ds rounded once to bf16, each miss their pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import pallas_kernels as jax_pk
from poseidon_tpu_torch.ops import flash as port_flash

NEG_INF = -1e30
F32_TOL = (1e-4, 1e-5)
BF16_TOL = (2 ** -7, 1e-3)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from
    zero, on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """A TF32 operand as the tensor core reads an f32 register: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mm_bf16_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (f32, from an accumulator) as a bf16 big part and a bf16 small
    remainder, times b (already bf16): two bf16 products."""
    big = _bf16(a)
    return _bf16(a - big) @ b + big @ b


def _mm_bf16_once(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bf16(a) @ b


def _live(rows, cols, causal, mode):
    """The kernels' mask of (query, key) positions: live, else NEG_INF."""
    if not causal:
        return torch.ones(len(rows), len(cols), dtype=torch.bool)
    lower = rows[:, None] >= cols[None, :]
    if mode is None or mode == 0:
        return lower
    return torch.full_like(lower, mode > 0)


def _scores(q, k, rows, cols, scale, causal, mode, first):
    s = first(q, k.transpose(-1, -2)) * scale
    return torch.where(_live(rows, cols, causal, mode), s, NEG_INF)


def _emulate(q, k, v, g, lse, delta, causal, mode, first, second,
             stream=32):
    """(dq, dk, dv) as the kernels compute them: K2 streams key tiles past a
    query tile, K3 query tiles past a key tile; ``first`` takes the s and dp
    products, ``second`` the dq, dk, dv products. Inputs f32 (B, H, S, D)
    holding the kernel's operand values; outputs f32. ``stream``: the
    streamed tile's rows."""
    s_len, d = q.shape[-2:]
    scale = d ** -0.5
    pos = torch.arange(s_len)
    dq = torch.zeros_like(q)
    for j0 in range(0, s_len, stream):
        j = slice(j0, j0 + stream)
        s = _scores(q, k[..., j, :], pos, pos[j], scale, causal, mode, first)
        p = torch.exp(s - lse[..., None])
        dp = first(g, v[..., j, :].transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + second(ds, k[..., j, :])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i0 in range(0, s_len, stream):
        i = slice(i0, i0 + stream)
        # K3 computes s^T = k q^T directly: the same products, transposed
        st = _scores(k, q[..., i, :], pos, pos[i], scale, False, None,
                     first).transpose(-1, -2)
        st = torch.where(_live(pos[i], pos, causal, mode), st, NEG_INF)
        p = torch.exp(st - lse[..., i, None])
        dp = first(g[..., i, :], v.transpose(-1, -2))
        ds = p * (dp - delta[..., i, None]) * scale
        dv = dv + second(p.transpose(-1, -2), g[..., i, :])
        dk = dk + second(ds.transpose(-1, -2), q[..., i, :])
    return dq, dk, dv


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*shape).astype(np.float32) for _ in range(4))


def _pallas(q, k, v, g, causal, mode, delta, dtype):
    """out and lse of the Pallas forward, dq, dk, dv of the Pallas backward
    (interpret mode), the inputs as the kernels see them (rounded to
    ``dtype``) and the delta the port passes: all as f32 torch tensors."""
    qj, kj, vj, gj = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    s_len = q.shape[-2]
    block = min(64, s_len) if s_len % 64 == 0 else s_len
    scale = q.shape[-1] ** -0.5
    jmode = None if mode is None else jnp.int32(mode)
    out, lse = jax_pk._flash_fwd(qj, kj, vj, scale, causal, block, block,
                                 True, mode=jmode)
    grads = jax_pk._flash_bwd(
        qj, kj, vj, out, lse, gj, scale, causal, block, block, True,
        mode=jmode, delta=None if delta is None else jnp.asarray(delta))
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(a).astype(jnp.float32)))
    if delta is None:
        # the port's flash_delta on the forward's out in the input dtype
        delta = port_flash.flash_delta(t(gj), t(out))
    else:
        delta = torch.from_numpy(delta)
    return ((t(qj), t(kj), t(vj), t(gj)), t(lse), delta,
            tuple(t(x) for x in grads))


def _violation(got, want, tol, dtype):
    """The largest amount by which ``got`` misses ``want`` (each rounded to
    ``dtype`` first, as the kernels store) beyond rtol and atol: <= 0 holds."""
    rtol, atol = tol
    a = got.to(dtype).float()
    b = want.to(dtype).float()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


CASES = [((1, 2, 128, 64), True, None), ((1, 2, 128, 64), False, None),
         ((1, 2, 100, 32), True, None), ((1, 2, 64, 64), True, 1),
         ((1, 2, 64, 64), True, 0), ((1, 2, 64, 64), True, -1)]


def _case(shape, causal, mode, dtype, seed):
    q, k, v, g = _inputs(shape, seed)
    delta = None
    if mode is not None:   # the ring passes its own delta in
        delta = (np.random.RandomState(seed + 1).randn(*shape[:3]) * 0.1
                 ).astype(np.float32)
    return _pallas(q, k, v, g, causal, mode, delta, dtype)


def test_tf32_rounding_is_cvt_rna_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, -0.0])
    assert torch.equal(_tf32(x), want)
    big = _tf32(x)
    # the small part carries what big dropped, to 11 more bits
    assert torch.equal(big + _tf32_truncated(x - big), x)
    assert torch.equal(_tf32_truncated(x[2:4]), torch.tensor([one, one]))


@pytest.mark.parametrize("shape,causal,mode", CASES)
def test_f32_3xtf32_route_matches_pallas_interpret(shape, causal, mode):
    ins, lse, delta, want = _case(shape, causal, mode, jnp.float32, 60)
    got = _emulate(*ins, lse, delta, causal, mode, _mm_3xtf32, _mm_3xtf32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == shape
        assert _violation(a, b, F32_TOL, torch.float32) <= 0, name


@pytest.mark.parametrize("shape,causal,mode", CASES)
def test_bf16_split_route_matches_pallas_interpret(shape, causal, mode):
    ins, lse, delta, want = _case(shape, causal, mode, jnp.bfloat16, 70)
    got = _emulate(*ins, lse, delta, causal, mode, torch.matmul,
                   _mm_bf16_split, stream=64)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _violation(a, b, BF16_TOL, torch.bfloat16) <= 0, name


def test_single_tf32_pass_misses_the_f32_pair():
    """One TF32 pass per product (what the f32 policy forbids) misses rtol
    1e-4, atol 1e-5 on the same inputs that three passes meet."""
    ins, lse, delta, want = _case((1, 2, 128, 64), True, None, jnp.float32,
                                  60)
    got = _emulate(*ins, lse, delta, True, None, _mm_1xtf32, _mm_1xtf32)
    worst = max(_violation(a, b, F32_TOL, torch.float32)
                for a, b in zip(got, want))
    assert worst > 0


def test_bf16_rounded_once_misses_the_bf16_pair():
    """p and ds rounded once to bf16 (FlashAttention-2's route) miss rtol
    2^-7, atol 1e-3 on a causal case that the split route meets."""
    shape = (1, 4, 256, 64)
    ins, lse, delta, want = _case(shape, True, None, jnp.bfloat16, 80)
    once = _emulate(*ins, lse, delta, True, None, torch.matmul,
                    _mm_bf16_once, stream=64)
    split = _emulate(*ins, lse, delta, True, None, torch.matmul,
                     _mm_bf16_split, stream=64)
    assert max(_violation(a, b, BF16_TOL, torch.bfloat16)
               for a, b in zip(once, want)) > 0
    assert max(_violation(a, b, BF16_TOL, torch.bfloat16)
               for a, b in zip(split, want)) <= 0
