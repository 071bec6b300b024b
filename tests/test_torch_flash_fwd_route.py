"""The numeric route of the tensor-core flash forward (``csrc/flash_fwd.cu``)
on the CPU, against the Pallas ``_flash_fwd`` in interpret mode.

The CUDA kernel runs only on the card. This file pins the rounding it
applies to its operands, with a test-local torch emulation of its
arithmetic: key tiles of the kernel's height (32 rows in f32, 64 in bf16
for D <= 64), the online softmax's running max m, row sum l and rescale
factor alpha in f32, out = acc / l and lse = m + log l:

- f32: both products (S = Q K^T and P V) as 3xTF32. Each operand is split
  into a TF32 ``big = rna(x)``, rounded as ``cvt.rna.tf32`` rounds (on the
  int32 view: ``(bits + 0x1000) & ~0x1FFF``, ties away from zero), and the
  remainder ``small = x - big`` as the tensor core reads it, truncated to
  TF32 (``bits & ~0x1FFF``); three products are summed in f32, small.big +
  big.small first, then big.big.
- bf16: q, k, v are bf16 and S takes them as they are; P, f32 in the
  accumulators, enters P V as a bf16 big part and a bf16 small remainder.

The emulation pins the rounding of the operands, not the order of the
tensor core's internal adder: the card check (``chip_smoke.py``,
``tests/test_torch_gpu.py``) stays the judge. Tolerances are
``chip_smoke.py``'s ``FLASH_TOL``: out at f32 rtol 1e-4, atol 1e-5 or bf16
rtol 2^-7, atol 1e-5; lse, f32 for both dtypes, at the f32 pair. Two tests
show why the route takes more than one pass: a single TF32 pass misses the
f32 pair, and P rounded once to bf16 misses the bf16 pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import pallas_kernels as jax_pk

NEG_INF = -1e30
F32_TOL = (1e-4, 1e-5)
BF16_TOL = (2 ** -7, 1e-5)


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
    """The kernel's mask of (query, key) positions: live, else NEG_INF."""
    if not causal:
        return torch.ones(len(rows), len(cols), dtype=torch.bool)
    lower = rows[:, None] >= cols[None, :]
    if mode is None or mode == 0:
        return lower
    return torch.full_like(lower, mode > 0)


def _emulate(q, k, v, causal, mode, first, second, tile):
    """(out, lse) as the kernel computes them: key tiles of ``tile`` rows
    streamed past every query row, ``first`` taking S = Q K^T and
    ``second`` P V, the online softmax in f32. Inputs f32 (B, H, S, D)
    holding the kernel's operand values; outputs f32. Key tiles that the
    kernel skips above the causal diagonal add exactly nothing here (p = 0,
    alpha = 1), so every tile is taken."""
    s_len, d = q.shape[-2:]
    scale = d ** -0.5
    pos = torch.arange(s_len)
    m = torch.full(q.shape[:-1], NEG_INF)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros_like(q)
    for j0 in range(0, s_len, tile):
        j = slice(j0, j0 + tile)
        s = first(q, k[..., j, :].transpose(-1, -2)) * scale
        s = torch.where(_live(pos, pos[j], causal, mode), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + second(p, v[..., j, :])
        m = m_new
    lsafe = torch.where(l == 0, 1.0, l)
    return acc / lsafe[..., None], m + torch.log(lsafe)


def _pallas(shape, causal, mode, dtype, seed):
    """The inputs as the kernel sees them (rounded to ``dtype``) and out and
    lse of the Pallas forward in interpret mode, all as f32 torch
    tensors."""
    rs = np.random.RandomState(seed)
    qj, kj, vj = (jnp.asarray(rs.randn(*shape).astype(np.float32), dtype)
                  for _ in range(3))
    s_len = shape[-2]
    block = min(64, s_len) if s_len % 64 == 0 else s_len
    jmode = None if mode is None else jnp.int32(mode)
    out, lse = jax_pk._flash_fwd(qj, kj, vj, shape[-1] ** -0.5, causal,
                                 block, block, True, mode=jmode)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(a).astype(jnp.float32)))
    return (t(qj), t(kj), t(vj)), t(out), t(lse)


def _violation(got, want, tol, dtype):
    """The largest amount by which ``got`` misses ``want`` (each rounded to
    ``dtype`` first, as the kernel stores) beyond rtol and atol: <= 0
    holds."""
    rtol, atol = tol
    a = got.to(dtype).float()
    b = want.to(dtype).float()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


CASES = [((1, 2, 128, 64), True, None), ((1, 2, 128, 64), False, None),
         ((1, 2, 96, 32), True, None), ((1, 2, 64, 64), True, 1),
         ((1, 2, 64, 64), True, 0), ((1, 2, 64, 64), True, -1)]


def _worst(got, out, lse, out_tol, dtype):
    """The larger violation of out (at ``out_tol`` in ``dtype``) and lse
    (f32 pair)."""
    return max(_violation(got[0], out, out_tol, dtype),
               _violation(got[1], lse, F32_TOL, torch.float32))


def test_tf32_split_carries_the_value():
    """big is x rounded to nearest TF32, ties away from zero; big + small
    (small read truncated) is within 2^-21 |x| of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4],
                     dtype=torch.float32)
    assert torch.equal(_tf32(x), torch.tensor([1 + ulp, -(1 + ulp), 1.0]))
    y = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32))
    big = _tf32(y)
    err = (big + _tf32_truncated(y - big) - y).abs()
    assert bool((err <= 2.0 ** -21 * y.abs()).all())
    assert float(err.max()) > 0   # the truncated remainder is not exact


@pytest.mark.parametrize("shape,causal,mode", CASES)
def test_f32_3xtf32_route_matches_pallas_interpret(shape, causal, mode):
    ins, out, lse = _pallas(shape, causal, mode, jnp.float32, 60)
    got = _emulate(*ins, causal, mode, _mm_3xtf32, _mm_3xtf32, tile=32)
    assert got[0].shape == shape and got[1].shape == shape[:3]
    assert _violation(got[0], out, F32_TOL, torch.float32) <= 0, "out"
    assert _violation(got[1], lse, F32_TOL, torch.float32) <= 0, "lse"


@pytest.mark.parametrize("shape,causal,mode", CASES)
def test_bf16_split_route_matches_pallas_interpret(shape, causal, mode):
    ins, out, lse = _pallas(shape, causal, mode, jnp.bfloat16, 70)
    got = _emulate(*ins, causal, mode, torch.matmul, _mm_bf16_split, tile=64)
    assert _violation(got[0], out, BF16_TOL, torch.bfloat16) <= 0, "out"
    assert _violation(got[1], lse, F32_TOL, torch.float32) <= 0, "lse"


def test_single_tf32_pass_misses_the_f32_pair():
    """One TF32 pass per product (what the f32 policy forbids) misses rtol
    1e-4, atol 1e-5 on the same inputs that three passes meet."""
    ins, out, lse = _pallas((1, 2, 128, 64), True, None, jnp.float32, 60)
    one = _emulate(*ins, True, None, _mm_1xtf32, _mm_1xtf32, tile=32)
    three = _emulate(*ins, True, None, _mm_3xtf32, _mm_3xtf32, tile=32)
    assert _worst(one, out, lse, F32_TOL, torch.float32) > 0
    assert _worst(three, out, lse, F32_TOL, torch.float32) <= 0


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_rounded_once_misses_the_bf16_pair(causal):
    """P rounded once to bf16 (FlashAttention-2's route, one MMA) misses
    out's rtol 2^-7, atol 1e-5 where P as a bf16 big part and remainder (two
    MMAs, the kernel's route) meets it: the reference multiplies P by V in
    f32, and an output that is a small difference of weighted values keeps
    P's rounding at full size."""
    ins, out, lse = _pallas((1, 4, 256, 64), causal, None, jnp.bfloat16, 80)
    once = _emulate(*ins, causal, None, torch.matmul, _mm_bf16_once, tile=64)
    split = _emulate(*ins, causal, None, torch.matmul, _mm_bf16_split,
                     tile=64)
    assert _violation(once[0], out, BF16_TOL, torch.bfloat16) > 0
    assert _worst(split, out, lse, BF16_TOL, torch.bfloat16) <= 0
