"""Scaled dot-product attention with an online-softmax block accumulator
(the port of ``poseidon_tpu/ops/attention.py``).

``attention`` is the dense reference: scores ``dot * scale`` from q and k
in the policy's ``compute_dtype``, taken to f32, the finite ``NEG_INF``
causal mask ``tril(k=sk-sq)``, f32 softmax, and the probability-weighted
sum of V with both operands in ``compute_dtype``, returned in q's dtype.
Under the default f32 policy every product runs in float32 with TF32 off
(the JAX package's ``Precision.HIGHEST``, ``numeric.apply_policy``); under
bf16 the operands are bfloat16 and the softmax statistics stay f32, as in
the JAX package.

The block accumulator is the flash/ring-attention recurrence: for key/value
blocks arriving one at a time, keep (acc, m, l) with

    m'   = max(m, rowmax(S))
    p    = exp(S - m')
    l'   = l * exp(m - m') + rowsum(p)
    acc' = acc * exp(m - m') + p @ V

and finalize with acc / l (an all-masked row, l == 0, divides by 1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..numeric import policy

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention. q, k, v: (B, H, S, D) -> (B, H, Sq, D)."""
    cd = policy().compute_dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (torch.matmul(q.to(cd), k.to(cd).transpose(-1, -2)) * scale).float()
    if bias is not None:
        s = s + bias
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w.to(cd), v.to(cd)).to(q.dtype)


class BlockAcc(NamedTuple):
    acc: torch.Tensor  # (B, H, Sq, D) f32
    m: torch.Tensor    # (B, H, Sq)    f32 running rowmax
    l: torch.Tensor    # (B, H, Sq)    f32 running denominator


def init_block_acc(batch: int, heads: int, sq: int, d: int,
                   device=None) -> BlockAcc:
    return BlockAcc(
        acc=torch.zeros((batch, heads, sq, d), dtype=torch.float32,
                        device=device),
        m=torch.full((batch, heads, sq), NEG_INF, dtype=torch.float32,
                     device=device),
        l=torch.zeros((batch, heads, sq), dtype=torch.float32,
                      device=device),
    )


def block_attend(state: BlockAcc, q, k, v, scale: float,
                 bias: Optional[torch.Tensor] = None) -> BlockAcc:
    """Fold one K/V block into the online-softmax accumulator (products in
    the policy's compute dtype, statistics and accumulator in f32)."""
    cd = policy().compute_dtype
    s = torch.matmul(q.to(cd), k.to(cd).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    s = s.float()
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    alpha = torch.exp(state.m - m_new)
    probs = torch.exp(s - m_new[..., None])
    l_new = state.l * alpha + probs.sum(dim=-1)
    pv = torch.matmul(probs.to(cd), v.to(cd)).float()
    return BlockAcc(acc=state.acc * alpha[..., None] + pv, m=m_new, l=l_new)


def finalize_block_acc(state: BlockAcc, dtype) -> torch.Tensor:
    l = torch.where(state.l == 0, 1.0, state.l)
    return (state.acc / l[..., None]).to(dtype)
