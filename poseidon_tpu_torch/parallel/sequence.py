"""Sequence parallelism: ring attention and all-to-all (Ulysses) attention
over a seq group (the port of ``poseidon_tpu/parallel/sequence.py``).

Each rank of the seq group (``parallel/mesh.DataGroup``) holds a
contiguous (B, H, S/n, D) block of q, k and v, block i at index i.

**Ring flash attention** (``ring_flash_attention``, an autograd Function).
K and V travel the ring as one stacked tensor (``DataGroup.ppermute_``,
index i to i + 1); at step i rank r holds the block of source
``(r - i) % n``. Every live block runs ``ops/flash.flash_attention_fwd``
with the ring ``mode`` of ``_chunk_mode`` (K1 on the card, the plain
version on the CPU), and the blocks' (out, lse) merge by logsumexp in f32
(``_ring_merge``); the returned lse is the global one,
``m + log(l)``. The backward computes ``delta = rowsum(dO * out)`` in f32
once from the merged output, re-rotates K/V and runs
``flash_attention_bwd(..., mode=mode, delta=delta)`` (K2 then K3) on each
live block with the global lse, so each block's p is its slice of the
global probabilities; dq accumulates in f32 at home, dK/dV accumulate in
f32 and ride the ring with their block, home after n shifts. A future
block (mode -1, causal only) launches nothing in either direction, as
JAX's ``lax.cond`` skips it: under causal masking rank r of n runs r + 1
forward and r + 1 backward kernels of each kind. JAX shifts K/V once more
after the last block in each direction; the port leaves that shift out
(nothing reads it).

**The block formulation** (``ring_attention`` when ``pick_block(S/n)``
finds no tile, as JAX routes off the TPU): ``ops/attention.block_attend``
folds each arriving block into the online-softmax accumulator under the
block-level causal bias, differentiated by autograd through a ring shift
whose backward is the reverse shift.

**Ulysses** (``ulysses_attention``): one ``all_to_all`` re-shards q, k and
v from sequence blocks to head groups ((B, H, S/n, D) -> (B, H/n, S, D)),
``ops/flash.maybe_flash_attention`` runs this rank's H/n heads over the
whole sequence (K1-K3 on the card), and a second ``all_to_all`` restores
the sequence blocks; both ride ``mesh.AllToAll``, so each exchange's
backward is the inverse exchange.

``parallel/mesh.EXCHANGED`` counts the bytes a rank sends: ``ring_kv``
(K/V shifts, forward and backward), ``ring_dkv`` (dK/dV shifts) and
``ulysses`` (both all-to-alls and their backward).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import (NEG_INF, block_attend, finalize_block_acc,
                             init_block_acc)
from ..ops.flash import (flash_attention_bwd, flash_attention_fwd,
                         flash_delta, maybe_flash_attention, pick_block)
from .mesh import AllToAll, DataGroup, note_exchange


def _chunk_mode(my: int, src: int, causal: bool) -> int:
    """+1 = the K/V block lies strictly in the past (all live), 0 = the
    diagonal block (the in-block causal triangle), -1 = a future block
    (fully masked). Non-causal: always +1."""
    if not causal:
        return 1
    return 1 if src < my else (0 if src == my else -1)


def _ring_merge(acc, m, l, o_c, lse_c):
    """Fold one block's normalized output and lse into the running merge:
    final = sum_c o_c * exp(lse_c) / sum_c exp(lse_c), computed stably in
    f32."""
    m_new = torch.maximum(m, lse_c)
    alpha = torch.exp(m - m_new)          # rescales the old accumulator
    w = torch.exp(lse_c - m_new)          # the new block's weight
    acc = acc * alpha[..., None] + o_c.float() * w[..., None]
    return acc, m_new, l * alpha + w


def _shift(group: DataGroup, t: torch.Tensor, kind: str,
           shift: int = 1) -> torch.Tensor:
    """``t`` one step around the ring (``shift`` -1: back), counted."""
    note_exchange(kind, t)
    return group.ppermute_(torch.empty_like(t), t, shift)


def _kernel_mode(mode: int, causal: bool) -> Optional[int]:
    """The ``mode`` the flash functions take: the ring mode under causal
    masking, none without it (nothing is masked)."""
    return mode if causal else None


def ring_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: DataGroup, causal: bool = False,
                   scale: Optional[float] = None):
    """(out, lse) of ring flash attention over ``group`` (JAX's
    ``_ring_flash_fwd_impl``): out in q's dtype, lse the global
    logsumexp, f32 (B, H, S/n)."""
    n, my = group.world, group.rank
    b, h, s, d = q.shape
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for i in range(n):
        mode = _chunk_mode(my, (my - i) % n, causal)
        if mode >= 0:
            o_c, lse_c = flash_attention_fwd(q, kv[0], kv[1], causal, scale,
                                             _kernel_mode(mode, causal))
            acc, m, l = _ring_merge(acc, m, l, o_c, lse_c)
        # a dead block merges as the identity (weight exp(NEG_INF - m) = 0
        # against the diagonal block's finite m): nothing to fold
        if i < n - 1:
            kv = _shift(group, kv, "ring_kv")
    lsafe = torch.where(l == 0, 1.0, l)
    out = (acc / lsafe[..., None]).to(q.dtype)
    return out, m + torch.log(lsafe)


def ring_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   group: DataGroup, causal: bool = False,
                   scale: Optional[float] = None):
    """(dq, dk, dv) of ring flash attention (JAX's ``_ring_flash_vjp_bwd``)
    from the forward's merged out and global lse."""
    n, my = group.world, group.rank
    delta = flash_delta(g, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        mode = _chunk_mode(my, (my - i) % n, causal)
        if mode >= 0:
            dq_c, dk_c, dv_c = flash_attention_bwd(
                q, kv[0], kv[1], out, lse, g, causal, scale,
                _kernel_mode(mode, causal), delta)
            dq += dq_c.float()
            dkv[0] += dk_c.float()
            dkv[1] += dv_c.float()
        # dK/dV ride the ring with their block: home after n shifts
        dkv = _shift(group, dkv, "ring_dkv")
        if i < n - 1:
            kv = _shift(group, kv, "ring_kv")
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingFlashAttention(torch.autograd.Function):
    """Ring flash attention over a seq group; saves q, k, v, the merged
    out and the global lse, and its backward is ``ring_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ring_flash_fwd(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_bwd(q, k, v, out, lse, g.contiguous(),
                                    *ctx.args)
        return dq, dk, dv, None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: DataGroup, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Exact ring attention with every block through the flash functions;
    q, k, v: this rank's (B, H, S/n, D) blocks; returns its output
    block."""
    return RingFlashAttention.apply(q, k, v, group, causal, scale)


class _RingShift(torch.autograd.Function):
    """One ring shift whose backward shifts the gradient back."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(group, t, "ring_kv")

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.group, g.contiguous(), "ring_dkv", -1), None


def _ring_block_attention(q, k, v, group: DataGroup, causal: bool,
                          scale: Optional[float]) -> torch.Tensor:
    """JAX's lax ring formulation: the online-softmax block accumulator
    over the arriving K/V blocks, differentiated by autograd."""
    n, my = group.world, group.rank
    b, h, s, d = q.shape
    if scale is None:
        scale = d ** -0.5
    state = init_block_acc(b, h, s, d, device=q.device)
    kv = torch.stack((k, v))
    within = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    for i in range(n):
        src = (my - i) % n
        bias = None
        if causal and src == my:
            bias = torch.where(within, 0.0, NEG_INF)
        elif causal and src > my:
            bias = torch.full((s, s), NEG_INF, device=q.device)
        state = block_attend(state, q, kv[0], kv[1], scale, bias)
        if i < n - 1:
            kv = _RingShift.apply(kv, group)
    return finalize_block_acc(state, q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: DataGroup, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``group``; q, k, v: this rank's (B, H, S/n, D)
    blocks. When ``pick_block(S/n)`` tiles the block it runs
    ``ring_flash_attention`` (the kernels on the card, their plain
    versions on the CPU: the same Function either way), else the block
    formulation."""
    if pick_block(q.shape[-2]) is not None:
        return ring_flash_attention(q, k, v, group, causal, scale)
    return _ring_block_attention(q, k, v, group, causal, scale)


def _seq_to_heads(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """(B, H, S/n, D) -> (B, H/n, S, D): head group j to index j, the
    sequence blocks concatenated in source order (global order)."""
    n = group.world
    b, h, s, d = x.shape
    send = x.reshape(b, n, h // n, s, d).transpose(0, 1)
    recv = AllToAll.apply(send, group, "ulysses")   # (n, B, H/n, S/n, D)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """(B, H/n, S, D) -> (B, H, S/n, D), the inverse exchange."""
    n = group.world
    b, hl, big_s, d = x.shape
    s = big_s // n
    send = x.reshape(b, hl, n, s, d).permute(2, 0, 1, 3, 4)
    recv = AllToAll.apply(send, group, "ulysses")   # (n, B, H/n, S/n, D)
    return recv.transpose(0, 1).reshape(b, n * hl, s, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: DataGroup, *, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all sequence parallelism over ``group``; q, k, v: (B, H,
    S/n, D) with H divisible by the group's size. Returns this rank's
    sequence block of the output. q, k and v cross in one exchange (a
    stacked batch)."""
    n = group.world
    b, h, s, d = q.shape
    if h % n:
        raise ValueError(f"heads ({h}) must divide by axis size ({n})")
    qkv = _seq_to_heads(torch.stack((q, k, v)).reshape(3 * b, h, s, d),
                        group)
    qh, kh, vh = qkv.reshape(3, b, h // n, n * s, d).unbind(0)
    out = maybe_flash_attention(qh, kh, vh, causal=causal, scale=scale)
    return _heads_to_seq(out, group)
