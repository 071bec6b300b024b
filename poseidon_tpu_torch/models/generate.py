"""Autoregressive decoding with a KV cache for the transformer family (the
port of ``poseidon_tpu/models/generate.py``, dense models only).

Prefill and decode share ``_block_cached``: prefill runs it once over the
whole prompt (S = P), writing the caches, and routes its attention through
``maybe_flash_attention`` (ordinary causal self-attention: the CUDA flash
kernel on the card); decode runs it with S = 1 per step as plain
dot-product work against the cache (``_attend_cached``), where a
single-query attend is gather-bound and the kernel's tiling gains nothing.
The two attends mirror the JAX package site by site: the flash path
multiplies by ``dh ** -0.5`` and masks with the finite ``-1e30``; the
cached and paged attends divide by ``sqrt(dh)`` and mask with ``-inf``.

The serving tier's paged decode (``prefill_cached`` + ``paged_decode_step``)
reads the same math through a page table; it matches ``generate``'s dense
caches bitwise on one device when both see the same cache length.

Unlike the JAX package's functional updates, the caches here are written
IN PLACE (``_block_cached`` into the dense caches it is given,
``paged_decode_step`` into the page pools), and returned for symmetry.
MoE configs raise ``NotImplementedError``: MoE decode is a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.flash import maybe_flash_attention
from .transformer import (TransformerConfig, _dense, _layer_norm,
                          embed_tokens, ffn_sublayer, lm_head)

_NO_MOE = ("MoE decode is not ported yet (ROADMAP, queue A); the port "
           "serves dense TransformerConfig models")


def _attend_cached(q, ck, cv, q_pos0):
    """q (B,H,S,Dh) against caches (B,H,T,Dh); key j is visible to query
    i iff j <= q_pos0 + i."""
    dh = q.shape[-1]
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(),
                          ck.float()) / np.sqrt(dh)
    t = ck.shape[2]
    i = q_pos0 + torch.arange(q.shape[2], device=q.device)
    visible = torch.arange(t, device=q.device)[None, :] <= i[:, None]
    scores = torch.where(visible[None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, cv.float())


def _qkv(cfg: TransformerConfig, x, blk):
    """ln1 -> fused qkv -> (q, k, v) each (B, H, S, Dh): the qkv rows are
    [q heads; k heads; v heads]."""
    b, s, _ = x.shape
    dh = cfg.d_model // cfg.n_heads
    h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    qkv = _dense(h, blk["wqkv"]).reshape(b, s, 3, cfg.n_heads, dh)
    return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))


def _block_cached(cfg: TransformerConfig, x, blk, ck, cv, pos0: int, *,
                  moe_cfg=None, prefill: bool = False):
    """One decoder block writing this call's K/V at ``pos0`` (in place) and
    attending against the cache. Returns (x_out, ck, cv). ``prefill`` marks
    the first call, where the cache holds nothing but this call's own keys:
    attention is then causal self-attention over the prompt, routed
    through the flash path."""
    if moe_cfg is not None:
        raise NotImplementedError(_NO_MOE)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, x, blk)
    ck[:, :, pos0:pos0 + s] = k.to(ck.dtype)
    cv[:, :, pos0:pos0 + s] = v.to(cv.dtype)
    if prefill:
        att = maybe_flash_attention(q, k, v, causal=True)
    else:
        att = _attend_cached(q, ck, cv, pos0)
    att = att.transpose(1, 2).reshape(b, s, cfg.d_model)
    x = x + _dense(att, blk["wo"]).to(x.dtype)
    return ffn_sublayer(x, blk), ck, cv


def _split_cfg(cfg):
    """(base TransformerConfig, MoE config | None) from either config."""
    base = getattr(cfg, "base", None)
    return (base, cfg) if base is not None else (cfg, None)


def _zero_caches(bcfg: TransformerConfig, b: int, total: int, device):
    dh = bcfg.d_model // bcfg.n_heads
    return tuple(
        (torch.zeros((b, bcfg.n_heads, total, dh), device=device),
         torch.zeros((b, bcfg.n_heads, total, dh), device=device))
        for _ in range(bcfg.n_layers))


def _forward_cached(params, cfg, tokens, caches, pos0: int, *,
                    prefill: bool = False):
    """tokens (B, S) starting at absolute position ``pos0`` -> (logits of
    the LAST position (B, V), caches updated in place)."""
    bcfg, moe_cfg = _split_cfg(cfg)
    x = embed_tokens(params, tokens, pos_offset=pos0)
    for i in range(bcfg.n_layers):
        x, _, _ = _block_cached(bcfg, x, params[f"block{i}"], *caches[i],
                                pos0, moe_cfg=moe_cfg, prefill=prefill)
    return lm_head(params, x)[:, -1], caches


# --------------------------------------------------------------------------- #
# Paged decode (the serving tier's cache discipline; serving/kv_pool.py owns
# page allocation, the math lives here beside the dense path it matches)
# --------------------------------------------------------------------------- #


def prefill_cached(params, cfg, tokens: torch.Tensor, last_idx: torch.Tensor,
                   total: int):
    """Serving prefill: tokens (B, Pb) right-padded prompts, ``last_idx``
    (B,) the index of each row's last REAL token, ``total`` the cache
    length to allocate. Returns (logits at last_idx (B, V), dense per-layer
    caches holding the prompt's K/V for the pool to scatter into pages).

    Padding positions write garbage K/V past last_idx; decode's visibility
    mask never exposes a position before the decode loop has overwritten
    it with a real token's K/V."""
    bcfg, moe_cfg = _split_cfg(cfg)
    b, _ = tokens.shape
    caches = _zero_caches(bcfg, b, total, tokens.device)
    x = embed_tokens(params, tokens, pos_offset=0)
    for i in range(bcfg.n_layers):
        x, _, _ = _block_cached(bcfg, x, params[f"block{i}"], *caches[i], 0,
                                moe_cfg=moe_cfg, prefill=True)
    logits = lm_head(params, x)                        # (B, Pb, V)
    idx = last_idx.long().to(logits.device)[:, None, None].expand(
        -1, 1, logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0], caches


def _attend_paged(q, ck, cv, pos):
    """q (B,H,1,Dh) against gathered page caches (B,H,T,Dh) with per-ROW
    positions: key j is visible to row b iff j <= pos[b]. The math of
    ``_attend_cached`` with a ragged mask."""
    dh = q.shape[-1]
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(),
                          ck.float()) / np.sqrt(dh)
    t = ck.shape[2]
    visible = (torch.arange(t, device=q.device)[None, None, None, :]
               <= pos[:, None, None, None])              # (B,1,1,T)
    scores = torch.where(visible, scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, cv.float())


def _block_paged(cfg: TransformerConfig, x, blk, pk, pv, page_table,
                 slot_pages, slots, pos):
    """One decoder block over PAGED caches: scatter this token's K/V into
    each row's (page, slot) in place, gather the row's pages back into a
    (B,H,T,Dh) view, attend with the ragged mask."""
    b, s, _ = x.shape                                  # s == 1
    dh = cfg.d_model // cfg.n_heads
    q, k, v = _qkv(cfg, x, blk)
    # (B,H,1,Dh) -> per-row scatter at [(page, slot)]; inactive rows all
    # point at the scratch page 0 slot 0, harmless by construction
    pk[slot_pages, :, slots, :] = k[:, :, 0, :].to(pk.dtype)
    pv[slot_pages, :, slots, :] = v[:, :, 0, :].to(pv.dtype)
    # page-table indirection: (B, P_seq) -> (B, P_seq, H, psz, Dh) ->
    # (B, H, P_seq*psz, Dh); pages sit in sequence order, so gathered index
    # j IS absolute position j
    ck = pk[page_table].permute(0, 2, 1, 3, 4).reshape(b, cfg.n_heads, -1, dh)
    cv = pv[page_table].permute(0, 2, 1, 3, 4).reshape(b, cfg.n_heads, -1, dh)
    att = _attend_paged(q, ck, cv, pos)
    att = att.transpose(1, 2).reshape(b, s, cfg.d_model)
    x = x + _dense(att, blk["wo"]).to(x.dtype)
    return ffn_sublayer(x, blk), pk, pv


def paged_decode_step(params, cfg, tok: torch.Tensor, caches,
                      page_table: torch.Tensor, pos: torch.Tensor):
    """ONE token for every row against paged KV caches: the serving decode
    step.

    tok (B,) int - the token each row feeds in; ``caches`` - per-layer
    (pk, pv) page pools (num_pages, H, page_size, Dh) shared by all rows,
    updated IN PLACE; page_table (B, max_pages) int - each row's pages in
    sequence order, unused entries page 0 (the reserved scratch page); pos
    (B,) int - the absolute position this token is written at. Returns
    (logits (B, V), caches). Inactive rows (padding up to the rung): an
    all-scratch table row, pos 0, tok 0."""
    bcfg, moe_cfg = _split_cfg(cfg)
    if moe_cfg is not None:
        raise NotImplementedError(_NO_MOE)
    psz = caches[0][0].shape[2]
    pos = pos.long()
    page_table = page_table.long()
    slot_pages = torch.gather(page_table, 1,
                              torch.div(pos, psz,
                                        rounding_mode="floor")[:, None])[:, 0]
    slots = pos % psz
    x = (params["embed"]["w"][tok.long()[:, None]]
         + params["pos"]["w"][pos][:, None, :])
    for i in range(bcfg.n_layers):
        pk, pv = caches[i]
        x, _, _ = _block_paged(bcfg, x, params[f"block{i}"], pk, pv,
                               page_table, slot_pages, slots, pos)
    return lm_head(params, x)[:, -1], caches


def generate(params, cfg, prompt: torch.Tensor, max_new: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (temperature 0) or sampled decoding over dense caches.

    prompt (B, P) int -> (generated tokens (B, max_new), per-step logits
    (B, max_new, V)); step i's logits are the ones token i was picked from.
    Sampling draws from ``generator`` (on the prompt's device). Requires
    P + max_new <= max_seq (learned positions)."""
    bcfg, _ = _split_cfg(cfg)
    b, p_len = prompt.shape
    total = p_len + max_new
    if total > bcfg.max_seq:
        raise ValueError(f"prompt {p_len} + max_new {max_new} exceeds "
                         f"max_seq {bcfg.max_seq}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    caches = _zero_caches(bcfg, b, total, prompt.device)
    with torch.inference_mode():
        logits, caches = _forward_cached(params, cfg, prompt, caches, 0,
                                         prefill=True)
        toks, step_logits = [], []
        for i in range(max_new):
            if temperature > 0.0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            step_logits.append(logits)
            if i + 1 < max_new:     # the last step's successor is never read
                logits, caches = _forward_cached(params, cfg, tok[:, None],
                                                 caches, p_len + i)
    return torch.stack(toks, dim=1), torch.stack(step_logits, dim=1)
