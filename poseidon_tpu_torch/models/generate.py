"""Autoregressive decoding with a KV cache for the transformer family (the
port of ``poseidon_tpu/models/generate.py``), for dense and MoE models.

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

An ``MoEConfig`` (``models/moe.py``) routes each block's FFN through
``moe_ffn`` with every expert local, DROPLESS: the capacity is the call's
token count, so every routed token reaches its expert; prefill routes its
tokens in chunks of 256 (routing is per token, so chunking changes
nothing), as JAX bounds its one-hot dispatch tensor. ``paged_decode_step``
serves dense models only and refuses an ``MoEConfig`` with JAX's message.

``tp_layout=`` marks head-major ``wqkv`` rows (``to_tp_layout``), as in
the JAX package. ``tp_prefill_cached`` and ``tp_paged_decode_step`` serve a
model tensor-parallel from ONE controller, where the JAX package compiles
one GSPMD program over a mesh: each shard holds its heads' q/k/v rows,
``wo`` columns, ``w1`` rows and ``w2`` columns (``tp_shard``) and its heads'
KV caches on its own device; the controller takes each layer norm once,
sends its output to every shard (Megatron's ``f``), and sums the shards'
partial ``wo`` and ``w2`` products back in rank order (``g``). The dense
leaves have no bias, so nothing is added once a shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.flash import maybe_flash_attention
from .moe import moe_ffn
from .transformer import (TransformerConfig, _dense, _layer_norm,
                          embed_tokens, ffn_product, ffn_sublayer, lm_head)

# JAX's refusal of an MoE config in paged decode (models/generate.py)
MOE_PAGED_REFUSAL = ("paged decode serves dense TransformerConfig models; "
                     "MoE decode stays on the dense-cache generate() path")

# tokens an MoE prefill routes a call: JAX's chunk, which bounds its
# one-hot dispatch tensor (the port's gathers need no bound; the same
# chunks give the experts' products JAX's shapes)
MOE_PREFILL_CHUNK = 256


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


def _split_qkv(cfg: TransformerConfig, qkv, tp_layout: bool):
    """Fused projections (B, S, 3*Hl*Dh) -> (q, k, v) each (B, Hl, S, Dh):
    rows [q heads; k heads; v heads], or head-major [(q, k, v) of head 0;
    ...] under ``tp_layout`` (``transformer.to_tp_layout``). Hl is the heads
    the rows hold: all of them, or a tp shard's."""
    b, s, n = qkv.shape
    dh = cfg.d_model // cfg.n_heads
    hl = n // (3 * dh)
    if tp_layout:
        qkv = qkv.reshape(b, s, hl, 3, dh)
        return tuple(qkv[:, :, :, j].transpose(1, 2) for j in range(3))
    qkv = qkv.reshape(b, s, 3, hl, dh)
    return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))


def _attn_cached(cfg: TransformerConfig, h, wqkv, wo, ck, cv, pos0: int, *,
                 prefill: bool, tp_layout: bool):
    """The attention of ``_block_cached`` from its ln1 output ``h``: write
    this call's K/V at ``pos0`` (in place), attend, and return ``att @
    wo^T`` (B, S, D). Given a tp shard's ``wqkv`` rows, ``wo`` columns and
    caches, it is the shard form: that shard's heads and its partial
    product."""
    b, s, _ = h.shape
    q, k, v = _split_qkv(cfg, _dense(h, wqkv), tp_layout)
    ck[:, :, pos0:pos0 + s] = k.to(ck.dtype)
    cv[:, :, pos0:pos0 + s] = v.to(cv.dtype)
    if prefill:
        att = maybe_flash_attention(q, k, v, causal=True)
    else:
        att = _attend_cached(q, ck, cv, pos0)
    return _dense(att.transpose(1, 2).reshape(b, s, -1), wo)


def _block_cached(cfg: TransformerConfig, x, blk, ck, cv, pos0: int, *,
                  moe_cfg=None, prefill: bool = False,
                  tp_layout: bool = False):
    """One decoder block writing this call's K/V at ``pos0`` (in place) and
    attending against the cache. Returns (x_out, ck, cv). ``prefill`` marks
    the first call, where the cache holds nothing but this call's own keys:
    attention is then causal self-attention over the prompt, routed
    through the flash path. With ``moe_cfg`` the FFN is the dropless
    switch FFN (all experts local, capacity = the chunk's tokens).
    ``tp_layout`` marks head-major ``wqkv`` rows (``to_tp_layout``)."""
    b, s, _ = x.shape
    h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    x = x + _attn_cached(cfg, h, blk["wqkv"], blk["wo"], ck, cv, pos0,
                         prefill=prefill, tp_layout=tp_layout).to(x.dtype)
    if moe_cfg is None:
        return ffn_sublayer(x, blk), ck, cv
    h = _layer_norm(x, blk["ln2_g"], blk["ln2_b"])
    flat = h.reshape(b * s, cfg.d_model)
    chunk = min(flat.shape[0], MOE_PREFILL_CHUNK)
    outs = []
    for lo in range(0, flat.shape[0], chunk):
        part = flat[lo:lo + chunk]
        dec = dataclasses.replace(moe_cfg, capacity=part.shape[0])
        outs.append(moe_ffn(part, blk["wg"], blk["w1e"], blk["w2e"],
                            dec)[0])
    y = torch.cat(outs) if len(outs) > 1 else outs[0]
    return x + y.reshape(b, s, cfg.d_model).to(x.dtype), ck, cv


def _split_cfg(cfg):
    """(base TransformerConfig, MoE config | None) from either config."""
    base = getattr(cfg, "base", None)
    return (base, cfg) if base is not None else (cfg, None)


def _check_dense(cfg) -> TransformerConfig:
    """The base config of a dense model; an ``MoEConfig`` is refused with
    JAX's paged-decode message."""
    bcfg, moe_cfg = _split_cfg(cfg)
    if moe_cfg is not None:
        raise NotImplementedError(MOE_PAGED_REFUSAL)
    return bcfg


def _zero_caches(bcfg: TransformerConfig, b: int, total: int, device,
                 heads: Optional[int] = None):
    """Per-layer (K, V) dense caches (b, heads, total, Dh), all heads
    unless a tp shard's count is given."""
    dh = bcfg.d_model // bcfg.n_heads
    shape = (b, heads or bcfg.n_heads, total, dh)
    return tuple((torch.zeros(shape, device=device),
                  torch.zeros(shape, device=device))
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
                   total: int, *, tp_layout: bool = False):
    """Serving prefill: tokens (B, Pb) right-padded prompts, ``last_idx``
    (B,) the index of each row's last REAL token, ``total`` the cache
    length to allocate. Returns (logits at last_idx (B, V), dense per-layer
    caches holding the prompt's K/V for the pool to scatter into pages).

    Padding positions write garbage K/V past last_idx; decode's visibility
    mask never exposes a position before the decode loop has overwritten
    it with a real token's K/V. ``tp_layout`` marks head-major ``wqkv``
    rows (``to_tp_layout``)."""
    bcfg, moe_cfg = _split_cfg(cfg)
    b, _ = tokens.shape
    caches = _zero_caches(bcfg, b, total, tokens.device)
    x = embed_tokens(params, tokens, pos_offset=0)
    for i in range(bcfg.n_layers):
        x, _, _ = _block_cached(bcfg, x, params[f"block{i}"], *caches[i], 0,
                                moe_cfg=moe_cfg, prefill=True,
                                tp_layout=tp_layout)
    return _pick_last(lm_head(params, x), last_idx), caches


def _pick_last(logits, last_idx):
    """(B, Pb, V) logits -> (B, V) at each row's ``last_idx``."""
    idx = last_idx.long().to(logits.device)[:, None, None].expand(
        -1, 1, logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0]


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


def _attn_paged(cfg: TransformerConfig, h, wqkv, wo, pk, pv, page_table,
                slot_pages, slots, pos, *, tp_layout: bool):
    """The attention of ``_block_paged`` from its ln1 output ``h``: scatter
    this token's K/V into each row's (page, slot) in place, gather the
    row's pages back into a (B,Hl,T,Dh) view, attend with the ragged mask,
    return ``att @ wo^T`` (B, 1, D). Given a tp shard's ``wqkv`` rows,
    ``wo`` columns and page pools, it is the shard form."""
    b, s, _ = h.shape                                  # s == 1
    q, k, v = _split_qkv(cfg, _dense(h, wqkv), tp_layout)
    hl, dh = q.shape[1], q.shape[3]
    # (B,Hl,1,Dh) -> per-row scatter at [(page, slot)]; inactive rows all
    # point at the scratch page 0 slot 0, harmless by construction
    pk[slot_pages, :, slots, :] = k[:, :, 0, :].to(pk.dtype)
    pv[slot_pages, :, slots, :] = v[:, :, 0, :].to(pv.dtype)
    # page-table indirection: (B, P_seq) -> (B, P_seq, Hl, psz, Dh) ->
    # (B, Hl, P_seq*psz, Dh); pages sit in sequence order, so gathered index
    # j IS absolute position j
    ck = pk[page_table].permute(0, 2, 1, 3, 4).reshape(b, hl, -1, dh)
    cv = pv[page_table].permute(0, 2, 1, 3, 4).reshape(b, hl, -1, dh)
    att = _attend_paged(q, ck, cv, pos)
    return _dense(att.transpose(1, 2).reshape(b, s, hl * dh), wo)


def _block_paged(cfg: TransformerConfig, x, blk, pk, pv, page_table,
                 slot_pages, slots, pos, *, tp_layout: bool = False):
    """One decoder block over PAGED caches (``_attn_paged``), then the FFN.
    ``tp_layout`` marks head-major ``wqkv`` rows (``to_tp_layout``)."""
    h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    x = x + _attn_paged(cfg, h, blk["wqkv"], blk["wo"], pk, pv, page_table,
                        slot_pages, slots, pos,
                        tp_layout=tp_layout).to(x.dtype)
    return ffn_sublayer(x, blk), pk, pv


def _paged_indices(page_table, pos, psz: int):
    """(page_table, pos, slot_pages, slots) as longs: each row's page and
    slot for the token it writes at ``pos``."""
    pos = pos.long()
    page_table = page_table.long()
    slot_pages = torch.gather(page_table, 1,
                              torch.div(pos, psz,
                                        rounding_mode="floor")[:, None])[:, 0]
    return page_table, pos, slot_pages, pos % psz


def _decode_embed(params, tok, pos):
    return (params["embed"]["w"][tok.long()[:, None]]
            + params["pos"]["w"][pos][:, None, :])


def paged_decode_step(params, cfg, tok: torch.Tensor, caches,
                      page_table: torch.Tensor, pos: torch.Tensor, *,
                      tp_layout: bool = False):
    """ONE token for every row against paged KV caches: the serving decode
    step.

    tok (B,) int - the token each row feeds in; ``caches`` - per-layer
    (pk, pv) page pools (num_pages, H, page_size, Dh) shared by all rows,
    updated IN PLACE; page_table (B, max_pages) int - each row's pages in
    sequence order, unused entries page 0 (the reserved scratch page); pos
    (B,) int - the absolute position this token is written at. Returns
    (logits (B, V), caches). Inactive rows (padding up to the rung): an
    all-scratch table row, pos 0, tok 0. ``tp_layout`` marks head-major
    ``wqkv`` rows (``to_tp_layout``)."""
    bcfg = _check_dense(cfg)
    page_table, pos, slot_pages, slots = _paged_indices(
        page_table, pos, caches[0][0].shape[2])
    x = _decode_embed(params, tok, pos)
    for i in range(bcfg.n_layers):
        pk, pv = caches[i]
        x, _, _ = _block_paged(bcfg, x, params[f"block{i}"], pk, pv,
                               page_table, slot_pages, slots, pos,
                               tp_layout=tp_layout)
    return lm_head(params, x)[:, -1], caches


# --------------------------------------------------------------------------- #
# Tensor-parallel serving: one controller over head-sharded weights and KV
# pools (the counterpart of the JAX package's GSPMD-placed tp executor)
# --------------------------------------------------------------------------- #


def _tp_reduce(parts, device):
    """Megatron's ``g``: the shards' partial products summed on ``device``
    in rank order 0, 1, ... (out of place: no shard's buffer is written)."""
    y = parts[0]
    for part in parts[1:]:
        y = y + part.to(device)
    return y


def _tp_block(x, blocks, attend):
    """One decoder block over tp shards, driven from the controller: ln1
    once on ``x``'s device (shard 0's), its output sent to each shard's
    device (Megatron's ``f``), ``attend(t, h_t)`` each shard's partial
    attention, the partials summed back in rank order and added to the
    residual once; then the same for ln2 and the FFN. ``blocks`` are the
    shards' trees of this block; the replicated ln leaves are read from
    shard 0's."""
    dev = x.device
    h = _layer_norm(x, blocks[0]["ln1_g"], blocks[0]["ln1_b"])
    y = _tp_reduce([attend(t, h.to(blk["wqkv"].device))
                    for t, blk in enumerate(blocks)], dev)
    x = x + y.to(x.dtype)
    h = _layer_norm(x, blocks[0]["ln2_g"], blocks[0]["ln2_b"])
    y = _tp_reduce([ffn_product(h.to(blk["w1"].device), blk["w1"],
                                 blk["w2"]) for blk in blocks], dev)
    return x + y.to(x.dtype)


def tp_prefill_cached(shards, cfg, tokens: torch.Tensor,
                      last_idx: torch.Tensor, total: int):
    """``prefill_cached`` over tp shards. ``shards`` is one tree a rank:
    rank t's ``tp_shard`` of the tp-layout params on its device. The
    replicated leaves are read from shard 0 only (the controller's, where
    ``tokens`` lie); the other shards need only their blocks' ``wqkv``,
    ``wo``, ``w1`` and ``w2`` slices. Each shard attends its H/tp heads
    through the flash path. Returns (logits at last_idx (B, V) on shard 0's device, one
    tuple of dense per-layer caches a shard, each (B, H/tp, total, Dh) on
    its shard's device)."""
    bcfg = _check_dense(cfg)
    b, _ = tokens.shape
    caches = [_zero_caches(bcfg, b, total, sh["block0"]["wqkv"].device,
                           heads=bcfg.n_heads // len(shards))
              for sh in shards]
    x = embed_tokens(shards[0], tokens, pos_offset=0)
    for i in range(bcfg.n_layers):
        blocks = [sh[f"block{i}"] for sh in shards]

        def attend(t, h, i=i, blocks=blocks):
            return _attn_cached(bcfg, h, blocks[t]["wqkv"], blocks[t]["wo"],
                                *caches[t][i], 0, prefill=True,
                                tp_layout=True)

        x = _tp_block(x, blocks, attend)
    return _pick_last(lm_head(shards[0], x), last_idx), tuple(caches)


def tp_paged_decode_step(shards, cfg, tok: torch.Tensor, caches,
                         page_table: torch.Tensor, pos: torch.Tensor):
    """``paged_decode_step`` over tp shards (``tp_prefill_cached``'s
    ``shards``): ``caches`` holds one tuple of per-layer (pk, pv) page pools
    a shard, each (num_pages, H/tp, page_size, Dh) on its shard's device
    and updated IN PLACE; a page id is the same page on every shard.
    ``tok``, ``page_table`` and ``pos`` lie on shard 0's device. Returns
    (logits (B, V) there, caches)."""
    bcfg = _check_dense(cfg)
    page_table, pos, slot_pages, slots = _paged_indices(
        page_table, pos, caches[0][0][0].shape[2])
    # the indices on each shard's device, copied once a device
    index = {}
    for sh in shards:
        dev = sh["block0"]["wqkv"].device
        if dev not in index:
            index[dev] = tuple(v.to(dev) for v in (page_table, slot_pages,
                                                   slots, pos))
    x = _decode_embed(shards[0], tok, pos)
    for i in range(bcfg.n_layers):
        blocks = [sh[f"block{i}"] for sh in shards]

        def attend(t, h, i=i, blocks=blocks):
            return _attn_paged(bcfg, h, blocks[t]["wqkv"], blocks[t]["wo"],
                               *caches[t][i], *index[h.device],
                               tp_layout=True)

        x = _tp_block(x, blocks, attend)
    return lm_head(shards[0], x)[:, -1], caches


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
