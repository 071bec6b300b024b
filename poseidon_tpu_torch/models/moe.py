"""Mixture-of-experts transformer with expert parallelism over an
``"expert"`` axis (the port of ``poseidon_tpu/models/moe.py``).

The Switch recipe, as in the JAX package: each block's dense FFN becomes a
router ``wg`` (E, D) and per-expert stacks ``w1e`` (E, F, D) and ``w2e``
(E, D, F); top-1 routing with a fixed per-source capacity (``capacity``,
or ``ceil(T / E * capacity_factor)`` for T tokens), tokens queued by
their running count, those past capacity dropped (they ride the residual
only); the chosen expert's output scaled by its gate probability (the
router learns through it) and the Switch load-balancing aux loss.

**Dispatch and combine are index gathers, not JAX's one-hot einsums.**
JAX builds a 0/1 dispatch tensor (T, E, C) and contracts it with the
tokens (``"tec,td->ecd"``) and the gate-weighted copy with the experts'
outputs (``"tec,ecd->td"``): T·E·C·D multiply-adds each way, and at
gpt_small's 2048 tokens a rank, 8 experts and capacity 320 a
(2048, 8, 320) f32 tensor (21 MB) a layer. Each slot receives at most one
token and each token reads at most one slot, so every sum in those
einsums has one nonzero term: the port gathers each slot's token (a zero
row for an empty slot) and each token's slot (a zero row when dropped)
and multiplies by the gate, the same values at T·D (and E·C·D) work, and
their backward is the matching scatter.

With ``expert_group`` the expert stacks hold this rank's E/n experts
(``ep_shard``) and each layer runs one all-to-all out and one back
(``parallel/mesh.AllToAll``: tokens to the owning rank, outputs home; the
backward of each is the reverse exchange, so the expert leaves' gradients
arrive summed over every source rank). ``build_dp_ep_train_step`` trains
over ``("data", "expert")``: losses are local sums over the static
GLOBAL token count, so the gradients and the loss are SUMMED across
ranks, never averaged.

``parallel/mesh.EXCHANGED`` counts ``ep_dispatch`` and ``ep_return``
(each all-to-all's buffer, forward and backward), ``ep_grad_all_reduce``
(the replicated leaves' gradients over data and expert) and
``ep_expert_grad_all_reduce`` (the expert leaves' over data).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.remat import wrap_checkpoint
from ..numeric import apply_policy, policy
from ..parallel.mesh import AllToAll, DataGroup, NamedGroups
from ..proto.messages import SolverParameter
from ..solvers.updates import SolverState, make_update_fn
from .transformer import (Params, TransformerConfig, _block, _dense, _grads,
                          _layer_norm, attention_sublayer, embed_tokens,
                          lm_head, sum_over, transformer_mults)

EXPERT_AXIS = "expert"
# the leaves that shard over the expert axis, on their leading E dim
# (JAX's ep_param_specs); every other leaf is replicated
EXPERT_LEAVES = ("w1e", "w2e")


@dataclass(frozen=True)
class MoEConfig:
    base: TransformerConfig
    n_experts: int = 8
    # tokens each SOURCE shard may send to each expert; 0 = auto from
    # capacity_factor (even-load tokens * factor, rounded up)
    capacity: int = 0
    capacity_factor: float = 1.25
    aux_weight: float = 0.01


def resolved_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    if cfg.capacity:
        return cfg.capacity
    return int(np.ceil(n_tokens / cfg.n_experts * cfg.capacity_factor))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device=None) -> Params:
    """Seeded parameters with the JAX package's shapes and scales (its
    ``init_moe_params``), drawn on ``generator``'s device and moved to
    ``device``. Another stream than ``jax.random``: cross weights with
    ``transformer.params_from_jax``."""
    b = cfg.base
    d, e = b.d_model, cfg.n_experts
    gen_dev = generator.device

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=gen_dev)
        return (w * (1.0 / np.sqrt(fan_in))).to(device)

    def const(value, n):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    params: Params = {
        "embed": {"w": dense(1, (b.vocab_size, d)) * 0.02},
        "pos": {"w": dense(1, (b.max_seq, d)) * 0.02},
        "head": {"w": dense(d, (b.vocab_size, d))},
        "ln_f": {"g": const(1.0, d), "b": const(0.0, d)},
    }
    for i in range(b.n_layers):
        params[f"block{i}"] = {
            "wqkv": dense(d, (3 * d, d)),
            "wo": dense(d, (d, d)),
            "wg": dense(d, (e, d)),
            "w1e": dense(d, (e, b.d_ff, d)),
            "w2e": dense(b.d_ff, (e, d, b.d_ff)),
            "ln1_g": const(1.0, d), "ln1_b": const(0.0, d),
            "ln2_g": const(1.0, d), "ln2_b": const(0.0, d),
        }
    return params


def _experts_apply(w1e: torch.Tensor, w2e: torch.Tensor,
                   toks: torch.Tensor) -> torch.Tensor:
    """toks (E_local, N, D) through each local expert's tanh-GELU FFN, as
    batched products in the policy's compute dtype (JAX computes these
    outside any Pallas kernel too)."""
    cd = policy().compute_dtype
    h = torch.bmm(toks.to(cd), w1e.to(cd).transpose(1, 2))
    return torch.bmm(F.gelu(h, approximate="tanh"),
                     w2e.to(cd).transpose(1, 2))


def moe_ffn(x: torch.Tensor, wg: torch.Tensor, w1e: torch.Tensor,
            w2e: torch.Tensor, cfg: MoEConfig, *,
            expert_group: Optional[DataGroup] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 switch FFN over flat tokens x (T, D) -> (y (T, D), aux loss).

    Without ``expert_group`` all experts are local. With it, ``w1e`` and
    ``w2e`` hold this rank's E/n experts and the slots cross the group:
    dispatch -> all-to-all (each rank's experts' slots from every source)
    -> local expert FFNs -> all-to-all back -> combine."""
    t_local, d = x.shape
    n_exp = cfg.n_experts
    cap = resolved_capacity(cfg, t_local)

    logits = _dense(x, wg).float()                    # (T, E)
    gates = torch.softmax(logits, dim=-1)
    e_star = torch.argmax(gates, dim=-1)              # the first of ties
    gate = gates.gather(1, e_star[:, None])[:, 0]
    onehot = F.one_hot(e_star, n_exp)
    # each token's place in its expert's queue; past capacity it drops
    pos = onehot.cumsum(0).gather(1, e_star[:, None])[:, 0] - 1
    keep = pos < cap
    # slot e * cap + pos of the flat (E * cap) queue; a dropped token
    # points at the spare slot past the end, which reads a zero row
    slot = torch.where(keep, e_star * cap + pos,
                       torch.full_like(pos, n_exp * cap))
    src = torch.full((n_exp * cap + 1,), t_local, dtype=torch.long,
                     device=x.device)
    src[slot] = torch.arange(t_local, device=x.device)
    xd = torch.cat([x, x.new_zeros(1, d)])[src[:-1]].reshape(n_exp, cap, d)
    if expert_group is not None:
        n = expert_group.world
        e_local = n_exp // n
        # rank r keeps its experts' slots from every source; after the
        # exchange dim 0 indexes the SOURCE rank
        xd = AllToAll.apply(xd.reshape(n, e_local, cap, d), expert_group,
                            "ep_dispatch")
        toks = xd.transpose(0, 1).reshape(e_local, n * cap, d)
        out = _experts_apply(w1e, w2e, toks).to(x.dtype)
        out = out.reshape(e_local, n, cap, d).transpose(0, 1)
        out = AllToAll.apply(out, expert_group, "ep_return")
    else:
        out = _experts_apply(w1e, w2e, xd).to(x.dtype)
    out = torch.cat([out.reshape(n_exp * cap, d), out.new_zeros(1, d)])
    y = out[slot] * (gate * keep).to(x.dtype)[:, None]

    # Switch load-balancing loss: n_exp * sum_e fraction_e * mean_gate_e
    frac = onehot.float().mean(dim=0)
    mean_gate = gates.mean(dim=0)
    aux = cfg.aux_weight * n_exp * (frac * mean_gate).sum()
    return y, aux


def moe_forward(params: Params, cfg: MoEConfig, tokens: torch.Tensor, *,
                expert_group: Optional[DataGroup] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), summed aux loss). The entry and
    exit are the dense model's (``embed_tokens``, ``lm_head``); each block
    is the dense attention sublayer (flash on the card) then ``moe_ffn``.
    A truthy ``cfg.base.remat`` checkpoints each MoE block, saving only its
    input (JAX's bare ``jax.checkpoint``): the dispatch, the exchanges and
    attention recompute in the backward."""
    b_sz, s = tokens.shape
    bcfg = cfg.base
    x = embed_tokens(params, tokens)

    def moe_block(x, blk):
        x = attention_sublayer(bcfg, x, blk)
        h = _layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        y, aux = moe_ffn(h.reshape(b_sz * s, bcfg.d_model), blk["wg"],
                         blk["w1e"], blk["w2e"], cfg,
                         expert_group=expert_group)
        return x + y.reshape(b_sz, s, bcfg.d_model).to(x.dtype), aux

    if bcfg.remat:
        moe_block = wrap_checkpoint(moe_block, "nothing_saveable")
    aux_total = torch.zeros((), device=x.device)
    for i in range(bcfg.n_layers):
        x, aux = moe_block(x, params[f"block{i}"])
        aux_total = aux_total + aux
    return lm_head(params, x), aux_total


def _check_ep_divisibility(cfg: MoEConfig, n_ranks: int) -> None:
    if cfg.n_experts % n_ranks:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                         f"{n_ranks} expert ranks")


def ep_shard(tree, cfg: MoEConfig, e: int, n_ranks: int):
    """Expert rank ``e`` of ``n_ranks``' part of an MoE tree (JAX's
    ``ep_param_specs``): the ``e``-th of ``n_ranks`` even blocks of each
    expert stack's leading E dim (in storage of its own), every other leaf
    whole. Takes any tree of the params' shapes (the momentum too)."""
    _check_ep_divisibility(cfg, n_ranks)
    out = {}
    for lname, lp in tree.items():
        out[lname] = dict(lp)
        for leaf in EXPERT_LEAVES:
            if leaf in lp:
                out[lname][leaf] = _block(lp[leaf], 0, e, n_ranks)
    return out


def ep_unshard(tree, expert_group: DataGroup):
    """The whole MoE tree from every expert rank's ``ep_shard`` part (an
    all-gather over ``expert_group`` an expert stack, in leaf order)."""
    out = {}
    for lname, lp in tree.items():
        out[lname] = dict(lp)
        for leaf in EXPERT_LEAVES:
            if leaf in lp:
                out[lname][leaf] = expert_group.all_gather(lp[leaf])
    return out


def build_dp_ep_train_step(cfg: MoEConfig, sp: SolverParameter,
                           groups: NamedGroups):
    """The JAX package's ``build_dp_ep_train_step`` over this rank's
    ``(data, expert)`` groups:

        step(params, state, tokens, targets) -> (params, state, {"loss"})

    params and the momentum are this rank's ``ep_shard``; tokens and
    targets its rows of the global batch, which shards over BOTH axes:
    row block ``data_index * n_expert + expert_index`` (JAX's
    ``P((data, expert))``; the mesh's joint group's rank). Each MoE layer
    runs one all-to-all out and one back over the expert group. The loss
    is this rank's token-loss sum over the static GLOBAL token count plus
    aux / n_dev, so the cross-rank sums rebuild the global mean exactly:
    the expert leaves' gradients (already summed over the expert group by
    the all-to-all's backward) are summed over data; every other leaf's
    over data and expert; the loss metric over both. Sums, not
    ``average_``'s means. Then ``make_update_fn(sp, transformer_mults(p))``
    updates each leaf."""
    expert = groups[EXPERT_AXIS]
    data = groups["data"]
    _check_ep_divisibility(cfg, expert.world)
    n_dev = expert.world * data.world
    joint, device = groups.joint, groups.device
    apply_policy()

    def step(params: Params, state: SolverState, tokens: torch.Tensor,
             targets: torch.Tensor):
        tokens, targets = tokens.to(device), targets.to(device)
        b_local, s_len = tokens.shape
        inv_total = 1.0 / float(b_local * s_len * n_dev)

        def loss_fn(p):
            logits, aux = moe_forward(p, cfg, tokens, expert_group=expert)
            logp = torch.log_softmax(logits, dim=-1)
            picked = torch.gather(logp, -1, targets[..., None].long())
            # local sums over the static GLOBAL normalizers: the sums
            # across ranks rebuild the exact global mean
            return -picked.sum() * inv_total + aux / float(n_dev)

        loss, grads = _grads(params, loss_fn)
        keys = [(n, l) for n in grads for l in grads[n]]
        grads, _ = sum_over(grads, None, data, "ep_expert_grad_all_reduce",
                            [k for k in keys if k[1] in EXPERT_LEAVES])
        grads, loss = sum_over(grads, loss, joint, "ep_grad_all_reduce",
                               [k for k in keys if k[1] not in EXPERT_LEAVES])
        update = make_update_fn(sp, transformer_mults(params))
        new_params, new_state = update(params, grads, state)
        return new_params, new_state, {"loss": loss}

    return step
