"""Transformer LM family: config, parameters, the forward pass and the
one-device training step (the port of ``poseidon_tpu/models/transformer.py
:36-241``).

A GPT-style decoder: token + learned position embeddings, pre-norm blocks
(layer norm -> fused qkv -> causal attention -> wo residual; layer norm ->
tanh-GELU FFN residual), a final layer norm and an untied vocabulary head.
Parameters are a plain ``{name: {leaf: tensor}}`` tree with the JAX
package's names and layouts (every weight is ``(out, in)``: ``_dense``
contracts x's last dim with w's dim 1, i.e. ``F.linear(x, w)``), so a JAX
tree crosses with ``params_from_jax``.

Numerics follow the JAX package's numeric policy (``numeric.py``): every
dense product takes its operands in ``compute_dtype`` (float32 with TF32
off by default; bfloat16 under ``--bf16``, whose q, k and v then reach the
flash kernels' bf16 builds), the residual stream keeps the embeddings'
float32 (each sublayer's output is cast back to it), layer norm runs in
f32 and returns its input's dtype, GELU in its tanh form
(``jax.nn.gelu``'s default; ``F.gelu``'s default is erf), f32 logits. Attention routes through ``ops/flash.maybe_flash_attention``: the
CUDA flash kernels (forward, and dQ and dK/dV in the backward) on the card
where the JAX package would run its Pallas kernels. ``cfg.remat`` wraps
each block in a checkpoint (``core/remat.py``), as the JAX forward does.

``build_dp_sp_train_step`` is the JAX package's data x seq step: one
device by default, or this rank's place on a ``("data", "seq")`` mesh
(``parallel/mesh.NamedGroups``): tokens arrive as the rank's (B/data,
S/seq) block, attention runs as a ring over the seq group
(``parallel/sequence.ring_attention``), positions start at the seq index
x S/seq, and the gradients and the loss are averaged over both axes.

The tensor-parallel half (Megatron): ``to_tp_layout`` reorders each
block's fused qkv rows head-major, ``tp_shard`` takes a rank's slices
(rows of ``wqkv`` and ``w1``, columns of ``wo`` and ``w2``; the rest
replicated), ``tp_block_forward`` runs a rank's heads and FFN columns
between Megatron's conjugate pair (``make_fg_ops``: ``f`` the identity
forward and an all-reduce backward at each column-parallel input, ``g``
an all-reduce forward and the identity backward after each row-parallel
product), and ``build_dp_tp_train_step`` trains over ``("data",
"model")`` or, with ``seq_axis``, ``("data", "seq", "model")``. The
pipeline step and MoE blocks wait for the next slice (ROADMAP A.10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.remat import resolve_lm_policy, wrap_checkpoint
from ..numeric import apply_policy, policy, resolve_device
from ..ops.flash import maybe_flash_attention
from ..parallel.mesh import (MODEL_AXIS, STAGE_AXIS, DataGroup, NamedGroups,
                             note_exchange)
from ..parallel.sequence import ring_attention
from ..proto.messages import SolverParameter
from ..solvers.updates import SolverState, make_update_fn

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 1024
    # rematerialize block activations in the backward pass: a policy name
    # of core/remat.REMAT_POLICIES or the legacy bool (True means
    # nothing_saveable, False unset)
    remat: "bool | str" = False

    def n_params(self) -> int:
        """Parameter count (embeddings + blocks + head)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        block = 4 * d * d + 2 * d * f + 4 * d  # qkv+o, ffn, 2 layernorms
        return v * d + self.max_seq * d + v * d + 2 * d + L * block


def gpt_small_config(max_seq: int = 1024,
                     remat: "bool | str" = True) -> TransformerConfig:
    """The GPT-2-small shape (768d x 12L x 12h, d_ff 3072) with a 32768
    vocabulary and an untied head (136,091,136 params at max_seq 1024);
    remat on by default, as in the JAX package."""
    return TransformerConfig(vocab_size=32768, d_model=768, n_heads=12,
                             n_layers=12, d_ff=3072, max_seq=max_seq,
                             remat=remat)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Seeded parameters with the JAX package's scales: normal / sqrt(fan_in)
    for weights, 0.02 * normal for the embeddings, LN gains 1 and biases 0.
    Drawn on ``generator``'s device (the CPU for a default Generator), then
    moved to ``device``. Another stream than ``jax.random``: cross weights
    with ``params_from_jax``."""
    gen_dev = generator.device

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=gen_dev)
        return (w * (1.0 / np.sqrt(fan_in))).to(device)

    def const(value, n):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    d = cfg.d_model
    params: Params = {
        "embed": {"w": dense(1, (cfg.vocab_size, d)) * 0.02},
        "pos": {"w": dense(1, (cfg.max_seq, d)) * 0.02},
        "head": {"w": dense(d, (cfg.vocab_size, d))},
        "ln_f": {"g": const(1.0, d), "b": const(0.0, d)},
    }
    for i in range(cfg.n_layers):
        params[f"block{i}"] = {
            "wqkv": dense(d, (3 * d, d)),
            "wo": dense(d, (d, d)),
            "w1": dense(d, (cfg.d_ff, d)),
            "w2": dense(cfg.d_ff, (d, cfg.d_ff)),
            "ln1_g": const(1.0, d), "ln1_b": const(0.0, d),
            "ln2_g": const(1.0, d), "ln2_b": const(0.0, d),
        }
    return params


def params_from_jax(tree, device=None) -> Params:
    """The JAX package's LM params (a ``{name: {leaf: array}}`` tree of numpy
    or JAX arrays; the layouts are the same) as a tree of tensors on
    ``device``."""
    return {name: {leaf: torch.tensor(np.asarray(v), device=device)
                   for leaf, v in d.items()}
            for name, d in tree.items()}


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's last dim against w's dim 1, both in the policy's compute
    dtype (the output stays in it)."""
    cd = policy().compute_dtype
    return F.linear(x.to(cd), w.to(cd))


def _attend(q, k, v, seq_group: Optional[DataGroup]) -> torch.Tensor:
    """Causal attention of (B, H, S, Dh) blocks: a ring over ``seq_group``
    when it spans more than one rank, else the flash path."""
    if seq_group is not None and seq_group.world > 1:
        return ring_attention(q, k, v, seq_group, causal=True)
    return maybe_flash_attention(q, k, v, causal=True)


def attention_sublayer(cfg: TransformerConfig, x: torch.Tensor, blk,
                       *, seq_group: Optional[DataGroup] = None
                       ) -> torch.Tensor:
    """ln1 -> fused qkv -> flash (or ring) attention -> wo residual."""
    b, s, _ = x.shape
    h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    qkv = _dense(h, blk["wqkv"])                       # (B, S, 3*D)
    d_head = cfg.d_model // cfg.n_heads
    qkv = qkv.reshape(b, s, 3, cfg.n_heads, d_head)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # (B,H,S,Dh)
    att = _attend(q, k, v, seq_group)
    att = att.transpose(1, 2).reshape(b, s, cfg.d_model)
    return x + _dense(att, blk["wo"]).to(x.dtype)


def ffn_product(h: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """``gelu(h @ w1^T) @ w2^T`` (tanh GELU) from the ln2 output; with a tp
    rank's ``w1`` rows and ``w2`` columns, that rank's partial product."""
    return _dense(F.gelu(_dense(h, w1), approximate="tanh"), w2)


def ffn_sublayer(x: torch.Tensor, blk) -> torch.Tensor:
    """ln2 -> tanh-GELU FFN -> residual."""
    h = _layer_norm(x, blk["ln2_g"], blk["ln2_b"])
    return x + ffn_product(h, blk["w1"], blk["w2"]).to(x.dtype)


def block_forward(cfg: TransformerConfig, x: torch.Tensor, blk,
                  *, seq_group: Optional[DataGroup] = None) -> torch.Tensor:
    """One decoder block: attention sublayer + GELU FFN residual."""
    return ffn_sublayer(attention_sublayer(cfg, x, blk, seq_group=seq_group),
                        blk)


def embed_tokens(params: Params, tokens: torch.Tensor,
                 pos_offset=0) -> torch.Tensor:
    """Token + positional embedding, as row lookups whose backward is
    ``F.embedding``'s: deterministic, so ranks that hold a replicated
    embedding (tp ranks, pipeline stages) compute its gradient bit for bit
    alike. (An index's backward accumulates repeated tokens' rows in a
    thread-dependent order on the CPU.)"""
    positions = pos_offset + torch.arange(tokens.shape[-1],
                                          device=tokens.device)
    return (F.embedding(tokens, params["embed"]["w"])
            + F.embedding(positions, params["pos"]["w"]))


def lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final layer norm + vocabulary projection (f32 logits)."""
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return _dense(x, params["head"]["w"]).float()


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            *, seq_group: Optional[DataGroup] = None,
            pos_offset=0) -> torch.Tensor:
    """tokens (B, S_local) -> logits (B, S_local, V). With ``seq_group``
    attention runs as a ring over it; everything else is
    local. Each block is wrapped in the checkpoint that
    ``resolve_lm_policy(cfg.remat)`` names (the identity for ``none``)."""
    x = embed_tokens(params, tokens, pos_offset)

    def block(x, blk):
        return block_forward(cfg, x, blk, seq_group=seq_group)

    block = wrap_checkpoint(block, resolve_lm_policy(cfg.remat))
    for i in range(len([k for k in params if k.startswith("block")])):
        x = block(x, params[f"block{i}"])
    return lm_head(params, x)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -picked.mean()


def transformer_mults(params) -> Dict:
    """(lr_mult, decay_mult) per leaf: weights (names starting with "w")
    decay, gains and biases do not."""
    return {lname: {p: (1.0, 1.0 if p.startswith("w") else 0.0)
                    for p in lp}
            for lname, lp in params.items()}


def _grads(params: Params, loss_fn) -> Tuple[torch.Tensor, Params]:
    """``loss_fn(leaves)`` and its gradient for every leaf (a tree like
    ``params``), by ``torch.autograd.grad``."""
    leaves = {n: {l: v.detach().requires_grad_(True) for l, v in d.items()}
              for n, d in params.items()}
    loss = loss_fn(leaves)
    flat = [v for d in leaves.values() for v in d.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), {n: {l: next(grads) for l in d}
                           for n, d in leaves.items()}


def loss_and_grads(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor, targets: torch.Tensor, *,
                   seq_group: Optional[DataGroup] = None,
                   pos_offset=0) -> Tuple[torch.Tensor, Params]:
    """The LM loss of one batch (this rank's block under ``seq_group``) and
    its gradient for every leaf, through ``forward``."""
    return _grads(params, lambda p: lm_loss(
        forward(p, cfg, tokens, seq_group=seq_group, pos_offset=pos_offset),
        targets))


def sum_over(tree: Params, loss: Optional[torch.Tensor], group: DataGroup,
             kind: str, keys, mean: bool = False
             ) -> Tuple[Params, Optional[torch.Tensor]]:
    """Sum the ``keys`` ((layer, leaf) pairs) of ``tree`` and the loss
    (unless None) over ``group`` (JAX's psum; with ``mean``, divided by
    the group's size: its pmean): one all-reduce of those leaves packed
    into one f32 buffer (counted under ``kind``) and one of the loss.
    Returns (tree, loss), the other leaves as they were; a group of one
    returns them as they are."""
    if group.world == 1:
        return tree, loss
    flat = torch.cat([tree[n][l].reshape(-1) for n, l in keys])
    note_exchange(kind, flat)
    group.all_reduce_(flat)
    if mean:
        flat /= group.world
    out, at = {n: dict(d) for n, d in tree.items()}, 0
    for n, l in keys:
        v = tree[n][l]
        out[n][l] = flat[at:at + v.numel()].view_as(v)
        at += v.numel()
    if loss is not None:
        loss = loss.reshape(1).clone()
        group.all_reduce_(loss)
        loss = loss[0] / group.world if mean else loss[0]
    return out, loss


def average_(tree: Params, loss: torch.Tensor, group: DataGroup):
    """Average every leaf of ``tree`` and the loss over ``group`` (JAX's
    pmean): ``sum_over`` every leaf, divided by the group's size. Returns
    (tree, loss); a group of one returns them as they are."""
    keys = [(n, l) for n in tree for l in tree[n]]
    return sum_over(tree, loss, group, "grad_all_reduce", keys, mean=True)


def build_dp_sp_train_step(cfg: TransformerConfig, sp: SolverParameter,
                           device=None, *,
                           groups: Optional[NamedGroups] = None):
    """The training step of the JAX package's ``build_dp_sp_train_step``:

        step(params, state, tokens, targets) -> (params, state, {"loss"})

    Without ``groups``, one device: tokens and targets are (B, S) integer
    tensors (the causal shift is the caller's, as in JAX), moved to the
    step's device, the card unless the caller passes ``"cpu"``. With
    ``groups`` (this rank's place on a ``(data, seq)`` mesh; the step runs
    on its device) they are this rank's (B/data, S/seq) block: attention
    runs as a ring over the seq group, positions start at the seq index x
    S/seq, and the gradients and the loss are averaged over both axes
    (``average_`` over the mesh's joint group; params stay replicated).
    The update is
    ``make_update_fn(sp, transformer_mults(params))``, the per-leaf rule
    (never the arena, as in JAX), returning new parameter and momentum
    tensors."""
    if groups is None:
        device, seq, sync = resolve_device(device), None, None
    else:
        device, seq, sync = groups.device, groups["seq"], groups.joint
    apply_policy()

    def step(params: Params, state: SolverState, tokens: torch.Tensor,
             targets: torch.Tensor):
        tokens, targets = tokens.to(device), targets.to(device)
        offset = 0 if seq is None else seq.rank * tokens.shape[1]
        loss, grads = loss_and_grads(params, cfg, tokens, targets,
                                     seq_group=seq, pos_offset=offset)
        if sync is not None:
            grads, loss = average_(grads, loss, sync)
        update = make_update_fn(sp, transformer_mults(params))
        new_params, new_state = update(params, grads, state)
        return new_params, new_state, {"loss": loss}

    return step


# ------------------------------------------------------------------------ #
# Tensor parallelism (Megatron): dp x tp over a ("data", "model") mesh

# the dim a tp-sharded block leaf splits on (JAX's tp_param_specs):
# wqkv's head-major rows and w1's rows (column-parallel), wo's and w2's
# input columns (row-parallel); every other leaf is replicated
TP_SPLIT_DIM = {"wqkv": 0, "w1": 0, "wo": 1, "w2": 1}


def _check_tp_divisibility(cfg: TransformerConfig, n_tp: int,
                           tp_axis: str = MODEL_AXIS) -> None:
    if cfg.n_heads % n_tp or cfg.d_ff % n_tp:
        raise ValueError(
            f"n_heads={cfg.n_heads} and d_ff={cfg.d_ff} must both divide "
            f"by the {n_tp} tensor-parallel ranks of axis {tp_axis!r}")


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, an all-reduce of the
    cotangent over the tp group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        note_exchange("tp_all_reduce", g)
        ctx.group.all_reduce_(g)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: an all-reduce over the tp group forward, the
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        note_exchange("tp_all_reduce", y)
        group.all_reduce_(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_fg_ops(tp_group: DataGroup):
    """Megatron's conjugate pair over ``tp_group``: ``f`` (identity
    forward, all-reduce backward) at each column-parallel region's input,
    ``g`` (all-reduce forward, identity backward) after each row-parallel
    product. A raw all-reduce in the differentiated path would double-count
    (JAX's note: its transpose is another all-reduce, which multiplies an
    already-replicated cotangent by the rank count)."""
    def f_op(x):
        return _CopyToTP.apply(x, tp_group)

    def g_op(x):
        return _ReduceFromTP.apply(x, tp_group)

    return f_op, g_op


def tp_block_forward(cfg: TransformerConfig, x: torch.Tensor, blk, f_op,
                     g_op, *, seq_group: Optional[DataGroup] = None
                     ) -> torch.Tensor:
    """One decoder block with this rank's tensor-parallel slices: its heads'
    (q, k, v) rows and FFN columns, the partial outputs summed by ``g_op``.
    With ``seq_group`` this rank's heads attend as a ring over it
    (the ring never crosses heads, so tp and sp compose)."""
    b, s, _ = x.shape
    dh = cfg.d_model // cfg.n_heads
    h = f_op(_layer_norm(x, blk["ln1_g"], blk["ln1_b"]))
    qkv = _dense(h, blk["wqkv"])                  # (B, S, Hl*3*dh)
    hl = qkv.shape[-1] // (3 * dh)                # this rank's heads
    qkv = qkv.reshape(b, s, hl, 3, dh)
    q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))
    att = _attend(q, k, v, seq_group)
    att = att.transpose(1, 2).reshape(b, s, hl * dh)
    x = x + g_op(_dense(att, blk["wo"])).to(x.dtype)
    h = f_op(_layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
    return x + g_op(ffn_product(h, blk["w1"], blk["w2"])).to(x.dtype)


def _relayout_qkv(tree, cfg: TransformerConfig, to_tp: bool):
    dh = cfg.d_model // cfg.n_heads
    shape = ((3, cfg.n_heads) if to_tp else (cfg.n_heads, 3)) + (
        dh, cfg.d_model)
    out = {k: dict(v) for k, v in tree.items()}
    for lname, lp in out.items():
        if lname.startswith("block"):
            lp["wqkv"] = lp["wqkv"].reshape(shape).transpose(0, 1).reshape(
                3 * cfg.d_model, cfg.d_model)
    return out


def to_tp_layout(params, cfg: TransformerConfig):
    """Each block's fused qkv rows from [q heads; k heads; v heads] to
    head-major [(q, k, v) of head 0; ...], so a contiguous row split gives
    each tp rank the whole q, k and v of its heads; other leaves as they
    are. Takes any tree of the params' shapes (the momentum too);
    ``from_tp_layout`` inverts."""
    return _relayout_qkv(params, cfg, True)


def from_tp_layout(params, cfg: TransformerConfig):
    return _relayout_qkv(params, cfg, False)


def _block(v: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    """The ``i``-th of ``n`` even blocks of ``v`` along ``dim``, in storage
    of its own (a view would keep the whole tensor alive on the rank)."""
    size = v.shape[dim] // n
    return v.narrow(dim, i * size, size).clone(
        memory_format=torch.contiguous_format)


def tp_shard(tree, cfg: TransformerConfig, t: int, n_tp: int):
    """Rank ``t`` of ``n_tp``'s slices of a tp-layout tree (JAX's
    ``tp_param_specs``): the ``t``-th of ``n_tp`` even blocks of each
    ``TP_SPLIT_DIM`` leaf, the other leaves whole."""
    _check_tp_divisibility(cfg, n_tp)
    out = {}
    for lname, lp in tree.items():
        out[lname] = dict(lp)
        if lname.startswith("block"):
            for leaf, dim in TP_SPLIT_DIM.items():
                out[lname][leaf] = _block(lp[leaf], dim, t, n_tp)
    return out


def _gather_dim(group: DataGroup, v: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``v`` concatenated along ``dim`` in rank order."""
    if not dim:
        return group.all_gather(v)
    v = group.all_gather(v.transpose(0, dim).contiguous())
    return v.transpose(0, dim).contiguous()


def tp_unshard(tree, tp_group: DataGroup):
    """The full tp-layout tree from every rank's ``tp_shard`` slices (an
    all-gather over ``tp_group`` a sharded leaf, in leaf order on every
    rank)."""
    out = {}
    for lname, lp in tree.items():
        out[lname] = dict(lp)
        if lname.startswith("block"):
            for leaf, dim in TP_SPLIT_DIM.items():
                out[lname][leaf] = _gather_dim(tp_group, lp[leaf], dim)
    return out


def build_dp_tp_train_step(cfg: TransformerConfig, sp: SolverParameter,
                           groups: NamedGroups,
                           seq_axis: Optional[str] = None):
    """The JAX package's ``build_dp_tp_train_step`` over this rank's
    ``(data, model)`` groups, or ``(data, seq, model)`` with
    ``seq_axis``:

        step(params, state, tokens, targets) -> (params, state, {"loss"})

    params and the momentum are this rank's ``tp_shard`` of the tp layout;
    tokens and targets its (B/data, S) block (S/seq with ``seq_axis``).
    Each block runs ``tp_block_forward``; the f/g pair leaves every
    replicated leaf's gradient whole and alike on the tp ranks and every
    sharded leaf's gradient complete locally, so nothing is summed over tp
    (a sum would double-count, JAX's note); everything is averaged over
    the mesh's joint group: data, and seq when the mesh has it (a second
    data-like axis for every leaf)."""
    tp = groups[MODEL_AXIS]
    _check_tp_divisibility(cfg, tp.world)
    seq = groups[seq_axis] if seq_axis is not None else None
    sync, device = groups.joint, groups.device
    f_op, g_op = make_fg_ops(tp)
    apply_policy()

    def block(x, blk):
        return tp_block_forward(cfg, x, blk, f_op, g_op, seq_group=seq)

    block = wrap_checkpoint(block, resolve_lm_policy(cfg.remat))

    def step(params: Params, state: SolverState, tokens: torch.Tensor,
             targets: torch.Tensor):
        tokens, targets = tokens.to(device), targets.to(device)
        offset = 0 if seq is None else seq.rank * tokens.shape[1]

        def loss_fn(p):
            x = embed_tokens(p, tokens, offset)
            for i in range(cfg.n_layers):
                x = block(x, p[f"block{i}"])
            return lm_loss(lm_head(p, x), targets)

        loss, grads = _grads(params, loss_fn)
        grads, loss = average_(grads, loss, sync)
        update = make_update_fn(sp, transformer_mults(params))
        new_params, new_state = update(params, grads, state)
        return new_params, new_state, {"loss": loss}

    return step


# ------------------------------------------------------------------------ #
# Pipeline parallelism (GPipe): dp x pp over a ("data", "stage") mesh

# the dim a tp-sharded leaf of the stacked pp layout splits on: one past
# its TP_SPLIT_DIM, behind the layer axis (JAX's pp_param_specs with
# tp_axis: wqkv and w1 on dim 1, wo and w2 on dim 2)
PP_TP_SPLIT_DIM = {leaf: dim + 1 for leaf, dim in TP_SPLIT_DIM.items()}


def to_pp_layout(params, cfg: TransformerConfig):
    """Stack the block leaves along a leading layer axis: ``{"block0":
    {...}, ...}`` becomes ``{"blocks": {leaf: (n_layers, ...)}}``, the
    other layers as they are (JAX's layout). Takes any tree of the params'
    shapes (the momentum too); ``from_pp_layout`` inverts."""
    out = {k: dict(v) for k, v in params.items() if not k.startswith("block")}
    names = sorted((k for k in params if k.startswith("block")),
                   key=lambda k: int(k[len("block"):]))
    out["blocks"] = {leaf: torch.stack([params[n][leaf] for n in names])
                     for leaf in params[names[0]]}
    return out


def from_pp_layout(params, cfg: TransformerConfig):
    out = {k: dict(v) for k, v in params.items() if k != "blocks"}
    n_layers = next(iter(params["blocks"].values())).shape[0]
    for i in range(n_layers):
        out[f"block{i}"] = {leaf: v[i] for leaf, v in params["blocks"].items()}
    return out


def _check_pp_divisibility(n_layers: int, n_stage: int) -> None:
    if n_layers % n_stage:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"{n_stage} pipeline stages")


def pp_shard(tree, cfg: TransformerConfig, stage: int, n_stage: int,
             t: int = 0, n_tp: int = 1):
    """Stage ``stage`` of ``n_stage``'s part of a pp-layout tree (JAX's
    ``pp_param_specs``): its contiguous run of ``n_layers / n_stage``
    layers of every stacked leaf, the other layers whole. With ``n_tp`` >
    1 (a tree in ``to_pp_layout(to_tp_layout(...))``) each
    ``PP_TP_SPLIT_DIM`` leaf is further cut to tp rank ``t``'s block."""
    n_layers = next(iter(tree["blocks"].values())).shape[0]
    _check_pp_divisibility(n_layers, n_stage)
    if n_tp > 1:
        _check_tp_divisibility(cfg, n_tp)
    per = n_layers // n_stage
    out = {k: dict(v) for k, v in tree.items()}
    for leaf, v in tree["blocks"].items():
        v = v.narrow(0, stage * per, per)
        dim = PP_TP_SPLIT_DIM.get(leaf)
        out["blocks"][leaf] = (_block(v, dim, t, n_tp) if dim is not None
                               else _block(v, 0, 0, 1))
    return out


def pp_unshard(tree, stage_group: Optional[DataGroup],
               tp_group: Optional[DataGroup] = None):
    """The whole pp-layout tree from every rank's ``pp_shard`` part: each
    stacked leaf all-gathered over ``tp_group`` on its ``PP_TP_SPLIT_DIM``
    and over ``stage_group`` on the layer axis (each when given), in leaf
    order on every rank."""
    out = {k: dict(v) for k, v in tree.items()}
    for leaf, v in tree["blocks"].items():
        if tp_group is not None and leaf in PP_TP_SPLIT_DIM:
            v = _gather_dim(tp_group, v, PP_TP_SPLIT_DIM[leaf])
        if stage_group is not None:
            v = stage_group.all_gather(v)
        out["blocks"][leaf] = v
    return out


def build_dp_pp_train_step(cfg: TransformerConfig, sp: SolverParameter,
                           groups: NamedGroups, microbatches: int):
    """The JAX package's ``build_dp_pp_train_step`` over this rank's
    ``(data, stage)`` groups, or ``(data, stage, model)`` (tp on when the
    mesh has the ``model`` axis):

        step(params, state, tokens, targets) -> (params, state, {"loss"})

    params and the momentum are this stage's ``pp_shard`` of the pp
    layout (of ``to_pp_layout(to_tp_layout(...))`` and rank t's tp slices
    with tp); tokens and targets this rank's (B/data, S) rows, split
    into ``microbatches`` microbatches of bm rows.

    The schedule is GPipe's, one process a stage: every microbatch's
    forward in order (stage 0 embeds it, the other stages receive it from
    the previous stage; each stage runs its layers and sends the result
    on; the last stage applies ``ln_f`` and the head and sums the token
    losses), then every backward in reverse microbatch order (the last
    stage from its loss, the others from the cotangent the next stage
    sends back; each stage sends the cotangent of its input back as soon
    as it exists). JAX runs the same ticks as one SPMD scan in which
    every stage executes every tick under masked selects (the embedding
    and head on every stage, kept by the first and last; m + n - 1 ticks,
    the pipe's fill and drain on garbage) and differentiates it whole;
    the port runs only the live work. The same microbatches pass through
    the same layers in the same order, and the selects JAX masks with add
    exact zeros, so both compute the same function and the same
    gradients: the loss is the sum of the retired microbatches' token
    losses over ``m * bm * S``, summed over stage (it lives on the last
    stage) and averaged over data.

    Gradients: block leaves stay stage-local (their cotangents arrive
    from the next stage). Embed and pos get gradient on stage 0 only,
    ``head`` and ``ln_f`` on the last stage only; each is summed over the
    stage group with zeros elsewhere, so the sum is exact and every
    stage's copy stays bitwise alike; never over ``model`` (the f/g pair
    leaves them whole on every tp rank, as in JAX). Then everything is
    averaged over data (``average_`` over the mesh's joint group, which
    holds ``data`` alone) and ``make_update_fn(sp, transformer_mults(p))``
    updates each leaf. With tp each layer runs ``tp_block_forward``
    between the f/g pair over the model group (the 3-D dp x pp x tp
    step).

    Remat: under ``cfg.remat`` one tick is
    checkpointed: a stage's whole run of layers for one microbatch, as
    JAX checkpoints its tick (the embedding and the head sit outside the
    port's checkpoint; JAX recomputes them inside its tick, which changes
    no value). Requires n_layers % n_stage == 0 and local batch %
    microbatches == 0 (JAX's messages)."""
    stage = groups[STAGE_AXIS]
    n_stage = stage.world
    _check_pp_divisibility(cfg.n_layers, n_stage)
    per = cfg.n_layers // n_stage
    first, last = stage.rank == 0, stage.rank == n_stage - 1
    sync, device = groups.joint, groups.device
    if MODEL_AXIS in groups.axes:
        model = groups[MODEL_AXIS]
        _check_tp_divisibility(cfg, model.world)
        f_op, g_op = make_fg_ops(model)

        def layer(h, blk):
            return tp_block_forward(cfg, h, blk, f_op, g_op)
    else:
        def layer(h, blk):
            return block_forward(cfg, h, blk)

    def run_stage(x, blocks):
        for i in range(per):
            x = layer(x, {leaf: v[i] for leaf, v in blocks.items()})
        return x

    tick = wrap_checkpoint(run_stage, resolve_lm_policy(cfg.remat))
    # the leaves this stage's work reaches; the others get zero gradient
    reach = ["blocks"] + (["embed", "pos"] if first else []) + (
        ["ln_f", "head"] if last else [])
    apply_policy()

    def step(params: Params, state: SolverState, tokens: torch.Tensor,
             targets: torch.Tensor):
        tokens, targets = tokens.to(device), targets.to(device)
        b_local, s_len = tokens.shape
        m = microbatches
        if b_local % m:
            raise ValueError(f"local batch {b_local} not divisible by "
                             f"{m} microbatches")
        bm = b_local // m
        tok_mb = tokens.reshape(m, bm, s_len)
        tgt_mb = targets.reshape(m, bm, s_len)
        n_tokens = float(m * bm * s_len)
        p = {n: {l: v.detach().requires_grad_(n in reach)
                 for l, v in d.items()} for n, d in params.items()}
        keys = [(n, l) for n in p if n in reach for l in p[n]]
        wrt = [p[n][l] for n, l in keys]
        loss = torch.zeros((), device=device)
        live = []
        for j in range(m):
            if first:
                x = embed_tokens(p, tok_mb[j])
            else:
                x = torch.empty((bm, s_len, cfg.d_model), device=device)
                stage.shift_(None, x, 1)
                x.requires_grad_(True)
            y = tick(x, p["blocks"])
            if last:
                logp = torch.log_softmax(lm_head(p, y), dim=-1)
                picked = torch.gather(logp, -1, tgt_mb[j][..., None].long())
                y = -picked.sum() / n_tokens
                loss = loss + y.detach()
            else:
                note_exchange("pp_activation", y)
                stage.shift_(y.detach(), None, 1)
            live.append((x, y))
        acc = None
        for j in reversed(range(m)):
            x, y = live.pop()
            g_y = None
            if not last:
                g_y = torch.empty_like(y)
                stage.shift_(None, g_y, -1)
            gs = torch.autograd.grad(y, wrt + ([] if first else [x]), g_y)
            if not first:
                note_exchange("pp_cotangent", gs[-1])
                stage.shift_(gs[-1], None, -1)
                gs = gs[:-1]
            acc = list(gs) if acc is None else [a + g for a, g in
                                                zip(acc, gs)]
            del x, y
        got = dict(zip(keys, acc))
        grads = {n: {l: got[(n, l)] if (n, l) in got else torch.zeros_like(v)
                     for l, v in d.items()} for n, d in p.items()}
        grads, loss = sum_over(grads, loss, stage, "pp_stage_all_reduce",
                               [(n, l) for n in grads if n != "blocks"
                                for l in grads[n]])
        grads, loss = average_(grads, loss, sync)
        update = make_update_fn(sp, transformer_mults(params))
        new_params, new_state = update(params, grads, state)
        return new_params, new_state, {"loss": loss}

    return step
