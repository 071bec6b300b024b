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

``build_dp_sp_train_step`` is the one-device counterpart of the JAX
package's data x seq step: the loss, the gradients by ``torch.autograd``,
and the per-leaf SGD rule. Larger data or seq axes (NCCL, ring attention),
the tp/pp steps and MoE blocks wait for later slices.
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


def attention_sublayer(cfg: TransformerConfig, x: torch.Tensor, blk,
                       *, seq_axis: Optional[str] = None) -> torch.Tensor:
    """ln1 -> fused qkv -> flash attention -> wo residual."""
    if seq_axis is not None:
        raise NotImplementedError(
            "ring attention over a sequence axis is not ported yet "
            "(ROADMAP, queue A: the LM family's sequence parallelism)")
    b, s, _ = x.shape
    h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
    qkv = _dense(h, blk["wqkv"])                       # (B, S, 3*D)
    d_head = cfg.d_model // cfg.n_heads
    qkv = qkv.reshape(b, s, 3, cfg.n_heads, d_head)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # (B,H,S,Dh)
    att = maybe_flash_attention(q, k, v, causal=True)
    att = att.transpose(1, 2).reshape(b, s, cfg.d_model)
    return x + _dense(att, blk["wo"]).to(x.dtype)


def ffn_sublayer(x: torch.Tensor, blk) -> torch.Tensor:
    """ln2 -> tanh-GELU FFN -> residual."""
    h = _layer_norm(x, blk["ln2_g"], blk["ln2_b"])
    ff = _dense(F.gelu(_dense(h, blk["w1"]), approximate="tanh"), blk["w2"])
    return x + ff.to(x.dtype)


def block_forward(cfg: TransformerConfig, x: torch.Tensor, blk,
                  *, seq_axis: Optional[str] = None) -> torch.Tensor:
    """One decoder block: attention sublayer + GELU FFN residual."""
    return ffn_sublayer(attention_sublayer(cfg, x, blk, seq_axis=seq_axis),
                        blk)


def embed_tokens(params: Params, tokens: torch.Tensor,
                 pos_offset=0) -> torch.Tensor:
    """Token + positional embedding."""
    positions = pos_offset + torch.arange(tokens.shape[-1],
                                          device=tokens.device)
    return params["embed"]["w"][tokens] + params["pos"]["w"][positions]


def lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final layer norm + vocabulary projection (f32 logits)."""
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return _dense(x, params["head"]["w"]).float()


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            *, seq_axis: Optional[str] = None,
            pos_offset=0) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V). Each block is wrapped in the
    checkpoint that ``resolve_lm_policy(cfg.remat)`` names (the identity
    for ``none``)."""
    x = embed_tokens(params, tokens, pos_offset)

    def block(x, blk):
        return block_forward(cfg, x, blk, seq_axis=seq_axis)

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


def loss_and_grads(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor,
                   targets: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """The LM loss of one batch and its gradient for every leaf (a tree
    like ``params``), by ``torch.autograd.grad`` through ``forward``."""
    leaves = {n: {l: v.detach().requires_grad_(True) for l, v in d.items()}
              for n, d in params.items()}
    loss = lm_loss(forward(leaves, cfg, tokens), targets)
    flat = [v for d in leaves.values() for v in d.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), {n: {l: next(grads) for l in d}
                           for n, d in leaves.items()}


def build_dp_sp_train_step(cfg: TransformerConfig, sp: SolverParameter,
                           device=None):
    """One training step on one device, the counterpart of the JAX
    package's ``build_dp_sp_train_step`` on a (1, 1) data x seq mesh:

        step(params, state, tokens, targets) -> (params, state, {"loss"})

    tokens and targets are (B, S) integer tensors, moved to the step's
    device (the causal shift is the caller's, as in JAX). The gradients
    come from ``loss_and_grads``; the update is ``make_update_fn(sp,
    transformer_mults(params))``, the per-leaf rule (never the arena, as
    in JAX), returning new parameter and momentum tensors. ``device`` is the
    card unless the caller passes ``"cpu"``. Data-parallel LM training and
    ring attention over a seq axis (ROADMAP queue A item 10) are not
    ported."""
    device = resolve_device(device)
    apply_policy()

    def step(params: Params, state: SolverState, tokens: torch.Tensor,
             targets: torch.Tensor):
        loss, grads = loss_and_grads(params, cfg, tokens.to(device),
                                     targets.to(device))
        update = make_update_fn(sp, transformer_mults(params))
        new_params, new_state = update(params, grads, state)
        return new_params, new_state, {"loss": loss}

    return step
