"""Caffe-exact learning-rate policies and optimizer update rules (the port
of ``poseidon_tpu/solvers/updates.py``).

Spec: ``src/caffe/solver.cpp``
- LR policies fixed/step/exp/inv/poly/sigmoid/multistep (GetLearningRate),
  computed in f32 as the JAX package computes them;
- SGD:      g' = g + decay*reg(w); h = m*h + local_lr*g'; w -= h
- Nesterov: h' = m*h + local_lr*g'; w -= (1+m)*h' - m*h
- AdaGrad:  h += g'^2; w -= local_lr * g' / (sqrt(h)+delta)
Regularization: L2 adds decay*w to the gradient, L1 adds decay*sign(w);
local_lr = rate * lr_mult, local_decay = weight_decay * decay_mult.

``make_update_fn`` is the per-leaf rule over a parameter tree (the LM
step's update). The flat rule (``make_flat_update_rule``) runs over the
parameter arena with per-segment multiplier vectors and updates w and h
in place. Its SGD + L2 arm — Caffe's default and AlexNet's solver — is
the fused kernel of ``ops/sgd.py`` (CUDA on the card, the plain version
on the CPU); the other arms (Nesterov, AdaGrad, L1) are plain tensor
formulas: the kernel does not compute them.

A step's rate reaches the flat rule as a host float, or as a 0-d f32
tensor on the arena's device (``learning_rates`` gives K steps' at
once): the form a CUDA graph of K steps takes, whose replays read the
rates the host wrote before each replay, so no arm freezes the captured
step's rate (every arm multiplies it into ``lr_vec`` as a tensor either
way, so the two forms give the same bits).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..ops.sgd import sgd_update_
from ..proto.messages import SolverParameter


def learning_rate(sp: SolverParameter, it: int) -> float:
    """The rate at iteration ``it``, computed in f32 (returned as the
    Python float of that f32 value)."""
    f32 = torch.float32
    itf = torch.tensor(float(it), dtype=f32)
    base = torch.tensor(sp.base_lr, dtype=f32)
    policy = sp.lr_policy
    if policy == "fixed":
        rate = base
    elif policy == "step":
        current_step = torch.floor(itf / sp.stepsize)
        rate = base * torch.pow(torch.tensor(sp.gamma, dtype=f32),
                                current_step)
    elif policy == "exp":
        rate = base * torch.pow(torch.tensor(sp.gamma, dtype=f32), itf)
    elif policy == "inv":
        rate = base * torch.pow(1.0 + sp.gamma * itf, -sp.power)
    elif policy == "poly":
        rate = base * torch.pow(1.0 - itf / sp.max_iter, sp.power)
    elif policy == "sigmoid":
        rate = base * (1.0 / (1.0 + torch.exp(-sp.gamma
                                               * (itf - sp.stepsize))))
    elif policy == "multistep":
        steps = torch.tensor(list(sp.stepvalue), dtype=f32)
        current_step = (itf >= steps).sum().to(f32)
        rate = base * torch.pow(torch.tensor(sp.gamma, dtype=f32),
                                current_step)
    else:
        raise ValueError(f"unknown lr_policy {policy!r}")
    return float(rate)


def learning_rates(sp: SolverParameter, it0: int, k: int) -> torch.Tensor:
    """The rates of iterations it0 .. it0+k-1 (``learning_rate``'s f32
    values) as a (k,) f32 host tensor."""
    return torch.tensor([learning_rate(sp, it0 + i) for i in range(k)],
                        dtype=torch.float32)


class SolverState(NamedTuple):
    it: int                 # current iteration
    history: Dict           # momentum / accumulated squared grads, like params


def init_state(params) -> SolverState:
    history = {l: {p: torch.zeros_like(v) for p, v in d.items()}
               for l, d in params.items()}
    return SolverState(it=0, history=history)


def _regularized(g, w, local_decay: float, reg_type: str):
    if local_decay == 0.0:
        return g
    if reg_type == "L2":
        return g + local_decay * w
    if reg_type == "L1":
        return g + local_decay * torch.sign(w)
    raise ValueError(f"unknown regularization_type {reg_type!r}")


def _leafwise_update(sp: SolverParameter, mults, rate: float, params, grads,
                     history):
    """One optimizer step over a per-leaf tree (the JAX package's classic
    path): returns (new params, new history) as new tensors."""
    momentum = sp.momentum
    new_params: Dict = {}
    new_hist: Dict = {}
    for lname, lparams in params.items():
        new_params[lname] = {}
        new_hist[lname] = {}
        for pname, w in lparams.items():
            lr_mult, decay_mult = mults[lname][pname]
            local_rate = torch.tensor(rate, dtype=torch.float32) * lr_mult
            local_rate = local_rate.to(w.device)
            h = history[lname][pname]
            g = _regularized(grads[lname][pname].float(), w,
                             sp.weight_decay * decay_mult,
                             sp.regularization_type)
            if sp.solver_type == "SGD":
                h_new = momentum * h + local_rate * g
                step = h_new
            elif sp.solver_type == "NESTEROV":
                h_new = momentum * h + local_rate * g
                step = (1.0 + momentum) * h_new - momentum * h
            elif sp.solver_type == "ADAGRAD":
                h_new = h + g * g
                step = local_rate * g / (torch.sqrt(h_new) + sp.delta)
            else:
                raise ValueError(f"unknown solver_type {sp.solver_type!r}")
            new_params[lname][pname] = w - step
            new_hist[lname][pname] = h_new
    return new_params, new_hist


def make_update_fn(sp: SolverParameter, mults: Dict[str, Dict[str, tuple]]):
    """update(params, grads, state) -> (params, state): the per-leaf rule
    over a ``{layer: {leaf: tensor}}`` tree at ``learning_rate(sp,
    state.it)``, returning new parameter and history tensors and
    ``state.it + 1``. ``mults`` maps layer -> leaf -> (lr_mult,
    decay_mult). The LM train step's update, as in the JAX package (never
    the arena or the fused kernel)."""
    def update(params, grads, state: SolverState):
        rate = learning_rate(sp, state.it)
        with torch.no_grad():
            new_params, new_hist = _leafwise_update(
                sp, mults, rate, params, grads, state.history)
        return new_params, SolverState(it=state.it + 1, history=new_hist)

    return update


def make_flat_update_rule(sp: SolverParameter, sgd_update=sgd_update_):
    """The flat update rule over the arena, in place:
    update(flat_w, flat_g, flat_h, rate, lr_vec, decay_vec) writes the new
    w and h into flat_w and flat_h; ``rate`` is a float or a 0-d f32
    tensor on the arena's device. SGD + L2 goes to ``sgd_update`` (the
    fused kernel by default; chip_smoke.py passes the plain version to hold
    a step against it)."""
    solver_type = sp.solver_type
    momentum = sp.momentum
    reg_type = sp.regularization_type
    delta = sp.delta
    if solver_type not in ("SGD", "NESTEROV", "ADAGRAD"):
        raise ValueError(f"unknown solver_type {solver_type!r}")
    if reg_type not in ("L2", "L1"):
        raise ValueError(f"unknown regularization_type {reg_type!r}")

    def update(flat_w, flat_g, flat_h, rate, lr_vec, decay_vec):
        if solver_type == "SGD" and reg_type == "L2":
            sgd_update(flat_w, flat_g, flat_h, rate, lr_vec, decay_vec,
                       momentum)
            return
        if not isinstance(rate, torch.Tensor):
            rate = torch.tensor(rate, dtype=torch.float32,
                                device=flat_w.device)
        local_rate = rate * lr_vec
        g = flat_g.float()
        reg = flat_w if reg_type == "L2" else torch.sign(flat_w)
        # the elementwise form of the per-leaf local_decay == 0 skip
        g = torch.where(decay_vec == 0.0, g, g + decay_vec * reg)
        if solver_type == "SGD":
            h_new = momentum * flat_h + local_rate * g
            step = h_new
        elif solver_type == "NESTEROV":
            h_new = momentum * flat_h + local_rate * g
            step = (1.0 + momentum) * h_new - momentum * flat_h
        else:  # ADAGRAD
            h_new = flat_h + g * g
            step = local_rate * g / (torch.sqrt(h_new) + delta)
        flat_w.sub_(step)
        flat_h.copy_(h_new)

    return update


def make_arena_update_fn(sp: SolverParameter, layout, device,
                         sgd_update=sgd_update_):
    """The arena step's optimizer update: one flat pass over the whole
    buffer with the layout's multiplier vectors (placed on ``device``
    once).

    update(flat_w, flat_g, flat_h, it, rate=None) -> the rate it used;
    flat_w and flat_h are updated in place. ``rate`` (a 0-d device tensor
    holding ``learning_rate(sp, it)``) replaces the host float."""
    rule = make_flat_update_rule(sp, sgd_update)
    lr_np, decay_np = layout.mult_vectors(sp.weight_decay)
    lr_vec = torch.from_numpy(lr_np).to(device)
    decay_vec = torch.from_numpy(decay_np).to(device)

    def update(flat_w, flat_g, flat_h, it: int, rate=None):
        if rate is None:
            rate = learning_rate(sp, it)
        rule(flat_w, flat_g, flat_h, rate, lr_vec, decay_vec)
        return rate

    return update
