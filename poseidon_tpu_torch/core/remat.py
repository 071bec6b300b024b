"""Rematerialization policies of the transformer family (the LM half of
``poseidon_tpu/core/remat.py:42-121``), on ``torch.utils.checkpoint``.

A checkpointed block keeps fewer of its forward activations for the
backward pass and recomputes the rest there: device memory drops from
O(layers x S x D) stored activations to about one block's worth, for about
one more forward pass of work. The policy names are the JAX package's:

- ``none``: no checkpoint, every block's internals are stored;
- ``dots_saveable``: checkpoint the block but keep the matrix products'
  results (``aten.mm``/``addmm``/``bmm``, through a selective-checkpoint
  context), recomputing the elementwise tissue between them;
- ``nothing_saveable``: keep only each block's inputs (the legacy
  ``remat=True``);
- ``auto``: follow a plan row (``resolve_lm_policy``).

Remat moves when activations are computed, never what: the recomputed
forward replays the same operations on the same inputs, so the loss is
bitwise equal across policies and the gradients equal to within the
summation orders of a recomputed graph. A custom autograd Function such as
flash attention is not a matrix product, so every checkpointing policy
recomputes it in the backward pass (its kernel launches again).

The measured HBM planner (``RematPlan``, ``plan_remat`` and the peak
measurements behind them) is not ported: it raises, naming ROADMAP queue A
item 11.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("none", "dots_saveable", "nothing_saveable", "auto")

_NO_PLANNER = ("the measured remat planner (RematPlan, plan_remat) is not "
               "ported yet (ROADMAP, queue A item 11); pass a policy name")

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)


def normalize_policy(value) -> str:
    """Fold the legacy bool flag and the enum spellings into one policy
    name: ``True`` is ``nothing_saveable`` (a bare checkpoint saves
    nothing), ``False``/``None``/``""`` are ``none``."""
    if value is None or value is False or value == "":
        return "none"
    if value is True:
        return "nothing_saveable"
    v = str(value).lower()
    if v not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {value!r}; choose from {REMAT_POLICIES}")
    return v


def resolve_lm_policy(cfg_remat, plan_policy=None) -> str:
    """The effective policy from the config flag and an (optional) plan
    row, refusing on disagreement, exactly as the JAX package resolves it.

    ``False`` (the dataclass default) is unset: a plan may enable remat
    under it. ``True`` and the string spellings are explicit: one that
    contradicts a concrete plan value raises. ``auto`` (either side) defers
    to the other; when both defer, ``dots_saveable`` applies."""
    plan = normalize_policy(plan_policy) if plan_policy is not None \
        else None
    explicit = cfg_remat is not None and cfg_remat is not False \
        and cfg_remat != ""
    cfg = normalize_policy(cfg_remat)
    if cfg == "auto":
        explicit = False
        cfg = "dots_saveable" if plan is None else plan
    if plan is None or plan == "auto":
        return "dots_saveable" if (plan == "auto" and not explicit) else cfg
    if explicit and cfg != plan:
        raise ValueError(
            f"remat policy conflict: config says {cfg!r} but the plan "
            f"says {plan!r} — drop the explicit flag (or set remat="
            f"'auto') to follow the plan, or retire the plan row")
    return plan if not explicit else cfg


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_policy(name: str):
    """The selective-checkpoint policy function of one enum member (None for
    ``nothing_saveable``: a plain checkpoint)."""
    name = normalize_policy(name)
    if name in ("none", "auto"):
        raise ValueError(f"policy {name!r} does not name a checkpoint "
                         f"policy; resolve it first")
    return _save_dots if name == "dots_saveable" else None


def wrap_checkpoint(fn, policy_name: str):
    """``fn`` wrapped in a non-reentrant ``torch.utils.checkpoint`` under
    ``policy_name`` (identity for ``none``)."""
    policy_name = normalize_policy(policy_name)
    if policy_name == "none":
        return fn
    pol = checkpoint_policy(policy_name)
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    pol) if pol is not None else None)

    @functools.wraps(fn)
    def wrapped(*args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


class RematPlan:
    """The measured per-layer plan: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NO_PLANNER)


def plan_remat(*args, **kwargs):
    """The greedy cheapest-recompute knapsack: not ported."""
    raise NotImplementedError(_NO_PLANNER)
