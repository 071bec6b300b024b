"""Checkpoint/resume for the LM family (the port of
``poseidon_tpu/runtime/lm_checkpoint.py``).

``save_lm`` writes ``<prefix>_iter_N.lmstate.npz`` with the JAX package's
keys: ``iter``, one array per leaf under ``params/`` and ``history/`` (tree
keys joined by ``runtime/checkpoint``'s separator), through a temporary
name and an atomic rename. ``restore_lm`` rebuilds ``(params,
SolverState)`` as CPU tensors. A snapshot written by either package loads
in the other.

Snapshots are always in the canonical layout (per-block dicts, one-device
shapes), so a run under one parallelism resumes under another.
``layout`` names the transforms the live trees carry, as in JAX: ``()``
for sp (canonical already) and ``("tp",)`` for tp. A tp rank's trees are
its ``tp_shard`` slices: with ``tp_group`` they are all-gathered over it
first (every rank of the group calls ``save_lm``, and every rank writes
the same bytes), then ``from_tp_layout`` undoes the head-major qkv rows.
``restore_lm(path, cfg, layout=("tp",))`` re-applies the layout to the
whole tree; the tp step takes the rank's ``tp_shard`` of it. The pipeline
layout (``"pp"``) waits for the pipeline step (ROADMAP A.10).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..solvers.updates import SolverState
from .checkpoint import _flatten, _unflatten, latest_snapshot


def _check_layout(layout: Sequence[str], cfg) -> Tuple[str, ...]:
    layout = tuple(layout)
    for name in layout:
        if name == "pp":
            raise NotImplementedError(
                "the pipeline layout ('pp') waits for the pipeline step "
                "(ROADMAP A.10, its next part)")
        if name != "tp":
            raise ValueError(f"unknown LM layout {name!r} (want 'tp')")
    if layout and cfg is None:
        raise ValueError(f"layout {layout} needs the model's cfg")
    return layout


def _canonical(tree: Dict, cfg, layout, tp_group) -> Dict:
    from ..models.transformer import from_tp_layout, tp_unshard
    if "tp" in layout:
        if tp_group is not None:
            tree = tp_unshard(tree, tp_group)
        tree = from_tp_layout(tree, cfg)
    return tree


def save_lm(prefix: str, params: Dict, state: SolverState, cfg=None, *,
            layout: Sequence[str] = (), tp_group=None) -> str:
    """Write ``<prefix>_iter_N.lmstate.npz`` (N = ``state.it``) in the
    canonical layout; returns its path. ``layout`` names the transforms
    ``params`` and the momentum carry; ``tp_group`` (a tp rank's group)
    gathers their shards first."""
    layout = _check_layout(layout, cfg)
    params = _canonical(params, cfg, layout, tp_group)
    history = _canonical(state.history, cfg, layout, tp_group)
    it = int(state.it)
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    path = f"{prefix}_iter_{it}.lmstate.npz"
    arrays = {"iter": np.asarray(it)}
    arrays.update({f"params/{k}": v for k, v in _flatten(params).items()})
    arrays.update({f"history/{k}": v for k, v in _flatten(history).items()})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def restore_lm(path: str, cfg=None, *,
               layout: Sequence[str] = ()) -> Tuple[Dict, SolverState]:
    """(params, SolverState) from a canonical snapshot, as CPU tensors,
    with ``layout`` re-applied for the resuming topology (which need not
    match the saving one)."""
    from ..models.transformer import to_tp_layout
    layout = _check_layout(layout, cfg)
    groups: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "history": {}}
    with np.load(path) as z:
        it = int(z["iter"])
        for key in z.files:
            head, _, rest = key.partition("/")
            if head in groups:
                groups[head][rest] = z[key]
    params = _unflatten(groups["params"])
    history = _unflatten(groups["history"])
    if "tp" in layout:
        params, history = to_tp_layout(params, cfg), to_tp_layout(history,
                                                                  cfg)
    return params, SolverState(it=it, history=history)


def latest_lm_snapshot(prefix: str) -> Optional[str]:
    """The newest ``<prefix>_iter_<N>.lmstate.npz`` by N, or None."""
    return latest_snapshot(prefix, suffix=".lmstate.npz")
