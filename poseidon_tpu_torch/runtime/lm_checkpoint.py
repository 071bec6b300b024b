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
``layout`` names the transforms the live trees carry, in the order they
were applied, as in JAX: ``()`` for sp and ep (canonical already),
``("tp",)`` for tp, ``("pp",)`` for pp and ``("tp", "pp")`` for the 3-D
step (``to_pp_layout(to_tp_layout(...))``). A rank's trees are its
shards; the groups gather them first (every rank of a group calls
``save_lm``, and every rank writes the same bytes): ``tp_group`` a tp
rank's ``tp_shard`` slices (under ``"pp"``, the stacked leaves' slices
one dim further in), ``pp_group`` a stage's run of layers (``pp_shard``),
``ep_group`` an MoE tree's experts (``ep_shard``). Then the layouts are
undone in reverse order (``from_pp_layout``, ``from_tp_layout``).
``restore_lm(path, cfg, layout=...)`` re-applies the layouts to the whole
tree; a step takes its rank's shard of it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..solvers.updates import SolverState
from .checkpoint import _flatten, _unflatten, latest_snapshot


_LAYOUTS = ("tp", "pp")


def _check_layout(layout: Sequence[str], cfg) -> Tuple[str, ...]:
    layout = tuple(layout)
    for name in layout:
        if name not in _LAYOUTS:
            raise ValueError(f"unknown LM layout {name!r} (want one of "
                             f"{_LAYOUTS})")
    if layout and cfg is None:
        raise ValueError(f"layout {layout} needs the model's cfg")
    return layout


def _canonical(tree: Dict, cfg, layout, tp_group, pp_group,
               ep_group) -> Dict:
    from ..models import transformer as tfm
    from ..models.moe import ep_unshard
    if ep_group is not None:
        tree = ep_unshard(tree, ep_group)
    if "pp" in layout:
        tree = tfm.pp_unshard(tree, pp_group,
                              tp_group if "tp" in layout else None)
    elif "tp" in layout and tp_group is not None:
        tree = tfm.tp_unshard(tree, tp_group)
    undo = {"tp": tfm.from_tp_layout, "pp": tfm.from_pp_layout}
    for name in reversed(layout):
        tree = undo[name](tree, cfg)
    return tree


def save_lm(prefix: str, params: Dict, state: SolverState, cfg=None, *,
            layout: Sequence[str] = (), tp_group=None, pp_group=None,
            ep_group=None) -> str:
    """Write ``<prefix>_iter_N.lmstate.npz`` (N = ``state.it``) in the
    canonical layout; returns its path. ``layout`` names the transforms
    ``params`` and the momentum carry; ``tp_group``, ``pp_group`` and
    ``ep_group`` (this rank's groups) gather their shards first."""
    layout = _check_layout(layout, cfg)
    params, history = (_canonical(t, cfg, layout, tp_group, pp_group,
                                  ep_group)
                       for t in (params, state.history))
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
    from ..models.transformer import to_pp_layout, to_tp_layout
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
    redo = {"tp": to_tp_layout, "pp": to_pp_layout}
    for name in layout:
        params, history = redo[name](params, cfg), redo[name](history, cfg)
    return params, SolverState(it=it, history=history)


def latest_lm_snapshot(prefix: str) -> Optional[str]:
    """The newest ``<prefix>_iter_<N>.lmstate.npz`` by N, or None."""
    return latest_snapshot(prefix, suffix=".lmstate.npz")
