"""Checkpoint/resume for the LM family (the port of
``poseidon_tpu/runtime/lm_checkpoint.py``).

``save_lm`` writes ``<prefix>_iter_N.lmstate.npz`` with the JAX package's
keys: ``iter``, one array per leaf under ``params/`` and ``history/`` (tree
keys joined by ``runtime/checkpoint``'s separator), through a temporary
name and an atomic rename. ``restore_lm`` rebuilds ``(params,
SolverState)`` as CPU tensors. A snapshot written by either package loads
in the other.

Snapshots are always in the canonical layout (per-block dicts, one-device
shapes). The port's LM trees are canonical already (sp on one device), so
nothing is undone before writing; the JAX package's tp and pp layouts wait
for those steps' port.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..solvers.updates import SolverState
from .checkpoint import _flatten, _unflatten, latest_snapshot


def save_lm(prefix: str, params: Dict, state: SolverState) -> str:
    """Write ``<prefix>_iter_N.lmstate.npz`` (N = ``state.it``); returns its
    path."""
    it = int(state.it)
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    path = f"{prefix}_iter_{it}.lmstate.npz"
    arrays = {"iter": np.asarray(it)}
    arrays.update({f"params/{k}": v for k, v in _flatten(params).items()})
    arrays.update({f"history/{k}": v
                   for k, v in _flatten(state.history).items()})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def restore_lm(path: str) -> Tuple[Dict, SolverState]:
    """(params, SolverState) from a canonical snapshot, as CPU tensors."""
    groups: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "history": {}}
    with np.load(path) as z:
        it = int(z["iter"])
        for key in z.files:
            head, _, rest = key.partition("/")
            if head in groups:
                groups[head][rest] = z[key]
    return (_unflatten(groups["params"]),
            SolverState(it=it, history=_unflatten(groups["history"])))


def latest_lm_snapshot(prefix: str) -> Optional[str]:
    """The newest ``<prefix>_iter_<N>.lmstate.npz`` by N, or None."""
    return latest_snapshot(prefix, suffix=".lmstate.npz")
