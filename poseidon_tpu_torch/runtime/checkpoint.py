"""Snapshots: ``.solverstate.npz`` + ``.caffemodel`` (numpy only), in the
JAX package's format (``poseidon_tpu/runtime/checkpoint.py``), so
snapshots cross-load both ways.

- ``snapshot()`` writes ``<prefix>_iter_<N>.caffemodel`` (a Caffe
  NetParameter binary) and ``<prefix>_iter_<N>.solverstate.npz`` with
  ``iter``, ``kind = "dense"``, one array per leaf under ``params/`` and
  ``history/``, and the TOPK residuals under ``comm_error/``, stacked
  ``(groups, *shape)`` as the caller gathered them
  (``TrainStep.gather_comm_error``; none without a TOPK layer). Tree keys
  join layer and param names with the ASCII unit separator (layer names may
  contain '/'). Both files are written to a temporary name and renamed.
- ``restore()`` rebuilds (params, TrainState) from a dense .npz as CPU
  tensors; ``restore_params`` reads the params alone.
- ``load_caffemodel`` merges a .caffemodel's weights through
  ``net.load_weights`` (Caffe's CopyTrainedLayersFrom).
- ``AsyncSnapshotWriter`` takes the host copy at the sync point and runs
  ``snapshot()`` on a background thread, one write in flight.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..proto.wire import decode_caffemodel, encode_caffemodel

_SEP = "\x1f"


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + _SEP))
        else:
            out[key] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v))
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return tree


def snapshot_paths(prefix: str, state) -> Tuple[str, str]:
    it = int(state.solver.it)
    return (f"{prefix}_iter_{it}.caffemodel",
            f"{prefix}_iter_{it}.solverstate.npz")


def snapshot(prefix: str, net, params, state) -> Tuple[str, str]:
    """Write both artifacts (tmp + atomic rename); returns their paths."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    model_path, state_path = snapshot_paths(prefix, state)
    pid = os.getpid()
    tmp = f"{model_path}.tmp.{pid}"
    with open(tmp, "wb") as f:
        f.write(encode_caffemodel(net.name or "net",
                                  net.export_weights(params)))
    os.replace(tmp, model_path)

    arrays = {"iter": np.asarray(int(state.solver.it)),
              "kind": np.asarray("dense")}
    arrays.update({f"params/{k}": v for k, v in _flatten(params).items()})
    arrays.update({f"history/{k}": v
                   for k, v in _flatten(state.solver.history).items()})
    arrays.update({f"comm_error/{k}": v
                   for k, v in _flatten(state.comm_error).items()})
    tmp = f"{state_path}.tmp.{pid}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, state_path)
    return model_path, state_path


def host_state_copy(params, state):
    """CPU copies of (params, TrainState): the snapshot's sync point (the
    copy off the card waits for the steps that produced the values)."""
    from ..parallel.trainer import TrainState
    from ..solvers.updates import SolverState

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict)
                else v.detach().to("cpu", copy=True) for k, v in tree.items()}

    return copy(params), TrainState(
        solver=SolverState(it=int(state.solver.it),
                           history=copy(state.solver.history)),
        comm_error=copy(state.comm_error))


class AsyncSnapshotWriter:
    """Snapshot serialization off the training loop's critical path.

    ``submit()`` takes the host copy on the caller's thread (the only sync
    point), then hands ``snapshot()`` — encoding and the atomic tmp-rename
    of both files — to a daemon thread. At most one write is in flight: a
    new ``submit`` first joins the previous one. A write's failure is
    re-raised, with its own exception, by the next ``submit()`` or
    ``wait()``: the loop calls one at every snapshot boundary and at the
    end of training, so a lost snapshot aborts the run at the next sync
    boundary. A write torn by process death leaves at worst
    ``*.tmp.<pid>`` files: only the rename creates the real names."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last: Optional[Tuple[str, str]] = None

    def submit(self, prefix: str, net, params, state) -> Tuple[str, str]:
        """Queue one snapshot; returns the (model, state) paths the write
        will land at. Blocks only for the host copy (and any write still
        running)."""
        self.wait()
        host_params, host_state = host_state_copy(params, state)

        def _write():
            try:
                self._last = snapshot(prefix, net, host_params, host_state)
            except BaseException as e:  # noqa: BLE001 — surfaced on join
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="AsyncSnapshotWriter")
        self._thread.start()
        return snapshot_paths(prefix, host_state)

    def wait(self) -> Optional[Tuple[str, str]]:
        """Join the write in flight, if any; re-raise its failure; return
        the last completed (model, state) paths."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            from .metrics import log
            log(f"async snapshot write FAILED ({type(err).__name__}: {err}); "
                f"the snapshot it was writing does not exist — aborting at "
                f"this sync boundary")
            raise err
        return self._last

    def close(self) -> None:
        self.wait()


def restore(state_path: str):
    """(params, TrainState) from a dense .solverstate.npz, as CPU tensors.
    SSP snapshots (``kind = "ssp"``) are not in the port yet and raise."""
    from ..parallel.trainer import TrainState
    from ..solvers.updates import SolverState
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    it, kind = 0, "dense"
    with np.load(state_path) as z:
        for key in z.files:
            if key == "iter":
                it = int(z[key])
            elif key == "kind":
                kind = str(z[key])
            else:
                group, rest = key.split("/", 1)
                groups.setdefault(group, {})[rest] = z[key]
    if kind != "dense":
        raise NotImplementedError(
            f"{state_path}: {kind!r} snapshots are not in the port yet "
            f"(dense only)")
    state = TrainState(
        solver=SolverState(it=it,
                           history=_unflatten(groups.get("history", {}))),
        comm_error=_unflatten(groups.get("comm_error", {})))
    return _unflatten(groups.get("params", {})), state


def restore_params(state_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The params tree {layer: {param: array}} of a .solverstate.npz."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(state_path) as z:
        for key in z.files:
            group, _, rest = key.partition("/")
            if group != "params" or not rest:
                continue
            parts = rest.split(_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def load_caffemodel(path: str, net, params):
    """Merge a .caffemodel's weights into ``params`` through
    ``net.load_weights``."""
    with open(path, "rb") as f:
        weights = decode_caffemodel(f.read())
    return net.load_weights(params, weights)


def latest_snapshot(prefix: str,
                    suffix: str = ".solverstate.npz") -> Optional[str]:
    """The newest ``<prefix>_iter_<N><suffix>`` by N, or None."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    best, best_it = None, -1
    if not os.path.isdir(d):
        return None
    for name in os.listdir(d):
        if name.startswith(base + "_iter_") and name.endswith(suffix):
            try:
                it = int(name[len(base + "_iter_"):-len(suffix)])
            except ValueError:
                continue
            if it > best_it:
                best, best_it = os.path.join(d, name), it
    return best
