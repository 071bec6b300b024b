"""Snapshots: ``.solverstate.npz`` + ``.caffemodel`` (numpy only), in the
JAX package's format (``poseidon_tpu/runtime/checkpoint.py``), so
snapshots cross-load both ways.

- ``snapshot()`` writes ``<prefix>_iter_<N>.caffemodel`` (a Caffe
  NetParameter binary) and ``<prefix>_iter_<N>.solverstate.npz``. A dense
  state (``TrainState``) stores ``iter``, ``kind = "dense"``, one array a
  leaf under ``params/`` and ``history/``, and the TOPK residuals under
  ``comm_error/``, stacked ``(groups, *shape)`` as the caller gathered
  them (``TrainStep.gather_comm_error``; none without a TOPK layer). An
  SSP state (``SSPState``, stacked by ``SSPTrainStep.gather_state``)
  stores ``kind = "ssp"``, the anchor under ``params/`` (and in the
  .caffemodel), and the stacked rows under ``local_params/``,
  ``local_history/``, ``adarev_gsum/`` and ``comm_error/``, with
  ``adarev_server/`` (its z/zmax) beside them. Tree keys join layer and
  param names with the ASCII unit separator (layer names may contain
  '/'). Both files are written to a temporary name and renamed.
- A net with shared (named) params stores its owners alone under
  ``params/`` and ``history/``, as JAX's owner-only tree does, and its
  .caffemodel repeats each owner's blobs under every sharer (Caffe's
  layout, ``Net.export_weights``); ``load_caffemodel`` routes a sharer's
  blobs to its owner. Both load both ways with the JAX package.
- ``restore()`` rebuilds (params, TrainState or SSPState) as CPU
  tensors, by the snapshot's kind; ``coerce_state`` converts between the
  kinds for the mode a run is in (JAX's rules); ``restore_params`` reads
  the params alone.
- ``load_caffemodel`` merges a .caffemodel's weights through
  ``net.load_weights`` (Caffe's CopyTrainedLayersFrom).
- ``AsyncSnapshotWriter`` takes the host copy at the sync point and runs
  ``snapshot()`` on a background thread, one write in flight.
- ``latest_snapshot`` and ``sweep_stale_tmp`` live in ``ckpt_files``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..proto.wire import decode_caffemodel, encode_caffemodel
from .ckpt_files import latest_snapshot, sweep_stale_tmp  # noqa: F401

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


def _is_ssp(state) -> bool:
    from ..parallel.trainer import SSPState
    return isinstance(state, SSPState)


def _state_it(state) -> int:
    return int(state.it if _is_ssp(state) else state.solver.it)


def snapshot_paths(prefix: str, state) -> Tuple[str, str]:
    it = _state_it(state)
    return (f"{prefix}_iter_{it}.caffemodel",
            f"{prefix}_iter_{it}.solverstate.npz")


def snapshot(prefix: str, net, params, state) -> Tuple[str, str]:
    """Write both artifacts (tmp + atomic rename); returns their paths.
    The .caffemodel holds the agreed view: the anchor under SSP."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    model_path, state_path = snapshot_paths(prefix, state)
    ssp = _is_ssp(state)
    model_params = state.anchor_params if ssp else params
    pid = os.getpid()
    tmp = f"{model_path}.tmp.{pid}"
    with open(tmp, "wb") as f:
        f.write(encode_caffemodel(net.name or "net",
                                  net.export_weights(model_params)))
    os.replace(tmp, model_path)

    arrays = {"iter": np.asarray(_state_it(state)),
              "kind": np.asarray("ssp" if ssp else "dense")}
    arrays.update({f"params/{k}": v
                   for k, v in _flatten(model_params).items()})
    if ssp:
        for group in ("local_params", "local_history", "adarev_server",
                      "adarev_gsum"):
            arrays.update({f"{group}/{k}": v for k, v in
                           _flatten(getattr(state, group)).items()})
    else:
        arrays.update({f"history/{k}": v
                       for k, v in _flatten(state.solver.history).items()})
    arrays.update({f"comm_error/{k}": v
                   for k, v in _flatten(state.comm_error).items()})
    tmp = f"{state_path}.tmp.{pid}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, state_path)
    return model_path, state_path


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True) for k, v in tree.items()}


def host_state_copy(params, state):
    """CPU copies of (params, state): the snapshot's sync point (the copy
    off the card waits for the steps that produced the values)."""
    if _is_ssp(state):
        return _copy_tree(params), state._replace(**{
            f: _copy_tree(getattr(state, f)) for f in (
                "local_params", "local_history", "anchor_params",
                "comm_error", "adarev_server", "adarev_gsum")})
    from ..parallel.trainer import TrainState
    from ..solvers.updates import SolverState
    return _copy_tree(params), TrainState(
        solver=SolverState(it=int(state.solver.it),
                           history=_copy_tree(state.solver.history)),
        comm_error=_copy_tree(state.comm_error))


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
    """(params, state) from a .solverstate.npz of either package, as CPU
    tensors: a ``TrainState`` for a dense snapshot, a stacked
    ``SSPState`` for an SSP one (``coerce_state`` converts)."""
    from ..parallel.trainer import SSPState, TrainState
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
    if kind not in ("dense", "ssp"):
        raise ValueError(f"{state_path}: unknown snapshot kind {kind!r}")
    params = _unflatten(groups.get("params", {}))
    err = _unflatten(groups.get("comm_error", {}))
    if kind == "ssp":
        return params, SSPState(
            local_params=_unflatten(groups.get("local_params", {})),
            local_history=_unflatten(groups.get("local_history", {})),
            anchor_params=params, it=it, comm_error=err,
            adarev_server=_unflatten(groups.get("adarev_server", {})),
            adarev_gsum=_unflatten(groups.get("adarev_gsum", {})))
    return params, TrainState(
        solver=SolverState(it=it,
                           history=_unflatten(groups.get("history", {}))),
        comm_error=err)


def _same_shapes(a: Dict, b: Dict) -> bool:
    """Same tree structure and leaf shapes."""
    if not isinstance(a, dict) or not isinstance(b, dict):
        return (not isinstance(a, dict) and not isinstance(b, dict)
                and tuple(a.shape) == tuple(b.shape))
    return sorted(a) == sorted(b) and all(_same_shapes(a[k], b[k])
                                          for k in a)


def coerce_state(params, state, *, staleness: int, n_dev: int, comm=None):
    """A restored (params, state) in the mode a run is in (JAX's
    ``coerce_state``):

    - dense -> SSP: fresh per-group copies of the params, momentum and
      residuals restarting (the reference's thread-0 fallback), the
      iteration kept;
    - SSP -> dense: the anchor, with fresh momentum and residuals;
    - SSP with another group count: fresh copies of the anchor;
    - the same mode: residuals reconciled with the current strategies
      (``reconcile_comm_error``), and the adarevision accumulators kept
      only where their structure and shapes still match (else z/zmax
      restart at 1 and the gradient sums at 0).

    On a mode change residuals and momentum restart: dense residuals hold
    gradient mass a step, SSP ones parameter-delta mass a period."""
    from ..parallel.trainer import (SSPState, TrainState, init_adarev_state,
                                    init_comm_error, init_ssp_state,
                                    reconcile_comm_error)
    from ..solvers.updates import SolverState, init_state

    want_ssp = staleness > 0
    is_ssp = isinstance(state, SSPState)
    if want_ssp and not is_ssp:
        return params, init_ssp_state(params, n_dev, comm)._replace(
            it=int(state.solver.it))
    if not want_ssp and is_ssp:
        anchor = state.anchor_params
        return anchor, TrainState(
            solver=SolverState(it=int(state.it),
                               history=init_state(anchor).history),
            comm_error=init_comm_error(anchor, comm, n_dev))
    if is_ssp:
        leaves = [v for lp in state.local_params.values()
                  for v in lp.values()]
        if leaves and leaves[0].shape[0] != n_dev:
            return state.anchor_params, init_ssp_state(
                state.anchor_params, n_dev, comm)._replace(it=int(state.it))
    state = state._replace(comm_error=reconcile_comm_error(
        params, state.comm_error, comm, n_dev))
    if not is_ssp:
        return params, state
    server, gsum = init_adarev_state(params, comm, n_dev)
    if server and _same_shapes(server, state.adarev_server):
        return params, state._replace(
            adarev_gsum=(state.adarev_gsum
                         if _same_shapes(gsum, state.adarev_gsum)
                         else gsum))
    return params, state._replace(adarev_server=server, adarev_gsum=gsum)


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
