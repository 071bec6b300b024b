"""Checkpoint hot-reload: watch the snapshot directory, swap params live
(the port of ``poseidon_tpu/serving/reloader.py``).

The training side of either package writes
``<prefix>_iter_N.solverstate.npz`` atomically (tmp + rename); discovery
uses ``runtime/ckpt_files.latest_snapshot``, whose suffix match ignores
the ``.tmp.<pid>`` litter a killed writer leaves behind, so a path this
reloader sees is a complete rename-landed file. Torn or incompatible
files are still handled: a failed load is logged, counted, and the server
keeps serving the previous params.

The load runs on this reloader's own thread, never a request thread, and
the handoff is ``executor.swap_params``: one atomic reference swap,
validated against the serving tree. In-flight requests that already read
the old params finish on them; no request is dropped or errored by a
reload.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..runtime.ckpt_files import latest_snapshot
from ..runtime.metrics import log
from .executor import load_serving_params

__all__ = ["CheckpointReloader", "FleetReloader"]


class CheckpointReloader:
    """Poll ``prefix`` for a newer solverstate and hot-swap the executor.

    ``prefix`` is the snapshot prefix exactly as the solver writes it
    (e.g. ``out/snap/lenet``); ``poll_s`` is the watch cadence. Starts its
    thread on construction; ``check_now()`` forces one poll synchronously
    (the server's ``reload`` op and the tests use it — determinism beats
    sleeping on the poll period)."""

    def __init__(self, executor, prefix: str, poll_s: float = 1.0,
                 start: bool = True, current_path: Optional[str] = None):
        """``current_path`` seeds the already-serving snapshot (the one
        --weights loaded): the first poll then only swaps to something
        strictly NEWER, instead of redundantly re-loading the snapshot
        already serving (or regressing to an older one)."""
        self.executor = executor
        self.prefix = prefix
        self.poll_s = float(poll_s)
        self.current_path = current_path
        self.reloads = 0
        self.failed_reloads = 0
        self.last_error: Optional[str] = None
        self._lock = threading.Lock()     # one load at a time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._watch_loop,
                                            daemon=True)
            self._thread.start()

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_now()
            except Exception as e:  # noqa: BLE001 — the watcher must survive
                # discovery itself failed (unreadable watch dir, NFS
                # outage): as loud as a failed load, or hot-reload dies
                # silently while the operator believes it is live.
                # Counter + last_error under the SAME lock check_now's
                # load-failure path uses
                err = f"{type(e).__name__}: {e}"
                with self._lock:
                    changed = err != self.last_error
                    self.last_error = err
                    self.failed_reloads += 1
                if changed:
                    log(f"serving: snapshot watch on {self.prefix!r} "
                        f"failing: {err}")

    def check_now(self) -> bool:
        """One poll: if a snapshot newer than the one serving exists, load
        it off-thread and swap. Returns True iff a swap happened."""
        with self._lock:
            path = latest_snapshot(self.prefix)
            if path is None or path == self.current_path:
                return False
            if self.current_path is not None and \
                    self._iter_of(path) <= self._iter_of(self.current_path):
                return False
            try:
                params = load_serving_params(self.executor.net,
                                             self.executor._params, path)
                version = self.executor.swap_params(params)
            except Exception as e:  # noqa: BLE001 — keep serving old params
                self.failed_reloads += 1
                self.last_error = f"{type(e).__name__}: {e}"
                log(f"serving: reload of {os.path.basename(path)} failed "
                    f"({self.last_error}); keeping previous params")
                return False
            self.current_path = path
            self.reloads += 1
            self.last_error = None
            log(f"serving: hot-reloaded {os.path.basename(path)} "
                f"(params version {version})")
            return True

    @staticmethod
    def _iter_of(path: str) -> int:
        name = os.path.basename(path)
        try:
            return int(name.split("_iter_")[-1].split(".")[0])
        except ValueError:
            return -1

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class FleetReloader(CheckpointReloader):
    """The single-executor reloader generalized to drive a fleet: one
    snapshot discovery, one load, then :meth:`ReplicaManager.rolling_reload`
    drains and swaps replicas one at a time (never more than one draining;
    zero requests dropped or errored across a full fleet reload).

    Same watch loop, discovery rules (tmp-litter-proof, strictly-newer
    only), failure accounting, and server `reload`-op surface as the
    parent — ``reloads`` counts completed FLEET rolls; per-replica
    generations are in the manager's stats rows."""

    def __init__(self, manager, prefix: str, poll_s: float = 1.0,
                 start: bool = True, current_path: Optional[str] = None,
                 drain_timeout_s: Optional[float] = None):
        self.manager = manager
        self.drain_timeout_s = drain_timeout_s
        super().__init__(executor=None, prefix=prefix, poll_s=poll_s,
                         start=start, current_path=current_path)

    def check_now(self) -> bool:
        """One poll: if a strictly newer snapshot exists, load it ONCE
        (against the fleet's reference replica) and roll it through every
        serving replica. True iff a fleet roll completed cleanly."""
        with self._lock:
            path = latest_snapshot(self.prefix)
            if path is None or path == self.current_path:
                return False
            if self.current_path is not None and \
                    self._iter_of(path) <= self._iter_of(self.current_path):
                return False
            from .fleet import PartialReloadError
            try:
                ref = self.manager.reference_executor()
                params = load_serving_params(ref.net, ref._params, path)
                swapped = self.manager.rolling_reload(
                    params, drain_timeout_s=self.drain_timeout_s)
            except PartialReloadError as e:
                # the roll RAN: some replicas landed, the rest refused or
                # could not drain. Advance current_path anyway — retrying
                # every poll would re-drain the healthy replicas (capacity
                # dips) and stall drain_timeout_s per pass on the sick one
                # forever. The skew is visible per-replica in stats; the
                # next strictly-newer snapshot rolls again.
                self.current_path = path
                self.failed_reloads += 1
                self.last_error = f"{type(e).__name__}: {e}"
                log(f"serving: fleet reload of {os.path.basename(path)} "
                    f"partially landed ({e.swapped} swapped, "
                    f"{len(e.errors)} failed); not re-rolling until a "
                    f"newer snapshot appears")
                return False
            except Exception as e:  # noqa: BLE001 — keep serving old params
                # the LOAD failed (torn/incompatible snapshot): nothing
                # was drained or swapped, so retrying next poll is free —
                # the single-executor reloader's existing behavior
                self.failed_reloads += 1
                self.last_error = f"{type(e).__name__}: {e}"
                log(f"serving: fleet reload of {os.path.basename(path)} "
                    f"failed ({self.last_error}); replicas keep their "
                    f"current params")
                return False
            self.current_path = path
            self.reloads += 1
            self.last_error = None
            log(f"serving: fleet hot-reloaded {os.path.basename(path)} "
                f"({swapped} replicas, one drain at a time)")
            return True
