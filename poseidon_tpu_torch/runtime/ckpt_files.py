"""Snapshot-file discovery and hygiene, the filesystem half of
``runtime.checkpoint`` (the port's copy of
``poseidon_tpu/runtime/ckpt_files.py``): socket-tier processes (async-SSP
workers deciding whether to auto-resume) use it without importing the
checkpoint module's torch state code."""

from __future__ import annotations

import os
import re
from typing import List, Optional


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True      # exists, owned by someone else
    except OSError:
        return False
    return True


def sweep_stale_tmp(prefix: str, min_age_s: float = 60.0) -> List[str]:
    """Remove orphaned snapshot temp files under ``prefix``.

    ``snapshot()`` writes ``<artifact>.tmp.<pid>`` then ``os.replace``s it
    into place; a process killed between the two leaves a tmp that can
    never be renamed — litter at best, a truncated half-write at worst.
    A tmp file is swept when its writer pid is gone (or is THIS process,
    which is not mid-snapshot while sweeping at startup/restore) AND it is
    at least ``min_age_s`` old. The age guard is what makes the sweep safe
    on a SHARED filesystem: the pid test is host-local, so a live writer
    on another host can look dead here — but its tmp is by construction
    only seconds old (the write->replace window), never past the guard.
    Completed snapshots are never touched (the iter-file naming shares no
    suffix with tmps), and latest_snapshot/restore never select a tmp, so
    un-swept litter is cosmetic, not a correctness hazard. Returns the
    removed paths."""
    import time
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    removed: List[str] = []
    if not os.path.isdir(d):
        return removed
    now = time.time()
    for name in os.listdir(d):
        if not name.startswith(base + "_iter_"):
            continue
        m = re.search(r"\.tmp\.(\d+)$", name)
        if not m:
            continue
        pid = int(m.group(1))
        if pid != os.getpid() and _pid_alive(pid):
            continue
        path = os.path.join(d, name)
        try:
            if now - os.path.getmtime(path) < min_age_s:
                continue
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def latest_snapshot(prefix: str,
                    suffix: str = ".solverstate.npz") -> Optional[str]:
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
