"""Host-side span timeline (the port's copy of
``poseidon_tpu/runtime/spans.py``).

``torch.profiler`` attributes DEVICE time; this module attributes HOST
time — where the training loop blocks. A span is a context manager around
one hot-path region (``prefetch_wait``, ``dispatch``, ``dispatch_window``,
``hard_sync``, ``snapshot``); the recorder buffers them in a bounded
thread-safe deque and dumps Chrome trace-event JSON (``chrome://tracing``
and Perfetto load it directly, beside a profiler trace).

Overhead discipline: the recorder ships DISABLED. ``span()`` on a disabled
recorder returns a shared no-op context manager — one attribute read and a
call, no allocation — so instrumentation can live permanently in the hot
path. ``Engine(trace_out=...)`` (``train --trace_out``) enables it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["SpanRecorder", "recorder", "span", "enabled"]


class _NullSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_rec", "name", "cat", "args", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str, cat: str, args):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        rec = self._rec
        rec._record(self.name, self.cat, self._t0, t1 - self._t0, self.args)
        return False


class SpanRecorder:
    """Bounded, thread-safe buffer of completed spans.

    ``maxlen`` bounds memory on long runs (oldest spans fall off — the
    timeline is a sliding window, like LatencyWindow); ``dump()`` writes
    the Chrome trace-event JSON atomically (tmp + rename) so a reader
    polling the file mid-run never sees a torn document.
    """

    def __init__(self, maxlen: int = 65536):
        self.enabled = False
        self._events: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._epoch_us = time.time() * 1e6 - self._t0 * 1e6
        self.dropped = 0          # spans recorded past maxlen (overwrote)

    # ---- lifecycle ---------------------------------------------------- #
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # ---- recording ---------------------------------------------------- #
    def span(self, name: str, cat: str = "engine",
             args: Optional[Dict] = None):
        """Context manager timing one region. Near-free when disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "engine",
                args: Optional[Dict] = None) -> None:
        """Zero-duration marker (Chrome trace 'i' events)."""
        if not self.enabled:
            return
        self._record(name, cat, time.perf_counter(), None, args)

    def _record(self, name, cat, t0, dur_s, args) -> None:
        ev = (name, cat, t0, dur_s, threading.get_ident(), args)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    # ---- export ------------------------------------------------------- #
    def trace_events(self) -> List[Dict]:
        """Chrome trace-event dicts ('X' complete / 'i' instant), ts/dur
        in microseconds on the wall-clock epoch."""
        with self._lock:
            snap = list(self._events)
        pid = os.getpid()
        out: List[Dict] = []
        for name, cat, t0, dur_s, tid, args in snap:
            ev: Dict = {
                "name": name, "cat": cat, "pid": pid, "tid": tid,
                "ts": round(self._epoch_us + t0 * 1e6, 3),
            }
            if dur_s is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur_s * 1e6, 3)
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return out

    def dump(self, path: str) -> str:
        """Write the Chrome trace JSON atomically; returns the path.
        A killed writer leaves only sweepable ``.tmp.<pid>`` litter."""
        doc = {"traceEvents": self.trace_events(),
               "displayTimeUnit": "ms",
               "metadata": {"tool": "poseidon_tpu_torch spans",
                            "dropped_spans": self.dropped}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# The process-wide recorder: the engine enables it under --trace_out and
# every instrumented module records into it (one timeline per process).
recorder = SpanRecorder()


def span(name: str, cat: str = "engine", args: Optional[Dict] = None):
    """Module-level shorthand for ``recorder.span`` (the common call)."""
    return recorder.span(name, cat, args)


def enabled() -> bool:
    return recorder.enabled
