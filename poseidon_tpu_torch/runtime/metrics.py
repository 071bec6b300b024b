"""Telemetry (the parts of ``poseidon_tpu/runtime/metrics.py`` the port
uses): ``log``, ``MetricsTable`` (the training and test output CSVs),
``AsyncScalarFetcher`` (the training loop's in-flight window),
``LatencyWindow`` and ``StatsRegistry`` (serving)."""

from __future__ import annotations

import math
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import torch


class MetricsTable:
    """Per-window metric rows, written as the JAX engine's CSVs
    (``<net>_train_outputs.csv``: iter,time,loss,...;
    ``<net>_test<i>_outputs.csv``: iter,time,accuracy,loss)."""

    def __init__(self, name: str):
        self.name = name
        self.rows: List[Dict[str, float]] = []
        self._window: Dict[str, List[float]] = defaultdict(list)
        self._t0 = time.time()

    def accumulate(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._window[k].append(float(v))

    def flush_row(self, iteration: int) -> Dict[str, float]:
        """Average the window into one row (keys sorted, as the JAX
        engine's metrics dicts come back sorted) and start a new window."""
        row = {"iter": iteration, "time": round(time.time() - self._t0, 3)}
        for k in sorted(self._window):
            vals = self._window[k]
            row[k] = sum(vals) / max(len(vals), 1)
        self._window.clear()
        self.rows.append(row)
        return row

    def to_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cols: List[str] = []
        for row in self.rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for row in self.rows:
                f.write(",".join(str(row.get(c, "")) for c in cols) + "\n")


class _Pending:
    """One dispatch's metrics on their way to the host: their names, a
    host buffer that receives their values, and (for a CUDA dispatch) the
    event recorded after the copy into it was issued."""

    __slots__ = ("first_iter", "names", "host", "event")

    def __init__(self, first_iter: int, metrics: Dict[str, torch.Tensor]):
        self.first_iter = first_iter
        self.names = sorted(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(())
                               for k in self.names])
        self.event: Optional[torch.cuda.Event] = None
        if stacked.is_cuda:
            # issued on the train thread: the copy runs on the stream that
            # produced the metrics, after them; the drainer only waits
            self.host = torch.empty(stacked.shape, dtype=stacked.dtype,
                                    pin_memory=True)
            self.host.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = stacked

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def row(self) -> Dict[str, float]:
        """Wait for the copy (never issues device work), then read it."""
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.names, self.host.tolist()))


class AsyncScalarFetcher:
    """Bounded in-flight dispatch window + off-thread scalar drain.

    The training loop dispatches step k+1 BEFORE step k's metrics are
    read: each dispatch's device metrics are ``put()`` here (stacked and
    copied without blocking into pinned host memory, behind a CUDA event),
    a drainer thread waits on the event and reads the floats, and ``put``
    itself blocks only when more than ``max_in_flight`` dispatches are
    unread — that backpressure IS the dispatch window. ``sync()`` is the
    hard host<->device sync point (display/test/snapshot boundaries and
    the end of training).

    NaN detection rides the drain: the first non-finite value of a watched
    key records ``(iteration, key, value)`` in ``divergence``, tagged with
    the iteration that produced it, which the loop observes at most
    ``max_in_flight`` steps later. Rows come back in dispatch order."""

    def __init__(self, max_in_flight: int = 2,
                 watch_keys: Tuple[str, ...] = ("loss",)):
        self.max_in_flight = max(1, int(max_in_flight))
        self.watch_keys = tuple(watch_keys)
        self.divergence: Optional[Tuple[int, str, float]] = None
        self._cond = threading.Condition()
        self._inbox: deque = deque()    # _Pending entries for the drainer
        self._drained: deque = deque()  # (iter, float row)
        self._pending = 0               # dispatches not yet read
        self._error: Optional[BaseException] = None
        self._closed = False
        self._puts = 0
        self._pending_sum = 0
        self._thread = threading.Thread(target=self._drain_loop, daemon=True,
                                        name="AsyncScalarFetcher")
        self._thread.start()

    # ---- producer side (the train thread) ---------------------------- #
    def put(self, first_iter: int, metrics: Dict[str, torch.Tensor]) -> None:
        """Enqueue one dispatch's metrics (``first_iter`` = the iteration
        of the step that produced them), then block until at most
        ``max_in_flight - 1`` dispatches are unread, so the step the loop
        dispatches next brings the count to at most ``max_in_flight``.
        With ``max_in_flight=1`` this reads the entry itself before
        returning: the serial loop.

        Fast path: when the window is empty and the dispatch has already
        finished (CPU tensors, or a device that ran ahead of the host),
        the row is read inline with no thread handoff: there is nothing
        left to overlap."""
        entry = _Pending(first_iter, metrics)
        with self._cond:
            if self._error:
                raise self._error
            inline = (self._pending == 0 and not self._inbox
                      and entry.ready())
            self._puts += 1
            self._pending_sum += 1 if inline else self._pending + 1
            if not inline:
                self._pending += 1
                self._inbox.append(entry)
                self._cond.notify_all()
                while self._pending > self.max_in_flight - 1 and \
                        not self._error:
                    self._cond.wait()
                if self._error:
                    raise self._error
                return
        # read OUTSIDE the lock (the entry is ready, so this cannot block);
        # one producer and an empty inbox keep the rows in order
        row = entry.row()
        with self._cond:
            self._ingest(first_iter, row)

    def take_drained(self) -> List[Tuple[int, Dict[str, float]]]:
        """Rows read so far, in order, without waiting."""
        with self._cond:
            out = list(self._drained)
            self._drained.clear()
        return out

    def sync(self) -> List[Tuple[int, Dict[str, float]]]:
        """Hard sync: wait until every pending dispatch is read, then
        return all drained rows (in order). Re-raises a drainer failure."""
        with self._cond:
            while self._pending and not self._error:
                self._cond.wait()
            if self._error:
                raise self._error
            out = list(self._drained)
            self._drained.clear()
        return out

    def mean_in_flight(self) -> float:
        """Average window occupancy seen at dispatch time (1.0 = the
        serial loop; up to max_in_flight as the pipeline fills)."""
        with self._cond:
            return self._pending_sum / self._puts if self._puts else 0.0

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)

    def _ingest(self, it: int, row: Dict[str, float]) -> None:
        """Append a read row and run the divergence watch. Caller holds
        the lock."""
        self._drained.append((it, row))
        if self.divergence is None:
            for k in self.watch_keys:
                v = row.get(k)
                if v is not None and not math.isfinite(v):
                    self.divergence = (it, k, v)
                    break

    # ---- drainer thread ---------------------------------------------- #
    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._inbox and not self._closed:
                    self._cond.wait()
                if not self._inbox and self._closed:
                    return
                entry = self._inbox[0]
            try:
                row = entry.row()
            except BaseException as e:  # noqa: BLE001 — surface, never wedge
                with self._cond:
                    self._error = e
                    self._pending = 0
                    self._cond.notify_all()
                return
            with self._cond:
                self._inbox.popleft()
                self._ingest(entry.first_iter, row)
                self._pending -= 1
                self._cond.notify_all()


class StatsRegistry:
    """Named sections of run-level stats (the serving `stats` op registers
    its snapshot as the "serving" section). Thread-safe: handler threads
    and the main thread touch one registry."""

    def __init__(self):
        self.sections: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def set_section(self, name: str, data: dict) -> None:
        with self._lock:
            self.sections[name] = data

    def snapshot(self) -> Dict[str, dict]:
        """A consistent copy of everything (one lock hold)."""
        with self._lock:
            return {k: dict(v) for k, v in self.sections.items()}


class LatencyWindow:
    """Sliding-window latency percentiles: a bounded deque of the last
    ``maxlen`` samples (seconds), O(1) record, sort-on-read. Thread-safe."""

    def __init__(self, maxlen: int = 2048):
        self._samples: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.count = 0            # total ever recorded (window is bounded)

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            self.count += 1

    @staticmethod
    def _rank(data: List[float], q: float) -> float:
        """Nearest-rank percentile over sorted ``data``."""
        return data[max(0, min(len(data) - 1,
                               int(round(q / 100.0 * (len(data) - 1)))))]

    def summary(self) -> Dict[str, float]:
        """{count, p50_ms, p99_ms, mean_ms} over the window (empty -> just
        count=0)."""
        with self._lock:
            data = sorted(self._samples)
            count = self.count
        if not data:
            return {"count": 0}
        return {
            "count": count,
            "p50_ms": round(self._rank(data, 50.0) * 1e3, 3),
            "p99_ms": round(self._rank(data, 99.0) * 1e3, 3),
            "mean_ms": round(sum(data) / len(data) * 1e3, 3),
        }


def log(msg: str, *, rank: int = 0) -> None:
    """Rank-0-only progress logging, the reference's client0/thread0
    idiom (a single process is rank 0)."""
    if rank == 0:
        print(msg, flush=True)
