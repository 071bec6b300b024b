"""Telemetry (the parts of ``poseidon_tpu/runtime/metrics.py`` the port
uses): ``log``, ``MetricsTable`` (the training and test output CSVs),
``LatencyWindow`` and ``StatsRegistry`` (serving)."""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List


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
