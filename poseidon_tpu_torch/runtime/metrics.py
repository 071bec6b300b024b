"""Serving telemetry (the parts of ``poseidon_tpu/runtime/metrics.py`` the
serving tier uses): ``log``, ``LatencyWindow`` and ``StatsRegistry``."""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List


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


def log(msg: str) -> None:
    print(msg, flush=True)
