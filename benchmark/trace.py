"""The traced stretch of a run, read from the ``torch.profiler`` Chrome
trace and the engine's host spans.

The stretch is the ``bench_window`` annotation (``harness.Tracer``): one
display period of the window, its hard sync included. Device time is the
union of the kernels, memsets and copies inside it on every stream; an
idle gap is named by the host span (``runtime/spans.py``) that covers
most of it. The host spans are put on the trace's clock by the
annotation's start, which the harness also read on its own clock.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
LOOP_SPANS = ("prefetch_wait", "dispatch", "dispatch_window", "hard_sync")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:96] or name[:96]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


class TraceView:
    def __init__(self, events: List[Dict], host: Tuple[float, float],
                 steps: int, spans: List[Tuple[str, float, float]]):
        marks = [e for e in events if e.get("name") == "bench_window"
                 and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if not marks:
            raise RuntimeError("the device trace holds no bench_window "
                               "annotation")
        a = float(marks[0]["ts"])
        b = a + float(marks[0]["dur"])
        self.window_us = (a, b)
        self.steps = max(1, int(steps))
        self.kernels: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            if e["cat"] == "gpu_memcpy" and ("HtoD" in e["name"]
                                             or "DtoH" in e["name"]):
                # copies over the host link: the input's staging, not op time
                continue
            t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
            lo, hi = max(t0, a), min(t0 + dur, b)
            if hi > lo:
                self.kernels.append((e["name"], lo, hi - lo))
        self.busy = union([(t, t + d) for _, t, d in self.kernels])
        self.busy_s = sum(y - x for x, y in self.busy) / 1e6
        self.window_s = (b - a) / 1e6
        # the host spans on the trace's clock
        off = a - host[0] * 1e6
        self.spans = [(n, s * 1e6 + off, d * 1e6) for n, s, d in spans
                      if n in LOOP_SPANS]
        self.spans = [(n, max(s, a), min(s + d, b) - max(s, a))
                      for n, s, d in self.spans
                      if min(s + d, b) > max(s, a)]

    # ------------------------------------------------------------------ #
    def kernel_s(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Seconds and launches of the device ops whose name ``match``
        accepts."""
        sel = [d for n, _, d in self.kernels if match(n)]
        return sum(sel) / 1e6, len(sel)

    def span_s(self, name: str) -> float:
        return sum(d for n, _, d in self.spans if n == name) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        a, b = self.window_us
        out, t = [], a
        for x, y in self.busy:
            if x > t:
                out.append((t, x))
            t = max(t, y)
        if b > t:
            out.append((t, b))
        return out

    def gap_label(self, gap: Tuple[float, float]) -> str:
        best, label = 0.0, "host_other"
        for n, s, d in self.spans:
            over = min(s + d, gap[1]) - max(s, gap[0])
            if over > best:
                best, label = over, n
        return label

    def breakdown(self) -> Dict:
        by_name: Dict[str, float] = {}
        for n, _, d in self.kernels:
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.gap_label(g), (g[1] - g[0]) / 1e6]
                              for g in gaps]}


def load(path: str, tracer, spans) -> TraceView:
    with open(path) as f:
        doc = json.load(f)
    return TraceView(doc.get("traceEvents", []), tracer.host, tracer.steps,
                     spans)
