"""Dynamic micro-batcher: flush on max-batch-size OR max-latency-deadline.

The port's copy of ``poseidon_tpu/serving/batcher.py`` (it has no torch or
jax in it; the port keeps its own copy and imports nothing of the JAX
package).

The serving analog of the data tier's prefetch pipeline, inverted: requests
arrive one at a time over sockets, the accelerator wants them in bucket-
sized batches. One flush thread owns the executor; handler threads enqueue
and block on their request's event.

Flush policy (whichever fires first):
- SIZE: queued rows reach the largest executor bucket (a full batch gains
  nothing by waiting);
- DEADLINE: the OLDEST queued request has waited ``max_delay_s`` (bounded
  queueing latency — a lone request never waits for company longer than
  the deadline).

Backpressure contract (bounded queue, explicit shed): ``submit`` on a full
queue raises :class:`ShedError` IMMEDIATELY — the caller gets an explicit
shed response, never a hang and never unbounded memory. A request whose
per-request deadline expires while queued is completed with
:class:`DeadlineError` instead of being dispatched (its reply would be
garbage to a timed-out client; spending a bucket slot on it would delay
live requests behind it).

Shutdown: ``close(drain=True)`` refuses new submissions, flushes everything
already admitted, then joins the flush thread — the graceful half of the
server's SIGTERM path. No admitted request is ever silently dropped: even
on ``drain=False`` the leftovers are completed with a shutdown error.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..runtime.metrics import LatencyWindow

__all__ = ["DynamicBatcher", "ShedError", "ShuttingDownError",
           "DeadlineError"]


class ShedError(RuntimeError):
    """Admission refused: the bounded queue is full (backpressure)."""


class ShuttingDownError(ShedError):
    """Admission refused because the batcher is closing (a typed marker,
    so callers tell a shutdown shed from a queue-full shed without
    matching on message text)."""


class DeadlineError(RuntimeError):
    """The request's deadline expired before it could be dispatched."""


class _Pending:
    __slots__ = ("inputs", "rows", "deadline", "enqueued", "event",
                 "result", "error", "cancelled")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 deadline: Optional[float]):
        self.inputs = inputs
        self.rows = rows
        self.deadline = deadline          # absolute monotonic, or None
        self.enqueued = time.monotonic()
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False            # submitter gave up (wait timeout)


class DynamicBatcher:
    """Queue -> micro-batch -> executor -> fan the rows back out.

    ``executor`` needs ``validate_request(inputs) -> rows``,
    ``infer(inputs) -> outputs``, ``max_batch`` and ``input_names``
    (a :class:`BucketedExecutor`). ``max_queue``
    bounds ADMITTED-but-unflushed requests (admission control);
    ``max_delay_s`` bounds how long a queued request waits for batch
    company."""

    def __init__(self, executor, max_delay_s: float = 0.005,
                 max_queue: int = 64):
        self.executor = executor
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        self.max_batch = int(executor.max_batch)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closing = False
        self._drain = True
        # telemetry (the /stats payload's batcher half)
        self.latency = LatencyWindow()     # submit -> reply, seconds
        self.shed_count = 0
        self.deadline_expired = 0
        self.batches = 0
        self.batched_rows = 0
        self._fill_sum = 0.0               # sum of rows/max_batch per flush
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- submission side ------------------------------------------------ #
    def submit(self, inputs: Dict[str, np.ndarray],
               deadline_s: Optional[float] = None,
               timeout_s: float = 30.0) -> Dict[str, np.ndarray]:
        """Enqueue one request (1..max_batch rows) and block until its
        micro-batch flushes. Raises ShedError on a full queue, DeadlineError
        on deadline expiry, ValueError on malformed inputs."""
        t0 = time.monotonic()
        # validate at ADMISSION, not at flush: a malformed request must be
        # rejected here with ITS error, never joined into a micro-batch
        # whose np.concatenate/dispatch failure would poison innocent
        # co-batched requests
        rows = int(self.executor.validate_request(inputs))
        if rows > self.max_batch:
            raise ValueError(f"request of {rows} rows exceeds max batch "
                             f"{self.max_batch}; split it client-side")
        deadline = None if deadline_s is None else t0 + float(deadline_s)
        req = _Pending(inputs, rows, deadline)
        with self._lock:
            if self._closing:
                raise ShuttingDownError("server is shutting down")
            if len(self._q) >= self.max_queue:
                self.shed_count += 1
                raise ShedError(
                    f"queue full ({self.max_queue} requests queued)")
            self._q.append(req)
            self._wake.notify()
        if not req.event.wait(timeout_s):
            # the submitter gives up: free the admission slot if still
            # queued, and mark cancelled so an already-popped copy is
            # skipped instead of burning bucket rows on an unread result
            with self._lock:
                req.cancelled = True
                try:
                    self._q.remove(req)
                except ValueError:
                    pass
            raise TimeoutError(f"no reply within {timeout_s}s "
                               f"(batcher wedged?)")
        if req.error is not None:
            raise req.error
        self.latency.record(time.monotonic() - t0)
        return req.result

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    def fill_ratio(self) -> Optional[float]:
        """Mean rows/max_batch over all flushed micro-batches."""
        with self._lock:      # paired read: both fields from one flush
            if not self.batches:
                return None
            return self._fill_sum / self.batches

    # ---- flush side ------------------------------------------------------ #
    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until a flush trigger fires; return the batch (oldest
        first, up to max_batch rows) or None on shutdown-without-drain /
        empty-drain."""
        with self._lock:
            while True:
                if self._q:
                    oldest = self._q[0]
                    queued_rows = sum(r.rows for r in self._q)
                    now = time.monotonic()
                    age = now - oldest.enqueued
                    if (queued_rows >= self.max_batch
                            or age >= self.max_delay_s or self._closing):
                        batch: List[_Pending] = []
                        rows = 0
                        while self._q and \
                                rows + self._q[0].rows <= self.max_batch:
                            r = self._q.popleft()
                            batch.append(r)
                            rows += r.rows
                        return batch
                    self._wake.wait(timeout=self.max_delay_s - age)
                elif self._closing:
                    return None
                else:
                    self._wake.wait(timeout=0.25)

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            now = time.monotonic()
            live: List[_Pending] = []
            for r in batch:
                if r.cancelled:
                    continue        # submitter timed out; nobody listens
                if r.deadline is not None and now > r.deadline:
                    # counter shared with the handler threads' /stats
                    # reads and submit's shed accounting — same lock as
                    # the rest of the telemetry (THR004)
                    with self._lock:
                        self.deadline_expired += 1
                    r.error = DeadlineError(
                        f"deadline expired after "
                        f"{now - r.enqueued:.3f}s in queue")
                    r.event.set()
                else:
                    live.append(r)
            if not live:
                continue
            rows = sum(r.rows for r in live)
            try:
                joined = {
                    name: np.concatenate(
                        [np.asarray(r.inputs[name]) for r in live], axis=0)
                    for name in self.executor.input_names}
                out = self.executor.infer(joined)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for r in live:
                    r.error = e
                    r.event.set()
                continue
            # flush-thread counters race the /stats handler threads (and
            # fill_ratio's two-field read) without the lock: a lost
            # increment here understates load forever (THR004)
            with self._lock:
                self.batches += 1
                self.batched_rows += rows
                self._fill_sum += rows / self.max_batch
            off = 0
            for r in live:
                r.result = {
                    k: (v[off:off + r.rows]
                        if np.ndim(v) >= 1 and np.shape(v)[0] == rows
                        else v)
                    for k, v in out.items()}
                off += r.rows
                r.event.set()

    # ---- shutdown -------------------------------------------------------- #
    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Refuse new submissions; with ``drain`` flush everything already
        admitted, otherwise complete leftovers with ShedError. Idempotent."""
        with self._lock:
            self._closing = True
            self._drain = drain
            if not drain:
                leftovers = list(self._q)
                self._q.clear()
            else:
                leftovers = []
            self._wake.notify_all()
        for r in leftovers:
            r.error = ShuttingDownError("server shut down before dispatch")
            r.event.set()
        self._thread.join(timeout=timeout_s)
