"""Serving fleet: a replica manager behind the one socket front door (the
port of ``poseidon_tpu/serving/fleet.py``).

Each replica is its own executor (a :class:`BucketedExecutor`, or a
:class:`GenerateExecutor` that brings its own scheduler) with its own
micro-batcher and flush thread, placed on one device; the front door
routes each request. Every replica on one card launches on PyTorch's
default stream of that device, so their kernels run in order as one
device's programs do in the JAX package.

Replica lifecycle (one-way into DEAD; everything else cycles)::

    WARMING ──> SERVING <──> DRAINING
                   │             │
                   └──> DEAD <───┘

- ``WARMING``  — the executor is still being built and warmed; never
  routed.
- ``SERVING``  — in the routing set.
- ``DRAINING`` — no NEW requests; admitted ones finish (rolling reload and
  graceful shutdown both pass through here).
- ``DEAD``     — failure detection tripped (a dispatch error or a wedged
  flush thread); terminal, never routed, never reloaded, logged and
  counted in stats, never replaced by another forward.

Routing signal: ``load = queue_depth + inflight_rows / max_batch`` from
each replica's live batcher. Least-loaded wins; ties break to the lowest
replica index (deterministic).

Failover: a replica dying MID-REQUEST loses no accepted request. The dead
batcher fans its dispatch error out to every co-batched request; each of
those ``submit`` calls re-enters the router and is dispatched again on a
survivor, within the request's absolute deadline. Only explicit sheds
(every serving replica at queue capacity, or no serving replica at all)
are refused, and at once.

Rolling hot-reload: :meth:`ReplicaManager.rolling_reload` drains and swaps
replicas ONE at a time (never more than one draining), so fleet capacity
never dips by more than one replica and no request is dropped or errored
by a reload.

The executors own the device state; threads are daemon threads; sockets
stay in server.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..runtime.metrics import LatencyWindow, log
from .batcher import (DeadlineError, DynamicBatcher, ShedError,
                      ShuttingDownError)

__all__ = ["Replica", "ReplicaManager", "PartialReloadError", "WARMING",
           "SERVING", "DRAINING", "DEAD", "REPLICA_STATES"]

WARMING = "WARMING"
SERVING = "SERVING"
DRAINING = "DRAINING"
DEAD = "DEAD"
REPLICA_STATES = (WARMING, SERVING, DRAINING, DEAD)


class PartialReloadError(RuntimeError):
    """A rolling pass swapped SOME replicas but not all (drain timeout or
    a refused swap). TYPED so the fleet reloader can tell "the roll ran
    and partially landed — do not re-drain the healthy replicas every
    poll" from "the load itself failed — nothing was touched, retry"."""

    def __init__(self, message: str, swapped: int, errors):
        super().__init__(message)
        self.swapped = swapped
        self.errors = list(errors)


class Replica:
    """One serving engine: executor + its private micro-batcher + health.

    The batcher exists only once the executor is attached (a WARMING
    replica has nothing to enqueue into); ``state`` transitions run
    through :meth:`ReplicaManager._transition` so the draining invariant
    and the death counters live in exactly one place."""

    def __init__(self, index: int, executor=None, device_label: str = "",
                 max_delay_s: float = 0.005, max_queue: int = 64):
        self.index = index
        self.device_label = device_label
        self.executor = executor
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self.batcher: Optional[DynamicBatcher] = None
        self.state = WARMING
        self.reload_generation = 0
        self.routed = 0            # requests the router assigned here
        self.failures = 0          # dispatch errors / wedged-submit events
        self.death_reason: Optional[str] = None
        self._lock = threading.Lock()
        if executor is not None:
            self._attach_batcher()

    def _attach_batcher(self) -> None:
        # an executor that brings its own scheduler (GenerateExecutor's
        # ContinuousScheduler) plugs in here; routing, failover, rolling
        # reload, and stats compose unchanged — a replica that schedules
        # sequences instead of micro-batches is still just a replica
        mk = getattr(self.executor, "make_batcher", None)
        if mk is not None:
            self.batcher = mk(max_delay_s=self.max_delay_s,
                              max_queue=self.max_queue)
        else:
            self.batcher = DynamicBatcher(self.executor,
                                          max_delay_s=self.max_delay_s,
                                          max_queue=self.max_queue)

    def load(self) -> float:
        """The routing signal (see module docstring). A replica with no
        batcher yet (WARMING) is never routed, but report its load as
        +inf so even a racy read sorts it last."""
        b = self.batcher
        return b.load_score() if b is not None else float("inf")

    def snapshot(self) -> Dict:
        """One per-replica stats row (the `stats` op / metrics-endpoint
        shape; scalar leaves so the flat key=value rendering keeps them)."""
        with self._lock:
            row = {
                "state": self.state,
                "device": self.device_label,
                "reload_generation": self.reload_generation,
                "routed": self.routed,
                "failures": self.failures,
            }
            if self.death_reason:
                row["death_reason"] = self.death_reason
        b = self.batcher
        if b is not None:
            fill = b.fill_ratio()
            row.update({
                "queue_depth": b.queue_depth,
                "inflight_rows": b.inflight_rows,
                "load": round(b.load_score(), 4),
                "batch_fill": None if fill is None else round(fill, 4),
                "batches": b.batches,
                "shed": b.shed_count,
                "deadline_expired": b.deadline_expired,
                "latency": b.latency.summary(),
            })
        ex = self.executor
        if ex is not None:
            row["params_version"] = getattr(ex, "params_version", None)
            row["rows_served"] = getattr(ex, "rows_served", None)
        return row


class ReplicaManager:
    """N replicas, least-loaded routing, health states, rolling reload.

    ``executors`` are assumed warmed (a :class:`BucketedExecutor` warms at
    construction); use :meth:`build` with a factory to get real WARMING
    states. ``failure_threshold`` consecutive dispatch failures (or one
    wedged-submit timeout each) mark a replica DEAD; ``on_transition`` is
    an observer callback ``(index, old, new, reason)`` — the chaos suite's
    invariant probe. ``None`` policy knobs resolve against
    ``config.fleet_config()`` (the same late-binding idiom as
    ManagedCommConfig)."""

    def __init__(self, executors: Sequence = (), devices: Sequence = (),
                 *, max_delay_s: float = 0.005, max_queue: int = 64,
                 failure_threshold: Optional[int] = None,
                 drain_timeout_s: Optional[float] = None,
                 on_transition: Optional[Callable] = None):
        from ..config import fleet_config
        cfg = fleet_config()
        self.failure_threshold = int(failure_threshold
                                     if failure_threshold is not None
                                     else cfg.failure_threshold)
        self.drain_timeout_s = float(drain_timeout_s
                                     if drain_timeout_s is not None
                                     else cfg.drain_timeout_s)
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self.on_transition = on_transition
        self.latency = LatencyWindow()   # front-door submit -> reply
        # fleet counters (manager lock; replica-local ones live on Replica)
        self.routed_total = 0
        self.failovers = 0          # submits re-dispatched off a dead replica
        self.fleet_sheds = 0        # requests refused fleet-wide
        self.deaths = 0
        self.reload_generation = 0
        self.max_concurrent_draining = 0
        self._draining = 0
        # the latest rolled (generation, params): a replica that finishes
        # WARMING after a reload pass catches up from here instead of
        # serving its factory-loaded stale weights forever
        self._last_reload = None
        self._closing = False
        self._lock = threading.Lock()
        self._reload_lock = threading.Lock()   # one rolling pass at a time
        self.replicas: List[Replica] = []
        labels = list(devices) + [""] * (len(executors) - len(devices))
        for i, ex in enumerate(executors):
            rep = Replica(i, ex, device_label=str(labels[i]),
                          max_delay_s=max_delay_s, max_queue=max_queue)
            self.replicas.append(rep)
            self._transition(rep, SERVING, reason="pre-warmed executor")

    # ---- construction ---------------------------------------------------- #
    @classmethod
    def build(cls, factory: Callable, n_replicas: int,
              devices: Sequence = (), warm_async: bool = False,
              **kwargs) -> "ReplicaManager":
        """Build N replicas through ``factory(device_or_None) -> executor``
        (construction IS the warm-up: every bucket runs once inside the
        factory). An entry of ``devices`` is handed over as it is, so it
        may be a device group, as a tp-sharded generate replica takes
        (``devices=[("cuda:0", "cuda:1"), ...]``, labelled ``str(group)``). Replicas are visible in WARMING while their factory
        runs; ``warm_async=True`` warms them on background threads so the
        fleet starts serving as soon as the FIRST replica is ready."""
        mgr = cls((), **kwargs)
        devs = list(devices)
        for i in range(int(n_replicas)):
            dev = devs[i % len(devs)] if devs else None
            rep = Replica(i, None, device_label=str(dev) if dev is not None
                          else "", max_delay_s=mgr.max_delay_s,
                          max_queue=mgr.max_queue)
            mgr.replicas.append(rep)

            def warm_one(rep=rep, dev=dev):
                try:
                    ex = factory(dev)
                except Exception as e:  # noqa: BLE001 — a replica that
                    # cannot warm is a DEAD replica, not a dead fleet
                    mgr._mark_dead(rep, f"warm-up failed: "
                                        f"{type(e).__name__}: {e}")
                    return
                with rep._lock:
                    rep.executor = ex
                rep._attach_batcher()
                mgr._transition(rep, SERVING, reason="warmed")
                # a reload may have rolled the fleet while this replica
                # was still warming; transition FIRST, then catch up —
                # if a concurrent rolling pass also swaps it, both land
                # the same params (idempotent)
                mgr._catch_up_reload(rep)

            if warm_async:
                threading.Thread(target=warm_one, daemon=True).start()
            else:
                warm_one()
        return mgr

    # ---- state machine --------------------------------------------------- #
    def _transition(self, rep: Replica, new_state: str,
                    reason: str = "") -> str:
        """The only writer of ``Replica.state``. DEAD is terminal; the
        draining high-water mark (the rolling-reload invariant's witness)
        updates here."""
        with rep._lock:
            old = rep.state
            if old == new_state or old == DEAD:
                return old
            rep.state = new_state
            if new_state == DEAD:
                rep.death_reason = reason
        with self._lock:
            if new_state == DRAINING:
                self._draining += 1
                self.max_concurrent_draining = max(
                    self.max_concurrent_draining, self._draining)
            if old == DRAINING:
                self._draining -= 1
            if new_state == DEAD:
                self.deaths += 1
        log(f"serving: replica {rep.index} {old} -> {new_state}"
            + (f" ({reason})" if reason else ""))
        cb = self.on_transition
        if cb is not None:
            cb(rep.index, old, new_state, reason)
        return old

    def _mark_dead(self, rep: Replica, reason: str) -> None:
        old = self._transition(rep, DEAD, reason=reason)
        if old == DEAD:
            return
        # complete the dead replica's queued requests with ShedError so
        # their router-side submit calls wake and re-dispatch (drain=False:
        # flushing through a dead executor would just re-raise per batch)
        if rep.batcher is not None:
            rep.batcher.close(drain=False, timeout_s=5.0)

    def state_counts(self) -> Dict[str, int]:
        counts = {s: 0 for s in REPLICA_STATES}
        for rep in self.replicas:
            with rep._lock:
                counts[rep.state] += 1
        return counts

    def reference_executor(self):
        """The first live replica's executor (net/params template for
        reload loads and bench input shapes)."""
        for rep in self.replicas:
            with rep._lock:
                dead = rep.state == DEAD
            if not dead and rep.executor is not None:
                return rep.executor
        raise RuntimeError("no live replica in the fleet")

    # ---- routing + failover ---------------------------------------------- #
    def _pick(self, exclude: frozenset) -> Optional[Replica]:
        best = None
        best_key = None
        for rep in self.replicas:
            if rep.index in exclude:
                continue
            with rep._lock:
                if rep.state != SERVING:
                    continue
            key = (rep.load(), rep.index)
            if best is None or key < best_key:
                best, best_key = rep, key
        return best

    def submit(self, inputs, deadline_s: Optional[float] = None,
               timeout_s: float = 30.0):
        """Route one request to the least-loaded SERVING replica; on a
        replica death mid-request, re-dispatch on a survivor. Returns
        ``(outputs, replica)``. Raises ShedError only for explicit
        fleet-wide backpressure, DeadlineError when the request's own
        deadline expired, ValueError for a malformed request."""
        t0 = time.monotonic()
        # the request's deadline is ABSOLUTE across reroutes: each batcher
        # admission recomputes now + deadline_s, so a failover must pass
        # the REMAINING budget, never restart the clock (the single-engine
        # path's contract, fleet-wide)
        deadline = None if deadline_s is None else t0 + float(deadline_s)
        with self._lock:
            if self._closing:
                raise ShuttingDownError("fleet is shutting down")
        tried: set = set()
        queue_full = 0
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise DeadlineError(
                        f"deadline expired after "
                        f"{time.monotonic() - t0:.3f}s (rerouting)")
            rep = self._pick(frozenset(tried))
            if rep is None:
                with self._lock:
                    self.fleet_sheds += 1
                if queue_full:
                    raise ShedError(
                        f"all {queue_full} serving replicas at queue "
                        f"capacity")
                raise ShedError("no serving replica available")
            with rep._lock:
                rep.routed += 1
            with self._lock:
                self.routed_total += 1
            try:
                out = rep.batcher.submit(inputs, deadline_s=remaining,
                                         timeout_s=timeout_s)
            except DeadlineError:
                raise               # the REQUEST's deadline — not a reroute
            except ShedError as e:
                with rep._lock:
                    dead = rep.state == DEAD
                tried.add(rep.index)
                if dead:
                    # leftovers of a killed batcher, not backpressure: the
                    # request was accepted, so it reroutes, never sheds
                    with self._lock:
                        self.failovers += 1
                    continue
                if isinstance(e, ShuttingDownError):
                    raise           # fleet/server shutdown — explicit shed
                queue_full += 1
                continue            # a FULL live replica: try the others
            except ValueError:
                raise               # malformed request — the client's error
            except Exception as e:  # noqa: BLE001 — replica failure
                self._note_failure(rep, e)
                tried.add(rep.index)
                with self._lock:
                    self.failovers += 1
                continue
            self.latency.record(time.monotonic() - t0)
            return out, rep

    def _catch_up_reload(self, rep: Replica) -> None:
        """Bring a late-warming replica onto the latest rolled params —
        without this, warm_async + a reload mid-warm-up would leave it
        serving its factory-loaded weights with no error anywhere."""
        with self._lock:
            pending = self._last_reload
        if pending is None:
            return
        gen, params = pending
        with rep._lock:
            behind = (rep.reload_generation < gen
                      and rep.executor is not None)
        if not behind:
            return
        try:
            rep.executor.swap_params(params)
        except Exception as e:  # noqa: BLE001 — keep serving, stay visible
            log(f"serving: replica {rep.index} failed to catch up to "
                f"reload gen {gen}: {type(e).__name__}: {e}")
            return
        with rep._lock:
            if rep.reload_generation < gen:
                rep.reload_generation = gen
        log(f"serving: replica {rep.index} caught up to reload gen {gen}")

    def _note_failure(self, rep: Replica, err: BaseException) -> None:
        """Failure detection: dispatch errors and wedged-submit timeouts
        count toward ``failure_threshold``; past it the replica is DEAD
        (its queue fans out and reroutes)."""
        with rep._lock:
            rep.failures += 1
            kill = rep.failures >= self.failure_threshold
        if kill:
            self._mark_dead(rep, f"{type(err).__name__}: {err}")

    # ---- rolling hot-reload ---------------------------------------------- #
    def rolling_reload(self, new_params,
                       drain_timeout_s: Optional[float] = None) -> int:
        """Drain and swap SERVING replicas one at a time. The sequential
        loop under ``_reload_lock`` IS the invariant: at most one replica
        is ever DRAINING, so fleet capacity never dips by more than one
        and zero requests fail (admitted ones finish before the swap; the
        router already skips the draining replica). Returns how many
        replicas swapped; raises if any swap failed (survivors keep their
        old params — generation skew is visible per-replica in stats)."""
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else self.drain_timeout_s)
        with self._reload_lock:
            with self._lock:
                self.reload_generation += 1
                gen = self.reload_generation
                # published BEFORE the loop: any replica that warms from
                # here on catches up itself (see _catch_up_reload)
                self._last_reload = (gen, new_params)
            swapped = 0
            errors: List[str] = []
            for rep in list(self.replicas):
                with rep._lock:
                    eligible = rep.state == SERVING
                if not eligible:
                    continue
                self._transition(rep, DRAINING,
                                 reason=f"rolling reload gen {gen}")
                drained = rep.batcher.wait_idle(timeout_s=timeout)
                if not drained:
                    # a replica that cannot drain is wedged — that is the
                    # failure detector's business, not the reloader's
                    self._transition(rep, SERVING,
                                     reason="drain timeout; swap skipped")
                    errors.append(f"replica {rep.index}: drain timed out "
                                  f"after {timeout}s")
                    continue
                try:
                    rep.executor.swap_params(new_params)
                except Exception as e:  # noqa: BLE001 — keep old params
                    self._transition(rep, SERVING,
                                     reason="swap failed; old params kept")
                    errors.append(f"replica {rep.index}: "
                                  f"{type(e).__name__}: {e}")
                    continue
                with rep._lock:
                    rep.reload_generation = gen
                self._transition(rep, SERVING,
                                 reason=f"reloaded gen {gen}")
                swapped += 1
            if errors:
                raise PartialReloadError(
                    f"rolling reload gen {gen}: {swapped} swapped, "
                    f"{len(errors)} failed: " + "; ".join(errors),
                    swapped=swapped, errors=errors)
            return swapped

    # ---- introspection ---------------------------------------------------- #
    def stats_snapshot(self) -> Dict:
        """Fleet totals + one row per replica (state, queue depth, batch
        fill, sheds, reload generation — which replica is sick is visible,
        not averaged away). Replica rows key by index so the flat metrics
        endpoint renders them as ``replicas.0.queue_depth=...``."""
        rows = {str(rep.index): rep.snapshot() for rep in self.replicas}
        batchers = [rep.batcher for rep in self.replicas
                    if rep.batcher is not None]
        # state_counts takes per-replica locks — outside the manager lock
        # (the transition path holds them in the opposite order)
        states = self.state_counts()
        with self._lock:
            snap = {
                "n_replicas": len(self.replicas),
                "states": states,
                "routing": {
                    "routed": self.routed_total,
                    "failovers": self.failovers,
                    "fleet_sheds": self.fleet_sheds,
                },
                "deaths": self.deaths,
                "reload_generation": self.reload_generation,
                "max_concurrent_draining": self.max_concurrent_draining,
            }
        snap["latency"] = self.latency.summary()           # front door
        snap["replica_latency"] = LatencyWindow.merged_summary(
            [b.latency for b in batchers])                 # pooled replicas
        snap["shed"] = sum(b.shed_count for b in batchers)
        snap["batches"] = sum(b.batches for b in batchers)
        snap["queue_depth"] = sum(b.queue_depth for b in batchers)
        snap["rows_served"] = sum(
            getattr(rep.executor, "rows_served", 0) or 0
            for rep in self.replicas if rep.executor is not None)
        snap["replicas"] = rows
        return snap

    # ---- shutdown --------------------------------------------------------- #
    def shutdown(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Refuse new submissions fleet-wide, then close every replica's
        batcher (with ``drain``, every admitted request completes)."""
        with self._lock:
            self._closing = True
        for rep in self.replicas:
            if rep.batcher is not None:
                rep.batcher.close(drain=drain, timeout_s=timeout_s)

    def close(self) -> None:
        self.shutdown()
