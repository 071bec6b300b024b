"""Engine hook for the wait-free async-SSP process tier (the port of
``poseidon_tpu/runtime/async_tier.py``'s ``AsyncSSPTier``).

``train --async_ssp --staleness N`` under the launcher env contract: each
process keeps its own local synchronous step (its own device, its own
momentum), and this tier owns the only cross-process exchange. Every
``sync_every`` optimizer iterations it flushes the parameter increment to
the rank-0 ``ParamService`` (non-blocking), rebuilds the read-my-writes
cache, and gates the next clock on the SSP window: the Bösen execution
model under the unmodified Engine loop. No process group exists in this
mode; rank and world come from ``runtime/cluster.env_world``.

**The arena owns the parameters.** The train step's leaves are views of
``TrainStep.flat_w``, so the tier never replaces the engine's params: it
takes ONE device-to-host copy of ``flat_w`` into a (pinned, on a GPU)
host buffer at each clock, and after the refresh writes the cache back
into ``flat_w`` in place with ONE host-to-device copy. Both copies and the
push and refresh between them are timed (``timings``, seconds summed over
the clocks) and traced as spans.

**Where the service listens.** The ``POSEIDON_ASYNC_SERVICE`` env
(``host:port``), else the coordinator: ``host:port`` (or
``tcp://host:port``) listens on ``port + 1``, as the JAX tier does; an
explicit ``service_port`` replaces the port. A ``file://`` coordinator
names no host or port, and then the env or the port is required. The
client's rendezvous deadline is the cluster's
(``POSEIDON_RENDEZVOUS_DEADLINE_S``): an unreachable service raises,
nothing falls back to training alone.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.workload import Shard, member_shard
from ..parallel.async_ssp import AsyncSSPClient, ParamService
from .cluster import RENDEZVOUS_DEADLINE_S, env_world, is_elastic_joiner
from .metrics import log
from .spans import recorder as _spans

SERVICE_ENV = "POSEIDON_ASYNC_SERVICE"
DEFAULT_SERVICE_PORT = 12356


def resolve_service_addr(coordinator: Optional[str],
                         service_port: Optional[int] = None
                         ) -> Tuple[str, Optional[int]]:
    """(host, port) of the rank-0 service by the module docstring's
    precedence; port None means "the default port"."""
    addr = os.environ.get(SERVICE_ENV)
    if addr:
        host, port = addr.rsplit(":", 1)
        return host, (int(port) if service_port is None else service_port)
    host = "127.0.0.1"
    if coordinator:
        if coordinator.startswith("file://"):
            if service_port is None:
                raise ValueError(
                    f"coordinator {coordinator!r} names no service host or "
                    f"port: set {SERVICE_ENV}=host:port (or pass "
                    f"service_port) for the async-SSP service")
            return host, service_port
        hostport = coordinator.split("://", 1)[-1]
        chost, cport = hostport.rsplit(":", 1)
        return chost, (int(cport) + 1 if service_port is None
                       else service_port)
    return host, service_port


class ArenaMirror:
    """The host side of the train step's flat arena: one D2H of
    ``flat_w`` (into a pinned buffer on a GPU) and the per-leaf numpy
    views of it; one H2D of a host tree back into ``flat_w``, in place."""

    def __init__(self, step):
        self.step = step
        self.arena = step.arena
        pin = step.flat_w.device.type == "cuda"
        self.host = torch.empty(self.arena.total, dtype=torch.float32,
                                pin_memory=pin)
        self._np = self.host.numpy()

    def tree_of(self, flat: np.ndarray) -> Dict:
        """Per-leaf views of a flat host array, in the parameters'
        shapes."""
        out: Dict = {}
        for s in self.arena.slots:
            out.setdefault(s.layer, {})[s.pname] = \
                flat[s.offset:s.offset + s.size].reshape(s.shape)
        return out

    def flat_of(self, tree: Dict) -> np.ndarray:
        out = np.empty(self.arena.total, np.float32)
        for s in self.arena.slots:
            out[s.offset:s.offset + s.size] = np.asarray(
                tree[s.layer][s.pname], np.float32).reshape(-1)
        return out

    def d2h(self) -> np.ndarray:
        """A copy of the device arena (waits for the steps in flight)."""
        self.host.copy_(self.step.flat_w)
        return self._np.copy()

    def h2d(self, flat: np.ndarray) -> None:
        """``flat`` into the device arena in place (same storage, so the
        forward and the update see it). The copy completes before this
        returns: the host buffer is rewritten by the next call."""
        np.copyto(self._np, flat)
        with torch.no_grad():
            self.step.flat_w.copy_(self.host)


class AsyncSSPTier:
    """Owns the service (rank 0), the client, and the flush cadence."""

    def __init__(self, step, staleness: int, sync_every: int = 1,
                 service_port: Optional[int] = None,
                 heartbeat_s: Optional[float] = None,
                 liveness_timeout_s: Optional[float] = None,
                 reconnect_deadline_s: Optional[float] = None,
                 gate_timeout_s: float = 120.0,
                 first_gate_timeout_s: Optional[float] = None,
                 comm_budget_mbps: Optional[float] = None,
                 comm_priority_frac: Optional[float] = None,
                 comm_adaptive: Optional[bool] = None,
                 comm_wire_dtype: Optional[str] = None):
        self.rank, self.n_procs, coord = env_world()
        self.staleness = staleness
        self.sync_every = max(1, sync_every)
        self.mirror = ArenaMirror(step)
        # managed communication (SSPAggr): None knobs resolve against the
        # global ManagedCommConfig; budget <= 0 keeps the dense path
        from .. import config as _config
        mc = _config.managed_comm_config()
        self.comm_budget_mbps = (mc.budget_mbps if comm_budget_mbps is None
                                 else comm_budget_mbps)
        self.comm_priority_frac = (mc.priority_frac
                                   if comm_priority_frac is None
                                   else comm_priority_frac)
        self.comm_adaptive = (mc.adaptive if comm_adaptive is None
                              else comm_adaptive)
        self.comm_wire_dtype = (mc.wire_dtype if comm_wire_dtype is None
                                else comm_wire_dtype)
        # the gate's backstop; the FIRST clock's gate also waits on peers
        # still building their step (kernel builds on a GPU), so it gets
        # its own, generous timeout unless the caller pins one
        self.gate_timeout_s = gate_timeout_s
        self.first_gate_timeout_s = (
            first_gate_timeout_s if first_gate_timeout_s is not None
            else max(1800.0, 10.0 * gate_timeout_s))
        self._gated_once = False
        host, port = resolve_service_addr(coord, service_port)
        if port is None:
            port = DEFAULT_SERVICE_PORT
        self.service = None
        if self.rank == 0:
            # only the service seed needs rank 0's host copy: every rank's
            # own view comes from join()'s anchor pull below
            self.service = ParamService(
                self.mirror.tree_of(self.mirror.d2h()),
                n_workers=self.n_procs, host=host, port=port,
                liveness_timeout_s=liveness_timeout_s)
            port = self.service.port
        self.client = AsyncSSPClient(
            self.rank, (host, port), staleness, n_workers=self.n_procs,
            retry_s=RENDEZVOUS_DEADLINE_S, heartbeat_s=heartbeat_s,
            reconnect_deadline_s=reconnect_deadline_s,
            budget_mbps=(self.comm_budget_mbps
                         if self.comm_budget_mbps > 0 else None),
            priority_frac=self.comm_priority_frac,
            adaptive=self.comm_adaptive,
            wire_dtype=self.comm_wire_dtype)
        # one join path for a fresh worker (a no-op pull at clock -1), a
        # restart (the push stream resumes past its exactly-once mark) and
        # an elastic joiner (admitted at the rendezvous anchor clock); the
        # anchor it returns seeds every rank (the init broadcast)
        cache, clocks = self.client.join()
        applied = clocks.get(self.rank, -1)
        if is_elastic_joiner(self.rank, self.n_procs):
            log(f"async-SSP tier: rank {self.rank} ADMITTED into the live "
                f"job at join clock {applied} (members "
                f"{sorted(self.client.members)})")
        elif applied >= 0:
            log(f"async-SSP tier: rank {self.rank} rejoined at clock "
                f"{applied}; push stream resumes at {applied + 1}",
                rank=self.rank)
        self._prev = self.mirror.flat_of(cache)
        self.mirror.h2d(self._prev)
        self._iters_since = 0
        self._members: Tuple[int, ...] = tuple(sorted(self.client.members))
        # seconds summed over the flushes (one a clock in the engine's
        # loop): device->host copy, push enqueue (the delta and the
        # non-blocking send), refresh (pull + cache rebuild), gate,
        # host->device copy
        self.timings = {"d2h_s": 0.0, "push_s": 0.0, "refresh_s": 0.0,
                        "gate_s": 0.0, "h2d_s": 0.0, "flushes": 0}
        managed = (f", managed comm {self.comm_budget_mbps:g} Mbit/s "
                   f"(priority_frac {self.comm_priority_frac:g}, "
                   f"adaptive {'on' if self.comm_adaptive else 'off'})"
                   if self.comm_budget_mbps > 0 else "")
        if self.comm_wire_dtype:
            managed += f", wire dtype {self.comm_wire_dtype}"
        log(f"async-SSP tier: {len(self._members)} members, staleness "
            f"{staleness}, flush every {self.sync_every} iter(s), service "
            f"{host}:{port}{managed}", rank=self.rank)

    # ------------------------------------------------------------------ #
    def data_shard(self) -> Shard:
        """This worker's record shard under the CURRENT member list."""
        members = set(self.client.members) | {self.rank}
        return member_shard(members, self.rank)

    def sync_membership(self, engine) -> bool:
        """Reshard the engine's data if membership changed since the last
        look (called at creation and after every flush)."""
        mem = tuple(sorted(set(self.client.members) | {self.rank}))
        if mem == self._members:
            return False
        old, self._members = self._members, mem
        log(f"async-SSP tier: membership changed {list(old)} -> "
            f"{list(mem)}; resharding data assignment", rank=self.rank)
        if engine is not None and hasattr(engine, "reshard_data"):
            engine.reshard_data(member_shard(mem, self.rank))
        return True

    def membership_counters(self) -> Dict[str, float]:
        from .comm_stats import membership_counters
        return membership_counters(service=self.service, client=self.client)

    def comm_counters(self) -> Dict[str, float]:
        from .comm_stats import managed_comm_counters
        return managed_comm_counters(self.client)

    # ------------------------------------------------------------------ #
    def due(self, n_iters: int) -> bool:
        """Whether ``after_iters(engine, n_iters)`` will flush a clock (the
        engine hard-syncs its in-flight window first)."""
        return self._iters_since + n_iters >= self.sync_every

    def after_iters(self, engine, n_iters: int) -> None:
        """Called by Engine.train after every dispatch of ``n_iters``
        steps. The carry SUBTRACTS ``sync_every`` a flush (never resets to
        zero), so a clock always means ``sync_every`` iterations."""
        self._iters_since += n_iters
        if self._iters_since < self.sync_every:
            return
        with _spans.span("async_flush", "async", {"rank": self.rank}):
            self._flush(engine)

    def _flush(self, engine) -> None:
        t = self.timings
        t0 = time.perf_counter()
        with _spans.span("async_d2h", "async", {"rank": self.rank}):
            cur = self.mirror.d2h()
        t1 = time.perf_counter()
        delta = self.mirror.tree_of(cur - self._prev)
        clock = self.client.push(delta)
        # exception safety: if refresh() raises, a retrying caller must
        # never re-derive (and double-push) the delta just enqueued
        self._prev = cur
        self._iters_since -= self.sync_every
        while self._iters_since >= self.sync_every:
            # the remaining windows' updates are in the first flush; the
            # clock advances on empty deltas
            clock = self.client.push({})
            self._iters_since -= self.sync_every
        t2 = time.perf_counter()
        cache, _ = self.client.refresh()
        self._prev = self.mirror.flat_of(cache)
        t3 = time.perf_counter()
        timeout = (self.gate_timeout_s if self._gated_once
                   else self.first_gate_timeout_s)
        self._gated_once = True
        self.client.gate(clock + 1, timeout_s=timeout)
        t4 = time.perf_counter()
        with _spans.span("async_h2d", "async", {"rank": self.rank}):
            self.mirror.h2d(self._prev)
        t5 = time.perf_counter()
        t["d2h_s"] += t1 - t0
        t["push_s"] += t2 - t1
        t["refresh_s"] += t3 - t2
        t["gate_s"] += t4 - t3
        t["h2d_s"] += t5 - t4
        t["flushes"] += 1
        self.sync_membership(engine)

    def finish(self, engine) -> Dict[str, float]:
        """Flush the trailing iterations, report done, and on rank 0 wait
        for every member and fold the final anchor into the arena."""
        if self._iters_since:
            self._iters_since = self.sync_every  # force the flush
            self.after_iters(engine, 0)
        self.client.mark_done()
        out = {"async_blocked_s": round(self.client.blocked_s, 3),
               "async_gate_blocks": float(self.client.gate_blocks),
               "async_final_clock": float(self.client.clock),
               "async_reconnects": float(self.client.reconnects)}
        for k, v in self.comm_counters().items():
            out[f"async_comm_{k}"] = round(float(v), 4)
        if self.service is not None:
            # poll (not barrier) until the current members are done
            done, failed = self.client.wait_all_done(None)
            out["async_max_spread"] = float(self.service.max_spread)
            out["async_evictions"] = float(self.service.evictions)
            out["async_rejoins"] = float(self.service.rejoins)
            out["async_admissions"] = float(self.service.admissions)
            if failed:
                out["async_failed_workers"] = sorted(failed)
                log(f"WARNING: async-SSP workers {sorted(failed)} FAILED "
                    f"mid-run; anchor holds their applied clocks only",
                    rank=self.rank)
            # the final anchor is the job's result: into rank 0's arena so
            # the snapshot and the eval see every worker's updates
            with self.service._lock:
                self.mirror.h2d(self.mirror.flat_of(self.service.anchor))
            time.sleep(0.2)
            self.service.close()
        self.client.close()
        # every rank reports its own clock, gates, bytes and host times
        flushes = max(1, self.timings["flushes"])
        out.update({f"async_{k.removesuffix('_s')}_ms_per_flush":
                    round(1e3 * v / flushes, 3)
                    for k, v in self.timings.items() if k != "flushes"})
        log(f"async-SSP tier (rank {self.rank}): "
            + ", ".join(f"{k}={v}" for k, v in out.items()))
        return out

    def close(self) -> None:
        """Teardown on an aborted run (finish() not reached)."""
        for closer in (self.client.close,
                       (self.service.close if self.service else None)):
            if closer is None:
                continue
            try:
                closer()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
