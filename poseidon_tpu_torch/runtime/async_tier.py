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

**The fabric** (``train --async_ssp --slice``, ``parallel/fabric.py``):
``FabricTier`` is the tier of a slice's leader, with the slice id as its
worker id and ``SliceArena`` in place of ``ArenaMirror`` (the slice's
canonical arena gathered over the slice group, exchanged as one flat
leaf, the refresh broadcast to the members); ``SliceMember`` is the hook
of the slice's other ranks, which never dial the service.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.workload import Shard, member_shard
from ..parallel.async_ssp import AsyncSSPClient, ParamService
from .cluster import (RENDEZVOUS_DEADLINE_S, env_world, is_elastic_joiner,
                      slice_world)
from .metrics import log
from .spans import recorder as _spans

SERVICE_ENV = "POSEIDON_ASYNC_SERVICE"
DEFAULT_SERVICE_PORT = 12356
# set (to anything) to have every slice member log its parameters'
# digest after each refresh (SliceArena)
DIGEST_ENV = "POSEIDON_FABRIC_DIGEST"


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

    # the phases d2h and h2d add to a tier's ``timings`` (seconds)
    phases = ("d2h_s", "h2d_s")

    def d2h(self, timings: Optional[Dict] = None) -> np.ndarray:
        """A copy of the device arena (waits for the steps in flight)."""
        t0 = time.perf_counter()
        self.host.copy_(self.step.flat_w)
        out = self._np.copy()
        if timings is not None:
            timings["d2h_s"] += time.perf_counter() - t0
        return out

    def h2d(self, flat: np.ndarray, timings: Optional[Dict] = None,
            members=()) -> None:
        """``flat`` into the device arena in place (same storage, so the
        forward and the update see it). The copy completes before this
        returns: the host buffer is rewritten by the next call."""
        t0 = time.perf_counter()
        np.copyto(self._np, flat)
        with torch.no_grad():
            self.step.flat_w.copy_(self.host)
        if timings is not None:
            timings["h2d_s"] += time.perf_counter() - t0


class SliceArena:
    """The two-tier fabric's side of the arena (``parallel/fabric.py``'s
    process model): the slice's canonical parameters through the slice's
    own process group (``step.group``), in the canonical one-device layout
    (``Net.arena_layout()``), exchanged as the one-leaf arena tree.

    Every member of the slice calls ``d2h`` and ``h2d`` in the same order
    (both are collectives); only the leader holds the host buffer.

    - ``d2h``: the gather (``canonical_params``: tp leaves all-gathered;
      the canonical step's arena is whole after every update, its fsdp
      shards all-gathered in the step) packed into a device buffer, then,
      on the leader, one D2H into a (pinned, on a GPU) host buffer.
    - ``h2d``: on the leader one H2D of the refreshed flat; then a
      header (the live slice ids) and ``step.load_weights`` broadcast from
      the leader, each member writing the arena and its own tp shards
      into its own buffers.

    ``phases`` are the timings each adds to: gather and broadcast on
    every member, the copies on the leader alone.

    With ``POSEIDON_FABRIC_DIGEST`` set, every member logs the sha256 of
    its canonical parameters after each ``h2d`` (a gather more): the
    members of a slice print the same digest as their leader."""

    HEADER = 256     # int64 slots: the member count, then the ids

    def __init__(self, step, leader: bool, slice_id: int = 0):
        from ..parallel.mesh import DataGroup
        self.step = step
        self.leader = leader
        self.slice_id = slice_id
        self.phases = (("gather_s", "d2h_s", "h2d_s", "broadcast_s")
                       if leader else ("gather_s", "broadcast_s"))
        self.group = step.group or DataGroup.single(step.net.device)
        self.layout = step.net.arena_layout()
        dev = step.net.device
        self.canon = torch.zeros(self.layout.total, dtype=torch.float32,
                                 device=dev)
        self._header = torch.zeros(self.HEADER, dtype=torch.int64,
                                   device=dev)
        self.host = None
        if leader:
            self.host = torch.empty(self.layout.total, dtype=torch.float32,
                                    pin_memory=dev.type == "cuda")
            self._np = self.host.numpy()
        self.digest = bool(os.environ.get(DIGEST_ENV))
        self.refreshes = 0

    def tree_of(self, flat: np.ndarray) -> Dict:
        from ..parallel.fabric import arena_tree
        return arena_tree(flat)

    def flat_of(self, tree: Dict) -> np.ndarray:
        from ..parallel.fabric import arena_flat
        return arena_flat(tree)

    def _sync(self) -> None:
        if self.canon.device.type == "cuda":
            torch.cuda.synchronize(self.canon.device)

    def _gather(self) -> None:
        with torch.no_grad():
            self.layout.pack(self.step.canonical_params(self.step.params()),
                             self.canon)
        self._sync()

    def d2h(self, timings: Optional[Dict] = None) -> Optional[np.ndarray]:
        """Every member: the gather. The leader: the canonical flat on the
        host (None elsewhere)."""
        t0 = time.perf_counter()
        self._gather()
        t1 = time.perf_counter()
        out = None
        if self.leader:
            self.host.copy_(self.canon)
            out = self._np.copy()
        if timings is not None:
            timings["gather_s"] += t1 - t0
            if self.leader:
                timings["d2h_s"] += time.perf_counter() - t1
        return out

    def h2d(self, flat: Optional[np.ndarray],
            timings: Optional[Dict] = None, members=()) -> List[int]:
        """The leader's ``flat`` (and its live slice ids ``members``) to
        every member, written into each member's step; returns the ids."""
        t0 = time.perf_counter()
        if self.leader:
            members = sorted(members)
            if len(members) >= self.HEADER:
                raise ValueError(f"{len(members)} live slices do not fit "
                                 f"the fabric's {self.HEADER}-slot header")
            np.copyto(self._np, flat)
            head = torch.zeros(self.HEADER, dtype=torch.int64)
            head[0] = len(members)
            head[1:1 + len(members)] = torch.tensor(members,
                                                    dtype=torch.int64)
            with torch.no_grad():
                self.canon.copy_(self.host)
                self._header.copy_(head)
        t1 = time.perf_counter()
        with torch.no_grad():
            self.group.broadcast_(self._header)
            # the leader's arena and tp leaves to every member, each
            # member's own shard written into its own allocations
            self.step.load_weights(self.layout.unpack(self.canon))
        self._sync()
        head = self._header.cpu()
        ids = [int(v) for v in head[1:1 + int(head[0])]]
        if timings is not None:
            if self.leader:
                timings["h2d_s"] += t1 - t0
            timings["broadcast_s"] += time.perf_counter() - t1
        self.refreshes += 1
        if self.digest:
            self._gather()
            digest = hashlib.sha256(
                self.canon.cpu().numpy().tobytes()).hexdigest()
            log(f"fabric digest: slice {self.slice_id} rank-in-slice "
                f"{self.group.rank} refresh {self.refreshes} sha256 "
                f"{digest}")
        return ids


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
        self.rank, self.n_procs, coord = self._identity()
        self.staleness = staleness
        self.sync_every = max(1, sync_every)
        self.mirror = self._make_mirror(step)
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
        self._members: Tuple[int, ...] = tuple(sorted(self.client.members))
        self._prev = self.mirror.flat_of(cache)
        self.mirror.h2d(self._prev, members=self._live())
        self._iters_since = 0
        # seconds summed over the flushes (one a clock in the engine's
        # loop): the mirror's phases (device->host copy, and host->device
        # copy; the fabric's gather and broadcast too), push enqueue (the
        # delta and the non-blocking send), refresh (pull + cache
        # rebuild), gate
        self.timings = {**{k: 0.0 for k in self.mirror.phases},
                        "push_s": 0.0, "refresh_s": 0.0, "gate_s": 0.0,
                        "flushes": 0}
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
    def _identity(self) -> Tuple[int, int, Optional[str]]:
        """(worker id, worker count, coordinator): the identity this
        process speaks the protocol under. Here one launcher rank is one
        SSP worker; ``FabricTier`` makes one SLICE one worker."""
        return env_world()

    def _make_mirror(self, step):
        return ArenaMirror(step)

    def _mirror(self) -> None:
        """After every push: nothing here (a worker's oplog dies with it,
        the bounded-loss failure model); ``FabricTier`` mirrors the
        leader's oplog into the slice ledger."""

    def _live(self) -> Tuple[int, ...]:
        """The current member list, this worker in it."""
        return tuple(sorted(set(self.client.members) | {self.rank}))

    def _shard_of(self, members) -> Shard:
        return member_shard(members, self.rank)

    def data_shard(self) -> Shard:
        """This worker's record shard under the CURRENT member list."""
        return self._shard_of(self._live())

    def sync_membership(self, engine) -> bool:
        """Reshard the engine's data if membership changed since the last
        look (called at creation and after every flush)."""
        mem = self._live()
        if mem == self._members:
            return False
        old, self._members = self._members, mem
        log(f"async-SSP tier: membership changed {list(old)} -> "
            f"{list(mem)}; resharding data assignment", rank=self.rank)
        if engine is not None and hasattr(engine, "reshard_data"):
            engine.reshard_data(self._shard_of(mem))
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
        with _spans.span("async_d2h", "async", {"rank": self.rank}):
            cur = self.mirror.d2h(t)
        t1 = time.perf_counter()
        delta = self.mirror.tree_of(cur - self._prev)
        clock = self.client.push(delta)
        self._mirror()
        # exception safety: if refresh() raises, a retrying caller must
        # never re-derive (and double-push) the delta just enqueued
        self._prev = cur
        self._iters_since -= self.sync_every
        while self._iters_since >= self.sync_every:
            # the remaining windows' updates are in the first flush; the
            # clock advances on empty deltas
            clock = self.client.push({})
            self._mirror()
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
            self.mirror.h2d(self._prev, t, self._live())
        t["push_s"] += t2 - t1
        t["refresh_s"] += t3 - t2
        t["gate_s"] += t4 - t3
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
                final = self.mirror.flat_of(self.service.anchor).copy()
            self.mirror.h2d(final, members=self._live())
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


def require_slice(sw=None):
    """``sw``, else this process's slice (``runtime/cluster.slice_world``);
    refused when the slice env is unset."""
    sw = sw if sw is not None else slice_world()
    if sw is None:
        raise ValueError(
            "--slice requires the slice env contract: set "
            "POSEIDON_SLICE_ID and POSEIDON_SLICE_SIZE "
            "(runtime/cluster.slice_world)")
    return sw


def _slice_shard(step, members, slice_id: int) -> Shard:
    """The two-tier shard of this rank: outer by the live slice ids,
    inner by the step's batch shard (tp replicas share one)."""
    from ..parallel.fabric import two_tier_shard
    group = step.group
    index, count = ((group.batch_index, group.batch_shards)
                    if group is not None else (0, 1))
    return two_tier_shard(members, slice_id, range(count), index)


class FabricTier(AsyncSSPTier):
    """The two-tier fabric's engine hook on a slice's LEADER (``train
    --async_ssp --slice``; ``parallel/fabric.py``). The DCN identity is
    the SLICE id and the roster is counted in whole slices, so the
    service gates, shards and admits/retires whole slices. The exchange
    is ``SliceArena``'s: the slice's canonical arena gathered over the
    slice group, pushed as one flat leaf, the refresh broadcast back to
    every member. After every push the leader's oplog is mirrored into
    the slice ledger (``_mirror``). The data shard is two-tier: outer by
    live slice id, inner by the step's batch shard.

    Refused: no slice env; a process that is not its slice's leader (a
    second client under one slice id would fork the push-seq stream and
    break exactly-once; the other members run ``SliceMember``)."""

    def __init__(self, step, staleness: int, slice_assignment=None,
                 **kwargs):
        from ..config import fabric_config
        from ..parallel.fabric import SliceLedger
        sw = require_slice(slice_assignment)
        if not sw.is_leader:
            raise ValueError(
                f"rank-in-slice {sw.rank_in_slice} of slice {sw.slice_id} "
                f"is not the leader: only the leader (rank-in-slice 0) "
                f"speaks the DCN protocol — a second client under slice id "
                f"{sw.slice_id} would fork the push-seq stream and break "
                f"exactly-once. Non-leader ranks run the intra-slice SPMD "
                f"program only.")
        self.slice_assignment = sw
        self.ledger = SliceLedger()
        self._fabric_cfg = fabric_config()
        super().__init__(step, staleness, **kwargs)
        log(f"fabric tier: slice {sw.slice_id} of {self.n_procs} "
            f"({sw.slice_size} process(es)/slice, leader rank-in-slice 0) "
            f"speaking the DCN tier as worker {self.rank}")

    def _identity(self) -> Tuple[int, int, Optional[str]]:
        _, _, coord = env_world()
        sw = self.slice_assignment
        return sw.slice_id, sw.n_slices, coord

    def _make_mirror(self, step):
        return SliceArena(step, leader=True,
                          slice_id=self.slice_assignment.slice_id)

    def _mirror(self) -> None:
        if self._fabric_cfg.ledger_mirroring:
            self.ledger.mirror(self.client)

    def _shard_of(self, members) -> Shard:
        return _slice_shard(self.mirror.step, members, self.rank)


class SliceMember:
    """The engine hook on a slice's non-leader ranks (``train --async_ssp
    --slice``): no client, no service. It takes part in the leader's
    collectives in the leader's order: the service seed's gather (slice 0
    only), the join's broadcast, at every flush the gather and the
    refresh broadcast, at the end the final anchor's broadcast (slice 0
    only); the broadcast's header carries the live slice ids, which
    re-cut this rank's two-tier data shard. It blocks in the broadcast
    while its leader waits at the gate."""

    def __init__(self, step, staleness: int = 0, sync_every: int = 1,
                 slice_assignment=None, **_dcn_options):
        sw = require_slice(slice_assignment)
        if sw.is_leader:
            raise ValueError(f"rank-in-slice 0 leads slice {sw.slice_id}: "
                             f"it runs FabricTier")
        self.slice_assignment = sw
        self.rank = env_world()[0]
        self.sync_every = max(1, sync_every)
        self.mirror = SliceArena(step, leader=False, slice_id=sw.slice_id)
        if sw.slice_id == 0:
            self.mirror.d2h()           # the service's seed
        self._members = tuple(self.mirror.h2d(None))   # the join's anchor
        self._iters_since = 0
        self.timings = {**{k: 0.0 for k in self.mirror.phases},
                        "flushes": 0}

    def data_shard(self) -> Shard:
        return _slice_shard(self.mirror.step, self._members,
                            self.slice_assignment.slice_id)

    def membership_counters(self) -> Dict[str, float]:
        return {"members": float(len(self._members))}

    def comm_counters(self) -> Dict[str, float]:
        return {}

    def due(self, n_iters: int) -> bool:
        return self._iters_since + n_iters >= self.sync_every

    def after_iters(self, engine, n_iters: int) -> None:
        self._iters_since += n_iters
        if self._iters_since < self.sync_every:
            return
        with _spans.span("async_flush", "async", {"rank": self.rank}):
            self.mirror.d2h(self.timings)
            while self._iters_since >= self.sync_every:
                self._iters_since -= self.sync_every
            mem = tuple(self.mirror.h2d(None, self.timings))
        self.timings["flushes"] += 1
        if mem != self._members:
            self._members = mem
            if engine is not None and hasattr(engine, "reshard_data"):
                engine.reshard_data(self.data_shard())

    def finish(self, engine) -> Dict[str, float]:
        if self._iters_since:
            self._iters_since = self.sync_every  # force the flush
            self.after_iters(engine, 0)
        if self.slice_assignment.slice_id == 0:
            self.mirror.h2d(None)       # the final anchor
        flushes = max(1, self.timings["flushes"])
        out = {f"async_{k.removesuffix('_s')}_ms_per_flush":
               round(1e3 * v / flushes, 3)
               for k, v in self.timings.items() if k != "flushes"}
        out["async_flushes"] = float(self.timings["flushes"])
        sw = self.slice_assignment
        log(f"fabric member (rank {self.rank}, rank-in-slice "
            f"{sw.rank_in_slice} of slice {sw.slice_id}): "
            + ", ".join(f"{k}={v}" for k, v in out.items()))
        return out

    def close(self) -> None:
        """Nothing to tear down: the slice group is the engine's."""
