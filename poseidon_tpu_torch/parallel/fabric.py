"""Two-tier training fabric: an SPMD slice as one elastic SSP worker (the
port of ``poseidon_tpu/parallel/fabric.py``; ``train --async_ssp --slice
--mesh``).

Poseidon's hierarchical sync at pod scale: INSIDE a slice the named
dp/fsdp/tp mesh (``parallel/spmd.py``) runs the step synchronously over
the slice's own ranks; BETWEEN slices one LEADER process a slice speaks
the unmodified async-SSP protocol (``parallel/async_ssp.py``) with the
slice id as its worker id, so the service's exactly-once, gate, eviction
and admit/retire rules apply to whole slices with no wire change.

**The process model.** JAX's slice is one process holding an N-device
mesh. The port's is N processes, one rank a device, joined by the slice's
own process group (``runtime/cluster.init_slice_group``:
``slice_submesh`` below hands it to ``build_mesh_groups``). Only the
leader (rank-in-slice 0) owns a client; at each flush every member takes
part in two collectives over the slice group (``runtime/async_tier.
SliceArena``): the gather of the slice's canonical parameters (tp leaves
all-gathered; the canonical step keeps the fsdp-gathered arena whole
after every update), which the leader packs into the one-leaf exchange
tree below, pushes, mirrors and refreshes; then the leader's broadcast of
the refreshed arena, which each member writes back into its own
buffers. The members block in that broadcast, so the leader's gate holds
the whole slice. Non-leaders never dial the service.

Robustness is slice-granular, as in JAX:

- **Leader failover.** The leader mirrors its push oplog (clock, pending
  payloads AS SENT, residual) into a :class:`SliceLedger` after every
  push. On leader death the min live rank takes over: it abandons the dead
  client raw, builds a fresh one under the same slice id and resumes the
  ledger through ``AsyncSSPClient.resume_oplog``, whose acked floor comes
  from the service; replays above it keep ``seq == clock``, so a push
  whose ack died with the leader dedups: exactly once across leader
  death. The ledger is shared memory in-process; replicating it across
  processes waits, as in JAX.
- **Shrink / retire.** A non-leader loss re-cuts the slice's inner data
  shard over the survivors; below ``FabricConfig.min_members`` the slice
  retires its DCN slot cleanly (flush, drain, retire RPC).
- **Slice join.** A joining slice anchors at the service's rendezvous
  clock, the ordinary elastic admit at slice granularity.

Data is cut in two tiers (:func:`two_tier_shard`): the outer cut by live
slice ids, the inner by live member ranks, composed into one record-space
shard, so any membership event re-cuts the same global permutation.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import fabric_config
from ..core.arena import ArenaLayout
from ..data.workload import Shard, member_shard
from .async_ssp import AsyncSSPClient

Tree = Dict[str, Dict[str, np.ndarray]]

# the arena-delta wire form: the whole parameter arena as ONE flat leaf,
# so a budget-tight TOPK partial push ranks magnitudes over the slice's
# whole update, not leaf by leaf
ARENA_LAYER = "arena"
ARENA_PARAM = "flat"


# --------------------------------------------------------------------------- #
# arena-delta helpers
# --------------------------------------------------------------------------- #

def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def arena_tree(flat) -> Tree:
    """Wrap a flat f32 arena buffer as the one-leaf exchange tree."""
    return {ARENA_LAYER: {ARENA_PARAM: _host_f32(flat)}}


def arena_flat(tree: Tree) -> np.ndarray:
    """Unwrap the one-leaf exchange tree back to the flat buffer."""
    return np.asarray(tree[ARENA_LAYER][ARENA_PARAM], np.float32)


def pack_arena_delta(layout, cur_params: Dict,
                     prev_flat: np.ndarray) -> Tuple[Tree, np.ndarray]:
    """Pack a slice's parameter tree through its arena layout and diff it
    against the previous packed view: (delta exchange tree, new flat
    view), on the host. The DCN tier then pushes one flat vector a
    clock."""
    flat = _host_f32(layout.pack(cur_params))
    return arena_tree(flat - prev_flat), flat


def unpack_arena_cache(layout, cache: Tree) -> Dict:
    """A refreshed DCN cache (one flat leaf) back into the per-leaf tree
    (a port ``ArenaLayout`` gives torch views of a copy)."""
    flat = arena_flat(cache)
    if isinstance(layout, ArenaLayout):
        return layout.unpack(torch.from_numpy(flat.copy()))
    return layout.unpack(flat)


# --------------------------------------------------------------------------- #
# two-tier data sharding and the slice's ranks
# --------------------------------------------------------------------------- #

def two_tier_shard(live_slices: Sequence[int], slice_id: int,
                   members: Sequence[int], rank: int) -> Shard:
    """The outer cut (by live slice id) and the inner cut (by live member
    within the slice) composed into one record-space shard. Both cuts are
    keyed by membership sets (``data/workload.member_shard``), so every
    process derives the same partition from the shared view alone."""
    outer = member_shard(live_slices, slice_id)
    inner = member_shard(members, rank)
    return Shard(outer.index * inner.count + inner.index,
                 outer.count * inner.count)


def slice_device_block(devices: Sequence, slice_id: int,
                       n_devices: int) -> List:
    """Slice ``slice_id``'s contiguous block of ``devices`` (or ranks):
    [slice_id * n_devices, (slice_id + 1) * n_devices), the
    contiguous-rank contract of ``runtime/cluster.slice_world``. Fails
    loudly when the block runs off the end."""
    lo, hi = slice_id * n_devices, (slice_id + 1) * n_devices
    if hi > len(devices):
        raise ValueError(
            f"slice {slice_id} wants devices [{lo}, {hi}) but only "
            f"{len(devices)} are visible — slice blocks are contiguous "
            f"and disjoint by contract")
    return list(devices[lo:hi])


def slice_submesh(mesh_cfg, group):
    """The slice's own named dp/fsdp/tp mesh: the slice's process group
    (``runtime/cluster.init_slice_group``, over its contiguous rank block
    of the launch roster) with ``build_mesh_groups``' axes on it when
    ``mesh_cfg`` is active, which must span the slice."""
    from ..runtime.cluster import build_mesh_groups
    if mesh_cfg is None:
        return group
    if mesh_cfg.n_devices != group.world:
        raise SystemExit(
            f"--mesh {mesh_cfg.describe()} needs {mesh_cfg.n_devices} "
            f"devices; the slice has {group.world} (POSEIDON_SLICE_SIZE)")
    if not mesh_cfg.active:
        return group
    return dataclasses.replace(group, mesh=build_mesh_groups(
        mesh_cfg, group.rank, group.device, group.backend))


# --------------------------------------------------------------------------- #
# the slice ledger
# --------------------------------------------------------------------------- #

@dataclass
class _LedgerState:
    clock: int = -1
    pending: List[Tuple[int, Dict, bool]] = field(default_factory=list)
    residual: Optional[Dict] = None
    mirrors: int = 0


class SliceLedger:
    """The slice's push-stream state: the leader's clock, its un-acked
    pending payloads AS SENT and the managed-communication residual. A
    lock-guarded object in-process; ``mirror()`` runs after every push
    returns, so at a leader's death the ledger holds every payload it may
    have flushed, and nothing newer. It holds no ack state: the acked
    floor is re-derived from the service at failover, so a stale mirror is
    safe (a replayed applied clock dedups by seq)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._s = _LedgerState()

    def mirror(self, client: AsyncSSPClient) -> None:
        """Snapshot the leader client's oplog (deep copies: the ledger
        outlives the client)."""
        clock, pending, residual = client.snapshot_oplog()
        with self._lock:
            self._s.clock = clock
            self._s.pending = pending
            self._s.residual = residual
            self._s.mirrors += 1

    def snapshot(self) -> Tuple[int, List[Tuple[int, Dict, bool]],
                                Optional[Dict]]:
        """(clock, pending, residual) for a successor's resume_oplog."""
        with self._lock:
            return (self._s.clock, list(self._s.pending), self._s.residual)

    @property
    def mirrors(self) -> int:
        with self._lock:
            return self._s.mirrors


# --------------------------------------------------------------------------- #
# the slice worker
# --------------------------------------------------------------------------- #

class SliceWorker:
    """One SPMD slice acting as ONE elastic SSP worker: the service sees
    ``worker == slice_id``. Exactly one member, the leader (min live
    rank), owns the client. Membership events (``fail_member``):

    - a non-leader dies -> the inner data cut re-keys (``data_shard``), or
      the slice retires cleanly below ``FabricConfig.min_members``;
    - the leader dies -> the min live rank is elected, the dead client is
      abandoned raw (no flush, no bye) and a fresh client for the same
      slice id resumes the ledger (``resume_oplog``);
    - the last member dies -> the slice is gone; the service evicts it.
    """

    def __init__(self, slice_id: int, members: Sequence[int],
                 addr: Tuple[str, int], staleness: int,
                 n_slices: int = 0,
                 client_opts: Optional[Dict] = None,
                 ledger: Optional[SliceLedger] = None):
        if not members:
            raise ValueError(f"slice {slice_id}: empty member list")
        self.slice_id = slice_id
        self.addr = addr
        self.staleness = staleness
        self.n_slices = n_slices
        self._client_opts = dict(client_opts or {})
        self.live: Set[int] = set(members)
        self.ledger = ledger if ledger is not None else SliceLedger()
        self._cfg = fabric_config()
        self.failovers = 0
        self.retired = False
        self.client = self._make_client()

    @property
    def leader(self) -> int:
        """The min live rank: every survivor elects the same successor
        from the shared live set alone."""
        if not self.live:
            raise RuntimeError(f"slice {self.slice_id} has no live members")
        return min(self.live)

    def _make_client(self) -> AsyncSSPClient:
        return AsyncSSPClient(self.slice_id, self.addr, self.staleness,
                              n_workers=self.n_slices,
                              **self._client_opts)

    # -- the DCN tier (leader only, ledger-mirrored) -------------------- #
    def join(self) -> Tuple[Dict, Dict[int, int]]:
        """Rendezvous the slice into the live job (the admit RPC;
        idempotent for roster slices): (anchor cache, clock table)."""
        return self.client.join()

    def push(self, delta: Dict, force_full: bool = False) -> int:
        """Flush one clock's slice update, then mirror the oplog: push
        first, mirror second (a mirror ahead of the push could hold a clock
        the sender never saw, which a successor would replay under a fresh
        seq)."""
        clock = self.client.push(delta, force_full=force_full)
        if self._cfg.ledger_mirroring:
            self.ledger.mirror(self.client)
        return clock

    def gate(self, clock: int, **kw) -> float:
        return self.client.gate(clock, **kw)

    def refresh(self) -> Tuple[Dict, Dict[int, int]]:
        return self.client.refresh()

    def retire(self) -> None:
        """Whole-slice scale-down: residual flush, drain, retire RPC."""
        self.client.leave()
        self.retired = True

    def mark_done(self) -> None:
        self.client.mark_done()

    def close(self) -> None:
        self.client.close()

    # -- membership events ---------------------------------------------- #
    def data_shard(self, live_slices: Sequence[int], rank: int) -> Shard:
        """Rank ``rank``'s shard under the current two-tier membership."""
        return two_tier_shard(live_slices, self.slice_id,
                              sorted(self.live), rank)

    def fail_member(self, rank: int) -> str:
        """A member process died: ``"shrunk"``, ``"failover"``,
        ``"retired"`` (below min_members, left cleanly) or ``"dead"`` (no
        member left)."""
        if rank not in self.live:
            raise ValueError(
                f"slice {self.slice_id}: rank {rank} is not live "
                f"({sorted(self.live)})")
        was_leader = rank == self.leader
        self.live.discard(rank)
        if not self.live:
            return "dead"
        if len(self.live) < max(1, self._cfg.min_members):
            if was_leader:
                self._failover()
            self.retire()
            return "retired"
        if was_leader:
            self._failover()
            return "failover"
        return "shrunk"

    def _failover(self) -> None:
        """The successor takes over the slice's DCN stream: the dead client
        abandoned raw, a fresh one resumes the ledger (acked floor from the
        service, pending above it replayed with their seqs, the residual
        restored verbatim)."""
        self.client.abandon()
        if self._cfg.failover_grace_s > 0:
            time.sleep(self._cfg.failover_grace_s)
        clock, pending, residual = self.ledger.snapshot()
        self.client = self._make_client()
        self.client.resume_oplog(clock, pending, residual)
        if self._cfg.ledger_mirroring:
            self.ledger.mirror(self.client)
        self.failovers += 1


# --------------------------------------------------------------------------- #
# the slice driver
# --------------------------------------------------------------------------- #

def run_slice_worker(
    slice_worker: SliceWorker,
    params: Dict,
    local_step: Callable[[Dict, int], Tuple[Dict, float]],
    n_clocks: int,
    sync_every: int = 1,
    join: bool = False,
    retire_at_clock: Optional[int] = None,
    fail_at: Optional[Dict[int, Sequence[int]]] = None,
) -> Dict:
    """Drive one slice through ``n_clocks`` DCN clocks: gate -> step(s) ->
    push -> refresh, with membership events at clock boundaries
    (``fail_at``: clock -> ranks to fail before that clock's step).
    ``local_step(cache, step_index) -> (new_params, loss)`` is the slice's
    step; the flushed increment is the parameter delta it made. Returns
    the final cache and telemetry."""
    from .async_ssp import _tree_copy, _tree_sub

    w = slice_worker
    losses: List[float] = []
    events: List[Tuple[int, str]] = []

    def result(cache):
        return {"cache": cache, "losses": losses, "events": events,
                "clock": w.client.clock, "slice_id": w.slice_id,
                "failovers": w.failovers, "retired": w.retired}

    start_clock = 0
    if join:
        cache, _ = w.join()
        start_clock = w.client.clock + 1
    else:
        cache = _tree_copy(params)
    step_i = 0
    for clock in range(start_clock, n_clocks):
        for rank in (fail_at or {}).get(clock, ()):
            events.append((clock, f"{w.fail_member(rank)}:{rank}"))
            if w.retired or not w.live:
                return result(cache)
        w.gate(clock)
        prev = _tree_copy(cache)
        for _ in range(sync_every):
            cache, loss = local_step(cache, step_i)
            step_i += 1
            losses.append(float(loss))
        w.push(_tree_sub(cache, prev))
        cache, _ = w.refresh()
        if retire_at_clock is not None and clock >= retire_at_clock:
            w.retire()
            events.append((clock, "retired:planned"))
            break
    if not w.retired:
        w.mark_done()
    return result(cache)
