"""The data-parallel group (the port of ``poseidon_tpu/parallel/mesh.py``'s
flat ``("data",)`` mesh and its two-tier ``("dcn", "data")`` mesh).

One process per rank, one device per process: the group is this rank's
place in the world, its device and the ``torch.distributed`` process group
its collectives ride. A single process is a group of one with no process
group, and every collective on it is the identity.

The two-tier group splits the world into ``slices`` of ``world // slices``
ranks, JAX's ``make_mesh(axes=("dcn", "data"), shape=(S, n // S))``: rank
r sits in slice r // (n / S) at index r % (n / S), so shard rows follow
rank order as JAX's batch spec ``P(("dcn", "data"))`` does. ``intra()`` is
this rank's slice (the fast tier) and ``cross()`` the ranks at its index in
every slice (the slow tier); ``runtime/cluster.init_distributed`` builds
both process groups.

The named SPMD mesh (``SPMD_AXES``, ``config.MeshConfig``, ``train --mesh
dp2,fsdp2,tp1``) reshapes the ranks to ``(data, fsdp, tp)`` row-major, as
JAX's ``named_mesh`` reshapes its devices: rank r sits at data
``r // (F*T)``, fsdp ``(r // T) % F`` and tp ``r % T``. ``MeshGroups``
holds this rank's coordinates and one ``DataGroup`` an axis (the ranks
that differ from it along that axis alone, in axis order) plus the joint
``(data, fsdp)`` group, whose rank is the batch-shard index ``d*F + f``:
tp replicas share one batch shard, one dropout stream and one TOPK
residual. ``runtime/cluster.init_distributed(mesh_cfg=...)`` builds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

DATA_AXIS = "data"
DCN_AXIS = "dcn"
# the named SPMD mesh's axis order (JAX's ``SPMD_AXES``): fsdp between
# data and tp, so the fsdp collectives ride the inner groups
SPMD_AXES = ("data", "fsdp", "tp")


def balanced_shape(n: int, k: int) -> Tuple[int, ...]:
    """Factor ``n`` devices into ``k`` mesh axes as evenly as possible:
    prime factors dealt largest-first onto the currently-smallest axis,
    sorted descending (JAX's ``balanced_shape``; prod == n)."""
    if k <= 0:
        raise ValueError(f"need at least one axis, got {k}")
    factors = []
    m, p = n, 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1
    if m > 1:
        factors.append(m)
    shape = [1] * k
    for f in sorted(factors, reverse=True):
        shape[shape.index(min(shape))] *= f
    return tuple(sorted(shape, reverse=True))


@dataclass(frozen=True)
class DataGroup:
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None      # "nccl" | "gloo"; None alone
    pg: Optional[Any] = None           # the process group; None alone
    slices: int = 1                    # the two-tier split of the world
    slice_pg: Optional[Any] = None     # this rank's slice (> 1 rank)
    cross_pg: Optional[Any] = None     # its index across slices (> 1)
    mesh: Optional["MeshGroups"] = None   # the named SPMD mesh, when set

    @classmethod
    def single(cls, device) -> "DataGroup":
        return cls(rank=0, world=1, device=torch.device(device))

    @property
    def distributed(self) -> bool:
        return self.pg is not None

    @property
    def batch_index(self) -> int:
        """Which batch shard this rank reads (and its dropout stream): the
        rank, or ``d*F + f`` on a named mesh (tp replicas share one)."""
        return self.mesh.batch_index if self.mesh is not None else self.rank

    @property
    def batch_shards(self) -> int:
        """How many distinct batch shards the world reads."""
        return self.mesh.n_dp if self.mesh is not None else self.world

    @property
    def slice_size(self) -> int:
        return self.world // self.slices

    @property
    def slice_index(self) -> int:
        return self.rank // self.slice_size

    @property
    def index_in_slice(self) -> int:
        return self.rank % self.slice_size

    def intra(self) -> "DataGroup":
        """This rank's slice as a group of its own (the whole group when
        there is one slice)."""
        if self.slices == 1:
            return self
        return DataGroup(rank=self.index_in_slice, world=self.slice_size,
                         device=self.device, backend=self.backend,
                         pg=self.slice_pg)

    def cross(self) -> "DataGroup":
        """The ranks at this rank's index in every slice, in slice order
        (a group of one when there is one slice)."""
        return DataGroup(rank=self.slice_index, world=self.slices,
                         device=self.device, backend=self.backend,
                         pg=self.cross_pg)

    def all_reduce_(self, t: torch.Tensor, async_op: bool = False):
        """Sum ``t`` over the ranks in place; the work handle with
        ``async_op`` (None alone)."""
        if self.pg is None:
            return None
        import torch.distributed as dist
        return dist.all_reduce(t, group=self.pg, async_op=async_op)

    def reduce_scatter_(self, out: torch.Tensor, t: torch.Tensor,
                        async_op: bool = False):
        """Sum ``t`` over the ranks and keep this rank's 1/world chunk of
        dim 0 in ``out`` (alone: a copy); the work handle with
        ``async_op``. gloo runs it on CUDA tensors too (checked on the
        card by ``chip_smoke.py``'s ``[spmd]``); nothing is moved to the
        CPU behind the caller's back."""
        if self.pg is None:
            out.copy_(t)
            return None
        import torch.distributed as dist
        return dist.reduce_scatter_tensor(out, t, group=self.pg,
                                          async_op=async_op)

    def all_gather_into(self, out: torch.Tensor, t: torch.Tensor,
                        async_op: bool = False):
        """Every rank's ``t`` into ``out`` along dim 0 in rank order
        (alone: a copy); the work handle with ``async_op``."""
        if self.pg is None:
            out.copy_(t)
            return None
        import torch.distributed as dist
        return dist.all_gather_into_tensor(out, t, group=self.pg,
                                           async_op=async_op)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order."""
        if self.pg is None:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(t)
                                     for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts, dim=0)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        """``t`` from the group's rank ``src`` to every rank."""
        if self.pg is not None:
            import torch.distributed as dist
            dist.broadcast(t, src=dist.get_global_rank(self.pg, src),
                           group=self.pg)

    def close(self) -> None:
        """Destroy the process groups (``init_distributed`` started
        them)."""
        if self.pg is not None:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


def mesh_coords(rank: int, cfg) -> Tuple[int, int, int]:
    """Rank r's (data, fsdp, tp) coordinates on a ``MeshConfig``'s mesh
    (row-major over ``SPMD_AXES``, as JAX reshapes its devices)."""
    f, t = cfg.fsdp, cfg.tp
    return rank // (f * t), (rank // t) % f, rank % t


def mesh_axis_ranks(cfg) -> dict:
    """{axis: [rank lists]} of every group of the named mesh, in the
    order every rank creates them: the data, fsdp and tp groups (the ranks
    that differ along that axis alone, in axis order) and the joint
    ``(data, fsdp)`` groups (one a tp index, in batch-shard order)."""
    n = cfg.n_devices
    coords = [mesh_coords(r, cfg) for r in range(n)]

    def groups(axis: int) -> List[List[int]]:
        keys = sorted({tuple(c for i, c in enumerate(co) if i != axis)
                       for co in coords})
        return [[r for r in range(n)
                 if tuple(c for i, c in enumerate(coords[r]) if i != axis)
                 == k] for k in keys]

    return {"data": groups(0), "fsdp": groups(1), "tp": groups(2),
            "joint": [[r for r in range(n) if coords[r][2] == t]
                      for t in range(cfg.tp)]}


@dataclass(frozen=True)
class MeshGroups:
    """This rank's place on the named SPMD mesh: its (data, fsdp, tp)
    coordinates and a ``DataGroup`` an axis (``data``, ``fsdp``, ``tp``)
    and for the joint ``(data, fsdp)`` axes (``joint``), each with the
    rank's index along it; a group of one rank has no process group and
    its collectives are the identity."""
    cfg: Any                     # config.MeshConfig
    data: DataGroup
    fsdp: DataGroup
    tp: DataGroup
    joint: DataGroup

    @property
    def coords(self) -> Tuple[int, int, int]:
        return self.data.rank, self.fsdp.rank, self.tp.rank

    @property
    def batch_index(self) -> int:
        return self.joint.rank

    @property
    def n_dp(self) -> int:
        """Distinct batch shards = data * fsdp (tp replicas share one)."""
        return self.cfg.data * self.cfg.fsdp


def rank_seed(seed: int, rank: int) -> int:
    """Rank r's dropout seed: the JAX step folds the device index into its
    key, so replicas draw different masks; rank 0 keeps the solver's seed,
    so a one-process run draws what it always drew. On a named mesh the
    caller passes the batch-shard index (``DataGroup.batch_index``), as
    JAX folds ``data*F + fsdp``: tp replicas draw the same masks."""
    return int(seed) + (int(rank) << 32)
