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

``MeshGroups`` is the SPMD case of the general form, ``NamedGroups``, that
any other named mesh takes (the LM's ``("data", "seq")``, ``("data",
"model")`` and ``("data", "seq", "model")``, ``train_lm --mode sp|tp``):
``named_axis_ranks(axes, shape)`` reshapes the ranks row-major, as JAX's
``make_mesh(axes=..., shape=...)`` reshapes ``jax.devices()``, and
``NamedGroups`` holds one ``DataGroup`` an axis plus the joint group of
the data-like axes (every axis but ``model`` and ``stage``), over which
the LM steps average their gradients (the pipeline's ``("data",
"stage")`` and ``("data", "stage", "model")`` average over ``data``
alone; ``("data", "expert")``'s joint group is the batch shard, rank
``d * E + e``). ``runtime/cluster.build_named_groups`` (or
``init_distributed(named=...)``) builds it; either mesh rides in
``DataGroup.mesh``. The LM's exchanges: ``DataGroup.ppermute_`` (the
ring shift), ``shift_`` (one neighbour's send or receive: the pipeline's
stage shift), ``all_to_all`` and its differentiable form ``AllToAll``
(Ulysses, the MoE dispatch and return); ``EXCHANGED`` counts the bytes a
rank puts into them and into the LM's all-reduces, by kind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
DCN_AXIS = "dcn"
# the named SPMD mesh's axis order (JAX's ``SPMD_AXES``): fsdp between
# data and tp, so the fsdp collectives ride the inner groups
SPMD_AXES = ("data", "fsdp", "tp")
# the LM's tensor-parallel and pipeline axes (JAX's names); every other
# axis of a named mesh is data-like: the LM steps average their gradients
# over it
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

# payload bytes this process put into each kind of exchange (a ring
# shift's or a stage shift's tensor, an all-to-all's send buffer, an
# all-reduce's tensor), counted by the callers that name the kind
EXCHANGED: Dict[str, int] = {}


def note_exchange(kind: str, t: torch.Tensor) -> None:
    EXCHANGED[kind] = EXCHANGED.get(kind, 0) + t.numel() * t.element_size()


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
    mesh: Optional["NamedGroups"] = None   # the named mesh, when set

    @classmethod
    def single(cls, device) -> "DataGroup":
        return cls(rank=0, world=1, device=torch.device(device))

    @property
    def distributed(self) -> bool:
        return self.pg is not None

    @property
    def batch_index(self) -> int:
        """Which batch shard this rank reads (and its dropout stream): the
        rank, or its index in the joint group on a named mesh (``d*F + f``
        on the SPMD mesh: tp replicas share one)."""
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

    def _staged(self, t: torch.Tensor) -> bool:
        """gloo moves CPU tensors only through send/recv and all-to-all:
        a CUDA tensor goes through a pinned host buffer on its way."""
        return self.backend == "gloo" and t.is_cuda

    @staticmethod
    def _pinned(t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of ``t``."""
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)

    def ppermute_(self, out: torch.Tensor, t: torch.Tensor,
                  shift: int = 1) -> torch.Tensor:
        """The ring shift: ``t`` to the rank at index ``(i + shift) % n``,
        ``out`` from ``(i - shift) % n``, both posted in one
        ``batch_isend_irecv`` (send first, on every rank) to the global
        ranks; returns ``out``. A group of one copies. Under gloo a CUDA
        tensor is staged through pinned host buffers (a device-to-host
        copy, the exchange, a host-to-device copy); under NCCL the device
        tensors go as they are."""
        if self.pg is None:
            return out.copy_(t)
        return self.shift_(t, out, shift)

    def shift_(self, send: Optional[torch.Tensor],
               out: Optional[torch.Tensor], shift: int = 1
               ) -> Optional[torch.Tensor]:
        """One neighbour's half of a shift: ``send`` (when given) to the
        rank at index ``(i + shift) % n`` and ``out`` (when given) filled
        from ``(i - shift) % n``, posted in one ``batch_isend_irecv`` and
        waited for; returns ``out``. A pipeline stage sends forward with
        ``shift=1`` and its cotangents back with ``shift=-1``; the first
        and last stages post one side only. Staged as ``ppermute_``."""
        import torch.distributed as dist
        ops, recv = [], None
        if send is not None:
            dst = dist.get_global_rank(self.pg,
                                       (self.rank + shift) % self.world)
            send = send.contiguous()
            if self._staged(send):
                send = self._pinned(send)
            ops.append(dist.P2POp(dist.isend, send, dst, group=self.pg))
        if out is not None:
            src = dist.get_global_rank(self.pg,
                                       (self.rank - shift) % self.world)
            if self._staged(out):
                recv = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            else:
                recv = out if out.is_contiguous() else torch.empty_like(out)
            ops.append(dist.P2POp(dist.irecv, recv, src, group=self.pg))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv is not None and recv is not out:
            out.copy_(recv)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s dim-0 chunk j to the rank at index j; returns the chunks
        received, chunk j from index j (dim 0 must be the group's size). A
        group of one returns ``t``. Under gloo a CUDA tensor is staged
        through pinned host buffers, as in ``ppermute_``."""
        if self.pg is None:
            return t
        if t.shape[0] != self.world:
            raise ValueError(f"all_to_all takes dim 0 of the group's size "
                             f"{self.world}, got {tuple(t.shape)}")
        import torch.distributed as dist
        t = t.contiguous()
        if self._staged(t):
            send = self._pinned(t)
            recv = torch.empty_like(send, pin_memory=True)
            dist.all_to_all_single(recv, send, group=self.pg)
            return recv.to(t.device)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.pg)
        return out

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


class AllToAll(torch.autograd.Function):
    """``DataGroup.all_to_all`` as a differentiable exchange: chunk j of
    dim 0 to index j forward; the cotangent's chunk j back to index j
    backward (the exchange is its own transpose). Both directions count
    under ``kind`` in ``EXCHANGED``. Ulysses' re-shards and the MoE
    dispatch and return ride it."""

    @staticmethod
    def forward(ctx, x, group: DataGroup, kind: str):
        ctx.group, ctx.kind = group, kind
        note_exchange(kind, x)
        out = group.all_to_all(x)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        note_exchange(ctx.kind, g)
        return ctx.group.all_to_all(g), None, None


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
    return named_axis_ranks(SPMD_AXES, (cfg.data, cfg.fsdp, cfg.tp),
                            joint=("data", "fsdp"))


def named_coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Rank r's coordinates on a mesh of ``shape``, row-major (the last
    axis varies fastest), as JAX reshapes its devices."""
    coords = []
    for size in reversed(tuple(shape)):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def named_axis_ranks(axes: Sequence[str], shape: Sequence[int],
                     joint: Sequence[str] = ()) -> Dict[str, List[List[int]]]:
    """{axis: [rank lists]} of a named mesh of ``shape``: for each axis the
    groups of ranks that differ along it alone, and under ``"joint"`` (when
    ``joint`` names axes) the groups that differ along those axes alone;
    each group in rank order, which is row-major over the axes it spans,
    and the groups in the order of the other axes' coordinates: the order
    every rank creates them in."""
    axes, shape = tuple(axes), tuple(int(n) for n in shape)
    if len(axes) != len(shape):
        raise ValueError(f"shape {shape} has {len(shape)} dims for "
                         f"{len(axes)} axes {axes}")
    n = 1
    for size in shape:
        n *= size
    coords = [named_coords(r, shape) for r in range(n)]

    def groups(span) -> List[List[int]]:
        def key(r):
            return tuple(c for i, c in enumerate(coords[r]) if i not in span)
        return [[r for r in range(n) if key(r) == k]
                for k in sorted({key(r) for r in range(n)})]

    out = {a: groups({i}) for i, a in enumerate(axes)}
    if joint:
        out["joint"] = groups({axes.index(a) for a in joint})
    return out


@dataclass(frozen=True)
class NamedGroups:
    """This rank's place on a general named mesh: one ``DataGroup`` an
    axis (its rank is the index along the axis) and ``joint``, the group
    of the data-like axes ``joint_axes`` (rank: the row-major index over
    them), over which the LM steps average. A group of one rank has no
    process group and its collectives are the identity."""
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    groups: Dict[str, DataGroup]
    joint: DataGroup
    joint_axes: Tuple[str, ...]

    def __getitem__(self, axis: str) -> DataGroup:
        return self.groups[axis]

    @property
    def device(self) -> torch.device:
        return self.joint.device

    def size(self, axis: str) -> int:
        return self.groups[axis].world if axis in self.groups else 1

    def index(self, axis: str) -> int:
        return self.groups[axis].rank if axis in self.groups else 0

    @property
    def batch_index(self) -> int:
        return self.joint.rank

    @property
    def n_dp(self) -> int:
        """Ranks of the joint group (tp replicas share one index)."""
        return self.joint.world

    def describe(self) -> str:
        return " x ".join(f"{a}={n}" for a, n in zip(self.axes, self.shape))


def data_like_axes(axes: Sequence[str]) -> Tuple[str, ...]:
    """The axes the LM steps average over: every one but ``model`` and
    ``stage`` (a pipeline keeps its block gradients stage-local and sums
    the others over ``stage``, never averages them)."""
    return tuple(a for a in axes if a not in (MODEL_AXIS, STAGE_AXIS))


@dataclass(frozen=True)
class MeshGroups(NamedGroups):
    """This rank's place on the named SPMD mesh: the ``NamedGroups`` of
    ``SPMD_AXES`` with the joint ``(data, fsdp)`` group, and the
    ``MeshConfig`` it was built from; ``data``, ``fsdp`` and ``tp`` name
    the axes' groups and ``coords`` the rank's (data, fsdp, tp)."""
    cfg: Any                     # config.MeshConfig

    @property
    def data(self) -> DataGroup:
        return self.groups["data"]

    @property
    def fsdp(self) -> DataGroup:
        return self.groups["fsdp"]

    @property
    def tp(self) -> DataGroup:
        return self.groups["tp"]

    @property
    def coords(self) -> Tuple[int, int, int]:
        return self.data.rank, self.fsdp.rank, self.tp.rank


def rank_seed(seed: int, rank: int) -> int:
    """Rank r's dropout seed: the JAX step folds the device index into its
    key, so replicas draw different masks; rank 0 keeps the solver's seed,
    so a one-process run draws what it always drew. On a named mesh the
    caller passes the batch-shard index (``DataGroup.batch_index``), as
    JAX folds ``data*F + fsdp``: tp replicas draw the same masks."""
    return int(seed) + (int(rank) << 32)
