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
both process groups. The named SPMD mesh (fsdp, tp) is not in the port
yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

DATA_AXIS = "data"
DCN_AXIS = "dcn"


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

    @classmethod
    def single(cls, device) -> "DataGroup":
        return cls(rank=0, world=1, device=torch.device(device))

    @property
    def distributed(self) -> bool:
        return self.pg is not None

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
        if self.pg is not None:
            import torch.distributed as dist
            dist.broadcast(t, src=src, group=self.pg)

    def close(self) -> None:
        """Destroy the process groups (``init_distributed`` started
        them)."""
        if self.pg is not None:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


def rank_seed(seed: int, rank: int) -> int:
    """Rank r's dropout seed: the JAX step folds the device index into its
    key, so replicas draw different masks; rank 0 keeps the solver's seed,
    so a one-process run draws what it always drew."""
    return int(seed) + (int(rank) << 32)
