"""The data-parallel group (the port's counterpart of the flat ``("data",)``
mesh of ``poseidon_tpu/parallel/mesh.py``).

One process per rank, one device per process: the group is this rank's
place in the world, its device and the ``torch.distributed`` process group
its collectives ride. A single process is a group of one with no process
group, and every collective on it is the identity. The named SPMD mesh
(fsdp, tp) and the two-tier DCN mesh are not in the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch


@dataclass(frozen=True)
class DataGroup:
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None      # "nccl" | "gloo"; None alone
    pg: Optional[Any] = None           # the process group; None alone

    @classmethod
    def single(cls, device) -> "DataGroup":
        return cls(rank=0, world=1, device=torch.device(device))

    @property
    def distributed(self) -> bool:
        return self.pg is not None

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
        """Destroy the process group (``init_distributed`` started it)."""
        if self.pg is not None:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


def rank_seed(seed: int, rank: int) -> int:
    """Rank r's dropout seed: the JAX step folds the device index into its
    key, so replicas draw different masks; rank 0 keeps the solver's seed,
    so a one-process run draws what it always drew."""
    return int(seed) + (int(rank) << 32)
