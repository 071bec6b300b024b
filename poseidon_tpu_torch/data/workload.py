"""Deterministic data partitioning (the port's copy of the parts of
``poseidon_tpu/data/workload.py`` the training slice uses).

``shard_indices`` is the reference's contiguous (client x thread) range
split over [0, n) (``ps/src/ml/include/ml/util/workload_manager.hpp``)
applied to a seeded per-epoch permutation, so every shard sees a disjoint,
reshuffled slice per epoch. A single GPU is shard 0 of 1.
``sharded_source_path`` is the reference's ``_k`` suffix for databases
partitioned ahead of time (``shared_file_system``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Shard:
    index: int
    count: int

    def __post_init__(self):
        if not (0 <= self.index < self.count):
            raise ValueError(f"shard {self.index} of {self.count}")


def contiguous_range(n: int, shard: Shard) -> Tuple[int, int]:
    """Contiguous [begin, end) split; the remainder goes to the leading
    shards one element each."""
    base = n // shard.count
    rem = n % shard.count
    begin = shard.index * base + min(shard.index, rem)
    end = begin + base + (1 if shard.index < rem else 0)
    return begin, end


def shard_indices(n: int, shard: Shard, epoch: int = 0,
                  shuffle: bool = True, seed: int = 0) -> np.ndarray:
    """Indices this shard reads for the given epoch. All shards use the same
    epoch permutation (seeded identically) so shards stay disjoint."""
    if shuffle:
        perm = np.random.RandomState(seed + epoch).permutation(n)
    else:
        perm = np.arange(n)
    begin, end = contiguous_range(n, shard)
    return perm[begin:end]


def sharded_source_path(source: str, shard_index: int,
                        shared_file_system: bool) -> str:
    """The reference's `_k` suffix convention for pre-partitioned databases."""
    if shared_file_system:
        return f"{source}_{shard_index}"
    return source
