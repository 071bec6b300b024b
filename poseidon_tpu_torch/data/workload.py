"""Deterministic data partitioning (the port's copy of the parts of
``poseidon_tpu/data/workload.py`` the training slice uses).

``shard_indices`` is the reference's contiguous (client x thread) range
split over [0, n) (``ps/src/ml/include/ml/util/workload_manager.hpp``)
applied to a seeded per-epoch permutation, so every shard sees a disjoint,
reshuffled slice per epoch. A single GPU is shard 0 of 1.
``sharded_source_path`` is the reference's ``_k`` suffix for databases
partitioned ahead of time (``shared_file_system``). ``member_shard`` and
``elastic_shard_indices`` key the split by the async-SSP tier's CURRENT
member list (elastic membership) instead of the launch rank and world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

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


def member_shard(members: Iterable[int], worker: int) -> Shard:
    """Worker ``worker``'s shard under the current member list: its
    position in the sorted list is the shard index and the member count
    the shard count, so every member computes the same partition from the
    membership set alone."""
    ms = sorted(set(members))
    if worker not in ms:
        raise ValueError(f"worker {worker} not in member list {ms}")
    return Shard(ms.index(worker), len(ms))


def elastic_shard_indices(n: int, worker: int, members: Iterable[int],
                          epoch: int = 0, shuffle: bool = True,
                          seed: int = 0) -> np.ndarray:
    """Indices ``worker`` reads for ``epoch`` under the current member
    list: the epoch permutation is every member's, and the member list
    only decides how many contiguous ranges it is cut into, so shards are
    disjoint and cover [0, n) for any membership."""
    return shard_indices(n, member_shard(members, worker), epoch=epoch,
                         shuffle=shuffle, seed=seed)


def sharded_source_path(source: str, shard_index: int,
                        shared_file_system: bool) -> str:
    """The reference's `_k` suffix convention for pre-partitioned databases."""
    if shared_file_system:
        return f"{source}_{shard_index}"
    return source
