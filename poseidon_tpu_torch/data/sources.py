"""Record sources of the port's data plane (the LMDB subset of
``poseidon_tpu/data/sources.py``).

A source yields ((C, H, W) float32 raw values, int label) records by index;
batching and augmentation sit on top (``pipeline.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..proto.wire import decode_datum


class Source:
    """Random-access record source."""

    def __len__(self) -> int:
        raise NotImplementedError

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        """-> ((C, H, W) float32 raw values, int label)."""
        raise NotImplementedError

    @property
    def record_shape(self) -> Tuple[int, int, int]:
        arr, _ = self.read(0)
        return tuple(arr.shape)  # type: ignore[return-value]


class LMDBSource(Source):
    """DATA with ``backend: LMDB``: Datum records of an LMDB database."""

    def __init__(self, path: str):
        from .lmdb_reader import LMDBReader
        self.db = LMDBReader(path)

    def __len__(self) -> int:
        return len(self.db)

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        d = decode_datum(self.db.value_at(index))
        return d.to_array(), d.label

    def close(self) -> None:
        self.db.close()
