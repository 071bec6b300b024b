"""Record sources of the port's data plane (the LMDB, LevelDB and
MEMORY_DATA sources of ``poseidon_tpu/data/sources.py``).

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

    def close(self) -> None:
        """Release what the source holds open (nothing, by default)."""


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


class LevelDBSource(Source):
    """DATA with ``backend: LEVELDB`` (the caffe.proto default): Datum
    records through the dependency-free reader of ``leveldb_reader.py``."""

    def __init__(self, path: str):
        from .leveldb_reader import LevelDBReader
        self.db = LevelDBReader(path)

    def __len__(self) -> int:
        return len(self.db)

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        d = decode_datum(self.db.value_at(index))
        return d.to_array(), d.label



class MemorySource(Source):
    """MEMORY_DATA: arrays handed in by the caller (memory_data_layer.cpp)."""

    def __init__(self, data: np.ndarray, labels: np.ndarray):
        self.data = np.asarray(data, np.float32)
        self.labels = np.asarray(labels).reshape(-1)
        if len(self.data) != len(self.labels):
            raise ValueError("data/label count mismatch")

    def __len__(self) -> int:
        return len(self.data)

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        return self.data[index], int(self.labels[index])

