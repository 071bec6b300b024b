"""Record sources of the port's data plane (the port of
``poseidon_tpu/data/sources.py``): DATA over LMDB and LevelDB, IMAGE_DATA
(a list file, decoded by PIL on read), HDF5_DATA (h5py), MEMORY_DATA, and
the synthetic source of tests and benchmarks.

A source yields ((C, H, W) float32 raw values, int label) records by index;
batching and augmentation sit on top (``pipeline.py``). PIL and h5py are
imported only by the sources that need them, so importing this module
needs neither.
"""

from __future__ import annotations

import os
from typing import List, Tuple

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


class ImageListSource(Source):
    """IMAGE_DATA: a text file of '<path> <label>' lines, decoded on read
    (BGR, CHW, as Caffe stores images); ``shuffle`` permutes the list once
    with ``np.random.RandomState(seed)``."""

    def __init__(self, source: str, root_folder: str = "",
                 new_height: int = 0, new_width: int = 0,
                 shuffle: bool = False, seed: int = 0,
                 color: bool = True):
        self.entries: List[Tuple[str, int]] = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                path, label = line.rsplit(None, 1)
                self.entries.append((os.path.join(root_folder, path),
                                     int(label)))
        if shuffle:
            np.random.RandomState(seed).shuffle(self.entries)
        self.new_height = new_height
        self.new_width = new_width
        self.color = color

    def __len__(self) -> int:
        return len(self.entries)

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        from PIL import Image
        path, label = self.entries[index]
        img = Image.open(path)
        img = img.convert("RGB" if self.color else "L")
        if self.new_height and self.new_width:
            img = img.resize((self.new_width, self.new_height))
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = arr[:, :, ::-1] if self.color else arr    # RGB -> BGR
        return np.ascontiguousarray(arr.transpose(2, 0, 1)), label


class HDF5Source(Source):
    """HDF5_DATA: ``source`` is a text file listing .h5 files with the
    datasets 'data' and 'label' (hdf5_data_layer.cpp), read whole at
    construction and concatenated in list order."""

    def __init__(self, source: str):
        import h5py
        with open(source) as f:
            names = [line.strip() for line in f if line.strip()]
        data: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        for name in names:
            with h5py.File(name, "r") as h:
                data.append(np.asarray(h["data"], np.float32))
                labels.append(np.asarray(h["label"]).reshape(-1))
        self.data_cat = np.concatenate(data)
        self.labels_cat = np.concatenate(labels)

    def __len__(self) -> int:
        return len(self.data_cat)

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        arr = self.data_cat[index]
        if arr.ndim == 1:
            arr = arr[:, None, None]
        return arr, int(self.labels_cat[index])


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



class SyntheticSource(Source):
    """A deterministic learnable task for tests and benchmarks: class
    templates plus Gaussian noise, record ``i`` drawn from
    ``RandomState(i)``."""

    def __init__(self, shape: Tuple[int, int, int], num_classes: int,
                 size: int = 1 << 16, noise: float = 0.3, seed: int = 0):
        rs = np.random.RandomState(seed)
        self.templates = rs.randn(num_classes, *shape).astype(np.float32)
        self.noise = noise
        self.size = size
        self.num_classes = num_classes
        self.shape = shape

    def __len__(self) -> int:
        return self.size

    def read(self, index: int) -> Tuple[np.ndarray, int]:
        rs = np.random.RandomState(index)
        label = index % self.num_classes
        return (self.templates[label]
                + self.noise * rs.randn(*self.shape).astype(np.float32),
                label)
