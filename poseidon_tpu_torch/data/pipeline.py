"""Batch pipeline: source -> transform -> background prefetch (the Python
source path of ``poseidon_tpu/data/pipeline.py``).

The counterpart of Caffe's ``BasePrefetchingDataLayer``: a daemon thread
keeps a bounded queue of ready host batches (transform applied, numpy)
while the GPU trains on the current one; ``__next__`` hands back
``{top: array}`` dicts the engine copies to the device.

Batches are identical, bit for bit, to the JAX package's
``BatchPipeline(..., use_native=False)`` from the same seed: the same epoch
permutation (``workload.shard_indices``) and the same transformer draws.
The batch multiplier is the caller's: the JAX engine multiplies the
prototxt batch by its local device count, the port's single-GPU engine
passes 1. Only DATA layers with ``backend: LMDB`` are sources here; LEVELDB,
IMAGE_DATA, HDF5_DATA, WINDOW_DATA and MEMORY_DATA raise
``NotImplementedError`` (the native C++ batcher and the on-device transform
are later work too).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..core.layers import DATA_SOURCE_TYPES
from ..proto.messages import LayerParameter, TransformationParameter
from .sources import LMDBSource, Source
from .transformer import DataTransformer
from .workload import Shard, shard_indices


def _effective_transform(lp: LayerParameter) -> TransformationParameter:
    """Merge the deprecated in-layer fields (scale/mean_file/crop/mirror on
    data_param etc.) into a TransformationParameter, preferring the modern
    transform_param when set (upgrade_proto.cpp behavior)."""
    tp = lp.transform_param
    legacy = None
    t = lp.canonical_type()
    if t == "DATA":
        legacy = lp.data_param
    elif t == "IMAGE_DATA":
        legacy = lp.image_data_param
    elif t == "WINDOW_DATA":
        legacy = lp.window_data_param
    if legacy is not None:
        return TransformationParameter(
            scale=tp.scale if tp.scale != 1.0 else legacy.scale,
            mirror=tp.mirror or legacy.mirror,
            crop_size=tp.crop_size or legacy.crop_size,
            mean_file=tp.mean_file or legacy.mean_file,
            mean_value=list(tp.mean_value),
        )
    return tp


def build_source(lp: LayerParameter) -> Source:
    t = lp.canonical_type()
    if t == "DATA":
        dp = lp.data_param
        if dp.backend != "LMDB":
            raise NotImplementedError(
                f"layer {lp.name!r}: DATA backend {dp.backend} is not in the "
                f"port yet (LMDB only)")
        if dp.shared_file_system:
            raise NotImplementedError(
                f"layer {lp.name!r}: shared_file_system sharding is not in "
                f"the port yet")
        return LMDBSource(dp.source)
    if t in DATA_SOURCE_TYPES:
        raise NotImplementedError(
            f"layer {lp.name!r}: {t} is not in the port yet (DATA with "
            f"backend LMDB only)")
    raise ValueError(f"layer {lp.name!r}: {t} is not a batch source")


def layer_batch_size(lp: LayerParameter) -> int:
    t = lp.canonical_type()
    return {
        "DATA": lp.data_param.batch_size,
        "IMAGE_DATA": lp.image_data_param.batch_size,
        "HDF5_DATA": lp.hdf5_data_param.batch_size,
        "MEMORY_DATA": lp.memory_data_param.batch_size,
        "WINDOW_DATA": lp.window_data_param.batch_size,
    }[t]


class BatchPipeline:
    """Iterates {top_name: np.ndarray} batches forever (epoch wraparound),
    prefetching ``prefetch`` batches ahead on a daemon thread. ``close``
    stops and joins the thread."""

    def __init__(self, lp: LayerParameter, phase: str, batch_size: int,
                 shard: Shard = Shard(0, 1), prefetch: int = 3,
                 seed: int = 0, shuffle: Optional[bool] = None):
        self.lp = lp
        self.phase = phase
        self.batch_size = batch_size
        self.shard = shard
        self.seed = seed
        self.shuffle = (phase == "TRAIN") if shuffle is None else shuffle
        self.tops = list(lp.top)
        self.source = build_source(lp)
        self._n_records = len(self.source)
        self.transformer = DataTransformer(_effective_transform(lp), phase,
                                           seed=seed)
        self._record_shape = self.source.record_shape
        self.data_shape = (batch_size,) + self.transformer.output_shape(
            *self._record_shape)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"BatchPipeline[{lp.name}]")
        self._thread.start()

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        while True:
            idx = shard_indices(self._n_records, self.shard, epoch,
                                self.shuffle, self.seed)
            if len(idx) == 0:
                raise RuntimeError("shard received zero records")
            yield from idx
            epoch += 1

    def _put(self, item) -> bool:
        """Bounded put that honors close(); False once stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        stream = self._index_stream()
        try:
            while not self._stop.is_set():
                idx = np.fromiter((next(stream)
                                   for _ in range(self.batch_size)),
                                  np.int64, count=self.batch_size)
                raw = np.empty((self.batch_size,) + self._record_shape,
                               np.float32)
                labels = np.empty((self.batch_size,), np.int32)
                for i, j in enumerate(idx):
                    arr, label = self.source.read(int(j))
                    raw[i] = arr
                    labels[i] = label
                batch = {self.tops[0]: self.transformer(raw)}
                if len(self.tops) > 1:
                    batch[self.tops[1]] = labels
                if not self._put(batch):
                    return
        except Exception as e:  # surface worker death to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if not self._thread.is_alive():
            self.source.close()


def build_phase_pipelines(net_param, phase: str, batch_multiplier: int = 1,
                          shard: Shard = Shard(0, 1), seed: int = 0):
    """A BatchPipeline per data layer of ``net_param`` at ``phase``.

    Returns (pipelines, source_shapes): source_shapes carry the prototxt
    batch_size, and each pipeline yields batch_size * batch_multiplier
    rows (1 on the port's single GPU)."""
    from ..core.net import filter_net
    from ..proto.messages import NetState

    pipes = []
    shapes: Dict[str, tuple] = {}
    try:
        for lp in filter_net(net_param, NetState(phase=phase)):
            if lp.canonical_type() not in DATA_SOURCE_TYPES:
                continue
            per_dev = layer_batch_size(lp)
            if per_dev <= 0:
                raise ValueError(f"layer {lp.name!r}: batch_size must be set")
            pipe = BatchPipeline(lp, phase, per_dev * batch_multiplier,
                                 shard=shard, seed=seed)
            pipes.append(pipe)
            shapes[lp.top[0]] = (per_dev,) + tuple(pipe.data_shape[1:])
            if len(lp.top) > 1:
                shapes[lp.top[1]] = (per_dev,)
    except BaseException:
        for p in pipes:
            p.close()
        raise
    return pipes, shapes
