"""Batch pipeline: source -> transform -> background prefetch -> the card
(the port of ``poseidon_tpu/data/pipeline.py``).

The counterpart of Caffe's ``BasePrefetchingDataLayer``: a daemon thread
keeps a bounded queue of ready host batches while the GPU trains on the
current one; ``__next__`` hands back ``{top: array}`` dicts.
``DevicePrefetcher`` stages those host batches on the card ahead of the
step that consumes them: pinned host buffers, a copy on its own CUDA
stream, an event the consumer's stream waits on.

Which path a pipeline takes (``BatchPipeline.route``):

- ``native``: DATA layers over an LMDB database go through the C++
  batcher (``data/native.py``), with the per-batch seed
  ``seed * 1_000_003 + batch_no``. A failed build or open raises.
- ``native-u8``: the same, shipping uint8 crops when ``device_transform``
  is asked for and the records are bytes and the mean is per channel (a
  ``mean_file`` is indexed by the source crop position, which the card
  cannot see); ``device_transform_spec`` is then the ``{mean_values,
  scale}`` the train step applies on the card.
- ``python``: every other source (LEVELDB, IMAGE_DATA, HDF5_DATA,
  MEMORY_DATA), or ``use_native=False``: records read one by one through
  ``DataTransformer``.
- ``window``: WINDOW_DATA, whose batches ``data/window.WindowDataSource``
  samples itself (fg/bg windows, seeded ``seed * shard.count +
  shard.index``), on the same worker thread and queue.

Batches are identical, bit for bit, to the JAX package's ``BatchPipeline``
with the same ``use_native`` from the same seed. The batch multiplier is
the caller's: the JAX engine multiplies the prototxt batch by its local
device count, the port's engine passes 1.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core.layers import DATA_SOURCE_TYPES
from ..proto.messages import LayerParameter, TransformationParameter
from .sources import (HDF5Source, ImageListSource, LevelDBSource,
                      LMDBSource, MemorySource, Source)
from .transformer import DataTransformer
from .workload import Shard, shard_indices, sharded_source_path


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


def data_source_path(lp: LayerParameter, shard: Shard) -> str:
    """A DATA layer's database path for this shard (the ``_k`` suffix under
    ``shared_file_system``)."""
    dp = lp.data_param
    return sharded_source_path(dp.source, shard.index, dp.shared_file_system)


def data_backend(lp: LayerParameter, path: str) -> str:
    """``LMDB`` or ``LEVELDB``: the layer's backend, except that a LEVELDB
    layer whose source holds an LMDB database (``data.mdb``, a converted
    one) reads it as LMDB, as the JAX package's batcher and source do."""
    backend = lp.data_param.backend
    if backend == "LEVELDB" and os.path.isfile(os.path.join(path,
                                                            "data.mdb")):
        return "LMDB"
    return backend


def build_source(lp: LayerParameter, shard: Shard = Shard(0, 1),
                 memory_data: Optional[Dict[str, np.ndarray]] = None
                 ) -> Source:
    t = lp.canonical_type()
    if t == "DATA":
        path = data_source_path(lp, shard)
        if data_backend(lp, path) == "LMDB":
            return LMDBSource(path)
        return LevelDBSource(path)
    if t == "IMAGE_DATA":
        ip = lp.image_data_param
        path = sharded_source_path(ip.source, shard.index,
                                   ip.shared_file_system)
        return ImageListSource(path, ip.root_folder, ip.new_height,
                               ip.new_width, ip.shuffle)
    if t == "HDF5_DATA":
        return HDF5Source(lp.hdf5_data_param.source)
    if t == "MEMORY_DATA":
        if memory_data is None:
            raise ValueError(
                f"layer {lp.name!r}: MEMORY_DATA requires arrays passed via "
                f"memory_data={{'data': ..., 'label': ...}}")
        return MemorySource(memory_data["data"], memory_data["label"])
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


def _mean_blob(path: str) -> np.ndarray:
    from ..proto.wire import read_blob_file
    return read_blob_file(path)[0]


class BatchPipeline:
    """Iterates {top_name: np.ndarray} batches forever (epoch wraparound),
    prefetching ``prefetch`` batches ahead on a daemon thread. ``close``
    stops and joins the thread."""

    def __init__(self, lp: LayerParameter, phase: str, batch_size: int,
                 shard: Shard = Shard(0, 1), prefetch: int = 3,
                 seed: int = 0, shuffle: Optional[bool] = None,
                 memory_data: Optional[Dict[str, np.ndarray]] = None,
                 use_native: bool = True, device_transform: bool = False):
        self.lp = lp
        self.phase = phase
        self.batch_size = batch_size
        self.shard = shard
        self.seed = seed
        self.shuffle = (phase == "TRAIN") if shuffle is None else shuffle
        self.tops = list(lp.top)
        self.native = None
        self.source: Optional[Source] = None
        self.device_transform_spec: Optional[Dict] = None
        self._u8 = False
        self._warned_mixed = False
        self.window = None
        if lp.canonical_type() == "WINDOW_DATA":
            from .window import WindowDataSource
            self.route = "window"
            self.window = WindowDataSource(
                lp, phase, seed=seed * shard.count + shard.index)
            self._n_records = len(self.window.fg) + len(self.window.bg)
            self.data_shape = (batch_size,) + self.window.record_shape
        elif use_native and self._native_eligible(shard):
            self._open_native(device_transform)
        else:
            self.route = "python"
            self.source = build_source(lp, shard, memory_data)
            self._n_records = len(self.source)
            self.transformer = DataTransformer(_effective_transform(lp),
                                               phase, seed=seed)
            self._record_shape = self.source.record_shape
            self.data_shape = (batch_size,) + self.transformer.output_shape(
                *self._record_shape)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"BatchPipeline[{lp.name}]")
        self._thread.start()

    # ---------------------------------------------------------------- #
    def _native_eligible(self, shard: Shard) -> bool:
        """DATA layers over an LMDB database; every other source takes the
        Python path by design, as in the JAX package."""
        lp = self.lp
        return (lp.canonical_type() == "DATA"
                and data_backend(lp, data_source_path(lp, shard)) == "LMDB")

    def _open_native(self, device_transform: bool) -> None:
        from .native import NativeLMDBBatcher
        tp = _effective_transform(self.lp)
        self.native = NativeLMDBBatcher(
            data_source_path(self.lp, self.shard), crop_size=tp.crop_size,
            mirror=tp.mirror, train=(self.phase == "TRAIN"), scale=tp.scale,
            mean=_mean_blob(tp.mean_file) if tp.mean_file else None,
            mean_values=(np.asarray(tp.mean_value, np.float32)
                         if tp.mean_value else None))
        self._n_records = len(self.native)
        self.data_shape = (self.batch_size,) + self.native.out_shape
        # a full mean_file is subtracted at the per-sample SOURCE crop
        # position, which the card cannot see: only mean_value or no-mean
        # configs move on the card
        if device_transform and not tp.mean_file and self._n_records:
            # probe a spread of records: float_data Datums cannot ship as
            # uint8, and a DB found mixed here keeps the host f32 path for
            # the whole pipeline (the only moment the wire contract can
            # still change; a float record met later is re-quantized)
            n = self._n_records
            probe = np.unique(np.linspace(0, n - 1, num=min(n, 8),
                                          dtype=np.int64))
            try:
                self.native.batch_u8(probe)
                self._u8 = True
            except (IOError, IndexError):
                self._u8 = False
        if self._u8:
            mv = (np.asarray(tp.mean_value, np.float32)
                  if tp.mean_value else None)
            if mv is not None and mv.size == 1:
                mv = np.repeat(mv, self.native.out_shape[0])
            self.device_transform_spec = {"mean_values": mv,
                                          "scale": float(tp.scale)}
        self.route = "native-u8" if self._u8 else "native"

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

    def _native_batch(self, idx: np.ndarray, batch_no: int):
        seed = self.seed * 1_000_003 + batch_no
        if not self._u8:
            return self.native.batch(idx, seed=seed)
        try:
            return self.native.batch_u8(idx, seed=seed)
        except IOError:
            # mixed byte/float DB: the probe saw byte records, but THIS
            # batch hit a float_data Datum. Keep the uint8 wire contract by
            # undoing the host transform's (x - mean) * scale (same seed,
            # same crop/mirror) instead of killing the worker mid-epoch.
            data, labels = self.native.batch(idx, seed=seed)
            spec = self.device_transform_spec
            raw = data / (spec["scale"] or 1.0)
            if spec["mean_values"] is not None:
                raw = raw + spec["mean_values"].reshape(1, -1, 1, 1)
            if not self._warned_mixed:
                self._warned_mixed = True
                print("WARNING: mixed byte/float LMDB under "
                      "--device_transform; float_data records are "
                      "re-quantized to uint8 per batch (lossy for values "
                      "outside [0,255])", file=sys.stderr, flush=True)
            return np.clip(np.rint(raw), 0, 255).astype(np.uint8), labels

    def _python_batch(self, idx: np.ndarray):
        raw = np.empty((self.batch_size,) + self._record_shape, np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        for i, j in enumerate(idx):
            arr, label = self.source.read(int(j))
            raw[i] = arr
            labels[i] = label
        return self.transformer(raw), labels

    def _worker(self) -> None:
        stream = None if self.window is not None else self._index_stream()
        batch_no = 0
        try:
            while not self._stop.is_set():
                if self.window is not None:
                    data, labels = self.window.batch(self.batch_size)
                else:
                    idx = np.fromiter((next(stream)
                                       for _ in range(self.batch_size)),
                                      np.int64, count=self.batch_size)
                    if self.native is not None:
                        data, labels = self._native_batch(idx, batch_no)
                    else:
                        data, labels = self._python_batch(idx)
                    batch_no += 1
                batch = {self.tops[0]: data}
                if len(self.tops) > 1:
                    batch[self.tops[1]] = labels
                if not self._put(batch):
                    return
        except Exception as e:  # surface worker death to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError(f"pipeline {self.lp.name!r} is "
                                       f"closed") from None
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
            for handle in (self.native, self.source):
                if handle is not None:
                    handle.close()


def place_batch(host: Dict[str, np.ndarray], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``, on the caller's thread and
    stream (the inline feed)."""
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


class DevicePrefetcher:
    """The device half of the input pipeline: a daemon thread merges the
    pipelines' host batches (the ``Engine._next_batch`` contract) and
    stages each on the card ahead of the step that consumes it, so the
    train thread dequeues batches that are already there.

    On a CUDA device each batch goes through a ring of ``depth + 1``
    pinned host slots: the thread copies the host arrays into a slot,
    issues ``copy_(..., non_blocking=True)`` into fresh device tensors on
    its own ``torch.cuda.Stream`` and records an event; a slot is refilled
    only after its last copy's event has completed. The consumer makes its
    current stream wait on that event and calls ``record_stream`` on the
    tensors it hands out, so their memory is not reused while its stream
    still reads them.

    ``passthrough`` (the default off the card, as the JAX package's
    ``_auto_passthrough`` on the CPU backend) assembles and places each
    batch inline on the consumer's thread. Either way a pipeline's death
    re-raises on this dequeue and every later one.
    """

    def __init__(self, pipes, device, depth: int = 2,
                 passthrough: Optional[bool] = None):
        self.pipes = list(pipes)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the thread's device: the caller's current one
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.depth = max(1, int(depth))
        self.passthrough = (self.device.type != "cuda" if passthrough is None
                            else bool(passthrough))
        self.staged = 0      # batches the CUDA stage copied onto the card
        self._error: Optional[Exception] = None
        self._thread: Optional[threading.Thread] = None
        if not self.passthrough:
            self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="DevicePrefetcher")
            self._thread.start()

    def _host_batch(self) -> Dict[str, np.ndarray]:
        host: Dict[str, np.ndarray] = {}
        for pipe in self.pipes:
            host.update(next(pipe))
        return host

    def _worker(self) -> None:
        cuda = self.device.type == "cuda"
        slots: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(self.depth + 1)]
        copied: List[Optional[torch.cuda.Event]] = [None] * len(slots)
        try:
            if cuda:
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(device=self.device)
            n = 0
            while not self._stop.is_set():
                host = self._host_batch()
                if not cuda:
                    item = (place_batch(host, self.device), None)
                else:
                    slot = n % len(slots)
                    if copied[slot] is not None:
                        copied[slot].synchronize()
                    batch = {}
                    with torch.cuda.stream(stream):
                        for k, v in host.items():
                            src = torch.from_numpy(v)
                            pinned = slots[slot].get(k)
                            if pinned is None or pinned.shape != src.shape \
                                    or pinned.dtype != src.dtype:
                                pinned = torch.empty_like(src,
                                                          pin_memory=True)
                                slots[slot][k] = pinned
                            pinned.copy_(src)
                            dev = torch.empty(src.shape, dtype=src.dtype,
                                              device=self.device)
                            dev.copy_(pinned, non_blocking=True)
                            batch[k] = dev
                        event = torch.cuda.Event()
                        event.record(stream)
                    copied[slot] = event
                    self.staged += 1
                    item = (batch, event)
                n += 1
                if not self._put(item):
                    return
        except Exception as e:  # surface pipeline death to the consumer
            self._error = e      # sticky BEFORE the sentinel: set-then-put
            self._put(e)

    def _put(self, item) -> bool:
        """Bounded put that honors close(): a full queue must not pin the
        thread forever after the consumer left."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self.passthrough:
            if self._error is not None:
                raise self._error
            try:
                return place_batch(self._host_batch(), self.device)
            except Exception as e:
                self._error = e  # the same sticky death as the thread's
                raise
        # drain queued batches first (the FIFO puts the death sentinel
        # after every good batch); then a dead worker is dead for good
        try:
            item = self._queue.get_nowait()
        except queue.Empty:
            if self._error is not None:
                raise self._error
            item = self._queue.get()
        if isinstance(item, Exception):
            self._error = item
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)


def build_phase_pipelines(net_param, phase: str, batch_multiplier: int = 1,
                          shard: Shard = Shard(0, 1), seed: int = 0,
                          memory_data: Optional[Dict[str, np.ndarray]] = None,
                          device_transform: bool = False,
                          use_native: bool = True):
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
                                 shard=shard, seed=seed,
                                 memory_data=memory_data,
                                 use_native=use_native,
                                 device_transform=device_transform)
            pipes.append(pipe)
            shapes[lp.top[0]] = (per_dev,) + tuple(pipe.data_shape[1:])
            if len(lp.top) > 1:
                shapes[lp.top[1]] = (per_dev,)
    except BaseException:
        for p in pipes:
            p.close()
        raise
    return pipes, shapes
