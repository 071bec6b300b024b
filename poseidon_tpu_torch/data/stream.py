"""Out-of-core streaming: the ML library's DiskStreamer (the port of
``poseidon_tpu/data/stream.py``).

The reference streams datasets larger than RAM through a rotating set of
byte buffers: one IO thread reads files (a directory, an explicit list, or
a numbered ``prefix_N`` sequence, optionally snappy-compressed) into a
bounded MultiBuffer, and workers pull parsed records N at a time
(ps/src/ml/disk_stream/{disk_streamer,multi_buffer,disk_reader}.hpp,
parsers/libsvm_parser.hpp). Memory stays proportional to ``num_buffers x
file size`` whatever the dataset's size, and ``num_passes`` streams several
epochs (0 = without end).

Here: a daemon IO thread and a bounded queue.
``DiskStreamer(config, parser).get_next_data(n)`` returns up to n parsed
records, an empty list meaning the end of the stream (the reference's
``GetNextData``); an IO error re-raises there. ``shutdown`` stops and joins
the thread. ``LibSVMParser`` is the stock parser; any callable
``bytes -> list`` works.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass
class DiskStreamConfig:
    """DiskReaderConfig and DiskStreamerConfig merged (one consumer: the
    train step takes the batches, so no worker threads meet at a
    barrier)."""
    num_buffers: int = 2          # bound on file buffers in flight
    num_passes: int = 1           # 0 = without end
    snappy_compressed: bool = False
    # exactly one of the three read modes:
    dir_path: str = ""            # every regular file under a directory
    file_list: Sequence[str] = field(default_factory=tuple)
    file_seq_prefix: str = ""     # prefix_<id> for id in [begin, begin+num)
    seq_id_begin: int = 0
    num_files: int = 0

    def files(self) -> List[str]:
        if self.dir_path:
            return sorted(
                os.path.join(self.dir_path, n)
                for n in os.listdir(self.dir_path)
                if os.path.isfile(os.path.join(self.dir_path, n)))
        if self.file_list:
            return list(self.file_list)
        if self.file_seq_prefix:
            return [f"{self.file_seq_prefix}_{i}"
                    for i in range(self.seq_id_begin,
                                   self.seq_id_begin + self.num_files)]
        raise ValueError("DiskStreamConfig: no read mode configured")


class DiskStreamer:
    """A background IO thread, a bounded buffer queue and parsing on
    the consumer's pull."""

    _EOS = object()

    def __init__(self, config: DiskStreamConfig,
                 parser: Callable[[bytes], list]):
        self.config = config
        self.parser = parser
        self._files = config.files()
        if not self._files:
            raise ValueError("DiskStreamer: no input files")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1,
                                                         config.num_buffers))
        self._pending: list = []
        self._done = False
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._io = threading.Thread(target=self._io_loop, daemon=True,
                                    name="DiskStreamer")
        self._io.start()

    # -- the IO thread: the DiskReader --------------------------------- #
    def _io_loop(self):
        passes = 0
        try:
            while not self._stop.is_set():
                for path in self._files:
                    if self._stop.is_set():
                        return
                    with open(path, "rb") as f:
                        buf = f.read()
                    if self.config.snappy_compressed:
                        from .snappy import uncompress
                        buf = uncompress(buf)
                    # blocks while num_buffers are in flight: the
                    # MultiBuffer bound that keeps memory constant
                    self._put(buf)
                passes += 1
                if self.config.num_passes and \
                        passes >= self.config.num_passes:
                    break
        except BaseException as e:  # noqa: BLE001 — raised on the consumer
            self._error = e
        finally:
            self._put(self._EOS)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- the consumer's side -------------------------------------------- #
    def get_next_data(self, num_data: int) -> list:
        """Up to ``num_data`` parsed records; [] at the end of the stream.
        A failure of the IO thread re-raises here: a missing or corrupt
        file must never pass for a clean, truncated end of stream."""
        while len(self._pending) < num_data and not self._done:
            item = self._q.get()
            if item is self._EOS:
                self._done = True
                if self._error is not None:
                    raise RuntimeError(
                        f"DiskStreamer IO thread failed: {self._error}"
                    ) from self._error
                break
            self._pending.extend(self.parser(item))
        out, self._pending = (self._pending[:num_data],
                              self._pending[num_data:])
        return out

    def shutdown(self):
        """Stop the IO thread and join it."""
        self._stop.set()
        # drain, so that a blocked _put sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._io.join(timeout=5.0)


class LibSVMParser:
    """parsers/libsvm_parser.hpp: one buffer -> a list of (label, indices
    int32, values float32) rows."""

    def __init__(self, one_based: bool = True):
        self.one_based = one_based

    def __call__(self, buf: bytes) -> list:
        out = []
        off = 1 if self.one_based else 0
        for line in buf.decode().splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            idx = np.empty(len(parts) - 1, np.int32)
            val = np.empty(len(parts) - 1, np.float32)
            for j, tok in enumerate(parts[1:]):
                i_s, v_s = tok.split(":", 1)
                idx[j] = int(i_s) - off
                val[j] = float(v_s)
            out.append((float(parts[0]), idx, val))
        return out


def stream_dense_batches(streamer: DiskStreamer, batch_size: int,
                         feature_dim: int):
    """A generator of (features (B, D) f32, labels (B,) f32) batches from
    a libsvm ``DiskStreamer`` (data_loading.hpp's convenience on top)."""
    while True:
        rows = streamer.get_next_data(batch_size)
        if not rows:
            return
        x = np.zeros((len(rows), feature_dim), np.float32)
        y = np.empty(len(rows), np.float32)
        for r, (label, idx, val) in enumerate(rows):
            x[r, idx] = val
            y[r] = label
        yield x, y
