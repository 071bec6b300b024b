"""ctypes binding of the native data plane (``native/poseidon_dataplane.cc``):
the port's counterpart of ``poseidon_tpu/data/native.py``.

``NativeLMDBBatcher`` assembles a batch of LMDB records by index (read,
Datum decode, crop, mirror, mean and scale) on C++ threads with the GIL
released: the reference's C++ data-layer role. ``batch_u8`` stops before
the mean and scale, which the train step then applies on the card
(``Engine``'s input transform). ``snappy_uncompress`` is the LevelDB
block decoder of the same library.

The library is built at first use from the unchanged source::

    g++ -O3 -std=c++17 -fPIC -pthread -shared \\
        -o build/poseidon_tpu_torch/libposeidon_dataplane-<hash>.so \\
        native/poseidon_dataplane.cc

into the port's build directory, named by the source's content hash, and
written to a temporary name first and renamed into place, so processes
that build at once never load a half-written file. A failed build, or a
database the library cannot open, raises with the compiler's output or
the library's own message: nothing falls back to the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "poseidon_dataplane.cc"
BUILD_DIR = REPO_ROOT / "build" / "poseidon_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class _TransformSpec(ctypes.Structure):
    _fields_ = [
        ("crop_size", ctypes.c_int32),
        ("mirror", ctypes.c_int32),
        ("train", ctypes.c_int32),
        ("scale", ctypes.c_float),
        ("mean_mode", ctypes.c_int32),
        ("mean", ctypes.POINTER(ctypes.c_float)),
    ]


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libposeidon_dataplane-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}."
                        f"{threading.get_ident()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native data plane: g++ not found ({e}); the "
                           f"batcher builds {SOURCE} at first use") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native data plane: g++ failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.pdp_open.restype = ctypes.c_void_p
    lib.pdp_open.argtypes = [ctypes.c_char_p]
    lib.pdp_error.restype = ctypes.c_char_p
    lib.pdp_error.argtypes = [ctypes.c_void_p]
    lib.pdp_count.restype = ctypes.c_int64
    lib.pdp_count.argtypes = [ctypes.c_void_p]
    lib.pdp_shape.restype = None
    lib.pdp_shape.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int32)] * 3
    lib.pdp_batch.restype = ctypes.c_int32
    lib.pdp_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(_TransformSpec), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.pdp_batch_u8.restype = ctypes.c_int32
    lib.pdp_batch_u8.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.pdp_close.restype = None
    lib.pdp_close.argtypes = [ctypes.c_void_p]
    lib.pdp_snappy_uncompress.restype = ctypes.c_int64
    lib.pdp_snappy_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if this source has no build yet.
    Raises RuntimeError with the compiler's output when the build fails
    (and again, with the same output, on every later call)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        out = lib_path()
        if not out.exists():
            try:
                _build(out)
            except RuntimeError as e:
                _build_error = str(e)
                raise
        _lib = _bind(out)
        return _lib


def built_library() -> Optional[ctypes.CDLL]:
    """The library when it is loaded or built already, else None (never
    starts a build)."""
    global _lib
    with _lock:
        if _lib is None and lib_path().exists():
            _lib = _bind(lib_path())
        return _lib


# A corrupt header must not force a huge zero-filled allocation before the
# body is ever validated; LevelDB blocks are ~4-64 KiB, so this is generous.
_SNAPPY_MAX_OUT = 256 << 20


def snappy_uncompress(buf: bytes, lib: Optional[ctypes.CDLL] = None) -> bytes:
    """Native snappy decode; raises ValueError on a malformed stream (the
    Python codec's contract)."""
    lib = lib or library()
    need = lib.pdp_snappy_uncompress(buf, len(buf), None, 0)
    if need < 0:
        raise ValueError("native snappy: malformed header")
    if need > _SNAPPY_MAX_OUT:
        raise ValueError(
            f"native snappy: declared size {need} exceeds the "
            f"{_SNAPPY_MAX_OUT}-byte block cap (corrupt header?)")
    out = (ctypes.c_uint8 * need)()
    got = lib.pdp_snappy_uncompress(buf, len(buf), out, need)
    if got != need:
        raise ValueError(f"native snappy: malformed stream (rc={got})")
    return bytes(out)


def _check_rc(rc: int) -> None:
    if rc == -2:
        raise IndexError("batch index out of range")
    if rc == -3:
        raise ValueError("crop_size exceeds record dimensions")
    if rc == -4:
        raise IOError("float_data records cannot ship as uint8")
    if rc != 0:
        raise IOError(f"native batch failed: bad record (rc={rc})")


class NativeLMDBBatcher:
    """Indexed batch assembly over one LMDB database of Datum records."""

    def __init__(self, path: str, *, crop_size: int = 0, mirror: bool = False,
                 train: bool = True, scale: float = 1.0,
                 mean: Optional[np.ndarray] = None,
                 mean_values: Optional[np.ndarray] = None,
                 n_threads: int = 0):
        lib = library()
        self._lib = lib
        self._h = lib.pdp_open(path.encode())
        err = lib.pdp_error(self._h)
        if err:
            lib.pdp_close(self._h)
            self._h = None
            raise IOError(f"{path}: {err.decode()}")
        c, h, w = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        lib.pdp_shape(self._h, ctypes.byref(c), ctypes.byref(h),
                      ctypes.byref(w))
        self.record_shape = (c.value, h.value, w.value)
        self.n = int(lib.pdp_count(self._h))
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        if crop_size and (crop_size > self.record_shape[1]
                          or crop_size > self.record_shape[2]):
            self.close()
            raise ValueError(
                f"crop_size {crop_size} exceeds record "
                f"{self.record_shape[1]}x{self.record_shape[2]}")
        mean_mode = 0
        self._mean_buf = None      # kept alive: the spec points into it
        if mean is not None:
            m = np.ascontiguousarray(np.asarray(mean, np.float32).reshape(-1))
            if m.size != int(np.prod(self.record_shape)):
                self.close()
                raise ValueError("mean array size mismatch")
            self._mean_buf, mean_mode = m, 2
        elif mean_values is not None and len(mean_values):
            m = np.asarray(mean_values, np.float32)
            if m.size == 1:
                m = np.repeat(m, self.record_shape[0])
            if m.size != self.record_shape[0]:
                self.close()
                raise ValueError("mean_values arity mismatch")
            self._mean_buf, mean_mode = np.ascontiguousarray(m), 1
        mean_ptr = (self._mean_buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)) if self._mean_buf is not None
            else ctypes.POINTER(ctypes.c_float)())
        self._spec = _TransformSpec(
            crop_size=crop_size, mirror=int(mirror), train=int(train),
            scale=scale, mean_mode=mean_mode, mean=mean_ptr)
        ch, hh, ww = self.record_shape
        self.out_shape = (ch, crop_size or hh, crop_size or ww)

    def __len__(self) -> int:
        return self.n

    def batch(self, indices: np.ndarray,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Decode, crop, mirror, mean and scale to (n, C, h, w) float32."""
        idx = np.ascontiguousarray(indices, np.int64)
        data = np.empty((len(idx),) + self.out_shape, np.float32)
        labels = np.empty((len(idx),), np.int32)
        _check_rc(self._lib.pdp_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), ctypes.byref(self._spec), ctypes.c_uint64(seed),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.n_threads))
        return data, labels

    def batch_u8(self, indices: np.ndarray,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Decode, crop and mirror to uint8; the mean and scale are left to
        the card. The same crop/mirror draws as ``batch`` for a seed.
        Raises IOError on float_data-backed records."""
        idx = np.ascontiguousarray(indices, np.int64)
        data = np.empty((len(idx),) + self.out_shape, np.uint8)
        labels = np.empty((len(idx),), np.int32)
        _check_rc(self._lib.pdp_batch_u8(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), self._spec.crop_size, self._spec.mirror,
            self._spec.train, ctypes.c_uint64(seed),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.n_threads))
        return data, labels

    def close(self) -> None:
        if self._h is not None:
            self._lib.pdp_close(self._h)
            self._h = None
