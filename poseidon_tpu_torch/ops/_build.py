"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``*.cu`` file under ``ops/csrc/`` is compiled on its own by ``nvcc``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o build/poseidon_tpu_torch/lib<name>-<hash>.so <name>.cu

The output lands in ``build/poseidon_tpu_torch/`` at the root of the
checkout, named by the content hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header rebuilds and an unchanged
one loads what is there. ``build_all`` starts one nvcc per
source at once. A failed build raises with the compiler's output: nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "poseidon_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(table: Dict[str, int], name: str) -> None:
    """Add one to ``table[name]`` (a module's ``LAUNCHES``) under one lock
    shared by every kernel module: serving replicas launch kernels from
    several threads, and a bare ``+= 1`` could lose a count."""
    with _count_lock:
        table[name] += 1


def launch_counts() -> Dict[str, int]:
    """Every kernel module's ``LAUNCHES`` merged into one copy (a CUDA
    graph's capture records its launches: the difference of two such
    copies around it is what each replay launches)."""
    from . import flash, lrn, pool, sgd
    with _count_lock:
        return {**lrn.LAUNCHES, **pool.LAUNCHES, **sgd.LAUNCHES,
                **flash.LAUNCHES}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build from source at first use")


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    """The library's path, named by the content of its source and of every
    header under ``csrc/`` (which a source may include)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns
    (process, tmp path, final path)."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    """Wait for one nvcc, then move the library into place atomically."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def _build_one(name: str) -> None:
    _finish(name, *_start(name))


def build_all(names: List[str]) -> None:
    """Build every library of ``names`` that is not built yet, one nvcc per
    source, all started together; raises on the first failure after every
    compiler has exited."""
    with _lock:
        started = [(n, *_start(n)) for n in names
                   if n not in _libs and not _lib_path(n).exists()]
        errors = []
        for name, proc, tmp, out in started:
            try:
                _finish(name, proc, tmp, out)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _build_one(name)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
