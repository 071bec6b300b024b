"""Fast restart: the kernel store, the step key, and the tuned store (the
port's ``poseidon_tpu/runtime/compile_cache.py``).

A (re)started process of the port pays three things before its first step
ends: the nvcc builds of its kernel libraries (``ops/_build.py``) and the
g++ build of the data plane (``data/native.py``), the first eager step
(cuDNN's heuristics, allocator growth), and, under ``steps_per_dispatch``
> 1, the CUDA graph's capture. Three layers take what can be kept:

1. **The kernel store** (the persistent XLA cache's counterpart):
   ``enable_compile_cache(cache_dir)`` points the kernel libraries' and the
   data plane's build output at ``<cache_dir>/kernels/``;
   ``disable_compile_cache()`` points them back at the checkout's
   ``build/poseidon_tpu_torch/``. Each library is named by the hash of
   what changes its bytes: the source and the shared headers, the
   compiler's version and flags (the target arch among them). A mismatch
   is a clean miss (a new name, built anew), never a stale load; a
   library that exists and fails to load raises. Builds write a temporary
   file and rename it into place, so processes that share a store never
   load a torn library.

2. **The step key and the AOT step store**: ``step_key`` is JSON of the
   canonicalized parts and SHA-256, the JAX package's function, so the
   same parts give the same key in both packages. The engine keys its
   train step as JAX's does (``Engine._resolve_aot_step``), with torch's
   and CUDA's versions and the card's name in place of jax's fields. What
   the JAX package serializes under ``<cache_dir>/aot/`` is the compiled
   step executable. The port has none to keep: its step is eager PyTorch
   calling hand-written kernels, a CUDA graph is bound to its process's
   addresses, and torch cannot serialize an eager step. So the store
   holds no step (``aot_entries`` counts what it holds: 0), the engine
   logs why, and a key hit means the kernel store and the tuned store are
   warm for that step.

3. **The tuned store**: measured decisions persisted as one JSON document
   per (namespace, key) under ``<cache_dir>/tuned/``. ``ops/conv_tune.py``
   keeps its per-layer conv winners here (namespace "conv_strategy") and
   ``runtime/tuned_plan.py`` its plans (namespace "plan"). The port keeps
   its documents apart from the JAX package's by the parts it puts in (a
   ``framework`` part, see ``tuned_plan.plan_key``). Saves are atomic; a
   file that exists but does not parse is a loud miss.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

from .metrics import log

__all__ = ["enable_compile_cache", "disable_compile_cache", "kernel_dir",
           "cache_entries", "step_key", "aot_entries", "describe",
           "NO_STEP_EXECUTABLE", "load_tuned", "save_tuned", "tuned_path"]

# why the AOT store holds no step for the port (logged once by the engine)
NO_STEP_EXECUTABLE = (
    "no step executable is stored: the port's step is eager PyTorch "
    "calling hand-written kernels, a CUDA graph is bound to its process's "
    "addresses and torch cannot serialize an eager step; a restart reuses "
    "the kernel store and the tuned store instead")


def kernel_dir(cache_dir: str) -> Path:
    return Path(cache_dir) / "kernels"


def enable_compile_cache(cache_dir: str) -> str:
    """Point the kernel libraries' and the data plane's builds at
    ``<cache_dir>/kernels/`` (created if missing); returns the resolved
    absolute ``cache_dir``. Libraries already loaded in this process stay
    loaded; later loads and builds use the store."""
    from ..data import native
    from ..ops import _build
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    store = kernel_dir(cache_dir)
    store.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = store
    native.BUILD_DIR = store
    return cache_dir


def disable_compile_cache() -> None:
    """Point the builds back at the checkout's ``build/poseidon_tpu_torch/``
    (pair every scoped ``enable_compile_cache`` with it)."""
    from ..data import native
    from ..ops import _build
    _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR
    native.BUILD_DIR = native.DEFAULT_BUILD_DIR


def cache_entries(cache_dir: str) -> int:
    """How many built libraries the kernel store holds (temporary files of
    builds in progress are not counted)."""
    try:
        return sum(1 for n in os.listdir(kernel_dir(cache_dir))
                   if n.endswith(".so"))
    except OSError:
        return 0


def _canon(obj: Any) -> Any:
    """JSON-stable canonicalization for key parts (tuples -> lists, dict
    keys sorted as strings, anything else not JSON -> str)."""
    if isinstance(obj, dict):
        return {str(k): _canon(v)
                for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def step_key(**parts: Any) -> str:
    """Content key: the same parts give the same key in any process (and
    in the JAX package); any drift is a clean miss."""
    blob = json.dumps(_canon(parts), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def aot_entries(cache_dir: str) -> int:
    """Serialized step executables under ``<cache_dir>/aot/`` (the JAX
    package's ``.aotexec`` entries). The port writes none."""
    try:
        return sum(1 for n in os.listdir(os.path.join(cache_dir, "aot"))
                   if n.endswith(".aotexec"))
    except OSError:
        return 0


def describe(cache_dir: str) -> Dict[str, int]:
    """Entry counts for stats.yaml: the kernel store's libraries and the
    AOT store's steps."""
    return {"kernel_entries": cache_entries(cache_dir),
            "aot_step_entries": aot_entries(cache_dir)}


# --------------------------------------------------------------------------- #
# the tuned store
# --------------------------------------------------------------------------- #

def tuned_path(cache_dir: str, namespace: str, key: str) -> str:
    return os.path.join(cache_dir, "tuned", f"{namespace}-{key}.json")


def load_tuned(cache_dir: str, namespace: str, key: str) -> Optional[Dict]:
    """The persisted decision document, or None. A missing file is a
    silent miss; a file that exists but cannot be read or parsed (a writer
    died mid-write, a hand edit) is logged and is a miss: the decision is
    measured again and the entry rewritten. Never raises: this runs while
    a Net is being built."""
    if not cache_dir:
        return None
    path = tuned_path(cache_dir, namespace, key)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        log(f"compile_cache: tuned entry {namespace}-{key} at {path} is "
            f"torn/unreadable ({type(e).__name__}: {e}); treating as a "
            f"miss — will re-measure and overwrite")
        return None


def save_tuned(cache_dir: str, namespace: str, key: str,
               doc: Dict) -> Optional[str]:
    """Persist a decision document (tmp file, then an atomic rename).
    Returns the path, or None when no store is configured or it cannot be
    written (logged)."""
    if not cache_dir:
        return None
    path = tuned_path(cache_dir, namespace, key)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError as e:
        log(f"compile_cache: tuned entry {namespace}-{key} not persisted "
            f"({e}); will re-measure next process")
        return None
