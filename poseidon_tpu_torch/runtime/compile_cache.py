"""The tuned store (the tuned-store half of ``poseidon_tpu/runtime/
compile_cache.py``): measured decisions persisted as one JSON document per
(namespace, key) under ``<cache_dir>/tuned/``, so a restarted process with
the same job configuration loads the winner instead of measuring again.

``ops/conv_tune.py`` keeps its per-layer conv lowering winners here
(namespace "conv_strategy") and ``runtime/tuned_plan.py`` its whole-policy
plans (namespace "plan"). ``step_key`` is JSON of the canonicalized parts
and SHA-256, the JAX package's function, so the same parts give the same
key in both packages; the port keeps its documents apart from the JAX
package's by the parts it puts in (a ``framework`` part, see
``tuned_plan.plan_key``). Saves are atomic (a tmp file renamed over the
entry); a file that exists but does not parse is a loud miss.

The XLA compile cache and the AOT step executables of the JAX module have
no counterpart here.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

from .metrics import log


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
    """Content key of a decision: the same parts give the same key in any
    process (and in the JAX package); any drift is a clean miss."""
    blob = json.dumps(_canon(parts), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


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
