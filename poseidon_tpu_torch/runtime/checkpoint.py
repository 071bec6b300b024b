"""Reading the JAX package's snapshot artifacts (numpy only).

- ``.solverstate.npz`` written by ``poseidon_tpu/runtime/checkpoint.py``:
  the ``params/`` group holds one array per leaf, keyed
  ``params/<layer>\\x1f<param>`` (layer names may contain '/', so tree keys
  are joined with the ASCII unit separator).
- ``.caffemodel``: a binary NetParameter, merged by layer name and blob
  order (Caffe's CopyTrainedLayersFrom).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..proto.wire import decode_caffemodel

_SEP = "\x1f"


def restore_params(state_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The params tree {layer: {param: array}} of a .solverstate.npz."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(state_path) as z:
        for key in z.files:
            group, _, rest = key.partition("/")
            if group != "params" or not rest:
                continue
            parts = rest.split(_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def load_caffemodel(path: str, net, params):
    """Merge a .caffemodel's weights into ``params`` through
    ``net.load_weights``."""
    with open(path, "rb") as f:
        weights = decode_caffemodel(f.read())
    return net.load_weights(params, weights)
