"""libsvm-format parsing and sparse feature batches (the port of
``poseidon_tpu/data/libsvm.py``; the reference's ML library,
ps/src/ml/include/ml/feature/ and ps/src/ml/util/data_loading.hpp).

A libsvm file read as a training source for the non-vision workloads
(logistic-regression-style apps) the Petuum ML library served.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class SparseFeatures:
    """A CSR batch: each row's (index, value) run, concatenated."""
    indices: np.ndarray   # int32 (nnz,)
    values: np.ndarray    # float32 (nnz,)
    offsets: np.ndarray   # int64 (rows+1,)
    dim: int

    def to_dense(self) -> np.ndarray:
        rows = len(self.offsets) - 1
        out = np.zeros((rows, self.dim), np.float32)
        for r in range(rows):
            lo, hi = self.offsets[r], self.offsets[r + 1]
            out[r, self.indices[lo:hi]] = self.values[lo:hi]
        return out


def read_libsvm(path: str, feature_dim: int = 0, one_based: bool = True
                ) -> Tuple[SparseFeatures, np.ndarray]:
    """Parse a libsvm file -> (features, labels). With feature_dim=0 the
    dimensionality is the largest index seen, plus one."""
    labels: List[float] = []
    indices: List[int] = []
    values: List[float] = []
    offsets: List[int] = [0]
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                idx_s, val_s = tok.split(":", 1)
                idx = int(idx_s) - (1 if one_based else 0)
                if idx < 0:
                    raise ValueError(f"{path}: bad feature index {idx_s}")
                indices.append(idx)
                values.append(float(val_s))
                max_idx = max(max_idx, idx)
            offsets.append(len(indices))
    dim = feature_dim or (max_idx + 1)
    return (SparseFeatures(np.asarray(indices, np.int32),
                           np.asarray(values, np.float32),
                           np.asarray(offsets, np.int64), dim),
            np.asarray(labels, np.float32))
