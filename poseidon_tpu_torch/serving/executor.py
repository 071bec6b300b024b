"""Shape-bucketed inference executor on PyTorch (the port of
``poseidon_tpu/serving/executor.py``).

Same contract as the JAX executor: a request of n rows runs on the
smallest bucket >= n, zero-padded; outputs are sliced back to n rows.
Row-independence of the TEST-phase forward makes the padding rows inert.
Requests are validated at admission (every input present, one row count,
row shapes matching the model), and ``swap_params`` replaces the serving
params atomically after checking them against the net.

``warm()`` runs one forward per bucket under ``torch.inference_mode()``:
the port's stand-in for the JAX package's AOT compile (it builds the CUDA
kernels, picks cuDNN algorithms and fills the allocator's cache before the
first request). A CUDA graph per bucket is later work.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.net import Net
from ..numeric import resolve_device
from ..proto.messages import load_net
from ..runtime.checkpoint import load_caffemodel, restore_params

DEFAULT_BUCKETS = (1, 4, 16, 64)


def parse_buckets(spec: str) -> Tuple[int, ...]:
    """'1,4,16,64' -> (1, 4, 16, 64), validated ascending positives."""
    try:
        buckets = tuple(sorted({int(tok) for tok in spec.split(",") if tok}))
    except ValueError as e:
        raise ValueError(f"bad bucket spec {spec!r}: {e}") from None
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bad bucket spec {spec!r}: need positive sizes")
    return buckets


def merge_snapshot_params(base_params: Dict, snap_params: Dict) -> Dict:
    """Overlay a snapshot's {layer: {param: array}} onto the serving tree.
    Extra snapshot layers (a train net's loss heads) are ignored; every
    serving layer must be present with matching shapes, or the load is
    refused."""
    merged: Dict = {}
    for lname, lparams in base_params.items():
        if lname not in snap_params:
            raise ValueError(f"snapshot is missing param layer {lname!r}")
        merged[lname] = {}
        for pname, cur in lparams.items():
            if pname not in snap_params[lname]:
                raise ValueError(
                    f"snapshot is missing param {lname!r}/{pname!r}")
            arr = np.asarray(snap_params[lname][pname])
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(
                    f"snapshot param {lname!r}/{pname!r} shape "
                    f"{arr.shape} != serving shape {tuple(cur.shape)}")
            merged[lname][pname] = arr
    return merged


def load_serving_params(net: Net, base_params: Dict, path: str) -> Dict:
    """Weights for serving from ``.caffemodel`` or ``.solverstate.npz``."""
    if path.endswith(".caffemodel"):
        return load_caffemodel(path, net, base_params)
    return merge_snapshot_params(base_params, restore_params(path))


class BucketedExecutor:
    """Shape-bucketed inference over a TEST-phase :class:`Net` with
    explicit input blobs; the leading dim of every input is the batch axis.
    Outputs whose leading dim equals the bucket are sliced back to the
    request's rows; any other output passes through."""

    def __init__(self, net: Net, params=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.net = net
        self.device = net.device
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"need at least one positive bucket, "
                             f"got {buckets!r}")
        self.input_names: List[str] = list(net.input_names)
        if not self.input_names:
            raise ValueError("net declares no inputs to serve")
        self._params = net.to_device_params(
            net.params if params is None else params)
        self._swap_lock = threading.Lock()
        self.params_version = 0            # bumped by every swap_params
        self.forwards = 0                  # every forward, warm-up included
        self.calls: Dict[int, int] = {b: 0 for b in self.buckets}
        self.rows_served = 0
        self.rows_padded = 0
        self.rows_by_bucket: Dict[int, int] = {b: 0 for b in self.buckets}
        self.padded_by_bucket: Dict[int, int] = {b: 0 for b in self.buckets}
        self.warm()

    def _input_dtype(self, name: str) -> np.dtype:
        """f32 for image-like (4-D) inputs, int32 otherwise."""
        return (np.dtype(np.float32) if len(self.net.blob_shapes[name]) > 1
                else np.dtype(np.int32))

    def _forward(self, params, host_inputs: Dict[str, np.ndarray]):
        inputs = {n: torch.from_numpy(a).to(self.device)
                  for n, a in host_inputs.items()}
        with torch.inference_mode():
            out = self.net(inputs, params)
        self.forwards += 1
        return {k: v.cpu().numpy() for k, v in out.items()}

    def warm(self) -> None:
        """One forward per bucket, so no request pays first-call costs."""
        for b in self.buckets:
            zeros = {n: np.zeros((b,) + tuple(self.net.blob_shapes[n][1:]),
                                 self._input_dtype(n))
                     for n in self.input_names}
            self._forward(self._params, zeros)

    def bucket_for(self, rows: int) -> int:
        if rows < 1:
            raise ValueError("empty request")
        for b in self.buckets:
            if rows <= b:
                return b
        raise ValueError(f"request of {rows} rows exceeds the largest "
                         f"bucket {self.buckets[-1]}")

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_fill(self) -> Dict[int, Optional[float]]:
        """{bucket: real rows / dispatched rows} per ladder rung."""
        out: Dict[int, Optional[float]] = {}
        for b in self.buckets:
            total = self.rows_by_bucket[b] + self.padded_by_bucket[b]
            out[b] = round(self.rows_by_bucket[b] / total, 4) if total \
                else None
        return out

    def validate_request(self, inputs: Dict[str, np.ndarray]) -> int:
        """Admission-time validation; returns the request's row count."""
        missing = [n for n in self.input_names if n not in inputs]
        if missing:
            raise ValueError(f"request missing inputs {missing}")
        rows = int(np.shape(inputs[self.input_names[0]])[0])
        if rows < 1:
            raise ValueError("empty request")
        for name in self.input_names:
            arr = np.asarray(inputs[name])
            if int(arr.shape[0]) != rows:
                raise ValueError(f"input {name!r} has {arr.shape[0]} rows, "
                                 f"expected {rows}")
            want = self.net.blob_shapes[name]
            if tuple(arr.shape[1:]) != tuple(want[1:]):
                raise ValueError(
                    f"input {name!r} row shape {tuple(arr.shape[1:])} != "
                    f"model shape {tuple(want[1:])}")
        return rows

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Pad up to the nearest bucket, run the forward, slice the padding
        back off. The params reference is read once, so a concurrent swap
        never tears a dispatch."""
        rows = self.validate_request(inputs)
        bucket = self.bucket_for(rows)
        padded = {}
        for name in self.input_names:
            dtype = self._input_dtype(name)
            arr = np.asarray(inputs[name]).astype(dtype, copy=False)
            if rows < bucket:
                pad = np.zeros((bucket - rows,) + arr.shape[1:], dtype)
                arr = np.concatenate([arr, pad], axis=0)
            padded[name] = np.ascontiguousarray(arr)
        params = self._params      # one atomic read: swap-safe
        out = self._forward(params, padded)
        self.calls[bucket] += 1
        self.rows_served += rows
        self.rows_padded += bucket - rows
        self.rows_by_bucket[bucket] += rows
        self.padded_by_bucket[bucket] += bucket - rows
        return {k: (v[:rows] if v.ndim >= 1 and v.shape[0] == bucket else v)
                for k, v in out.items()}

    def swap_params(self, new_params: Dict) -> int:
        """Atomically replace the serving params after validating them
        against the net; returns the new params version."""
        new = self.net.to_device_params(new_params)
        with self._swap_lock:
            self._params = new
            self.params_version += 1
            return self.params_version

    @classmethod
    def from_files(cls, model_path: str, weights_path: Optional[str] = None,
                   buckets: Sequence[int] = DEFAULT_BUCKETS, device=None,
                   seed: int = 0) -> "BucketedExecutor":
        """Build from a deploy prototxt + optional weights (.caffemodel or
        .solverstate.npz). Without weights the net serves its filler
        initialization drawn from ``seed``."""
        dev = resolve_device(device)
        net = Net(load_net(model_path), "TEST", device=dev)
        params = net.init(torch.Generator().manual_seed(seed))
        if weights_path:
            params = load_serving_params(net, params, weights_path)
        return cls(net, params, buckets=buckets)
