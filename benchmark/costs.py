"""The yardstick's arithmetic: model FLOPs, the conv FLOPs a step runs,
the byte bounds of the port's NHWC LRN and pooling kernels, and the
table of peaks (``peaks.json``).

Counts come from the reference net's shapes (``refnet.RefNet``), after
the conv and FC rows of the program's ``runtime/attribution.
layer_cost_table`` (2 FLOPs a multiply-add, a backward of dW plus dX) and
the bound column of ``PERF.md``'s kernel table (each input byte read
once, each output byte written once, over the HBM rate, or the ops over
the peak where that is larger). A conv whose bottom is the data blob
computes no input gradient, so it is billed 2x its forward, not 3x.
"""

from __future__ import annotations

import json
import os
from typing import Dict

from .refnet import RefNet

HERE = os.path.dirname(os.path.abspath(__file__))


def _passes(net: RefNet, layer) -> int:
    """Forward, weight gradient, and the input gradient unless the bottom
    is the data blob."""
    return 2 if layer.bottoms and layer.bottoms[0] == net.data_blob else 3


def model_flops_per_image(net: RefNet) -> float:
    """Conv and FC FLOPs of one trained image (forward and backward)."""
    total = sum(2.0 * layer.macs * _passes(net, layer) for layer in net.layers
                if layer.type in ("CONVOLUTION", "INNER_PRODUCT"))
    return total / net.batch


def conv_flops_per_step(net: RefNet) -> float:
    """The FLOPs of the convolutions' kernels in one step of ``net``'s
    batch: forward, data gradient (not for the data layer's conv) and
    weight gradient."""
    return sum(2.0 * layer.macs * _passes(net, layer)
               for layer in net.layers if layer.type == "CONVOLUTION")


def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def lrn_bound_s(net: RefNet, elem_bytes: int, hbm_bytes_s: float,
                peak_flops: float) -> float:
    """Least seconds of one step's across-channel LRN kernels: the forward
    reads x and writes y, the backward reads x and dy and writes dx; the
    ops (a window sum of squares, the power and the products, about
    2 size + 4 a element forward and twice that backward) where larger."""
    total = 0.0
    for layer in net.layers:
        if layer.type != "LRN":
            continue
        n = _elems(layer.in_shapes[0])
        size = int(layer.lp.msg("lrn_param").get("local_size", 5))
        for arrays, ops in ((2, 2 * size + 4), (3, 4 * size + 8)):
            total += max(arrays * n * elem_bytes / hbm_bytes_s,
                         n * ops / peak_flops)
    return total


def pool_bwd_bound_s(net: RefNet, elem_bytes: int,
                     hbm_bytes_s: float) -> float:
    """Least seconds of one step's pooling backward kernels: MAX reads x
    and dy and writes dx, AVE reads dy and writes dx."""
    total = 0.0
    for layer in net.layers:
        if layer.type != "POOLING":
            continue
        kind = layer.geom["method"]
        n_in = _elems(layer.in_shapes[0])
        n_out = _elems(layer.out_shapes[0])
        arrays = (2 * n_in + n_out) if kind == "MAX" else (n_in + n_out)
        total += arrays * elem_bytes / hbm_bytes_s
    return total


def peaks(device_name: str) -> Dict[str, float]:
    """The published dense peaks of the card named ``device_name`` (the
    first entry of ``peaks.json`` whose key is a part of the name)."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    for key, row in table["cards"].items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")
