"""The analytic per-layer cost model of a training step (the analytic half
of ``poseidon_tpu/runtime/attribution.py``): ``layer_cost_table`` and its
``_shape_elems``, computed from the port's ``Net.blob_shapes`` and
``param_defs`` exactly as the JAX package computes them from its own.

Its ``act_bytes`` column is what ``core/remat.py``'s budget knapsack ranks
against recompute FLOPs. The trace half of the JAX module (reading a
profiler trace and folding each op's device time into per-layer rows,
``train --profile``) is not ported here: it comes with the
``torch.profiler`` port of ``--profile`` (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Dict

__all__ = ["layer_cost_table"]


def _shape_elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def layer_cost_table(net, dtype_bytes: int = 4) -> Dict[str, Dict]:
    """{layer: {flops, bytes, act_bytes, intensity}} for one train step
    (forward and backward), from the blob and parameter shapes.

    Conv and FC are exact MAC counts (x2 for the multiply and the add; the
    backward, dW + dX, is twice the forward). Pooling, LRN and elementwise
    layers are per-element estimates: they rank the sinks and give an
    intensity, they are not a simulator. Bytes are the activations in and
    out plus the params, x3 for the backward's re-reads and gradient
    writes.

    ``act_bytes`` is the layer's stored forward activation footprint, its
    top blobs; an in-place top (named as a bottom) counts once."""
    out: Dict[str, Dict] = {}
    for layer in net.layers:
        lp = layer.lp
        tops = [net.blob_shapes[t] for t in lp.top if t in net.blob_shapes]
        bots = [net.blob_shapes[b] for b in lp.bottom
                if b in net.blob_shapes]
        out_elems = sum(_shape_elems(s) for s in tops)
        in_elems = sum(_shape_elems(s) for s in bots)
        defs = net.param_defs.get(layer.name, [])
        pcount = sum(p.count for p in defs)
        t = layer.TYPE
        if t == "CONVOLUTION" and defs and len(defs[0].shape) == 4:
            k, cg, r, s = defs[0].shape
            n, _, ho, wo = tops[0]
            fwd = 2.0 * n * ho * wo * k * cg * r * s
        elif t in ("INNER_PRODUCT",) and defs:
            batch = bots[0][0] if bots else 1
            wcount = max((p.count for p in defs if len(p.shape) == 2),
                         default=pcount)
            fwd = 2.0 * batch * wcount
        elif t == "POOLING":
            ksz = max(1, int(getattr(lp.pooling_param, "kernel_size", 2)))
            fwd = float(out_elems) * ksz * ksz
        elif t == "LRN":
            local = max(1, int(getattr(lp.lrn_param, "local_size", 5)))
            fwd = float(in_elems) * (2 * local + 4)
        elif t in ("SOFTMAX", "SOFTMAX_LOSS"):
            fwd = 5.0 * in_elems
        else:
            fwd = float(max(in_elems, out_elems))
        flops = 3.0 * fwd                       # fwd + (dW + dX) backward
        bytes_ = 3.0 * (in_elems + out_elems + pcount) * dtype_bytes
        out[layer.name] = {
            "flops": flops,
            "bytes": bytes_,
            "act_bytes": int(out_elems) * int(dtype_bytes),
            "intensity": round(flops / bytes_, 3) if bytes_ else None,
        }
    return out
