"""The plain reference net: a Caffe TRAIN net read from its prototxt and
run with plain PyTorch operators in the precision the caller sets.

It imports nothing of the program: it reads the configuration's frozen
prototxt with the benchmark's own parser, infers the blob shapes by
Caffe's rules, counts each layer's multiply-adds for the FLOP functions
(``costs.py``), and runs the forward pass whose loss autograd
differentiates. Layer semantics follow Caffe:

- CONVOLUTION: ``(h + 2 pad - kernel) // stride + 1``, grouped;
- POOLING: Caffe's ceil rule (a last window that would start in the
  padding is dropped); MAX over the window, AVE divided by the window
  clipped to the padded input (``pooling_layer.cpp``);
- LRN across channels: ``x (k + alpha / size * sum x^2) ^ -beta``;
- INNER_PRODUCT on the NCHW flatten; SOFTMAX_LOSS the batch mean of the
  cross entropy times its ``loss_weight``;
- DROPOUT inverted: a unit is kept where a uniform draw in ``[0, 1)`` from
  the run's dropout generator is below ``1 - ratio`` and scaled by
  ``1 / (1 - ratio)``; the draws are made in layer order, one tensor of
  the blob's logical shape each (``PERF.md`` says why this is the plan).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .prototxt import Msg

LOSS_TYPES = ("SOFTMAX_LOSS",)


@dataclass
class ParamSpec:
    layer: str
    name: str              # "w" or "b", the program's leaf names
    shape: Tuple[int, ...]
    filler: Msg
    lr_mult: float
    decay_mult: float
    fan_in: int


@dataclass
class Layer:
    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    lp: Msg
    params: List[ParamSpec]
    loss_weight: float = 0.0
    macs: int = 0          # forward multiply-adds at the net's batch
    in_shapes: Tuple = ()
    out_shapes: Tuple = ()


def _in_phase(lp: Msg, phase: str) -> bool:
    inc = lp.all("include")
    if inc:
        return any(r.get("phase", phase) == phase for r in inc)
    return not any(r.get("phase") == phase for r in lp.all("exclude"))


def _hw(p: Msg, key: str, default=None) -> Tuple[int, int]:
    """A square size (``kernel_size``, ``stride``, ``pad``); the h/w forms
    are not covered."""
    if f"{key}_h" in p or f"{key}_w" in p:
        raise ValueError(f"reference net: {key}_h/{key}_w are not covered")
    single = p.get(f"{key}_size" if key == "kernel" else key, default)
    if single is None:
        raise ValueError(f"no {key} given")
    return int(single), int(single)


def caffe_pool_out(size: int, k: int, s: int, p: int) -> int:
    out = int(math.ceil((size + 2 * p - k) / s)) + 1
    if p and (out - 1) * s >= size + p:
        out -= 1
    return out


class RefNet:
    """The TRAIN net of ``net`` (a parsed NetParameter) at ``batch``
    images of ``channels`` x ``crop`` x ``crop``."""

    def __init__(self, net: Msg, batch: int, crop: int, channels: int = 3,
                 phase: str = "TRAIN"):
        self.batch = batch
        self.layers: List[Layer] = []
        shapes: Dict[str, Tuple[int, ...]] = {}
        self.data_blob = ""
        for lp in net.all("layers"):
            if not _in_phase(lp, phase):
                continue
            t = str(lp.get("type"))
            layer = Layer(name=lp.get("name"), type=t,
                          bottoms=[str(b) for b in lp.all("bottom")],
                          tops=[str(b) for b in lp.all("top")], lp=lp,
                          params=[])
            ins = tuple(shapes[b] for b in layer.bottoms)
            outs = self._setup(layer, ins, batch, crop, channels)
            layer.in_shapes, layer.out_shapes = ins, tuple(outs)
            lw = lp.all("loss_weight")
            layer.loss_weight = float(lw[0]) if lw else (
                1.0 if t in LOSS_TYPES else 0.0)
            for top, shape in zip(layer.tops, outs):
                shapes[top] = shape
            self.layers.append(layer)
        self.shapes = shapes

    # ------------------------------------------------------------------ #
    def _specs(self, layer: Layer, wshape, wfill: Msg, bshape,
               bfill: Msg) -> None:
        lp = layer.lp
        lrs = lp.all("blobs_lr")
        decays = lp.all("weight_decay")
        fan_in = int(math.prod(wshape[1:]))
        for i, (name, shape, fill) in enumerate(
                (("w", wshape, wfill), ("b", bshape, bfill))):
            if shape is None:
                continue
            layer.params.append(ParamSpec(
                layer=layer.name, name=name, shape=tuple(shape), filler=fill,
                lr_mult=float(lrs[i]) if i < len(lrs) else 1.0,
                decay_mult=float(decays[i]) if i < len(decays) else 1.0,
                fan_in=fan_in))

    def _setup(self, layer: Layer, ins, batch, crop, channels):
        t, lp = layer.type, layer.lp
        if t == "DATA":
            self.data_blob = layer.tops[0]
            return [(batch, channels, crop, crop), (batch,)][:len(layer.tops)]
        if t == "CONVOLUTION":
            cp = lp.msg("convolution_param")
            n, c, h, w = ins[0]
            kh, kw = _hw(cp, "kernel")
            sh, sw = _hw(cp, "stride", 1)
            ph, pw = _hw(cp, "pad", 0)
            g = int(cp.get("group", 1))
            k = int(cp.get("num_output"))
            oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
            layer.geom = dict(stride=(sh, sw), pad=(ph, pw), group=g)
            bias = str(cp.get("bias_term", "true")).lower() != "false"
            self._specs(layer, (k, c // g, kh, kw), cp.msg("weight_filler"),
                        (k,) if bias else None, cp.msg("bias_filler"))
            layer.macs = n * k * oh * ow * (c // g) * kh * kw
            return [(n, k, oh, ow)]
        if t == "POOLING":
            pp = lp.msg("pooling_param")
            n, c, h, w = ins[0]
            kh, kw = _hw(pp, "kernel")
            sh, sw = _hw(pp, "stride", 1)
            ph, pw = _hw(pp, "pad", 0)
            layer.geom = dict(kernel=(kh, kw), stride=(sh, sw), pad=(ph, pw),
                              method=str(pp.get("pool", "MAX")))
            return [(n, c, caffe_pool_out(h, kh, sh, ph),
                     caffe_pool_out(w, kw, sw, pw))]
        if t == "INNER_PRODUCT":
            ip = lp.msg("inner_product_param")
            n = ins[0][0]
            fan = int(math.prod(ins[0][1:]))
            k = int(ip.get("num_output"))
            bias = str(ip.get("bias_term", "true")).lower() != "false"
            self._specs(layer, (k, fan), ip.msg("weight_filler"),
                        (k,) if bias else None, ip.msg("bias_filler"))
            layer.macs = n * k * fan
            return [(n, k)]
        if t in ("RELU", "LRN", "DROPOUT"):
            return [ins[0]]
        if t == "CONCAT":
            cp = lp.msg("concat_param")
            axis = int(cp.get("concat_dim", 1))
            out = list(ins[0])
            out[axis] = sum(s[axis] for s in ins)
            layer.geom = dict(axis=axis)
            return [tuple(out)]
        if t == "SOFTMAX_LOSS":
            return [()]
        raise ValueError(f"reference net: layer type {t} is not covered")

    # ------------------------------------------------------------------ #
    def param_specs(self) -> List[ParamSpec]:
        return [p for layer in self.layers for p in layer.params]

    def forward(self, params: Dict[str, Dict[str, torch.Tensor]],
                data: torch.Tensor, labels: torch.Tensor,
                dropout_gen: torch.Generator,
                quant: Optional[Callable] = None) -> torch.Tensor:
        """The weighted total loss of one batch. ``quant`` (the lower
        precision controls) rounds each conv and FC operand."""
        q = quant or (lambda x: x)
        blobs: Dict[str, torch.Tensor] = {}
        total = data.new_zeros(())
        for layer in self.layers:
            t = layer.type
            if t == "DATA":
                blobs[layer.tops[0]] = data
                if len(layer.tops) > 1:
                    blobs[layer.tops[1]] = labels
                continue
            x = [blobs[b] for b in layer.bottoms]
            p = params.get(layer.name, {})
            if t == "CONVOLUTION":
                g = layer.geom
                y = F.conv2d(q(x[0]), q(p["w"]), p.get("b"), g["stride"],
                             g["pad"], 1, g["group"])
            elif t == "RELU":
                y = F.relu(x[0])
            elif t == "LRN":
                lrn = layer.lp.msg("lrn_param")
                region = str(lrn.get("norm_region", "ACROSS_CHANNELS"))
                if region != "ACROSS_CHANNELS":
                    raise ValueError("reference net: WITHIN_CHANNEL LRN is "
                                     "not covered")
                y = F.local_response_norm(
                    x[0], int(lrn.get("local_size", 5)),
                    float(lrn.get("alpha", 1.0)), float(lrn.get("beta", 0.75)),
                    float(lrn.get("k", 1.0)))
            elif t == "POOLING":
                y = self._pool(layer, x[0])
            elif t == "INNER_PRODUCT":
                y = F.linear(q(x[0].reshape(x[0].shape[0], -1)), q(p["w"]),
                             p.get("b"))
            elif t == "DROPOUT":
                ratio = float(layer.lp.msg("dropout_param").get(
                    "dropout_ratio", 0.5))
                keep = 1.0 - ratio
                mask = torch.rand(x[0].shape, generator=dropout_gen,
                                  device=x[0].device) < keep
                y = torch.where(mask, x[0] / keep,
                                torch.zeros((), dtype=x[0].dtype,
                                            device=x[0].device))
            elif t == "CONCAT":
                y = torch.cat(x, dim=layer.geom["axis"])
            elif t == "SOFTMAX_LOSS":
                y = F.cross_entropy(x[0], x[1].long())
                if layer.loss_weight:
                    total = total + layer.loss_weight * y
            else:
                raise ValueError(f"reference net: {t} is not covered")
            blobs[layer.tops[0]] = y
        return total

    @staticmethod
    def _pool(layer: Layer, x: torch.Tensor) -> torch.Tensor:
        g = layer.geom
        (kh, kw), (sh, sw), (ph, pw) = g["kernel"], g["stride"], g["pad"]
        n, c, h, w = x.shape
        oh, ow = layer.out_shapes[0][2], layer.out_shapes[0][3]
        # the input padded out to where the last window ends
        eh = max(0, (oh - 1) * sh + kh - (h + 2 * ph))
        ew = max(0, (ow - 1) * sw + kw - (w + 2 * pw))
        if g["method"] == "MAX":
            xp = F.pad(x, (pw, pw + ew, ph, ph + eh), value=-math.inf)
            return F.max_pool2d(xp, (kh, kw), (sh, sw))
        if g["method"] != "AVE":
            raise ValueError(f"reference net: {g['method']} pooling is not "
                             f"covered")
        xp = F.pad(x, (pw, pw + ew, ph, ph + eh))
        sums = F.avg_pool2d(xp, (kh, kw), (sh, sw)) * (kh * kw)
        hs = torch.arange(oh, device=x.device) * sh - ph
        ws = torch.arange(ow, device=x.device) * sw - pw
        dh = (hs + kh).clamp(max=h + ph) - hs
        dw = (ws + kw).clamp(max=w + pw) - ws
        div = (dh[:, None] * dw[None, :]).to(x.dtype)
        return sums / div
