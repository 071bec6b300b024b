"""The CNN subset of the layer catalog (``poseidon_tpu/core/layers.py``).

A layer is an ``nn.Module`` without parameters of its own: ``setup`` infers
top shapes from bottom shapes and declares ``ParamDef``s, ``forward`` maps
(params, bottoms) to tops. The net owns the parameter tensors and passes
each layer its own, so a hot swap replaces one dict reference. Backward is
autograd over the forward; the ops with hand-written kernels (LRN, pooling)
are ``torch.autograd.Function``s whose backward is the kernel.

Types: CONVOLUTION, INNER_PRODUCT, POOLING (MAX, AVE), LRN, RELU, DROPOUT,
SOFTMAX, FLATTEN, SPLIT, CONCAT, SOFTMAX_LOSS and ACCURACY, plus the data
layers (DATA and the other source types), whose tops the data pipeline
provides. Any other type raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import elementwise as E
from ..ops import losses as L
from ..ops import nn as NN
from ..ops import pool as P
from ..ops.lrn import lrn_across_channels
from ..proto.messages import FillerParameter, LayerParameter
from .blob import ParamDef

Shape = Tuple[int, ...]

LOSS_TYPES = {"SOFTMAX_LOSS"}
# data layers: sources whose tops the data pipeline provides, so the net
# takes them as external inputs (the pipeline says which ones it reads)
DATA_SOURCE_TYPES = {"DATA", "IMAGE_DATA", "HDF5_DATA", "WINDOW_DATA",
                     "MEMORY_DATA"}


class Layer(nn.Module):
    TYPE = "NONE"

    def __init__(self, lp: LayerParameter):
        super().__init__()
        self.lp = lp
        self.params: List[ParamDef] = []

    @property
    def name(self) -> str:
        return self.lp.name

    def extra_repr(self) -> str:
        return f"{self.name!r}"

    def loss_weights(self, n_tops: int) -> List[float]:
        """Per-top loss weights: the prototxt's, else 1 on top 0 of a loss
        layer and 0 elsewhere (Caffe's default)."""
        lw = list(self.lp.loss_weight)
        if not lw:
            default = 1.0 if self.TYPE in LOSS_TYPES else 0.0
            return [default if i == 0 else 0.0 for i in range(n_tops)]
        if len(lw) != n_tops:
            raise ValueError(f"{self.name}: loss_weight arity mismatch")
        return lw

    def _param(self, name: str, shape: Shape, filler: FillerParameter,
               blob_index: int) -> ParamDef:
        spec = self.lp.param_spec(blob_index)
        if spec.name:
            raise NotImplementedError(
                f"layer {self.name!r}: shared (named) params are not in the "
                f"port yet")
        return ParamDef(name=name, shape=shape, filler=filler,
                        lr_mult=spec.lr_mult, decay_mult=spec.decay_mult)

    def setup(self, bottom_shapes: List[Shape]) -> List[Shape]:
        raise NotImplementedError

    def forward(self, params: Dict[str, torch.Tensor],
                bottoms: List[torch.Tensor], train: bool
                ) -> List[torch.Tensor]:
        raise NotImplementedError


def _resolve_hw(single, h, w, default=None, *, what="", layer=""):
    """Caffe's size rule: the square ``single`` value or BOTH h and w;
    required unless a default exists."""
    if h or w:
        if single:
            raise ValueError(
                f"layer {layer!r}: specify {what} as one size OR "
                f"{what}_h/{what}_w, not both")
        if not (h and w):
            raise ValueError(
                f"layer {layer!r}: both {what}_h and {what}_w are required "
                f"for non-square {what}")
        return int(h), int(w)
    if single:
        return int(single), int(single)
    if default is None:
        raise ValueError(f"layer {layer!r}: {what} must be specified")
    return default, default


class ConvolutionLayer(Layer):
    TYPE = "CONVOLUTION"

    def __init__(self, lp: LayerParameter):
        super().__init__(lp)
        # set by the net's epilogue plan when an in-place ReLU immediately
        # consumes this conv's top
        self.fused_relu_slope: Optional[float] = None
        # the net's conv lowering ("" leaves it to the policy's conv_s2d)
        self.conv_strategy: str = ""

    def setup(self, bottom_shapes):
        cp = self.lp.convolution_param
        n, c, h, w = bottom_shapes[0]
        self.kernel = _resolve_hw(cp.kernel_size, cp.kernel_h, cp.kernel_w,
                                  what="kernel", layer=self.name)
        self.stride = _resolve_hw(cp.stride, cp.stride_h, cp.stride_w, 1,
                                  what="stride", layer=self.name)
        self.pad = _resolve_hw(cp.pad, cp.pad_h, cp.pad_w, 0,
                               what="pad", layer=self.name)
        self.group = cp.group
        self.bias_term = cp.bias_term
        if c % self.group or cp.num_output % self.group:
            raise ValueError(f"{self.name}: channels not divisible by group")
        wshape = (cp.num_output, c // self.group, *self.kernel)
        self.params = [self._param("w", wshape, cp.weight_filler, 0)]
        if self.bias_term:
            self.params.append(
                self._param("b", (cp.num_output,), cp.bias_filler, 1))
        oh = NN.conv_out_size(h, self.kernel[0], self.stride[0], self.pad[0])
        ow = NN.conv_out_size(w, self.kernel[1], self.stride[1], self.pad[1])
        return [(n, cp.num_output, oh, ow)] * len(self.lp.top)

    def forward(self, params, bottoms, train):
        act = "relu" if self.fused_relu_slope is not None else None
        return [NN.conv2d(x, params["w"], params.get("b"), self.stride,
                          self.pad, self.group, act=act,
                          act_slope=self.fused_relu_slope or 0.0,
                          strategy=self.conv_strategy)
                for x in bottoms]


class InnerProductLayer(Layer):
    TYPE = "INNER_PRODUCT"

    def setup(self, bottom_shapes):
        ip = self.lp.inner_product_param
        n = bottom_shapes[0][0]
        k = int(np.prod(bottom_shapes[0][1:]))
        self.params = [self._param("w", (ip.num_output, k),
                                   ip.weight_filler, 0)]
        if ip.bias_term:
            self.params.append(self._param("b", (ip.num_output,),
                                           ip.bias_filler, 1))
        return [(n, ip.num_output)]

    def forward(self, params, bottoms, train):
        return [NN.inner_product(bottoms[0], params["w"], params.get("b"))]


class PoolingLayer(Layer):
    TYPE = "POOLING"

    def setup(self, bottom_shapes):
        pp = self.lp.pooling_param
        n, c, h, w = bottom_shapes[0]
        if pp.global_pooling:
            self.kernel, self.stride, self.pad = (h, w), (1, 1), (0, 0)
        else:
            self.kernel = _resolve_hw(pp.kernel_size, pp.kernel_h,
                                      pp.kernel_w, what="kernel",
                                      layer=self.name)
            self.stride = _resolve_hw(pp.stride, pp.stride_h, pp.stride_w, 1,
                                      what="stride", layer=self.name)
            self.pad = _resolve_hw(pp.pad, pp.pad_h, pp.pad_w, 0,
                                   what="pad", layer=self.name)
        self.method = pp.pool
        if self.method not in ("MAX", "AVE"):
            raise NotImplementedError(
                f"layer {self.name!r}: {self.method} pooling is not in the "
                f"port yet")
        # the pooling Function (its backward: the kernel on a CUDA tensor,
        # the plain version on a CPU tensor); chip_smoke.py swaps in the
        # plain-backward reference to hold a training step against it
        self.pool = P.max_pool if self.method == "MAX" else P.ave_pool
        oh = P.pool_out_size(h, self.kernel[0], self.stride[0], self.pad[0])
        ow = P.pool_out_size(w, self.kernel[1], self.stride[1], self.pad[1])
        return [(n, c, oh, ow)]

    def forward(self, params, bottoms, train):
        return [self.pool(bottoms[0], self.kernel, self.stride, self.pad)]


class LRNLayer(Layer):
    TYPE = "LRN"

    def setup(self, bottom_shapes):
        p = self.lp.lrn_param
        self.local_size = p.local_size
        self.alpha = p.alpha
        self.beta = p.beta
        self.region = p.norm_region
        self.k = p.k
        # the across-channels implementation: the kernels' autograd Function
        # (the plain versions on a CPU tensor); chip_smoke.py swaps in the
        # plain reference to hold a forward or a training step against it
        # on the card
        self.across_channels = lrn_across_channels
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train):
        x = bottoms[0]
        if self.region == "ACROSS_CHANNELS":
            return [self.across_channels(x, self.local_size, self.alpha,
                                         self.beta, self.k)]
        return [NN.lrn_within_channel(x, self.local_size, self.alpha,
                                      self.beta)]


class ReLULayer(Layer):
    TYPE = "RELU"

    def __init__(self, lp: LayerParameter):
        super().__init__(lp)
        # set by the net's epilogue plan: this in-place ReLU was folded
        # into the producing conv, so forward is the identity
        self.folded_into: Optional[str] = None

    def setup(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train):
        if self.folded_into is not None:
            return [bottoms[0]]
        return [E.relu(bottoms[0], self.lp.relu_param.negative_slope)]


class DropoutLayer(Layer):
    TYPE = "DROPOUT"

    def __init__(self, lp: LayerParameter):
        super().__init__(lp)
        # the net's dropout generator (on the net's device), set by the net
        self.generator: Optional[torch.Generator] = None

    def setup(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train):
        return [E.dropout(bottoms[0], self.lp.dropout_param.dropout_ratio,
                          train, self.generator)]


class FlattenLayer(Layer):
    TYPE = "FLATTEN"

    def setup(self, bottom_shapes):
        return [(bottom_shapes[0][0], int(np.prod(bottom_shapes[0][1:])))]

    def forward(self, params, bottoms, train):
        return [E.flatten(bottoms[0])]


class ConcatLayer(Layer):
    TYPE = "CONCAT"

    def setup(self, bottom_shapes):
        self.axis = self.lp.concat_param.concat_dim
        out = list(bottom_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in bottom_shapes)
        return [tuple(out)]

    def forward(self, params, bottoms, train):
        return [E.concat(bottoms, self.axis)]


class SplitLayer(Layer):
    TYPE = "SPLIT"

    def setup(self, bottom_shapes):
        return [bottom_shapes[0]] * len(self.lp.top)

    def forward(self, params, bottoms, train):
        return [bottoms[0]] * len(self.lp.top)


class SoftmaxLayer(Layer):
    TYPE = "SOFTMAX"

    def setup(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train):
        return [L.softmax(bottoms[0], axis=1)]


class SoftmaxLossLayer(Layer):
    TYPE = "SOFTMAX_LOSS"

    def setup(self, bottom_shapes):
        if len(self.lp.top) >= 2:
            return [(), bottom_shapes[0]]
        return [()]

    def forward(self, params, bottoms, train):
        loss = L.softmax_loss(bottoms[0], bottoms[1])
        if len(self.lp.top) >= 2:
            return [loss, L.softmax(bottoms[0], axis=1)]
        return [loss]


class AccuracyLayer(Layer):
    TYPE = "ACCURACY"

    def setup(self, bottom_shapes):
        return [()]

    def forward(self, params, bottoms, train):
        return [L.accuracy(bottoms[0], bottoms[1],
                           self.lp.accuracy_param.top_k)]


REGISTRY: Dict[str, type] = {
    cls.TYPE: cls
    for cls in [ConvolutionLayer, InnerProductLayer, PoolingLayer, LRNLayer,
                ReLULayer, DropoutLayer, FlattenLayer, ConcatLayer,
                SplitLayer, SoftmaxLayer, SoftmaxLossLayer, AccuracyLayer]
}


def create_layer(lp: LayerParameter) -> Layer:
    t = lp.canonical_type()
    if t not in REGISTRY:
        raise NotImplementedError(
            f"layer {lp.name!r}: type {t} is not in the port yet")
    return REGISTRY[t](lp)
