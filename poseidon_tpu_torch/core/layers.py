"""The layer catalog (the port of ``poseidon_tpu/core/layers.py``).

A layer is an ``nn.Module`` without parameters of its own: ``setup`` infers
top shapes from bottom shapes and declares ``ParamDef``s, ``forward`` maps
(params, bottoms) to tops. The net owns the parameter tensors and passes
each layer its own, so a hot swap replaces one dict reference. Backward is
autograd over the forward; the ops with hand-written kernels (LRN, pooling)
are ``torch.autograd.Function``s whose backward is the kernel.

Every type of JAX's ``REGISTRY``: CONVOLUTION, INNER_PRODUCT, POOLING
(MAX, AVE, STOCHASTIC), LRN, IM2COL, the neurons (RELU, SIGMOID, TANH,
BNLL, ABSVAL, POWER, THRESHOLD, DROPOUT), the structural layers (FLATTEN,
CONCAT, SLICE, SPLIT, ELTWISE, MVN, SILENCE), SOFTMAX and ARGMAX, the
losses (SOFTMAX, EUCLIDEAN, HINGE, MULTINOMIAL_LOGISTIC,
SIGMOID_CROSS_ENTROPY, INFOGAIN, CONTRASTIVE) and ACCURACY, DUMMY_DATA
(drawn in the graph), HDF5_OUTPUT (no compute: the engine dumps its
bottoms), and the data sources (DATA and the other source types), whose
tops the data pipeline provides. A type outside the catalog raises
``ValueError`` naming it, as in JAX.

Logical shapes are NCHW in both of the net's layouts (torch's
``channels_last`` is a memory format), so the layers that name an axis
(CONCAT, SLICE, SOFTMAX, MVN) take Caffe's axis as it is; JAX remaps it
under its NHWC plan because its NHWC tensors are NHWC logically.
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
from .fillers import fill

Shape = Tuple[int, ...]

LOSS_TYPES = {
    "SOFTMAX_LOSS", "EUCLIDEAN_LOSS", "HINGE_LOSS", "INFOGAIN_LOSS",
    "MULTINOMIAL_LOGISTIC_LOSS", "SIGMOID_CROSS_ENTROPY_LOSS",
    "CONTRASTIVE_LOSS",
}
# data layers: sources whose tops the data pipeline provides, so the net
# takes them as external inputs (the pipeline says which ones it reads)
DATA_SOURCE_TYPES = {"DATA", "IMAGE_DATA", "HDF5_DATA", "WINDOW_DATA",
                     "MEMORY_DATA"}


class Layer(nn.Module):
    TYPE = "NONE"

    def __init__(self, lp: LayerParameter, index: int = 0):
        super().__init__()
        self.lp = lp
        # the layer's position among the phase-filtered layers (JAX's
        # index; DUMMY_DATA derives its generator from it)
        self.index = index
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

    def __init__(self, lp: LayerParameter, index: int = 0):
        super().__init__(lp, index)
        # set by the net's epilogue plan when an in-place ReLU immediately
        # consumes this conv's top
        self.fused_relu_slope: Optional[float] = None
        # this layer's conv lowering, planned by the net ("" leaves it to
        # the policy's conv_s2d; "auto" is resolved to a measured winner)
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
        if self.method not in ("MAX", "AVE", "STOCHASTIC"):
            raise ValueError(f"unknown pool method {self.method}")
        # the pooling Function (MAX and AVE: its backward the kernel on a
        # CUDA tensor, the plain version on a CPU tensor; chip_smoke.py
        # swaps in the plain-backward reference to hold a training step
        # against it). STOCHASTIC is the prob-weighted average in both
        # phases, as in JAX, left to PyTorch's operators
        self.pool = {"MAX": P.max_pool, "AVE": P.ave_pool,
                     "STOCHASTIC": NN.stochastic_pool}[self.method]
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

    def __init__(self, lp: LayerParameter, index: int = 0):
        super().__init__(lp, index)
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

    def __init__(self, lp: LayerParameter, index: int = 0):
        super().__init__(lp, index)
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


class Im2colLayer(Layer):
    TYPE = "IM2COL"

    def setup(self, bottom_shapes):
        cp = self.lp.convolution_param
        n, c, h, w = bottom_shapes[0]
        self.kernel = _resolve_hw(cp.kernel_size, cp.kernel_h, cp.kernel_w,
                                  what="kernel", layer=self.name)
        self.stride = _resolve_hw(cp.stride, cp.stride_h, cp.stride_w, 1,
                                  what="stride", layer=self.name)
        self.pad = _resolve_hw(cp.pad, cp.pad_h, cp.pad_w, 0,
                               what="pad", layer=self.name)
        oh = NN.conv_out_size(h, self.kernel[0], self.stride[0], self.pad[0])
        ow = NN.conv_out_size(w, self.kernel[1], self.stride[1], self.pad[1])
        return [(n, c * self.kernel[0] * self.kernel[1], oh, ow)]

    def forward(self, params, bottoms, train):
        return [NN.im2col(bottoms[0], self.kernel, self.stride, self.pad)]


class _NeuronLayer(Layer):
    """Shape-preserving elementwise: ``fn`` of the bottom."""

    def setup(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train):
        return [self.fn(bottoms[0])]


class SigmoidLayer(_NeuronLayer):
    TYPE = "SIGMOID"

    def fn(self, x):
        return E.sigmoid(x)


class TanHLayer(_NeuronLayer):
    TYPE = "TANH"

    def fn(self, x):
        return E.tanh(x)


class BNLLLayer(_NeuronLayer):
    TYPE = "BNLL"

    def fn(self, x):
        return E.bnll(x)


class AbsValLayer(_NeuronLayer):
    TYPE = "ABSVAL"

    def fn(self, x):
        return E.absval(x)


class PowerLayer(_NeuronLayer):
    TYPE = "POWER"

    def fn(self, x):
        pp = self.lp.power_param
        return E.power(x, pp.power, pp.scale, pp.shift)


class ThresholdLayer(_NeuronLayer):
    TYPE = "THRESHOLD"

    def fn(self, x):
        return E.threshold(x, self.lp.threshold_param.threshold)


class MVNLayer(_NeuronLayer):
    TYPE = "MVN"

    def fn(self, x):
        mp = self.lp.mvn_param
        return E.mvn(x, mp.normalize_variance, mp.across_channels)


class SliceLayer(Layer):
    TYPE = "SLICE"

    def setup(self, bottom_shapes):
        sp = self.lp.slice_param
        self.axis = sp.slice_dim
        self.points = list(sp.slice_point)
        n_top = len(self.lp.top)
        size = bottom_shapes[0][self.axis]
        if self.points:
            bounds = [0] + self.points + [size]
        else:
            if size % n_top != 0:
                raise ValueError(
                    f"layer {self.lp.name!r}: cannot slice axis of size "
                    f"{size} into {n_top} equal tops")
            bounds = [i * (size // n_top) for i in range(n_top + 1)]
        shapes = []
        for i in range(n_top):
            s = list(bottom_shapes[0])
            s[self.axis] = bounds[i + 1] - bounds[i]
            shapes.append(tuple(s))
        return shapes

    def forward(self, params, bottoms, train):
        return E.slice_blob(bottoms[0], self.axis, self.points,
                            len(self.lp.top))


class EltwiseLayer(Layer):
    TYPE = "ELTWISE"

    def setup(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train):
        ep = self.lp.eltwise_param
        return [E.eltwise(bottoms, ep.operation, ep.coeff)]


class _SinkLayer(Layer):
    """No tops and no compute."""

    def setup(self, bottom_shapes):
        return []

    def forward(self, params, bottoms, train):
        return []


class SilenceLayer(_SinkLayer):
    TYPE = "SILENCE"


class HDF5OutputLayer(_SinkLayer):
    """hdf5_output_layer.cpp: file IO cannot live in the graph, so the
    engine writes the bottoms after each iteration (``runtime/engine.py``,
    as the JAX engine does)."""
    TYPE = "HDF5_OUTPUT"


class ArgMaxLayer(Layer):
    TYPE = "ARGMAX"

    def setup(self, bottom_shapes):
        ap = self.lp.argmax_param
        n = bottom_shapes[0][0]
        return [(n, 2 if ap.out_max_val else 1, ap.top_k, 1)]

    def forward(self, params, bottoms, train):
        ap = self.lp.argmax_param
        return [L.argmax(bottoms[0], ap.top_k, ap.out_max_val)]


class _ScalarTopLayer(Layer):
    def setup(self, bottom_shapes):
        return [()]


class EuclideanLossLayer(_ScalarTopLayer):
    TYPE = "EUCLIDEAN_LOSS"

    def forward(self, params, bottoms, train):
        return [L.euclidean_loss(bottoms[0], bottoms[1])]


class HingeLossLayer(_ScalarTopLayer):
    TYPE = "HINGE_LOSS"

    def forward(self, params, bottoms, train):
        return [L.hinge_loss(bottoms[0], bottoms[1],
                             self.lp.hinge_loss_param.norm)]


class MultinomialLogisticLossLayer(_ScalarTopLayer):
    TYPE = "MULTINOMIAL_LOGISTIC_LOSS"

    def forward(self, params, bottoms, train):
        return [L.multinomial_logistic_loss(bottoms[0], bottoms[1])]


class SigmoidCrossEntropyLossLayer(_ScalarTopLayer):
    TYPE = "SIGMOID_CROSS_ENTROPY_LOSS"

    def forward(self, params, bottoms, train):
        return [L.sigmoid_cross_entropy_loss(bottoms[0], bottoms[1])]


class InfogainLossLayer(_ScalarTopLayer):
    """H is the third bottom, or read from ``infogain_loss_param.source``
    (a ``.npy`` file, else a blob file) as a (dim, dim) matrix, dim the
    bottom's count a sample."""
    TYPE = "INFOGAIN_LOSS"

    def setup(self, bottom_shapes):
        src = self.lp.infogain_loss_param.source
        self.H: Optional[torch.Tensor] = None
        if len(bottom_shapes) < 3:
            if not src:
                raise ValueError(
                    f"{self.name}: infogain needs a source or 3rd bottom")
            from ..proto.wire import read_blob_file
            h = (np.load(src) if src.endswith(".npy")
                 else read_blob_file(src))
            dim = int(np.prod(bottom_shapes[0][1:]))
            self.H = torch.from_numpy(
                np.asarray(h, np.float32).reshape(dim, dim).copy())
        return [()]

    def forward(self, params, bottoms, train):
        if len(bottoms) >= 3:
            H = bottoms[2]
            if H.dim() > 2:
                H = (H.reshape(H.shape[-2], H.shape[-1])
                     if H.shape[-1] == H.shape[-2]
                     else H.reshape(int(H.numel() ** 0.5), -1))
        else:
            x = bottoms[0]
            if (self.H.device, self.H.dtype) != (x.device, x.dtype):
                # moved once: a forward inside a CUDA graph's capture
                # copies nothing from the host
                self.H = self.H.to(device=x.device, dtype=x.dtype)
            H = self.H
        return [L.infogain_loss(bottoms[0], bottoms[1], H)]


class ContrastiveLossLayer(_ScalarTopLayer):
    TYPE = "CONTRASTIVE_LOSS"

    def forward(self, params, bottoms, train):
        return [L.contrastive_loss(bottoms[0], bottoms[1], bottoms[2],
                                   self.lp.contrastive_loss_param.margin)]


class _SourceLayer(Layer):
    """A data source: its tops come from the data pipeline, so the net
    takes them as external inputs and never builds this class."""

    def setup(self, bottom_shapes):
        raise RuntimeError(
            f"{self.TYPE} tops must come from the data pipeline")

    def forward(self, params, bottoms, train):
        raise RuntimeError(f"{self.TYPE} is not applied in the graph")


class DataLayer(_SourceLayer):
    TYPE = "DATA"


class ImageDataLayer(_SourceLayer):
    TYPE = "IMAGE_DATA"


class HDF5DataLayer(_SourceLayer):
    TYPE = "HDF5_DATA"


class WindowDataLayer(_SourceLayer):
    TYPE = "WINDOW_DATA"


class MemoryDataLayer(_SourceLayer):
    TYPE = "MEMORY_DATA"


class DummyDataLayer(Layer):
    """Tops drawn in the graph from ``dummy_data_param``'s fillers (one a
    top, or one for all), each forward, from ``generator``: the net's,
    derived from its seed and this layer's index (``Net.manual_seed``).
    Torch cannot replay JAX's threefry stream, so a non-constant filler
    draws other numbers than JAX's from the same shape and law."""
    TYPE = "DUMMY_DATA"

    def __init__(self, lp: LayerParameter, index: int = 0):
        super().__init__(lp, index)
        self.generator: Optional[torch.Generator] = None

    def setup(self, bottom_shapes):
        dp = self.lp.dummy_data_param
        n_top = len(self.lp.top)

        def dim(values, i):
            return values[0] if len(values) == 1 else values[i]

        self.shapes = [(dim(dp.num, i), dim(dp.channels, i),
                        dim(dp.height, i), dim(dp.width, i))
                       for i in range(n_top)]
        fillers = dp.data_filler or [FillerParameter()]
        self.fillers = [fillers[i] if len(fillers) > 1 else fillers[0]
                        for i in range(n_top)]
        return list(self.shapes)

    def forward(self, params, bottoms, train):
        return [fill(self.generator, ParamDef(name=f"top{i}", shape=shape,
                                              filler=f))
                for i, (shape, f) in enumerate(zip(self.shapes,
                                                   self.fillers))]


REGISTRY: Dict[str, type] = {
    cls.TYPE: cls
    for cls in [
        ConvolutionLayer, InnerProductLayer, PoolingLayer, LRNLayer,
        Im2colLayer, ReLULayer, SigmoidLayer, TanHLayer, BNLLLayer,
        AbsValLayer, PowerLayer, ThresholdLayer, DropoutLayer, FlattenLayer,
        ConcatLayer, SliceLayer, SplitLayer, EltwiseLayer, MVNLayer,
        SilenceLayer, SoftmaxLayer, ArgMaxLayer, SoftmaxLossLayer,
        EuclideanLossLayer, HingeLossLayer, MultinomialLogisticLossLayer,
        SigmoidCrossEntropyLossLayer, InfogainLossLayer, ContrastiveLossLayer,
        AccuracyLayer, DataLayer, ImageDataLayer, HDF5DataLayer,
        WindowDataLayer, MemoryDataLayer, DummyDataLayer, HDF5OutputLayer,
    ]
}


def create_layer(lp: LayerParameter, index: int = 0) -> Layer:
    t = lp.canonical_type()
    if t not in REGISTRY:
        raise ValueError(f"layer {lp.name!r}: unsupported type {t}")
    return REGISTRY[t](lp, index)
