"""Convolution (with the space-to-depth stem rewrite and the im2col + GEMM
lowering), im2col,
within-channel LRN, STOCHASTIC pooling and inner product (the part of
``poseidon_tpu/ops/nn.py`` outside the Pallas kernels), in either
activation layout.

The JAX package leaves convolution and GEMMs to XLA, not to Pallas, so the
port leaves them to PyTorch's own operators (cuDNN and cuBLAS on the card)
under the numeric policy of ``numeric.py``: x and w are cast to
``compute_dtype`` and the output stays in it (bfloat16 activations under
the perf policy, the f32 parameters' gradients cast back by autograd);
conv output size stays Caffe's floor((in + 2*pad - k)/stride) + 1.

Layouts are torch's memory formats: logical shapes are always NCHW, and a
``torch.channels_last`` activation is the JAX package's NHWC. Every op here
keeps its input's memory format; the inner product's flatten is the
genuine boundary (Caffe's C-major (C, H, W) order, whatever the layout).
Conv weights stay canonical OIHW in either layout.

Pooling lives in ``ops/pool.py`` with its CUDA backward kernels, and the
cross-channel LRN in ``ops/lrn.py`` with its CUDA kernels: the ops on this
path the JAX package gave Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numeric import CONV_STRATEGIES, memory_format, policy
from .pool import _pool_dims, _pool_pad_crop, ave_pool


def conv_out_size(in_size: int, kernel: int, stride: int, pad: int) -> int:
    return (in_size + 2 * pad - kernel) // stride + 1


def _space_to_depth_rewrite(x: torch.Tensor, w: torch.Tensor, stride,
                            pad) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rewrite of a few-channel strided conv as a stride-1, pad-0
    conv over s*s times the channels (JAX ``_space_to_depth_rewrite``).

    Each s x s input block becomes channels and the kernel is zero-padded
    to a multiple of s, so out(i, j) = sum_{c,u,v} w[o,c,u,v] x[c, si+u,
    sj+v] is the same sum (exact up to float summation order). The channel
    order is (c, sh, sw) in both layouts, so the rewritten kernel w2 is
    canonical OIHW. A channels-last x gives a channels-last x2, built from
    its NHWC view (one copy, no transpose back)."""
    s = stride[0]
    o, c, kh, kw = w.shape
    n, h, wd = x.shape[0], x.shape[2], x.shape[3]
    out_h = conv_out_size(h, kh, s, pad[0])
    out_w = conv_out_size(wd, kw, s, pad[1])
    k2h = -(-kh // s) * s
    k2w = -(-kw // s) * s
    # explicit conv padding, then crop to exactly the rows/cols the
    # out_h x out_w windows touch: s*(out-1) + k2
    need_h = s * (out_h - 1) + k2h
    need_w = s * (out_w - 1) + k2w
    xp = F.pad(x, (pad[1], max(need_w - wd - pad[1], 0),
                   pad[0], max(need_h - h - pad[0], 0)))
    xp = xp[:, :, :need_h, :need_w]
    if memory_format(x) == torch.channels_last:
        x2 = xp.permute(0, 2, 3, 1).reshape(n, need_h // s, s, need_w // s,
                                             s, c)
        x2 = x2.permute(0, 1, 3, 5, 2, 4).reshape(
            n, need_h // s, need_w // s, c * s * s).permute(0, 3, 1, 2)
    else:
        x2 = xp.reshape(n, c, need_h // s, s, need_w // s, s)
        x2 = x2.permute(0, 1, 3, 5, 2, 4).reshape(
            n, c * s * s, need_h // s, need_w // s)
    wp = F.pad(w, (0, k2w - kw, 0, k2h - kh))
    w2 = wp.reshape(o, c, k2h // s, s, k2w // s, s)
    w2 = w2.permute(0, 1, 3, 5, 2, 4).reshape(o, c * s * s, k2h // s,
                                              k2w // s)
    return x2, w2


def _s2d_shape_ok(x: torch.Tensor, w: torch.Tensor, stride, group) -> bool:
    """Structural applicability of the rewrite: a few-channel strided conv
    with a kernel at least as tall as the stride."""
    return (group == 1 and stride[0] == stride[1] and stride[0] >= 2
            and x.shape[1] <= 4 and w.shape[2] >= stride[0])


def _s2d_applicable(x, w, stride, group) -> bool:
    return policy().conv_s2d and _s2d_shape_ok(x, w, stride, group)


def conv_strategy_applicable(strategy: str, x: torch.Tensor,
                             w: torch.Tensor, stride, group) -> bool:
    """Whether a concrete strategy can lower this conv at all (JAX's; the
    measured choice of ``ops/conv_tune.py`` only picks candidates that
    pass it): s2d where the stem rewrite's shape allows, im2col for an
    ungrouped conv, direct always."""
    if strategy == "s2d":
        return _s2d_shape_ok(x, w, stride, group)
    if strategy == "im2col":
        return group == 1
    return strategy in ("", "direct")


def _conv_im2col(xc: torch.Tensor, wc: torch.Tensor, stride,
                 pad) -> torch.Tensor:
    """The explicit im2col + GEMM lowering (Caffe's conv_layer.cpp over
    util/im2col.cpp; JAX's ``_conv_im2col``): patches in Caffe's (c, kh,
    kw) column order, which is the OIHW weight's reshape order, times the
    weight as (O, C·kh·kw) in one ``torch.matmul``. NCHW: the patches by
    ``F.unfold``, (N, K, L), and the product (N, O, L) is NCHW. A
    channels-last x: the patches from its NHWC view, (N·oh·ow, K), and the
    product (N·oh·ow, O) viewed back as a channels-last (N, O, oh, ow), so
    the NHWC graph gains no transpose."""
    n, c, h, w_ = xc.shape
    o, _, kh, kw = wc.shape
    oh = conv_out_size(h, kh, stride[0], pad[0])
    ow = conv_out_size(w_, kw, stride[1], pad[1])
    w2 = wc.reshape(o, -1)
    if memory_format(xc) == torch.channels_last:
        xv = F.pad(xc.permute(0, 2, 3, 1),
                   (0, 0, pad[1], pad[1], pad[0], pad[0]))
        patches = xv.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
        y = torch.matmul(patches.reshape(n * oh * ow, c * kh * kw), w2.t())
        return y.view(n, oh, ow, o).permute(0, 3, 1, 2)
    cols = F.unfold(xc, (kh, kw), padding=tuple(pad), stride=tuple(stride))
    return torch.matmul(w2, cols).view(n, o, oh, ow)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: Tuple[int, int], pad: Tuple[int, int], group: int = 1,
           act: Optional[str] = None, act_slope: float = 0.0,
           strategy: Optional[str] = None) -> torch.Tensor:
    """Convolution with the fused bias + ReLU epilogue. ``w`` is OIHW with
    I = C/group; x and w are cast to the policy's ``compute_dtype`` and the
    output (in x's memory format) stays in it. ``strategy`` selects the
    lowering: "direct", "im2col" (patches + one GEMM, ``_conv_im2col``),
    "s2d" (the stem rewrite, where its shape allows), or None/"" for the
    policy's ``conv_s2d``; a strategy that cannot lower this conv (grouped
    im2col, non-stem s2d) takes direct, as in JAX, and "auto" (resolved
    per layer when the Net is built) raises JAX's ValueError. The epilogue
    runs in place on the convolution's own fresh output, so the fold
    allocates nothing (the JAX package folds the same in-place ReLU into
    its conv; both give Caffe's ``relu(conv + b)``)."""
    cd = policy().compute_dtype
    xc, wc = x.to(cd), w.to(cd)
    strategy = strategy or ""
    if strategy not in CONV_STRATEGIES or strategy == "auto":
        raise ValueError(f"conv2d: unresolved strategy {strategy!r} "
                         f"(choose from {CONV_STRATEGIES[2:]}; 'auto' is "
                         f"resolved per layer at Net construction)")
    use_s2d = (_s2d_applicable(xc, wc, stride, group) if strategy == ""
               else strategy == "s2d" and _s2d_shape_ok(xc, wc, stride,
                                                        group))
    if use_s2d:
        xc, wc = _space_to_depth_rewrite(xc, wc, stride, pad)
        stride, pad = (1, 1), (0, 0)
    if strategy == "im2col" and group == 1:
        y = _conv_im2col(xc, wc, stride, pad)
        if b is not None:
            y.add_(b.to(cd).view(1, -1, 1, 1))
    else:
        if memory_format(xc) == torch.channels_last:
            # the call's own copy of the weight goes to cuDNN
            # channels-last too, so it transforms no filter (the stored
            # weight stays OIHW; its gradient comes back through this
            # copy)
            wc = wc.contiguous(memory_format=torch.channels_last)
        y = F.conv2d(xc, wc, None if b is None else b.to(cd),
                     stride=tuple(stride), padding=tuple(pad), groups=group)
    if act == "relu":
        if act_slope == 0.0:
            y.clamp_min_(0)
        else:
            y = torch.where(y > 0, y, act_slope * y)
    elif act is not None:
        raise ValueError(f"unknown conv epilogue act {act!r}")
    return y


def im2col(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
           pad: Tuple[int, int]) -> torch.Tensor:
    """Patch extraction (the IM2COL layer, util/im2col.cpp): (N, C*kh*kw,
    out_h, out_w) in Caffe's column order, channel-major then the kernel's
    rows and columns. The column order is the layer's contract, so the
    result is NCHW-contiguous whatever x's memory format."""
    n, _, h, w = x.shape
    oh = conv_out_size(h, kernel[0], stride[0], pad[0])
    ow = conv_out_size(w, kernel[1], stride[1], pad[1])
    cols = F.unfold(x, tuple(kernel), padding=tuple(pad),
                    stride=tuple(stride))
    return cols.reshape(n, cols.shape[1], oh, ow)


def stochastic_pool(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    """STOCHASTIC pooling as the JAX package computes it in both phases:
    the probability-weighted average of each window, sum(x^2) /
    max(sum(x), FLT_MIN), the reference's TEST path (pooling_layer.cu);
    x must be non-negative. Caffe's ceil-mode output size; padding raises,
    as in JAX. Window sums are torch's average pooling with divisor 1, so
    autograd gives the backward."""
    if tuple(pad) != (0, 0):
        raise NotImplementedError("stochastic pooling with padding")
    _, _, oh, ow = _pool_dims(x, kernel, stride, pad)

    def window_sum(t):
        tp = _pool_pad_crop(t, kernel, stride, pad, oh, ow, 0.0)
        return F.avg_pool2d(tp, tuple(kernel), tuple(stride),
                            divisor_override=1)

    tiny = float(np.finfo(np.float32).tiny)
    return window_sum(x * x) / torch.clamp_min(window_sum(x), tiny)


def lrn_within_channel(x: torch.Tensor, local_size: int, alpha: float,
                       beta: float) -> torch.Tensor:
    """WITHIN_CHANNEL LRN: scale = (1 + alpha * avgpool(x^2))^-beta over a
    local_size x local_size window (Caffe's lrn_layer.cpp), in x's dtype
    and memory format."""
    pre_pad = (local_size - 1) // 2
    pooled = ave_pool(x * x, (local_size, local_size), (1, 1),
                      (pre_pad, pre_pad))
    scale = 1.0 + alpha * pooled
    return x * scale.pow(-beta)


def inner_product(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (N, ...) flattened C-major to (N, K) (a channels-last x is
    gathered into that order: the layout's genuine boundary); w: (M, K) as
    Caffe stores it. Computed in the policy's ``compute_dtype``."""
    cd = policy().compute_dtype
    return F.linear(x.reshape(x.shape[0], -1).to(cd), w.to(cd),
                    None if b is None else b.to(cd))
