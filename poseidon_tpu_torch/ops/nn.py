"""Convolution, pooling, within-channel LRN and inner product, NCHW only
(the serving subset of ``poseidon_tpu/ops/nn.py``).

The JAX package leaves convolution, pooling and GEMMs to XLA, not to
Pallas, so the port leaves them to PyTorch's own operators (cuDNN and
cuBLAS on the card) with the f32 policy of ``numeric.py``. What must stay
Caffe-exact is wrapped around them here:

- conv output size: floor((in + 2*pad - k)/stride) + 1
- pool output size: ceil((in + 2*pad - k)/stride) + 1, minus one if the
  last window would start in the padding (``pool_out_size``)
- pooling runs over the Caffe-padded input cropped to exactly the extent
  the output grid consumes (``_pool_pad_crop``), so no builtin ceil-mode
  rule decides a window;
- AVE pooling divides by the window clipped to the *padded* extent.

The cross-channel LRN, the one op the JAX package gave a Pallas kernel on
this path, lives in ``ops/lrn.py`` with its CUDA kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv_out_size(in_size: int, kernel: int, stride: int, pad: int) -> int:
    return (in_size + 2 * pad - kernel) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: Tuple[int, int], pad: Tuple[int, int], group: int = 1,
           act: Optional[str] = None, act_slope: float = 0.0) -> torch.Tensor:
    """Convolution with the fused bias + ReLU epilogue. ``w`` is OIHW with
    I = C/group. The epilogue runs in place on the convolution's own fresh
    output, so the fold allocates nothing (the JAX package folds the same
    in-place ReLU into its conv; both give Caffe's ``relu(conv + b)``)."""
    y = F.conv2d(x, w, b, stride=tuple(stride), padding=tuple(pad),
                 groups=group)
    if act == "relu":
        if act_slope == 0.0:
            y.clamp_min_(0)
        else:
            y = torch.where(y > 0, y, act_slope * y)
    elif act is not None:
        raise ValueError(f"unknown conv epilogue act {act!r}")
    return y


def pool_out_size(in_size: int, kernel: int, stride: int, pad: int) -> int:
    out = int(math.ceil((in_size + 2 * pad - kernel) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= in_size + pad:
        out -= 1
    return out


def _pool_dims(x, kernel, stride, pad):
    h, w = x.shape[2], x.shape[3]
    return h, w, pool_out_size(h, kernel[0], stride[0], pad[0]), \
        pool_out_size(w, kernel[1], stride[1], pad[1])


def _pool_pad_crop(x, kernel, stride, pad, oh, ow, fill: float):
    """The Caffe-padded input, cropped to exactly the extent the oh x ow
    output grid consumes ((o-1)*s + k per spatial dim)."""
    h, w = x.shape[2], x.shape[3]
    hi_h = max((oh - 1) * stride[0] + kernel[0] - pad[0] - h, 0)
    hi_w = max((ow - 1) * stride[1] + kernel[1] - pad[1] - w, 0)
    xp = F.pad(x, (pad[1], hi_w, pad[0], hi_h), value=fill)
    return xp[:, :, :(oh - 1) * stride[0] + kernel[0],
              :(ow - 1) * stride[1] + kernel[1]]


def max_pool(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    xp = _pool_pad_crop(x, kernel, stride, pad, oh, ow, -math.inf)
    return F.max_pool2d(xp, tuple(kernel), tuple(stride))


def _ave_denom(h, w, oh, ow, kernel, stride, pad) -> np.ndarray:
    """Caffe's AVE divisor: the window clipped to the padded extent
    [start, in+pad), where start may be negative."""
    def divisors(n_out, stride_, pad_, kernel_, in_):
        starts = np.arange(n_out) * stride_ - pad_
        ends = np.minimum(starts + kernel_, in_ + pad_)
        return (ends - starts).astype(np.float32)

    return np.outer(divisors(oh, stride[0], pad[0], kernel[0], h),
                    divisors(ow, stride[1], pad[1], kernel[1], w))


def ave_pool(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    xp = _pool_pad_crop(x, kernel, stride, pad, oh, ow, 0.0)
    summed = F.avg_pool2d(xp, tuple(kernel), tuple(stride),
                          divisor_override=1)
    denom = torch.from_numpy(_ave_denom(h, w, oh, ow, kernel, stride, pad))
    return summed / denom.to(device=x.device, dtype=x.dtype)


def lrn_within_channel(x: torch.Tensor, local_size: int, alpha: float,
                       beta: float) -> torch.Tensor:
    """WITHIN_CHANNEL LRN: scale = (1 + alpha * avgpool(x^2))^-beta over a
    local_size x local_size window (Caffe's lrn_layer.cpp)."""
    pre_pad = (local_size - 1) // 2
    pooled = ave_pool(x * x, (local_size, local_size), (1, 1),
                      (pre_pad, pre_pad))
    scale = 1.0 + alpha * pooled
    return x * scale.pow(-beta)


def inner_product(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (N, ...) flattened C-major to (N, K); w: (M, K) as Caffe stores
    it."""
    return F.linear(x.reshape(x.shape[0], -1), w, b)
