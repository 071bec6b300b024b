"""Convolution, within-channel LRN and inner product, NCHW only (the
subset of ``poseidon_tpu/ops/nn.py`` that CNN serving and training use).

The JAX package leaves convolution and GEMMs to XLA, not to Pallas, so the
port leaves them to PyTorch's own operators (cuDNN and cuBLAS on the card)
with the f32 policy of ``numeric.py``; conv output size stays Caffe's
floor((in + 2*pad - k)/stride) + 1.

Pooling lives in ``ops/pool.py`` with its CUDA backward kernel, and the
cross-channel LRN in ``ops/lrn.py`` with its CUDA kernels: the ops on this
path the JAX package gave Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .pool import ave_pool


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
