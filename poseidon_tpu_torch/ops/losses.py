"""Losses and metrics (the port of ``poseidon_tpu/ops/losses.py``), with
the reference's normalization (``*_loss_layer.cpp``):

- softmax_loss: -mean over (num * spatial) of log prob[label], log probs
  clamped at log(FLT_MIN);
- multinomial_logistic: the same over num only, probs clamped at 1e-20;
- euclidean: sum((a-b)^2) / (2*num);
- hinge L1/L2: sum(max(0, 1 +/- score)) / num (squared for L2);
- infogain: -sum H[label, j] log(p_j) / num;
- sigmoid cross-entropy: -sum[x t - log(1 + e^x)] / num, overflow-stable;
- contrastive: (y d^2 + (1-y) max(margin - d^2, 0)) / (2*num), the old
  Caffe form on the squared distance;
- accuracy: top-k hit rate, a metric (computed without gradient);
- argmax: the top_k indices (and values), ties to the lower index.

Top-k here breaks ties toward the lower index, as ``lax.top_k`` does
(``torch.topk`` promises no order among equal values).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..numeric import memory_format
from .elementwise import max0

_LOG_FLT_MIN = math.log(float(np.finfo(np.float32).tiny))


def softmax(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Softmax over ``axis``; a channels-last 4-D x over its channels is
    taken on the NHWC view, so the result stays channels-last (torch's
    softmax would gather the NCHW order first)."""
    if axis == 1 and memory_format(x) == torch.channels_last:
        return torch.softmax(x.permute(0, 2, 3, 1), dim=-1).permute(
            0, 3, 1, 2)
    return torch.softmax(x, dim=axis)


def softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (N, C, H, W) or (N, C); labels with N*H*W integer values."""
    if logits.dim() == 2:
        logits = logits[:, :, None, None]
    n, h, w = logits.shape[0], logits.shape[2], logits.shape[3]
    labels = labels.reshape(n, h, w).long()
    logp = torch.log_softmax(logits, dim=1)
    picked = torch.gather(logp, 1, labels[:, None])[:, 0]
    picked = torch.clamp_min(picked, _LOG_FLT_MIN)
    return -picked.sum() / (n * h * w)


def ordered_top_k(s: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of the 2-D
    ``s``, largest first, equal values in index order (``lax.top_k``'s
    order: a stable descending sort)."""
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def accuracy(scores: torch.Tensor, labels: torch.Tensor,
             top_k: int = 1) -> torch.Tensor:
    n = scores.shape[0]
    with torch.no_grad():
        s = scores.reshape(n, -1)
        labels = labels.reshape(n).long()
        if top_k == 1:
            hit = s.argmax(dim=1) == labels
        else:
            idx = ordered_top_k(s, top_k)[1]
            hit = (idx == labels[:, None]).any(dim=1)
        return hit.float().mean()


def multinomial_logistic_loss(probs: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    n = probs.shape[0]
    labels = labels.reshape(n).long()
    picked = torch.gather(probs.reshape(n, -1), 1, labels[:, None])[:, 0]
    return -torch.mean(torch.log(torch.clamp_min(picked, 1e-20)))


def euclidean_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sum(d * d) / (2.0 * a.shape[0])


def hinge_loss(scores: torch.Tensor, labels: torch.Tensor,
               norm: str = "L1") -> torch.Tensor:
    n = scores.shape[0]
    s = scores.reshape(n, -1)
    labels = labels.reshape(n).long()
    sign = torch.ones_like(s)
    sign[torch.arange(n, device=s.device), labels] = -1.0
    margins = max0(1.0 + sign * s)
    if norm == "L1":
        return torch.sum(margins) / n
    if norm == "L2":
        return torch.sum(margins * margins) / n
    raise ValueError(f"unknown hinge norm {norm!r}")


def infogain_loss(probs: torch.Tensor, labels: torch.Tensor,
                  H: torch.Tensor) -> torch.Tensor:
    n = probs.shape[0]
    p = probs.reshape(n, -1)
    labels = labels.reshape(n).long()
    logp = torch.log(torch.clamp_min(p, 1e-20))
    return -torch.sum(H[labels] * logp) / n


def sigmoid_cross_entropy_loss(logits: torch.Tensor,
                               targets: torch.Tensor) -> torch.Tensor:
    n = logits.shape[0]
    x = logits.reshape(n, -1)
    t = targets.reshape(n, -1)
    loss = max0(x) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.sum(loss) / n


def contrastive_loss(a: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
                     margin: float) -> torch.Tensor:
    n = a.shape[0]
    d = (a - b).reshape(n, -1)
    dist_sq = torch.sum(d * d, dim=1)
    per = torch.where(y.reshape(n) > 0, dist_sq, max0(margin - dist_sq))
    return torch.sum(per) / (2.0 * n)


def argmax(scores: torch.Tensor, top_k: int = 1,
           out_max_val: bool = False) -> torch.Tensor:
    """(N, 1, top_k, 1) indices as floats, or with ``out_max_val`` (N, 2,
    top_k, 1): channel 0 the indices, channel 1 the values
    (argmax_layer.cpp)."""
    n = scores.shape[0]
    vals, idx = ordered_top_k(scores.reshape(n, -1), top_k)
    idx = idx.to(scores.dtype)
    if out_max_val:
        return torch.stack([idx, vals], dim=1)[:, :, :, None]
    return idx[:, None, :, None]
