"""Softmax, the softmax loss and accuracy (the CNN subset of
``poseidon_tpu/ops/losses.py``), with the reference's normalization:

- softmax_loss: -mean over (num * spatial) of log prob[label], log probs
  clamped at log(FLT_MIN) (softmax_loss_layer.cpp);
- accuracy: top-k hit rate, a metric (computed without gradient).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..numeric import memory_format

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


def accuracy(scores: torch.Tensor, labels: torch.Tensor,
             top_k: int = 1) -> torch.Tensor:
    n = scores.shape[0]
    with torch.no_grad():
        s = scores.reshape(n, -1)
        labels = labels.reshape(n).long()
        if top_k == 1:
            hit = s.argmax(dim=1) == labels
        else:
            idx = torch.topk(s, top_k, dim=1).indices
            hit = (idx == labels[:, None]).any(dim=1)
        return hit.float().mean()
