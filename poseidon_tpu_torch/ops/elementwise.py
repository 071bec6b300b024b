"""Neuron and structural ops (the serving subset of
``poseidon_tpu/ops/elementwise.py``): ReLU, dropout, flatten, concat."""

from __future__ import annotations

from typing import Sequence

import torch


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope == 0.0:
        return torch.clamp_min(x, 0)
    return torch.where(x > 0, x, negative_slope * x)


def dropout(x: torch.Tensor, ratio: float, train: bool) -> torch.Tensor:
    """Inverted dropout, as the JAX package computes it: kept units are
    scaled by 1/(1-ratio) at TRAIN time, so TEST is the identity."""
    if not train or ratio == 0.0:
        return x
    raise NotImplementedError("TRAIN-phase dropout belongs to the training "
                              "slice; the serving slice runs TEST nets")


def flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def concat(xs: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    return torch.cat(list(xs), dim=axis)
