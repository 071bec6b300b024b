"""Neuron and structural ops (the CNN subset of
``poseidon_tpu/ops/elementwise.py``): ReLU, dropout, flatten, concat."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope == 0.0:
        return torch.clamp_min(x, 0)
    return torch.where(x > 0, x, negative_slope * x)


def dropout(x: torch.Tensor, ratio: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout, as the JAX package computes it: at TRAIN time each
    unit is kept with probability 1-ratio (a mask drawn from ``generator``,
    on x's device) and scaled by 1/(1-ratio); TEST is the identity. The
    mask's random stream is torch's, not JAX's. The mask is drawn as a
    contiguous tensor of x's logical shape, so a channels-last x drops the
    same units as an NCHW one (the draw never follows the memory
    layout)."""
    if not train or ratio == 0.0:
        return x
    keep = 1.0 - ratio
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def concat(xs: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    return torch.cat(list(xs), dim=axis)
