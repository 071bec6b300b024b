"""Neuron and structural ops (the port of
``poseidon_tpu/ops/elementwise.py``): ReLU, sigmoid, tanh, BNLL, absval,
power, threshold, dropout, flatten, concat, slice, eltwise and MVN.

The JAX package leaves these to XLA, so the port leaves them to PyTorch's
own operators. Logical shapes are NCHW in either memory format, so an op
that names an axis takes the NCHW axis whatever the layout (JAX remaps
the axis under its NHWC plan). Where JAX takes ``jnp.maximum``, the port
takes ``torch.maximum``: both split the cotangent evenly at a tie, which
``clamp`` does not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: the cotangent halved where x is exactly 0."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def bnll(x: torch.Tensor) -> torch.Tensor:
    """x > 0 ? x + log(1 + exp(-x)) : log(1 + exp(x)) (bnll_layer.cpp), in
    JAX's overflow-free form."""
    return (torch.where(x > 0, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
            + torch.log1p(torch.exp(-torch.abs(x))))


def absval(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x)


def power(x: torch.Tensor, power_: float, scale: float,
          shift: float) -> torch.Tensor:
    """(shift + scale * x) ** power."""
    base = shift + scale * x
    if power_ == 1.0:
        return base
    return base.pow(power_)


def threshold(x: torch.Tensor, t: float) -> torch.Tensor:
    """1 where x > t, else 0 (no gradient)."""
    return (x > t).to(x.dtype)


def slice_blob(x: torch.Tensor, axis: int, slice_points: Optional[List[int]],
               num_out: int) -> List[torch.Tensor]:
    """Split ``axis`` at ``slice_points``, or into ``num_out`` equal
    parts."""
    size = x.shape[axis]
    if slice_points:
        bounds = [0] + list(slice_points) + [size]
    else:
        if size % num_out != 0:
            raise ValueError(f"slice: {size} not divisible into {num_out}")
        step = size // num_out
        bounds = [i * step for i in range(num_out + 1)]
    return [x.narrow(axis, bounds[i], bounds[i + 1] - bounds[i])
            for i in range(len(bounds) - 1)]


def eltwise(xs: Sequence[torch.Tensor], operation: str,
            coeffs: Sequence[float]) -> torch.Tensor:
    """PROD, SUM (with per-bottom coefficients) or MAX over the bottoms,
    folded left to right as JAX folds them."""
    if operation == "PROD":
        y = xs[0]
        for x in xs[1:]:
            y = y * x
        return y
    if operation == "SUM":
        if not coeffs:
            coeffs = [1.0] * len(xs)
        y = None
        for c, x in zip(coeffs, xs):
            term = x if c == 1.0 else c * x
            y = term if y is None else y + term
        return y
    if operation == "MAX":
        y = xs[0]
        for x in xs[1:]:
            y = torch.maximum(y, x)
        return y
    raise ValueError(f"unknown eltwise op {operation!r}")


def mvn(x: torch.Tensor, normalize_variance: bool, across_channels: bool,
        eps: float = 1e-10) -> torch.Tensor:
    """mvn_layer.cpp: per sample, subtract the mean over (C, H, W) if
    ``across_channels`` else over (H, W); with ``normalize_variance``
    divide by sqrt(max(var, 0)) + eps (eps added to the root)."""
    axes = (1, 2, 3) if across_channels else (2, 3)
    mean = torch.mean(x, dim=axes, keepdim=True)
    centered = x - mean
    if not normalize_variance:
        return centered
    var = torch.mean(x * x, dim=axes, keepdim=True) - mean * mean
    return centered / (torch.sqrt(max0(var)) + eps)
