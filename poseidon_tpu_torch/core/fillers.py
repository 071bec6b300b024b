"""Parameter initialization with Caffe's filler semantics, drawn from an
explicit ``torch.Generator`` (the port of ``poseidon_tpu/core/fillers.py``).

Every filler of ``include/caffe/filler.hpp``: constant, uniform
(Uniform(min, max)), gaussian (with the optional sparse Bernoulli mask,
nonzero with probability min(1, sparse / shape[0])), positive_unitball
(Uniform(0, 1) rows normalized to sum 1) and xavier (Uniform(-s, s),
s = sqrt(3 / fan_in), fan_in = count / num). JAX and torch draw different
numbers from the same seed, so weights cross between the packages as
arrays, never as seeds; the fillers agree in shape, support and law.
"""

from __future__ import annotations

import torch

from .blob import ParamDef


def fill(gen: torch.Generator, pdef: ParamDef,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A tensor of ``pdef.shape`` drawn from ``gen``, on the generator's
    device (a CPU generator for parameters, so a seed gives the same
    weights whatever device serves them)."""
    f = pdef.filler
    shape = pdef.shape
    dev = gen.device
    if f.type == "constant":
        return torch.full(shape, f.value, dtype=dtype, device=dev)
    if f.type == "uniform":
        u = torch.rand(shape, generator=gen, dtype=dtype, device=dev)
        return f.min + (f.max - f.min) * u
    if f.type == "gaussian":
        x = f.mean + f.std * torch.randn(shape, generator=gen, dtype=dtype,
                                         device=dev)
        if f.sparse >= 0:
            prob = min(1.0, f.sparse / max(1, shape[0]))
            keep = torch.rand(shape, generator=gen, device=dev) < prob
            x = torch.where(keep, x, torch.zeros((), dtype=dtype,
                                                 device=dev))
        return x
    if f.type == "positive_unitball":
        u = torch.rand(shape, generator=gen, dtype=dtype, device=dev)
        flat = u.reshape(shape[0], -1)
        return (flat / flat.sum(dim=1, keepdim=True)).reshape(shape)
    if f.type == "xavier":
        scale = (3.0 / pdef.fan_in) ** 0.5
        u = torch.rand(shape, generator=gen, dtype=dtype, device=dev)
        return u * (2.0 * scale) - scale
    raise ValueError(f"unknown filler type {f.type!r}")
