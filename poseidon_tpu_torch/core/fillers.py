"""Parameter initialization with Caffe's filler semantics, drawn from an
explicit ``torch.Generator`` (the port of ``poseidon_tpu/core/fillers.py``).

The serving slice carries the three fillers the model zoo's deploy nets use:
constant, gaussian and xavier (Uniform(-s, s), s = sqrt(3 / fan_in),
fan_in = count / num). JAX and torch draw different numbers from the same
seed, so weights cross between the packages as arrays, never as seeds.
"""

from __future__ import annotations

import torch

from .blob import ParamDef


def fill(gen: torch.Generator, pdef: ParamDef,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A CPU tensor of ``pdef.shape`` drawn from ``gen`` (a CPU generator,
    so a seed gives the same weights whatever device serves them)."""
    f = pdef.filler
    shape = pdef.shape
    if f.type == "constant":
        return torch.full(shape, f.value, dtype=dtype)
    if f.type == "gaussian":
        if f.sparse >= 0:
            raise NotImplementedError(
                "sparse gaussian filler: not in the serving slice")
        return f.mean + f.std * torch.randn(shape, generator=gen, dtype=dtype)
    if f.type == "xavier":
        scale = (3.0 / pdef.fan_in) ** 0.5
        u = torch.rand(shape, generator=gen, dtype=dtype)
        return u * (2.0 * scale) - scale
    raise NotImplementedError(f"filler type {f.type!r}: not in the serving "
                              f"slice (constant, gaussian, xavier)")
