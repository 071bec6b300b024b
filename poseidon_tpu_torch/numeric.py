"""Numeric policy and device resolution for the PyTorch port (the port of
``poseidon_tpu/numeric.py``).

Parameters and optimizer state stay float32 (``param_dtype``). Matmul and
conv inputs are cast to ``compute_dtype`` (float32 by default, bfloat16
under the perf policy) and produce compute-dtype activations; reductions
that must not lose precision (softmax statistics, the SFB weight product)
accumulate in ``accum_dtype``, float32. Under float32 compute the policy
is Caffe-parity numerics, the JAX package's ``Precision.HIGHEST``: TF32 is
switched off for convolutions (cuDNN's default would run them in TF32,
about three decimal digits) and matmuls, so the policy never depends on
PyTorch's defaults. Under bfloat16 compute the f32 products that remain
may use TF32, JAX's ``Precision.DEFAULT``. ``apply_policy`` sets those
flags from the active policy; ``Net.__init__``, the LM train step and the
LM executor call it, so every entry point that builds a model runs under
it.

``conv_layout`` is the CNN graph's activation layout, planned by
``core/net.py`` at construction: "NCHW", "NHWC" (``torch.channels_last``
activations) or "AUTO", resolved per device by ``resolve_conv_layout``.
``conv_s2d`` turns on the space-to-depth stem rewrite
(``ops/nn.py:_space_to_depth_rewrite``); ``conv_strategy`` picks the conv
lowering: "" leaves it to ``conv_s2d``, "direct", "im2col" or "s2d" force
one net-wide, and "auto" measures a winner per conv layer when the net is
built (``ops/conv_tune.py``).

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
GPU they raise instead of silently running there.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32  # bfloat16 in perf configs
    accum_dtype: torch.dtype = torch.float32
    # the CNN graph's activation layout, resolved at Net construction;
    # params, gradients and snapshots stay canonical OIHW/NCHW either way
    conv_layout: str = "NCHW"
    # the space-to-depth stem rewrite: few-channel strided convs (AlexNet's
    # and GoogLeNet's conv1) as an exact stride-1 conv over s*s times the
    # channels; off by default so golden-value tests see the direct conv
    conv_s2d: bool = False
    # the conv lowering: "" (conv_s2d decides), "direct", "im2col", "s2d"
    # net-wide, or "auto" (measured per layer, ops/conv_tune.py)
    conv_strategy: str = ""


# --bf16 accuracy guardrail (the JAX package's values): after
# BF16_SMOKE_ITERS LeNet steps on identical data, the mean of the last 5
# bf16 losses must sit within BF16_SMOKE_RTOL (relative) + BF16_SMOKE_ATOL
# (absolute) of the f32 run's (tests/test_torch_bf16.py).
BF16_SMOKE_ITERS = 30
BF16_SMOKE_RTOL = 0.10
BF16_SMOKE_ATOL = 0.05

# the per-layer conv lowering axis (the JAX package's): "" = the policy's
# conv_s2d decides; "auto" is resolved to a measured winner per layer at
# Net construction (ops/conv_tune.py) and never reaches ops/nn.conv2d
CONV_STRATEGIES = ("", "auto", "direct", "im2col", "s2d")


def check_conv_strategy(strategy: str) -> str:
    strategy = strategy or ""
    if strategy not in CONV_STRATEGIES:
        raise ValueError(f"unknown conv_strategy {strategy!r}; choose from "
                         f"{CONV_STRATEGIES}")
    return strategy


def resolve_conv_layout(layout: str, backend: str = "cpu",
                        consult_plan: bool = True) -> str:
    """Resolve a conv_layout choice ("NCHW" | "NHWC" | "auto", any case)
    against the backend that runs the net ("cuda" or JAX's "gpu", "cpu").
    Explicit values pass through. "auto" first reads the active tuned
    plan (``runtime/tuned_plan.active_plan_value``): a measured
    conv_layout row loaded for this run is the answer. Without one (or
    with ``consult_plan=False``, how the tune search builds its default
    arm) it takes the JAX package's built-in table: NHWC on a GPU (the
    tensor cores' native conv layout: cuDNN runs an NCHW float32 conv
    between transposes), NCHW elsewhere."""
    lay = (layout or "NCHW").upper()
    if lay != "AUTO":
        if lay not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown conv_layout {layout!r}")
        return lay
    if consult_plan:
        from .runtime.tuned_plan import active_plan_value
        measured = active_plan_value("conv_layout")
        if measured:
            return str(measured).upper()
    return "NHWC" if backend in ("cuda", "gpu") else "NCHW"


_policy = Policy()


def policy() -> Policy:
    return _policy


def set_policy(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_policy, k):
            raise AttributeError(k)
        if k == "conv_strategy":
            v = check_conv_strategy(v)
        setattr(_policy, k, v)


def set_perf_policy(**overrides) -> None:
    """THE bf16 perf config (``train --bf16`` routes here): bfloat16
    compute plus the space-to-depth stem rewrite. Parameters, optimizer
    state and softmax statistics stay f32; only matmul/conv inputs and
    activations drop to bfloat16. Its accuracy guardrail is the
    BF16_SMOKE_* band."""
    cfg = dict(compute_dtype=torch.bfloat16, conv_s2d=True)
    cfg.update(overrides)
    set_policy(**cfg)


@contextmanager
def policy_scope(**kwargs):
    saved = {k: getattr(_policy, k) for k in kwargs}
    set_policy(**kwargs)
    try:
        yield
    finally:
        set_policy(**saved)


def apply_policy() -> None:
    """The active policy's TF32 flags: off under float32 compute (full
    precision, JAX's ``Precision.HIGHEST``), on under bfloat16 compute for
    the f32 products that remain (``Precision.DEFAULT``)."""
    fast = _policy.compute_dtype != torch.float32
    torch.backends.cudnn.allow_tf32 = fast
    torch.backends.cuda.matmul.allow_tf32 = fast


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """The activation layout of a tensor: ``torch.channels_last`` for a 4-D
    tensor laid out NHWC and not also NCHW-contiguous (one channel or one
    position is both, and counts as NCHW), else
    ``torch.contiguous_format``."""
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU (and raises when there is none); ``"cpu"``
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "poseidon_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev
