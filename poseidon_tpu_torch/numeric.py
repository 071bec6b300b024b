"""Numeric policy and device resolution for the PyTorch port.

The JAX package's float32 policy (``poseidon_tpu/numeric.py``) forces
``Precision.HIGHEST`` on every f32 matmul and conv, for Caffe-parity
numerics. The CUDA counterpart is to switch TF32 off: cuDNN runs float32
convolutions in TF32 by default, which keeps about three decimal digits,
and the matmul flag is set too so the policy never depends on PyTorch's
defaults. The port keeps only this f32 policy; the bf16 perf policy is
later work. ``Net.__init__`` applies it, so every entry point that builds a
net runs under it.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
GPU they raise instead of silently running there.
"""

from __future__ import annotations

import torch


def apply_f32_policy() -> None:
    """Full-precision float32 convolutions and matmuls on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU (and raises when there is none); ``"cpu"``
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "poseidon_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev
