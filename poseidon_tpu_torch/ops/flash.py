"""Flash-attention forward: the hand-written CUDA kernel, its wrapper, its
plain PyTorch version, the autograd Function and the routing rule.

``flash_attention_fwd(q, k, v, causal, scale, mode)`` returns ``(out, lse)``
over (B, H, S, D) tensors: what ``poseidon_tpu/ops/pallas_kernels.py
:_flash_fwd`` computes (out in q's dtype, the per-row logsumexp in f32,
the finite ``NEG_INF`` causal mask, ``mode`` +1/0/-1 for ring chunks). For
a tensor on the CPU it runs ``flash_attention_fwd_plain``; for a CUDA
tensor it launches ``csrc/flash_fwd.cu`` (the port of the TPU kernel
``_flash_fwd_kernel``) or raises: nothing falls back. Each launch adds one
to ``LAUNCHES["flash_fwd"]``.

The plain version is the dense formulation: scores ``(q k^T) * scale`` in
f32, masked entries set to ``NEG_INF = -1e30`` (not -inf, so a fully masked
row in ``mode = -1`` weighs every key equally and gives the kernel's out,
the mean of V, and lse ``-1e30 + log S``), ``m`` the row max, ``p =
exp(s - m)``, ``l`` its sum (1 where it is 0), ``out = (p @ v) / l``, ``lse
= m + log l``.

``flash_attention`` is the autograd Function the models call; its backward
(the TPU kernels ``_flash_dq_kernel`` and ``_flash_dkv_kernel``) is ported
with the LM-training slice and raises until then. ``maybe_flash_attention``
keeps the JAX routing rule: the kernel when q and k have the same length
and ``pick_block(S)`` finds a tile, else the dense ``attention``. The
kernel itself takes any S; the rule decides only which lengths it sees.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, attention

# launches of this module's kernel, counted where the kernel launches
LAUNCHES = {"flash_fwd": 0}
# the kernel keeps a row's output columns in registers (csrc/flash_fwd.cu)
MAX_CUDA_HEAD_DIM = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pick_block(s: int) -> Optional[int]:
    """The JAX package's tile height for a sequence length (128/64/32/16/8,
    the largest that divides it), or None: the routing rule of
    ``maybe_flash_attention``."""
    return next((bs for bs in (128, 64, 32, 16, 8) if s % bs == 0), None)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None, mode=None):
    """(out, lse) of the flash forward, dense, computed in f32; out in q's
    dtype, lse (B, H, S) f32."""
    scale = _scale(q, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        idx = torch.arange(n, device=s.device)
        lower = idx[:, None] >= idx[None, :]
        if mode is None:
            live = lower
        else:
            mode = int(mode)
            live = lower if mode == 0 else torch.full_like(lower, mode > 0)
        s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    lsafe = torch.where(l == 0, 1.0, l)
    out = torch.matmul(p, v.float()) / lsafe[..., None]
    return out.to(q.dtype), m + torch.log(lsafe)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError("flash_fwd_cuda needs CUDA tensors")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_fwd_cuda takes float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd_cuda takes (B, H, S, D), got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("flash_fwd_cuda needs contiguous tensors")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_fwd_cuda: q, k and v differ in shape, "
                             "dtype or device")
    b, h, s, d = q.shape
    if not 1 <= d <= MAX_CUDA_HEAD_DIM:
        raise ValueError(f"flash_fwd_cuda takes head dim 1..."
                         f"{MAX_CUDA_HEAD_DIM}, got {d}")
    if not 1 <= b * h <= 65535 or s < 1:
        raise ValueError(f"flash_fwd_cuda takes 1..65535 (batch x heads) "
                         f"and S >= 1, got {tuple(q.shape)}")


def _lib():
    fn = _build.load("flash_fwd").poseidon_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mode=None):
    """Launch the kernel on PyTorch's current stream; (out, lse)."""
    _check_cuda(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    chunk = mode is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), _DTYPE_CODE[q.dtype], b * h, s, d,
                    _scale(q, scale), int(bool(causal)), int(chunk),
                    int(mode) if chunk else 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        mode=None):
    """(out, lse): the plain version for CPU tensors, the kernel for CUDA
    tensors (made contiguous first)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale, mode)
    return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal, scale, mode)


class FlashAttention(torch.autograd.Function):
    """Flash attention's forward; the backward kernels (K2 dQ, K3 dK/dV)
    come with the LM-training slice."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mode):
        out, _ = flash_attention_fwd(q, k, v, causal, scale, mode)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash attention backward (the dQ and dK/dV kernels of "
            "poseidon_tpu/ops/pallas_kernels.py:_flash_bwd) is ported with "
            "the LM-training slice (ROADMAP, queue B); the LM path of this "
            "port serves only")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    mode=None) -> torch.Tensor:
    """Blockwise attention, (B, H, S, D) -> (B, H, S, D)."""
    return FlashAttention.apply(q, k, v, causal, scale, mode)


def maybe_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The flash path when q and k have the same length and ``pick_block``
    tiles it, else the dense ``attention`` (the JAX routing rule)."""
    s = q.shape[-2]
    if k.shape[-2] == s and pick_block(s) is not None:
        return flash_attention(q, k, v, causal, scale)
    return attention(q, k, v, causal=causal, scale=scale)
