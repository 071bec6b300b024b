"""Cross-channel LRN: the hand-written CUDA kernel, its wrapper, and its
plain PyTorch version.

``lrn_across_channels`` is what the LRN layer calls. For a tensor on the
CPU it runs ``lrn_across_channels_plain``; for a CUDA tensor it launches
the kernel of ``csrc/lrn_fwd.cu`` (the port of the TPU kernel
``poseidon_tpu/ops/pallas_kernels.py:_lrn_kernel``) or raises — nothing
falls back. Each launch adds one to ``LAUNCHES["lrn_fwd"]``.

The plain version is the pad-and-add formulation of
``poseidon_tpu/ops/nn.py:_lrn_ac_raw``: the window pads ``pre=(n-1)//2``
channels before and ``n-1-pre`` after. It is deliberately NOT
``F.local_response_norm``, which pads ``n//2`` before and so disagrees with
Caffe at even ``n``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# launches of each kernel of this module, counted where the kernel launches
LAUNCHES = {"lrn_fwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lrn_across_channels_plain(x: torch.Tensor, local_size: int, alpha: float,
                              beta: float, k: float = 1.0) -> torch.Tensor:
    """ACROSS_CHANNELS LRN on (N, C, H, W): computed in f32, returned in
    x's dtype, window taps summed in ascending order."""
    pre = (local_size - 1) // 2
    post = local_size - pre - 1
    c = x.shape[1]
    xf = x.float()
    sq = F.pad(xf * xf, (0, 0, 0, 0, pre, post))
    windowed = torch.zeros_like(xf)
    for dc in range(local_size):
        windowed = windowed + sq[:, dc:dc + c]
    scale = k + (alpha / local_size) * windowed
    return (xf * scale.pow(-beta)).to(x.dtype)


def _lib():
    lib = _build.load("lrn_fwd")
    fn = lib.poseidon_lrn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def lrn_fwd_cuda(x: torch.Tensor, local_size: int, alpha: float, beta: float,
                 k: float = 1.0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if not x.is_cuda:
        raise ValueError("lrn_fwd_cuda needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"lrn_fwd_cuda takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"lrn_fwd_cuda takes (N, C, H, W), got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("lrn_fwd_cuda needs a contiguous NCHW tensor")
    if local_size < 1:
        raise ValueError(f"local_size must be positive, got {local_size}")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype], n, c,
                h * w, local_size, alpha / local_size, beta, k, stream)
    if rc != 0:
        raise RuntimeError(f"lrn_fwd kernel launch failed: cudaError {rc}")
    LAUNCHES["lrn_fwd"] += 1
    return y


def lrn_across_channels(x: torch.Tensor, local_size: int, alpha: float,
                        beta: float, k: float = 1.0) -> torch.Tensor:
    """The LRN layer's entry: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return lrn_across_channels_plain(x, local_size, alpha, beta, k)
    return lrn_fwd_cuda(x, local_size, alpha, beta, k)
