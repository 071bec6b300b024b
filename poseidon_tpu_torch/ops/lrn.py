"""Cross-channel LRN: the hand-written CUDA kernels (forward and backward),
their wrappers, their plain PyTorch versions, and the autograd Function.

``lrn_across_channels`` is what the LRN layer calls: the autograd Function
``LRNAcrossChannels``, whose forward saves x and whose backward computes
Caffe's analytic gradient. For a tensor on the CPU both directions run the
plain versions; for a CUDA tensor they launch the kernels of
``csrc/lrn_fwd.cu`` and ``csrc/lrn_bwd.cu`` (ports of the TPU kernels
``poseidon_tpu/ops/pallas_kernels.py:_lrn_kernel`` and ``_lrn_bwd_kernel``)
or raise — nothing falls back. Each launch adds one to
``LAUNCHES["lrn_fwd"]`` or ``LAUNCHES["lrn_bwd"]``.

The plain forward is the pad-and-add formulation of
``poseidon_tpu/ops/nn.py:_lrn_ac_raw``: the window pads ``pre=(n-1)//2``
channels before and ``n-1-pre`` after. It is deliberately NOT
``F.local_response_norm``, which pads ``n//2`` before and so disagrees with
Caffe at even ``n``. The plain backward is ``_lrn_ac_bwd`` of the same
module (the analytic formula, not autograd through the forward); its window
is the forward's mirrored, padded (post, pre).

``lrn_across_channels_reference`` runs the plain versions of both
directions on any device: chip_smoke.py swaps it into the LRN layers to
hold a whole training step against the kernels on the card.

The kernels compute each element with explicitly rounded multiplies and
adds, the window taps in ascending order from zero and the same ``powf``
calls as the plain versions, so they are bitwise equal to them on the card.
The forward (K4) walks C serially in one thread per (n, h*w) position. The
backward (K5) is channel-parallel: a block stages a chunk of channels with
its halo times 32 consecutive h*w positions in shared memory, computes each
element's s and r once there, and forms dx from the r window; the halo of
``local_size - 1`` channels on each side grows its shared memory with the
window.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# launches of each kernel of this module, counted where the kernel launches
LAUNCHES = {"lrn_fwd": 0, "lrn_bwd": 0}
# the backward kernel's shared-memory halo grows with the window: capped
# here and in csrc/lrn_bwd.cu (MAX_LRN_SIZE)
MAX_CUDA_LOCAL_SIZE = 32

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _window_sum(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Channel-window sum of (N, C, H, W): pad (before, after) channels with
    zeros and add the before+after+1 shifted slices in ascending order."""
    c = t.shape[1]
    tp = F.pad(t, (0, 0, 0, 0, before, after))
    out = torch.zeros_like(t)
    for dc in range(before + after + 1):
        out = out + tp[:, dc:dc + c]
    return out


def _compute(t: torch.Tensor) -> torch.Tensor:
    """The compute dtype of the plain versions: f32, or f64 for f64 input
    (what ``gradcheck`` feeds)."""
    return t if t.dtype == torch.float64 else t.float()


def lrn_across_channels_plain(x: torch.Tensor, local_size: int, alpha: float,
                              beta: float, k: float = 1.0) -> torch.Tensor:
    """ACROSS_CHANNELS LRN on (N, C, H, W): computed in f32, returned in
    x's dtype, window taps summed in ascending order."""
    pre = (local_size - 1) // 2
    post = local_size - pre - 1
    xf = _compute(x)
    scale = k + (alpha / local_size) * _window_sum(xf * xf, pre, post)
    return (xf * scale.pow(-beta)).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor, local_size: int,
                  alpha: float, beta: float, k: float = 1.0) -> torch.Tensor:
    """dx of ACROSS_CHANNELS LRN from (x, g): Caffe's analytic gradient,
    computed in f32 with s recomputed from x, returned in x's dtype."""
    pre = (local_size - 1) // 2
    post = local_size - pre - 1
    xf = _compute(x)
    gf = _compute(g)
    scale = k + (alpha / local_size) * _window_sum(xf * xf, pre, post)
    r = gf * xf * scale.pow(-beta - 1.0)
    rsum = _window_sum(r, post, pre)
    dx = gf * scale.pow(-beta) - (2.0 * alpha * beta / local_size) * xf * rsum
    return dx.to(x.dtype)


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name} needs a CUDA tensor")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} takes float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} takes (N, C, H, W), got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous NCHW tensor")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             f"device")


def _lib(name: str, args):
    fn = getattr(_build.load(name), f"poseidon_{name}")
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return fn


def lrn_fwd_cuda(x: torch.Tensor, local_size: int, alpha: float, beta: float,
                 k: float = 1.0) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream."""
    _check_cuda("lrn_fwd_cuda", x)
    if local_size < 1:
        raise ValueError(f"local_size must be positive, got {local_size}")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _lib("lrn_fwd", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype], n, c,
                h * w, local_size, alpha / local_size, beta, k, stream)
    if rc != 0:
        raise RuntimeError(f"lrn_fwd kernel launch failed: cudaError {rc}")
    LAUNCHES["lrn_fwd"] += 1
    return y


def lrn_bwd_cuda(x: torch.Tensor, g: torch.Tensor, local_size: int,
                 alpha: float, beta: float, k: float = 1.0) -> torch.Tensor:
    """Launch the backward kernel on PyTorch's current stream."""
    _check_cuda("lrn_bwd_cuda", x, g)
    if not 1 <= local_size <= MAX_CUDA_LOCAL_SIZE:
        raise ValueError(f"lrn_bwd_cuda takes local_size in [1, "
                         f"{MAX_CUDA_LOCAL_SIZE}], got {local_size}")
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    fn = _lib("lrn_bwd", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_float, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                _DTYPE_CODE[x.dtype], n, c, h * w, local_size,
                alpha / local_size, -beta, -beta - 1.0,
                2.0 * alpha * beta / local_size, k, stream)
    if rc != 0:
        raise RuntimeError(f"lrn_bwd kernel launch failed: cudaError {rc}")
    LAUNCHES["lrn_bwd"] += 1
    return dx


class LRNAcrossChannels(torch.autograd.Function):
    """ACROSS_CHANNELS LRN with Caffe's analytic backward. ``plain`` runs the
    plain versions whatever the device; otherwise a CPU tensor takes the
    plain versions and a CUDA tensor the kernels."""

    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, k, plain):
        ctx.save_for_backward(x)
        ctx.args = (local_size, alpha, beta, k)
        ctx.plain = plain or x.device.type == "cpu"
        if ctx.plain:
            return lrn_across_channels_plain(x, local_size, alpha, beta, k)
        return lrn_fwd_cuda(x.contiguous(), local_size, alpha, beta, k)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if ctx.plain:
            dx = lrn_bwd_plain(x, g, *ctx.args)
        else:
            dx = lrn_bwd_cuda(x.contiguous(), g.contiguous(), *ctx.args)
        return dx, None, None, None, None, None


def lrn_across_channels(x: torch.Tensor, local_size: int, alpha: float,
                        beta: float, k: float = 1.0) -> torch.Tensor:
    """The LRN layer's entry: the plain versions for a CPU tensor, the CUDA
    kernels for a CUDA tensor, in both directions."""
    return LRNAcrossChannels.apply(x, local_size, alpha, beta, k, False)


def lrn_across_channels_reference(x: torch.Tensor, local_size: int,
                                  alpha: float, beta: float,
                                  k: float = 1.0) -> torch.Tensor:
    """The plain versions of both directions, on any device."""
    return LRNAcrossChannels.apply(x, local_size, alpha, beta, k, True)
