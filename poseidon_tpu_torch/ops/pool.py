"""Caffe pooling (MAX and AVE, NCHW): the forward, the hand-written CUDA
backward kernel, its wrapper, its plain PyTorch version, and the autograd
Functions the POOLING layer calls.

What must stay Caffe-exact, here as in ``poseidon_tpu/ops/nn.py``:

- output size: ceil((in + 2*pad - k)/stride) + 1, minus one if the last
  window would start in the padding (``pool_out_size``);
- pooling runs over the Caffe-padded input cropped to exactly the extent
  the output grid consumes (``_pool_pad_crop``), so no builtin ceil-mode
  rule decides a window;
- AVE divides by the window clipped to the *padded* extent (``_ave_denom``).

The forward is a library call over that padded crop (``F.max_pool2d`` /
``F.avg_pool2d``): the JAX package's forward is ``lax.reduce_window``, not a
Pallas kernel. The backward is the port of the TPU kernel
``poseidon_tpu/ops/pallas_kernels.py:_pool_bwd_kernel``: for a CUDA tensor
``pool_bwd_cuda`` launches ``csrc/pool_bwd.cu`` (adding one to
``LAUNCHES["pool_bwd"]``) or raises; for a CPU tensor ``pool_bwd_plain``
runs the taps formulation of ``ops/nn.py:_pool_bwd`` (``_pool_max_args``,
``_pool_scatter_taps``, ``_pool_unpad``). Torch's own pooling backward is
never used.

``max_pool_reference`` / ``ave_pool_reference`` run the plain backward on
any device: chip_smoke.py swaps them into the POOLING layers to hold a
whole training step against the kernel on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# launches of this module's kernel, counted where the kernel launches
LAUNCHES = {"pool_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pool_out_size(in_size: int, kernel: int, stride: int, pad: int) -> int:
    out = int(math.ceil((in_size + 2 * pad - kernel) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= in_size + pad:
        out -= 1
    return out


def _pool_dims(x, kernel, stride, pad) -> Tuple[int, int, int, int]:
    h, w = x.shape[2], x.shape[3]
    return h, w, pool_out_size(h, kernel[0], stride[0], pad[0]), \
        pool_out_size(w, kernel[1], stride[1], pad[1])


def _pool_pad_crop(x, kernel, stride, pad, oh, ow, fill: float):
    """The Caffe-padded input, cropped to exactly the extent the oh x ow
    output grid consumes ((o-1)*s + k per spatial dim)."""
    h, w = x.shape[2], x.shape[3]
    hi_h = max((oh - 1) * stride[0] + kernel[0] - pad[0] - h, 0)
    hi_w = max((ow - 1) * stride[1] + kernel[1] - pad[1] - w, 0)
    xp = F.pad(x, (pad[1], hi_w, pad[0], hi_h), value=fill)
    return xp[:, :, :(oh - 1) * stride[0] + kernel[0],
              :(ow - 1) * stride[1] + kernel[1]]


def _ave_denom(h, w, oh, ow, kernel, stride, pad) -> np.ndarray:
    """Caffe's AVE divisor: the window clipped to the padded extent
    [start, in+pad), where start may be negative."""
    def divisors(n_out, stride_, pad_, kernel_, in_):
        starts = np.arange(n_out) * stride_ - pad_
        ends = np.minimum(starts + kernel_, in_ + pad_)
        return (ends - starts).astype(np.float32)

    return np.outer(divisors(oh, stride[0], pad[0], kernel[0], h),
                    divisors(ow, stride[1], pad[1], kernel[1], w))


def pool_forward(x: torch.Tensor, kernel, stride, pad,
                 method: str) -> torch.Tensor:
    """Caffe MAX ("max") or AVE ("ave") pooling of (N, C, H, W)."""
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    if method == "max":
        xp = _pool_pad_crop(x, kernel, stride, pad, oh, ow, -math.inf)
        return F.max_pool2d(xp, tuple(kernel), tuple(stride))
    xp = _pool_pad_crop(x, kernel, stride, pad, oh, ow, 0.0)
    summed = F.avg_pool2d(xp, tuple(kernel), tuple(stride),
                          divisor_override=1)
    denom = torch.from_numpy(_ave_denom(h, w, oh, ow, kernel, stride, pad))
    return summed / denom.to(device=x.device, dtype=x.dtype)


def pool_bwd_plain(x: torch.Tensor, g: torch.Tensor, kernel, stride, pad,
                   method: str) -> torch.Tensor:
    """dx of Caffe pooling from (x, g), the taps formulation: for MAX each
    window's first-max-wins argmax (strict ``>`` over row-major taps, pad
    = -inf, initial argmax flat index 0) recomputed from the padded input;
    for AVE the divisor-scaled cotangent. Contributions are added onto the
    padded plane tap by tap in row-major order, in f32, then the padding is
    cropped off; returned in x's dtype."""
    n, c = x.shape[0], x.shape[1]
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    ph = stride[0] * (oh - 1) + kernel[0]
    pw = stride[1] * (ow - 1) + kernel[1]
    # f32 (f64 for f64 input, what gradcheck feeds)
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    gf = g.to(cdt)
    rows = lambda d: slice(d, d + stride[0] * (oh - 1) + 1, stride[0])  # noqa: E731
    cols = lambda d: slice(d, d + stride[1] * (ow - 1) + 1, stride[1])  # noqa: E731
    ioh = torch.arange(oh, device=x.device).view(oh, 1)
    iow = torch.arange(ow, device=x.device).view(1, ow)

    def flat(dh, dw):
        return (ioh * stride[0] + dh) * pw + (iow * stride[1] + dw)

    if method == "ave":
        denom = torch.from_numpy(_ave_denom(h, w, oh, ow, kernel, stride,
                                            pad)).to(x.device)
        gf = gf / denom
    else:
        xp = _pool_pad_crop(x.to(cdt), kernel, stride, pad, oh, ow,
                            -math.inf)
        mx = torch.full_like(gf, -math.inf)
        arg = torch.zeros(gf.shape, dtype=torch.int64, device=x.device)
        for dh in range(kernel[0]):
            for dw in range(kernel[1]):
                v = xp[:, :, rows(dh), cols(dw)]
                better = v > mx
                mx = torch.where(better, v, mx)
                arg = torch.where(better, flat(dh, dw), arg)
    dxp = torch.zeros((n, c, ph, pw), dtype=cdt, device=x.device)
    for dh in range(kernel[0]):
        for dw in range(kernel[1]):
            contrib = gf if method == "ave" else torch.where(
                arg == flat(dh, dw), gf, 0.0)
            dxp[:, :, rows(dh), cols(dw)] += contrib
    # un-pad: drop the pad rows/cols, zero-fill any input extent the
    # ceil-mode crop never consumed
    dxp = F.pad(dxp, (0, max(pad[1] + w - pw, 0), 0, max(pad[0] + h - ph, 0)))
    return dxp[:, :, pad[0]:pad[0] + h, pad[1]:pad[1] + w].to(x.dtype)


def _lib():
    fn = _build.load("pool_bwd").poseidon_pool_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pool_bwd_cuda(x: torch.Tensor, g: torch.Tensor, kernel, stride, pad,
                  method: str) -> torch.Tensor:
    """Launch the backward kernel on PyTorch's current stream (for MAX an
    argmax pass into an int32 scratch, then the gather pass: one launch of
    the kernel, as counted). For "ave" x is read for its shape, dtype and
    device only (an expanded tensor will do)."""
    if method not in ("max", "ave"):
        raise ValueError(f"pool_bwd_cuda: method must be 'max' or 'ave', "
                         f"got {method!r}")
    for t in (x, g) if method == "max" else (g,):
        if not t.is_cuda:
            raise ValueError("pool_bwd_cuda needs CUDA tensors")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"pool_bwd_cuda takes float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError("pool_bwd_cuda takes contiguous (N, C, H, W) "
                             "tensors")
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError("pool_bwd_cuda: x and g differ in dtype or device")
    n, c = x.shape[0], x.shape[1]
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    if tuple(g.shape) != (n, c, oh, ow):
        raise ValueError(f"pool_bwd_cuda: g has shape {tuple(g.shape)}, "
                         f"the pooling gives {(n, c, oh, ow)}")
    if min(*kernel, *stride) < 1 or min(pad) < 0:
        raise ValueError(f"pool_bwd_cuda: bad window {kernel}/{stride}/{pad}")
    if h * w >= 2 ** 31:
        raise ValueError("pool_bwd_cuda: a plane must hold < 2^31 elements")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dx
    # the argmax pass's scratch: one int32 flat padded index per window
    arg = (torch.empty(g.shape, dtype=torch.int32, device=x.device)
           if method == "max" else None)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr() if method == "max" else None, g.data_ptr(),
                dx.data_ptr(), arg.data_ptr() if method == "max" else None,
                _DTYPE_CODE[x.dtype], int(method == "max"), n * c, h, w, oh,
                ow, kernel[0], kernel[1], stride[0], stride[1], pad[0],
                pad[1], stream)
    if rc != 0:
        raise RuntimeError(f"pool_bwd kernel launch failed: cudaError {rc}")
    LAUNCHES["pool_bwd"] += 1
    return dx


class Pool2d(torch.autograd.Function):
    """Caffe pooling whose backward is the kernel on a CUDA tensor and the
    plain version on a CPU tensor (or anywhere, with ``plain``)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad, method, plain):
        ctx.geom = (tuple(kernel), tuple(stride), tuple(pad), method)
        ctx.plain = plain or x.device.type == "cpu"
        if method == "max":
            ctx.save_for_backward(x)
        else:
            # the AVE backward reads only x's shape: keep no activation
            ctx.like = torch.empty((), dtype=x.dtype, device=x.device)
            ctx.x_shape = x.shape
        return pool_forward(x, kernel, stride, pad, method)

    @staticmethod
    def backward(ctx, g):
        kernel, stride, pad, method = ctx.geom
        if method == "max":
            (x,) = ctx.saved_tensors
        else:
            x = ctx.like.expand(ctx.x_shape)
        if ctx.plain:
            dx = pool_bwd_plain(x, g, kernel, stride, pad, method)
        else:
            if method == "max":
                x = x.contiguous()
            dx = pool_bwd_cuda(x, g.contiguous(), kernel, stride, pad,
                               method)
        return dx, None, None, None, None, None


def max_pool(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    return Pool2d.apply(x, kernel, stride, pad, "max", False)


def ave_pool(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    return Pool2d.apply(x, kernel, stride, pad, "ave", False)


def max_pool_reference(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    """MAX pooling with the plain backward, on any device."""
    return Pool2d.apply(x, kernel, stride, pad, "max", True)


def ave_pool_reference(x: torch.Tensor, kernel, stride, pad) -> torch.Tensor:
    """AVE pooling with the plain backward, on any device."""
    return Pool2d.apply(x, kernel, stride, pad, "ave", True)
