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
Both are channel-parallel tiles: a block stages a chunk of at most 64
channels (C in equal chunks, chosen by the C entry) with its halo times a
run of consecutive h*w positions (64 for the forward, 32 for the backward)
in shared memory. The forward (K4) squares each element once there and
forms y from the window of squares; the backward (K5) computes each
element's s and r once and forms dx from the r window.
The halo (``local_size - 1`` channels for the forward, on each side for
the backward) grows their shared memory with the window, so both take
``local_size`` up to MAX_CUDA_LOCAL_SIZE.

A channels-last (NHWC) tensor has kernels of its own, the second entry
points of ``csrc/lrn_fwd.cu`` and ``csrc/lrn_bwd.cu`` (the TPU kernels'
``layout="NHWC"`` form), with the same arithmetic, so they too are bitwise
equal to the plain versions. Both keep a warp's run of pixels in registers,
V consecutive channels a lane moved as one access (``ops/vector.vector_width``
picks V from C and the pointers: at most MAX_NHWC_FWD_LANE_CHANNELS for the
forward, 16 bytes in f32 and bf16; at most MAX_NHWC_LANE_CHANNELS for the
backward, 16 bytes in f32, 8 in bf16), and take the window's taps from the
neighbouring lanes by warp shuffles (``csrc/lrn_nhwc.cuh``): no shared
memory. Both take C up to MAX_NHWC_CHANNELS and count their launches in
``LAUNCHES["lrn_fwd_nhwc"]`` and ``LAUNCHES["lrn_bwd_nhwc"]``. The autograd
Function routes by memory format: a channels-last CUDA tensor to the NHWC
kernels, any other CUDA tensor (made NCHW-contiguous) to the NCHW ones; it
never converts a channels-last tensor to NCHW, and its gradient comes back
in the input's memory format, as the plain versions' results do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..numeric import memory_format
from . import _build
from .vector import vector_width

# launches of each kernel of this module, counted where the kernel launches
LAUNCHES = {"lrn_fwd": 0, "lrn_bwd": 0, "lrn_fwd_nhwc": 0,
            "lrn_bwd_nhwc": 0}
# the kernels' shared-memory halo grows with the window: capped here and
# in csrc/lrn_fwd.cu and csrc/lrn_bwd.cu (MAX_LRN_SIZE)
MAX_CUDA_LOCAL_SIZE = 32
# channels a pixel of the NHWC kernels, at most: MAX_NHWC_CHANNELS of
# csrc/lrn_nhwc.cuh, which both C entries refuse past
MAX_NHWC_CHANNELS = 4096
# channels a lane of the NHWC backward, at most (csrc/lrn_bwd.cu: more
# cost registers and blocks an SM)
MAX_NHWC_LANE_CHANNELS = 4
# channels a lane of the NHWC forward, at most (csrc/lrn_fwd.cu: 16 bytes
# of bf16; f32 stops at 4 by vector_width's 16 bytes)
MAX_NHWC_FWD_LANE_CHANNELS = 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _window_sum(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Channel-window sum of (N, C, H, W), in t's memory format: pad
    (before, after) channels with zeros and add the before+after+1 shifted
    slices in ascending order."""
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
    x's dtype and memory format, window taps summed in ascending order."""
    pre = (local_size - 1) // 2
    post = local_size - pre - 1
    xf = _compute(x)
    scale = k + (alpha / local_size) * _window_sum(xf * xf, pre, post)
    return (xf * scale.pow(-beta)).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor, local_size: int,
                  alpha: float, beta: float, k: float = 1.0) -> torch.Tensor:
    """dx of ACROSS_CHANNELS LRN from (x, g): Caffe's analytic gradient,
    computed in f32 with s recomputed from x, returned in x's dtype and
    memory format."""
    pre = (local_size - 1) // 2
    post = local_size - pre - 1
    xf = _compute(x)
    gf = _compute(g)
    scale = k + (alpha / local_size) * _window_sum(xf * xf, pre, post)
    r = gf * xf * scale.pow(-beta - 1.0)
    rsum = _window_sum(r, post, pre)
    dx = gf * scale.pow(-beta) - (2.0 * alpha * beta / local_size) * xf * rsum
    return dx.to(x.dtype).contiguous(memory_format=memory_format(x))


def _check_window(name: str, local_size: int) -> None:
    if not 1 <= local_size <= MAX_CUDA_LOCAL_SIZE:
        raise ValueError(f"{name} takes local_size in [1, "
                         f"{MAX_CUDA_LOCAL_SIZE}], got {local_size}")


def _check_cuda(name: str, *ts: torch.Tensor,
                fmt: torch.memory_format = torch.contiguous_format) -> None:
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
        if not t.is_contiguous(memory_format=fmt):
            raise ValueError(f"{name} needs a "
                             + ("channels-last (NHWC)" if fmt ==
                                torch.channels_last else "contiguous NCHW")
                             + " tensor")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             f"device")


def _lib(name: str, args, entry: str = ""):
    fn = getattr(_build.load(name), entry or f"poseidon_{name}")
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return fn


def lrn_fwd_cuda(x: torch.Tensor, local_size: int, alpha: float, beta: float,
                 k: float = 1.0) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream."""
    _check_window("lrn_fwd_cuda", local_size)
    _check_cuda("lrn_fwd_cuda", x)
    n, c, h, w = x.shape
    if c * h * w >= 2 ** 31:
        raise ValueError("lrn_fwd_cuda: an image must hold < 2^31 elements")
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
    _build.count_launch(LAUNCHES, "lrn_fwd")
    return y


def lrn_fwd_kernel_attrs(dtype: torch.dtype, channels: int,
                         local_size: int) -> dict:
    """What the card reports for the forward kernel's instantiation that
    takes ``dtype`` and ``local_size`` at the tile of ``channels``
    (``cudaFuncGetAttributes``, and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its shared
    memory): registers, static/dynamic shared bytes, local (spill) bytes,
    threads a block, resident blocks per SM, and the tile's channels
    (``chunk``). Needs the card."""
    fn = getattr(_build.load("lrn_fwd"), "poseidon_lrn_fwd_attrs")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
            "local_bytes", "threads", "blocks_per_sm", "chunk")
    buf = (ctypes.c_int * len(keys))()
    rc = fn(_DTYPE_CODE[dtype], channels, local_size, buf)
    if rc != 0:
        raise RuntimeError(f"lrn_fwd attributes: cudaError {rc}")
    return dict(zip(keys, buf))


def lrn_bwd_cuda(x: torch.Tensor, g: torch.Tensor, local_size: int,
                 alpha: float, beta: float, k: float = 1.0) -> torch.Tensor:
    """Launch the backward kernel on PyTorch's current stream."""
    _check_cuda("lrn_bwd_cuda", x, g)
    _check_window("lrn_bwd_cuda", local_size)
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
    _build.count_launch(LAUNCHES, "lrn_bwd")
    return dx


def _check_channels(name: str, c: int) -> None:
    if c > MAX_NHWC_CHANNELS:
        raise ValueError(f"{name}: C must be at most MAX_NHWC_CHANNELS "
                         f"({MAX_NHWC_CHANNELS}), got {c}")


# argument types of the NHWC forward's C entries
_NHWC_FWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_float, ctypes.c_float,
                  ctypes.c_float, ctypes.c_void_p]
_NHWC_FWD_ATTRS_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p]


def lrn_fwd_nhwc_cuda(x: torch.Tensor, local_size: int, alpha: float,
                      beta: float, k: float = 1.0, *,
                      lane_channels: int = MAX_NHWC_FWD_LANE_CHANNELS
                      ) -> torch.Tensor:
    """Launch the NHWC forward kernel on PyTorch's current stream; x is a
    channels-last (N, C, H, W) tensor, y comes back channels-last. A lane
    moves ``vector_width`` channels as one access, at most
    ``lane_channels`` (a measurement may ask for fewer)."""
    _check_window("lrn_fwd_nhwc_cuda", local_size)
    _check_cuda("lrn_fwd_nhwc_cuda", x, fmt=torch.channels_last)
    n, c, h, w = x.shape
    _check_channels("lrn_fwd_nhwc_cuda", c)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    vec = vector_width(c, x.element_size(), x.data_ptr(), y.data_ptr(),
                       most=lane_channels)
    fn = _lib("lrn_fwd", _NHWC_FWD_ARGS, entry="poseidon_lrn_nhwc_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype], n * h * w,
                c, vec, local_size, alpha / local_size, beta, k, stream)
    if rc != 0:
        raise RuntimeError(f"lrn_fwd_nhwc kernel launch failed: cudaError "
                           f"{rc}")
    _build.count_launch(LAUNCHES, "lrn_fwd_nhwc")
    return y


def _nhwc_attrs(lib: str, entry: str, args, dtype: torch.dtype, vec: int,
                local_size: int) -> dict:
    """An NHWC kernel's attributes from the C entry ``entry`` of
    ``csrc/<lib>.cu``."""
    fn = _lib(lib, args, entry=entry)
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
            "local_bytes", "threads", "blocks_per_sm")
    buf = (ctypes.c_int * len(keys))()
    rc = fn(_DTYPE_CODE[dtype], vec, local_size, buf)
    if rc != 0:
        raise RuntimeError(f"{entry}: cudaError {rc}")
    return dict(zip(keys, buf))


def lrn_fwd_nhwc_kernel_attrs(dtype: torch.dtype, vec: int,
                              local_size: int) -> dict:
    """What the card reports for the NHWC forward's instantiation that
    takes ``dtype``, ``vec`` channels a lane and ``local_size``: registers,
    static/dynamic shared bytes, local (spill) bytes, threads a block and
    resident blocks per SM. Needs the card."""
    return _nhwc_attrs("lrn_fwd", "poseidon_lrn_nhwc_fwd_attrs",
                       _NHWC_FWD_ATTRS_ARGS, dtype, vec, local_size)


# argument types of the NHWC backward's C entries
_NHWC_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_float, ctypes.c_float,
                  ctypes.c_float, ctypes.c_float, ctypes.c_float,
                  ctypes.c_void_p]
_NHWC_BWD_ATTRS_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_POWF_FLOOR_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2


def lrn_bwd_nhwc_cuda(x: torch.Tensor, g: torch.Tensor, local_size: int,
                      alpha: float, beta: float,
                      k: float = 1.0) -> torch.Tensor:
    """Launch the NHWC backward kernel on PyTorch's current stream; x and g
    channels-last, dx comes back channels-last. A lane moves
    ``vector_width`` channels as one access: MAX_NHWC_LANE_CHANNELS where C
    and the pointers allow."""
    _check_window("lrn_bwd_nhwc_cuda", local_size)
    _check_cuda("lrn_bwd_nhwc_cuda", x, g, fmt=torch.channels_last)
    n, c, h, w = x.shape
    _check_channels("lrn_bwd_nhwc_cuda", c)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return dx
    vec = vector_width(c, x.element_size(), x.data_ptr(), g.data_ptr(),
                       dx.data_ptr(), most=MAX_NHWC_LANE_CHANNELS)
    fn = _lib("lrn_bwd", _NHWC_BWD_ARGS, entry="poseidon_lrn_nhwc_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                _DTYPE_CODE[x.dtype], n * h * w, c, vec, local_size,
                alpha / local_size, -beta, -beta - 1.0,
                2.0 * alpha * beta / local_size, k, stream)
    if rc != 0:
        raise RuntimeError(f"lrn_bwd_nhwc kernel launch failed: cudaError "
                           f"{rc}")
    _build.count_launch(LAUNCHES, "lrn_bwd_nhwc")
    return dx


def lrn_bwd_nhwc_kernel_attrs(dtype: torch.dtype, vec: int,
                              local_size: int) -> dict:
    """What the card reports for the NHWC backward's instantiation that
    takes ``dtype``, ``vec`` channels a lane and ``local_size``: registers,
    static/dynamic shared bytes, local (spill) bytes, threads a block and
    resident blocks per SM. Needs the card."""
    return _nhwc_attrs("lrn_bwd", "poseidon_lrn_nhwc_bwd_attrs",
                       _NHWC_BWD_ATTRS_ARGS, dtype, vec, local_size)


def lrn_powf_floor_cuda(n: int, local_size: int, alpha: float, beta: float,
                        k: float = 1.0, device="cuda",
                        blocks: int = 132 * 16,
                        powfs: int = 2) -> torch.Tensor:
    """An LRN kernel's powf alone, over ``n`` elements from registers (the
    least time its unchanged arithmetic allows): ``powfs`` = 2 for the
    backward's two an element, 1 for the forward's one; returns the
    kernel's per-thread sums. A measurement, not on any path."""
    if powfs not in (1, 2):
        raise ValueError(f"lrn_powf_floor_cuda: powfs is 1 or 2, got {powfs}")
    out = torch.empty(blocks * 256, dtype=torch.float32, device=device)
    fn = _lib("lrn_bwd", _POWF_FLOOR_ARGS, entry="poseidon_lrn_powf_floor")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(n, blocks, powfs, alpha / local_size, -beta, -beta - 1.0, k,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lrn_powf_floor launch failed: cudaError {rc}")
    return out


def lrn_fwd_device(x: torch.Tensor, local_size: int, alpha: float,
                   beta: float, k: float = 1.0) -> torch.Tensor:
    """The forward kernel for a CUDA tensor's memory format: NHWC for a
    channels-last tensor, else NCHW (a non-contiguous x made contiguous)."""
    if memory_format(x) == torch.channels_last:
        return lrn_fwd_nhwc_cuda(x, local_size, alpha, beta, k)
    return lrn_fwd_cuda(x.contiguous(), local_size, alpha, beta, k)


def lrn_bwd_device(x: torch.Tensor, g: torch.Tensor, local_size: int,
                   alpha: float, beta: float, k: float = 1.0) -> torch.Tensor:
    """The backward kernel for x's memory format; g is brought to x's
    format (autograd may hand it over in another one)."""
    fmt = memory_format(x)
    if fmt == torch.channels_last:
        return lrn_bwd_nhwc_cuda(x, g.contiguous(memory_format=fmt),
                                 local_size, alpha, beta, k)
    return lrn_bwd_cuda(x.contiguous(), g.contiguous(), local_size, alpha,
                        beta, k)


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
        return lrn_fwd_device(x, local_size, alpha, beta, k)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if ctx.plain:
            dx = lrn_bwd_plain(x, g, *ctx.args)
        else:
            dx = lrn_bwd_device(x, g, *ctx.args)
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
