"""Caffe pooling (MAX and AVE, NCHW or channels-last): the forward, the
hand-written CUDA backward kernels, their wrappers, their plain PyTorch
version, and the autograd Functions the POOLING layer calls.

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

The kernel is one pass over shared-memory bands: a block stages the x and
g rows of a band of dx rows (or of several whole small planes) and takes
each window's argmax (MAX) or scaled cotangent (AVE) once; MAX sends each
cotangent to its element in one pass a slot, AVE gathers, both in the
plain version's order of adds. ``pool_band_plan`` sizes the band to a
shared-memory budget here, where a CPU test can check it, and the wrapper
hands it to the C entry.

A channels-last (NHWC) tensor has a kernel of its own, the second entry
point of ``csrc/pool_bwd.cu`` (``pool_bwd_nhwc_cuda``, counted in
``LAUNCHES["pool_bwd_nhwc"]`` once a call): one launch, no scratch. A
block stages the x and g rows of a band of dx rows of one image and a group
of its channels in shared memory with cp.async, a vector of up to 16 bytes
of channels a copy, takes each window's argmax (MAX) once there, and each
dx element gathers its covering windows in the plain version's order, so it
too is bitwise equal to the plain version. ``pool_nhwc_plan`` picks the
vector width (``ops/vector.vector_width``), the channel group and the band
here, where a CPU test can check them.
The JAX package transposes an NHWC plane to NCHW around its kernel; the
port does not, as the result is the same. The forward keeps its input's
memory format (the pad, the crop and torch's pooling all do), and the
Function routes the backward by memory format: a channels-last CUDA
tensor to the NHWC kernel, any other CUDA tensor (made NCHW-contiguous) to
the NCHW one, never converting a channels-last tensor to NCHW; dx comes
back in the input's memory format, as the plain version's does.

``max_pool_reference`` / ``ave_pool_reference`` run the plain backward on
any device: chip_smoke.py swaps them into the POOLING layers to hold a
whole training step against the kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numeric import memory_format
from . import _build
from .vector import vector_width

# launches of this module's kernel, counted where the kernel launches
LAUNCHES = {"pool_bwd": 0, "pool_bwd_nhwc": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The backward kernel's band plan: a band's shared memory fits
# POOL_SMEM_BUDGET bytes (POOL_SMEM_MAX, what a block can opt in to, when a
# band of one row needs more), and a block takes several whole planes until
# it holds about POOL_BLOCK_ELEMS dx elements within POOL_GROUP_SMEM bytes
# (nine blocks of 128 threads an SM); a small tensor takes fewer planes,
# then shorter bands, until the grid has POOL_MIN_BLOCKS blocks. A MAX
# window takes at most POOL_MAX_SLOTS slots (csrc/pool_bwd.cu kMaxSlots).
POOL_SMEM_BUDGET = 48 * 1024
POOL_SMEM_MAX = 227 * 1024
POOL_BLOCK_ELEMS = 4096
POOL_GROUP_SMEM = 24 * 1024
POOL_MIN_BLOCKS = 1024
POOL_MAX_SLOTS = 1 << 15
# The NHWC kernel's plan: a block takes about POOL_NHWC_GROUP_BYTES of each
# pixel's channels and the tallest band whose shared memory fits
# POOL_NHWC_SMEM_BUDGET (three blocks of 256 threads an SM; POOL_SMEM_MAX
# when a band of one row needs more), fewer rows for a small tensor until
# the grid has POOL_MIN_BLOCKS blocks. A window takes at most
# POOL_NHWC_MAX_TAPS taps (a 16-bit code, one value kept for none).
POOL_NHWC_GROUP_BYTES = 64
POOL_NHWC_SMEM_BUDGET = 72 * 1024
POOL_NHWC_MAX_TAPS = 65534


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


@functools.lru_cache(maxsize=256)
def _ave_denom_on(h, w, oh, ow, kernel, stride, pad, device,
                  dtype) -> torch.Tensor:
    """``_ave_denom`` as a tensor on ``device``, made once a shape: a
    forward inside a CUDA graph's capture copies nothing from the host."""
    return torch.from_numpy(_ave_denom(h, w, oh, ow, kernel, stride,
                                       pad)).to(device=device, dtype=dtype)


def pool_forward(x: torch.Tensor, kernel, stride, pad,
                 method: str) -> torch.Tensor:
    """Caffe MAX ("max") or AVE ("ave") pooling of (N, C, H, W), in x's
    memory format."""
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    if method == "max":
        xp = _pool_pad_crop(x, kernel, stride, pad, oh, ow, -math.inf)
        return F.max_pool2d(xp, tuple(kernel), tuple(stride))
    xp = _pool_pad_crop(x, kernel, stride, pad, oh, ow, 0.0)
    summed = F.avg_pool2d(xp, tuple(kernel), tuple(stride),
                          divisor_override=1)
    return summed / _ave_denom_on(h, w, oh, ow, tuple(kernel), tuple(stride),
                                  tuple(pad), x.device, x.dtype)


def pool_bwd_plain(x: torch.Tensor, g: torch.Tensor, kernel, stride, pad,
                   method: str) -> torch.Tensor:
    """dx of Caffe pooling from (x, g), the taps formulation: for MAX each
    window's first-max-wins argmax (strict ``>`` over row-major taps, pad
    = -inf, initial argmax flat index 0) recomputed from the padded input;
    for AVE the divisor-scaled cotangent. Contributions are added onto the
    padded plane tap by tap in row-major order, in f32, then the padding is
    cropped off; returned in x's dtype and in x's memory format (for AVE,
    where x may be an expanded stand-in, in g's)."""
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
        gf = gf / _ave_denom_on(h, w, oh, ow, tuple(kernel), tuple(stride),
                                tuple(pad), x.device, torch.float32)
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
    # the padded plane in the result's memory format, so the crop below
    # converts nothing (the device kernels write that format too)
    fmt = memory_format(x if method == "max" else g)
    dxp = torch.empty((n, c, ph, pw), dtype=cdt, device=x.device,
                      memory_format=fmt).zero_()
    for dh in range(kernel[0]):
        for dw in range(kernel[1]):
            contrib = gf if method == "ave" else torch.where(
                arg == flat(dh, dw), gf, 0.0)
            dxp[:, :, rows(dh), cols(dw)] += contrib
    # un-pad: drop the pad rows/cols, zero-fill any input extent the
    # ceil-mode crop never consumed
    dxp = F.pad(dxp, (0, max(pad[1] + w - pw, 0), 0, max(pad[0] + h - ph, 0)))
    return dxp[:, :, pad[0]:pad[0] + h, pad[1]:pad[1] + w].to(x.dtype) \
        .contiguous(memory_format=fmt)


class Band(NamedTuple):
    """Band j of a plan: dx rows [r0, r1), the window rows covering them
    [oy0, oy0 + nwy) and the x rows those windows read [xr0, xr0 + nxr)."""
    r0: int
    r1: int
    oy0: int
    nwy: int
    xr0: int
    nxr: int


class BandPlan(NamedTuple):
    """What the C entry launches: ``band_rows`` dx rows a block (all ``h``
    when one band holds the plane, then ``planes_per_block`` whole planes a
    block), and the shared memory of a block (``x_rows``, ``win_rows``:
    the most any band stages per plane)."""
    band_rows: int
    n_bands: int
    planes_per_block: int
    x_rows: int
    win_rows: int
    smem_bytes: int


def _cover_lo(p: int, kernel: int, stride: int) -> int:
    """First window along an axis that covers padded coordinate p."""
    first = p - kernel + 1
    return 0 if first <= 0 else (first + stride - 1) // stride


def _cover_hi(p: int, stride: int, n_out: int) -> int:
    """Last window along an axis that covers padded coordinate p."""
    return min(p // stride, n_out - 1)


def pool_band(h: int, oh: int, kh: int, sh: int, ph: int, band_rows: int,
              j: int) -> Band:
    """Band j of ``band_rows`` dx rows (csrc/pool_bwd.cu:band_of)."""
    r0 = j * band_rows
    r1 = min(h, r0 + band_rows)
    oy0 = _cover_lo(r0 + ph, kh, sh)
    hi = _cover_hi(r1 - 1 + ph, sh, oh)
    nwy = max(0, hi - oy0 + 1)
    if nwy == 0:
        return Band(r0, r1, oy0, 0, 0, 0)
    xr0 = max(0, oy0 * sh - ph)
    return Band(r0, r1, oy0, nwy, xr0, max(0, min(h, hi * sh - ph + kh)
                                            - xr0))


def pool_slots(oh: int, ow: int, kernel, stride) -> int:
    """A MAX dx element's slots in the kernel: the most windows that
    cover one input element, min(ceil(k / s), out) an axis."""
    return (min(-(-kernel[0] // stride[0]), oh)
            * min(-(-kernel[1] // stride[1]), ow))


def pool_smem_bytes(w: int, ow: int, is_max: bool, band_rows: int,
                    planes_per_block: int, x_rows: int,
                    win_rows: int) -> int:
    """A block's shared memory (csrc/pool_bwd.cu:smem_words) in 4-byte
    words: for MAX, per plane x (whose space then holds the band's dx) and
    the windows' g and argmax codes; for AVE, per plane the windows' g,
    then two covering-window tables of 2 words per band row and column."""
    if is_max:
        return 4 * planes_per_block * (max(x_rows, band_rows) * w
                                       + 2 * win_rows * ow)
    return 4 * (planes_per_block * win_rows * ow + 2 * band_rows + 2 * w)


def _plan_at(h: int, w: int, oh: int, ow: int, kernel, stride, pad,
             is_max: bool, rows: int, ppb: int) -> BandPlan:
    """The plan of ``rows`` dx rows a band (at most ``h``) and ``ppb``
    planes a block, its shared memory the most any band stages."""
    rows = min(rows, h)
    n_bands = -(-h // rows)
    bands = [pool_band(h, oh, kernel[0], stride[0], pad[0], rows, j)
             for j in range(n_bands)]
    xr = max(b.nxr for b in bands)
    wr = max(b.nwy for b in bands)
    return BandPlan(rows, n_bands, ppb, xr, wr, pool_smem_bytes(
        w, ow, is_max, rows, ppb, xr, wr))


@functools.lru_cache(maxsize=256)
def pool_band_plan(planes: int, h: int, w: int, oh: int, ow: int, kernel,
                   stride, pad, is_max: bool) -> BandPlan:
    """The backward kernel's band plan for (planes, h, w) pooled to (oh,
    ow): the tallest band within POOL_SMEM_BUDGET bytes of shared memory
    (the whole plane where it fits, then several planes a block up to
    POOL_BLOCK_ELEMS dx elements and POOL_GROUP_SMEM bytes), cut down for
    a small tensor until the grid has POOL_MIN_BLOCKS blocks. Raises
    ValueError for a MAX window of more than POOL_MAX_SLOTS slots, and
    where even one row overflows POOL_SMEM_MAX."""
    if is_max and pool_slots(oh, ow, kernel, stride) > POOL_MAX_SLOTS:
        raise ValueError(f"pool_bwd: a MAX window {kernel}/{stride} over "
                         f"a {oh}x{ow} output takes more than "
                         f"{POOL_MAX_SLOTS} slots")

    def plan(rows: int, ppb: int) -> BandPlan:
        return _plan_at(h, w, oh, ow, kernel, stride, pad, is_max, rows, ppb)

    for cap in (POOL_SMEM_BUDGET, POOL_SMEM_MAX):
        best = next((p for p in (plan(rows, 1) for rows in range(h, 0, -1))
                     if p.smem_bytes <= cap), None)
        if best is not None:
            break
    else:
        raise ValueError(f"pool_bwd: a band of one {w}-wide row needs more "
                         f"than {POOL_SMEM_MAX} bytes of shared memory")
    if planes * best.n_bands < POOL_MIN_BLOCKS:
        bands = -(-POOL_MIN_BLOCKS // planes)
        return plan(min(best.band_rows, -(-h // bands)), 1)
    if best.n_bands > 1:
        return best
    ppb = max(1, min(POOL_BLOCK_ELEMS // (h * w), planes // POOL_MIN_BLOCKS))
    while ppb > 1 and plan(h, ppb).smem_bytes > POOL_GROUP_SMEM:
        ppb -= 1
    return plan(h, ppb)


def _lib():
    fn = _build.load("pool_bwd").poseidon_pool_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + \
            [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_ATTR_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
              "local_bytes", "threads", "blocks_per_sm")


def pool_bwd_kernel_attrs(dtype: torch.dtype, method: str, shape, kernel,
                          stride, pad) -> dict:
    """What the card reports for the kernel instantiation that takes
    ``dtype`` and ``method`` at the band plan of an (N, C, H, W) ``shape``
    (``cudaFuncGetAttributes``, and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the plan's shared
    memory), keyed by ``_ATTR_KEYS`` plus the plan. Needs the card."""
    fn = _build.load("pool_bwd").poseidon_pool_bwd_attrs
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 16 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    n, c, h, w = shape
    oh = pool_out_size(h, kernel[0], stride[0], pad[0])
    ow = pool_out_size(w, kernel[1], stride[1], pad[1])
    plan = pool_band_plan(n * c, h, w, oh, ow, tuple(kernel), tuple(stride),
                          tuple(pad), method == "max")
    buf = (ctypes.c_int * len(_ATTR_KEYS))()
    rc = fn(_DTYPE_CODE[dtype], int(method == "max"), h, w, oh, ow,
            kernel[0], kernel[1], stride[0], stride[1], pad[0], pad[1],
            plan.band_rows, plan.planes_per_block, plan.x_rows,
            plan.win_rows, buf)
    if rc != 0:
        raise RuntimeError(f"pool_bwd attributes: cudaError {rc}")
    return {**dict(zip(_ATTR_KEYS, buf)), **plan._asdict()}


def pool_bwd_cuda(x: torch.Tensor, g: torch.Tensor, kernel, stride, pad,
                  method: str) -> torch.Tensor:
    """Launch the backward kernel on PyTorch's current stream, one launch
    at the band plan of ``pool_band_plan``. For "ave" x is read for its
    shape, dtype and device only (an expanded tensor will do)."""
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
    padded = ((oh - 1) * stride[0] + kernel[0]) * \
        ((ow - 1) * stride[1] + kernel[1])
    if max(h * w, padded) >= 2 ** 31:
        raise ValueError("pool_bwd_cuda: a plane must hold < 2^31 elements")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dx
    plan = pool_band_plan(n * c, h, w, oh, ow, tuple(kernel), tuple(stride),
                          tuple(pad), method == "max")
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr() if method == "max" else None, g.data_ptr(),
                dx.data_ptr(), _DTYPE_CODE[x.dtype], int(method == "max"),
                n * c, h, w, oh, ow, kernel[0], kernel[1], stride[0],
                stride[1], pad[0], pad[1], plan.band_rows,
                plan.planes_per_block, plan.x_rows, plan.win_rows, stream)
    if rc != 0:
        raise RuntimeError(f"pool_bwd kernel launch failed: cudaError {rc}")
    _build.count_launch(LAUNCHES, "pool_bwd")
    return dx


class NhwcPlan(NamedTuple):
    """What the NHWC C entry launches: ``vec`` channels a vector,
    ``group_vecs`` vectors of each pixel a block (``n_groups`` groups),
    ``band_rows`` dx rows a block (``n_bands`` bands), and the shared memory
    of a block (``x_rows``, ``win_rows``: the most any band stages)."""
    vec: int
    group_vecs: int
    n_groups: int
    band_rows: int
    n_bands: int
    x_rows: int
    win_rows: int
    smem_bytes: int


def pool_nhwc_smem_bytes(w: int, ow: int, is_max: bool, vec: int,
                         elem_size: int, group_vecs: int, x_rows: int,
                         win_rows: int) -> int:
    """A block's shared memory (csrc/pool_bwd.cu:nhwc::smem_bytes): a pixel's
    group of ``group_vecs`` vectors; for MAX ``x_rows`` rows of x, then
    ``win_rows`` rows of g and of the windows' codes (2 bytes a channel);
    for AVE the g rows alone."""
    g_bytes = win_rows * ow * group_vecs * vec * elem_size
    if not is_max:
        return g_bytes
    return (x_rows * w * group_vecs * vec * elem_size + g_bytes
            + win_rows * ow * group_vecs * vec * 2)


@functools.lru_cache(maxsize=256)
def pool_nhwc_plan(batch: int, channels: int, h: int, w: int, oh: int,
                   ow: int, kernel, stride, pad, is_max: bool,
                   elem_size: int, vec: int) -> NhwcPlan:
    """The NHWC kernel's plan for (batch, h, w, channels) pooled to (oh, ow)
    with ``vec`` channels a vector: groups of about POOL_NHWC_GROUP_BYTES of
    a pixel, split evenly; then the tallest band within
    POOL_NHWC_SMEM_BUDGET bytes (POOL_SMEM_MAX if one row needs more), its
    rows evened out over the plane, cut down for a small tensor until the
    grid has POOL_MIN_BLOCKS blocks. Raises ValueError where even one row
    overflows POOL_SMEM_MAX."""
    nvp = channels // vec
    group = max(1, min(nvp, POOL_NHWC_GROUP_BYTES // (vec * elem_size)))
    n_groups = -(-nvp // group)
    group = -(-nvp // n_groups)

    def plan(rows: int) -> NhwcPlan:
        rows = min(rows, h)
        n_bands = -(-h // rows)
        bands = [pool_band(h, oh, kernel[0], stride[0], pad[0], rows, j)
                 for j in range(n_bands)]
        xr = max(b.nxr for b in bands) if is_max else 0
        wr = max(b.nwy for b in bands)
        return NhwcPlan(vec, group, n_groups, rows, n_bands, xr, wr,
                        pool_nhwc_smem_bytes(w, ow, is_max, vec, elem_size,
                                             group, xr, wr))

    def tallest(top: int, cap: int):
        return next((p for p in (plan(rows) for rows in range(top, 0, -1))
                     if p.smem_bytes <= cap), None)

    for cap in (POOL_NHWC_SMEM_BUDGET, POOL_SMEM_MAX):
        best = tallest(h, cap)
        if best is not None:
            break
    else:
        raise ValueError(f"pool_bwd_nhwc: a band of one {w}-pixel row of "
                         f"{group * vec} channels needs more than "
                         f"{POOL_SMEM_MAX} bytes of shared memory")
    rows = -(-h // best.n_bands)
    if batch * n_groups * best.n_bands < POOL_MIN_BLOCKS:
        bands = -(-POOL_MIN_BLOCKS // (batch * n_groups))
        rows = min(rows, -(-h // bands))
    return tallest(rows, cap) or best


def _nhwc_lib():
    fn = _build.load("pool_bwd").poseidon_pool_nhwc_bwd
    if fn.argtypes is None:
        fn.argtypes = _NHWC_ARGS
        fn.restype = ctypes.c_int
    return fn


# argument types of the NHWC C entries
_NHWC_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_longlong] + \
    [ctypes.c_int] * 16 + [ctypes.c_void_p]
_NHWC_ATTRS_ARGS = [ctypes.c_int] * 18 + [ctypes.c_void_p]


def _nhwc_geometry(name: str, x: torch.Tensor, kernel, stride, pad):
    """(h, w, oh, ow) of a call, refusing what the NHWC kernel does not
    take."""
    c = x.shape[1]
    h, w, oh, ow = _pool_dims(x, kernel, stride, pad)
    if min(*kernel, *stride) < 1 or min(pad) < 0:
        raise ValueError(f"{name}: bad window {kernel}/{stride}/{pad}")
    if max(h * w, oh * ow) * c >= 2 ** 31:
        raise ValueError(f"{name}: an image must hold < 2^31 elements")
    if kernel[0] * kernel[1] > POOL_NHWC_MAX_TAPS:
        raise ValueError(f"{name}: a window takes at most "
                         f"{POOL_NHWC_MAX_TAPS} taps (POOL_NHWC_MAX_TAPS)")
    return h, w, oh, ow


def pool_bwd_nhwc_kernel_attrs(dtype: torch.dtype, method: str, shape,
                               kernel, stride, pad) -> dict:
    """What the card reports for the NHWC kernel's instantiation that takes
    ``dtype`` and ``method`` at the plan of a fresh channels-last (N, C, H,
    W) tensor of ``shape`` (16-byte aligned), keyed by ``_ATTR_KEYS`` plus
    the plan. Needs the card."""
    fn = _build.load("pool_bwd").poseidon_pool_nhwc_bwd_attrs
    if fn.argtypes is None:
        fn.argtypes = _NHWC_ATTRS_ARGS
        fn.restype = ctypes.c_int
    n, c, h, w = shape
    oh = pool_out_size(h, kernel[0], stride[0], pad[0])
    ow = pool_out_size(w, kernel[1], stride[1], pad[1])
    size = torch.empty((), dtype=dtype).element_size()
    plan = pool_nhwc_plan(n, c, h, w, oh, ow, tuple(kernel), tuple(stride),
                          tuple(pad), method == "max", size,
                          vector_width(c, size))
    buf = (ctypes.c_int * len(_ATTR_KEYS))()
    rc = fn(_DTYPE_CODE[dtype], int(method == "max"), c, h, w, oh, ow,
            kernel[0], kernel[1], stride[0], stride[1], pad[0], pad[1],
            plan.vec, plan.group_vecs, plan.band_rows, plan.x_rows,
            plan.win_rows, buf)
    if rc != 0:
        raise RuntimeError(f"pool_bwd_nhwc attributes: cudaError {rc}")
    return {**dict(zip(_ATTR_KEYS, buf)), **plan._asdict()}


def pool_bwd_nhwc_cuda(x: torch.Tensor, g: torch.Tensor, kernel, stride,
                       pad, method: str) -> torch.Tensor:
    """Launch the NHWC backward kernel on PyTorch's current stream: x and g
    channels-last (N, C, H, W) tensors, dx comes back channels-last; one
    launch at the plan of ``pool_nhwc_plan``, allocating nothing but dx.
    For "ave" x is read for its shape, dtype and device only (an expanded
    tensor will do)."""
    if method not in ("max", "ave"):
        raise ValueError(f"pool_bwd_nhwc_cuda: method must be 'max' or "
                         f"'ave', got {method!r}")
    for t in (x, g) if method == "max" else (g,):
        if not t.is_cuda:
            raise ValueError("pool_bwd_nhwc_cuda needs CUDA tensors")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"pool_bwd_nhwc_cuda takes float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError("pool_bwd_nhwc_cuda takes channels-last "
                             "(N, C, H, W) tensors")
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError("pool_bwd_nhwc_cuda: x and g differ in dtype or "
                         "device")
    n, c = x.shape[0], x.shape[1]
    h, w, oh, ow = _nhwc_geometry("pool_bwd_nhwc_cuda", x, kernel, stride,
                                  pad)
    if tuple(g.shape) != (n, c, oh, ow):
        raise ValueError(f"pool_bwd_nhwc_cuda: g has shape "
                         f"{tuple(g.shape)}, the pooling gives "
                         f"{(n, c, oh, ow)}")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    if x.numel() == 0:
        return dx
    is_max = method == "max"
    ptrs = (g.data_ptr(), dx.data_ptr()) + ((x.data_ptr(),) if is_max
                                            else ())
    plan = pool_nhwc_plan(n, c, h, w, oh, ow, tuple(kernel), tuple(stride),
                          tuple(pad), is_max, x.element_size(),
                          vector_width(c, x.element_size(), *ptrs))
    if n * plan.n_groups * plan.n_bands > 2 ** 31 - 1:
        raise ValueError("pool_bwd_nhwc_cuda: a grid of at most 2^31 - 1 "
                         "blocks (batch x channel groups x bands)")
    fn = _nhwc_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr() if is_max else None, g.data_ptr(),
                dx.data_ptr(), _DTYPE_CODE[x.dtype], int(is_max), n, c, h,
                w, oh, ow, kernel[0], kernel[1], stride[0], stride[1],
                pad[0], pad[1], plan.vec, plan.group_vecs, plan.band_rows,
                plan.x_rows, plan.win_rows, stream)
    if rc != 0:
        raise RuntimeError(f"pool_bwd_nhwc kernel launch failed: cudaError "
                           f"{rc}")
    _build.count_launch(LAUNCHES, "pool_bwd_nhwc")
    return dx


def pool_bwd_device(x: torch.Tensor, g: torch.Tensor, kernel, stride, pad,
                    method: str, fmt: torch.memory_format) -> torch.Tensor:
    """The backward kernel for the input's memory format ``fmt``: NHWC for
    channels-last, else NCHW; g is brought to that format (autograd may
    hand it over in another one), x too where it is read (MAX)."""
    if fmt == torch.channels_last:
        if method == "max":
            x = x.contiguous(memory_format=fmt)
        return pool_bwd_nhwc_cuda(x, g.contiguous(memory_format=fmt),
                                  kernel, stride, pad, method)
    if method == "max":
        x = x.contiguous()
    return pool_bwd_cuda(x, g.contiguous(), kernel, stride, pad, method)


class Pool2d(torch.autograd.Function):
    """Caffe pooling whose backward is the kernel on a CUDA tensor and the
    plain version on a CPU tensor (or anywhere, with ``plain``)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad, method, plain):
        ctx.geom = (tuple(kernel), tuple(stride), tuple(pad), method)
        ctx.plain = plain or x.device.type == "cpu"
        ctx.fmt = memory_format(x)
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
            # g in x's format, as the kernels' path brings it
            g = g.contiguous(memory_format=ctx.fmt)
            dx = pool_bwd_plain(x, g, kernel, stride, pad, method)
        else:
            dx = pool_bwd_device(x, g, kernel, stride, pad, method, ctx.fmt)
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
