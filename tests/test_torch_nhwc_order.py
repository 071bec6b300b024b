"""The order of operations of K4-NHWC, K5-NHWC and K6-NHWC, the
channels-last LRN forward, LRN backward and pooling backward kernels
(``ops/csrc/lrn_fwd.cu``, ``ops/csrc/lrn_bwd.cu``, ``ops/csrc/pool_bwd.cu``),
checked on the CPU.

The CUDA kernels cannot run here, so this file writes out each design's
schedule with numpy and torch and holds it BITWISE against the plain
versions on the same channels-last tensors, in float32 and bfloat16:

- K4-NHWC: K5-NHWC's runs, rounds and lanes (below) with one stream: each
  element squared once, the window of squares from the neighbouring lanes
  and rounds, zero outside the pixel, from 0.0 in ascending tap order,
  ``pow`` once over the whole tensor; against JAX's Pallas
  ``lrn_fused(layout="NHWC")`` in interpret mode too;
- K5-NHWC: a warp's run of pixels as one stream of pixels * C elements,
  walked in rounds of 32 lanes x V elements; each window tap beyond a
  lane's own V elements taken the kernel's way, from the lane ``s`` away
  with one shuffle whose sender picks the previous, current or next round
  for its one reader, zero where the tap's channel leaves [0, C); both
  window sums from 0.0 in ascending tap order; ``pow`` once over the whole
  tensor, as in the plain version (torch's CPU ``pow`` takes another path
  on another shape; on the card both sides call the same ``powf``);
- K6-NHWC: the wrapper's plan (channel groups, bands of dx rows with their
  halo of window rows and x rows), each window's first maximum once from
  the band's staged rows as a tap code (0xffff for none, bar window (0,
  0)), each dx element gathering its covering windows with the output row
  and column descending (K6's slots in ascending order), f32 adds from
  zero; AVE with g over Caffe's divisor;
- the same inputs through the JAX package's Pallas ``lrn_fused_bwd(layout=
  "NHWC")`` in interpret mode (rtol 1e-5, atol 1e-6 in f32; 2^-7 in bf16)
  and its NHWC pooling backward, taps arm (bitwise);
- the wrappers' planners: ``ops/vector.vector_width`` (from C and the
  pointers), ``ops/pool.pool_nhwc_plan`` (hypothesis: every dx row once,
  every covering window and x row staged, the budget kept), and the C
  entries' signatures against the wrappers' ctypes argument lists.

Nothing here needs a card.
"""

import ctypes
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from poseidon_tpu.ops import nn as JNN
from poseidon_tpu.ops.pallas_kernels import lrn_fused, lrn_fused_bwd
from poseidon_tpu_torch.ops import lrn as port_lrn
from poseidon_tpu_torch.ops import pool as port_pool
from poseidon_tpu_torch.ops.vector import VECTOR_BYTES, vector_width

CL = torch.channels_last
CSRC = Path(port_lrn.__file__).resolve().parent / "csrc"
ALPHA, BETA, K = 0.7, 0.75, 1.3
LANES = 32
F32 = np.float32


def _cl(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).contiguous(
        memory_format=CL)


def _inputs(shape, dtype, seed, oshape=None):
    rs = np.random.RandomState(seed)
    x = _cl(rs.randn(*shape).astype(F32), dtype)
    g = _cl(rs.randn(*(oshape or shape)).astype(F32), dtype)
    return x, g


# --------------------------------------------------------------------------- #
# K5-NHWC: lanes, rounds and shuffles
# --------------------------------------------------------------------------- #

def _lane_window(a, lo, hi, chan, channels, vec, rounds=True):
    """The kernel's ``window<V, LO, HI>`` over every lane of every round at
    once: a (runs, rounds, 32, V) f32; chan (runs, rounds, 32) the channel
    of each lane's first element. Returns the window sums, same shape.
    ``rounds=False`` (a negative control) sends every tap from the current
    round."""
    prev, nxt = np.zeros_like(a), np.zeros_like(a)
    prev[:, 1:], nxt[:, :-1] = a[:, :-1], a[:, 1:]
    if not rounds:
        prev = nxt = a
    lane = np.arange(LANES)
    e = {}
    for h in range(-lo, 0):
        s = -((-h + vec - 1) // vec)
        j = h - s * vec
        send = np.where(lane - s >= LANES, prev[..., j], a[..., j])
        e[h] = np.where(chan + h >= 0, send[..., (lane + s) % LANES], F32(0))
    for i in range(vec):
        e[i] = a[..., i]
    for h in range(vec, vec + hi):
        s, j = h // vec, h % vec
        send = np.where(lane < s, nxt[..., j], a[..., j])
        e[h] = np.where(chan + h < channels, send[..., (lane + s) % LANES],
                        F32(0))
    out = np.empty_like(a)
    for i in range(vec):
        acc = np.zeros(a.shape[:-1], F32)
        for t in range(lo + hi + 1):
            acc = acc + e[i - lo + t]
        out[..., i] = acc
    return out


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).reshape(-1).numpy()


def _warp_runs(n_pix, c, vec, pixels):
    """The warps' runs of ``pixels`` pixels as streams of rounds of 32
    lanes x ``vec`` elements: (stream, unstream, chan), stream taking a
    flat NHWC array to (runs, rounds, 32, vec), zero past each run's end,
    unstream the way back, chan the channel of each lane's first element,
    (round * 32 vec + lane vec) % C."""
    runs = -(-n_pix // pixels)
    rnd = LANES * vec
    n_rounds = -(-pixels * c // rnd)

    def stream(flat):
        flat = np.concatenate([flat, np.zeros(runs * pixels * c - flat.size,
                                              F32)]).reshape(runs, -1)
        flat = np.concatenate([flat, np.zeros((runs, n_rounds * rnd
                                               - pixels * c), F32)], 1)
        return flat.reshape(runs, n_rounds, LANES, vec)

    def unstream(a):
        return a.reshape(runs, -1)[:, :pixels * c].reshape(-1)[:n_pix * c]

    pos = (np.arange(n_rounds)[:, None] * rnd + np.arange(LANES) * vec) % c
    return stream, unstream, np.broadcast_to(pos, (runs, n_rounds, LANES))


def _lrn_fwd_lane_schedule(x, size, alpha, beta, k, vec, pixels,
                           rounds=True):
    """y as K4-NHWC forms it: each warp's run of ``pixels`` pixels a stream
    of rounds of 32 lanes x ``vec`` elements (a window other than 5 runs
    one element a lane), each element squared once, the window of squares
    from the neighbouring lanes (lane 0 from the previous round, lane 31
    from the next; ``rounds=False``, a negative control, from their own),
    zero outside the pixel."""
    n, c, h, w = x.shape
    vec = vec if size == 5 else 1
    pre = (size - 1) // 2
    stream, unstream, chan = _warp_runs(n * h * w, c, vec, pixels)
    xs = stream(_nhwc(x))
    ws = _lane_window(xs * xs, pre, size - 1 - pre, chan, c, vec, rounds)
    s = F32(k) + F32(alpha / size) * ws
    # pow over the whole tensor in the plain version's layout
    s_t = torch.from_numpy(unstream(s).copy()).reshape(n, h, w, c).permute(
        0, 3, 1, 2)
    y = _nhwc(x) * _nhwc(s_t.pow(-beta))
    return torch.from_numpy(y.copy()).reshape(n, h, w, c).permute(
        0, 3, 1, 2).to(x.dtype)


FWD_CHANNELS = [1, 2, 3, 7, 16, 96, 131, 256]


@pytest.mark.parametrize("size", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("channels", FWD_CHANNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lrn_fwd_lane_schedule_bitwise_to_plain(dtype, channels, size):
    """K4-NHWC's schedule at every lane width the C entry takes (1, 2, 4
    and, in bf16, 8 channels a lane, where it divides C) and runs of 1, 3
    and 8 pixels: runs of one pixel, rounds that end mid-pixel, runs that
    end mid-round, a last run cut short (30 pixels)."""
    x, _ = _inputs((2, channels, 3, 5), dtype, 11 * size + channels)
    want = port_lrn.lrn_across_channels_plain(x, size, ALPHA, BETA,
                                              K).contiguous()
    most = 16 // x.element_size()
    for vec in [v for v in (1, 2, 4, 8) if v <= most and channels % v == 0]:
        for pixels in (1, 3, 8):
            got = _lrn_fwd_lane_schedule(x, size, ALPHA, BETA, K, vec,
                                         pixels)
            assert torch.equal(got, want), (vec, pixels)


def test_lrn_fwd_lane_schedule_alexnet_runs():
    """norm1's and norm2's widths at the runs the C entry picks on the card
    (pixels_per_warp at 12 rounds: 16 and 6 pixels in f32, 32 and 12 in
    bf16), whole rounds a run."""
    for c, runs in ((96, {torch.float32: 16, torch.bfloat16: 32}),
                    (256, {torch.float32: 6, torch.bfloat16: 12})):
        for dtype, pixels in runs.items():
            x, _ = _inputs((2, c, 7, 9), dtype, c + pixels)
            vec = vector_width(c, x.element_size(),
                               most=port_lrn.MAX_NHWC_FWD_LANE_CHANNELS)
            assert vec * x.element_size() == 16
            assert pixels * c % (LANES * vec) == 0
            got = _lrn_fwd_lane_schedule(x, 5, ALPHA, BETA, K, vec, pixels)
            assert torch.equal(got, port_lrn.lrn_across_channels_plain(
                x, 5, ALPHA, BETA, K).contiguous())


def test_lrn_fwd_lane_schedule_needs_the_neighbouring_rounds():
    """Negative control: lane 0 and lane 31 taking their taps from their
    own round, not the previous and next, breaks the result, so the tests
    above see the rounds."""
    x, _ = _inputs((2, 96, 3, 5), torch.float32, 4)
    got = _lrn_fwd_lane_schedule(x, 5, ALPHA, BETA, K, 4, 8, rounds=False)
    assert not torch.equal(got, port_lrn.lrn_across_channels_plain(
        x, 5, ALPHA, BETA, K).contiguous())


@pytest.mark.parametrize("size,channels", [(5, 16), (4, 7), (5, 96),
                                           (9, 131)])
def test_lrn_fwd_lane_schedule_vs_pallas_nhwc_interpret(size, channels):
    x, _ = _inputs((2, channels, 4, 5), torch.float32, 50 + size)
    got = _lrn_fwd_lane_schedule(x, size, ALPHA, BETA, K,
                                 vector_width(channels, 4), 4)
    ref = np.asarray(lrn_fused(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), size, ALPHA, BETA, K,
        interpret=True, layout="NHWC")).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("vec", [4, 8])
def test_lrn_fwd_lane_schedule_bf16_vs_pallas_nhwc_interpret(vec):
    x, _ = _inputs((2, 16, 4, 5), torch.bfloat16, 55)
    got = _lrn_fwd_lane_schedule(x, 5, ALPHA, BETA, K, vec, 4)
    xh = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
    ref = np.asarray(lrn_fused(xh, 5, ALPHA, BETA, K, interpret=True,
                               layout="NHWC").astype(jnp.float32)
                     ).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_lrn_fwd_lane_width_alexnet():
    """K4-NHWC's lanes take 16 bytes at AlexNet's widths: 4 f32 or 8 bf16
    channels; fewer for an odd C or a pointer off 16 bytes."""
    most = port_lrn.MAX_NHWC_FWD_LANE_CHANNELS
    assert vector_width(96, 4, most=most) == 4
    assert vector_width(96, 2, most=most) == 8
    assert vector_width(256, 2, most=most) == 8
    assert vector_width(131, 2, most=most) == 1
    assert vector_width(96, 2, 1 << 20 | 8, most=most) == 4


def _lrn_lane_schedule(x, g, size, alpha, beta, k, vec, pixels,
                       rounds=True):
    """dx as K5-NHWC forms it: each warp's run of ``pixels`` pixels a
    stream of rounds of 32 lanes x ``vec`` elements (a window other than 5
    runs one element a lane), the windows from neighbouring lanes."""
    n, c, h, w = x.shape
    vec = vec if size == 5 else 1
    pre = (size - 1) // 2
    post = size - 1 - pre
    stream, unstream, chan = _warp_runs(n * h * w, c, vec, pixels)
    xs, gs = stream(_nhwc(x)), stream(_nhwc(g))
    ws = _lane_window(xs * xs, pre, post, chan, c, vec, rounds)
    s = F32(k) + F32(alpha / size) * ws
    # pow over the whole tensor in the plain version's layout
    s_t = torch.from_numpy(unstream(s).copy()).reshape(n, h, w, c).permute(
        0, 3, 1, 2)
    p1 = _nhwc(s_t.pow(-beta - 1.0))
    p0 = _nhwc(s_t.pow(-beta))
    xf, gf = _nhwc(x), _nhwc(g)
    r = stream((gf * xf) * p1)
    first = gf * p0
    rs = unstream(_lane_window(r, post, pre, chan, c, vec, rounds))
    dx = first - (F32(2.0 * alpha * beta / size) * xf) * rs
    return torch.from_numpy(dx.copy()).reshape(n, h, w, c).permute(
        0, 3, 1, 2).to(x.dtype)


LRN_CASES = [  # (shape, local_size)
    ((2, 96, 5, 7), 5), ((1, 256, 3, 3), 5), ((3, 2, 4, 4), 5),
    ((2, 3, 5, 5), 5), ((1, 131, 3, 3), 5), ((2, 37, 3, 3), 4),
    ((2, 16, 3, 3), 1), ((1, 70, 2, 3), 32), ((2, 40, 2, 2), 7),
]


@pytest.mark.parametrize("pixels", [1, 3, 8])
@pytest.mark.parametrize("case", LRN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lrn_lane_schedule_bitwise_to_plain(dtype, case, pixels):
    shape, size = case
    x, g = _inputs(shape, dtype, 7 * size + shape[1])
    vec = vector_width(shape[1], x.element_size(),
                       most=port_lrn.MAX_NHWC_LANE_CHANNELS)
    got = _lrn_lane_schedule(x, g, size, ALPHA, BETA, K, vec, pixels)
    want = port_lrn.lrn_bwd_plain(x, g, size, ALPHA, BETA, K)
    assert torch.equal(got, want.contiguous())


@pytest.mark.parametrize("vec", [1, 2, 4])
def test_lrn_lane_schedule_any_vector_width(vec):
    """The result does not depend on the width a lane moves (the pointers'
    alignment picks it), f32 C = 96 at 1, 2 and 4 channels a lane."""
    x, g = _inputs((2, 96, 3, 5), torch.float32, 3)
    got = _lrn_lane_schedule(x, g, 5, ALPHA, BETA, K, vec, 5)
    assert torch.equal(got, port_lrn.lrn_bwd_plain(x, g, 5, ALPHA, BETA,
                                                   K).contiguous())


def test_lrn_lane_schedule_needs_the_neighbouring_rounds():
    """Negative control: lane 0 and lane 31 taking their taps from their
    own round, not the previous and next, breaks the result, so the tests
    above see the rounds."""
    x, g = _inputs((2, 96, 3, 5), torch.float32, 4)
    got = _lrn_lane_schedule(x, g, 5, ALPHA, BETA, K, 4, 8, rounds=False)
    assert not torch.equal(got, port_lrn.lrn_bwd_plain(x, g, 5, ALPHA, BETA,
                                                       K).contiguous())


@pytest.mark.parametrize("size,channels", [(5, 16), (4, 7), (5, 96)])
def test_lrn_lane_schedule_vs_pallas_nhwc_interpret(size, channels):
    x, g = _inputs((2, channels, 4, 5), torch.float32, 40 + size)
    got = _lrn_lane_schedule(x, g, size, ALPHA, BETA, K,
                             vector_width(channels, 4, most=4), 4)
    ref = np.asarray(lrn_fused_bwd(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(g.permute(0, 2, 3, 1).numpy()), size, ALPHA, BETA, K,
        interpret=True, layout="NHWC")).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_lrn_lane_schedule_bf16_vs_pallas_nhwc_interpret():
    x, g = _inputs((2, 16, 4, 5), torch.bfloat16, 45)
    got = _lrn_lane_schedule(x, g, 5, ALPHA, BETA, K, 4, 4)
    xh = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
    gh = jnp.asarray(g.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
    ref = np.asarray(lrn_fused_bwd(xh, gh, 5, ALPHA, BETA, K,
                                   interpret=True, layout="NHWC")
                     .astype(jnp.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# K6-NHWC: channel groups, bands, the argmax codes, the gather
# --------------------------------------------------------------------------- #

NONE = 0xffff


def _pool_band_schedule(x, g, kernel, stride, pad, method, plan):
    """dx as K6-NHWC forms it, block by block of ``plan``: each (channel
    group, band) stages its x rows and window rows, takes each window's
    first maximum once as a tap code, then each dx element of the band
    gathers its covering windows, output row and column descending."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    n, c, h, w = x.shape
    oh, ow = g.shape[2], g.shape[3]
    xs = x.float().permute(0, 2, 3, 1).numpy()
    gs = g.float().permute(0, 2, 3, 1).numpy()
    dx = np.full((n, h, w, c), np.nan, F32)
    group = plan.group_vecs * plan.vec
    assert plan.n_groups * group >= c > (plan.n_groups - 1) * group
    ext = lambda o, s_, p_, k_, n_: (  # noqa: E731
        min(o * s_ - p_ + k_, n_ + p_) - (o * s_ - p_))
    for grp in range(plan.n_groups):
        cs = slice(grp * group, min(c, (grp + 1) * group))
        for j in range(plan.n_bands):
            b = port_pool.pool_band(h, oh, kh, sh, ph, plan.band_rows, j)
            assert b.nwy <= plan.win_rows
            sg = gs[:, b.oy0:b.oy0 + b.nwy, :, cs]
            if method == "max":
                assert b.nxr <= plan.x_rows
                sx = xs[:, b.xr0:b.xr0 + b.nxr, :, cs]
                code = np.full(sg.shape, NONE, np.int64)
                for wy in range(b.nwy):
                    oy = b.oy0 + wy
                    for ox in range(ow):
                        mx = np.full((n, sg.shape[3]), -np.inf, F32)
                        best = np.full(mx.shape, -1, np.int64)
                        for a in range(kh):
                            y = oy * sh - ph + a
                            if not 0 <= y < h:
                                continue
                            for bb in range(kw):
                                xx = ox * sw - pw + bb
                                if not 0 <= xx < w:
                                    continue
                                v = sx[:, y - b.xr0, xx]
                                better = v > mx
                                mx = np.where(better, v, mx)
                                best = np.where(better, a * kw + bb, best)
                        none = 0 if oy == 0 and ox == 0 else NONE
                        code[:, wy, ox] = np.where(best >= 0, best, none)
            for y in range(b.r0, b.r1):
                py = y + ph
                lo_y, hi_y = _cover(py, kh, sh, oh)
                for xx in range(w):
                    px = xx + pw
                    lo_x, hi_x = _cover(px, kw, sw, ow)
                    acc = np.zeros((n, sg.shape[3]), F32)
                    for oy in range(hi_y, lo_y - 1, -1):
                        for ox in range(hi_x, lo_x - 1, -1):
                            gv = sg[:, oy - b.oy0, ox]
                            if method == "max":
                                tap = (py - oy * sh) * kw + (px - ox * sw)
                                take = code[:, oy - b.oy0, ox] == tap
                                acc = np.where(take, acc + gv, acc)
                            else:
                                d = F32(ext(oy, sh, ph, kh, h)) * F32(
                                    ext(ox, sw, pw, kw, w))
                                acc = acc + gv / d
                    dx[:, y, xx, cs] = acc
    return torch.from_numpy(dx).permute(0, 3, 1, 2).to(x.dtype)


def _cover(p, kernel, stride, n_out):
    """Windows [lo, hi] along an axis covering padded coordinate p."""
    first = p - kernel + 1
    lo = 0 if first <= 0 else -(-first // stride)
    return lo, min(p // stride, n_out - 1)


def _plan(x, kernel, stride, pad, method, band_rows=None):
    n, c, h, w = x.shape
    oh = port_pool.pool_out_size(h, kernel[0], stride[0], pad[0])
    ow = port_pool.pool_out_size(w, kernel[1], stride[1], pad[1])
    plan = port_pool.pool_nhwc_plan(n, c, h, w, oh, ow, kernel, stride, pad,
                                    method == "max", x.element_size(),
                                    vector_width(c, x.element_size()))
    if band_rows is None:
        return plan, (oh, ow)
    bands = [port_pool.pool_band(h, oh, kernel[0], stride[0], pad[0],
                                 band_rows, j)
             for j in range(-(-h // band_rows))]
    return plan._replace(band_rows=band_rows, n_bands=len(bands),
                         x_rows=max(b.nxr for b in bands),
                         win_rows=max(b.nwy for b in bands)), (oh, ow)


POOL_CASES = [  # (shape, kernel, stride, pad, band rows or None)
    ((2, 96, 13, 13), (3, 3), (2, 2), (0, 0), None),
    ((2, 16, 23, 9), (3, 3), (2, 2), (0, 0), 4),
    ((2, 16, 23, 9), (3, 3), (2, 2), (1, 1), 5),
    ((1, 2, 12, 12), (3, 3), (2, 2), (0, 0), 3),
    ((2, 3, 10, 10), (2, 2), (3, 3), (0, 0), 4),
    ((2, 40, 14, 14), (5, 5), (3, 3), (0, 0), None),
    ((2, 16, 13, 13), (13, 13), (1, 1), (0, 0), None),
    ((2, 45, 11, 11), (3, 3), (2, 2), (1, 1), 2),
    ((2, 24, 7, 7), (7, 7), (1, 1), (0, 0), None),
    ((2, 8, 12, 11), (3, 3), (2, 2), (1, 1), 1),
]


@pytest.mark.parametrize("method", ["max", "ave"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pool_band_schedule_bitwise_to_plain(dtype, case, method):
    shape, kernel, stride, pad, rows = case
    oh = port_pool.pool_out_size(shape[2], kernel[0], stride[0], pad[0])
    ow = port_pool.pool_out_size(shape[3], kernel[1], stride[1], pad[1])
    x, g = _inputs(shape, dtype, shape[1] + 3 * rows if rows else 5,
                   (shape[0], shape[1], oh, ow))
    plan, _ = _plan(x, kernel, stride, pad, method, rows)
    got = _pool_band_schedule(x, g, kernel, stride, pad, method, plan)
    want = port_pool.pool_bwd_plain(x, g, kernel, stride, pad, method)
    assert torch.equal(got, want.contiguous())


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pool_band_schedule_ties_minus_inf_and_nan(dtype, pad):
    """Rows and a whole plane of -inf (a window of nothing above -inf keeps
    flat index 0), a constant plane (the first maximum wins) and a NaN
    (never wins), over bands of 3 rows: bitwise to the plain version and
    to the JAX package's NHWC taps arm."""
    rs = np.random.RandomState(50 + pad)
    x = rs.randn(2, 12, 11, 11).astype(F32)
    x[0, :, :4] = -np.inf
    x[1, 3] = -np.inf
    x[1, 5] = 0.25
    x[0, 7, 5, 5] = np.nan
    oh = port_pool.pool_out_size(11, 3, 2, pad)
    xt = _cl(x, dtype)
    gt = _cl(rs.randn(2, 12, oh, oh).astype(F32), dtype)
    k, s, p = (3, 3), (2, 2), (pad, pad)
    plan, _ = _plan(xt, k, s, p, "max", 3)
    got = _pool_band_schedule(xt, gt, k, s, p, "max", plan)
    assert torch.equal(got, port_pool.pool_bwd_plain(xt, gt, k, s, p,
                                                     "max").contiguous())


@pytest.mark.parametrize("method", ["max", "ave"])
@pytest.mark.parametrize("geom", [((3, 3), (2, 2), (0, 0), 11),
                                  ((3, 3), (2, 2), (1, 1), 9),
                                  ((2, 2), (3, 3), (0, 0), 10)], ids=str)
def test_pool_band_schedule_vs_jax_nhwc_taps(geom, method, monkeypatch):
    """The schedule against the JAX package's NHWC pooling backward (taps
    arm): bitwise, the parity table's pooling tolerance."""
    monkeypatch.setenv("POSEIDON_POOL_BWD", "taps")
    kern, s, p, h = geom
    oh = port_pool.pool_out_size(h, kern[0], s[0], p[0])
    x, g = _inputs((2, 5, h, h), torch.float32, 60 + h, (2, 5, oh, oh))
    plan, _ = _plan(x, kern, s, p, method, 2)
    got = _pool_band_schedule(x, g, kern, s, p, method, plan)
    fn = JNN.max_pool if method == "max" else JNN.ave_pool
    _, vjp = jax.vjp(lambda x_: fn(x_, kern, s, p, "NHWC"),
                     jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    ref = np.asarray(vjp(jnp.asarray(g.permute(0, 2, 3, 1).numpy()))[0])
    np.testing.assert_array_equal(got.numpy(), ref.transpose(0, 3, 1, 2))


# --------------------------------------------------------------------------- #
# the planners
# --------------------------------------------------------------------------- #

@settings(max_examples=200, deadline=None)
@given(channels=st.integers(1, 4096), elem=st.sampled_from([2, 4]),
       offsets=st.lists(st.integers(0, 63), min_size=0, max_size=3),
       most=st.sampled_from([1, 2, 4, 8]))
def test_vector_width(channels, elem, offsets, most):
    addresses = [1 << 20 | (o * elem) for o in offsets]
    v = vector_width(channels, elem, *addresses, most=most)
    assert 1 <= v <= min(VECTOR_BYTES // elem, most) and v & (v - 1) == 0
    assert channels % v == 0
    assert all(a % (v * elem) == 0 for a in addresses)
    # the widest such: twice as wide fails a condition
    wider = 2 * v
    assert (wider * elem > VECTOR_BYTES or wider > most or channels % wider
            or any(a % (wider * elem) for a in addresses))


def test_vector_width_alexnet_and_odd_widths():
    assert vector_width(96, 4) == 4 and vector_width(256, 2) == 8
    assert vector_width(131, 4) == 1 and vector_width(2, 2) == 2
    assert vector_width(96, 4, 4) == 1 and vector_width(96, 2, 8) == 4
    # K5-NHWC's lanes take at most MAX_NHWC_LANE_CHANNELS
    assert vector_width(256, 2, most=port_lrn.MAX_NHWC_LANE_CHANNELS) == 4


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 300), c=st.integers(1, 600), h=st.integers(1, 120),
       w=st.integers(1, 120), k=st.integers(1, 7), s=st.integers(1, 4),
       p=st.integers(0, 3), is_max=st.booleans(), elem=st.sampled_from(
           [2, 4]))
def test_pool_nhwc_plan_covers_stages_and_fits(n, c, h, w, k, s, p, is_max,
                                               elem):
    p = min(p, k - 1)
    if h + 2 * p < k or w + 2 * p < k:
        return
    oh = port_pool.pool_out_size(h, k, s, p)
    ow = port_pool.pool_out_size(w, k, s, p)
    vec = vector_width(c, elem)
    plan = port_pool.pool_nhwc_plan(n, c, h, w, oh, ow, (k, k), (s, s),
                                    (p, p), is_max, elem, vec)
    nvp = c // vec
    assert plan.vec == vec
    assert plan.n_groups * plan.group_vecs >= nvp
    assert (plan.n_groups - 1) * plan.group_vecs < nvp
    assert plan.group_vecs * vec * elem <= max(
        port_pool.POOL_NHWC_GROUP_BYTES, vec * elem)
    assert plan.smem_bytes <= port_pool.POOL_SMEM_MAX
    assert plan.smem_bytes == port_pool.pool_nhwc_smem_bytes(
        w, ow, is_max, vec, elem, plan.group_vecs, plan.x_rows,
        plan.win_rows)
    rows = []
    for j in range(plan.n_bands):
        b = port_pool.pool_band(h, oh, k, s, p, plan.band_rows, j)
        rows.extend(range(b.r0, b.r1))
        assert b.nwy <= plan.win_rows and (not is_max or b.nxr <= plan.x_rows)
        for y in range(b.r0, b.r1):
            lo, hi = _cover(y + p, k, s, oh)
            for oy in range(lo, hi + 1):
                assert b.oy0 <= oy < b.oy0 + b.nwy
                for a in range(k):
                    yy = oy * s - p + a
                    if 0 <= yy < h and is_max:
                        assert b.xr0 <= yy < b.xr0 + b.nxr
    assert rows == list(range(h))


def test_pool_nhwc_plan_alexnet_fits_the_budget():
    """AlexNet's pools at batch 256 take the budget (three blocks an SM),
    whole planes where they fit, 16-byte vectors, about 64 bytes of a pixel
    a block."""
    for c, h, oh, elem in ((96, 55, 27, 4), (96, 55, 27, 2), (256, 27, 13, 4),
                           (256, 27, 13, 2), (256, 13, 6, 2)):
        plan = port_pool.pool_nhwc_plan(256, c, h, h, oh, oh, (3, 3), (2, 2),
                                        (0, 0), True, elem, 16 // elem)
        assert plan.smem_bytes <= port_pool.POOL_NHWC_SMEM_BUDGET
        assert plan.group_vecs * plan.vec * elem == 64
        assert 256 * plan.n_groups * plan.n_bands >= port_pool.POOL_MIN_BLOCKS


def test_pool_nhwc_plan_refuses_a_row_past_the_card():
    with pytest.raises(ValueError, match="shared memory"):
        port_pool.pool_nhwc_plan(1, 64, 4, 200000, 1, 99999, (3, 3), (2, 2),
                                 (0, 0), True, 4, 4)


def _c_params(source: str, entry: str):
    """The parameter names of ``extern "C" int entry(...)`` in a source."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', text)
    assert m, entry
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,entry,args", [
    ("pool_bwd.cu", "poseidon_pool_nhwc_bwd", port_pool._NHWC_ARGS),
    ("pool_bwd.cu", "poseidon_pool_nhwc_bwd_attrs",
     port_pool._NHWC_ATTRS_ARGS),
    ("lrn_bwd.cu", "poseidon_lrn_nhwc_bwd", port_lrn._NHWC_BWD_ARGS),
    ("lrn_bwd.cu", "poseidon_lrn_nhwc_bwd_attrs",
     port_lrn._NHWC_BWD_ATTRS_ARGS),
    ("lrn_bwd.cu", "poseidon_lrn_powf_floor", port_lrn._POWF_FLOOR_ARGS),
    ("lrn_fwd.cu", "poseidon_lrn_nhwc_fwd", port_lrn._NHWC_FWD_ARGS),
    ("lrn_fwd.cu", "poseidon_lrn_nhwc_fwd_attrs",
     port_lrn._NHWC_FWD_ATTRS_ARGS),
])
def test_c_entries_match_the_wrappers_argument_lists(source, entry, args):
    """Each NHWC C entry takes as many parameters as its wrapper passes,
    pointers and the stream as pointers; the pooling entry has no scratch
    argument (the kernel allocates nothing and takes no ``code``)."""
    params = _c_params(source, entry)
    assert len(params) == len(args)
    text = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)',
                    text).group(1).split(",")
    for decl, arg in zip(sig, args):
        assert ("*" in decl) == (arg is ctypes.c_void_p), (decl, arg)
    assert "code" not in params


def test_pool_nhwc_wrapper_refuses_a_window_past_its_codes():
    x = torch.zeros(1, 2, 300, 300).contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="POOL_NHWC_MAX_TAPS"):
        port_pool._nhwc_geometry("pool_bwd_nhwc_cuda", x, (256, 256),
                                 (1, 1), (0, 0))
    assert math.prod((255, 256)) <= port_pool.POOL_NHWC_MAX_TAPS
