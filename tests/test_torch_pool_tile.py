"""The pooling backward kernel's band plan (``ops/pool.py:pool_band_plan``)
and its loop order, checked on the CPU.

The CUDA kernel (``ops/csrc/pool_bwd.cu``) cannot run here, so this file
holds what decides its result against the plain version:

- the band plan the wrapper hands to the C entry covers every dx row
  exactly once, stages every window that covers a band row and every x row
  those windows read, and fits its shared-memory budget (hypothesis over
  the geometry, with several planes a block);
- a numpy emulation of the kernel's loop order — band by band, each
  window's argmax once as a flat index into the whole padded plane
  (boundary windows recomputed by both bands), its cotangent sent in one
  pass a slot (the window's rank among those covering the element) so
  that each dx element adds its covering windows with the output row and
  column descending (AVE: gathered in that order), f32
  adds from zero — is BITWISE equal to ``pool_bwd_plain`` on MAX and AVE:
  rows and planes of -inf (a window with nothing above -inf keeps flat
  index 0 of the plane), NaN, ties, pad with the ceil-mode clamp, stride
  larger than the window, global pooling, band boundaries at every row;
- MAX cases are also held BITWISE against the JAX package's taps arm
  (``POSEIDON_POOL_BWD=taps``), as ``tests/test_torch_pool.py`` does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from poseidon_tpu.ops import nn as JNN
from poseidon_tpu_torch.ops import pool as port_pool


def _cover(p, kernel, stride, n_out):
    """Windows [lo, hi] along an axis covering padded coordinate p."""
    first = p - kernel + 1
    lo = 0 if first <= 0 else -(-first // stride)
    return lo, min(p // stride, n_out - 1)


def _emulate(x, g, kernel, stride, pad, method, plan):
    """dx as the kernel forms it, block by block of ``plan``. MAX: each
    window's first maximum once, as a flat index into the whole padded
    plane; its cotangent goes to that element if it lies in the band, in
    one pass a slot ascending: for tap (a, b) of window (oy, ox) the slot
    is (min(a // sh, oh-1-oy), min(b // sw, ow-1-ox)), the window's rank
    among those covering the element with the output row and column
    descending. AVE: each dx element gathers its covering windows' g /
    divisor in that order."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    n, c, h, w = x.shape
    oh, ow = g.shape[2], g.shape[3]
    planes = n * c
    xs = x.float().numpy().reshape(planes, h, w)
    gs = g.float().numpy().reshape(planes, oh, ow)
    pwidth = (ow - 1) * sw + kw
    cols = np.array([_cover(cc + pw, kw, sw, ow) for cc in range(w)])
    col_lo, col_hi = cols[:, 0], cols[:, 1]
    span_x = max(1, int((col_hi - col_lo + 1).max()))
    slots_x = min(-(-kw // sw), ow)
    n_slots = min(-(-kh // sh), oh) * slots_x
    dx = np.full((planes, h, w), np.nan, np.float32)
    for p0 in range(0, planes, plan.planes_per_block):
        blk = slice(p0, min(p0 + plan.planes_per_block, planes))
        for j in range(plan.n_bands):
            b = port_pool.pool_band(h, oh, kh, sh, ph, plan.band_rows, j)
            oys = b.oy0 + np.arange(b.nwy)
            oxs = np.arange(ow)
            # stage: the band's windows' g, and the x rows they read
            sg = gs[blk, b.oy0:b.oy0 + b.nwy].copy()
            if method == "max":
                sx = xs[blk, b.xr0:b.xr0 + b.nxr]
                mx = np.full(sg.shape, -np.inf, np.float32)
                arg = np.zeros(sg.shape, np.int64)
                for a in range(kh):
                    ys = oys * sh + a - ph
                    for bb in range(kw):
                        xx = oxs * sw + bb - pw
                        ok = (((ys >= 0) & (ys < h))[:, None]
                              & ((xx >= 0) & (xx < w))[None, :])
                        yi = np.clip(ys - b.xr0, 0, max(b.nxr - 1, 0))
                        xi = np.clip(xx, 0, w - 1)
                        v = np.where(ok, sx[:, yi][:, :, xi], -np.inf)
                        better = v > mx
                        mx = np.where(better, v, mx)
                        flat = ((oys * sh + a)[:, None] * pwidth
                                + (oxs * sw + bb)[None, :])
                        arg = np.where(better, flat, arg)
                # the argmax's tap in its window, and the element it is
                tap_y = arg // pwidth - (oys * sh)[:, None]
                tap_x = arg % pwidth - (oxs * sw)[None, :]
                row, col = arg // pwidth - ph, arg % pwidth - pw
                send = ((tap_y >= 0) & (tap_x >= 0) & (row >= b.r0)
                        & (row < b.r1) & (col >= 0) & (col < w))
                slot = (np.minimum(tap_y // sh, oh - 1 - oys[:, None])
                        * slots_x
                        + np.minimum(tap_x // sw, ow - 1 - oxs[None, :]))
                assert ((slot >= 0) & (slot < n_slots) | ~send).all()
                band = np.zeros((sg.shape[0], b.r1 - b.r0, w), np.float32)
                pl = np.broadcast_to(np.arange(sg.shape[0])[:, None, None],
                                     sg.shape)
                # the kernel's code, (slot << 16) | element, is never
                # negative
                elem = (pl * (b.r1 - b.r0) + row - b.r0) * w + col
                assert (elem[send] < 2 ** 16).all()
                assert ((slot[send] << 16) | elem[send] < 2 ** 31).all()
                for k in range(n_slots):
                    sel = send & (slot == k)
                    idx = (pl[sel], row[sel] - b.r0, col[sel])
                    assert len(set(zip(*idx))) == len(idx[0])  # no clash
                    band[idx] = band[idx] + sg[sel]
                dx[blk, b.r0:b.r1] = band
                continue
            ext = lambda o, s_, p_, k_, n_: (  # noqa: E731
                np.minimum(o * s_ - p_ + k_, n_ + p_) - (o * s_ - p_))
            denom = (ext(oys, sh, ph, kh, h).astype(np.float32)[:, None]
                     * ext(oxs, sw, pw, kw, w).astype(np.float32)[None])
            sg = sg / denom
            for r in range(b.r0, b.r1):
                lo, hi = _cover(r + ph, kh, sh, oh)
                acc = np.zeros((sg.shape[0], w), np.float32)
                for oy in range(hi, lo - 1, -1):
                    for d in range(span_x):
                        ox = col_hi - d
                        oxc = np.clip(ox, 0, ow - 1)
                        acc = np.where(ox >= col_lo,
                                       acc + sg[:, oy - b.oy0, oxc], acc)
                dx[blk, r] = acc
    return torch.from_numpy(dx.reshape(n, c, h, w)).to(x.dtype)


def _case(shape, k, s, p, seed, fill=None, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    if fill == "ties":
        x.fill_(0.5)
    elif fill == "-inf":
        x[:, :, :3] = -math.inf
        x[0, 1] = -math.inf
        x[-1, -1, :, 1] = math.nan
    oh = port_pool.pool_out_size(shape[2], k, s, p)
    ow = port_pool.pool_out_size(shape[3], k, s, p)
    g = torch.from_numpy(rs.randn(shape[0], shape[1], oh, ow)
                         .astype(np.float32))
    return x.to(dtype), g.to(dtype), ((k, k), (s, s), (p, p))


def _plan(x, g, geom, method, band_rows=None, planes_per_block=1):
    """The wrapper's plan, or the one of ``band_rows`` rows a band and
    ``planes_per_block`` planes a block."""
    n, c, h, w = x.shape
    if band_rows is None:
        return port_pool.pool_band_plan(n * c, h, w, g.shape[2], g.shape[3],
                                        *geom, method == "max")
    return port_pool._plan_at(h, w, g.shape[2], g.shape[3], *geom,
                              method == "max", band_rows, planes_per_block)


@settings(max_examples=80, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 300), k=st.integers(1, 7),
       s=st.integers(1, 4), pad_frac=st.floats(0, 0.999),
       planes=st.integers(1, 40), is_max=st.booleans())
def test_band_plan_covers_stages_and_fits(h, w, k, s, pad_frac, planes,
                                          is_max):
    pad = int(pad_frac * k)  # 0 .. k-1
    assume(h + 2 * pad >= k and w + 2 * pad >= k)
    oh = port_pool.pool_out_size(h, k, s, pad)
    ow = port_pool.pool_out_size(w, k, s, pad)
    plan = port_pool.pool_band_plan(planes, h, w, oh, ow, (k, k), (s, s),
                                    (pad, pad), is_max)
    assert plan.smem_bytes <= port_pool.POOL_SMEM_BUDGET
    assert plan.smem_bytes == port_pool.pool_smem_bytes(
        w, ow, is_max, plan.band_rows, plan.planes_per_block, plan.x_rows,
        plan.win_rows)
    assert plan.planes_per_block >= 1
    assert plan.planes_per_block == 1 or plan.n_bands == 1
    rows_seen = []
    for j in range(plan.n_bands):
        b = port_pool.pool_band(h, oh, k, s, pad, plan.band_rows, j)
        rows_seen.extend(range(b.r0, b.r1))
        assert b.nwy <= plan.win_rows and b.nxr <= plan.x_rows
        for r in range(b.r0, b.r1):
            lo, hi = _cover(r + pad, k, s, oh)
            for oy in range(lo, hi + 1):
                # the window is staged, and so is every x row it reads
                assert b.oy0 <= oy < b.oy0 + b.nwy
                for y in range(oy * s - pad, oy * s - pad + k):
                    if 0 <= y < h:
                        assert b.xr0 <= y < b.xr0 + b.nxr
    assert rows_seen == list(range(h))


def test_band_plan_alexnet_and_a_large_plane():
    """AlexNet's pools take whole planes (pool2 five, pool5 24 a block);
    a 600x600 plane takes several bands."""
    for h, ppb in ((55, 1), (27, 5), (13, 24)):
        oh = port_pool.pool_out_size(h, 3, 2, 0)
        plan = port_pool.pool_band_plan(256 * 256, h, h, oh, oh, (3, 3),
                                        (2, 2), (0, 0), True)
        assert (plan.n_bands, plan.planes_per_block) == (1, ppb)
    plan = port_pool.pool_band_plan(2, 600, 600, 300, 300, (3, 3), (2, 2),
                                    (0, 0), True)
    assert plan.n_bands > 1 and plan.planes_per_block == 1


@pytest.mark.parametrize("planes,h", [(128, 27), (2, 600), (1, 5), (300, 7)])
def test_band_plan_small_tensor_fills_the_grid(planes, h):
    """A small tensor takes one plane a block, then shorter bands, until
    the grid has POOL_MIN_BLOCKS blocks (or every block holds one row)."""
    oh = port_pool.pool_out_size(h, 3, 2, 0)
    plan = port_pool.pool_band_plan(planes, h, h, oh, oh, (3, 3), (2, 2),
                                    (0, 0), True)
    blocks = -(-planes // plan.planes_per_block) * plan.n_bands
    assert plan.planes_per_block == 1
    assert blocks >= port_pool.POOL_MIN_BLOCKS or plan.band_rows == 1 \
        or blocks * plan.band_rows >= port_pool.POOL_MIN_BLOCKS


MAX_CASES = [
    ("alexnet 3x3 s2", (2, 3, 27, 27), 3, 2, 0, None),
    ("pad ceil clamp", (2, 3, 8, 8), 3, 2, 1, None),
    ("stride > kernel", (2, 3, 13, 13), 2, 3, 0, None),
    ("googlenet 3x3 s1 p1", (2, 3, 14, 14), 3, 1, 1, None),
    ("ties", (2, 3, 9, 9), 3, 2, 0, "ties"),
    ("-inf rows, NaN", (2, 3, 11, 11), 3, 2, 0, "-inf"),
    ("-inf rows, NaN, pad", (2, 3, 11, 11), 3, 2, 1, "-inf"),
    ("lenet 2x2 s2", (2, 3, 12, 12), 2, 2, 0, None),
    # global MAX pooling (one window, 169 taps) and a wide stride-1 window
    ("global 13x13", (2, 3, 13, 13), 13, 1, 0, None),
    ("12x12 s1", (2, 3, 15, 14), 12, 1, 0, None),
]


@pytest.mark.parametrize("band_rows", [None, 1, 2, 3])
@pytest.mark.parametrize("label,shape,k,s,p,fill", MAX_CASES,
                         ids=[c[0] for c in MAX_CASES])
def test_banded_max_gather_bitwise_equal_to_plain(label, shape, k, s, p,
                                                  fill, band_rows):
    x, g, geom = _case(shape, k, s, p, seed=len(label), fill=fill)
    plan = _plan(x, g, geom, "max", band_rows=band_rows)
    got = _emulate(x, g, *geom, "max", plan)
    want = port_pool.pool_bwd_plain(x, g, *geom, "max")
    assert torch.equal(got, want)


@pytest.mark.parametrize("label,shape,k,s,p,fill", MAX_CASES,
                         ids=[c[0] for c in MAX_CASES])
def test_banded_max_gather_bitwise_equal_to_jax_taps(label, shape, k, s, p,
                                                     fill, monkeypatch):
    monkeypatch.setenv("POSEIDON_POOL_BWD", "taps")
    x, g, geom = _case(shape, k, s, p, seed=len(label) + 1, fill=fill)
    got = _emulate(x, g, *geom, "max", _plan(x, g, geom, "max",
                                             band_rows=2))
    _, vjp = jax.vjp(lambda x_: JNN.max_pool(x_, *geom),
                     jnp.asarray(x.numpy()))
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    np.testing.assert_array_equal(got.numpy(), want)


def test_max_slots_and_the_refused_window():
    """A MAX element's slots: min(ceil(k / s), out) an axis, one for a
    global pool; a window past POOL_MAX_SLOTS is refused before the
    device."""
    assert port_pool.pool_slots(27, 27, (3, 3), (2, 2)) == 4
    assert port_pool.pool_slots(28, 28, (3, 3), (1, 1)) == 9
    assert port_pool.pool_slots(1, 1, (13, 13), (1, 1)) == 1
    assert port_pool.pool_slots(4, 3, (12, 12), (1, 1)) == 12
    assert port_pool.pool_slots(201, 201, (200, 200), (1, 1)) \
        > port_pool.POOL_MAX_SLOTS
    with pytest.raises(ValueError, match="slots"):
        port_pool.pool_band_plan(1, 400, 400, 201, 201, (200, 200), (1, 1),
                                 (0, 0), True)
    plan = port_pool.pool_band_plan(1, 400, 400, 201, 201, (200, 200),
                                    (1, 1), (0, 0), False)
    assert plan.smem_bytes <= port_pool.POOL_SMEM_MAX


def test_minus_inf_plane_keeps_flat_index_zero():
    """A plane of -inf: every window keeps flat index 0 of the plane, so
    only window (0, 0) sends its cotangent (to input (0, 0)), whatever
    band it lies in; with padding that position is padding and nothing is
    sent."""
    for pad in (0, 1):
        x, g, geom = _case((1, 2, 11, 11), 3, 2, pad, seed=7, fill="-inf")
        for band_rows in (1, 4):
            plan = _plan(x, g, geom, "max", band_rows=band_rows)
            got = _emulate(x, g, *geom, "max", plan)
            assert torch.equal(got, port_pool.pool_bwd_plain(x, g, *geom,
                                                             "max"))
            assert float(got[0, 1, 0, 0]) == (float(g[0, 1, 0, 0])
                                              if pad == 0 else 0.0)
            assert int((got[0, 1] != 0).sum()) == (1 if pad == 0 else 0)


AVE_CASES = [
    ("pad ceil clamp", (2, 3, 13, 13), 2, 2, 1),
    ("googlenet 5x5 s3", (2, 3, 14, 14), 5, 3, 0),
    ("googlenet 7x7 s1", (2, 3, 7, 7), 7, 1, 0),
    ("cifar 3x3 s2", (2, 3, 16, 16), 3, 2, 0),
    ("stride > kernel, pad", (2, 3, 13, 11), 2, 3, 1),
]


@pytest.mark.parametrize("band_rows", [None, 1, 2])
@pytest.mark.parametrize("label,shape,k,s,p", AVE_CASES,
                         ids=[c[0] for c in AVE_CASES])
def test_banded_ave_gather_bitwise_equal_to_plain(label, shape, k, s, p,
                                                  band_rows):
    x, g, geom = _case(shape, k, s, p, seed=len(label) + 2)
    plan = _plan(x, g, geom, "ave", band_rows=band_rows)
    got = _emulate(x, g, *geom, "ave", plan)
    assert torch.equal(got, port_pool.pool_bwd_plain(x, g, *geom, "ave"))


@pytest.mark.parametrize("method", ["max", "ave"])
def test_band_boundaries_at_every_row_and_plane_groups(method):
    """Every band height from 1 to h, and whole planes grouped 1..7 to a
    block (the last block short), in f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        x, g, geom = _case((2, 5, 10, 9), 3, 2, 1, seed=11, dtype=dtype)
        want = port_pool.pool_bwd_plain(x, g, *geom, method)
        for band_rows in range(1, 11):
            plan = _plan(x, g, geom, method, band_rows=band_rows)
            assert torch.equal(_emulate(x, g, *geom, method, plan), want)
        for ppb in range(1, 8):
            plan = _plan(x, g, geom, method, band_rows=10,
                         planes_per_block=ppb)
            assert torch.equal(_emulate(x, g, *geom, method, plan), want)
