"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test decides at run time whether a CUDA device is
present and skips without one (the CPU suite counts them as skipped).
Imports nothing of JAX, so it runs wherever torch sees a GPU.
"""

import pytest
import torch

from poseidon_tpu_torch.ops import flash as port_flash
from poseidon_tpu_torch.ops import lrn as port_lrn
from poseidon_tpu_torch.ops import pool as port_pool
from poseidon_tpu_torch.ops import sgd as port_sgd


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,local_size,tol", [
    (torch.float32, (4, 96, 55, 55), 5, 1e-5),
    (torch.float32, (3, 37, 9, 9), 4, 1e-5),
    (torch.bfloat16, (4, 256, 27, 27), 5, 2 ** -7),
])
def test_cuda_kernel_matches_plain_on_card(dtype, shape, local_size, tol):
    """The CUDA kernel against its plain version on the card (skips without
    a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = port_lrn.LAUNCHES["lrn_fwd"]
    got = port_lrn.lrn_across_channels(x, local_size, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert port_lrn.LAUNCHES["lrn_fwd"] == before + 1
    want = port_lrn.lrn_across_channels_plain(x, local_size, 1e-4, 0.75, 1.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,local_size,tol", [
    (torch.float32, (4, 96, 55, 55), 5, 1e-5),
    (torch.float32, (3, 37, 9, 9), 4, 1e-5),
    (torch.bfloat16, (4, 256, 27, 27), 5, 2 ** -7),
    # the window's edges: n = 1, the largest n; C below the halo; one
    # position; batch 1 with a C that is no multiple of the 64-channel chunk
    (torch.float32, (2, 16, 9, 9), 1, 1e-5),
    (torch.float32, (2, 70, 5, 7), 32, 1e-5),
    (torch.float32, (3, 2, 11, 11), 5, 1e-5),
    (torch.float32, (5, 96, 1, 1), 5, 1e-5),
    (torch.float32, (1, 131, 13, 13), 5, 1e-5),
    (torch.bfloat16, (1, 131, 13, 13), 7, 2 ** -7),
])
def test_lrn_bwd_kernel_matches_plain_on_card(dtype, shape, local_size, tol):
    """K5 through the autograd Function against the plain backward."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    xr = x.clone().requires_grad_(True)
    before = port_lrn.LAUNCHES["lrn_bwd"]
    port_lrn.lrn_across_channels(xr, local_size, 1e-4, 0.75, 1.0).backward(g)
    torch.cuda.synchronize()
    assert port_lrn.LAUNCHES["lrn_bwd"] == before + 1
    want = port_lrn.lrn_bwd_plain(x, g, local_size, 1e-4, 0.75, 1.0)
    torch.testing.assert_close(xr.grad.float(), want.float(), rtol=tol,
                               atol=1e-6)


@pytest.mark.gpu
def test_lrn_bwd_kernel_bitwise_equal_to_plain_on_card():
    """K5 computes each element as the plain backward does (taps in
    ascending order from zero, explicitly rounded, the same powf calls):
    bitwise equal at norm1's shape."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, g = (torch.randn((4, 96, 55, 55), generator=gen, device="cuda")
            for _ in range(2))
    got = port_lrn.lrn_bwd_cuda(x, g, 5, 1e-4, 0.75, 1.0)
    want = port_lrn.lrn_bwd_plain(x, g, 5, 1e-4, 0.75, 1.0)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,k,s,p,method", [
    (torch.float32, (4, 96, 55, 55), 3, 2, 0, "max"),
    (torch.bfloat16, (4, 256, 13, 13), 3, 2, 0, "max"),
    (torch.float32, (2, 16, 13, 13), 2, 2, 1, "ave"),
])
def test_pool_bwd_kernel_matches_plain_on_card(dtype, shape, k, s, p, method):
    """K6 through the autograd Function against the plain backward: the
    same f32 sums in the same order, so bitwise."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    fn = port_pool.max_pool if method == "max" else port_pool.ave_pool
    xr = x.clone().requires_grad_(True)
    y = fn(xr, (k, k), (s, s), (p, p))
    g = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    before = port_pool.LAUNCHES["pool_bwd"]
    y.backward(g)
    torch.cuda.synchronize()
    assert port_pool.LAUNCHES["pool_bwd"] == before + 1
    want = port_pool.pool_bwd_plain(x, g, (k, k), (s, s), (p, p), method)
    assert torch.equal(xr.grad, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4099, 60965224 + 7])
def test_sgd_update_kernel_matches_plain_on_card(n):
    """K7 against the plain rule: explicitly rounded, same order: bitwise."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    h = torch.randn(n, generator=gen, device="cuda") * 1e-3
    seg = (torch.arange(n, device="cuda") // 97) % 2 == 1
    lr = torch.where(seg, 2.0, 1.0).float()
    dec = torch.where(seg, 0.0, 5e-4).float()
    wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
    before = port_sgd.LAUNCHES["sgd_update"]
    port_sgd.sgd_update_(wk, g, hk, 0.01, lr, dec, 0.9)
    torch.cuda.synchronize()
    assert port_sgd.LAUNCHES["sgd_update"] == before + 1
    port_sgd.sgd_update_plain_(wp, g, hp, 0.01, lr, dec, 0.9)
    assert torch.equal(wk, wp) and torch.equal(hk, hp)


# (dtype, (heads, S, D), causal, mode) of the K1 card checks
FLASH_FWD_CASES = [
    (torch.float32, (12, 256, 64), True, None),
    (torch.float32, (4, 128, 64), False, None),
    (torch.float32, (4, 128, 64), True, 1),
    (torch.float32, (4, 128, 64), True, 0),
    (torch.float32, (4, 128, 64), True, -1),
    (torch.float32, (3, 48, 16), True, None),
    (torch.float32, (2, 100, 128), True, None),
    (torch.float32, (2, 100, 128), False, None),
    (torch.bfloat16, (12, 256, 64), True, None),
    # S off the 64-row query tiles and the key tiles
    (torch.float32, (2, 200, 64), True, None),
    (torch.float32, (2, 1000, 64), True, None),
    (torch.float32, (2, 1000, 64), False, None),
    # D padded up to the instantiation's 32/64/128 (zero-filled columns)
    (torch.float32, (2, 96, 24), True, None),
    (torch.float32, (2, 130, 80), True, None),
    # S smaller than one tile; a D off the 16-byte copies
    (torch.float32, (2, 20, 64), True, None),
    (torch.float32, (3, 7, 5), True, None),
    (torch.bfloat16, (2, 200, 80), True, None),
    (torch.bfloat16, (2, 130, 128), True, None),
    (torch.bfloat16, (4, 128, 64), True, 1),
    (torch.bfloat16, (4, 128, 64), True, -1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["short", "full"])
@pytest.mark.parametrize("dtype,hsd,causal,mode", FLASH_FWD_CASES)
def test_flash_fwd_kernel_matches_plain_on_card(dtype, hsd, causal, mode,
                                                grid):
    """K1 through the routing wrapper against its plain version on the
    card: out within f32 rtol 1e-4, atol 1e-5 (bf16: one bf16 step), lse
    within rtol 1e-4, atol 1e-5 (the kernel folds key tiles of 3xTF32 or
    bf16 tensor-core products, the plain version sums in one pass). A
    ``short`` grid (batch 1: fewer 64-row query tiles than the card has
    SMs) takes the kernel's key split, a ``full`` one (the batch raised
    until the tiles fill the SMs) the blocks of 64 rows."""
    _need_gpu()
    h, s, d = hsd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = h * -(-s // 64)
    b = 1 if grid == "short" else -(-sms // tiles)
    assert (b * tiles < sms) == (grid == "short")
    shape = (b, h, s, d)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = port_flash.LAUNCHES["flash_fwd"]
    out, lse = port_flash.flash_attention_fwd(q, k, v, causal, None, mode)
    torch.cuda.synchronize()
    assert port_flash.LAUNCHES["flash_fwd"] == before + 1
    want_o, want_l = port_flash.flash_attention_fwd_plain(q, k, v, causal,
                                                          None, mode)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want_o.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(lse, want_l, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,causal,mode", [
    (torch.float32, (2, 12, 512, 64), True, None),
    (torch.bfloat16, (2, 12, 512, 64), True, None),
    (torch.float32, (1, 2, 200, 128), False, None),
    (torch.float32, (2, 4, 128, 64), True, -1),
    (torch.float32, (1, 12, 256, 64), True, None),
])
def test_flash_fwd_kernel_bitwise_from_run_to_run(dtype, shape, causal,
                                                   mode):
    """Each block owns its output rows and nothing is added atomically: two
    launches on the same inputs give bitwise-equal out and lse."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    first = port_flash.flash_fwd_cuda(q, k, v, causal, None, mode)
    second = port_flash.flash_fwd_cuda(q, k, v, causal, None, mode)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_attrs_on_card(dtype):
    """Every K1 instantiation (both key splits) reports its registers and
    resident blocks; the f32 ones (the dtype of every path) spill nothing.
    bf16 at D = 64 is held to three blocks an SM and spills a few bytes,
    which measured faster than its unbounded build."""
    _need_gpu()
    for split in (1, 2):
        for d in (32, 64, 128):
            a = port_flash.flash_fwd_kernel_attrs(dtype, d, split)
            assert a["registers"] > 0 and a["blocks_per_sm"] >= 1, (d, a)
            assert a["own_rows"] == 64 // split, (d, a)
            if dtype == torch.float32:
                assert a["local_bytes"] == 0, (d, a)
    if dtype == torch.float32:
        assert port_flash.flash_fwd_kernel_attrs(dtype, 64)[
            "blocks_per_sm"] == 3


def _bwd_inputs(shape, dtype, causal, mode, seed):
    """q, k, v, dO on the card, and the plain forward's out and lse."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    out, lse = port_flash.flash_attention_fwd_plain(q, k, v, causal, None,
                                                    mode)
    return q, k, v, g, out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,causal,mode", [
    (torch.float32, (2, 12, 256, 64), True, None),
    (torch.float32, (2, 4, 128, 64), False, None),
    (torch.float32, (2, 4, 128, 64), True, 1),
    (torch.float32, (2, 4, 128, 64), True, 0),
    (torch.float32, (2, 4, 128, 64), True, -1),
    (torch.float32, (1, 3, 48, 16), True, None),
    (torch.float32, (1, 2, 100, 128), True, None),
    (torch.bfloat16, (2, 12, 256, 64), True, None),
    # S off the 64-row own tiles and the 32/64-row streamed tiles
    (torch.float32, (1, 2, 200, 64), True, None),
    (torch.float32, (1, 2, 1000, 64), False, None),
    (torch.float32, (1, 2, 1000, 64), True, None),
    # D padded up to the instantiation's 32/64/128 (zero-filled columns)
    (torch.float32, (1, 2, 96, 24), True, None),
    (torch.float32, (1, 2, 130, 80), True, None),
    (torch.float32, (1, 2, 256, 128), False, None),
    (torch.bfloat16, (1, 2, 200, 80), True, None),
    # S smaller than one tile; a D off the 16-byte copies
    (torch.float32, (1, 2, 20, 64), True, None),
    (torch.float32, (1, 3, 7, 5), True, None),
    (torch.bfloat16, (2, 4, 128, 64), False, None),
    (torch.bfloat16, (2, 4, 128, 64), True, 1),
])
def test_flash_bwd_kernels_match_plain_on_card(dtype, shape, causal, mode):
    """K2 (dQ) and K3 (dK/dV) through the routing wrapper against the plain
    backward on the same out and lse, one launch each: f32 within rtol
    1e-4, atol 1e-5 (3xTF32 tensor-core products summed in another order
    than one dense f32 product); bf16 within one bf16 step (rtol 2^-7,
    atol 1e-3: the outputs round to bf16 from f32 sums of up to S terms)."""
    _need_gpu()
    q, k, v, g, out, lse = _bwd_inputs(shape, dtype, causal, mode, 5)
    delta = None
    if mode is not None:   # the ring passes delta in
        delta = port_flash.flash_delta(g, out) * 0.5
    before = dict(port_flash.LAUNCHES)
    got = port_flash.flash_attention_bwd(q, k, v, out, lse, g, causal, None,
                                         mode, delta)
    torch.cuda.synchronize()
    assert port_flash.LAUNCHES["flash_dq"] == before["flash_dq"] + 1
    assert port_flash.LAUNCHES["flash_dkv"] == before["flash_dkv"] + 1
    want = port_flash.flash_attention_bwd_plain(q, k, v, out, lse, g, causal,
                                                None, mode, delta)
    rtol, atol = (2 ** -7, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,causal", [
    (torch.float32, (2, 12, 512, 64), True),
    (torch.bfloat16, (2, 12, 512, 64), True),
    (torch.float32, (1, 2, 200, 128), False),
])
def test_flash_bwd_kernels_bitwise_from_run_to_run(dtype, shape, causal):
    """Each block owns its output tile and nothing is added atomically: two
    launches on the same inputs give bitwise-equal dq, dk and dv."""
    _need_gpu()
    q, k, v, g, out, lse = _bwd_inputs(shape, dtype, causal, None, 7)
    delta = port_flash.flash_delta(g, out)
    args = (q, k, v, g, lse, delta, causal)
    first = port_flash.flash_bwd_cuda(*args)
    second = port_flash.flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_function_backward_on_card_gpt_small_shape():
    """The autograd Function at a gpt_small-shaped head layout (B=1, 12
    heads, S=1024, d 64, causal): kernels (one launch of each of K1, K2,
    K3) against the same Function with the plain versions."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (1, 12, 1024, 64)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(4))
    grads = {}
    for plain in (False, True):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = dict(port_flash.LAUNCHES)
        out = port_flash.flash_attention(*ins, True, None, None, plain)
        out.backward(g)
        torch.cuda.synchronize()
        n = 0 if plain else 1
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            assert port_flash.LAUNCHES[name] == before[name] + n, name
        grads[plain] = [t.grad for t in ins]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
