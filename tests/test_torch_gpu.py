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
@pytest.mark.parametrize("dtype,shape,local_size", [
    (torch.float32, (4, 96, 55, 55), 5),      # norm1
    (torch.bfloat16, (4, 256, 27, 27), 5),    # norm2
    # the window's edges and the tile's: one channel, the widest window,
    # an even window, C below the halo, one position, a C off the chunks
    (torch.float32, (2, 16, 9, 9), 1),
    (torch.float32, (2, 70, 5, 7), 32),
    (torch.float32, (3, 37, 9, 9), 4),
    (torch.float32, (3, 2, 11, 11), 5),
    (torch.float32, (5, 96, 1, 1), 5),
    (torch.float32, (1, 131, 13, 13), 5),
    (torch.bfloat16, (1, 131, 13, 13), 7),
])
def test_lrn_fwd_kernel_bitwise_equal_to_plain_on_card(dtype, shape,
                                                       local_size):
    """K4 computes each element as the plain forward does (squares summed
    in ascending order from zero, explicitly rounded, the same powf):
    bitwise equal to it, and a second launch to the first."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    got = port_lrn.lrn_fwd_cuda(x, local_size, 1e-4, 0.75, 1.0)
    again = port_lrn.lrn_fwd_cuda(x, local_size, 1e-4, 0.75, 1.0)
    want = port_lrn.lrn_across_channels_plain(x, local_size, 1e-4, 0.75,
                                              1.0)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_lrn_fwd_kernel_attrs_on_card():
    """K4's tile at norm1's and norm2's chunks (two of 48 channels, four
    of 64) spills nothing and keeps at least four blocks an SM."""
    _need_gpu()
    for c, chunk in ((96, 48), (256, 64)):
        a = port_lrn.lrn_fwd_kernel_attrs(torch.float32, c, 5)
        assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 4, a
        assert a["chunk"] == chunk, a


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,k,s,p,method", [
    (torch.float32, (4, 96, 55, 55), 3, 2, 0, "max"),
    (torch.bfloat16, (4, 256, 13, 13), 3, 2, 0, "max"),
    (torch.float32, (2, 16, 13, 13), 2, 2, 1, "ave"),
    # a plane of several bands
    (torch.float32, (1, 2, 600, 600), 3, 2, 0, "max"),
    # GoogLeNet's inception pool, loss-branch and final pools
    (torch.float32, (2, 192, 28, 28), 3, 1, 1, "max"),
    (torch.float32, (2, 512, 14, 14), 5, 3, 0, "ave"),
    (torch.float32, (2, 1024, 7, 7), 7, 1, 0, "ave"),
    (torch.bfloat16, (2, 64, 14, 14), 5, 3, 0, "ave"),
    # inputs that no window covers; CIFAR's and LeNet's pools
    (torch.float32, (2, 16, 13, 13), 2, 3, 0, "max"),
    (torch.float32, (2, 32, 32, 32), 3, 2, 0, "max"),
    (torch.float32, (2, 32, 16, 16), 3, 2, 0, "ave"),
    (torch.float32, (2, 20, 24, 24), 2, 2, 0, "max"),
    # global MAX pooling (one window of 169 taps) and a wide stride-1
    # window: each element's slots are its covering windows, not its taps
    (torch.float32, (2, 256, 13, 13), 13, 1, 0, "max"),
    (torch.bfloat16, (2, 64, 15, 14), 12, 1, 0, "max"),
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
@pytest.mark.parametrize("pad", [0, 1])
def test_pool_bwd_kernel_minus_inf_rows_on_card(pad):
    """Rows and a whole plane of -inf: a window with nothing above -inf
    keeps flat index 0 of the padded plane, so window (0, 0) sends its
    cotangent to input (0, 0) without padding and drops it with; bitwise
    equal to the plain version, and a second launch to the first."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 8, 27, 27), generator=gen, device="cuda")
    x[:, :, :3] = -float("inf")
    x[0, 1] = -float("inf")
    x[1, 2, 5] = float("nan")
    geom = ((3, 3), (2, 2), (pad, pad))
    y = port_pool.pool_forward(x, *geom, "max")
    g = torch.randn(y.shape, generator=gen, device="cuda")
    got = port_pool.pool_bwd_cuda(x, g, *geom, "max")
    again = port_pool.pool_bwd_cuda(x, g, *geom, "max")
    want = port_pool.pool_bwd_plain(x, g, *geom, "max")
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert got[0, 1, 0, 0] == (g[0, 1, 0, 0] if pad == 0 else 0)


@pytest.mark.gpu
def test_pool_bwd_kernel_attrs_on_card():
    """K6 at AlexNet's pool1/pool2/pool5 band plans spills nothing and keeps
    at least four blocks an SM."""
    _need_gpu()
    for shape in ((256, 96, 55, 55), (256, 256, 27, 27), (256, 256, 13, 13)):
        a = port_pool.pool_bwd_kernel_attrs(torch.float32, "max", shape,
                                            (3, 3), (2, 2), (0, 0))
        assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 4, a


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


def _byte_lmdb(path, n=40, shape=(3, 20, 20), seed=0):
    import numpy as np
    from poseidon_tpu_torch.data.lmdb_reader import LMDBWriter
    from poseidon_tpu_torch.proto import wire
    rs = np.random.RandomState(seed)
    w = LMDBWriter(path)
    for i in range(n):
        w.put(f"{i:08d}".encode(), wire.encode_datum(wire.Datum(
            *shape, data=rs.randint(0, 256, size=shape).astype(np.uint8)
            .tobytes(), label=int(rs.randint(10)))))
    w.close()


def _data_layer(path, tp):
    from poseidon_tpu_torch.proto.messages import load_net_from_string
    return load_net_from_string(
        f'layers {{ name: "d" type: DATA top: "data" top: "label" '
        f'data_param {{ source: "{path}" batch_size: 6 backend: LMDB }} '
        f'transform_param {{ {tp} }} }}').layers[0]


@pytest.mark.gpu
def test_cuda_prefetcher_batches_are_the_inline_batches(tmp_path):
    """The CUDA prefetch stage (pinned ring of depth + 1 = 3 slots, its own
    stream, an event per batch) over 9 batches, the ring wrapping three
    times: each batch bitwise the inline copy of the same pipeline's."""
    _need_gpu()
    from poseidon_tpu_torch.data.pipeline import (BatchPipeline,
                                                  DevicePrefetcher,
                                                  place_batch)
    path = str(tmp_path / "lmdb")
    _byte_lmdb(path)
    lp = _data_layer(path, "crop_size: 16 mirror: true mean_value: 100 "
                           "scale: 0.5")
    pipes = [BatchPipeline(lp, "TRAIN", 6, seed=1) for _ in range(2)]
    feed = DevicePrefetcher([pipes[0]], "cuda", depth=2)
    try:
        assert not feed.passthrough
        for _ in range(9):
            got = next(feed)
            # the consumer's stream works on the batch before the check
            got = {k: v * 1 for k, v in got.items()}
            want = place_batch(next(pipes[1]), torch.device("cuda"))
            torch.cuda.synchronize()
            for k in want:
                assert got[k].is_cuda and torch.equal(got[k], want[k]), k
        assert feed.staged >= 9
    finally:
        feed.close()
        for p in pipes:
            p.close()


@pytest.mark.gpu
def test_device_transform_on_card_is_the_native_f32_batch(tmp_path):
    _need_gpu()
    from poseidon_tpu_torch.data.pipeline import BatchPipeline
    from poseidon_tpu_torch.runtime.engine import device_input_transform
    path = str(tmp_path / "lmdb")
    _byte_lmdb(path, seed=2)
    lp = _data_layer(path, "crop_size: 16 mirror: true mean_value: 104 "
                           "mean_value: 117 mean_value: 123 "
                           "scale: 0.017")
    u8 = BatchPipeline(lp, "TRAIN", 6, seed=3, device_transform=True)
    f32 = BatchPipeline(lp, "TRAIN", 6, seed=3)
    try:
        assert u8.route == "native-u8"
        transform = device_input_transform([u8], torch.device("cuda"))
        for _ in range(3):
            got = transform({k: torch.from_numpy(v).cuda()
                             for k, v in next(u8).items()})
            want = torch.from_numpy(next(f32)["data"]).cuda()
            assert torch.equal(got["data"], want)
    finally:
        u8.close()
        f32.close()


_TOPK_NET = """
name: "TopkNet"
input: "data" input_dim: 8 input_dim: 3 input_dim: 23 input_dim: 23
input: "label" input_dim: 8 input_dim: 1 input_dim: 1 input_dim: 1
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.1 } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 } }
layers { name: "pool1" type: POOLING bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool1" top: "fc6"
  inner_product_param { num_output: 64
    weight_filler { type: "gaussian" std: 0.05 } } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "fc8" type: INNER_PRODUCT bottom: "fc6" top: "fc8"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "loss" }
"""


def _topk_run(comm, steps=3):
    """``steps`` TOPK-or-DENSE steps of a small LRN + MAX-pool net on the
    card, one process; (losses, params, momentum, state)."""
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.proto.messages import (SolverParameter,
                                                   load_net_from_string)
    net = Net(load_net_from_string(_TOPK_NET), "TRAIN", device="cuda")
    params = net.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"data": torch.randn(8, 3, 23, 23, generator=gen,
                                 device="cuda"),
             "label": torch.randint(0, 10, (8, 1, 1, 1), generator=gen,
                                    device="cuda").float()}
    step = T.build_train_step(net, SolverParameter(
        base_lr=0.01, momentum=0.9, weight_decay=5e-4), None, comm)
    params, state = step.load(params, T.init_train_state(params, comm, 1))
    losses = []
    for _ in range(steps):
        params, state, m = step.step(params, state, batch)
        losses.append(float(m["loss"]))
    clone = lambda t: {l: {k: v.clone() for k, v in d.items()}  # noqa: E731
                       for l, d in t.items()}
    return losses, clone(params), clone(state.solver.history), state


@pytest.mark.gpu
def test_topk_at_fraction_one_is_dense_on_card():
    """TOPK on every layer at fraction 1 sends everything: its steps are
    the DENSE steps, bitwise (cuDNN deterministic), the residual zero."""
    _need_gpu()
    from poseidon_tpu_torch.parallel.strategies import CommConfig
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        d_losses, d_params, d_hist, _ = _topk_run(CommConfig())
        t_losses, t_params, t_hist, state = _topk_run(CommConfig(
            default_strategy="topk", topk_fraction=1.0))
    finally:
        torch.backends.cudnn.deterministic = det
    assert t_losses == d_losses
    for a, b in ((t_params, d_params), (t_hist, d_hist)):
        for l in a:
            for k in a[l]:
                assert torch.equal(a[l][k], b[l][k]), (l, k)
    assert not any(bool(v.any()) for lv in state.comm_error.values()
                   for v in lv.values())


@pytest.mark.gpu
@pytest.mark.parametrize("block", [None, 128])
def test_topk_conserves_gradient_mass_on_card(block):
    """TOPK on fc6 and fc8 at fraction 0.01 on the card: every leaf, every
    step, sent + residual = g + residual before (bitwise), at most k sent,
    a nonzero residual; K4, K6, K5 and K7 launched once each a step."""
    _need_gpu()
    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.parallel.strategies import CommConfig
    records, compress = [], T.topk_compress

    def checking(g, fraction, error, *a, **kw):
        assert g.is_cuda and error.is_cuda
        sent, resid = compress(g, fraction, error, *a, **kw)
        records.append((bool(torch.equal(sent + resid, g + error)),
                        int(torch.count_nonzero(sent)),
                        max(1, int(g.numel() * fraction)),
                        bool(resid.abs().max() > 0)))
        return sent, resid

    before = {**port_lrn.LAUNCHES, **port_pool.LAUNCHES,
              **port_sgd.LAUNCHES}
    T.topk_compress = checking
    try:
        losses, *_ = _topk_run(CommConfig(
            layer_strategies={"fc6": "topk", "fc8": "topk"},
            topk_block=block))
    finally:
        T.topk_compress = compress
    after = {**port_lrn.LAUNCHES, **port_pool.LAUNCHES, **port_sgd.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == {
        "lrn_fwd": 3, "lrn_bwd": 3, "pool_bwd": 3, "sgd_update": 3,
        # the channels-last kernels: none on this NCHW path
        "lrn_fwd_nhwc": 0, "lrn_bwd_nhwc": 0, "pool_bwd_nhwc": 0}
    assert len(records) == 4 * 3
    assert all(c and sent <= k and nz for c, sent, k, nz in records)
    assert all(map(lambda x: x == x and abs(x) < 1e4, losses))


# --------------------------------------------------------------------------- #
# the channels-last (NHWC) kernels: K4, K5 and K6 on channels-last tensors
# --------------------------------------------------------------------------- #

_NHWC_LRN_CASES = [
    (torch.float32, (4, 96, 55, 55), 5),
    (torch.bfloat16, (4, 96, 55, 55), 5),
    (torch.float32, (4, 256, 27, 27), 5),
    (torch.bfloat16, (4, 256, 27, 27), 5),
    (torch.float32, (3, 37, 9, 9), 4),
    # the window's edges, C below the halo, one position (both layouts at
    # once: routed as NCHW), batch 1 with C = 131, a C past one warp's
    # multiple, the widest window
    (torch.float32, (2, 16, 9, 9), 1),
    (torch.float32, (2, 70, 5, 7), 32),
    (torch.float32, (3, 2, 11, 11), 5),
    (torch.float32, (5, 96, 1, 1), 5),
    (torch.float32, (1, 131, 13, 13), 5),
    (torch.bfloat16, (1, 131, 13, 13), 7),
    (torch.float32, (2, 1000, 3, 3), 5),
]


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,local_size", _NHWC_LRN_CASES)
def test_lrn_nhwc_kernels_bitwise_equal_to_plain_on_card(dtype, shape,
                                                         local_size):
    """K4-NHWC and K5-NHWC through the autograd Function on channels-last
    tensors: bitwise equal to the plain versions on the same tensors, the
    output and the gradient channels-last, and no NCHW kernel launched."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = _channels_last(torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype))
    g = _channels_last(torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype))
    both = x.is_contiguous()   # one position: NCHW and NHWC at once
    before = dict(port_lrn.LAUNCHES)
    xr = x.clone().requires_grad_(True)
    y = port_lrn.lrn_across_channels(xr, local_size, 1e-4, 0.75, 1.0)
    y.backward(g)
    torch.cuda.synchronize()
    after = port_lrn.LAUNCHES
    fwd, bwd = ("lrn_fwd", "lrn_bwd") if both else ("lrn_fwd_nhwc",
                                                    "lrn_bwd_nhwc")
    assert after[fwd] == before[fwd] + 1 and after[bwd] == before[bwd] + 1
    assert sum(after.values()) == sum(before.values()) + 2
    if not both:
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert xr.grad.is_contiguous(memory_format=torch.channels_last)
    want_y = port_lrn.lrn_across_channels_plain(x, local_size, 1e-4, 0.75,
                                                1.0)
    want_dx = port_lrn.lrn_bwd_plain(x, g, local_size, 1e-4, 0.75, 1.0)
    assert torch.equal(y, want_y)
    assert torch.equal(xr.grad, want_dx)
    if not both:
        # a second launch gives the same bits
        assert torch.equal(port_lrn.lrn_fwd_nhwc_cuda(
            x, local_size, 1e-4, 0.75, 1.0), want_y)


@pytest.mark.gpu
def test_lrn_nhwc_refuses_too_many_channels_on_card():
    _need_gpu()
    x = _channels_last(torch.zeros(1, port_lrn.MAX_NHWC_CHANNELS + 1, 2, 2,
                                   device="cuda"))
    with pytest.raises(ValueError, match="MAX_NHWC|at most"):
        port_lrn.lrn_fwd_nhwc_cuda(x, 5, 1e-4, 0.75, 1.0)


_NHWC_POOL_CASES = [
    (torch.float32, (4, 96, 55, 55), (3, 3), (2, 2), (0, 0), "max"),
    (torch.bfloat16, (4, 96, 55, 55), (3, 3), (2, 2), (0, 0), "max"),
    (torch.float32, (4, 256, 27, 27), (3, 3), (2, 2), (0, 0), "max"),
    (torch.float32, (4, 256, 13, 13), (3, 3), (2, 2), (0, 0), "max"),
    (torch.bfloat16, (4, 256, 13, 13), (3, 3), (2, 2), (0, 0), "max"),
    (torch.float32, (2, 32, 17, 17), (3, 3), (2, 2), (1, 1), "ave"),
    (torch.bfloat16, (2, 32, 17, 17), (3, 3), (2, 2), (1, 1), "ave"),
    (torch.float32, (2, 64, 28, 28), (3, 3), (1, 1), (1, 1), "max"),
    (torch.float32, (2, 40, 14, 14), (5, 5), (3, 3), (0, 0), "ave"),
    (torch.float32, (2, 24, 7, 7), (7, 7), (1, 1), (0, 0), "ave"),
    # batch 1, C = 2, a stride past the window, a global pool, several
    # bands of a wide plane, a C off the 32-channel chunks
    (torch.float32, (1, 2, 12, 12), (3, 3), (2, 2), (0, 0), "max"),
    (torch.float32, (2, 3, 10, 10), (2, 2), (3, 3), (0, 0), "max"),
    (torch.float32, (2, 16, 13, 13), (13, 13), (1, 1), (0, 0), "max"),
    (torch.float32, (1, 32, 90, 300), (3, 3), (2, 2), (0, 0), "max"),
    (torch.float32, (2, 45, 11, 11), (3, 3), (2, 2), (1, 1), "max"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,k,s,p,method", _NHWC_POOL_CASES)
def test_pool_nhwc_kernel_bitwise_equal_to_plain_on_card(dtype, shape, k, s,
                                                         p, method):
    """K6-NHWC through the autograd Function on channels-last tensors:
    bitwise equal to the plain backward on the same tensors, dx
    channels-last, no NCHW kernel launched; a second launch equal."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = _channels_last(torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype))
    oh = port_pool.pool_out_size(shape[2], k[0], s[0], p[0])
    ow = port_pool.pool_out_size(shape[3], k[1], s[1], p[1])
    g = _channels_last(torch.randn((shape[0], shape[1], oh, ow),
                                   generator=gen, device="cuda").to(dtype))
    fn = port_pool.max_pool if method == "max" else port_pool.ave_pool
    before = dict(port_pool.LAUNCHES)
    xr = x.clone().requires_grad_(True)
    y = fn(xr, k, s, p)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y.backward(g)
    torch.cuda.synchronize()
    assert port_pool.LAUNCHES["pool_bwd_nhwc"] == \
        before["pool_bwd_nhwc"] + 1
    assert port_pool.LAUNCHES["pool_bwd"] == before["pool_bwd"]
    assert xr.grad.is_contiguous(memory_format=torch.channels_last)
    want = port_pool.pool_bwd_plain(x, g, k, s, p, method)
    assert torch.equal(xr.grad, want)
    again = port_pool.pool_bwd_nhwc_cuda(x, g, k, s, p, method)
    assert torch.equal(again, xr.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [0, 1])
def test_pool_nhwc_kernel_minus_inf_rows_and_ties_on_card(pad):
    """Rows and a whole plane of -inf (a window of nothing above -inf keeps
    flat index 0) and a constant plane (first max wins), channels-last."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((2, 40, 11, 11), generator=gen, device="cuda")
    x[0, :, :4] = -float("inf")
    x[1, 3] = -float("inf")
    x[1, 5] = 0.25
    x = _channels_last(x)
    oh = port_pool.pool_out_size(11, 3, 2, pad)
    g = _channels_last(torch.randn((2, 40, oh, oh), generator=gen,
                                   device="cuda"))
    got = port_pool.pool_bwd_nhwc_cuda(x, g, (3, 3), (2, 2), (pad, pad),
                                       "max")
    torch.cuda.synchronize()
    want = port_pool.pool_bwd_plain(x, g, (3, 3), (2, 2), (pad, pad), "max")
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# K4-NHWC and K5-NHWC (registers and warp shuffles) and K6-NHWC (one launch
# over shared-memory bands): vector widths, alignment, bands, no scratch
# --------------------------------------------------------------------------- #

def _nhwc_pool_inputs(shape, k, s, p, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _channels_last(torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype))
    oh = port_pool.pool_out_size(shape[2], k[0], s[0], p[0])
    ow = port_pool.pool_out_size(shape[3], k[1], s[1], p[1])
    g = _channels_last(torch.randn((shape[0], shape[1], oh, ow),
                                   generator=gen, device="cuda").to(dtype))
    return x, g


def _lrn_fwd_nhwc_bitwise(x, local_size=5):
    """K4-NHWC on x, one launch, bitwise equal to the plain version."""
    before = port_lrn.LAUNCHES["lrn_fwd_nhwc"]
    y = port_lrn.lrn_fwd_nhwc_cuda(x, local_size, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert port_lrn.LAUNCHES["lrn_fwd_nhwc"] == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, port_lrn.lrn_across_channels_plain(
        x, local_size, 1e-4, 0.75, 1.0))
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["bwd", "fwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [2, 3, 131])
def test_nhwc_bwd_kernels_c_off_the_vector_on_card(dtype, channels,
                                                   direction):
    """C not a multiple of the 16-byte vector: K5-NHWC and K6-NHWC (MAX and
    AVE), and K4-NHWC (``fwd``), take a narrower vector in the same kernel,
    bitwise equal to the plain versions."""
    _need_gpu()
    from poseidon_tpu_torch.ops.vector import vector_width
    shape = (3, channels, 15, 13)
    size = torch.empty((), dtype=dtype).element_size()
    assert vector_width(channels, size) < 16 // size
    x, g = _nhwc_pool_inputs(shape, (3, 3), (2, 2), (1, 1), dtype, 31)
    if direction == "fwd":
        _lrn_fwd_nhwc_bitwise(x)
        return
    for method in ("max", "ave"):
        got = port_pool.pool_bwd_nhwc_cuda(x, g, (3, 3), (2, 2), (1, 1),
                                           method)
        torch.cuda.synchronize()
        assert torch.equal(got, port_pool.pool_bwd_plain(
            x, g, (3, 3), (2, 2), (1, 1), method))
    gl = _channels_last(torch.randn_like(x))
    dx = port_lrn.lrn_bwd_nhwc_cuda(x, gl, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(dx, port_lrn.lrn_bwd_plain(x, gl, 5, 1e-4, 0.75, 1.0))


def _offset_channels_last(shape, dtype, offset, gen):
    """A channels-last (N, C, H, W) tensor starting `offset` elements into
    its storage."""
    n, c, h, w = shape
    buf = torch.randn(n * c * h * w + offset, generator=gen,
                      device="cuda").to(dtype)
    return buf[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["bwd", "fwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["batch slice", "storage offset"])
def test_nhwc_bwd_kernels_off_16_byte_alignment_on_card(dtype, kind,
                                                        direction):
    """x, g whose data_ptr is not 16-byte aligned (2 or 4 bytes off): a
    channels-last slice of a larger batch (C = 6) and a view one element
    into its storage (C = 96). The kernels (``fwd``: K4-NHWC) take the
    vector the pointers allow, bitwise equal to the plain versions."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(32)
    k, s, p = (3, 3), (2, 2), (0, 0)
    if kind == "batch slice":
        # an image of x is 6 * 121 elements, of g 6 * 25: both off 16 bytes
        x = _channels_last(torch.randn((3, 6, 11, 11), generator=gen,
                                       device="cuda").to(dtype))[1:]
        gl = _channels_last(torch.randn((3, 6, 11, 11), generator=gen,
                                        device="cuda").to(dtype))[1:]
        g = _channels_last(torch.randn((3, 6, 5, 5), generator=gen,
                                       device="cuda").to(dtype))[1:]
    else:
        x = _offset_channels_last((2, 96, 11, 11), dtype, 1, gen)
        gl = _offset_channels_last((2, 96, 11, 11), dtype, 1, gen)
        g = _offset_channels_last((2, 96, 5, 5), dtype, 1, gen)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    if direction == "fwd":
        _lrn_fwd_nhwc_bitwise(x)
        return
    got = port_pool.pool_bwd_nhwc_cuda(x, g, k, s, p, "max")
    dx = port_lrn.lrn_bwd_nhwc_cuda(x, gl, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(got, port_pool.pool_bwd_plain(x, g, k, s, p, "max"))
    assert torch.equal(dx, port_lrn.lrn_bwd_plain(x, gl, 5, 1e-4, 0.75, 1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["max", "ave"])
def test_pool_nhwc_band_boundary_inside_a_window_row_on_card(dtype, method):
    """A plan of several bands whose boundaries fall inside a window row
    (the row is covered by two windows, computed by both blocks): bitwise
    equal to the plain version."""
    _need_gpu()
    shape, k, s, p = (2, 64, 121, 57), (3, 3), (2, 2), (1, 1)
    x, g = _nhwc_pool_inputs(shape, k, s, p, dtype, 33)
    oh = port_pool.pool_out_size(121, 3, 2, 1)
    ow = port_pool.pool_out_size(57, 3, 2, 1)
    plan = port_pool.pool_nhwc_plan(2, 64, 121, 57, oh, ow, k, s, p,
                                    method == "max", x.element_size(),
                                    16 // x.element_size())
    assert plan.n_bands > 1
    inside = [j * plan.band_rows for j in range(1, plan.n_bands)
              if port_pool.pool_band(121, oh, 3, 2, 1, plan.band_rows, j)
              .oy0 * 2 - 1 < j * plan.band_rows]
    assert inside, plan
    got = port_pool.pool_bwd_nhwc_cuda(x, g, k, s, p, method)
    torch.cuda.synchronize()
    assert torch.equal(got, port_pool.pool_bwd_plain(x, g, k, s, p, method))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["max", "ave"])
def test_pool_nhwc_allocates_no_scratch_on_card(method):
    """One call allocates dx and nothing else: the memory allocated across
    the call is dx's bytes (as the caching allocator rounds them)."""
    _need_gpu()
    x, g = _nhwc_pool_inputs((8, 96, 55, 55), (3, 3), (2, 2), (0, 0),
                             torch.bfloat16, 34)
    port_pool.pool_bwd_nhwc_cuda(x, g, (3, 3), (2, 2), (0, 0), method)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx = port_pool.pool_bwd_nhwc_cuda(x, g, (3, 3), (2, 2), (0, 0), method)
    torch.cuda.synchronize()
    dx_bytes = -(-dx.numel() * dx.element_size() // 512) * 512
    assert torch.cuda.max_memory_allocated() - before == dx_bytes
    assert torch.cuda.memory_allocated() - before == dx_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["bwd", "fwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhwc_bwd_kernels_bitwise_from_run_to_run_on_card(dtype, direction):
    """Two launches of K5-NHWC and of K6-NHWC (``fwd``: of K4-NHWC, at each
    lane width) on the same inputs give the same bits, at norm1's and
    pool1's widths."""
    _need_gpu()
    x, g = _nhwc_pool_inputs((8, 96, 55, 55), (3, 3), (2, 2), (0, 0), dtype,
                             35)
    if direction == "fwd":
        want = _lrn_fwd_nhwc_bitwise(x)
        for lanes in (1, 2, 4, 8):
            got = port_lrn.lrn_fwd_nhwc_cuda(x, 5, 1e-4, 0.75, 1.0,
                                             lane_channels=lanes)
            torch.cuda.synchronize()
            assert torch.equal(got, want), lanes
        return
    gl = _channels_last(torch.randn_like(x))
    first = (port_lrn.lrn_bwd_nhwc_cuda(x, gl, 5, 1e-4, 0.75, 1.0),
             port_pool.pool_bwd_nhwc_cuda(x, g, (3, 3), (2, 2), (0, 0),
                                          "max"))
    second = (port_lrn.lrn_bwd_nhwc_cuda(x, gl, 5, 1e-4, 0.75, 1.0),
              port_pool.pool_bwd_nhwc_cuda(x, g, (3, 3), (2, 2), (0, 0),
                                           "max"))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(first[0], port_lrn.lrn_bwd_plain(x, gl, 5, 1e-4,
                                                        0.75, 1.0))


@pytest.mark.gpu
def test_nhwc_bwd_kernel_attrs_on_card():
    """K4-NHWC and K5-NHWC use no shared memory; K6-NHWC's plan fits its
    budget; no spills at AlexNet's widths (K4-NHWC at every lane width
    within 16 bytes)."""
    _need_gpu()
    for dtype, widths in ((torch.float32, (1, 2, 4)),
                          (torch.bfloat16, (1, 2, 4, 8))):
        for vec in widths:
            a = port_lrn.lrn_fwd_nhwc_kernel_attrs(dtype, vec, 5)
            assert a["static_smem_bytes"] == a["dynamic_smem_bytes"] == 0
            assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1, (
                dtype, vec, a)
        a = port_lrn.lrn_bwd_nhwc_kernel_attrs(
            dtype, port_lrn.MAX_NHWC_LANE_CHANNELS, 5)
        assert a["static_smem_bytes"] == a["dynamic_smem_bytes"] == 0
        assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1
        a = port_pool.pool_bwd_nhwc_kernel_attrs(
            dtype, "max", (256, 96, 55, 55), (3, 3), (2, 2), (0, 0))
        assert a["dynamic_smem_bytes"] <= port_pool.POOL_NHWC_SMEM_BUDGET
        assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1


_LRN_FWD_NHWC_EDGES = [
    # one pixel; C = 1 and C = 2 at n = 5; a C off the lane widths
    (torch.float32, (1, 96, 1, 1), 5),
    (torch.bfloat16, (1, 256, 1, 1), 5),
    (torch.float32, (3, 1, 7, 9), 5),
    (torch.bfloat16, (3, 1, 7, 9), 5),
    (torch.float32, (3, 2, 7, 9), 5),
    (torch.bfloat16, (3, 2, 7, 9), 5),
    # n_pixels not a multiple of the run (pixels_per_warp: 16 pixels a run
    # of norm1's width in f32, 32 in bf16, 2 at C = 131, 4 at a window of
    # 7 with C = 96), the runs' last one cut short
    (torch.float32, (29, 96, 55, 55), 5),
    (torch.bfloat16, (57, 96, 55, 55), 5),
    (torch.float32, (1, 131, 251, 257), 5),
    (torch.bfloat16, (3, 96, 89, 83), 7),
    (torch.float32, (2, 70, 21, 23), 32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,local_size", _LRN_FWD_NHWC_EDGES)
def test_lrn_fwd_nhwc_edges_on_card(dtype, shape, local_size):
    """K4-NHWC at its edges, called directly on channels-last tensors:
    bitwise equal to the plain version, one launch."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(36)
    x = _channels_last(torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype))
    _lrn_fwd_nhwc_bitwise(x, local_size)


@pytest.mark.gpu
def test_lrn_fwd_nhwc_entry_refuses_a_width_off_c_or_the_pointers():
    """The C entry refuses a lane width that does not divide C, that a
    pointer is not aligned to, or that passes 16 bytes, and launches
    nothing."""
    _need_gpu()
    fn = port_lrn._lib("lrn_fwd", port_lrn._NHWC_FWD_ARGS,
                       entry="poseidon_lrn_nhwc_fwd")
    buf = torch.zeros(2 * 96 * 9 + 1, device="cuda")
    y = torch.zeros_like(buf)
    stream = torch.cuda.current_stream().cuda_stream

    def call(x_ptr, dtype, channels, vec):
        return fn(x_ptr, y.data_ptr(), dtype, 18 * 96 // channels, channels,
                  vec, 5, 1e-4 / 5, 0.75, 1.0, stream)

    assert call(buf.data_ptr(), 0, 96, 4) == 0
    assert call(buf.data_ptr(), 0, 6, 4) != 0          # 4 does not divide 6
    assert call(buf.data_ptr() + 4, 0, 96, 4) != 0     # x 4 bytes off
    assert call(buf.data_ptr() + 4, 0, 96, 1) == 0
    assert call(buf.data_ptr(), 0, 96, 8) != 0         # 32 bytes of f32
    assert call(buf.data_ptr(), 1, 96, 8) == 0         # 16 bytes of bf16
    assert call(buf.data_ptr(), 0, 96, 3) != 0         # not a power of two
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_fwd_nhwc_allocates_no_scratch_on_card(dtype):
    """One call allocates y and nothing else: the memory allocated across
    the call is y's bytes (as the caching allocator rounds them)."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(37)
    x = _channels_last(torch.randn((8, 96, 55, 55), generator=gen,
                                   device="cuda").to(dtype))
    port_lrn.lrn_fwd_nhwc_cuda(x, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = port_lrn.lrn_fwd_nhwc_cuda(x, 5, 1e-4, 0.75, 1.0)
    torch.cuda.synchronize()
    y_bytes = -(-y.numel() * y.element_size() // 512) * 512
    assert torch.cuda.max_memory_allocated() - before == y_bytes
    assert torch.cuda.memory_allocated() - before == y_bytes


# --------------------------------------------------------------------- #
# SSP and the async tier's arena copies on the card

_SSP_NET = """
name: "SSPTiny"
layers { name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 3 height: 19 width: 19 } }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "norm1" type: LRN bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layers { name: "ip1" type: INNER_PRODUCT bottom: "norm1" top: "ip1"
  inner_product_param { num_output: 10
    weight_filler { type: "gaussian" std: 0.05 } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""


def _ssp_net_and_batch():
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net_from_string
    net = Net(load_net_from_string(_SSP_NET), "TRAIN", device="cuda",
              source_shapes={"data": (8, 3, 19, 19), "label": (8,)})
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"data": torch.randn(8, 3, 19, 19, generator=gen,
                                 device="cuda"),
             "label": torch.randint(0, 10, (8,), generator=gen,
                                    device="cuda").float()}
    return net, batch


def _solver():
    from poseidon_tpu_torch.proto.messages import SolverParameter
    return SolverParameter(base_lr=0.01, momentum=0.9, weight_decay=5e-4,
                           lr_policy="fixed")


@pytest.mark.gpu
def test_ssp_step_kernels_vs_plain_on_card():
    """The SSP step (staleness 1, two boundaries) with K4-K7 against the
    same steps with their plain versions, cuDNN deterministic."""
    _need_gpu()
    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.parallel.strategies import CommConfig
    net, batch = _ssp_net_and_batch()
    params0 = net.init(torch.Generator().manual_seed(1))
    step = T.SSPTrainStep(net, _solver(), 1, None, CommConfig())

    def run(plain):
        lrns = [l for l in net.layers if l.TYPE == "LRN"]
        pools = [l for l in net.layers if l.TYPE == "POOLING"]
        if plain:
            for l in lrns:
                l.across_channels = port_lrn.lrn_across_channels_reference
            for l in pools:
                l.pool = port_pool.max_pool_reference
            step.sgd_update = port_sgd.sgd_update_plain_
        try:
            anchor, st = step.load(params0, T.init_ssp_state(
                params0, 1, step.comm))
            for _ in range(4):
                anchor, st, m = step.step(anchor, st, batch)
            torch.cuda.synchronize()
            return ({l: {k: v.clone() for k, v in d.items()}
                     for l, d in anchor.items()}, float(m["loss"]))
        finally:
            for l in lrns:
                l.across_channels = port_lrn.lrn_across_channels
            for l in pools:
                l.pool = port_pool.max_pool
            step.sgd_update = port_sgd.sgd_update_

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = dict(port_sgd.LAUNCHES)
        got, loss_k = run(False)
        assert port_sgd.LAUNCHES["sgd_update"] == \
            before["sgd_update"] + 4
        want, loss_p = run(True)
    finally:
        torch.backends.cudnn.deterministic = det
    assert abs(loss_k - loss_p) <= 1e-6 + 1e-4 * abs(loss_p)
    for l in want:
        for k in want[l]:
            torch.testing.assert_close(got[l][k], want[l][k], rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.gpu
def test_arena_mirror_round_trip_is_bitwise_and_pinned_on_card():
    _need_gpu()
    import types

    from poseidon_tpu_torch.runtime.async_tier import ArenaMirror
    net, _ = _ssp_net_and_batch()
    arena = net.arena_layout()
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = torch.randn(arena.total, generator=gen, device="cuda")
    mirror = ArenaMirror(types.SimpleNamespace(arena=arena, flat_w=flat))
    assert mirror.host.is_pinned()
    host = mirror.d2h()
    assert torch.equal(torch.from_numpy(host), flat.cpu())
    new = host * 3.0 - 1.0
    ptr = flat.data_ptr()
    mirror.h2d(new)
    torch.cuda.synchronize()
    assert flat.data_ptr() == ptr
    assert torch.equal(flat.cpu(), torch.from_numpy(new))


@pytest.mark.gpu
def test_slice_arena_round_trip_is_bitwise_and_in_place_on_card():
    """The fabric leader's side of the arena (``SliceArena``) on a
    one-device step: the gather and the pinned D2H give the canonical
    flat bitwise; the H2D and the broadcast write a refresh into the
    step's own storage bitwise and hand back the live slice ids."""
    _need_gpu()
    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.runtime.async_tier import SliceArena
    net, _ = _ssp_net_and_batch()
    step = T.TrainStep(net, _solver())
    step.load_weights(net.init(torch.Generator().manual_seed(4)))
    arena = SliceArena(step, leader=True)
    assert arena.host.is_pinned()
    timings = {k: 0.0 for k in arena.phases}
    flat = arena.d2h(timings)
    assert torch.equal(torch.from_numpy(flat), step.flat_w.cpu())
    new = flat * 0.5 + 1.0
    ptr = step.flat_w.data_ptr()
    assert arena.h2d(new, timings, members=(3, 0)) == [0, 3]
    assert step.flat_w.data_ptr() == ptr
    assert torch.equal(step.flat_w.cpu(), torch.from_numpy(new))
    assert all(v >= 0.0 for v in timings.values())


@pytest.mark.gpu
def test_arena_refresh_in_place_feeds_the_forward_and_k7_on_card():
    """A refresh written into the arena by the tier's H2D keeps the
    storage (no new tensor) and the next step's forward and K7 read the
    refreshed weights: the step equals a step loaded with them."""
    _need_gpu()
    import types

    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.runtime.async_tier import ArenaMirror
    net, batch = _ssp_net_and_batch()
    params0 = net.init(torch.Generator().manual_seed(2))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = T.TrainStep(net, _solver())
        pa, sa = a.load(params0, T.init_train_state(params0))
        mirror = ArenaMirror(types.SimpleNamespace(arena=a.arena,
                                                   flat_w=a.flat_w))
        ptr = a.flat_w.data_ptr()
        refreshed = mirror.d2h() * 0.5
        mirror.h2d(refreshed)
        assert a.flat_w.data_ptr() == ptr
        before = port_sgd.LAUNCHES["sgd_update"]
        pa, sa, ma = a.step(a.params(), sa, batch)
        assert port_sgd.LAUNCHES["sgd_update"] == before + 1
        got = {l: {k: v.clone() for k, v in d.items()}
               for l, d in pa.items()}
        b = T.TrainStep(net, _solver())
        want_in = {l: {k: v.cuda() for k, v in d.items()} for l, d in
                   a.arena.unpack(torch.from_numpy(refreshed)).items()}
        pb, sb = b.load(want_in, T.init_train_state(want_in))
        pb, sb, mb = b.step(pb, sb, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    assert float(ma["loss"]) == float(mb["loss"])
    for l in got:
        for k in got[l]:
            assert torch.equal(got[l][k], pb[l][k]), f"{l}/{k}"


def _lenet_on(device, rows):
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples/mnist/lenet_train_test.prototxt")
    return Net(load_net(path), "TRAIN",
               device=device, source_shapes={"data": (rows, 1, 28, 28),
                                             "label": (rows,)})


@pytest.mark.gpu
@pytest.mark.parametrize("f", [2, 4])
def test_k7_on_fsdp_shards_bitwise_on_card(f):
    """K7 over each fsdp rank's shard of LeNet's aligned arena, with its
    shard-major multiplier segments, bitwise against the plain version;
    a vector off 16 bytes is refused (the step copies its shard into
    allocated buffers)."""
    _need_gpu()
    from poseidon_tpu_torch.parallel import spmd
    from poseidon_tpu_torch.proto.messages import SolverParameter
    layout = _lenet_on("cpu", 2).arena_layout(0.3, align=f)
    lr_all, dec_all = spmd.shard_mult_vectors(
        layout, SolverParameter(weight_decay=5e-4), f)
    n = layout.padded_total // f
    gen = torch.Generator(device="cuda").manual_seed(4)
    for fi in range(f):
        lr = torch.from_numpy(lr_all[fi * n:(fi + 1) * n].copy()).cuda()
        dec = torch.from_numpy(dec_all[fi * n:(fi + 1) * n].copy()).cuda()
        w, g, h = (torch.randn(n, generator=gen, device="cuda")
                   for _ in range(3))
        wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
        before = port_sgd.LAUNCHES["sgd_update"]
        port_sgd.sgd_update_(wk, g, hk, 0.01, lr, dec, 0.9)
        torch.cuda.synchronize()
        assert port_sgd.LAUNCHES["sgd_update"] == before + 1
        port_sgd.sgd_update_plain_(wp, g, hp, 0.01, lr, dec, 0.9)
        assert torch.equal(wk, wp) and torch.equal(hk, hp), fi
    buf = torch.zeros(1025, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_sgd.sgd_update_cuda_(buf[1:], buf[1:], buf[1:], 0.01, buf[1:],
                                  buf[1:], 0.9)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["tp2", "dp1,fsdp2,tp2"])
def test_k7_at_tp_step_lengths_bitwise_on_card(spec):
    """K7 over both flat buffers a tp rank's step updates (its arena, or
    the arena's fsdp shard, and its tp leaves; ``spmd.step_layouts``),
    each with its own multiplier vectors, bitwise against the plain
    version, one launch a call."""
    _need_gpu()
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.parallel import spmd
    from poseidon_tpu_torch.proto.messages import SolverParameter
    cfg = MeshConfig.parse(spec)
    net = _lenet_on("cpu", 2)
    sp = SolverParameter(weight_decay=5e-4)
    arena, _full, local = spmd.step_layouts(
        net, spmd.ShardingPlan.build(net, cfg), 0.3)
    f = cfg.fsdp
    n_sh = arena.padded_total // f
    lr_sh, dec_sh = spmd.shard_mult_vectors(arena, sp, f)
    vectors = [(lr_sh[:n_sh], dec_sh[:n_sh])]
    if local is not None:
        vectors.append(local.mult_vectors(sp.weight_decay))
    gen = torch.Generator(device="cuda").manual_seed(6)
    for lr_np, dec_np in vectors:
        lr = torch.from_numpy(lr_np.copy()).cuda()
        dec = torch.from_numpy(dec_np.copy()).cuda()
        w, g, h = (torch.randn(len(lr_np), generator=gen, device="cuda")
                   for _ in range(3))
        wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
        before = port_sgd.LAUNCHES["sgd_update"]
        port_sgd.sgd_update_(wk, g, hk, 0.01, lr, dec, 0.9)
        torch.cuda.synchronize()
        assert port_sgd.LAUNCHES["sgd_update"] == before + 1
        port_sgd.sgd_update_plain_(wp, g, hp, 0.01, lr, dec, 0.9)
        assert torch.equal(wk, wp) and torch.equal(hk, hp), len(lr_np)


def _fsdp2_pair_worker(rank, store, q):
    import numpy as np
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.parallel import spmd
    from poseidon_tpu_torch.parallel.strategies import CommConfig
    from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import SolverParameter
    from poseidon_tpu_torch.runtime import cluster
    torch.backends.cudnn.deterministic = True
    cfg = MeshConfig(fsdp=2)
    group = cluster.init_distributed(torch.device("cuda"), rank=rank,
                                     world=2, coordinator=f"file://{store}",
                                     mesh_cfg=cfg)
    try:
        out = {"backend": group.backend}
        rs = np.random.RandomState(0)
        xs = [torch.from_numpy(rs.randn(8, 1, 28, 28).astype(np.float32))
              for _ in range(3)]
        ys = [torch.from_numpy(rs.randint(0, 10, 8).astype(np.float32))
              for _ in range(3)]
        for shard in (True, False):
            net = _lenet_on(group.device, 4)
            params = net.init(torch.Generator().manual_seed(0))
            comm = CommConfig(bucket_mb=0.3)
            plan = spmd.ShardingPlan.build(net, cfg, comm,
                                           shard_params=shard)
            step = build_train_step(net, SolverParameter(
                base_lr=0.01, momentum=0.9, weight_decay=5e-4), group, comm,
                plan=plan)
            p, s = step.load(params, init_train_state(params, comm, 2))
            before = port_sgd.LAUNCHES["sgd_update"]
            for x, y in zip(xs, ys):
                p, s, _m = step.step(p, s, {
                    "data": x[rank * 4:(rank + 1) * 4].cuda(),
                    "label": y[rank * 4:(rank + 1) * 4].cuda()})
            torch.cuda.synchronize()
            cp, cs = step.export(p, s)
            out[shard] = ({f"{l}/{k}": v.cpu().numpy() for l, lv in cp.items()
                           for k, v in lv.items()},
                          port_sgd.LAUNCHES["sgd_update"] - before,
                          step.w_sh.numel() if step.w_sh is not None else 0,
                          step.arena.padded_total)
        q.put((rank, out))
    finally:
        group.close()


@pytest.mark.gpu
def test_gloo_fsdp2_pair_on_card(tmp_path):
    """Two fsdp2 ranks sharing the card over gloo (CUDA tensors through
    reduce-scatter and all-gather): the sharded arm bitwise to its
    replicated control and across ranks, K7 once a step over the
    padded_total / 2 shard."""
    _need_gpu()
    import numpy as np
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_fsdp2_pair_worker,
                         args=(r, str(tmp_path / "store"), q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert res[0]["backend"] == "gloo"
    sharded, launches, shard, padded = res[0][True]
    assert launches == 3 and shard * 2 == padded
    for r in (0, 1):
        for arm in (True, False):
            for k, v in res[r][arm][0].items():
                np.testing.assert_array_equal(v, sharded[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,mode", [
    (torch.float32, (4, 12, 512, 64), 0),
    (torch.float32, (4, 12, 512, 64), 1),
    (torch.bfloat16, (4, 12, 512, 64), 0),
    (torch.bfloat16, (4, 12, 512, 64), 1),
    (torch.float32, (4, 6, 512, 64), 0),
    (torch.float32, (4, 6, 512, 64), 1),
    (torch.bfloat16, (4, 6, 512, 64), 0),
    (torch.bfloat16, (4, 6, 512, 64), 1),
    (torch.float32, (4, 6, 1024, 64), None),
    (torch.bfloat16, (4, 6, 1024, 64), None),
    (torch.float32, (4, 12, 1024, 64), None),
    (torch.bfloat16, (4, 12, 1024, 64), None),
])
def test_flash_kernels_at_lm_par_call_sites_on_card(dtype, shape, mode):
    """K1-K3 at the LM's sp and tp call sites: a seq rank's ring blocks of
    gpt_small at a global sequence of 1024 (the diagonal, mode 0, and a
    past block, mode +1, delta passed in as the ring does) with 12 heads
    (sp) and a tp rank's 6 (sp x tp), a tp or Ulysses rank's 6 heads over
    the whole sequence, and the one-device control's 12 at batch 4,
    against the plain versions at the tolerances of the tests above."""
    _need_gpu()
    q, k, v, g, _out, _lse = _bwd_inputs(shape, dtype, True, mode, 11)
    before = dict(port_flash.LAUNCHES)
    out, lse = port_flash.flash_attention_fwd(q, k, v, True, None, mode)
    want_o, want_l = port_flash.flash_attention_fwd_plain(q, k, v, True,
                                                          None, mode)
    delta = port_flash.flash_delta(g, out) if mode is not None else None
    got = port_flash.flash_attention_bwd(q, k, v, out, lse, g, True, None,
                                         mode, delta)
    want = port_flash.flash_attention_bwd_plain(q, k, v, out, lse, g, True,
                                                None, mode, delta)
    torch.cuda.synchronize()
    assert all(port_flash.LAUNCHES[n] == before[n] + 1
               for n in ("flash_fwd", "flash_dq", "flash_dkv"))
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want_o.float(),
                               rtol=2 ** -7 if bf16 else 1e-4, atol=1e-5)
    torch.testing.assert_close(lse, want_l, rtol=1e-4, atol=1e-5)
    rtol, atol = (2 ** -7, 1e-3) if bf16 else (1e-4, 1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


def _seq_pair_worker(rank, store, q):
    from poseidon_tpu_torch.parallel import sequence
    from poseidon_tpu_torch.runtime import cluster
    group = cluster.init_distributed(torch.device("cuda"), rank=rank,
                                     world=2, coordinator=f"file://{store}",
                                     named=(("seq",), (2,)))
    try:
        seq = group.mesh["seq"]
        out = {"backend": group.backend}
        gen = torch.Generator(device="cuda").manual_seed(3)
        # the staged exchanges round-trip CUDA tensors exactly
        t = torch.randn(2, 3, 5, generator=gen, device="cuda") + rank
        shifted = seq.ppermute_(torch.empty_like(t), t)
        swapped = seq.all_to_all(t)
        out["exchanges"] = (shifted.is_cuda and swapped.is_cuda,
                            shifted.cpu(), swapped.cpu(), t.cpu())
        q_, k, v, g = (torch.randn(2, 4, 256, 64, generator=gen,
                                   device="cuda") for _ in range(4))
        rows = slice(rank * 128, (rank + 1) * 128)
        full = [x.clone().requires_grad_(True) for x in (q_, k, v)]
        ref = port_flash.flash_attention(*full, True)
        ref_g = torch.autograd.grad(ref, full, g)
        for kind in ("ring", "ulysses"):
            loc = [x[:, :, rows].clone().requires_grad_(True)
                   for x in (q_, k, v)]
            before = dict(port_flash.LAUNCHES)
            o = (sequence.ring_flash_attention(*loc, seq, True)
                 if kind == "ring" else
                 sequence.ulysses_attention(*loc, seq, causal=True))
            grads = torch.autograd.grad(o, loc, g[:, :, rows])
            torch.cuda.synchronize()
            launches = {n: port_flash.LAUNCHES[n] - before[n]
                        for n in ("flash_fwd", "flash_dq", "flash_dkv")}
            errs = [float((a - b[:, :, rows]).abs().max())
                    for a, b in zip((o, *grads), (ref, *ref_g))]
            out[kind] = (launches, errs)
        q.put((rank, out))
    finally:
        group.close()


@pytest.mark.gpu
def test_ring_and_ulysses_gloo_pair_on_card(tmp_path):
    """Two gloo ranks sharing the card: ``ppermute_`` and ``all_to_all``
    move CUDA tensors (staged through pinned host buffers) exactly; ring
    flash attention and Ulysses over the pair match the flash kernels on
    the gathered sequence (f32 rtol 1e-4, atol 1e-5 as K1-K3's own
    checks: max abs well inside it), rank r running r + 1 of each kernel
    in the ring and one in Ulysses."""
    _need_gpu()
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_seq_pair_worker,
                         args=(r, str(tmp_path / "store"), q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert res[0]["backend"] == "gloo"
    for r in (0, 1):
        on_card, shifted, swapped, t = res[r]["exchanges"]
        other = res[1 - r]["exchanges"][3]
        assert on_card and torch.equal(shifted, other)
        assert torch.equal(swapped[r], t[r])
        assert torch.equal(swapped[1 - r], other[r])
        launches, errs = res[r]["ring"]
        assert launches == {"flash_fwd": r + 1, "flash_dq": r + 1,
                            "flash_dkv": r + 1}, launches
        assert max(errs) < 1e-4, errs
        launches, errs = res[r]["ulysses"]
        assert launches == {"flash_fwd": 1, "flash_dq": 1,
                            "flash_dkv": 1}, launches
        assert max(errs) < 1e-4, errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (2, 12, 1024, 64)),
    (torch.bfloat16, (2, 12, 1024, 64)),
    (torch.float32, (2, 6, 1024, 64)),
    (torch.bfloat16, (2, 6, 1024, 64)),
])
def test_flash_kernels_at_lm_pp_ep_call_sites_on_card(dtype, shape):
    """K1-K3 at the LM's pp and ep call sites, causal over the whole
    sequence: a pp2 microbatch and an ep2 rank of gpt_small at 4 x 1024
    (2 rows, 12 heads; the CLI pairs run the same shape) and a pp2 x tp2
    rank's 6 heads, against the plain versions at the tolerances of the
    sp and tp sites."""
    test_flash_kernels_at_lm_par_call_sites_on_card(dtype, shape, None)


def _pp_ep_pair_worker(rank, store, q):
    from poseidon_tpu_torch.models import moe
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.proto.messages import SolverParameter
    from poseidon_tpu_torch.runtime import cluster
    from poseidon_tpu_torch.solvers.updates import init_state
    dev = torch.device("cuda")
    group = cluster.init_distributed(dev, rank=rank, world=2,
                                     coordinator=f"file://{store}")
    try:
        out = {"backend": group.backend}
        cfg = tfm.TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                                    n_layers=4, d_ff=512, max_seq=256,
                                    remat=True)
        sp = SolverParameter(base_lr=0.05, lr_policy="fixed", momentum=0.9)
        toks = torch.randint(0, 256, (4, 257),
                             generator=torch.Generator().manual_seed(5))
        tokens, targets = toks[:, :-1].to(dev), toks[:, 1:].to(dev)
        pp = cluster.build_named_groups(("data", "stage"), (1, 2), rank,
                                        dev, "gloo")
        stage = pp["stage"]
        # the stage shift moves CUDA tensors (staged) each way
        t = torch.full((3, 5), float(rank + 1), device=dev)
        got = torch.empty_like(t)
        for shift in (1, -1):
            sends = (rank == 0) == (shift == 1)
            stage.shift_(t if sends else None, None if sends else got,
                         shift)
        out["shift"] = (got.is_cuda, float(got.mean()))
        # pp2 (2 microbatches, remat) against the one-device step
        p0 = tfm.init_params(cfg, torch.Generator().manual_seed(1), dev)
        params = tfm.pp_shard(tfm.to_pp_layout(p0, cfg), cfg, rank, 2)
        step = tfm.build_dp_pp_train_step(cfg, sp, pp, 2)
        before = dict(port_flash.LAUNCHES)
        params, _, m = step(params, init_state(params), tokens, targets)
        torch.cuda.synchronize()
        out["pp_launches"] = {n: port_flash.LAUNCHES[n] - before[n]
                              for n in ("flash_fwd", "flash_dq",
                                        "flash_dkv")}
        canon = tfm.from_pp_layout(tfm.pp_unshard(params, stage), cfg)
        if rank == 0:
            one = tfm.build_dp_sp_train_step(cfg, sp, dev)
            want, _, wm = one(p0, init_state(p0), tokens, targets)
            out["pp"] = (float(m["loss"]), float(wm["loss"]),
                         max(float((canon[a][b] - want[a][b]).abs().max())
                             for a in want for b in want[a]))
        # ep2 (4 experts, the default capacity factor) against the
        # per-source control
        mcfg = moe.MoEConfig(base=cfg, n_experts=4)
        ep = cluster.build_named_groups(("data", "expert"), (1, 2), rank,
                                        dev, "gloo")
        m0 = moe.init_moe_params(mcfg, torch.Generator().manual_seed(2), dev)
        params = moe.ep_shard(m0, mcfg, rank, 2)
        step = moe.build_dp_ep_train_step(mcfg, sp, ep)
        rows = slice(2 * rank, 2 * rank + 2)
        params, _, m = step(params, init_state(params), tokens[rows],
                            targets[rows])
        canon = moe.ep_unshard(params, ep["expert"])
        if rank == 0:
            def loss_fn(p):
                total = 0.0
                for blk in range(2):
                    r = slice(2 * blk, 2 * blk + 2)
                    logits, aux = moe.moe_forward(p, mcfg, tokens[r])
                    logp = torch.log_softmax(logits, dim=-1)
                    picked = torch.gather(logp, -1, targets[r][..., None])
                    total = total - picked.sum() / tokens.numel() + aux / 2
                return total
            loss, grads = tfm._grads(m0, loss_fn)
            upd = moe.make_update_fn(sp, tfm.transformer_mults(m0))
            want, _ = upd(m0, grads, init_state(m0))
            out["ep"] = (float(m["loss"]), float(loss),
                         max(float((canon[a][b] - want[a][b]).abs().max())
                             for a in want for b in want[a]))
        q.put((rank, out))
    finally:
        group.close()


@pytest.mark.gpu
def test_pp_and_ep_gloo_pair_on_card(tmp_path):
    """Two gloo ranks sharing the card: the stage shift moves CUDA tensors
    both ways; a pp2 step (2 microbatches, remat, 2 layers a stage) runs
    K1 8 times and K2, K3 4 times a rank and equals the one-device step
    (loss 1e-5, every leaf within 1e-5); an ep2 step of 4 experts at the
    default capacity factor equals the control that routes each rank's
    rows as its own source (the same bounds)."""
    _need_gpu()
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_pp_ep_pair_worker,
                         args=(r, str(tmp_path / "store"), q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert res[0]["backend"] == "gloo"
    for r in (0, 1):
        assert res[r]["shift"] == (True, float(2 - r))
        assert res[r]["pp_launches"] == {"flash_fwd": 8, "flash_dq": 4,
                                         "flash_dkv": 4}, res[r]
    for kind in ("pp", "ep"):
        got, want, worst = res[0][kind]
        assert got == pytest.approx(want, rel=1e-5), kind
        assert worst < 1e-5, (kind, worst)


@pytest.mark.gpu
def test_fleet_on_card():
    """Two AlexNet deploy replicas on cuda:0 behind the fleet: each
    replica's replies within NET_TOL (rtol 1e-4, atol 1e-6) of a direct
    forward on the card, eight concurrent requests through the router,
    and exactly two LRN forward launches a forward, warm-ups included."""
    _need_gpu()
    import threading

    import numpy as np

    from poseidon_tpu_torch.runtime.cli import build_serving_fleet

    x = {n: np.random.RandomState(n).randn(n, 3, 227, 227)
         .astype(np.float32) for n in (1, 4, 16)}
    for k in port_lrn.LAUNCHES:
        port_lrn.LAUNCHES[k] = 0
    mgr = build_serving_fleet("examples/imagenet/alexnet_deploy.prototxt",
                              "", "1,4,16", 2, devices_spec="0,0")
    try:
        for rep in mgr.replicas:
            assert rep.device_label == "cuda:0"
            for n, rows in x.items():
                got = rep.batcher.submit({"data": rows})["prob"]
                with torch.inference_mode():
                    want = rep.executor.net(
                        {"data": torch.from_numpy(rows).cuda()},
                        rep.executor._params)["prob"].cpu().numpy()
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        outs = []
        threads = [threading.Thread(
            target=lambda: outs.append(mgr.submit({"data": x[4]})[1].index),
            daemon=True) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(outs) == 8
    finally:
        mgr.shutdown()
    torch.cuda.synchronize()
    forwards = sum(rep.executor.forwards for rep in mgr.replicas)
    # the check's direct forwards (one a size a replica) launched K4 too
    direct = 2 * len(mgr.replicas) * len(x)
    assert port_lrn.LAUNCHES["lrn_fwd"] == 2 * forwards + direct


@pytest.mark.gpu
def test_tp2_generate_executor_on_card():
    """A tp2 ``GenerateExecutor`` with both shards on cuda:0 beside the
    one-device executor from the same weights (a small transformer whose
    shards take K1 at (1, 2, 16|64, 16)): prefill logits within LM_TOL
    (rtol 1e-4, atol 1e-4), equal greedy tokens from 4 concurrent
    requests, and exactly 2 x n_layers K1 launches a tp prefill."""
    _need_gpu()
    import threading

    import numpy as np

    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.models.transformer import (TransformerConfig,
                                                       init_params)
    from poseidon_tpu_torch.serving.continuous import GenerateExecutor

    cfg = TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                            n_layers=2, d_ff=256, max_seq=128)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(page_size=16, decode_rungs=(1, 2, 4), prompt_buckets=(16, 64))
    one = GenerateExecutor(cfg, params, device="cuda:0", **kw)
    tp = GenerateExecutor(cfg, params, mesh_cfg=MeshConfig(tp=2),
                          devices=("cuda:0", "cuda:0"), **kw)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 256, n).astype(np.int32) for n in (5, 16, 40, 9)]
    for p in prompts:
        np.testing.assert_allclose(tp._run_prefill(p)[0],
                                   one._run_prefill(p)[0], rtol=1e-4,
                                   atol=1e-4)

    def serve(ex):
        sched = ex.make_batcher(max_queue=8)
        out = [None] * len(prompts)
        try:
            threads = [threading.Thread(
                target=lambda i=i: out.__setitem__(i, sched.submit(
                    {"prompt": prompts[i], "max_new": 12})["tokens"]),
                daemon=True) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sched.close()
        return out

    toks = {"one": serve(one)}
    torch.cuda.synchronize()
    port_flash.LAUNCHES["flash_fwd"] = 0
    prefills0 = tp.prefills
    toks["tp"] = serve(tp)
    torch.cuda.synchronize()
    assert port_flash.LAUNCHES["flash_fwd"] == \
        2 * cfg.n_layers * (tp.prefills - prefills0)
    for a, b in zip(toks["one"], toks["tp"]):
        np.testing.assert_array_equal(a, b)
    assert tp.pool.all_free() and tp.snapshot()["mesh"] == "dp1,fsdp1,tp2"


@pytest.mark.gpu
def test_zoo_googlenet_step_kernels_vs_plain_on_card():
    """One step of GoogLeNet from ``models/zoo.py`` (aux heads, 1000
    classes, batch 4, f32, planned NHWC as "auto" plans it on the card)
    with the kernels against the same step with the plain LRN, pooling
    and update: the loss and every param and momentum within STEP_TOL
    (rtol 1e-4, atol 1e-6); the step launches K4-/K5-NHWC twice, K6-NHWC
    16 times (13 MAX, 3 AVE) and K7 once."""
    _need_gpu()
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.models import zoo
    from poseidon_tpu_torch.parallel.trainer import (TrainState,
                                                     build_train_step,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import SolverParameter
    from poseidon_tpu_torch.solvers.updates import SolverState

    net = Net(zoo.googlenet(), "TRAIN", device="cuda",
              source_shapes=zoo.googlenet_shapes(4), conv_layout="auto")
    assert net.conv_layout == "NHWC"
    step = build_train_step(net, SolverParameter(
        base_lr=0.01, lr_policy="poly", power=0.5, max_iter=2400000,
        momentum=0.9, weight_decay=2e-4))
    init = net.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"data": (torch.rand((4, 3, 224, 224), generator=gen) * 255
                      - 117).cuda(),
             "label": torch.randint(0, 1000, (4,), generator=gen)
             .float().cuda()}

    def one_step():
        net.manual_seed(3)
        params = {l: {k: v.clone() for k, v in d.items()}
                  for l, d in init.items()}
        state = init_train_state(params)
        params, state = step.load(params, TrainState(
            SolverState(0, state.solver.history), {}))
        params, state, m = step.step(params, state, batch)
        torch.cuda.synchronize()
        return (float(m["loss"]),
                {l: {k: v.clone() for k, v in d.items()}
                 for l, d in params.items()},
                {l: {k: v.clone() for k, v in d.items()}
                 for l, d in state.solver.history.items()})

    counts = {**port_lrn.LAUNCHES, **port_pool.LAUNCHES, **port_sgd.LAUNCHES}
    loss_k, pk, hk = one_step()
    after = {**port_lrn.LAUNCHES, **port_pool.LAUNCHES, **port_sgd.LAUNCHES}
    delta = {k: after[k] - counts[k] for k in after}
    assert delta == {"lrn_fwd": 0, "lrn_bwd": 0, "lrn_fwd_nhwc": 2,
                     "lrn_bwd_nhwc": 2, "pool_bwd": 0, "pool_bwd_nhwc": 16,
                     "sgd_update": 1}
    for l in net.layers:
        if l.TYPE == "LRN":
            l.across_channels = port_lrn.lrn_across_channels_reference
        elif l.TYPE == "POOLING":
            l.pool = (port_pool.max_pool_reference if l.method == "MAX"
                      else port_pool.ave_pool_reference)
    step.sgd_update = port_sgd.sgd_update_plain_
    loss_p, pp, hp = one_step()
    assert {**port_lrn.LAUNCHES, **port_pool.LAUNCHES,
            **port_sgd.LAUNCHES} == after
    assert abs(loss_k - loss_p) <= 1e-6 + 1e-4 * abs(loss_p)
    for a, b in ((pk, pp), (hk, hp)):
        for l in a:
            for k in a[l]:
                torch.testing.assert_close(a[l][k], b[l][k], rtol=1e-4,
                                           atol=1e-6)


@pytest.mark.gpu
def test_zoo_catalog_net_card_vs_cpu():
    """The catalog net (every layer type beyond the CNN core, STOCHASTIC
    pooling, a shared conv weight, the new fillers), planned "auto"
    (channels-last on the card, NCHW on the CPU): one forward and backward
    on the card against the CPU from the same params, the loss, tops and
    gradients within NET_TOL (rtol 1e-4, atol 1e-6)."""
    _need_gpu()
    import numpy as np

    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net

    path = "examples/catalog/layer_catalog.prototxt"
    rs = np.random.RandomState(0)
    inputs = {"data": rs.rand(4, 3, 12, 12).astype(np.float32),
              "label": rs.randint(0, 5, (4, 1, 1, 1)).astype(np.float32),
              "target": rs.rand(4, 5, 1, 1).astype(np.float32),
              "sim": rs.randint(0, 2, (4, 1, 1, 1)).astype(np.float32),
              "H": rs.rand(1, 1, 5, 5).astype(np.float32)}
    init = Net(load_net(path), "TRAIN", device="cpu").init(
        torch.Generator().manual_seed(0))

    def run(dev):
        net = Net(load_net(path), "TRAIN", device=dev, conv_layout="auto")
        params = {l: {k: v.to(dev).clone().requires_grad_(True)
                      for k, v in d.items()} for l, d in init.items()}
        feeds = {k: torch.from_numpy(v).to(dev).requires_grad_(k == "data")
                 for k, v in inputs.items()}
        out = net.apply(params, feeds, keep_blobs=True)
        out.loss.backward()
        got = {"loss": out.loss.detach().reshape(1), "ddata":
               feeds["data"].grad, "logits": out.blobs["logits"].detach()}
        got.update({f"d{l}/{k}": v.grad for l, d in params.items()
                    for k, v in d.items()})
        return {k: v.cpu() for k, v in got.items()}

    card, cpu = run("cuda"), run("cpu")
    for k in cpu:
        torch.testing.assert_close(card[k], cpu[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


_RESTART = r"""
import sys
from poseidon_tpu_torch.data import native
from poseidon_tpu_torch.ops import _build
from poseidon_tpu_torch.runtime import cli
rc = cli.main(["train", "--solver", sys.argv[1], "--output_dir", sys.argv[2],
               "--compile_cache_dir", sys.argv[3], "--aot_steps", "true"])
print("BUILT", len(_build.BUILT) + native.BUILT)
sys.exit(rc)
"""


@pytest.mark.gpu
def test_kernel_store_restart_on_card(tmp_path):
    """Two fresh ``train --compile_cache_dir D`` processes on one empty D:
    the first builds every kernel library and the data plane into
    D/kernels before its first step, the second builds nothing."""
    _need_gpu()
    import os
    import subprocess
    import sys
    from poseidon_tpu_torch.ops import _build
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(repo, "examples/digits/digits_train_test.prototxt")}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\ndisplay: 1\n'
        'max_iter: 1\ntest_iter: 1\ntest_interval: 1\n'
        'test_initialization: false\nsnapshot_prefix: "digits"\n')
    built = []
    for run in ("cold", "warm"):
        out = subprocess.run(
            [sys.executable, "-c", _RESTART, str(solver), str(tmp_path / run),
             str(tmp_path / "D")], cwd=repo, capture_output=True, text=True,
            timeout=600)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "aot warm start: no step executable is stored" in out.stdout
        built.append(int(out.stdout.split("BUILT ")[1].split()[0]))
    assert built == [len(_build.sources()) + 1, 0]
    assert len([n for n in os.listdir(tmp_path / "D" / "kernels")
                if n.endswith(".so")]) == len(_build.sources()) + 1


@pytest.mark.gpu
def test_layout_census_on_card_equals_the_cpu_contract():
    """One channels-last AlexNet step on the card under the op census: the
    layout conversions of the CPU contract (the fc6 pair and the five
    filter copies), op by op, with K4-NHWC, K5-NHWC, K6-NHWC and K7 on
    the path."""
    _need_gpu()
    from poseidon_tpu_torch.analysis import contracts as C
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.models import zoo
    from poseidon_tpu_torch.ops import _build
    from poseidon_tpu_torch.runtime import hlo_layout as HL
    from poseidon_tpu_torch.runtime.op_census import record
    golden = C.load_contract("alexnet")["nhwc"]
    net = Net(zoo.alexnet(num_classes=10, with_accuracy=False), "TRAIN",
              device="cuda", conv_layout="NHWC",
              source_shapes={"data": (2, 3, 227, 227), "label": (2,)})
    ts = HL.build_plain_step(net, None)
    params, state, batch = HL.step_inputs(ts, net, 2, 227)
    params, state, _ = ts.step(params, state, batch)
    before = _build.launch_counts()
    _, records = record(ts.step, params, state, batch)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert ran == {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2, "pool_bwd_nhwc": 3,
                   "sgd_update": 1}, ran
    rep = HL.layout_report(records)
    assert rep["layout_transpose_shapes"] == golden["layout_transpose_shapes"]
