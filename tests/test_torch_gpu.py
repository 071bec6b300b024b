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
