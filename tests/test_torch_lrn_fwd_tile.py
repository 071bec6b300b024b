"""The LRN forward kernel's tile loop (``ops/csrc/lrn_fwd.cu``), checked on
the CPU.

The CUDA kernel cannot run here, so this file emulates its loop order with
torch: C split into the kernel's equal chunks (``_chunk``), each
chunk staged with its halo of ``pre`` channels before and ``post`` after
(zeros outside [0, C)), each square once, the window sum from zero in
ascending tap order, one ``pow`` an element. The emulation is held BITWISE
against ``lrn_across_channels_plain`` at n = 1, 4 (even: Caffe's asymmetric
window), 5, 32 and C = 2 (below the halo), 37, 96, 131 (off the chunks),
and at one h*w position; and against the Pallas kernel
``_lrn_fused_fwd_impl(interpret=True)`` at ``tests/test_torch_lrn.py``'s
f32 tolerance (rtol 1e-5, atol 1e-6: ``pow`` may differ by an ulp).
``lrn_fwd_cuda`` checks the window cap before the device, so its refusal
is pinned here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops.pallas_kernels import _lrn_fused_fwd_impl
from poseidon_tpu_torch.ops import lrn as port_lrn

ALPHA, BETA, K = 0.7, 0.75, 1.3
MAX_CHUNK = 64  # channels of a tile, at most (csrc/lrn_fwd.cu kMaxChunk)


def _chunk(channels: int) -> int:
    """The kernel's channels a tile (csrc/lrn_fwd.cu chunk_of): C split
    into the fewest equal chunks of at most MAX_CHUNK."""
    n_chunks = -(-channels // MAX_CHUNK)
    return -(-channels // n_chunks)


def _emulate(x: torch.Tensor, size: int, alpha: float, beta: float,
             k: float) -> torch.Tensor:
    """y as the kernel forms it, chunk by chunk. The ``pow`` runs once over
    the whole tensor, as in the plain version: torch's CPU ``pow`` takes
    another (vectorised or scalar) path on another shape and may differ in
    the last bit; on the card both sides call the same ``powf``."""
    n, c, h, w = x.shape
    pre = (size - 1) // 2
    xf = x.float().reshape(n, c, h * w)
    chunk = _chunk(c)
    scale = torch.full_like(xf, float("nan"))
    xc = torch.full_like(xf, float("nan"))
    for c0 in range(0, c, chunk):
        cc = min(chunk, c - c0)
        # stage: x for channels c0 - pre .. c0 + cc + post - 1, zero outside
        rows = torch.zeros(n, cc + size - 1, h * w)
        for i in range(cc + size - 1):
            ch = c0 - pre + i
            if 0 <= ch < c:
                rows[:, i] = xf[:, ch]
        sq = rows * rows
        for r in range(cc):
            acc = torch.zeros(n, h * w)
            for t in range(size):
                acc = acc + sq[:, r + t]
            scale[:, c0 + r] = k + (alpha / size) * acc
            xc[:, c0 + r] = rows[:, r + pre]
    return (xc * scale.pow(-beta)).reshape(n, c, h, w).to(x.dtype)


def _x(c, hw, seed, dtype=torch.float32):
    h, w = hw
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(2, c, h, w).astype(np.float32)) \
        .to(dtype)


@pytest.mark.parametrize("size", [1, 4, 5, 32])
@pytest.mark.parametrize("channels", [2, 37, 96, 131])
def test_chunked_forward_bitwise_equal_to_plain(size, channels):
    x = _x(channels, (3, 5), seed=size * 1000 + channels)
    want = port_lrn.lrn_across_channels_plain(x, size, ALPHA, BETA, K)
    assert torch.equal(_emulate(x, size, ALPHA, BETA, K), want)


@pytest.mark.parametrize("size,channels", [(5, 96), (4, 37), (32, 70)])
def test_chunked_forward_one_position_and_bf16(size, channels):
    for dtype in (torch.float32, torch.bfloat16):
        x = _x(channels, (1, 1), seed=size + channels, dtype=dtype)
        want = port_lrn.lrn_across_channels_plain(x, size, ALPHA, BETA, K)
        assert torch.equal(_emulate(x, size, ALPHA, BETA, K), want)


@pytest.mark.parametrize("size", [1, 4, 5])
@pytest.mark.parametrize("channels", [2, 37, 131])
def test_chunked_forward_matches_pallas_interpret(size, channels):
    x = _x(channels, (3, 5), seed=size * 10 + channels)
    ref = np.asarray(_lrn_fused_fwd_impl(jnp.asarray(x.numpy()), size, ALPHA,
                                         BETA, K, 512, True))
    np.testing.assert_allclose(_emulate(x, size, ALPHA, BETA, K).numpy(),
                               ref, rtol=1e-5, atol=1e-6)


def test_lrn_chunk_equal_chunks_of_at_most_64():
    """The emulated chunking (the card's attributes report the kernel's,
    tests/test_torch_gpu.py): norm1's 96 channels in two of 48, norm2's 256
    in four of 64, never an empty chunk."""
    assert [_chunk(c) for c in (1, 2, 64, 65, 96, 131, 256)] \
        == [1, 2, 64, 33, 48, 44, 64]
    for c in range(1, 300):
        chunk = _chunk(c)
        n_chunks = -(-c // chunk)
        assert chunk <= MAX_CHUNK
        assert n_chunks == -(-c // MAX_CHUNK)
        assert c - (n_chunks - 1) * chunk > 0  # no empty chunk


@pytest.mark.parametrize("local_size", [0, 33])
def test_fwd_kernel_entry_refuses_window_past_the_cap(local_size):
    """The forward takes the backward's windows (1..MAX_CUDA_LOCAL_SIZE),
    checked before the device, so a CPU tensor shows it."""
    x = _x(7, (5, 6), seed=1)
    with pytest.raises(ValueError, match="local_size"):
        port_lrn.lrn_fwd_cuda(x, local_size, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_lrn.lrn_fwd_cuda(x, port_lrn.MAX_CUDA_LOCAL_SIZE, ALPHA, BETA,
                              K)
