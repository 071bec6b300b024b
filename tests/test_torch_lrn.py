"""The port's LRN (ops/lrn.py) against the JAX package's.

The plain PyTorch versions (forward and the analytic backward) are held
against the Pallas kernels run in interpret mode (``lrn_fused`` /
``lrn_fused_bwd(..., interpret=True)``) and against the XLA formulation
``ops/nn.lrn_across_channels`` (its custom VJP, and plain autodiff), on the
same numpy inputs. Tolerance (f32): atol 1e-6, rtol 1e-5 — both sides
compute the same pad-and-add formula in float32; only ``pow`` may differ by
an ulp. Autodiff through the forward computes the same gradient by another
route, so it gets rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops.nn import lrn_across_channels as jax_lrn_xla
from poseidon_tpu.ops.pallas_kernels import lrn_fused, lrn_fused_bwd
from poseidon_tpu_torch.ops import lrn as port_lrn

ALPHA, BETA, K = 0.7, 0.75, 1.3


def _inputs(c, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(2, c, 5, 6).astype(dtype)


@pytest.mark.parametrize("local_size", [3, 4, 5])
@pytest.mark.parametrize("channels", [7, 16])
def test_plain_lrn_matches_pallas_interpret(local_size, channels):
    x = _inputs(channels, seed=local_size * 100 + channels)
    ref = np.asarray(lrn_fused(jnp.asarray(x), local_size, ALPHA, BETA, K,
                               interpret=True))
    got = port_lrn.lrn_across_channels_plain(
        torch.from_numpy(x), local_size, ALPHA, BETA, K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local_size", [3, 4, 5])
@pytest.mark.parametrize("channels", [7, 16])
def test_plain_lrn_matches_xla_formulation(local_size, channels):
    x = _inputs(channels, seed=local_size * 10 + channels)
    ref = np.asarray(jax_lrn_xla(jnp.asarray(x), local_size, ALPHA, BETA, K))
    got = port_lrn.lrn_across_channels_plain(
        torch.from_numpy(x), local_size, ALPHA, BETA, K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_plain_lrn_bf16_matches_pallas_interpret():
    """bf16 in, f32 compute, bf16 out on both sides; the outputs may differ
    by one bf16 rounding step (2^-7 relative) where an ulp of pow flips a
    rounding, so rtol is 2^-7."""
    x = _inputs(16, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = lrn_fused(jnp.asarray(xb.float().numpy(), jnp.bfloat16), 5,
                    ALPHA, BETA, K, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = port_lrn.lrn_across_channels_plain(xb, 5, ALPHA, BETA, K)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_even_window_is_caffe_not_torch_builtin():
    """Caffe pads (n-1)//2 channels before the window; F.local_response_norm
    pads n//2. At n=4 the two must differ, and the port must be Caffe."""
    x = _inputs(16, seed=4)
    ref = np.asarray(jax_lrn_xla(jnp.asarray(x), 4, ALPHA, BETA, 1.0))
    got = port_lrn.lrn_across_channels_plain(torch.from_numpy(x), 4, ALPHA,
                                             BETA, 1.0).numpy()
    builtin = torch.nn.functional.local_response_norm(
        torch.from_numpy(x), 4, ALPHA, BETA, 1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(builtin - ref).max() > 1e-3


def test_wrapper_on_cpu_takes_plain_path_without_launch():
    x = torch.from_numpy(_inputs(7, seed=5))
    before = dict(port_lrn.LAUNCHES)
    got = port_lrn.lrn_across_channels(x, 5, ALPHA, BETA, K)
    want = port_lrn.lrn_across_channels_plain(x, 5, ALPHA, BETA, K)
    assert torch.equal(got, want)
    assert port_lrn.LAUNCHES == before


def test_kernel_entry_refuses_cpu_tensor():
    x = torch.from_numpy(_inputs(7, seed=6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_lrn.lrn_fwd_cuda(x, 5, ALPHA, BETA, K)


def _grads(c, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, c, 5, 6).astype(dtype),
            rs.randn(2, c, 5, 6).astype(dtype))


@pytest.mark.parametrize("local_size", [3, 4, 5])
@pytest.mark.parametrize("channels", [7, 16])
def test_plain_lrn_bwd_matches_pallas_interpret(local_size, channels):
    x, g = _grads(channels, seed=local_size * 7 + channels)
    ref = np.asarray(lrn_fused_bwd(jnp.asarray(x), jnp.asarray(g),
                                   local_size, ALPHA, BETA, K,
                                   interpret=True))
    got = port_lrn.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 local_size, ALPHA, BETA, K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local_size", [3, 4, 5])
@pytest.mark.parametrize("channels", [7, 16])
def test_plain_lrn_bwd_matches_jax_vjp(local_size, channels, monkeypatch):
    """Against jax.vjp of the XLA formulation: its analytic custom VJP
    (rtol 1e-5), and plain autodiff through the forward
    (POSEIDON_LRN_BWD=autodiff, another route to the same gradient: rtol
    1e-4)."""
    x, g = _grads(channels, seed=local_size * 11 + channels)
    got = port_lrn.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 local_size, ALPHA, BETA, K).numpy()
    for env, rtol in (("", 1e-5), ("autodiff", 1e-4)):
        monkeypatch.setenv("POSEIDON_LRN_BWD", env)
        _, vjp = jax.vjp(lambda x_: jax_lrn_xla(x_, local_size, ALPHA, BETA,
                                                K), jnp.asarray(x))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6,
                                   err_msg=env or "custom vjp")


@pytest.mark.parametrize("local_size", [4, 5])
def test_plain_lrn_bwd_bf16_matches_pallas_interpret(local_size):
    """bf16 x and g, f32 compute, bf16 dx on both sides: one bf16 rounding
    step (2^-7 relative) apart at most where an ulp of pow flips it."""
    x, g = _grads(16, seed=20 + local_size)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    ref = lrn_fused_bwd(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                        jnp.asarray(gb.float().numpy(), jnp.bfloat16),
                        local_size, ALPHA, BETA, K, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = port_lrn.lrn_bwd_plain(xb, gb, local_size, ALPHA, BETA, K)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("local_size", [3, 4])
def test_lrn_function_gradcheck_f64(local_size):
    """The autograd Function's analytic backward against finite
    differences of its forward, in f64 on the CPU."""
    x = torch.from_numpy(np.random.RandomState(30 + local_size)
                         .randn(1, 6, 2, 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: port_lrn.lrn_across_channels(t, local_size, ALPHA, BETA,
                                               K), (x,), eps=1e-6,
        atol=1e-7, rtol=1e-5)


def test_function_on_cpu_runs_plain_both_ways_without_launch():
    x = torch.from_numpy(_inputs(7, seed=8)).requires_grad_(True)
    g = torch.from_numpy(_inputs(7, seed=9))
    before = dict(port_lrn.LAUNCHES)
    y = port_lrn.lrn_across_channels(x, 5, ALPHA, BETA, K)
    y.backward(g)
    assert torch.equal(y.detach(), port_lrn.lrn_across_channels_plain(
        x.detach(), 5, ALPHA, BETA, K))
    assert torch.equal(x.grad, port_lrn.lrn_bwd_plain(x.detach(), g, 5,
                                                      ALPHA, BETA, K))
    assert port_lrn.LAUNCHES == before


def test_bwd_kernel_entry_refuses_cpu_tensor():
    x = torch.from_numpy(_inputs(7, seed=10))
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_lrn.lrn_bwd_cuda(x, x, 5, ALPHA, BETA, K)
