"""The space-to-depth stem rewrite (``poseidon_tpu_torch/ops/nn.py``) against
the JAX package's (``poseidon_tpu/ops/nn.py:_space_to_depth_rewrite``).

- The rewritten input x2 and kernel w2 equal JAX's bitwise, in both
  layouts: data movement and zero padding only. The port's NHWC is a
  channels-last tensor of the logical NCHW shape, so JAX's NHWC x2 is
  compared after a transpose, and the port's x2 must stay channels-last.
- The rewritten conv against the direct conv at the real stems, AlexNet's
  conv1 (96x3x11x11 / s4 / p0 at 227) and GoogLeNet's (64x3x7x7 / s2 / p3
  at 224), in f32 at batch 1, at JAX's own tolerance for the same check
  (``tests/test_ops.py``: rtol 1e-5, atol 1e-5): the two sums add the same
  products in another order. Also in channels-last, and the conv's
  gradients through the rewrite at JAX's tolerance for the rewrite's
  gradients (``tests/test_ops.py``: rtol 1e-3, atol 3e-4; the gradients
  re-bracket sums of k*k*O terms).
"""

import numpy as np
import pytest
import torch

from poseidon_tpu.ops import nn as JNN
from poseidon_tpu_torch.numeric import memory_format, policy_scope
from poseidon_tpu_torch.ops import nn as NN

CL = torch.channels_last


def is_channels_last(t: torch.Tensor) -> bool:
    return memory_format(t) == CL
# (name, out channels, kernel, stride, pad, image)
STEMS = [("alexnet_conv1", 96, 11, 4, 0, 227),
         ("googlenet_conv1", 64, 7, 2, 3, 224)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("o,c,k,s,p,h", [(96, 3, 11, 4, 0, 227),
                                         (64, 3, 7, 2, 3, 224),
                                         (8, 4, 5, 2, 1, 17),
                                         (6, 1, 3, 3, 2, 10)])
def test_rewrite_bitwise_equals_jax(layout, o, c, k, s, p, h):
    rs = np.random.RandomState(o + k + h)
    x = rs.randn(2, c, h, h).astype(np.float32)
    w = rs.randn(o, c, k, k).astype(np.float32)
    jx = x.transpose(0, 2, 3, 1) if layout == "NHWC" else x
    jx2, jw2 = JNN._space_to_depth_rewrite(jx, w, (s, s), (p, p), layout)
    jx2 = np.asarray(jx2)
    if layout == "NHWC":
        jx2 = jx2.transpose(0, 3, 1, 2)
    tx = torch.from_numpy(x)
    if layout == "NHWC":
        tx = tx.contiguous(memory_format=CL)
    x2, w2 = NN._space_to_depth_rewrite(tx, torch.from_numpy(w), (s, s),
                                        (p, p))
    assert tuple(x2.shape) == jx2.shape
    assert np.array_equal(x2.numpy(), jx2)
    assert np.array_equal(w2.numpy(), np.asarray(jw2))
    if layout == "NHWC" and c > 1:
        assert is_channels_last(x2)
    else:
        # one input channel is both layouts at once: NCHW
        assert x2.is_contiguous()


def test_s2d_shape_rule_matches_jax():
    cases = [((1, 3, 227, 227), (96, 3, 11, 11), (4, 4), 1, True),
             ((1, 3, 224, 224), (64, 3, 7, 7), (2, 2), 1, True),
             ((1, 5, 32, 32), (8, 5, 3, 3), (2, 2), 1, False),
             ((1, 3, 32, 32), (8, 3, 3, 3), (1, 1), 1, False),
             ((1, 4, 32, 32), (8, 2, 3, 3), (2, 2), 2, False),
             ((1, 3, 32, 32), (8, 3, 3, 3), (4, 4), 1, False),
             ((1, 3, 32, 32), (8, 3, 3, 3), (2, 3), 1, False)]
    for xs, ws, stride, group, want in cases:
        x, w = np.zeros(xs, np.float32), np.zeros(ws, np.float32)
        assert JNN._s2d_shape_ok(x, w, stride, group, "NCHW") == want
        assert NN._s2d_shape_ok(torch.from_numpy(x), torch.from_numpy(w),
                                stride, group) == want


@pytest.mark.parametrize("name,o,k,s,p,h", STEMS)
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_s2d_conv_matches_direct_at_real_stems(name, o, k, s, p, h, layout):
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(1, 3, h, h).astype(np.float32))
    w = torch.from_numpy(rs.randn(o, 3, k, k).astype(np.float32) / k)
    b = torch.from_numpy(rs.randn(o).astype(np.float32))
    if layout == "NHWC":
        x = x.contiguous(memory_format=CL)
    y_direct = NN.conv2d(x, w, b, (s, s), (p, p), 1)
    with policy_scope(conv_s2d=True):
        y_s2d = NN.conv2d(x, w, b, (s, s), (p, p), 1)
    y_forced = NN.conv2d(x, w, b, (s, s), (p, p), 1, strategy="s2d")
    assert y_direct.shape == y_s2d.shape == y_forced.shape
    assert torch.equal(y_s2d, y_forced)
    np.testing.assert_allclose(y_s2d.numpy(), y_direct.numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
    if layout == "NHWC":
        assert is_channels_last(y_s2d)
    # and against JAX's direct conv at the same tolerance
    jy = np.asarray(JNN.conv2d(x.contiguous().numpy(), w.numpy(), b.numpy(),
                               (s, s), (p, p), 1))
    np.testing.assert_allclose(y_s2d.numpy(), jy, rtol=1e-5, atol=1e-5,
                               err_msg=name)


@pytest.mark.parametrize("name,o,k,s,p,h", STEMS)
def test_s2d_gradients_match_direct(name, o, k, s, p, h):
    rs = np.random.RandomState(4)
    x0 = torch.from_numpy(rs.randn(1, 3, h, h).astype(np.float32))
    w0 = torch.from_numpy(rs.randn(o, 3, k, k).astype(np.float32) / k)
    b0 = torch.from_numpy(rs.randn(o).astype(np.float32))
    grads = {}
    for strategy in ("direct", "s2d"):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = NN.conv2d(x, w, b, (s, s), (p, p), 1, act="relu",
                      strategy=strategy)
        (y * y).sum().backward()
        grads[strategy] = (x.grad, w.grad, b.grad)
    for a, c, what in zip(grads["direct"], grads["s2d"], "xwb"):
        assert a.shape == c.shape
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-3,
                                   atol=3e-4, err_msg=f"{name} d{what}")
