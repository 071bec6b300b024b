"""The port's learning-rate policies, update rules and arena against the
JAX package's (solvers/updates.py, core/arena.py, the Pallas fused_sgd).

Tolerances:
- learning_rate: fixed, step and multistep bitwise; exp, inv, poly and
  sigmoid call pow/exp, where XLA and torch may differ by an ulp: rtol
  2.5e-7 (two f32 ulps).
- SGD + L2 over the arena: bitwise against the JAX flat rule (XLA on the
  CPU) — the same f32 operations in the same order, no fused multiply-add
  on either side. The Pallas kernel in interpret mode computes
  ``momentum*h + lr*g`` as one fused multiply-add (measured: it matches
  fma(momentum, h, lr*g)), so against it h is held at atol 2e-8 and w at
  rtol 2.5e-7, atol 2e-8 (one rounding of that sum, carried into w).
- Nesterov and AdaGrad: rtol 1e-6 (AdaGrad's sqrt and divide are IEEE on
  both sides; held loosely in case XLA fuses differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.ops.pallas_kernels import fused_sgd
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu.solvers import updates as JU
from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.ops import sgd as port_sgd
from poseidon_tpu_torch.parallel.trainer import param_mults
from poseidon_tpu_torch.proto.messages import (SolverParameter, load_net,
                                               load_net_from_string)
from poseidon_tpu_torch.solvers import updates as PU

from test_torch_net import NARROW_ALEXNET

LENET = "examples/mnist/lenet_train_test.prototxt"
LENET_SHAPES = {"data": (4, 1, 28, 28), "label": (4,)}

POLICIES = {
    "fixed": {},
    "step": {"gamma": 0.1, "stepsize": 7},
    "exp": {"gamma": 0.993},
    "inv": {"gamma": 1e-4, "power": 0.75},
    "poly": {"power": 0.9, "max_iter": 50},
    "sigmoid": {"gamma": -0.05, "stepsize": 20},
    "multistep": {"gamma": 0.5, "stepvalue": [3, 9, 27]},
}


def _solvers(**kw):
    return SolverParameter(**kw), JaxSolver(**kw)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_learning_rate_matches_jax(policy):
    port_sp, jax_sp = _solvers(base_lr=0.01, lr_policy=policy,
                               **POLICIES[policy])
    for it in (0, 1, 6, 7, 13, 27, 40, 49):
        got = PU.learning_rate(port_sp, it)
        ref = float(JU.learning_rate(jax_sp, jnp.asarray(it)))
        if policy in ("fixed", "step", "multistep"):
            assert got == ref, (policy, it)
        else:
            np.testing.assert_allclose(got, ref, rtol=2.5e-7,
                                       err_msg=f"{policy} it={it}")


def _flat_inputs(n=4099, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(n).astype(np.float32)
    g = rs.randn(n).astype(np.float32)
    h = (rs.randn(n) * 1e-2).astype(np.float32)
    seg = (np.arange(n) // 97) % 2 == 1       # bias-like segments
    lr = np.where(seg, 2.0, 1.0).astype(np.float32)
    dec = np.where(seg, 0.0, 5e-4).astype(np.float32)
    return w, g, h, lr, dec


def test_sgd_l2_plain_vs_jax_flat_rule_and_pallas():
    w, g, h, lr, dec = _flat_inputs()
    rate, momentum = np.float32(0.00937), 0.9
    sp, jsp = _solvers(solver_type="SGD", momentum=momentum,
                       weight_decay=5e-4)
    # the JAX flat rule (XLA), and the Pallas kernel in interpret mode
    jw, jh = JU.make_flat_update_rule(jsp)(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(h), jnp.asarray(rate),
        jnp.asarray(lr), jnp.asarray(dec))
    pw, ph = fused_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(h),
                       jnp.asarray(rate) * jnp.asarray(lr), jnp.asarray(dec),
                       momentum, interpret=True)
    tw, th = torch.from_numpy(w.copy()), torch.from_numpy(h.copy())
    before = dict(port_sgd.LAUNCHES)
    PU.make_flat_update_rule(sp)(tw, torch.from_numpy(g), th, float(rate),
                                 torch.from_numpy(lr), torch.from_numpy(dec))
    assert port_sgd.LAUNCHES == before      # the CPU runs the plain version
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tw.numpy(), np.asarray(pw), rtol=2.5e-7,
                               atol=2e-8)
    np.testing.assert_allclose(th.numpy(), np.asarray(ph), rtol=0,
                               atol=2e-8)
    # both segments moved: decay 0 keeps the raw gradient, decay > 0 not
    assert not np.array_equal(tw.numpy(), w)


@pytest.mark.parametrize("solver_type", ["NESTEROV", "ADAGRAD"])
@pytest.mark.parametrize("reg", ["L2", "L1"])
def test_other_rules_match_jax_flat_rule(solver_type, reg):
    w, g, h, lr, dec = _flat_inputs(seed=1)
    h = np.abs(h)
    kw = dict(solver_type=solver_type, momentum=0.9, weight_decay=5e-4,
              regularization_type=reg, delta=1e-8)
    sp, jsp = _solvers(**kw)
    rate = np.float32(0.01)
    jw, jh = JU.make_flat_update_rule(jsp)(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(h), jnp.asarray(rate),
        jnp.asarray(lr), jnp.asarray(dec))
    tw, th = torch.from_numpy(w.copy()), torch.from_numpy(h.copy())
    PU.make_flat_update_rule(sp)(tw, torch.from_numpy(g), th, float(rate),
                                 torch.from_numpy(lr), torch.from_numpy(dec))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-9)


def test_leafwise_rule_matches_flat_rule():
    """The per-leaf rule and the arena rule agree on one net's tree."""
    net = Net(load_net_from_string(NARROW_ALEXNET), "TEST", device="cpu")
    params = net.init(torch.Generator().manual_seed(0))
    grads = {l: {p: torch.randn(v.shape, generator=torch.Generator()
                                .manual_seed(1)) for p, v in d.items()}
             for l, d in params.items()}
    hist = {l: {p: torch.zeros_like(v) for p, v in d.items()}
            for l, d in params.items()}
    sp = SolverParameter(solver_type="SGD", momentum=0.9, weight_decay=5e-4)
    new_p, new_h = PU._leafwise_update(sp, param_mults(net), 0.01, params,
                                       grads, hist)
    arena = net.arena_layout()
    fw, fg, fh = arena.pack(params), arena.pack(grads), arena.pack(hist)
    lr, dec = (torch.from_numpy(v) for v in arena.mult_vectors(5e-4))
    PU.make_flat_update_rule(sp)(fw, fg, fh, 0.01, lr, dec)
    for l, d in arena.unpack(fw).items():
        for p, v in d.items():
            assert torch.equal(v, new_p[l][p]), (l, p)


@pytest.mark.parametrize("name,bucket_mb", [("lenet", 4.0), ("lenet", 0.05),
                                            ("narrow_alexnet", 0.01),
                                            ("narrow_alexnet", 0)])
def test_arena_layout_matches_jax(name, bucket_mb):
    if name == "lenet":
        jnet = JaxNet(jax_load_net(LENET), "TRAIN", source_shapes=LENET_SHAPES,
                      conv_layout="NCHW")
        net = Net(load_net(LENET), "TRAIN", device="cpu",
                  source_shapes=LENET_SHAPES)
    else:
        jnet = JaxNet(jax_load_str(NARROW_ALEXNET), "TRAIN",
                      conv_layout="NCHW")
        net = Net(load_net_from_string(NARROW_ALEXNET), "TRAIN", device="cpu")
    ja = jnet.arena_layout(None, bucket_mb)
    pa = net.arena_layout(bucket_mb)
    assert [(s.layer, s.pname, s.shape, s.offset, s.size, s.lr_mult,
             s.decay_mult) for s in pa.slots] == \
        [(s.layer, s.pname, tuple(s.shape), s.offset, s.size, s.lr_mult,
          s.decay_mult) for s in ja.slots]
    assert pa.bucket_ranges == ja.bucket_ranges
    for a, b in zip(pa.mult_vectors(5e-4), ja.mult_vectors(5e-4)):
        np.testing.assert_array_equal(a, b)
    # views of one flat tensor carry the whole gradient back into it
    flat = torch.zeros(pa.total, requires_grad=True)
    sum(v.sum() * (i + 1) for i, v in enumerate(pa.views(flat))).backward()
    expect = torch.cat([torch.full((s.size,), float(i + 1))
                        for i, s in enumerate(pa.slots)])
    assert torch.equal(flat.grad, expect)
