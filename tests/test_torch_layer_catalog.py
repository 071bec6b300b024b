"""The port's layer catalog against the JAX package's, on the CPU.

- The port's ``REGISTRY`` and ``LOSS_TYPES`` hold exactly JAX's types.
- Each layer type the port added (IM2COL, the neurons SIGMOID, TANH,
  BNLL, ABSVAL, POWER, THRESHOLD, the structural SLICE, ELTWISE, MVN,
  SILENCE, ARGMAX, the six losses) and STOCHASTIC pooling, as a one-layer
  net over input blobs: its tops against JAX's ``Net.apply`` on the same
  numpy inputs, and the gradient of sum(top * cotangent) with respect to
  every float input against ``jax.vjp``, with the port's net in NCHW and
  in channels-last (its 4-D inputs ``torch.channels_last``). Tolerance
  rtol 1e-5, atol 1e-6: the same f32 formulas, summed in other orders.
  ELTWISE MAX and ARGMAX have cases with pinned ties: the cotangent splits
  at a tie as ``jnp.maximum``'s does, and top-k takes the lower index as
  ``lax.top_k`` does. Each case also holds the net's loss (Caffe's
  objective, loss layers weighted 1 by default) against JAX's.
- INFOGAIN_LOSS reads its matrix from a ``.npy`` file and from a blob
  file, as JAX's does.
- The new fillers (uniform, sparse gaussian, positive_unitball) by shape,
  by support and by statistics against JAX's draws of the same shape
  (torch cannot replay JAX's threefry stream); DUMMY_DATA's constant tops
  exactly, its random tops by shape and statistics, and its stream by
  seed and layer index.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.core import fillers as jax_fillers
from poseidon_tpu.core import layers as jax_layers
from poseidon_tpu.core.blob import ParamDef as JaxParamDef
from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.proto.messages import FillerParameter as JaxFiller
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.core import layers
from poseidon_tpu_torch.core.blob import ParamDef
from poseidon_tpu_torch.core.fillers import fill
from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.numeric import memory_format
from poseidon_tpu_torch.proto.messages import (FillerParameter,
                                               load_net_from_string)
from poseidon_tpu_torch.proto.wire import encode_blob

TOL = dict(rtol=1e-5, atol=1e-6)


def _net_text(inputs, body):
    head = "".join(
        f'input: "{n}" ' + " ".join(f"input_dim: {d}" for d in shape) + "\n"
        for n, shape in inputs.items())
    return f'name: "catalog"\n{head}{body}'


class Case:
    def __init__(self, inputs, body, tops, make, diff=None,
                 jax_nan_grad=False):
        self.inputs = inputs           # {name: 4-D shape}
        self.body = body               # layers text
        self.tops = tops               # top blob names to compare
        self.make = make               # rs -> {name: array}
        self.diff = diff               # names to differentiate (floats)
        # JAX's gradient is NaN where the port's is finite (see
        # test_stochastic_pool_zero_window_gradient_is_zero_not_nan)
        self.jax_nan_grad = jax_nan_grad


def _randn(*shape, scale=1.0):
    return lambda rs: (scale * rs.randn(*shape)).astype(np.float32)


def _labels(n, classes):
    return lambda rs: rs.randint(0, classes, size=(n, 1, 1, 1)).astype(
        np.float32)


def _probs(n, c):
    def make(rs):
        z = rs.randn(n, c).astype(np.float64)
        p = np.exp(z) / np.exp(z).sum(1, keepdims=True)
        return p.reshape(n, c, 1, 1).astype(np.float32)
    return make


def _inputs(**makers):
    return lambda rs: {k: m(rs) for k, m in makers.items()}


X4 = (2, 3, 4, 5)


def _neuron(t, extra=""):
    return Case({"x": X4}, f'layers {{ name: "l" type: {t} bottom: "x" '
                           f'top: "y" {extra} }}', ["y"],
                _inputs(x=_randn(*X4, scale=2.0)))


def _tied_eltwise(rs):
    a = rs.randn(*X4).astype(np.float32)
    b = rs.randn(*X4).astype(np.float32)
    c = rs.randn(*X4).astype(np.float32)
    b.flat[::3] = a.flat[::3]          # a == b ties
    c.flat[::4] = np.maximum(a, b).flat[::4]   # three-way and two-way ties
    return {"a": a, "b": b, "c": c}


def _tied_scores(rs):
    s = rs.randn(3, 4, 2, 1).astype(np.float32)
    s[0, :, :, 0] = 1.5                # all tied: indices 0..k-1
    s[1, 1, 0, 0] = s[1, 3, 1, 0] = 9.0   # a tie at the top
    return {"s": s}


def _nonneg(*shape):
    return lambda rs: rs.rand(*shape).astype(np.float32)


def _power_frac(rs):
    return {"x": rs.uniform(-1, 1, size=X4).astype(np.float32)}


CASES = {
    "im2col": Case(
        {"x": (2, 3, 7, 6)},
        'layers { name: "l" type: IM2COL bottom: "x" top: "y" '
        'convolution_param { kernel_size: 3 stride: 2 pad: 1 } }',
        ["y"], _inputs(x=_randn(2, 3, 7, 6))),
    "im2col_rect": Case(
        {"x": (1, 2, 6, 7)},
        'layers { name: "l" type: IM2COL bottom: "x" top: "y" '
        'convolution_param { kernel_h: 2 kernel_w: 3 stride: 1 } }',
        ["y"], _inputs(x=_randn(1, 2, 6, 7))),
    "sigmoid": _neuron("SIGMOID"),
    "tanh": _neuron("TANH"),
    "bnll": _neuron("BNLL"),
    "absval": _neuron("ABSVAL"),
    "power_square": _neuron(
        "POWER", "power_param { power: 2 scale: 0.5 shift: 1 }"),
    "power_frac": Case(
        {"x": X4}, 'layers { name: "l" type: POWER bottom: "x" top: "y" '
                   'power_param { power: 0.5 scale: 1.5 shift: 3 } }',
        ["y"], _power_frac),
    "power_identity": _neuron(
        "POWER", "power_param { power: 1 scale: -2 shift: 0.5 }"),
    "threshold": _neuron("THRESHOLD", "threshold_param { threshold: 0.3 }"),
    "slice_points": Case(
        {"x": (2, 6, 3, 4)},
        'layers { name: "l" type: SLICE bottom: "x" top: "p" top: "q" '
        'top: "r" slice_param { slice_dim: 1 slice_point: 1 '
        'slice_point: 4 } }', ["p", "q", "r"],
        _inputs(x=_randn(2, 6, 3, 4))),
    "slice_equal_h": Case(
        {"x": (2, 3, 4, 5)},
        'layers { name: "l" type: SLICE bottom: "x" top: "p" top: "q" '
        'slice_param { slice_dim: 2 } }', ["p", "q"],
        _inputs(x=_randn(2, 3, 4, 5))),
    "eltwise_prod": Case(
        {"a": X4, "b": X4, "c": X4},
        'layers { name: "l" type: ELTWISE bottom: "a" bottom: "b" '
        'bottom: "c" top: "y" eltwise_param { operation: PROD } }', ["y"],
        _inputs(a=_randn(*X4), b=_randn(*X4), c=_randn(*X4))),
    "eltwise_sum_coeff": Case(
        {"a": X4, "b": X4, "c": X4},
        'layers { name: "l" type: ELTWISE bottom: "a" bottom: "b" '
        'bottom: "c" top: "y" eltwise_param { operation: SUM coeff: 1 '
        'coeff: -0.5 coeff: 2 } }', ["y"],
        _inputs(a=_randn(*X4), b=_randn(*X4), c=_randn(*X4))),
    "eltwise_max_ties": Case(
        {"a": X4, "b": X4, "c": X4},
        'layers { name: "l" type: ELTWISE bottom: "a" bottom: "b" '
        'bottom: "c" top: "y" eltwise_param { operation: MAX } }', ["y"],
        _tied_eltwise),
    "mvn": _neuron("MVN"),
    "mvn_mean_only": _neuron("MVN", "mvn_param { normalize_variance: false }"),
    "mvn_across": _neuron("MVN", "mvn_param { across_channels: true }"),
    "mvn_across_mean_only": _neuron(
        "MVN", "mvn_param { normalize_variance: false across_channels: true }"),
    "silence": Case(
        {"x": X4, "z": X4},
        'layers { name: "l" type: SILENCE bottom: "x" bottom: "z" }\n'
        'layers { name: "t" type: TANH bottom: "z" top: "y" }', ["y"],
        _inputs(x=_randn(*X4), z=_randn(*X4))),
    "argmax": Case(
        {"s": (3, 4, 2, 1)},
        'layers { name: "l" type: ARGMAX bottom: "s" top: "y" }', ["y"],
        _tied_scores),
    "argmax_top3_ties": Case(
        {"s": (3, 4, 2, 1)},
        'layers { name: "l" type: ARGMAX bottom: "s" top: "y" '
        'argmax_param { top_k: 3 } }', ["y"], _tied_scores),
    "argmax_max_val": Case(
        {"s": (3, 4, 2, 1)},
        'layers { name: "l" type: ARGMAX bottom: "s" top: "y" '
        'argmax_param { top_k: 2 out_max_val: true } }', ["y"],
        _tied_scores),
    "euclidean_loss": Case(
        {"a": X4, "b": X4},
        'layers { name: "l" type: EUCLIDEAN_LOSS bottom: "a" bottom: "b" '
        'top: "loss" }', ["loss"], _inputs(a=_randn(*X4), b=_randn(*X4))),
    "hinge_l1": Case(
        {"s": (4, 5, 1, 1), "t": (4, 1, 1, 1)},
        'layers { name: "l" type: HINGE_LOSS bottom: "s" bottom: "t" '
        'top: "loss" }', ["loss"],
        _inputs(s=_randn(4, 5, 1, 1), t=_labels(4, 5)), diff=["s"]),
    "hinge_l2": Case(
        {"s": (4, 5, 1, 1), "t": (4, 1, 1, 1)},
        'layers { name: "l" type: HINGE_LOSS bottom: "s" bottom: "t" '
        'top: "loss" hinge_loss_param { norm: L2 } }', ["loss"],
        _inputs(s=_randn(4, 5, 1, 1), t=_labels(4, 5)), diff=["s"]),
    "multinomial_logistic_loss": Case(
        {"p": (4, 6, 1, 1), "t": (4, 1, 1, 1)},
        'layers { name: "l" type: MULTINOMIAL_LOGISTIC_LOSS bottom: "p" '
        'bottom: "t" top: "loss" }', ["loss"],
        _inputs(p=_probs(4, 6), t=_labels(4, 6)), diff=["p"]),
    "sigmoid_cross_entropy_loss": Case(
        {"x": X4, "t": X4},
        'layers { name: "l" type: SIGMOID_CROSS_ENTROPY_LOSS bottom: "x" '
        'bottom: "t" top: "loss" }', ["loss"],
        _inputs(x=_randn(*X4, scale=20.0), t=_nonneg(*X4)), diff=["x"]),
    "infogain_loss_bottom": Case(
        {"p": (4, 6, 1, 1), "t": (4, 1, 1, 1), "h": (1, 1, 6, 6)},
        'layers { name: "l" type: INFOGAIN_LOSS bottom: "p" bottom: "t" '
        'bottom: "h" top: "loss" }', ["loss"],
        _inputs(p=_probs(4, 6), t=_labels(4, 6), h=_nonneg(1, 1, 6, 6)),
        diff=["p", "h"]),
    "contrastive_loss": Case(
        {"a": (6, 3, 1, 1), "b": (6, 3, 1, 1), "y": (6, 1, 1, 1)},
        'layers { name: "l" type: CONTRASTIVE_LOSS bottom: "a" bottom: "b" '
        'bottom: "y" top: "loss" contrastive_loss_param { margin: 1.5 } }',
        ["loss"], _inputs(a=_randn(6, 3, 1, 1, scale=0.6),
                          b=_randn(6, 3, 1, 1, scale=0.6),
                          y=_labels(6, 2)), diff=["a", "b"]),
    "stochastic_pool": Case(
        {"x": (2, 3, 8, 7)},
        'layers { name: "l" type: POOLING bottom: "x" top: "y" '
        'pooling_param { pool: STOCHASTIC kernel_size: 3 stride: 2 } }',
        ["y"], _inputs(x=_nonneg(2, 3, 8, 7))),
    "stochastic_pool_zeros": Case(
        {"x": (1, 2, 6, 6)},
        'layers { name: "l" type: POOLING bottom: "x" top: "y" '
        'pooling_param { pool: STOCHASTIC kernel_h: 2 kernel_w: 3 '
        'stride: 2 } }', ["y"],
        lambda rs: {"x": np.where(rs.rand(1, 2, 6, 6) < 0.5, 0.0,
                                  rs.rand(1, 2, 6, 6)).astype(np.float32)},
        jax_nan_grad=True),
}

# the layer types each case holds, so the catalog's coverage is checked
NEW_TYPES = {"IM2COL", "SIGMOID", "TANH", "BNLL", "ABSVAL", "POWER",
             "THRESHOLD", "SLICE", "ELTWISE", "MVN", "SILENCE", "ARGMAX",
             "EUCLIDEAN_LOSS", "HINGE_LOSS", "MULTINOMIAL_LOGISTIC_LOSS",
             "SIGMOID_CROSS_ENTROPY_LOSS", "INFOGAIN_LOSS",
             "CONTRASTIVE_LOSS", "DUMMY_DATA", "HDF5_OUTPUT"}


def _jax_run(case, arrays, phase="TRAIN", cots=None):
    """JAX's tops and the vjp of sum(top * cot) over the float inputs
    (random cotangents unless given)."""
    jnet = JaxNet(jax_load_str(_net_text(case.inputs, case.body)), phase,
                  conv_layout="NCHW")
    diff = case.diff if case.diff is not None else list(case.inputs)

    def f(d):
        feeds = {**{k: jnp.asarray(v) for k, v in arrays.items()}, **d}
        out = jnet.apply({}, feeds, keep_blobs=True)
        return {t: out.blobs[t] for t in case.tops}, out.loss

    (tops, loss), vjp = jax.vjp(
        f, {k: jnp.asarray(arrays[k]) for k in diff})
    rs = np.random.RandomState(99)
    if cots is None:
        cots = {t: np.asarray(rs.randn(*np.shape(v)), np.float32)
                for t, v in tops.items()}
    (grads,) = vjp(({t: jnp.asarray(c) for t, c in cots.items()},
                    jnp.zeros((), jnp.float32)))
    return ({t: np.asarray(v) for t, v in tops.items()}, float(loss), cots,
            {k: np.asarray(v) for k, v in grads.items()})


def _port_run(case, arrays, cots, layout, phase="TRAIN"):
    net = Net(load_net_from_string(_net_text(case.inputs, case.body)),
              phase, device="cpu", conv_layout=layout)
    diff = case.diff if case.diff is not None else list(case.inputs)
    feeds = {}
    for k, v in arrays.items():
        t = torch.from_numpy(v.copy())
        if layout == "NHWC" and t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        feeds[k] = t.requires_grad_(k in diff)
    out = net.apply({}, feeds, keep_blobs=True)
    tops = {t: out.blobs[t] for t in case.tops}
    obj = sum((v * torch.from_numpy(cots[t])).sum() for t, v in tops.items())
    if obj.requires_grad:
        obj.backward()
    grads = {k: (feeds[k].grad if feeds[k].grad is not None
                 else torch.zeros_like(feeds[k])) for k in diff}
    return tops, float(out.loss.detach()), grads, feeds


def test_registry_matches_jax():
    assert set(layers.REGISTRY) == set(jax_layers.REGISTRY)
    assert layers.LOSS_TYPES == jax_layers.LOSS_TYPES
    for t in NEW_TYPES | {"POOLING"}:
        assert t in layers.REGISTRY


def test_cases_cover_every_new_type():
    covered = set()
    for case in CASES.values():
        for lp in load_net_from_string(_net_text(case.inputs,
                                                 case.body)).layers:
            covered.add(lp.canonical_type())
    # DUMMY_DATA and HDF5_OUTPUT have tests of their own (below, and
    # tests/test_torch_shared_params.py's engine dump)
    assert NEW_TYPES - {"DUMMY_DATA", "HDF5_OUTPUT"} <= covered


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax_forward_and_vjp(name, layout):
    case = CASES[name]
    arrays = case.make(np.random.RandomState(zlib.crc32(name.encode())))
    want, want_loss, cots, want_g = _jax_run(case, arrays)
    got, got_loss, got_g, feeds = _port_run(case, arrays, cots, layout)
    for t in case.tops:
        assert tuple(got[t].shape) == want[t].shape, t
        np.testing.assert_allclose(got[t].detach().numpy(), want[t],
                                   err_msg=f"{name} top {t}", **TOL)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    for k in want_g:
        g, w = got_g[k].numpy(), want_g[k]
        assert np.isfinite(g).all()
        if case.jax_nan_grad:
            assert not np.isfinite(w).all()
            g, w = g[np.isfinite(w)], w[np.isfinite(w)]
        np.testing.assert_allclose(g, w, err_msg=f"{name} d{k}", **TOL)
    if layout == "NHWC":
        # the inputs reached the layer channels-last
        assert all(memory_format(v) == torch.channels_last
                   for v in feeds.values() if v.dim() == 4
                   and v.shape[1] > 1 and v.shape[2] * v.shape[3] > 1)


def test_eltwise_max_splits_ties_as_jnp_maximum():
    """Where two of three bottoms tie for the max, each gets half the
    cotangent; all three: 1/4, 1/4, 1/2 (the left fold's splits)."""
    case = CASES["eltwise_max_ties"]
    arrays = {"a": np.ones(X4, np.float32), "b": np.ones(X4, np.float32),
              "c": np.ones(X4, np.float32)}
    arrays["c"][0, 0, 0, 0] = 0.0
    ones = {"y": np.ones(X4, np.float32)}
    _, _, got_g, _ = _port_run(case, arrays, ones, "NCHW")
    assert float(got_g["a"][0, 0, 0, 1]) == 0.25
    assert float(got_g["c"][0, 0, 0, 1]) == 0.5
    assert float(got_g["a"][0, 0, 0, 0]) == 0.5
    assert float(got_g["c"][0, 0, 0, 0]) == 0.0
    want, _, _, want_g = _jax_run(case, arrays, cots=ones)
    for k in want_g:
        np.testing.assert_array_equal(got_g[k].numpy(), want_g[k])


def test_argmax_ties_take_the_lower_index():
    case = CASES["argmax_top3_ties"]
    arrays = _tied_scores(np.random.RandomState(0))
    want, _, cots, _ = _jax_run(case, arrays)
    got, _, _, _ = _port_run(case, arrays, cots, "NCHW")
    y = got["y"].detach().numpy()
    np.testing.assert_array_equal(y[0, 0, :, 0], [0, 1, 2])
    np.testing.assert_array_equal(y[1, 0, :2, 0], [2, 7])
    np.testing.assert_array_equal(y, want["y"])


def test_accuracy_top_k_ties_take_the_lower_index():
    """ACCURACY's top-k shares ARGMAX's order: with every score tied, the
    top 2 are indices 0 and 1, so only labels 0 and 1 hit, as in JAX
    (``torch.topk`` picks 2 and 4 of five tied zeros on the CPU)."""
    from poseidon_tpu.ops import losses as jax_losses
    from poseidon_tpu_torch.ops import losses
    scores = np.zeros((6, 5), np.float32)
    scores[5, 3] = 1.0
    labels = np.array([0, 1, 0, 1, 2, 3], np.float32)
    got = float(losses.accuracy(torch.from_numpy(scores),
                                torch.from_numpy(labels), top_k=2))
    want = float(jax_losses.accuracy(jnp.asarray(scores),
                                     jnp.asarray(labels), top_k=2))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(5 / 6, rel=1e-6)


@pytest.mark.parametrize("kind", ["npy", "blob"])
def test_infogain_source_file_matches_jax(tmp_path, kind):
    rs = np.random.RandomState(5)
    H = rs.rand(6, 6).astype(np.float32)
    if kind == "npy":
        src = str(tmp_path / "H.npy")
        np.save(src, H)
    else:
        src = str(tmp_path / "H.binaryproto")
        with open(src, "wb") as f:
            f.write(encode_blob(H.reshape(1, 1, 6, 6)))
    text = _net_text({"p": (4, 6, 1, 1), "t": (4, 1, 1, 1)},
                     'layers { name: "l" type: INFOGAIN_LOSS bottom: "p" '
                     'bottom: "t" top: "loss" }')
    # JAX's prototxt tokenizer reads the "inf" of "infogain_loss_param" as
    # a number (the port's no longer does), so JAX's layer gets the source
    # set on its message
    jparam = jax_load_str(text)
    jparam.layers[0].infogain_loss_param.source = src
    jnet = JaxNet(jparam, "TRAIN", conv_layout="NCHW")
    arrays = {"p": _probs(4, 6)(rs), "t": _labels(4, 6)(rs)}
    cot = np.float32(0.7)

    def f(p):
        return jnet.apply({}, {"p": p, "t": jnp.asarray(arrays["t"])},
                          keep_blobs=True).blobs["loss"]

    want, vjp = jax.vjp(f, jnp.asarray(arrays["p"]))
    (want_p,) = vjp(jnp.asarray(cot))
    net = Net(load_net_from_string(text.replace(
        'top: "loss" }', f'top: "loss" infogain_loss_param {{ source: '
                         f'"{src}" }} }}')), "TRAIN", device="cpu")
    p = torch.from_numpy(arrays["p"]).requires_grad_()
    got = net.apply({}, {"p": p, "t": torch.from_numpy(arrays["t"])},
                    keep_blobs=True).blobs["loss"]
    (got * float(cot)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p), **TOL)


def test_prototxt_names_starting_with_inf_or_nan_parse():
    """Field and enum names that begin with "inf" or "nan" are names, and
    inf and nan alone stay numbers."""
    net = load_net_from_string(
        'name: "x" layers { name: "l" type: INFOGAIN_LOSS '
        'infogain_loss_param { source: "H.npy" } loss_weight: inf } '
        'layers { name: "m" type: POWER power_param { power: -inf '
        'scale: nan } }')
    assert net.layers[0].infogain_loss_param.source == "H.npy"
    assert net.layers[0].loss_weight == [float("inf")]
    assert net.layers[1].power_param.power == float("-inf")
    assert np.isnan(net.layers[1].power_param.scale)


def test_stochastic_pool_zero_window_gradient_is_zero_not_nan():
    """A window of zeros (common after a ReLU) pools to 0 in both
    packages; its gradient is 0 in the port (the limit of sum(x^2) /
    FLT_MIN there) where JAX's is NaN: JAX's quotient rule squares
    FLT_MIN, which underflows to 0, and 0/0 passes through the clamp's
    mask. Elsewhere the two agree (the parametrised case above)."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 0] = 0.5
    case = Case({"x": (1, 1, 4, 4)},
                'layers { name: "l" type: POOLING bottom: "x" top: "y" '
                'pooling_param { pool: STOCHASTIC kernel_size: 2 '
                'stride: 2 } }', ["y"], None)
    ones = {"y": np.ones((1, 1, 2, 2), np.float32)}
    want, _, _, want_g = _jax_run(case, {"x": x}, cots=ones)
    got, _, got_g, _ = _port_run(case, {"x": x}, ones, "NCHW")
    np.testing.assert_array_equal(got["y"].detach().numpy(), want["y"])
    np.testing.assert_array_equal(got["y"].detach().numpy(),
                                  [[[[0.5, 0.0], [0.0, 0.0]]]])
    g = got_g["x"].numpy()
    assert np.isnan(want_g["x"][0, 0, 2:, :]).all()
    np.testing.assert_array_equal(g[0, 0, 2:, :], 0.0)
    np.testing.assert_array_equal(g[0, 0, :2, :2], want_g["x"][0, 0, :2, :2])


def test_stochastic_pool_with_padding_raises_as_jax():
    case = Case({"x": (1, 2, 6, 6)},
                'layers { name: "l" type: POOLING bottom: "x" top: "y" '
                'pooling_param { pool: STOCHASTIC kernel_size: 3 stride: 2 '
                'pad: 1 } }', ["y"], _inputs(x=_nonneg(1, 2, 6, 6)))
    arrays = case.make(np.random.RandomState(0))
    with pytest.raises(NotImplementedError, match="padding"):
        _jax_run(case, arrays)
    with pytest.raises(NotImplementedError, match="padding"):
        _port_run(case, arrays, {"y": None}, "NCHW")


def test_new_loss_layers_weigh_one_by_default():
    for t in jax_layers.LOSS_TYPES:
        lp = load_net_from_string(
            f'name: "n" layers {{ name: "l" type: {t} }}').layers[0]
        assert layers.REGISTRY[t](lp).loss_weights(1) == [1.0]


# --------------------------------------------------------------------------- #
# fillers
# --------------------------------------------------------------------------- #

FILLERS = {
    "uniform": dict(type="uniform", min=-0.3, max=0.7),
    "sparse_gaussian": dict(type="gaussian", std=0.5, sparse=30),
    "positive_unitball": dict(type="positive_unitball"),
}
FILLER_SHAPE = (120, 40, 3, 3)


def _jax_fill(spec, shape):
    pdef = JaxParamDef(name="w", shape=shape, filler=JaxFiller(**spec))
    return np.asarray(jax_fillers.fill(jax.random.PRNGKey(3), pdef))


def _port_fill(spec, shape, seed=3):
    pdef = ParamDef(name="w", shape=shape, filler=FillerParameter(**spec))
    return fill(torch.Generator().manual_seed(seed), pdef).numpy()


@pytest.mark.parametrize("name", sorted(FILLERS))
def test_new_filler_matches_jax_by_shape_support_and_law(name):
    spec = FILLERS[name]
    got, want = _port_fill(spec, FILLER_SHAPE), _jax_fill(spec,
                                                          FILLER_SHAPE)
    assert got.shape == want.shape == FILLER_SHAPE
    assert got.dtype == want.dtype == np.float32
    if name == "uniform":
        for a in (got, want):
            assert a.min() >= -0.3 and a.max() <= 0.7
        assert abs(got.mean() - 0.2) < 0.01
        assert abs(got.std() - 1.0 / np.sqrt(12)) < 0.01
    elif name == "sparse_gaussian":
        p = 30 / FILLER_SHAPE[0]
        for a in (got, want):
            assert abs(float((a != 0).mean()) - p) < 0.01
        nz = got[got != 0]
        assert abs(nz.std() - 0.5) < 0.02 and abs(nz.mean()) < 0.02
    else:
        for a in (got, want):
            assert a.min() >= 0
            np.testing.assert_allclose(
                a.reshape(FILLER_SHAPE[0], -1).sum(1), 1.0, rtol=1e-5)
    # the law agrees with JAX's draw: moments within sampling error
    assert abs(got.mean() - want.mean()) < 0.01
    assert abs(got.std() - want.std()) < 0.02
    # a seed gives the same draw
    np.testing.assert_array_equal(got, _port_fill(spec, FILLER_SHAPE))


def test_sparse_gaussian_caps_probability_at_one():
    spec = dict(type="gaussian", std=1.0, sparse=500)
    assert (_port_fill(spec, (8, 4)) != 0).all()


def test_unknown_filler_raises_as_jax():
    spec = dict(type="msra")
    with pytest.raises(ValueError, match="unknown filler type 'msra'"):
        _port_fill(spec, (2, 2))
    with pytest.raises(ValueError, match="unknown filler type 'msra'"):
        _jax_fill(spec, (2, 2))


# --------------------------------------------------------------------------- #
# DUMMY_DATA
# --------------------------------------------------------------------------- #

DUMMY = """
name: "dummy"
layers { name: "d" type: DUMMY_DATA top: "c" top: "g" top: "u"
  dummy_data_param {
    num: 2 num: 64 num: 3 channels: 3 channels: 8 channels: 2
    height: 4 height: 16 height: 5 width: 5 width: 16 width: 1
    data_filler { type: "constant" value: 0.25 }
    data_filler { type: "gaussian" mean: 1.0 std: 2.0 }
    data_filler { type: "uniform" min: -1 max: 3 } } }
layers { name: "d2" type: DUMMY_DATA top: "z"
  dummy_data_param { num: 1 channels: 1 height: 2 width: 2 } }
"""


def _dummy_tops(seed, layout="NCHW"):
    net = Net(load_net_from_string(DUMMY), "TRAIN", device="cpu",
              conv_layout=layout).manual_seed(seed)
    return net.apply({}, {}, keep_blobs=True).blobs


def test_dummy_data_matches_jax_by_shape_constants_and_law():
    jnet = JaxNet(jax_load_str(DUMMY), "TRAIN", conv_layout="NCHW")
    want = jnet.apply({}, {}, rng=jax.random.PRNGKey(0),
                      keep_blobs=True).blobs
    got = _dummy_tops(0)
    for t in ("c", "g", "u", "z"):
        assert tuple(got[t].shape) == want[t].shape
    # constant fillers exactly (the default filler is constant 0)
    np.testing.assert_array_equal(got["c"].numpy(), np.asarray(want["c"]))
    np.testing.assert_array_equal(got["z"].numpy(), np.asarray(want["z"]))
    g, wg = got["g"].numpy(), np.asarray(want["g"])
    assert abs(g.mean() - 1.0) < 0.05 and abs(g.std() - 2.0) < 0.05
    assert abs(g.mean() - wg.mean()) < 0.1 and abs(g.std() - wg.std()) < 0.1
    u = got["u"].numpy()
    assert u.min() >= -1 and u.max() <= 3


def test_dummy_data_stream_follows_seed_and_index():
    a, b = _dummy_tops(0), _dummy_tops(0)
    assert torch.equal(a["g"], b["g"])
    assert not torch.equal(a["g"], _dummy_tops(1)["g"])
    # each forward draws anew (Caffe refills a non-constant filler)
    net = Net(load_net_from_string(DUMMY), "TRAIN", device="cpu")
    first = net.apply({}, {}, keep_blobs=True).blobs["g"]
    assert not torch.equal(first, net.apply({}, {},
                                            keep_blobs=True).blobs["g"])
    # the layouts draw the same units
    assert torch.equal(_dummy_tops(4)["g"], _dummy_tops(4, "NHWC")["g"])
    # two layers never share a stream: the same layer at another index
    moved = DUMMY.replace('layers { name: "d" ', 'layers { name: "d0" '
                          'type: DUMMY_DATA top: "e" dummy_data_param { '
                          'num: 1 channels: 1 height: 1 width: 1 } }\n'
                          'layers { name: "d" ', 1)
    net2 = Net(load_net_from_string(moved), "TRAIN", device="cpu")
    net2.manual_seed(0)
    assert not torch.equal(a["g"], net2.apply({}, {}, keep_blobs=True)
                           .blobs["g"])


def test_layer_param_dataclasses_are_the_same_fields():
    """The catalog's parameters parse to the same fields in both packages
    (one prototxt drives both)."""
    from poseidon_tpu.proto import messages as JM
    from poseidon_tpu_torch.proto import messages as TM
    for cls in ("ArgMaxParameter", "MVNParameter", "EltwiseParameter",
                "SliceParameter", "DummyDataParameter", "PowerParameter",
                "HingeLossParameter", "InfogainLossParameter",
                "ContrastiveLossParameter", "ThresholdParameter",
                "HDF5OutputParameter"):
        assert ([f.name for f in dataclasses.fields(getattr(JM, cls))]
                == [f.name for f in dataclasses.fields(getattr(TM, cls))])


# --------------------------------------------------------------------------- #
# the catalog net (examples/catalog), the net chip_smoke.py runs on the card
# --------------------------------------------------------------------------- #

CATALOG = "examples/catalog/layer_catalog.prototxt"
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def catalog_inputs(seed=0):
    rs = np.random.RandomState(seed)
    return {"data": rs.rand(4, 3, 12, 12).astype(np.float32),
            "label": rs.randint(0, 5, (4, 1, 1, 1)).astype(np.float32),
            "target": rs.rand(4, 5, 1, 1).astype(np.float32),
            "sim": rs.randint(0, 2, (4, 1, 1, 1)).astype(np.float32),
            "H": rs.rand(1, 1, 5, 5).astype(np.float32)}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_catalog_net_matches_jax(layout):
    """Every new type, STOCHASTIC pooling, a shared conv weight and the
    new fillers in one net: the port's filler draw carried into JAX's
    net, then the loss (rtol 1e-5), every top (rtol 1e-5, atol 1e-6) and
    every owner gradient and input gradient (rtol 1e-4, atol 1e-6, the
    train-step gradient tolerance) against ``jax.grad``."""
    from poseidon_tpu.proto.messages import load_net as jax_load_net
    from poseidon_tpu_torch.proto.messages import load_net
    net = Net(load_net(CATALOG), "TRAIN", device="cpu", conv_layout=layout)
    jnet = JaxNet(jax_load_net(CATALOG), "TRAIN", conv_layout="NCHW")
    covered = {l.TYPE for l in net.layers} | {
        l.lp.pooling_param.pool for l in net.layers if l.TYPE == "POOLING"}
    assert NEW_TYPES | {"STOCHASTIC"} <= covered
    assert list(net.param_defs) == list(jnet.param_defs) == [
        "conv_a", "conv_b", "ip1", "ip2"]
    assert [p.name for p in net.param_defs["conv_b"]] == ["b"]
    params = net.init(torch.Generator().manual_seed(0))
    fillers = {(l, p.name): p.filler.type
               for l, d in net.param_defs.items() for p in d}
    assert {"uniform", "positive_unitball", "gaussian"} <= set(
        fillers.values())
    np.testing.assert_allclose(params["ip1"]["w"].sum(1).numpy(), 1.0,
                               rtol=1e-5)
    inputs = catalog_inputs()
    init = {l: {p: v.numpy() for p, v in d.items()}
            for l, d in params.items()}
    diff = ["data", "target", "H"]

    def f(p, d):
        out = jnet.apply(p, {**inputs, **d}, train=True, keep_blobs=True)
        return out.loss, {k: out.blobs[k] for k in ("logits", "top2", "sp",
                                                    "mv", "f2")}

    (jloss, jtops), (jgp, jgd) = (
        f(init, {k: inputs[k] for k in diff}),
        jax.grad(lambda p, d: f(p, d)[0], argnums=(0, 1))(
            init, {k: inputs[k] for k in diff}))
    tp = {l: {k: v.clone().requires_grad_() for k, v in d.items()}
          for l, d in params.items()}
    feeds = {k: torch.from_numpy(v.copy()).requires_grad_(k in diff)
             for k, v in inputs.items()}
    out = net.apply(tp, feeds, train=True, keep_blobs=True)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jloss),
                               rtol=1e-5)
    for k, v in jtops.items():
        np.testing.assert_allclose(out.blobs[k].detach().numpy(),
                                   np.asarray(v), err_msg=k, **TOL)
    for l in jgp:
        for p in jgp[l]:
            np.testing.assert_allclose(tp[l][p].grad.numpy(),
                                       np.asarray(jgp[l][p]),
                                       err_msg=f"d{l}/{p}", **GRAD_TOL)
    for k in diff:
        np.testing.assert_allclose(feeds[k].grad.numpy(),
                                   np.asarray(jgd[k]), err_msg=f"d{k}",
                                   **GRAD_TOL)
