"""The port's Net against the JAX package's Net, on the CPU.

Weights cross the boundary as arrays (``params_from_jax``), never as seeds:
the JAX Net initializes, the port loads the same tree, and both run the
same numpy inputs. The JAX side is ``Net(..., "TEST",
conv_layout="NCHW").apply(train=False)``; every blob is compared.

Tolerance: rtol 1e-4, atol 1e-5 on every blob — both sides compute in
float32, but convolution and GEMM sum in different orders (XLA's CPU conv
vs PyTorch's), which moves the last few bits of sums over hundreds of
products.
"""

import jax
import numpy as np
import pytest
import torch

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.proto.messages import load_net, load_net_from_string

RTOL, ATOL = 1e-4, 1e-5

ALEXNET = "examples/imagenet/alexnet_deploy.prototxt"
LENET = "examples/mnist/lenet_deploy.prototxt"

# AlexNet-shaped, narrow: group-2 convs, two LRNs (n=5 and the even n=4),
# ceil-mode max pools whose floor-mode size would differ, an AVE pool with
# padding, fc layers, dropout and softmax
NARROW_ALEXNET = """
name: "NarrowAlexNet"
input: "data"
input_dim: 4 input_dim: 3 input_dim: 35 input_dim: 35
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 } }
layers { name: "pool1" type: POOLING bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv2" type: CONVOLUTION bottom: "pool1" top: "conv2"
  convolution_param { num_output: 16 pad: 2 kernel_size: 5 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu2" type: RELU bottom: "conv2" top: "conv2" }
layers { name: "norm2" type: LRN bottom: "conv2" top: "norm2"
  lrn_param { local_size: 4 alpha: 0.5 beta: 0.75 } }
layers { name: "pool2" type: POOLING bottom: "norm2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv3" type: CONVOLUTION bottom: "pool2" top: "conv3"
  convolution_param { num_output: 24 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.2 } } }
layers { name: "relu3" type: RELU bottom: "conv3" top: "conv3" }
layers { name: "conv4" type: CONVOLUTION bottom: "conv3" top: "conv4"
  convolution_param { num_output: 24 pad: 1 kernel_size: 3 group: 2
    weight_filler { type: "gaussian" std: 0.2 } } }
layers { name: "relu4" type: RELU bottom: "conv4" top: "conv4" }
layers { name: "pool5" type: POOLING bottom: "conv4" top: "pool5"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool5" top: "fc6"
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.1 } } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "drop6" type: DROPOUT bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
layers { name: "fc7" type: INNER_PRODUCT bottom: "fc6" top: "fc7"
  inner_product_param { num_output: 10
    weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc7" top: "prob" }
"""

# the structural layers of the slice: SPLIT, CONCAT, FLATTEN, a leaky
# ReLU, WITHIN_CHANNEL LRN and an AVE pool
STRUCTURAL = """
name: "Structural"
input: "data"
input_dim: 2 input_dim: 4 input_dim: 9 input_dim: 9
layers { name: "split" type: SPLIT bottom: "data" top: "a" top: "b" }
layers { name: "conv_a" type: CONVOLUTION bottom: "a" top: "conv_a"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layers { name: "leaky" type: RELU bottom: "conv_a" top: "conv_a"
  relu_param { negative_slope: 0.1 } }
layers { name: "lrn_w" type: LRN bottom: "b" top: "lrn_w"
  lrn_param { local_size: 3 alpha: 0.3 beta: 0.75
    norm_region: WITHIN_CHANNEL } }
layers { name: "cat" type: CONCAT bottom: "conv_a" bottom: "lrn_w"
  top: "cat" }
layers { name: "pool" type: POOLING bottom: "cat" top: "pool"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layers { name: "flat" type: FLATTEN bottom: "pool" top: "flat" }
layers { name: "fc" type: INNER_PRODUCT bottom: "flat" top: "fc"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
"""


def _jax_net_and_params(jax_param, seed=0):
    jnet = JaxNet(jax_param, "TEST", conv_layout="NCHW")
    params = jnet.init(jax.random.PRNGKey(seed))
    return jnet, params


def _np_tree(params):
    return {l: {p: np.asarray(v) for p, v in d.items()}
            for l, d in params.items()}


def _blobs_both(jax_param, port_param, batch, seed):
    jnet, params = _jax_net_and_params(jax_param)
    shape = (batch,) + tuple(jnet.blob_shapes["data"][1:])
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    ref = jnet.apply(params, {"data": x}, train=False, keep_blobs=True)
    net = Net(port_param, "TEST", device="cpu")
    params_from_jax(net, _np_tree(params))
    with torch.inference_mode():
        got = net({"data": torch.from_numpy(x)}, keep_blobs=True)
    return jnet, net, {k: np.asarray(v) for k, v in ref.blobs.items()}, \
        {k: v.numpy() for k, v in got.items()}


def test_alexnet_deploy_shapes_and_io_names_match():
    jnet = JaxNet(jax_load_net(ALEXNET), "TEST", conv_layout="NCHW")
    net = Net(load_net(ALEXNET), "TEST", device="cpu")
    assert net.blob_shapes == jnet.blob_shapes
    assert net.input_names == jnet.input_names == ["data"]
    assert net.output_names == jnet.output_names == ["prob"]
    assert net.param_count() == jnet.param_count()
    assert {l: [p.shape for p in d] for l, d in net.param_defs.items()} == \
        {l: [p.shape for p in d] for l, d in jnet.param_defs.items()}


def test_alexnet_epilogue_plan_matches():
    jnet = JaxNet(jax_load_net(ALEXNET), "TEST", conv_layout="NCHW")
    net = Net(load_net(ALEXNET), "TEST", device="cpu")
    jfused = {l.name: getattr(l, "fused_relu_slope", None)
              for l in jnet.layers if l.TYPE == "CONVOLUTION"}
    fused = {l.name: l.fused_relu_slope
             for l in net.layers if l.TYPE == "CONVOLUTION"}
    assert fused == jfused
    assert all(v == 0.0 for v in fused.values())


@pytest.mark.parametrize("name,text_or_path", [
    ("lenet", LENET),
    ("narrow_alexnet", NARROW_ALEXNET),
    ("structural", STRUCTURAL),
])
def test_forward_parity_every_blob(name, text_or_path):
    if text_or_path.endswith(".prototxt"):
        jp, pp = jax_load_net(text_or_path), load_net(text_or_path)
    else:
        jp, pp = jax_load_str(text_or_path), load_net_from_string(
            text_or_path)
    _, net, ref, got = _blobs_both(jp, pp, batch=3, seed=7)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: blob {k}")
    prob = got["prob"]
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=1e-5)


def test_narrow_alexnet_lrn_is_not_negligible():
    """Guards the parity test above: the LRNs there change their blobs."""
    _, _, ref, _ = _blobs_both(jax_load_str(NARROW_ALEXNET),
                               load_net_from_string(NARROW_ALEXNET),
                               batch=2, seed=8)
    assert np.abs(ref["norm1"] - ref["conv1"]).max() > 1e-2
    assert np.abs(ref["norm2"] - ref["conv2"]).max() > 1e-2


def test_export_weights_roundtrip_through_load_weights():
    jnet, params = _jax_net_and_params(jax_load_str(NARROW_ALEXNET))
    net = Net(load_net_from_string(NARROW_ALEXNET), "TEST", device="cpu")
    params_from_jax(net, _np_tree(params))
    exported = net.export_weights()
    jexported = jnet.export_weights(params)
    assert list(exported) == list(jexported)
    for l in exported:
        for a, b in zip(exported[l], jexported[l]):
            np.testing.assert_array_equal(a, np.asarray(b))
    fresh = net.init(torch.Generator().manual_seed(3))
    loaded = net.load_weights(fresh, exported, strict=True)
    for l in loaded:
        for p in loaded[l]:
            np.testing.assert_array_equal(loaded[l][p].numpy(),
                                          np.asarray(params[l][p]))


def test_init_is_seeded_and_follows_fillers():
    net = Net(load_net_from_string(NARROW_ALEXNET), "TEST", device="cpu")
    a = net.init(torch.Generator().manual_seed(11))
    b = net.init(torch.Generator().manual_seed(11))
    for l in a:
        for p in a[l]:
            assert torch.equal(a[l][p], b[l][p])
    assert torch.all(a["conv1"]["b"] == 0.1)
    assert torch.all(a["conv3"]["b"] == 0.0)
    fc7 = a["fc7"]["w"]
    scale = (3.0 / 32) ** 0.5
    assert float(fc7.abs().max()) <= scale
    assert abs(float(a["conv1"]["w"].std()) - 0.2) < 0.05


def test_params_from_jax_refuses_wrong_shape():
    _, params = _jax_net_and_params(jax_load_str(NARROW_ALEXNET))
    net = Net(load_net_from_string(NARROW_ALEXNET), "TEST", device="cpu")
    bad = _np_tree(params)
    bad["fc6"]["w"] = bad["fc6"]["w"][:, :-1]
    with pytest.raises(ValueError, match="fc6"):
        params_from_jax(net, bad)


def test_unsupported_layer_type_raises_naming_it():
    # every type of JAX's catalog is ported; NONE is the one type the
    # prototxt names that neither package builds, and both refuse it
    text = NARROW_ALEXNET.replace('type: SOFTMAX bottom: "fc7"',
                                  'type: NONE bottom: "fc7"')
    with pytest.raises(ValueError, match="unsupported type NONE") as want:
        JaxNet(jax_load_str(text), "TEST")
    with pytest.raises(ValueError, match="unsupported type NONE") as got:
        Net(load_net_from_string(text), "TEST", device="cpu")
    assert str(got.value) == str(want.value)
