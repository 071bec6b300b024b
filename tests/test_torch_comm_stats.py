"""The port's static comm accounting (``runtime/comm_stats.py``) against
the JAX package's ``layer_comm_table`` and ``comm_summary``, on the CPU.

Every byte column must equal JAX's for LeNet, a narrow AlexNet and
AlexNet (full width, at batch 256 and 32 a device), on a flat group of 8
and a two-tier group of 2 slices of 4, given as an {axis: size} dict and
as a ``DataGroup``, under DENSE, SFB, TOPK, the SFB auto picks, a bf16
wire, a blocked TOPK and a bandwidth budget. ``est_comm_ms`` differs by
design: the port's rate model is the H100 SXM's published link rates,
not the TPU's; with JAX's rates passed in, the whole table must equal
JAX's.
"""

import os

import pytest
import torch

from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.parallel import strategies as S
from poseidon_tpu_torch.parallel.mesh import DataGroup
from poseidon_tpu_torch.proto.messages import load_net, load_net_from_string
from poseidon_tpu_torch.runtime import comm_stats as CS

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.parallel import strategies as JS
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_str
from poseidon_tpu.runtime import comm_stats as JCS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET = os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")
ALEXNET = os.path.join(REPO, "examples/imagenet/alexnet_train_val.prototxt")

# AlexNet-shaped and narrow: group conv, LRN, MAX and AVE pools, two FC
NARROW_ALEXNET = """
name: "NarrowAlexNet"
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2 } }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1" }
layers { name: "pool1" type: POOLING bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "conv2" type: CONVOLUTION bottom: "pool1" top: "conv2"
  convolution_param { num_output: 16 pad: 2 kernel_size: 5 group: 2 } }
layers { name: "pool2" type: POOLING bottom: "conv2" top: "pool2"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool2" top: "fc6"
  inner_product_param { num_output: 32 } }
layers { name: "fc8" type: INNER_PRODUCT bottom: "fc6" top: "fc8"
  inner_product_param { num_output: 10 } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "loss" }
"""
NETS = {"lenet": (LENET, (1, 28, 28), 64),
        "narrow_alexnet": (NARROW_ALEXNET, (3, 35, 35), 4),
        "alexnet_256": (ALEXNET, (3, 227, 227), 256),
        "alexnet_32": (ALEXNET, (3, 227, 227), 32)}
# the CommConfig fields of each configuration, the same in both packages;
# "auto" takes the SFB layers from each package's auto_strategies
CONFIGS = {
    "dense": {},
    "sfb": {"default_strategy": "sfb"},
    "topk": {"default_strategy": "topk"},
    "topk_block": {"default_strategy": "topk", "topk_block": 4096},
    "topk_fc": {"layer_strategies": "fc_topk", "topk_fraction": 0.05},
    "auto": {"layer_strategies": "auto"},
    "wire_bf16": {"default_strategy": "topk", "wire_dtype": "bf16"},
    "sfb_wire_f16": {"default_strategy": "sfb", "wire_dtype": "f16"},
    "budget": {"default_strategy": "topk", "bandwidth_budget_mb": 2.0},
}
SHAPES = {"flat": {"data": 8}, "two_tier": {"dcn": 2, "data": 4}}


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, (path, chw, batch) in NETS.items():
        shapes = {"data": (batch, *chw), "label": (batch,)}
        text = path.endswith(".prototxt")
        out[name] = (Net(load_net(path) if text else load_net_from_string(
                         path), "TRAIN", device="cpu", source_shapes=shapes),
                     JaxNet(jax_load_net(path) if text else jax_str(path),
                            "TRAIN", conv_layout="NCHW",
                            source_shapes=shapes))
    return out


def _configs(config, shape, net, jnet):
    fields = dict(CONFIGS[config])
    dcn = "dcn" if "dcn" in SHAPES[shape] else None
    if fields.get("layer_strategies") == "auto":
        port_ls, jax_ls = S.auto_strategies(net), JS.auto_strategies(jnet)
    elif fields.get("layer_strategies") == "fc_topk":
        port_ls = jax_ls = {l.name: "topk" for l in net.layers
                            if l.TYPE == "INNER_PRODUCT"}
    else:
        port_ls = jax_ls = {}
    fields.pop("layer_strategies", None)
    return (S.CommConfig(dcn_axis=dcn, layer_strategies=dict(port_ls),
                         **fields),
            JS.CommConfig(dcn_axis=dcn, layer_strategies=dict(jax_ls),
                          **fields))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", list(NETS))
def test_comm_table_bytes_equal_jax(nets, name, config, shape):
    net, jnet = nets[name]
    comm, jcomm = _configs(config, shape, net, jnet)
    got = CS.layer_comm_table(net, comm, SHAPES[shape])
    want = JCS.layer_comm_table(jnet, jcomm, SHAPES[shape])
    assert list(got) == list(want)
    for layer, row in want.items():
        assert {k: v for k, v in got[layer].items() if k != "est_comm_ms"} \
            == {k: v for k, v in row.items() if k != "est_comm_ms"}, layer
    drop = ("est_comm_ms_per_step",)
    assert {k: v for k, v in CS.comm_summary(got).items() if k not in drop} \
        == {k: v for k, v in JCS.comm_summary(want).items() if k not in drop}
    # with JAX's rates the estimate is JAX's too
    tpu_rates = CS.CommCostModel(ici_gbps=JCS.ICI_GBPS,
                                 dcn_gbps=JCS.DCN_GBPS)
    assert CS.layer_comm_table(net, comm, SHAPES[shape], tpu_rates) == want
    assert CS.comm_summary(CS.layer_comm_table(
        net, comm, SHAPES[shape], tpu_rates), 40.0) == \
        JCS.comm_summary(want, 40.0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_comm_table_of_a_data_group_equals_its_shape(nets, shape):
    net, _ = nets["alexnet_256"]
    comm = S.CommConfig(default_strategy="topk",
                        dcn_axis="dcn" if shape == "two_tier" else None)
    slices = SHAPES[shape].get("dcn", 1)
    group = DataGroup(rank=5, world=8, device=torch.device("cpu"),
                      slices=slices)
    assert CS.layer_comm_table(net, comm, group) == \
        CS.layer_comm_table(net, comm, SHAPES[shape])


def test_rate_model_is_the_h100s_not_the_tpus(nets):
    cost = CS.CommCostModel()
    assert (cost.ici_gbps, cost.dcn_gbps) == (450.0, 50.0)
    assert (cost.ici_gbps, cost.dcn_gbps) != (JCS.ICI_GBPS, JCS.DCN_GBPS)
    net, _ = nets["lenet"]
    row = CS.layer_comm_table(net, S.CommConfig(), {"data": 8})["ip1"]
    want_ms = row["ici_bytes_per_step"] / 450e9 * 1e3
    assert row["est_comm_ms"] == round(want_ms, 4)


def test_topk_bills_index_and_value(nets):
    """AlexNet's fc6 at the default fraction on a flat group of 8: k
    entries of 4-byte index + 4-byte value, ring all-reduced."""
    net, _ = nets["alexnet_256"]
    row = CS.layer_comm_table(net, S.CommConfig(default_strategy="topk"),
                              {"data": 8})["fc6"]
    k = int((4096 * 9216 + 4096) * 0.01)
    assert row["param_count"] == 4096 * 9216 + 4096
    assert row["ici_bytes_per_step"] == int(2 * 7 / 8 * k * 8)
    assert row["dcn_bytes_per_step"] == 0
