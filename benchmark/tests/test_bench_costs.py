"""The yardstick's arithmetic against counts worked by hand from the two
prototxts."""

import math

import pytest

from benchmark import costs, manifest, prototxt
from benchmark.refnet import RefNet


def _net(cell: str, batch: int) -> RefNet:
    c = manifest.load_cell(cell)
    return RefNet(prototxt.read(manifest.config_path(c, "net")), batch,
                  int(c.config["crop_size"]))


def test_alexnet_macs_by_hand():
    net = _net("alexnet_b256_f32_u8", 1)
    macs = {l.name: l.macs for l in net.layers if l.macs}
    # out h * out w * out channels * (in channels / group) * kernel area
    assert macs == {
        "conv1": 55 * 55 * 96 * 3 * 11 * 11,
        "conv2": 27 * 27 * 256 * (96 // 2) * 5 * 5,
        "conv3": 13 * 13 * 384 * 256 * 3 * 3,
        "conv4": 13 * 13 * 384 * (384 // 2) * 3 * 3,
        "conv5": 13 * 13 * 256 * (384 // 2) * 3 * 3,
        "fc6": 4096 * 256 * 6 * 6,
        "fc7": 4096 * 4096,
        "fc8": 1000 * 4096,
    }
    assert sum(macs.values()) == 724_406_816
    params = sum(math.prod(p.shape) for p in net.param_specs())
    assert params == 60_965_224


def test_alexnet_model_flops():
    net = _net("alexnet_b256_f32_u8", 256)
    conv1 = 55 * 55 * 96 * 3 * 11 * 11
    # 3 passes of 2 FLOPs a multiply-add, less conv1's input gradient
    want = 6 * 724_406_816 - 2 * conv1
    assert costs.model_flops_per_image(net) == pytest.approx(want, rel=1e-12)
    convs = 105_415_200 + 223_948_800 + 149_520_384 + 112_140_288 + \
        74_760_192
    assert costs.conv_flops_per_step(net) == pytest.approx(
        256 * (6 * convs - 2 * conv1), rel=1e-12)


def test_googlenet_by_hand():
    net = _net("googlenet_b32_f32_k4", 1)
    macs = {l.name: l.macs for l in net.layers if l.macs}
    assert macs["conv1/7x7_s2"] == 112 * 112 * 64 * 3 * 7 * 7
    assert macs["conv2/3x3"] == 56 * 56 * 192 * 64 * 3 * 3
    assert macs["inception_3a/5x5"] == 28 * 28 * 32 * 16 * 5 * 5
    assert macs["inception_5b/1x1"] == 7 * 7 * 384 * 832
    assert macs["loss1/fc"] == 1024 * 128 * 4 * 4
    assert macs["loss3/classifier"] == 1000 * 1024
    assert sum(macs.values()) == 1_591_044_096
    params = sum(math.prod(p.shape) for p in net.param_specs())
    assert params == 13_378_280
    shapes = net.shapes
    assert shapes["pool1/3x3_s2"] == (1, 64, 56, 56)      # Caffe's ceil
    assert shapes["inception_3a/output"] == (1, 256, 28, 28)
    assert shapes["pool5/7x7_s1"] == (1, 1024, 1, 1)


def test_nhwc_kernel_bounds_at_alexnet_shapes():
    """K4/K5/K6-NHWC's bounds at batch 256 in f32 over 3.35 TB/s: the
    bound column of the port's kernel table (0.2916, 0.4374 and 0.3555
    ms)."""
    net = _net("alexnet_b256_f32_u8", 256)
    norm1 = 256 * 96 * 55 * 55
    norm2 = 256 * 256 * 27 * 27
    bw = 3.35e12
    k4 = 2 * 4 * (norm1 + norm2) / bw
    k5 = 3 * 4 * (norm1 + norm2) / bw
    assert k4 * 1e3 == pytest.approx(0.2916, abs=1e-4)
    assert k5 * 1e3 == pytest.approx(0.4374, abs=1e-4)
    assert costs.lrn_bound_s(net, 4, bw, 67e12) == pytest.approx(k4 + k5)
    pools = [(256 * 96 * 55 * 55, 256 * 96 * 27 * 27),
             (256 * 256 * 27 * 27, 256 * 256 * 13 * 13),
             (256 * 256 * 13 * 13, 256 * 256 * 6 * 6)]
    k6 = sum(4 * (2 * i + o) for i, o in pools) / bw
    assert k6 * 1e3 == pytest.approx(0.3555, abs=1e-4)
    assert costs.pool_bwd_bound_s(net, 4, bw) == pytest.approx(k6)
    # bf16 halves the bytes
    assert costs.pool_bwd_bound_s(net, 2, bw) == pytest.approx(k6 / 2)


def test_peaks_table():
    row = costs.peaks("NVIDIA H100 80GB HBM3")
    assert row["flops_s"]["f32"] == 67e12
    assert row["flops_s"]["bf16"] == 989e12
    assert row["hbm_bytes_s"] == 3.35e12
    with pytest.raises(KeyError):
        costs.peaks("a card nobody has")
