"""Model zoo: programmatic builders for the reference's benchmark networks
(the port of ``poseidon_tpu/models/zoo.py``, on the port's own
``proto/messages``).

The reference ships these as prototxt (``models/bvlc_alexnet``,
``models/bvlc_googlenet``, ``examples/mnist``, ``examples/cifar10``). Here the
same architectures are constructed programmatically as ``NetParameter``s:
LeNet, CIFAR-10 quick and full, AlexNet, GoogLeNet (inception modules, the
two auxiliary heads at loss weight 0.3 in TRAIN), CaffeNet, R-CNN ILSVRC13
and Flickr-style finetuning. ``to_prototxt`` writes them as text, the same
text as the JAX package's; each ``*_shapes`` gives the source shapes at a
batch size, so one definition serves train, test and bench shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..proto.messages import (  # noqa: F401
    net_to_prototxt as to_prototxt,
    AccuracyParameter, ConvolutionParameter, DropoutParameter, FillerParameter,
    InnerProductParameter, LayerParameter, LRNParameter, NetParameter,
    NetStateRule, ParamSpec, PoolingParameter,
)


def gaussian(std: float) -> FillerParameter:
    return FillerParameter(type="gaussian", std=std)


def constant(value: float = 0.0) -> FillerParameter:
    return FillerParameter(type="constant", value=value)


def xavier() -> FillerParameter:
    return FillerParameter(type="xavier")


def conv(
    name: str, bottom: str, top: str, num_output: int, kernel: int,
    stride: int = 1, pad: int = 0, group: int = 1,
    weight_filler: Optional[FillerParameter] = None,
    bias_value: float = 0.0,
    lr: Tuple[float, float] = (1.0, 2.0),
    decay: Tuple[float, float] = (1.0, 0.0),
) -> LayerParameter:
    return LayerParameter(
        name=name, type="CONVOLUTION", bottom=[bottom], top=[top],
        blobs_lr=list(lr), weight_decay=list(decay),
        convolution_param=ConvolutionParameter(
            num_output=num_output, kernel_size=kernel, stride=stride, pad=pad,
            group=group, weight_filler=weight_filler or xavier(),
            bias_filler=constant(bias_value)))


def ip(
    name: str, bottom: str, top: str, num_output: int,
    weight_filler: Optional[FillerParameter] = None,
    bias_value: float = 0.0,
    lr: Tuple[float, float] = (1.0, 2.0),
    decay: Tuple[float, float] = (1.0, 0.0),
) -> LayerParameter:
    return LayerParameter(
        name=name, type="INNER_PRODUCT", bottom=[bottom], top=[top],
        blobs_lr=list(lr), weight_decay=list(decay),
        inner_product_param=InnerProductParameter(
            num_output=num_output, weight_filler=weight_filler or xavier(),
            bias_filler=constant(bias_value)))


def pool(name: str, bottom: str, top: str, method: str, kernel: int,
         stride: int, pad: int = 0) -> LayerParameter:
    return LayerParameter(
        name=name, type="POOLING", bottom=[bottom], top=[top],
        pooling_param=PoolingParameter(pool=method, kernel_size=kernel,
                                       stride=stride, pad=pad))


def relu(name: str, blob: str) -> LayerParameter:
    return LayerParameter(name=name, type="RELU", bottom=[blob], top=[blob])


def lrn(name: str, bottom: str, top: str, local_size: int = 5,
        alpha: float = 1e-4, beta: float = 0.75,
        norm_region: str = "ACROSS_CHANNELS") -> LayerParameter:
    return LayerParameter(
        name=name, type="LRN", bottom=[bottom], top=[top],
        lrn_param=LRNParameter(local_size=local_size, alpha=alpha, beta=beta,
                               norm_region=norm_region))


def dropout(name: str, blob: str, ratio: float = 0.5) -> LayerParameter:
    return LayerParameter(name=name, type="DROPOUT", bottom=[blob], top=[blob],
                          dropout_param=DropoutParameter(dropout_ratio=ratio))


def softmax_loss(name: str, bottoms: List[str], top: str = "loss") -> LayerParameter:
    return LayerParameter(name=name, type="SOFTMAX_LOSS", bottom=bottoms,
                          top=[top])


def accuracy(name: str, bottoms: List[str], top: str = "accuracy",
             top_k: int = 1, test_only: bool = True) -> LayerParameter:
    lp = LayerParameter(name=name, type="ACCURACY", bottom=bottoms, top=[top],
                        accuracy_param=AccuracyParameter(top_k=top_k))
    if test_only:
        lp.include = [NetStateRule(phase="TEST")]
    return lp


# --------------------------------------------------------------------------- #
# LeNet (examples/mnist) — the minimum end-to-end slice of SURVEY.md §7.2
# --------------------------------------------------------------------------- #

def lenet(with_accuracy: bool = True) -> NetParameter:
    layers = [
        conv("conv1", "data", "conv1", 20, 5, lr=(1, 2), decay=(1, 0)),
        pool("pool1", "conv1", "pool1", "MAX", 2, 2),
        conv("conv2", "pool1", "conv2", 50, 5),
        pool("pool2", "conv2", "pool2", "MAX", 2, 2),
        ip("ip1", "pool2", "ip1", 500),
        relu("relu1", "ip1"),
        ip("ip2", "ip1", "ip2", 10),
        softmax_loss("loss", ["ip2", "label"]),
    ]
    if with_accuracy:
        layers.insert(-1, accuracy("accuracy", ["ip2", "label"]))
    return NetParameter(name="LeNet", layers=layers)


def lenet_shapes(batch: int) -> Dict[str, tuple]:
    return {"data": (batch, 1, 28, 28), "label": (batch,)}


# --------------------------------------------------------------------------- #
# CIFAR-10 quick (examples/cifar10)
# --------------------------------------------------------------------------- #

def cifar10_quick(with_accuracy: bool = True) -> NetParameter:
    layers = [
        conv("conv1", "data", "conv1", 32, 5, pad=2, weight_filler=gaussian(1e-4)),
        pool("pool1", "conv1", "pool1", "MAX", 3, 2),
        relu("relu1", "pool1"),
        conv("conv2", "pool1", "conv2", 32, 5, pad=2, weight_filler=gaussian(0.01)),
        relu("relu2", "conv2"),
        pool("pool2", "conv2", "pool2", "AVE", 3, 2),
        conv("conv3", "pool2", "conv3", 64, 5, pad=2, weight_filler=gaussian(0.01)),
        relu("relu3", "conv3"),
        pool("pool3", "conv3", "pool3", "AVE", 3, 2),
        ip("ip1", "pool3", "ip1", 64, weight_filler=gaussian(0.1)),
        ip("ip2", "ip1", "ip2", 10, weight_filler=gaussian(0.1)),
        softmax_loss("loss", ["ip2", "label"]),
    ]
    if with_accuracy:
        layers.insert(-1, accuracy("accuracy", ["ip2", "label"]))
    return NetParameter(name="CIFAR10_quick", layers=layers)


def cifar10_full(with_accuracy: bool = True) -> NetParameter:
    """examples/cifar10/cifar10_full_train_test.prototxt: the deeper CIFAR
    config — pool-before-relu stem, WITHIN_CHANNEL LRNs, heavy ip decay."""
    layers = [
        conv("conv1", "data", "conv1", 32, 5, pad=2,
             weight_filler=gaussian(1e-4)),
        pool("pool1", "conv1", "pool1", "MAX", 3, 2),
        relu("relu1", "pool1"),
        lrn("norm1", "pool1", "norm1", local_size=3, alpha=5e-5, beta=0.75,
            norm_region="WITHIN_CHANNEL"),
        conv("conv2", "norm1", "conv2", 32, 5, pad=2,
             weight_filler=gaussian(0.01)),
        relu("relu2", "conv2"),
        pool("pool2", "conv2", "pool2", "AVE", 3, 2),
        lrn("norm2", "pool2", "norm2", local_size=3, alpha=5e-5, beta=0.75,
            norm_region="WITHIN_CHANNEL"),
        conv("conv3", "norm2", "conv3", 64, 5, pad=2,
             weight_filler=gaussian(0.01), lr=(1, 1), decay=(1, 0)),
        relu("relu3", "conv3"),
        pool("pool3", "conv3", "pool3", "AVE", 3, 2),
        ip("ip1", "pool3", "ip1", 10, weight_filler=gaussian(0.01),
           decay=(250.0, 0.0)),
        softmax_loss("loss", ["ip1", "label"]),
    ]
    if with_accuracy:
        layers.insert(-1, accuracy("accuracy", ["ip1", "label"]))
    return NetParameter(name="CIFAR10_full", layers=layers)


def cifar10_shapes(batch: int) -> Dict[str, tuple]:
    return {"data": (batch, 3, 32, 32), "label": (batch,)}


# --------------------------------------------------------------------------- #
# AlexNet (models/bvlc_alexnet) — the FC-heavy SFB benchmark model
# --------------------------------------------------------------------------- #

def alexnet(num_classes: int = 1000, with_accuracy: bool = True) -> NetParameter:
    layers = [
        conv("conv1", "data", "conv1", 96, 11, stride=4,
             weight_filler=gaussian(0.01)),
        relu("relu1", "conv1"),
        lrn("norm1", "conv1", "norm1"),
        pool("pool1", "norm1", "pool1", "MAX", 3, 2),
        conv("conv2", "pool1", "conv2", 256, 5, pad=2, group=2,
             weight_filler=gaussian(0.01), bias_value=0.1),
        relu("relu2", "conv2"),
        lrn("norm2", "conv2", "norm2"),
        pool("pool2", "norm2", "pool2", "MAX", 3, 2),
        conv("conv3", "pool2", "conv3", 384, 3, pad=1,
             weight_filler=gaussian(0.01)),
        relu("relu3", "conv3"),
        conv("conv4", "conv3", "conv4", 384, 3, pad=1, group=2,
             weight_filler=gaussian(0.01), bias_value=0.1),
        relu("relu4", "conv4"),
        conv("conv5", "conv4", "conv5", 256, 3, pad=1, group=2,
             weight_filler=gaussian(0.01), bias_value=0.1),
        relu("relu5", "conv5"),
        pool("pool5", "conv5", "pool5", "MAX", 3, 2),
        ip("fc6", "pool5", "fc6", 4096, weight_filler=gaussian(0.005),
           bias_value=0.1),
        relu("relu6", "fc6"),
        dropout("drop6", "fc6", 0.5),
        ip("fc7", "fc6", "fc7", 4096, weight_filler=gaussian(0.005),
           bias_value=0.1),
        relu("relu7", "fc7"),
        dropout("drop7", "fc7", 0.5),
        ip("fc8", "fc7", "fc8", num_classes, weight_filler=gaussian(0.01)),
        softmax_loss("loss", ["fc8", "label"]),
    ]
    if with_accuracy:
        layers.insert(-1, accuracy("accuracy", ["fc8", "label"]))
    return NetParameter(name="AlexNet", layers=layers)


def alexnet_shapes(batch: int) -> Dict[str, tuple]:
    return {"data": (batch, 3, 227, 227), "label": (batch,)}


# --------------------------------------------------------------------------- #
# GoogLeNet (models/bvlc_googlenet) — the conv-heavy dense-psum benchmark model
# --------------------------------------------------------------------------- #

def _inception(name: str, bottom: str, c1: int, c3r: int, c3: int,
               c5r: int, c5: int, cp: int) -> Tuple[List[LayerParameter], str]:
    """One inception module; returns (layers, output blob name)."""
    n = f"inception_{name}"
    ls = [
        conv(f"{n}/1x1", bottom, f"{n}/1x1", c1, 1,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{n}/relu_1x1", f"{n}/1x1"),
        conv(f"{n}/3x3_reduce", bottom, f"{n}/3x3_reduce", c3r, 1,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{n}/relu_3x3_reduce", f"{n}/3x3_reduce"),
        conv(f"{n}/3x3", f"{n}/3x3_reduce", f"{n}/3x3", c3, 3, pad=1,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{n}/relu_3x3", f"{n}/3x3"),
        conv(f"{n}/5x5_reduce", bottom, f"{n}/5x5_reduce", c5r, 1,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{n}/relu_5x5_reduce", f"{n}/5x5_reduce"),
        conv(f"{n}/5x5", f"{n}/5x5_reduce", f"{n}/5x5", c5, 5, pad=2,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{n}/relu_5x5", f"{n}/5x5"),
        pool(f"{n}/pool", bottom, f"{n}/pool", "MAX", 3, 1, pad=1),
        conv(f"{n}/pool_proj", f"{n}/pool", f"{n}/pool_proj", cp, 1,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{n}/relu_pool_proj", f"{n}/pool_proj"),
        LayerParameter(
            name=f"{n}/output", type="CONCAT",
            bottom=[f"{n}/1x1", f"{n}/3x3", f"{n}/5x5", f"{n}/pool_proj"],
            top=[f"{n}/output"]),
    ]
    return ls, f"{n}/output"


def _aux_head(tag: str, bottom: str, num_classes: int) -> List[LayerParameter]:
    p = f"loss{tag}"
    return [
        pool(f"{p}/ave_pool", bottom, f"{p}/ave_pool", "AVE", 5, 3),
        conv(f"{p}/conv", f"{p}/ave_pool", f"{p}/conv", 128, 1,
             weight_filler=xavier(), bias_value=0.2),
        relu(f"{p}/relu_conv", f"{p}/conv"),
        ip(f"{p}/fc", f"{p}/conv", f"{p}/fc", 1024,
           weight_filler=xavier(), bias_value=0.2),
        relu(f"{p}/relu_fc", f"{p}/fc"),
        dropout(f"{p}/drop_fc", f"{p}/fc", 0.7),
        ip(f"{p}/classifier", f"{p}/fc", f"{p}/classifier", num_classes,
           weight_filler=xavier()),
        LayerParameter(
            name=f"{p}/loss", type="SOFTMAX_LOSS",
            bottom=[f"{p}/classifier", "label"], top=[f"{p}/loss"],
            loss_weight=[0.3], include=[NetStateRule(phase="TRAIN")]),
    ]


def googlenet(num_classes: int = 1000, with_accuracy: bool = True,
              aux_heads: bool = True) -> NetParameter:
    layers: List[LayerParameter] = [
        conv("conv1/7x7_s2", "data", "conv1/7x7_s2", 64, 7, stride=2, pad=3,
             weight_filler=xavier(), bias_value=0.2),
        relu("conv1/relu_7x7", "conv1/7x7_s2"),
        pool("pool1/3x3_s2", "conv1/7x7_s2", "pool1/3x3_s2", "MAX", 3, 2),
        lrn("pool1/norm1", "pool1/3x3_s2", "pool1/norm1"),
        conv("conv2/3x3_reduce", "pool1/norm1", "conv2/3x3_reduce", 64, 1,
             weight_filler=xavier(), bias_value=0.2),
        relu("conv2/relu_3x3_reduce", "conv2/3x3_reduce"),
        conv("conv2/3x3", "conv2/3x3_reduce", "conv2/3x3", 192, 3, pad=1,
             weight_filler=xavier(), bias_value=0.2),
        relu("conv2/relu_3x3", "conv2/3x3"),
        lrn("conv2/norm2", "conv2/3x3", "conv2/norm2"),
        pool("pool2/3x3_s2", "conv2/norm2", "pool2/3x3_s2", "MAX", 3, 2),
    ]
    cur = "pool2/3x3_s2"

    cfgs = {
        "3a": (64, 96, 128, 16, 32, 32),
        "3b": (128, 128, 192, 32, 96, 64),
        "4a": (192, 96, 208, 16, 48, 64),
        "4b": (160, 112, 224, 24, 64, 64),
        "4c": (128, 128, 256, 24, 64, 64),
        "4d": (112, 144, 288, 32, 64, 64),
        "4e": (256, 160, 320, 32, 128, 128),
        "5a": (256, 160, 320, 32, 128, 128),
        "5b": (384, 192, 384, 48, 128, 128),
    }
    for tag in ("3a", "3b"):
        ls, cur = _inception(tag, cur, *cfgs[tag])
        layers += ls
    layers.append(pool("pool3/3x3_s2", cur, "pool3/3x3_s2", "MAX", 3, 2))
    cur = "pool3/3x3_s2"
    for tag in ("4a", "4b", "4c", "4d", "4e"):
        ls, cur = _inception(tag, cur, *cfgs[tag])
        layers += ls
        if aux_heads and tag == "4a":
            layers += _aux_head("1", cur, num_classes)
        if aux_heads and tag == "4d":
            layers += _aux_head("2", cur, num_classes)
    layers.append(pool("pool4/3x3_s2", cur, "pool4/3x3_s2", "MAX", 3, 2))
    cur = "pool4/3x3_s2"
    for tag in ("5a", "5b"):
        ls, cur = _inception(tag, cur, *cfgs[tag])
        layers += ls
    layers += [
        pool("pool5/7x7_s1", cur, "pool5/7x7_s1", "AVE", 7, 1),
        dropout("pool5/drop_7x7_s1", "pool5/7x7_s1", 0.4),
        ip("loss3/classifier", "pool5/7x7_s1", "loss3/classifier", num_classes,
           weight_filler=xavier()),
        softmax_loss("loss3/loss3", ["loss3/classifier", "label"], "loss3"),
    ]
    if with_accuracy:
        layers.insert(-1, accuracy("loss3/top-1", ["loss3/classifier", "label"]))
    return NetParameter(name="GoogleNet", layers=layers)


def googlenet_shapes(batch: int) -> Dict[str, tuple]:
    return {"data": (batch, 3, 224, 224), "label": (batch,)}


ZOO = {
    "lenet": (lenet, lenet_shapes),
    "cifar10_quick": (cifar10_quick, cifar10_shapes),
    "alexnet": (alexnet, alexnet_shapes),
    "googlenet": (googlenet, googlenet_shapes),
}


# --------------------------------------------------------------------------- #
# CaffeNet (models/bvlc_reference_caffenet) — AlexNet variant with
# pool-before-norm ordering; also the backbone of the reference's R-CNN
# (models/bvlc_reference_rcnn_ilsvrc13) and flickr-style finetuning models.
# --------------------------------------------------------------------------- #

def caffenet(num_classes: int = 1000, with_accuracy: bool = True,
             classifier_name: str = "fc8") -> NetParameter:
    layers = [
        conv("conv1", "data", "conv1", 96, 11, stride=4,
             weight_filler=gaussian(0.01)),
        relu("relu1", "conv1"),
        pool("pool1", "conv1", "pool1", "MAX", 3, 2),
        lrn("norm1", "pool1", "norm1"),
        conv("conv2", "norm1", "conv2", 256, 5, pad=2, group=2,
             weight_filler=gaussian(0.01), bias_value=1.0),
        relu("relu2", "conv2"),
        pool("pool2", "conv2", "pool2", "MAX", 3, 2),
        lrn("norm2", "pool2", "norm2"),
        conv("conv3", "norm2", "conv3", 384, 3, pad=1,
             weight_filler=gaussian(0.01)),
        relu("relu3", "conv3"),
        conv("conv4", "conv3", "conv4", 384, 3, pad=1, group=2,
             weight_filler=gaussian(0.01), bias_value=1.0),
        relu("relu4", "conv4"),
        conv("conv5", "conv4", "conv5", 256, 3, pad=1, group=2,
             weight_filler=gaussian(0.01), bias_value=1.0),
        relu("relu5", "conv5"),
        pool("pool5", "conv5", "pool5", "MAX", 3, 2),
        ip("fc6", "pool5", "fc6", 4096, weight_filler=gaussian(0.005),
           bias_value=1.0),
        relu("relu6", "fc6"),
        dropout("drop6", "fc6", 0.5),
        ip("fc7", "fc6", "fc7", 4096, weight_filler=gaussian(0.005),
           bias_value=1.0),
        relu("relu7", "fc7"),
        dropout("drop7", "fc7", 0.5),
        ip(classifier_name, "fc7", classifier_name, num_classes,
           weight_filler=gaussian(0.01)),
        softmax_loss("loss", [classifier_name, "label"]),
    ]
    if with_accuracy:
        layers.insert(-1, accuracy("accuracy", [classifier_name, "label"]))
    return NetParameter(name="CaffeNet", layers=layers)


def caffenet_shapes(batch: int) -> Dict[str, tuple]:
    return {"data": (batch, 3, 227, 227), "label": (batch,)}


def rcnn_ilsvrc13(num_classes: int = 200) -> NetParameter:
    """R-CNN detection head (models/bvlc_reference_rcnn_ilsvrc13): CaffeNet
    backbone scoring warped window crops; trains from WINDOW_DATA."""
    net = caffenet(num_classes=num_classes, with_accuracy=True,
                   classifier_name="fc-rcnn")
    net.name = "R-CNN-ilsvrc13"
    return net


def finetune_flickr_style(num_classes: int = 20) -> NetParameter:
    """Finetuning recipe (models/finetune_flickr_style upstream): CaffeNet
    with a fresh, faster-learning classifier layer."""
    net = caffenet(num_classes=num_classes, with_accuracy=True,
                   classifier_name="fc8_flickr")
    for lp in net.layers:
        if lp.name == "fc8_flickr":
            lp.blobs_lr = [10.0, 20.0]  # fresh head learns 10x faster
    net.name = "FlickrStyleCaffeNet"
    return net


ZOO.update({
    "caffenet": (caffenet, caffenet_shapes),
    "rcnn_ilsvrc13": (rcnn_ilsvrc13, caffenet_shapes),
    "finetune_flickr_style": (finetune_flickr_style, caffenet_shapes),
})
