"""V0 legacy prototxt upgrade (upgrade_proto.cpp:15-506 semantics).

The oldest Caffe format nests a flat ``V0LayerParameter`` under each
connection: ``layers { layer { name: "c1" type: "conv" num_output: 96 ... }
bottom: "data" top: "c1" }``. The reference upgrades these in two passes
(``UpgradeV0Net``):

1. ``UpgradeV0PaddingLayers`` — V0 modeled padding as a separate "padding"
   layer feeding a conv/pool; the upgrade deletes it, folds its ``pad`` into
   the consumer, and rewires the consumer's bottom to the padding layer's
   input.
2. ``UpgradeLayerParameter`` — scatter the flat V0 fields into the typed V1
   parameter messages (num_output -> convolution/inner_product_param, pad/
   kernelsize/stride -> convolution/pooling_param, scale/meanfile/cropsize/
   mirror -> transform_param, source/batchsize -> the per-backend data
   params, det_* -> window_data_param, ...), and map the lowercase type
   strings to V1 enum names (``UpgradeV0LayerType``).

Scoped to the fields the reference's V0 path actually rewrites; unknown V0
fields raise rather than silently dropping (the reference logs
is_fully_compatible=false — we fail loudly instead).
"""

from __future__ import annotations

from typing import List

from .prototxt import Node, PrototxtError

# UpgradeV0LayerType (upgrade_proto.cpp:453-506)
V0_TYPE_TO_V1 = {
    "accuracy": "ACCURACY",
    "bnll": "BNLL",
    "concat": "CONCAT",
    "conv": "CONVOLUTION",
    "data": "DATA",
    "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS",
    "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA",
    "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL",
    "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS",
    "innerproduct": "INNER_PRODUCT",
    "lrn": "LRN",
    "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING",
    "relu": "RELU",
    "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX",
    "softmax_loss": "SOFTMAX_LOSS",
    "split": "SPLIT",
    "tanh": "TANH",
    "window_data": "WINDOW_DATA",
}

# flat V0 field -> (sub-message field name, {v0_type: param block name})
# (UpgradeLayerParameter's long if-chain, upgrade_proto.cpp:139-449)
_SCATTER = {
    "num_output": ("num_output", {"conv": "convolution_param",
                                  "innerproduct": "inner_product_param"}),
    "biasterm": ("bias_term", {"conv": "convolution_param",
                               "innerproduct": "inner_product_param"}),
    "weight_filler": ("weight_filler", {"conv": "convolution_param",
                                        "innerproduct":
                                        "inner_product_param"}),
    "bias_filler": ("bias_filler", {"conv": "convolution_param",
                                    "innerproduct": "inner_product_param"}),
    "pad": ("pad", {"conv": "convolution_param", "pool": "pooling_param"}),
    "kernelsize": ("kernel_size", {"conv": "convolution_param",
                                   "pool": "pooling_param"}),
    "group": ("group", {"conv": "convolution_param"}),
    "stride": ("stride", {"conv": "convolution_param",
                          "pool": "pooling_param"}),
    "pool": ("pool", {"pool": "pooling_param"}),
    "dropout_ratio": ("dropout_ratio", {"dropout": "dropout_param"}),
    "local_size": ("local_size", {"lrn": "lrn_param"}),
    "alpha": ("alpha", {"lrn": "lrn_param"}),
    "beta": ("beta", {"lrn": "lrn_param"}),
    "k": ("k", {"lrn": "lrn_param"}),
    "source": ("source", {"data": "data_param",
                          "hdf5_data": "hdf5_data_param",
                          "images": "image_data_param",
                          "window_data": "window_data_param",
                          "infogain_loss": "infogain_loss_param"}),
    "batchsize": ("batch_size", {"data": "data_param",
                                 "hdf5_data": "hdf5_data_param",
                                 "images": "image_data_param",
                                 "window_data": "window_data_param"}),
    "rand_skip": ("rand_skip", {"data": "data_param",
                                "images": "image_data_param"}),
    "shuffle_images": ("shuffle", {"images": "image_data_param"}),
    "new_height": ("new_height", {"images": "image_data_param"}),
    "new_width": ("new_width", {"images": "image_data_param"}),
    "concat_dim": ("concat_dim", {"concat": "concat_param"}),
    "det_fg_threshold": ("fg_threshold", {"window_data":
                                          "window_data_param"}),
    "det_bg_threshold": ("bg_threshold", {"window_data":
                                          "window_data_param"}),
    "det_fg_fraction": ("fg_fraction", {"window_data": "window_data_param"}),
    "det_context_pad": ("context_pad", {"window_data": "window_data_param"}),
    "det_crop_mode": ("crop_mode", {"window_data": "window_data_param"}),
}

# scattered into transform_param regardless of layer type
_TRANSFORM = {"scale": "scale", "meanfile": "mean_file",
              "cropsize": "crop_size", "mirror": "mirror"}

# copied through at the layer level
_PASSTHROUGH = {"name", "blobs", "blobs_lr", "weight_decay", "blob_mode"}


def net_needs_v0_upgrade(layer_nodes: List[Node]) -> bool:
    """NetNeedsUpgrade: any connection with a nested ``layer`` block."""
    return any(n.has("layer") for n in layer_nodes)


def upgrade_v0_layers(layer_nodes: List[Node]) -> List[Node]:
    """Both passes, at the parse-tree level: fold padding layers, then
    rewrite each V0 connection into a V1-shaped Node that the normal
    ``_build_layer`` path consumes."""
    return [_upgrade_layer(n) for n in _fold_padding(layer_nodes)]


def _v0_type(conn: Node) -> str:
    layer = conn.get("layer")
    return str(layer.get("type", "")) if layer is not None else ""


def _fold_padding(layer_nodes: List[Node]) -> List[Node]:
    """UpgradeV0PaddingLayers (upgrade_proto.cpp:51-110): drop "padding"
    layers, push their pad into the consuming conv/pool, rewire bottoms."""
    if not any(_v0_type(n) == "padding" for n in layer_nodes):
        return layer_nodes
    # blob name -> producing layer node (last writer wins, like the ref map)
    producer = {}
    out: List[Node] = []
    for conn in layer_nodes:
        lp = conn.get("layer")
        if _v0_type(conn) != "padding":
            new_conn = Node()
            for k, v in conn:
                if k != "bottom":
                    new_conn.add(k, v)
            for bottom in conn.get_all("bottom"):
                src = producer.get(str(bottom))
                if src is not None and _v0_type(src) == "padding":
                    t = _v0_type(conn)
                    if t not in ("conv", "pool"):
                        raise PrototxtError(
                            f"padding layer feeds non-conv/pool layer "
                            f"type {t!r} (undefined in Caffe)")
                    if len(src.get_all("bottom")) != 1 or \
                            len(src.get_all("top")) != 1:
                        raise PrototxtError(
                            "padding layer must have one bottom and one top")
                    # the consumer must be single-bottom too
                    # (upgrade_proto.cpp CHECK_EQ(bottom_size(), 1)):
                    # folding pad into a multi-input layer is undefined
                    if len(conn.get_all("bottom")) != 1:
                        raise PrototxtError(
                            f"layer consuming padding output must have "
                            f"exactly one bottom, got "
                            f"{len(conn.get_all('bottom'))}")
                    lp.add("pad", src.get("layer").get("pad"))
                    new_conn.add("bottom", src.get("bottom"))
                else:
                    new_conn.add("bottom", bottom)
            out.append(new_conn)
            conn = new_conn
        for top in conn.get_all("top"):
            producer[str(top)] = conn
    return out


def _upgrade_layer(conn: Node) -> Node:
    """UpgradeLayerParameter for one connection Node -> V1-shaped Node."""
    if not conn.has("layer"):
        return conn  # already V1 (mixed nets upgrade per layer)
    v0 = conn.get("layer")
    out = Node()
    for k, v in conn:
        if k != "layer":
            out.add(k, v)  # bottom / top / (stray V1 fields)

    vtype = str(v0.get("type", ""))
    params: dict = {}       # param block name -> Node
    transform: Node = Node()

    def block(name: str) -> Node:
        if name not in params:
            params[name] = Node()
        return params[name]

    for k, v in v0:
        if k == "type":
            if vtype not in V0_TYPE_TO_V1:
                raise PrototxtError(f"unknown V0 layer type {vtype!r}")
            out.add("type", V0_TYPE_TO_V1[vtype])
        elif k in _PASSTHROUGH:
            out.add(k, v)
        elif k in _TRANSFORM:
            transform.add(_TRANSFORM[k], v)
        elif k in _SCATTER:
            field_name, by_type = _SCATTER[k]
            if vtype not in by_type:
                raise PrototxtError(
                    f"V0 field {k!r} is not valid for layer type {vtype!r}")
            block(by_type[vtype]).add(field_name, v)
        elif k == "hdf5_output_param":
            out.add("hdf5_output_param", v)
        else:
            raise PrototxtError(
                f"V0 layer field {k!r} has no upgrade mapping")

    for name, node in params.items():
        out.add(name, node)
    if transform.fields:
        out.add("transform_param", transform)
    return out
