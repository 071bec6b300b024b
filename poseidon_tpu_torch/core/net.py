"""Net: a prototxt-defined DAG as an ``nn.Module`` (the port of
``poseidon_tpu/core/net.py``, TEST-phase serving subset).

Construction filters the layers by phase (``filter_net``), takes the deploy
net's ``input:``/``input_dim:`` blobs, infers every blob shape, declares the
parameters, and folds each in-place ReLU that directly follows a conv into
the conv's epilogue (``_plan_epilogues``, the same fold the JAX package
makes, so both give the same blobs).

Parameters are a plain ``{layer: {"w": tensor, "b": tensor}}`` tree on the
net's device, the layout of the JAX package's params (OIHW conv weights,
(out, in) fc weights). ``forward(inputs, params=None)`` runs the graph in
order, rebinding each top name as it is produced, so in-place layers
(``relu1: conv1 -> conv1``) behave as in Caffe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..numeric import apply_f32_policy, resolve_device
from ..proto.messages import LayerParameter, NetParameter, NetState
from .blob import ParamDef
from .fillers import fill
from .layers import Layer, create_layer

Shape = Tuple[int, ...]
Params = Dict[str, Dict[str, torch.Tensor]]


def filter_net(net_param: NetParameter,
               state: NetState) -> List[LayerParameter]:
    """Phase/level/stage filtering with Caffe's include/exclude rules."""
    out = []
    for lp in net_param.layers:
        if lp.include and lp.exclude:
            raise ValueError(
                f"layer {lp.name!r}: specify include or exclude, not both")
        if lp.include:
            keep = any(r.matches(state) for r in lp.include)
        elif lp.exclude:
            keep = not any(r.matches(state) for r in lp.exclude)
        else:
            keep = True
        if keep:
            out.append(lp)
    return out


class Net(nn.Module):
    def __init__(self, net_param: NetParameter, phase: str = "TEST",
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        apply_f32_policy()
        self.net_param = net_param
        self.phase = phase
        self.state = NetState(phase=phase)
        self.name = net_param.name

        blob_shapes: Dict[str, Shape] = {}
        if net_param.input:
            dims = net_param.input_dim
            if len(dims) != 4 * len(net_param.input):
                raise ValueError("input_dim must have 4 entries per input")
            for i, name in enumerate(net_param.input):
                blob_shapes[name] = tuple(dims[4 * i:4 * i + 4])

        layers: List[Layer] = []
        for lp in filter_net(net_param, self.state):
            layer = create_layer(lp)
            bottoms = []
            for b in lp.bottom:
                if b not in blob_shapes:
                    raise ValueError(
                        f"layer {lp.name!r}: unknown bottom {b!r}")
                bottoms.append(blob_shapes[b])
            tops = layer.setup(bottoms)
            if len(tops) != len(lp.top):
                raise ValueError(
                    f"layer {lp.name!r}: produced {len(tops)} tops, "
                    f"declared {len(lp.top)}")
            for name, shape in zip(lp.top, tops):
                blob_shapes[name] = tuple(int(d) for d in shape)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.blob_shapes = blob_shapes
        self.input_names: List[str] = list(net_param.input)

        produced, consumed = [], set()
        for layer in self.layers:
            consumed.update(layer.lp.bottom)
            for t in layer.lp.top:
                if t not in produced:
                    produced.append(t)
        self.output_names = [t for t in produced if t not in consumed]

        self.param_defs: Dict[str, List[ParamDef]] = {
            layer.name: layer.params for layer in self.layers if layer.params}
        self._layer_by_name = {l.name: l for l in self.layers}
        self._plan_epilogues()
        self.params: Optional[Params] = None

    def _plan_epilogues(self) -> None:
        """Fold each in-place ReLU that immediately consumes a conv's top
        into the conv's epilogue. Skipped when any layer touches the blob
        in between, or when the conv's top carries a loss_weight."""
        for i, layer in enumerate(self.layers):
            if layer.TYPE != "CONVOLUTION" or len(layer.lp.top) != 1:
                continue
            if layer.lp.loss_weight:
                continue
            top = layer.lp.top[0]
            for nxt in self.layers[i + 1:]:
                if (nxt.TYPE == "RELU" and nxt.lp.bottom == [top]
                        and nxt.lp.top == [top]):
                    layer.fused_relu_slope = nxt.lp.relu_param.negative_slope
                    nxt.folded_into = layer.name
                    break
                if top in nxt.lp.bottom or top in nxt.lp.top:
                    break

    def param_count(self) -> int:
        return sum(p.count for defs in self.param_defs.values() for p in defs)

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> Params:
        """Filler-initialize every parameter from ``generator`` (a CPU
        generator; layers in sorted name order, as the JAX package walks
        them), place the tree on the net's device, and keep it as
        ``self.params``."""
        params: Params = {}
        for lname in sorted(self.param_defs):
            params[lname] = {p.name: fill(generator, p).to(self.device)
                             for p in self.param_defs[lname]}
        self.params = params
        return params

    def to_device_params(self, tree) -> Params:
        """Validate a {layer: {param: array or tensor}} tree against the
        net's ParamDefs and return it as float32 tensors on the net's
        device (tensors already there are used as they are)."""
        out: Params = {}
        for lname, defs in self.param_defs.items():
            if lname not in tree:
                raise ValueError(f"params missing layer {lname!r}")
            out[lname] = {}
            for pdef in defs:
                if pdef.name not in tree[lname]:
                    raise ValueError(
                        f"params missing {lname!r}/{pdef.name!r}")
                v = tree[lname][pdef.name]
                t = (v if isinstance(v, torch.Tensor) else
                     torch.from_numpy(np.array(v, np.float32)))
                if tuple(t.shape) != pdef.shape:
                    raise ValueError(
                        f"{lname}/{pdef.name}: shape {tuple(t.shape)} != "
                        f"defined {pdef.shape}")
                out[lname][pdef.name] = t.to(self.device, torch.float32)
        return out

    # ------------------------------------------------------------------ #
    def forward(self, inputs: Dict[str, torch.Tensor],
                params: Optional[Params] = None,
                keep_blobs: bool = False) -> Dict[str, torch.Tensor]:
        """Run the graph; returns the output blobs (every blob, by its last
        value, with ``keep_blobs``)."""
        if params is None:
            params = self.params
        if params is None:
            raise RuntimeError("net has no params: call init() or pass "
                               "params=")
        train = self.phase == "TRAIN"
        blobs: Dict[str, torch.Tensor] = dict(inputs)
        for layer in self.layers:
            bottoms = [blobs[b] for b in layer.lp.bottom]
            tops = layer(params.get(layer.name, {}), bottoms, train)
            for name, val in zip(layer.lp.top, tops):
                blobs[name] = val
        if keep_blobs:
            return blobs
        return {name: blobs[name] for name in self.output_names}

    # ------------------------------------------------------------------ #
    def load_weights(self, params: Params,
                     layer_weights: Dict[str, List[np.ndarray]],
                     strict: bool = False) -> Params:
        """Caffe's CopyTrainedLayersFrom: merge {layer: [blob arrays]} by
        name and order (blobs reshaped to the defined shapes); unknown
        layers are ignored unless ``strict``."""
        new_params = {k: dict(v) for k, v in params.items()}
        for lname, arrays in layer_weights.items():
            layer = self._layer_by_name.get(lname)
            if layer is None or not layer.params:
                if strict:
                    raise KeyError(f"no such param layer {lname!r}")
                continue
            if len(arrays) != len(layer.params):
                raise ValueError(f"{lname}: {len(arrays)} blobs in file, "
                                 f"{len(layer.params)} in net")
            for pdef, arr in zip(layer.params, arrays):
                arr = np.asarray(arr, np.float32)
                if int(arr.size) != pdef.count:
                    raise ValueError(f"{lname}/{pdef.name}: count mismatch "
                                     f"{arr.size} vs {pdef.count}")
                new_params[lname][pdef.name] = torch.from_numpy(
                    arr.reshape(pdef.shape).copy()).to(self.device)
        return new_params

    def export_weights(self, params: Optional[Params] = None
                       ) -> Dict[str, List[np.ndarray]]:
        """Every param layer's blobs as numpy arrays, in Caffe's order."""
        params = self.params if params is None else params
        return {layer.name: [params[layer.name][p.name].detach().cpu()
                             .numpy() for p in layer.params]
                for layer in self.layers if layer.params}


def params_from_jax(net: Net, params) -> Params:
    """Load the JAX package's ``{layer: {"w", "b"}}`` params (as numpy
    arrays: OIHW conv and (out, in) fc weights, the layout torch uses) into
    ``net``; returns the device tree, also kept as ``net.params``."""
    net.params = net.to_device_params(
        {layer: {p: np.asarray(v) for p, v in d.items()}
         for layer, d in params.items()})
    return net.params
