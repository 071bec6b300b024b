"""Net: a prototxt-defined DAG as an ``nn.Module`` (the port of
``poseidon_tpu/core/net.py``, TRAIN and TEST phases, NCHW or NHWC).

Construction filters the layers by phase (``filter_net``), takes the deploy
net's ``input:``/``input_dim:`` blobs and the data layers' tops (shapes
from ``source_shapes``, as the data pipeline gives them) as external
inputs, infers every blob shape, declares the parameters, and folds each
in-place ReLU that directly follows a conv into the conv's epilogue
(``_plan_epilogues``, the same fold the JAX package makes, so both give the
same blobs).

The activation layout is a graph-level plan fixed at construction
(``conv_layout``: the argument, else the numeric policy's; "auto" resolved
per device by ``numeric.resolve_conv_layout``), applied the torch way:
under "NHWC" every 4-D external input becomes ``torch.channels_last`` at
entry and the bottoms of the spatial layers (conv, pooling, LRN) are
brought to it, as JAX's ``_plan_layouts`` runs them NHWC; ReLU and concat
keep their inputs' memory format; logical shapes stay NCHW, so the inner
product's flatten is the genuine boundary (one gather into Caffe's
C-major order). A 4-D dropout draws its mask over the logical NCHW shape,
so its units are the same in both layouts (JAX makes dropout a
canonical-layout layer for this). Parameters, their gradients and
snapshots stay canonical OIHW/NCHW in either layout. ``conv_strategy``
(the argument, else the policy's) is planned per conv layer
(``_plan_conv_strategies``): "" leaves each conv to the policy's
``conv_s2d``, a concrete strategy goes to every conv, and "auto" takes a
measured winner per layer from ``ops/conv_tune.py`` (geometry-keyed, so
shape-identical layers measure once; persisted in the tuned store).

Parameters are a plain ``{layer: {"w": tensor, "b": tensor}}`` tree on the
net's device, the layout of the JAX package's params (OIHW conv weights,
(out, in) fc weights). Shared (named) params, JAX's port of Caffe's
weight sharing (siamese nets): a blob whose ``param`` name an earlier
layer declared is stored once, under that owner; ``param_defs`` and the
tree hold owners only and ``_storage_of`` routes each sharer to its
owner, after the owner's checks (STRICT shape or PERMISSIVE count, from
``blob_share_mode`` in a V1 net and ``share_mode`` in a V2 one; equal lr
and decay multipliers). Autograd sums every sharer's gradient into the
one leaf, so the arena, the DWBP order and the update see owners only.
``load_weights`` and ``export_weights`` take and give Caffe's layout,
where each sharer repeats its owner's blob. ``apply(params, inputs)``
runs the graph in order, rebinding each top name as it is produced, so
in-place layers (``relu1: conv1 -> conv1``) behave as in Caffe, and
returns the loss (sum over tops of loss_weight * top, Caffe's objective)
with the outputs.
Backward is autograd through ``apply``. DUMMY_DATA draws its tops in the
graph, from a generator on the net's device that ``manual_seed`` derives
from the net's seed and the layer's index.

The DWBP-ordered parameter table (REVERSE forward layer order, the order
gradients materialize during backward) lays out the flat parameter arena
(``arena_layout``, ``core/arena.py``) the training step packs parameters,
gradients and momentum into.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..numeric import (apply_policy, check_conv_strategy, policy,
                       resolve_conv_layout, resolve_device)
from ..proto.messages import LayerParameter, NetParameter, NetState
from .blob import ParamDef
from .fillers import fill
from .layers import DATA_SOURCE_TYPES, Layer, create_layer
from ..runtime.attribution import scope
from .remat import RematRng, checkpoint_layer

Shape = Tuple[int, ...]
Params = Dict[str, Dict[str, torch.Tensor]]


# the layers that run natively in the planned layout (JAX's
# LAYOUT_SPATIAL); the others keep whatever memory format they are given
SPATIAL_TYPES = frozenset({"CONVOLUTION", "POOLING", "LRN"})


def to_channels_last(t: torch.Tensor) -> torch.Tensor:
    """A 4-D tensor in ``torch.channels_last`` (itself when it already is);
    anything else as it is."""
    if t.dim() != 4:
        return t
    return t.contiguous(memory_format=torch.channels_last)


@dataclass
class NetOutputs:
    loss: torch.Tensor
    outputs: Dict[str, torch.Tensor]
    blobs: Dict[str, torch.Tensor] = field(default_factory=dict)


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
                 device=None, source_shapes: Optional[Dict[str, Shape]] = None,
                 conv_layout: Optional[str] = None,
                 conv_strategy: Optional[str] = None):
        super().__init__()
        self.device = resolve_device(device)
        apply_policy()
        self.conv_layout = resolve_conv_layout(
            conv_layout or policy().conv_layout, self.device.type)
        self.conv_strategy = check_conv_strategy(
            conv_strategy if conv_strategy is not None
            else policy().conv_strategy)
        self.net_param = net_param
        self.phase = phase
        self.state = NetState(phase=phase)
        self.name = net_param.name
        # the dropout masks' random stream, on the net's device; the engine
        # reseeds it from the solver's random_seed
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        # how a checkpointed DROPOUT replays its mask (``apply(remat=)``)
        self.remat_rng = RematRng(self.generator)

        blob_shapes: Dict[str, Shape] = {}
        if net_param.input:
            dims = net_param.input_dim
            if len(dims) != 4 * len(net_param.input):
                raise ValueError("input_dim must have 4 entries per input")
            for i, name in enumerate(net_param.input):
                blob_shapes[name] = tuple(dims[4 * i:4 * i + 4])
        # any supplied source shape is an external input (the tops of data
        # layers, or direct feeds)
        source_shapes = dict(source_shapes or {})
        for name, shape in source_shapes.items():
            blob_shapes[name] = tuple(shape)

        layers: List[Layer] = []
        source_tops: List[str] = []
        for idx, lp in enumerate(filter_net(net_param, self.state)):
            if lp.canonical_type() in DATA_SOURCE_TYPES:
                for top in lp.top:
                    if top not in source_shapes:
                        raise ValueError(
                            f"data layer {lp.name!r}: shape for top {top!r} "
                            f"must be supplied via source_shapes")
                    source_tops.append(top)
                continue
            layer = create_layer(lp, idx)
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
        for name in list(source_shapes) + source_tops:
            if name not in self.input_names:
                self.input_names.append(name)
        for layer in self.layers:
            if layer.TYPE == "DROPOUT":
                layer.generator = self.generator
            if layer.TYPE == "DUMMY_DATA":
                layer.generator = torch.Generator(device=self.device)
        self._plan_conv_strategies()
        self.manual_seed(0)

        produced, consumed = [], set()
        for layer in self.layers:
            consumed.update(layer.lp.bottom)
            for t in layer.lp.top:
                if t not in produced:
                    produced.append(t)
        self.output_names = [t for t in produced if t not in consumed]

        self._plan_sharing()
        self._layer_by_name = {l.name: l for l in self.layers}
        # the static arena offset table: every ParamDef in DWBP order
        # (reverse forward layer order), as the JAX package orders it
        self._arena_order: List[Tuple[str, ParamDef]] = [
            (layer.name, pdef)
            for layer in reversed(self.layers)
            if layer.name in self.param_defs
            for pdef in self.param_defs[layer.name]]
        self._arena_layouts: Dict = {}
        self._plan_epilogues()
        self.params: Optional[Params] = None

    def _plan_sharing(self) -> None:
        """``param_defs`` (owners only) and ``_storage_of`` ((layer,
        param) -> its owner's), with JAX's checks and messages."""
        self.param_defs: Dict[str, List[ParamDef]] = {}
        self._storage_of: Dict[Tuple[str, str], Tuple[str, str]] = {}
        shared_owner: Dict[str, Tuple[str, str, ParamDef]] = {}
        for layer in self.layers:
            owned: List[ParamDef] = []
            for i, pdef in enumerate(layer.params):
                spec = layer.lp.param_spec(i)
                share_name = spec.name
                if share_name and share_name in shared_owner:
                    olayer, opname, odef = shared_owner[share_name]
                    mode = (layer.lp.blob_share_mode[i]
                            if i < len(layer.lp.blob_share_mode)
                            else spec.share_mode)
                    if (spec.lr_mult, spec.decay_mult) != (odef.lr_mult,
                                                           odef.decay_mult):
                        raise ValueError(
                            f"layer {layer.name!r}: shared param "
                            f"{share_name!r} lr/decay multipliers "
                            f"({spec.lr_mult}, {spec.decay_mult}) differ "
                            f"from owner {olayer!r}'s ({odef.lr_mult}, "
                            f"{odef.decay_mult})")
                    if mode == "PERMISSIVE":
                        if pdef.count != odef.count:
                            raise ValueError(
                                f"layer {layer.name!r}: shared param "
                                f"{share_name!r} count mismatch "
                                f"{pdef.count} vs {odef.count}")
                    elif pdef.shape != odef.shape:
                        raise ValueError(
                            f"layer {layer.name!r}: shared param "
                            f"{share_name!r} shape mismatch "
                            f"{pdef.shape} vs {odef.shape}")
                    self._storage_of[(layer.name, pdef.name)] = (olayer,
                                                                 opname)
                else:
                    if share_name:
                        shared_owner[share_name] = (layer.name, pdef.name,
                                                    pdef)
                    self._storage_of[(layer.name, pdef.name)] = (layer.name,
                                                                 pdef.name)
                    owned.append(pdef)
            if owned:
                self.param_defs[layer.name] = owned

    def _plan_conv_strategies(self) -> None:
        """Each conv layer's lowering (JAX's ``_plan_conv_strategies``):
        "" leaves the policy's ``conv_s2d`` to decide; a concrete strategy
        goes to every conv; "auto" resolves a measured winner per layer
        through ``ops/conv_tune.py`` on this net's device and layout and
        logs ``[conv_strategy] ...`` a layer."""
        req = self.conv_strategy
        convs = [l for l in self.layers if l.TYPE == "CONVOLUTION"]
        if not req or not convs:
            return
        if req != "auto":
            for layer in convs:
                layer.conv_strategy = req
            return
        from ..ops import conv_tune
        from ..runtime.metrics import log
        for layer in convs:
            n, c, h, w = self.blob_shapes[layer.lp.bottom[0]]
            doc = conv_tune.resolve(
                layer.name, c, h, w, layer.kernel, layer.stride, layer.pad,
                layer.group, layer.params[0].shape[0], self.conv_layout, n,
                device=self.device)
            layer.conv_strategy = doc["winner"]
            log(f"[conv_strategy] {conv_tune.describe(doc)}")

    def conv_strategy_plan(self) -> Dict[str, Optional[str]]:
        """{conv layer name: its strategy, None where the policy's
        conv_s2d decides} (JAX's)."""
        return {l.name: l.conv_strategy or None for l in self.layers
                if l.TYPE == "CONVOLUTION"}

    def manual_seed(self, seed: int) -> "Net":
        """Seed the dropout generator with ``seed`` and each DUMMY_DATA
        layer's with a seed derived from (``seed``, the layer's index)."""
        self.generator.manual_seed(seed)
        for layer in self.layers:
            if layer.TYPE == "DUMMY_DATA":
                digest = hashlib.blake2b(f"{seed}/{layer.index}".encode(),
                                         digest_size=8).digest()
                layer.generator.manual_seed(
                    int.from_bytes(digest, "little") >> 1)
        return self

    def arena_layout(self, bucket_mb: float = 4.0, align: int = 1,
                     layers=None):
        """The flat-parameter-arena layout over the DWBP-ordered table (of
        the ``layers`` given, else every param layer), cut into
        ~``bucket_mb`` MB buckets aligned to ``align``; cached. None when
        nothing qualifies."""
        from .arena import build_arena
        key = (bucket_mb, align, None if layers is None
               else frozenset(layers))
        if key not in self._arena_layouts:
            self._arena_layouts[key] = build_arena(
                self._arena_order, bucket_mb, align, key[2])
        return self._arena_layouts[key]

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
    def apply(self, params: Optional[Params],
              inputs: Dict[str, torch.Tensor], train: Optional[bool] = None,
              keep_blobs: bool = False, comm=None, remat=None) -> NetOutputs:
        """Run the graph: the loss (Caffe's objective, sum over tops of
        loss_weight * top, in f32), the output blobs, and every blob by its
        last value with ``keep_blobs``. ``train`` defaults to the phase.
        ``comm`` (a ``parallel/strategies.CommContext``) runs each of its
        ``routed_layers`` through its ``layer_product`` (the
        sufficient-factor product, or a tensor-parallel shard's on a
        named mesh). A leaf whose shape differs from its definition is
        reshaped when its count agrees; otherwise only a leaf the comm's
        plan tensor-shards may pass (JAX's ``_layer_params``).

        ``remat`` names layers (usually ``core/remat.RematPlan.layer_set``)
        whose forward bodies run under ``torch.utils.checkpoint``
        (non-reentrant): their internal activations are dropped after the
        forward and recomputed from the stored bottoms and params during
        backward; a checkpointed DROPOUT draws its forward's mask again
        (``core/remat.RematRng``). The math is unchanged, so remat arms
        are bitwise equal to stored arms. Unknown names raise. While a
        profiler records, each layer runs inside a ``record_function``
        range named after it (``runtime/attribution.scope``)."""
        if params is None:
            params = self.params
        if params is None:
            raise RuntimeError("net has no params: call init() or pass "
                               "params=")
        if train is None:
            train = self.phase == "TRAIN"
        remat_set = frozenset(remat) if remat else frozenset()
        unknown = remat_set - set(self._layer_by_name)
        if unknown:
            raise ValueError(f"remat names unknown layers: "
                             f"{sorted(unknown)}")
        nhwc = self.conv_layout == "NHWC"
        blobs: Dict[str, torch.Tensor] = {
            k: to_channels_last(v) if nhwc else v for k, v in inputs.items()}
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            bottoms = [blobs[b] for b in layer.lp.bottom]
            if nhwc and layer.TYPE in SPATIAL_TYPES:
                bottoms = [to_channels_last(b) for b in bottoms]
            lparams = self._layer_params(params, layer, comm)
            # the layer's range for a profiler's attribution (a no-op
            # unless one records)
            with scope(layer.name):
                if layer.name in remat_set:
                    tops = self._checkpointed(layer, lparams, bottoms,
                                              train, comm)
                else:
                    tops = self._run_layer(layer, lparams, bottoms, train,
                                           comm)
            weights = layer.loss_weights(len(tops))
            for name, val, w in zip(layer.lp.top, tops, weights):
                blobs[name] = val
                if w:
                    loss = loss + w * val.float().sum()
        return NetOutputs(
            loss=loss,
            outputs={name: blobs[name] for name in self.output_names},
            blobs=blobs if keep_blobs else {})

    @staticmethod
    def _run_layer(layer: Layer, lparams, bottoms, train, comm):
        if comm is not None and layer.name in comm.routed_layers:
            return [comm.layer_product(layer.name, bottoms[0], lparams["w"],
                                       lparams.get("b"))]
        return layer(lparams, bottoms, train)

    def _checkpointed(self, layer: Layer, lparams, bottoms, train, comm):
        """The layer's forward body under a checkpoint: its params and
        bottoms are the checkpoint's inputs, its tops come out."""
        names = list(lparams)

        def body(*args):
            # the layer's range inside the body too: the recomputation in
            # backward runs only what is inside the checkpoint
            with scope(layer.name):
                return self._run_layer(
                    layer, dict(zip(names, args[:len(names)])),
                    list(args[len(names):]), train, comm)

        rng = (self.remat_rng if layer.TYPE == "DROPOUT" and train
               else None)
        return list(checkpoint_layer(
            body, [lparams[k] for k in names] + list(bottoms), rng))

    def _layer_params(self, params: Params, layer: Layer, comm=None
                      ) -> Dict[str, torch.Tensor]:
        """A layer's params through the sharing bindings: each sharer's
        blob is its owner's leaf (reshaped under PERMISSIVE)."""
        lparams: Dict[str, torch.Tensor] = {}
        for pdef in layer.params:
            olayer, opname = self._storage_of[(layer.name, pdef.name)]
            v = params.get(olayer, {}).get(opname)
            if v is None:
                continue
            lparams[pdef.name] = v
            if tuple(v.shape) == pdef.shape:
                continue
            if v.numel() == pdef.count:
                lparams[pdef.name] = v.reshape(pdef.shape)
            elif comm is None or not comm.is_tp_leaf(layer.name, pdef.name):
                raise ValueError(
                    f"layer {layer.name!r} param {pdef.name!r}: got shape "
                    f"{tuple(v.shape)} for defined shape {pdef.shape} — "
                    f"size mismatch with no tensor-parallel plan covering "
                    f"this leaf")
        return lparams

    def forward(self, inputs: Dict[str, torch.Tensor],
                params: Optional[Params] = None,
                keep_blobs: bool = False) -> Dict[str, torch.Tensor]:
        """Run the graph; returns the output blobs (every blob, by its last
        value, with ``keep_blobs``)."""
        out = self.apply(params, inputs, keep_blobs=keep_blobs)
        return out.blobs if keep_blobs else out.outputs

    # ------------------------------------------------------------------ #
    def load_weights(self, params: Params,
                     layer_weights: Dict[str, List[np.ndarray]],
                     strict: bool = False) -> Params:
        """Caffe's CopyTrainedLayersFrom: merge {layer: [blob arrays]} by
        name and order (blobs reshaped to the defined shapes), a sharer's
        blob into its owner's storage; unknown layers are ignored unless
        ``strict``."""
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
                olayer, opname = self._storage_of[(lname, pdef.name)]
                oshape = next(d.shape for d in self.param_defs[olayer]
                              if d.name == opname)
                new_params.setdefault(olayer, {})[opname] = torch.from_numpy(
                    arr.reshape(oshape).copy()).to(self.device)
        return new_params

    def export_weights(self, params: Optional[Params] = None
                       ) -> Dict[str, List[np.ndarray]]:
        """Every param layer's blobs as numpy arrays, in Caffe's order,
        sharers included (each repeats its owner's array, in its own
        shape)."""
        params = self.params if params is None else params
        return {layer.name: [v.detach().cpu().numpy() for v in
                             self._layer_params(params, layer).values()]
                for layer in self.layers if layer.params}


def params_from_jax(net: Net, params) -> Params:
    """Load the JAX package's ``{layer: {"w", "b"}}`` params (as numpy
    arrays: OIHW conv and (out, in) fc weights, the layout torch uses) into
    ``net``; returns the device tree, also kept as ``net.params``."""
    net.params = net.to_device_params(
        {layer: {p: np.asarray(v) for p, v in d.items()}
         for layer, d in params.items()})
    return net.params
