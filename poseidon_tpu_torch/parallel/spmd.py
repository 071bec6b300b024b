"""SPMD sharding planner over the named ``(data, fsdp, tp)`` mesh (the port
of ``poseidon_tpu/parallel/spmd.py``; ``train --mesh dp2,fsdp2,tp1``).

One process a device, as everywhere in the port: rank r sits at
``parallel/mesh.mesh_coords(r, cfg)`` and talks over the groups of its
``MeshGroups`` (data, fsdp, tp and the joint (data, fsdp) group).

- ``data``: batch shards, replicated parameters.
- ``fsdp``: batch shards PLUS a sharded parameter arena (the ZeRO trade):
  every arena bucket aligns to the fsdp size (``core/arena.py``'s
  ``align``), gradients REDUCE-SCATTER over fsdp then all-reduce over
  data, bucket by bucket, issued from the gradient-accumulation hooks
  mid-backward (``ShardedBucketSync``, DWBP); the fused update (the
  ``ops/sgd.py`` kernel on the card) runs once over this rank's 1/fsdp
  shard, its shard-major multiplier segments sliced the same way, and
  the updated shards ALL-GATHER back. With ``sharded_state=True`` params
  and momentum live sharded between steps (``SpmdState``) and the param
  gather moves to the step's prologue.
- ``tp``: FC layers the planner picks run as column or row shards
  (``TPColMatmul``/``TPRowMatmul``, the Megatron f/g operators); conv,
  LRN and pooling replicate over tp; SFB/TOPK/LOCAL layers opt out.

The planner (``ShardingPlan``, ``collective_schedule``, the shard-major
maps) is plain Python and numpy over the layout, equal to JAX's for the
same net. Gradient sums are HIERARCHICAL (fsdp first, then data; the mean
divides by the batch-shard count in f32), so the sharded arm and the
replicated control arm (``shard_params=False``) add the same terms in the
same order: with two ranks an axis every element's sum is a + b either
way, and the two arms are bitwise equal.

Every collective runs under a ``torch.profiler.record_function`` named as
JAX's scopes — ``grad_rs_bucket<i>`` (fsdp), ``grad_ar_bucket<i>``
(data), ``param_ag_bucket<i>``/``hist_ag_bucket<i>`` (fsdp),
``tp_fwd_<layer>``/``tp_dx_<layer>`` (tp), ``grad_tp_*``,
``grad_fused_*``, ``grad_tap_*``, ``grad_topk_*``, ``sfb_*`` and the SSP
boundary's ``delta_{rs,ar,ag}_bucket<i>`` — and is counted in ``CENSUS``
(per kind, and the last step's list), which the tests diff against
``collective_schedule``: the port's stand-in for JAX's HLO census.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MeshConfig
from ..core.arena import build_arena
from ..numeric import policy
from ..ops.sgd import sgd_update_
from ..solvers.updates import SolverState, learning_rate, \
    make_flat_update_rule
from .mesh import DataGroup, MeshGroups
from .strategies import (DENSE, DENSE_FUSED, LOCAL, TOPK, WIRE_DTYPES,
                         Bucket, BucketSync, CommConfig, CommContext,
                         SFBMatmul, budget_topk_fraction, comm_salt,
                         sync_kinds, topk_compress, wire_all_reduce)

# layer types that may consume a tp-sharded activation unchanged (pure
# elementwise, no rng). Dropout is NOT safe: its mask must not depend on
# the tp shard
TP_ELEMENTWISE_SAFE = frozenset({"RELU"})

COL = "column"   # weight (M, K) sharded over M; output feature shards
ROW = "row"      # weight (M, K) sharded over K; input arrives sharded

Spec = Tuple[Optional[str], ...]     # JAX's PartitionSpec as a tuple


# --------------------------------------------------------------------------- #
# the census: every collective labelled and counted
# --------------------------------------------------------------------------- #

class Census:
    """Issued collectives: ``counts`` per kind since start-up, ``last``
    the records ({name, kind, axis, elems}) since the last ``begin`` (each
    SPMD step begins one). ``elems`` is the op's result size, as JAX's
    census thresholds it."""

    KINDS = ("all_reduce", "reduce_scatter", "all_gather")

    def __init__(self):
        self.counts = {k: 0 for k in self.KINDS}
        self.last: List[Dict] = []

    def begin(self) -> None:
        self.last = []

    @contextlib.contextmanager
    def collective(self, name: str, kind: str, axis: str, elems: int):
        self.counts[kind] += 1
        self.last.append({"name": name, "kind": kind, "axis": axis,
                          "elems": int(elems)})
        with torch.profiler.record_function(name):
            yield

    def scheduled(self, min_elements: int = 256) -> Dict:
        """The last step's records at or above ``min_elements`` and their
        counts, the form of ``collective_schedule``'s."""
        names = [r for r in self.last if r["elems"] >= min_elements]
        counts = {k: sum(r["kind"] == k for r in names) for k in self.KINDS}
        return {"counts": counts, "collectives": names}


CENSUS = Census()


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class TPDecision:
    """One FC layer's tensor-parallel assignment."""
    mode: str            # COL | ROW
    gather: bool         # COL only: all-gather the output (the resharding
    #                      point) vs keep it sharded for a downstream ROW
    shard_dim: int       # weight dim carrying the tp shard (0=M, 1=K)


@dataclass(frozen=True)
class LeafPlan:
    """One parameter leaf's placement."""
    placement: str       # "arena_fsdp" | "tp" | "replicated"
    spec: Spec           # JAX's PartitionSpec of the leaf, as a tuple


@dataclass
class ShardingPlan:
    """Per-layer plan for one Net on one MeshConfig (JAX's
    ``ShardingPlan``), computed once at step-build time."""

    mesh_cfg: MeshConfig
    shard_params: bool = True          # False = replicated control arm
    tp_layers: Dict[str, TPDecision] = dc_field(default_factory=dict)
    arena_layers: frozenset = frozenset()
    leaf_plan: Dict[Tuple[str, str], LeafPlan] = dc_field(
        default_factory=dict)
    # blobs that stay tp-sharded between a COL producer and a ROW consumer
    sharded_blobs: frozenset = frozenset()

    @property
    def active(self) -> bool:
        return self.mesh_cfg.active

    @property
    def n_dp(self) -> int:
        """Distinct batch shards = data * fsdp (tp replicas share one)."""
        return self.mesh_cfg.data * self.mesh_cfg.fsdp

    @property
    def fsdp_on(self) -> bool:
        return self.mesh_cfg.fsdp > 1 and self.shard_params

    def param_spec(self, layer: str, pname: str) -> Spec:
        lp = self.leaf_plan.get((layer, pname))
        return lp.spec if lp is not None else ()

    @classmethod
    def build(cls, net, mesh_cfg: MeshConfig,
              comm: Optional[CommConfig] = None,
              shard_params: bool = True,
              enable_tp: bool = True) -> "ShardingPlan":
        """Plan a Net: TP assignments for eligible FC layers, the fsdp
        arena cover (the DENSE non-tp layers) and a placement for every
        leaf. ``shard_params=False`` / ``enable_tp=False`` build the
        replicated control arm on the same mesh."""
        comm = comm or CommConfig()
        plan = cls(mesh_cfg=mesh_cfg, shard_params=shard_params)
        if mesh_cfg.fsdp > 1 and shard_params and not comm.param_arena:
            raise ValueError(
                "fsdp sharding rides the flat parameter arena "
                "(--param_arena true); an fsdp mesh with the arena off "
                "has nothing to shard")
        tp_layers: Dict[str, TPDecision] = {}
        sharded_blobs: set = set()
        if mesh_cfg.tp > 1 and enable_tp:
            tp_layers, sharded_blobs = cls._plan_tp(net, comm, mesh_cfg.tp)
        plan.tp_layers = tp_layers
        plan.sharded_blobs = frozenset(sharded_blobs)
        arena = {lname for lname in net.param_defs
                 if comm.strategy_for(lname) == DENSE
                 and lname not in tp_layers}
        plan.arena_layers = (frozenset(arena) if comm.param_arena
                             else frozenset())
        leaf_plan: Dict[Tuple[str, str], LeafPlan] = {}
        for lname, defs in net.param_defs.items():
            for pdef in defs:
                if lname in tp_layers:
                    dec = tp_layers[lname]
                    if pdef.name == "w":
                        spec = (("tp", None) if dec.shard_dim == 0
                                else (None, "tp"))
                    elif pdef.name == "b" and dec.mode == COL:
                        spec = ("tp",)
                    else:
                        spec = ()
                    leaf_plan[(lname, pdef.name)] = LeafPlan("tp", spec)
                elif lname in plan.arena_layers:
                    leaf_plan[(lname, pdef.name)] = LeafPlan(
                        "arena_fsdp" if plan.fsdp_on else "replicated", ())
                else:
                    # SFB/TOPK/LOCAL/DENSE_FUSED keep their own comm
                    # paths: replicated storage, tp opt-out
                    leaf_plan[(lname, pdef.name)] = LeafPlan("replicated",
                                                             ())
        plan.leaf_plan = leaf_plan
        return plan

    @staticmethod
    def _plan_tp(net, comm: CommConfig, tp: int):
        """TP assignment walk. COLUMN by default (M % tp == 0); a
        candidate fed — through TP-elementwise-safe layers only — by a COL
        candidate whose sharded path has no other consumers becomes ROW
        (K % tp == 0), and the COL producer keeps its output sharded
        (gather=False): the Megatron pairing."""
        consumers: Dict[str, List] = {}
        writers: Dict[str, List[Tuple[int, object]]] = {}
        layer_index: Dict[str, int] = {}
        for idx, layer in enumerate(net.layers):
            layer_index[layer.name] = idx
            for b in layer.lp.bottom:
                consumers.setdefault(b, []).append(layer)
            for t in layer.lp.top:
                writers.setdefault(t, []).append((idx, layer))

        def producer_before(blob: str, idx: int):
            """Last writer of ``blob`` before layer ``idx`` (in-place
            chains reuse one blob name)."""
            prev = None
            for widx, wlayer in writers.get(blob, ()):
                if widx >= idx:
                    break
                prev = wlayer
            return prev

        def eligible(layer) -> bool:
            if layer.TYPE != "INNER_PRODUCT":
                return False
            if comm.strategy_for(layer.name) != DENSE:
                return False        # SFB/TOPK/... opt out of tp
            if layer.name not in net.param_defs:
                return False
            wdef = next((p for p in net.param_defs[layer.name]
                         if p.name == "w"), None)
            if wdef is None or len(wdef.shape) != 2:
                return False
            if any(layer.loss_weights(len(layer.lp.top))):
                return False        # a sharded top would mis-sum the loss
            return wdef.shape[0] % tp == 0

        decisions: Dict[str, TPDecision] = {}
        sharded_blobs: set = set()
        cands = [l for l in net.layers if eligible(l)]
        cand_names = {l.name for l in cands}
        for layer in cands:
            decisions[layer.name] = TPDecision(COL, True, 0)
        for layer in cands:
            bottom = layer.lp.bottom[0]
            idx = layer_index[layer.name]
            chain_blobs = [bottom]
            chain_layers = {layer.name}
            src = producer_before(bottom, idx)
            while src is not None and src.TYPE in TP_ELEMENTWISE_SAFE:
                chain_layers.add(src.name)
                idx = layer_index[src.name]
                bottom = src.lp.bottom[0]
                if bottom not in chain_blobs:
                    chain_blobs.append(bottom)
                src = producer_before(bottom, idx)
            if src is None or src.name not in cand_names or \
                    decisions[src.name] != TPDecision(COL, True, 0):
                continue
            wdef = next(p for p in net.param_defs[layer.name]
                        if p.name == "w")
            if wdef.shape[1] % tp:
                continue
            chain_layers.add(src.name)
            ok = all(
                all(c.name in chain_layers for c in consumers.get(b, []))
                and b not in net.output_names
                for b in chain_blobs)
            if not ok:
                continue
            decisions[layer.name] = TPDecision(ROW, False, 1)
            decisions[src.name] = TPDecision(COL, False, 0)
            sharded_blobs.update(chain_blobs)
        return decisions, sharded_blobs

    def collective_schedule(self, layout, net=None,
                            comm: Optional[CommConfig] = None,
                            min_elements: int = 256,
                            sharded_state: bool = False) -> Dict:
        """The PLANNED collective census of one train step (JAX's
        ``collective_schedule``): payloads under ``min_elements`` elements
        are left out on both sides."""
        comm = comm or CommConfig()
        d, f = self.mesh_cfg.data, self.mesh_cfg.fsdp
        fsdp_on = f > 1 and self.shard_params
        n_buckets = layout.n_buckets if layout is not None else 0
        names: List[Dict] = []
        counts = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}

        def add(name, kind, axis, elems):
            if elems < min_elements:
                return
            names.append({"name": name, "kind": kind, "axis": axis,
                          "elems": int(elems)})
            counts[kind] += 1

        for i in range(n_buckets):
            lo, hi = layout.bucket_ranges[i]
            if fsdp_on:
                add(f"grad_rs_bucket{i}", "reduce_scatter", "fsdp",
                    (hi - lo) // f)
            elif f > 1:
                add(f"grad_rs_bucket{i}", "all_reduce", "fsdp", hi - lo)
            if d > 1:
                add(f"grad_ar_bucket{i}", "all_reduce", "data",
                    (hi - lo) // f if fsdp_on else hi - lo)
            if fsdp_on:
                add(f"param_ag_bucket{i}", "all_gather", "fsdp", hi - lo)
                if not sharded_state:
                    add(f"hist_ag_bucket{i}", "all_gather", "fsdp",
                        hi - lo)
        if net is not None:
            t = self.mesh_cfg.tp
            for lname, dec in self.tp_layers.items():
                layer = next(l for l in net.layers if l.name == lname)
                b_loc = net.blob_shapes[layer.lp.top[0]][0]
                wdef = next(p for p in net.param_defs[lname]
                            if p.name == "w")
                m, k = wdef.shape
                if dec.mode == COL and dec.gather:
                    add(f"tp_fwd_{lname}", "all_gather", "tp", b_loc * m)
                if dec.mode == COL:
                    add(f"tp_dx_{lname}", "all_reduce", "tp", b_loc * k)
                else:
                    add(f"tp_fwd_{lname}", "all_reduce", "tp", b_loc * m)
                for pdef in net.param_defs[lname]:
                    elems = (pdef.count // t
                             if pdef.name == "w" or dec.mode == COL
                             else pdef.count)
                    if f > 1:
                        add(f"grad_tp_{lname}_{pdef.name}_fsdp",
                            "all_reduce", "fsdp", elems)
                    if d > 1:
                        add(f"grad_tp_{lname}_{pdef.name}_data",
                            "all_reduce", "data", elems)
            for lname, defs in net.param_defs.items():
                strat = comm.strategy_for(lname)
                if lname in self.tp_layers or lname in self.arena_layers \
                        or strat == LOCAL:
                    continue
                layer = next(l for l in net.layers if l.name == lname)
                if strat == TOPK:
                    for pdef in defs:
                        add(f"grad_topk_{lname}_{pdef.name}",
                            "all_reduce", "data+fsdp", pdef.count)
                elif strat == DENSE_FUSED:
                    for pdef in defs:
                        if f > 1:
                            add(f"grad_fused_{lname}_{pdef.name}_fsdp",
                                "all_reduce", "fsdp", pdef.count)
                        if d > 1:
                            add(f"grad_fused_{lname}_{pdef.name}_data",
                                "all_reduce", "data", pdef.count)
                elif strat == DENSE:
                    for pdef in defs:
                        add(f"grad_tap_{lname}_{pdef.name}",
                            "all_reduce", "data+fsdp", pdef.count)
                else:   # SFB: backward gathers both factors, psums bias
                    b_glob = net.blob_shapes[layer.lp.top[0]][0] * \
                        self.n_dp
                    wdef = next(p for p in defs if p.name == "w")
                    m, k = wdef.shape
                    add(f"sfb_gfactor_{lname}", "all_gather",
                        "data+fsdp", b_glob * m)
                    add(f"sfb_xfactor_{lname}", "all_gather",
                        "data+fsdp", b_glob * k)
                    if any(p.name == "b" for p in defs):
                        add(f"sfb_bias_{lname}", "all_reduce",
                            "data+fsdp", m)
        return {
            "mesh": self.mesh_cfg.describe(),
            "shard_params": self.shard_params,
            "sharded_state": sharded_state,
            "min_elements": min_elements,
            "arena_buckets": n_buckets,
            "counts": counts,
            "collectives": names,
        }

    def describe(self) -> str:
        tp = {l: d.mode + ("" if d.gather or d.mode == ROW
                           else "+sharded-out")
              for l, d in self.tp_layers.items()}
        return (f"mesh {self.mesh_cfg.describe()}"
                f"{'' if self.shard_params else ' (replicated control)'}: "
                f"{len(self.arena_layers)} arena layer(s) over fsdp, "
                f"tp {tp or 'none'}")


# --------------------------------------------------------------------------- #
# fsdp shard geometry
# --------------------------------------------------------------------------- #

def fsdp_shard_ranges(layout, f: int) -> List[List[Tuple[int, int]]]:
    """Per-rank list of [lo, hi) flat-buffer ranges: fsdp rank d owns the
    d-th 1/f slice of every bucket; a disjoint cover of
    [0, padded_total)."""
    out: List[List[Tuple[int, int]]] = [[] for _ in range(f)]
    for lo, hi in layout.bucket_ranges:
        s = (hi - lo) // f
        for dd in range(f):
            out[dd].append((lo + dd * s, lo + (dd + 1) * s))
    return out


def to_shard_major(flat: np.ndarray, layout, f: int) -> np.ndarray:
    """Canonical flat order -> shard-major order: row block d holds fsdp
    rank d's per-bucket shard segments in bucket order (the layout of
    ``SpmdState.flat_w`` and of the sharded multiplier segments)."""
    ranges = fsdp_shard_ranges(layout, f)
    return np.concatenate([flat[lo:hi] for dd in range(f)
                           for lo, hi in ranges[dd]])


def from_shard_major(sm: np.ndarray, layout, f: int) -> np.ndarray:
    """Inverse of ``to_shard_major``."""
    out = np.empty_like(sm)
    pos = 0
    for rngs in fsdp_shard_ranges(layout, f):
        for lo, hi in rngs:
            out[lo:hi] = sm[pos:pos + (hi - lo)]
            pos += hi - lo
    return out


def shard_mult_vectors(layout, sp, f: int):
    """(lr, decay) multiplier vectors in shard-major order (JAX's
    ``_shard_mult_vectors``): fsdp rank d's slice is row block d."""
    lr, dec = layout.mult_vectors(sp.weight_decay)
    return to_shard_major(lr, layout, f), to_shard_major(dec, layout, f)


def step_layouts(net, plan: ShardingPlan, bucket_mb: float = 4.0):
    """(arena, excl_full, excl): the flat layouts an ``SpmdTrainStep``
    keeps under ``plan``. ``arena`` holds the plan's arena layers,
    fsdp-aligned when fsdp shards (None without arena layers); K7 updates
    it whole, or this rank's ``padded_total / fsdp`` shard. ``excl``
    holds every other leaf, one bucket a leaf, at this rank's tp shapes
    (None when the arena holds every leaf); K7 updates it whole.
    ``excl_full`` is the same table at full shapes."""
    f, t = plan.mesh_cfg.fsdp, plan.mesh_cfg.tp
    arena = (net.arena_layout(bucket_mb, align=f if plan.fsdp_on else 1,
                              layers=plan.arena_layers)
             if plan.arena_layers else None)
    excl = [(l, p) for l, p in net._arena_order
            if arena is None or l not in arena.layers]
    return arena, build_arena(excl, 0.0), build_arena(
        [(l, _with_shape(p, _local_shape(p, plan.tp_layers.get(l), t)))
         for l, p in excl], 0.0)


def sharded_state_bytes(net, plan: ShardingPlan, bucket_mb: float = 4.0
                        ) -> Dict[str, int]:
    """The persistent params + momentum bytes of ONE rank under ``plan``
    (JAX's ``sharded_state_avals`` counted instead of described): the
    arena's ``padded_total / fsdp`` f32 twice with sharded params
    (``padded_total`` twice in the replicated arm), plus every other
    leaf at its local size (a tp leaf's 1/tp shard) twice."""
    f = plan.mesh_cfg.fsdp if plan.fsdp_on else 1
    layout, _full, local = step_layouts(net, plan, bucket_mb)
    arena = 0 if layout is None else 2 * 4 * (layout.padded_total // f)
    excl = 0 if local is None else 2 * 4 * local.total
    return {"arena": arena, "excl": excl, "total": arena + excl}


# --------------------------------------------------------------------------- #
# tp shards of a leaf
# --------------------------------------------------------------------------- #

def _local_shape(pdef, dec: Optional[TPDecision], t: int):
    """The shape of this rank's slice of a leaf (itself off tp)."""
    shape = tuple(pdef.shape)
    if dec is None:
        return shape
    if pdef.name == "w":
        dim = dec.shard_dim
        return shape[:dim] + (shape[dim] // t,) + shape[dim + 1:]
    if pdef.name == "b" and dec.mode == COL:
        return (shape[0] // t,)
    return shape


def _shard_dim(pname: str, dec: Optional[TPDecision]) -> Optional[int]:
    if dec is None:
        return None
    if pname == "w":
        return dec.shard_dim
    return 0 if dec.mode == COL else None


def _local_slice(v: torch.Tensor, pname: str, dec, tidx: int, t: int):
    dim = _shard_dim(pname, dec)
    if dim is None:
        return v
    n = v.shape[dim] // t
    return v.narrow(dim, tidx * n, n)


# --------------------------------------------------------------------------- #
# tp matmuls (the Megatron f/g operators as autograd Functions)
# --------------------------------------------------------------------------- #

def _acc(t: torch.Tensor, cd) -> torch.Tensor:
    """Compute-dtype values in the accumulation dtype (exact in f32)."""
    return t.to(cd).to(policy().accum_dtype)


class TPColMatmul(torch.autograd.Function):
    """Column-parallel FC: w (M/t, K), b (M/t); forward computes the local
    output shard and, with ``gather``, all-gathers the feature dim over tp
    (the resharding point). Backward: dw and db are exact local shard
    products (each rank owns its rows); dx sums the partial contractions
    over tp (the Megatron ``f`` operator's backward all-reduce). The
    gathered output's cotangent is the same on every tp rank, so its
    backward takes this rank's columns of one copy."""

    @staticmethod
    def forward(ctx, x2, w, b, tp: DataGroup, gather: bool, layer: str):
        cd = policy().compute_dtype
        ctx.save_for_backward(x2, w)
        ctx.tp, ctx.gather, ctx.layer, ctx.cd = tp, gather, layer, cd
        ctx.b_dtype = None if b is None else b.dtype
        y = F.linear(x2.to(cd), w.to(cd), None if b is None else b.to(cd))
        if gather:
            n, m_loc = y.shape
            parts = y.new_empty((tp.world, n, m_loc))
            with CENSUS.collective(f"tp_fwd_{layer}", "all_gather", "tp",
                                   parts.numel()):
                tp.all_gather_into(parts.view(tp.world * n, m_loc),
                                   y.contiguous())
            y = parts.permute(1, 0, 2).reshape(n, tp.world * m_loc)
        return y

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        cd, tp = ctx.cd, ctx.tp
        if ctx.gather:
            m_loc = w.shape[0]
            gy = gy[:, tp.rank * m_loc:(tp.rank + 1) * m_loc]
        gw = _acc(gy, cd).t().mm(_acc(x2, cd)).to(w.dtype)
        gb = (gy.float().sum(0).to(ctx.b_dtype)
              if ctx.b_dtype is not None else None)
        gx = _acc(gy, cd).mm(_acc(w, cd)).contiguous()
        with CENSUS.collective(f"tp_dx_{ctx.layer}", "all_reduce", "tp",
                               gx.numel()):
            tp.all_reduce_(gx)
        return gx.to(x2.dtype), gw, gb, None, None, None


class TPRowMatmul(torch.autograd.Function):
    """Row-parallel FC: x arrives tp-sharded on features (a COL producer
    kept its output sharded), w (M, K/t); the partial products all-reduce
    over tp (the Megatron ``g`` operator) and the replicated bias adds
    once, after the sum. Backward is local: dx and dw are exact shard
    products, db is tp-replicated."""

    @staticmethod
    def forward(ctx, x_loc, w, b, tp: DataGroup, layer: str):
        cd = policy().compute_dtype
        ctx.save_for_backward(x_loc, w)
        ctx.cd = cd
        ctx.b_dtype = None if b is None else b.dtype
        part = F.linear(x_loc.to(cd), w.to(cd)).contiguous()
        with CENSUS.collective(f"tp_fwd_{layer}", "all_reduce", "tp",
                               part.numel()):
            tp.all_reduce_(part)
        return part if b is None else part + b.to(cd)

    @staticmethod
    def backward(ctx, gy):
        x_loc, w = ctx.saved_tensors
        cd = ctx.cd
        gx = _acc(gy, cd).mm(_acc(w, cd)).to(x_loc.dtype)
        gw = _acc(gy, cd).t().mm(_acc(x_loc, cd)).to(w.dtype)
        gb = (gy.float().sum(0).to(ctx.b_dtype)
              if ctx.b_dtype is not None else None)
        return gx, gw, gb, None, None


class SpmdCommContext(CommContext):
    """CommContext for a planned mesh: routes the TP layers' products to
    the column/row Functions over the tp group, the SFB layers' to the
    sufficient-factor product over the joint (data, fsdp) group, lets the
    plan's tp leaves arrive at their shard size, and labels and counts
    every collective."""

    def __init__(self, cfg: CommConfig, plan: ShardingPlan,
                 mesh: MeshGroups, kinds: Dict[str, str]):
        super().__init__(cfg, mesh.joint, kinds)
        self.plan = plan
        self.mesh = mesh
        self._routed = frozenset(self.sfb_layers | set(plan.tp_layers))

    @property
    def routed_layers(self):
        return self._routed

    def is_tp_leaf(self, layer: str, pname: str) -> bool:
        lp = self.plan.leaf_plan.get((layer, pname))
        return lp is not None and lp.placement == "tp"

    def collective(self, name: str, kind: str, elems: int):
        return CENSUS.collective(name, kind, "data+fsdp", elems)

    def layer_product(self, layer: str, x, w, b) -> torch.Tensor:
        x2 = x.reshape(x.shape[0], -1)
        dec = self.plan.tp_layers.get(layer)
        if dec is None:
            return SFBMatmul.apply(x2, w, b, self, layer)
        if dec.mode == COL:
            return TPColMatmul.apply(x2, w, b, self.mesh.tp, dec.gather,
                                     layer)
        return TPRowMatmul.apply(x2, w, b, self.mesh.tp, layer)


# --------------------------------------------------------------------------- #
# hierarchical gradient sync (fsdp first, then data)
# --------------------------------------------------------------------------- #

def hierarchical_all_reduce(g: torch.Tensor, mesh: MeshGroups, reduce: str,
                            wire: Optional[str], scope: str) -> torch.Tensor:
    """Sum over fsdp, then data — the association order of the sharded
    reduce-scatter path — through an optional wire dtype; the mean divides
    by the batch-shard count in f32. Returns a new f32 tensor (JAX's
    ``hierarchical_psum``)."""
    wd = WIRE_DTYPES.get(wire) if wire else None
    buf = g.to(wd) if wd is not None and g.dtype != wd else g.clone()
    for axis, grp in (("fsdp", mesh.fsdp), ("data", mesh.data)):
        if grp.world > 1:
            with CENSUS.collective(f"{scope}_{axis}", "all_reduce", axis,
                                   buf.numel()):
                grp.all_reduce_(buf)
    s = buf.float()
    if reduce == "mean":
        s = s / mesh.n_dp
    return s


class ShardedBucketSync(BucketSync):
    """The bucketed gradient sync of the fsdp-aligned arena (JAX's
    ``sharded_bucket_sync``), issued from the leaves' gradient-accumulation
    hooks by ``strategies.BucketSync``'s machinery over the layout's
    buckets: the moment bucket i's last leaf has accumulated (and every
    bucket before it has gone), its range reduce-scatters over fsdp into
    this rank's shard segment (sharded arm) or all-reduces over fsdp
    (replicated arm); each bucket's data all-reduce follows as soon as its
    fsdp step is done, in bucket order (polled at every later issue, the
    rest at ``finish``), so every rank issues the same sequence on every
    group. ``finish`` waits on everything, brings each range to f32 and to
    the mean."""

    def __init__(self, mesh: MeshGroups, cfg: CommConfig, layout,
                 leaves, flat_g: torch.Tensor, g_sh: Optional[torch.Tensor],
                 shard_params: bool):
        buckets = [Bucket(lo, hi, tuple(
            j for j, s in enumerate(layout.slots)
            if s.offset < hi and s.offset + s.size > lo))
            for lo, hi in layout.bucket_ranges]
        super().__init__(mesh.joint, cfg, layout.slots, {}, leaves, flat_g,
                         hooked=buckets)
        self.mesh = mesh
        self.g_sh = g_sh
        self.f = mesh.cfg.fsdp
        self.fsdp_on = self.f > 1 and shard_params
        self.shard_lo: List[int] = []
        pos = 0
        for b in buckets:
            self.shard_lo.append(pos)
            pos += (b.hi - b.lo) // self.f

    def _issue(self, b: Bucket) -> None:
        i = self._next          # BucketSync issues bucket _next
        src = self.flat_g[b.lo:b.hi]
        buf = src if self.wire is None else src.to(self.wire)
        work = None
        if self.fsdp_on:
            n = (b.hi - b.lo) // self.f
            dest = self.g_sh[self.shard_lo[i]:self.shard_lo[i] + n]
            out = dest if self.wire is None else buf.new_empty(n)
            with CENSUS.collective(f"grad_rs_bucket{i}",
                                   "reduce_scatter", "fsdp", n):
                work = self.mesh.fsdp.reduce_scatter_(out, buf,
                                                      async_op=True)
        else:
            dest, out = src, buf
            if self.f > 1:
                with CENSUS.collective(f"grad_rs_bucket{i}",
                                       "all_reduce", "fsdp", b.hi - b.lo):
                    work = self.mesh.fsdp.all_reduce_(out, async_op=True)
        self._pending.append(_Pending(i, out, dest, work))
        self._advance(block=False)

    def _advance(self, block: bool) -> None:
        """Issue the data all-reduce of every pending bucket, in order,
        whose fsdp step is done (waiting for it with ``block``)."""
        for p in self._pending:
            if p.sent:
                continue
            if p.fsdp_work is not None:
                if not block and not p.fsdp_work.is_completed():
                    return
                p.fsdp_work.wait()
                p.fsdp_work = None
            if self.mesh.cfg.data > 1:
                with CENSUS.collective(f"grad_ar_bucket{p.index}",
                                       "all_reduce", "data", p.out.numel()):
                    p.data_work = self.mesh.data.all_reduce_(p.out,
                                                             async_op=True)
            p.sent = True

    def finish(self) -> None:
        while self._next < len(self.hooked):
            self._issue_hooked()
        self._advance(block=True)
        for p in self._pending:
            if p.data_work is not None:
                p.data_work.wait()
            if p.out is not p.dest:
                p.dest.copy_(p.out)
            if self.cfg.reduce == "mean":
                p.dest.div_(self.mesh.n_dp)
        self._pending = []


@dataclass
class _Pending:
    """One issued bucket: its wire buffer, its f32 destination (the shard
    segment, or the range itself), the fsdp and data works, and whether
    the data all-reduce has gone."""
    index: int
    out: torch.Tensor
    dest: torch.Tensor
    fsdp_work: object
    data_work: object = None
    sent: bool = False


# --------------------------------------------------------------------------- #
# the spmd train step
# --------------------------------------------------------------------------- #

class SpmdState(NamedTuple):
    """The sharded-state carry (``SpmdTrainStep(sharded_state=True)``):
    ``flat_w``/``flat_h`` are this rank's arena params/momentum shard in
    shard-major order (its row block of ``to_shard_major``, ``padded_total
    / fsdp`` f32 each); ``excl_*`` the other leaves (tp leaves at this
    rank's shard); ``comm_error`` this rank's TOPK rows. Snapshots go
    through ``unshard_train_state`` and stay canonical."""
    flat_w: torch.Tensor
    flat_h: torch.Tensor
    excl_params: Dict
    excl_hist: Dict
    it: int
    comm_error: Dict


class SpmdTrainStep:
    """The train step over a planned (data, fsdp, tp) mesh, one rank a
    device (JAX's ``build_spmd_train_step``).

    Canonical layout (default): ``step(params, state, batch) -> (params,
    state, metrics)`` with per-leaf trees at the boundary, as
    ``trainer.TrainStep``'s (views of the step's buffers, updated in place
    by the next step), except that a tp leaf is this rank's shard:
    ``canonical_params``/``export`` gather them (collectives) for eval and
    snapshots, and ``load`` slices canonical trees. Inside: the arena
    gradients reduce-scatter over fsdp mid-backward, K7 updates this
    rank's shard, and params and momentum all-gather back
    (``param_ag_bucket<i>``, ``hist_ag_bucket<i>``).

    ``sharded_state=True`` (fsdp > 1, sharded params): ``step(state,
    batch) -> (state, metrics)`` over an ``SpmdState``; the params
    all-gather in the prologue and momentum never crosses the wire.
    Convert with ``shard_train_state`` / ``unshard_train_state``.

    Outside the arena: tp leaves and DENSE_FUSED synced per leaf after
    backward by ``hierarchical_all_reduce``; TOPK compressed against this
    rank's residual and summed over the joint group; SFB in-backward over
    the joint group; DENSE leaves with the arena off summed over the joint
    group per leaf. LOCAL is refused, as in JAX.

    ``remat_plan`` (``core/remat.RematPlan``) checkpoints the plan's
    layers in the forward, as ``trainer.TrainStep``'s does; every rank
    takes the same plan (the engine plans from the largest peak)."""

    def __init__(self, net, sp, group: DataGroup, plan: ShardingPlan,
                 comm: Optional[CommConfig] = None,
                 input_transform: Optional[Callable] = None,
                 sharded_state: bool = False, remat_plan=None):
        if max(1, int(sp.iter_size)) > 1:
            from .trainer import iter_size_refusal
            raise ValueError(iter_size_refusal("the SPMD step",
                                               "--mesh sharding"))
        comm = comm or CommConfig()
        comm.validate()
        mesh = group.mesh if group is not None else None
        if mesh is None or mesh.cfg != plan.mesh_cfg:
            raise ValueError(
                "an SPMD plan needs the named mesh's groups "
                "(runtime/cluster.init_distributed(mesh_cfg=...)) for the "
                "plan's mesh")
        if comm.dcn_axis is not None:
            raise ValueError("--mesh and --dcn_slices do not compose: the "
                             "named mesh's axes carry the whole topology")
        for lname in net.param_defs:
            if comm.strategy_for(lname) == LOCAL:
                raise ValueError(
                    f"layer {lname!r}: LOCAL (unsynced) params diverge "
                    f"across replicas; use build_ssp_train_step")
        self.net, self.sp, self.group, self.comm = net, sp, group, comm
        self.plan, self.mesh = plan, mesh
        self.input_transform = input_transform
        # the checkpointed layers (``core/remat.RematPlan``; JAX's
        # ``build_spmd_train_step(remat_plan=)``)
        self.remat = (remat_plan.layer_set if remat_plan is not None
                      and remat_plan.layers else None)
        f = plan.mesh_cfg.fsdp
        self.fsdp_on = plan.fsdp_on
        if sharded_state and not self.fsdp_on:
            raise ValueError("sharded_state needs fsdp > 1 with sharded "
                             "params (the fsdp axis IS the shard dimension)")
        self.sharded_state = sharded_state
        dev = net.device
        # the arena, and the leaves outside it at this rank's tp shapes
        self.arena, self.excl_full, self.excl = step_layouts(
            net, plan, comm.bucket_mb)
        if sharded_state and self.arena is None:
            raise ValueError("sharded_state needs at least one arena "
                             "(DENSE) layer to shard")

        def z(n: int) -> torch.Tensor:
            return torch.zeros(n, dtype=torch.float32, device=dev)

        self.leaves: List[torch.Tensor] = []
        self._leaf_tree: Dict[str, Dict[str, torch.Tensor]] = {}
        self.flat_w = self.flat_g = self.flat_h = None
        if self.arena is not None:
            n = self.arena.padded_total
            self.flat_w, self.flat_g = z(n), z(n)
            self.flat_h = None if sharded_state else z(n)
            self._arena_leaves = self._make_leaves(self.arena, self.flat_w,
                                                   self.flat_g)
        self.ex_w = self.ex_g = self.ex_h = None
        if self.excl is not None:
            n = self.excl.total
            self.ex_w, self.ex_g, self.ex_h = z(n), z(n), z(n)
            self._make_leaves(self.excl, self.ex_w, self.ex_g)
        self.kinds = sync_kinds(net, comm)
        self._ctx = SpmdCommContext(comm, plan, mesh, self.kinds)
        # this rank's fsdp shard: the buffers K7 runs on (allocations, so
        # 16-byte aligned whatever the shard's offset in the arena), the
        # index of its elements in the arena, its multiplier segments
        self.w_sh = self.g_sh = self.h_sh = None
        self.sync: Optional[ShardedBucketSync] = None
        # the SGD + L2 update (K7 on the card); chip_smoke.py and the gpu
        # tests swap in the plain version to hold a step against it
        self.sgd_update: Callable = sgd_update_
        self._rule = make_flat_update_rule(
            sp, sgd_update=lambda *a: self.sgd_update(*a))
        if self.arena is not None:
            if self.fsdp_on:
                fi = mesh.fsdp.rank
                n_sh = self.arena.padded_total // f
                self.w_sh, self.g_sh, self.h_sh = z(n_sh), z(n_sh), z(n_sh)
                idx = np.concatenate([np.arange(lo, hi) for lo, hi in
                                      fsdp_shard_ranges(self.arena, f)[fi]])
                self._shard_idx = torch.from_numpy(idx).to(dev)
                lr, dec = shard_mult_vectors(self.arena, sp, f)
                self._mults = (torch.from_numpy(
                    lr[fi * n_sh:(fi + 1) * n_sh].copy()).to(dev),
                    torch.from_numpy(
                        dec[fi * n_sh:(fi + 1) * n_sh].copy()).to(dev))
            else:
                self._mults = tuple(torch.from_numpy(v).to(dev) for v in
                                    self.arena.mult_vectors(sp.weight_decay))
            self.sync = ShardedBucketSync(mesh, comm, self.arena,
                                          self._arena_leaves, self.flat_g,
                                          self.g_sh, plan.shard_params)
        if self.excl is not None:
            self._ex_mults = tuple(torch.from_numpy(v).to(dev) for v in
                                   self.excl.mult_vectors(sp.weight_decay))
        self.topk_slots = ([s for s in self.excl.slots
                            if self.kinds.get(s.layer) == TOPK]
                           if self.excl is not None else [])
        self.topk_fraction = budget_topk_fraction(net, comm)
        self.n_err_groups = plan.n_dp
        self.err_row = mesh.batch_index
        if sharded_state:
            self.step = self._step_sharded

    def _make_leaves(self, layout, flat_w, flat_g) -> List[torch.Tensor]:
        leaves = [v.detach().requires_grad_(True)
                  for v in layout.views(flat_w)]
        for leaf, g, s in zip(leaves, layout.views(flat_g), layout.slots):
            leaf.grad = g
            self._leaf_tree.setdefault(s.layer, {})[s.pname] = leaf
            self.leaves.append(leaf)
        return leaves

    # ---------------------------------------------------------------- #
    def _tp(self, layer: str) -> Optional[TPDecision]:
        return self.plan.tp_layers.get(layer)

    def params(self):
        """The current parameters: views of the step's buffers (tp leaves
        at this rank's shard)."""
        return _merge(self.arena.unpack(self.flat_w) if self.arena else {},
                      self.excl.unpack(self.ex_w) if self.excl else {})

    def _history(self):
        return _merge(self.arena.unpack(self.flat_h)
                      if self.arena is not None and self.flat_h is not None
                      else {},
                      self.excl.unpack(self.ex_h) if self.excl else {})

    def _load_excl(self, tree, out: torch.Tensor) -> None:
        """A canonical tree's non-arena leaves, rank 0's, into ``out`` at
        this rank's tp shard."""
        full = self.excl_full.pack(tree)
        self.group.broadcast_(full)
        tidx, t = self.mesh.tp.rank, self.plan.mesh_cfg.tp
        for s, fv, lv in zip(self.excl.slots, self.excl_full.views(full),
                             self.excl.views(out)):
            lv.copy_(_local_slice(fv, s.pname, self._tp(s.layer), tidx, t))

    def _load_rows(self, params, comm_error) -> Dict:
        from .trainer import reconcile_comm_error
        stacked = reconcile_comm_error(params, comm_error, self.comm,
                                       self.n_err_groups)
        r = self.err_row
        return {lname: {k: v[r:r + 1].to(self.net.device,
                                         dtype=torch.float32, copy=True)
                        for k, v in lv.items()}
                for lname, lv in stacked.items()}

    def load(self, params, state):
        """Copy canonical (params, TrainState) in (rank 0's; this rank's
        tp shards and residual row) and return them as the step's views."""
        from .trainer import TrainState
        if self.sharded_state:
            raise TypeError("a sharded-state step takes SpmdState "
                            "(shard_train_state)")
        with torch.no_grad():
            if self.arena is not None:
                self.arena.pack(params, self.flat_w)
                self.arena.pack(state.solver.history, self.flat_h)
                self.group.broadcast_(self.flat_w)
                self.group.broadcast_(self.flat_h)
            if self.excl is not None:
                self._load_excl(params, self.ex_w)
                self._load_excl(state.solver.history, self.ex_h)
        return self.params(), TrainState(
            solver=SolverState(it=int(state.solver.it),
                               history=self._history()),
            comm_error=self._load_rows(params, state.comm_error))

    def load_weights(self, params):
        """New canonical weights (rank 0's); momentum and residuals
        stay."""
        with torch.no_grad():
            if self.arena is not None:
                self.arena.pack(params, self.flat_w)
                self.group.broadcast_(self.flat_w)
            if self.excl is not None:
                self._load_excl(params, self.ex_w)
        return self.params()

    # ---------------------------------------------------------------- #
    def _gather_tp(self, tree: Dict) -> Dict:
        """Canonical leaves from tp shards (an all-gather over tp a
        sharded leaf; every rank calls it)."""
        out = {l: dict(lv) for l, lv in tree.items()}
        tp = self.mesh.tp
        for lname, dec in self.plan.tp_layers.items():
            for pname, v in tree.get(lname, {}).items():
                dim = _shard_dim(pname, dec)
                if dim is None:
                    continue
                parts = v.new_empty((tp.world,) + tuple(v.shape))
                tp.all_gather_into(parts.view((-1,) + tuple(v.shape[1:])),
                                   v.contiguous())
                out[lname][pname] = torch.cat(parts.unbind(0), dim=dim)
        return out

    def canonical_params(self, params) -> Dict:
        return self._gather_tp(params)

    def gather_comm_error(self, comm_error: Dict) -> Dict:
        """Every batch shard's residual rows stacked in batch order (a
        collective over the joint group)."""
        if not comm_error:
            return comm_error
        return {lname: {k: self.mesh.joint.all_gather(v)
                        for k, v in lv.items()}
                for lname, lv in comm_error.items()}

    def export(self, params, state):
        """Canonical (params, TrainState) for a snapshot: tp leaves and
        their momentum gathered, every residual row stacked. A
        collective."""
        if self.sharded_state:
            return unshard_train_state(state, self)
        return self.canonical_params(params), state._replace(
            solver=state.solver._replace(
                history=self._gather_tp(state.solver.history)),
            comm_error=self.gather_comm_error(state.comm_error))

    # ---------------------------------------------------------------- #
    def _sync_excl(self, comm_error: Dict, it: int) -> Dict:
        """Per-leaf syncs of everything outside the arena, in slot order
        (every rank the same sequence)."""
        cfg = self.comm
        new_errors = dict(comm_error)
        if self.excl is None:
            return new_errors
        for s in self.excl.slots:
            g = self.ex_g[s.offset:s.offset + s.size].view(s.shape)
            kind = self.kinds.get(s.layer)
            if s.layer in self.plan.tp_layers or kind == DENSE_FUSED:
                prefix = ("grad_tp" if s.layer in self.plan.tp_layers
                          else "grad_fused")
                g.copy_(hierarchical_all_reduce(
                    g, self.mesh, cfg.reduce, cfg.wire_dtype,
                    f"{prefix}_{s.layer}_{s.pname}"))
            elif kind == TOPK:
                sent, resid = topk_compress(
                    g, self.topk_fraction, comm_error[s.layer][s.pname][0],
                    cfg.topk_policy, it, salt=comm_salt(s.layer, s.pname),
                    block=cfg.topk_block, wire=cfg.wire_dtype)
                g.copy_(self._joint_sum(sent, f"grad_topk_{s.layer}_"
                                        f"{s.pname}"))
                new_errors[s.layer] = {**new_errors.get(s.layer, {}),
                                       s.pname: resid[None]}
            elif kind == DENSE:
                # the arena is off: one joint sum a leaf (JAX's taps)
                g.copy_(self._joint_sum(g, f"grad_tap_{s.layer}_{s.pname}"))
        return new_errors

    def _joint_sum(self, g: torch.Tensor, name: str) -> torch.Tensor:
        """Sum over the joint (data, fsdp) group through the wire dtype;
        the mean divided by the batch-shard count in f32."""
        with CENSUS.collective(name, "all_reduce", "data+fsdp", g.numel()):
            return wire_all_reduce(g, self.mesh.joint, self.comm.reduce,
                                   self.comm.wire_dtype)

    def _forward_backward(self, batch):
        if self.input_transform is not None:
            batch = self.input_transform(batch)
        with torch.no_grad():
            if self.flat_g is not None:
                self.flat_g.zero_()
            if self.ex_g is not None:
                self.ex_g.zero_()
        if self.sync is not None:
            self.sync.begin()
        out = self.net.apply(self._leaf_tree, batch, train=True,
                             comm=self._ctx, remat=self.remat)
        out.loss.backward()
        if self.sync is not None:
            self.sync.finish()
        return out

    def _metrics(self, out) -> Dict[str, torch.Tensor]:
        """Loss and scalar outputs averaged over the batch shards."""
        from .trainer import _rank_mean, _scalar_metrics
        return _rank_mean(_scalar_metrics(out), self.mesh.joint)

    def _gather_bucket(self, src: torch.Tensor, dst: torch.Tensor,
                       name: str, works: Optional[list] = None) -> None:
        """Each bucket's shard segment of ``src`` (shard-major) all-gathered
        over fsdp into its range of ``dst``, one collective a bucket, all
        issued before any is waited on (into ``works`` when given, for the
        caller to wait on, else here)."""
        mine = [] if works is None else works
        pos = 0
        for i, (lo, hi) in enumerate(self.arena.bucket_ranges):
            n = (hi - lo) // self.plan.mesh_cfg.fsdp
            with CENSUS.collective(f"{name}{i}", "all_gather", "fsdp",
                                   hi - lo):
                mine.append(self.mesh.fsdp.all_gather_into(
                    dst[lo:hi], src[pos:pos + n], async_op=True))
            pos += n
        if works is None:
            _wait(mine)

    def step(self, params, state, batch: Dict[str, torch.Tensor]):
        """-> (params, state, metrics): one step in the canonical layout
        (tp leaves at this rank's shard; the trees are the step's
        views)."""
        from .trainer import TrainState
        CENSUS.begin()
        with torch.no_grad():
            if self.arena is not None:
                self.arena.pack(params, self.flat_w)
                self.arena.pack(state.solver.history, self.flat_h)
            if self.excl is not None:
                self.excl.pack(params, self.ex_w)
                self.excl.pack(state.solver.history, self.ex_h)
        out = self._forward_backward(batch)
        it = int(state.solver.it)
        with torch.no_grad():
            comm_error = self._sync_excl(state.comm_error, it)
            rate = learning_rate(self.sp, it)
            if self.arena is not None and self.fsdp_on:
                torch.index_select(self.flat_w, 0, self._shard_idx,
                                   out=self.w_sh)
                torch.index_select(self.flat_h, 0, self._shard_idx,
                                   out=self.h_sh)
                self._rule(self.w_sh, self.g_sh, self.h_sh, rate,
                           *self._mults)
                works: list = []
                self._gather_bucket(self.w_sh, self.flat_w,
                                    "param_ag_bucket", works)
                self._gather_bucket(self.h_sh, self.flat_h,
                                    "hist_ag_bucket", works)
                _wait(works)
            elif self.arena is not None:
                self._rule(self.flat_w, self.flat_g, self.flat_h, rate,
                           *self._mults)
            if self.excl is not None:
                self._rule(self.ex_w, self.ex_g, self.ex_h, rate,
                           *self._ex_mults)
        new_state = TrainState(
            solver=SolverState(it=it + 1, history=self._history()),
            comm_error=comm_error)
        return self.params(), new_state, self._metrics(out)

    def _step_sharded(self, state: SpmdState,
                      batch: Dict[str, torch.Tensor]):
        """-> (state, metrics) over an ``SpmdState``: params all-gather
        per bucket in the prologue (``param_ag_bucket<i>``), the update
        runs on the shard, momentum stays sharded."""
        CENSUS.begin()
        with torch.no_grad():
            if state.flat_w is not self.w_sh:
                self.w_sh.copy_(state.flat_w)
            if state.flat_h is not self.h_sh:
                self.h_sh.copy_(state.flat_h)
            if self.excl is not None:
                self.excl.pack(state.excl_params, self.ex_w)
                self.excl.pack(state.excl_hist, self.ex_h)
            self._gather_bucket(self.w_sh, self.flat_w, "param_ag_bucket")
        out = self._forward_backward(batch)
        it = int(state.it)
        with torch.no_grad():
            comm_error = self._sync_excl(state.comm_error, it)
            rate = learning_rate(self.sp, it)
            self._rule(self.w_sh, self.g_sh, self.h_sh, rate, *self._mults)
            if self.excl is not None:
                self._rule(self.ex_w, self.ex_g, self.ex_h, rate,
                           *self._ex_mults)
        excl_p = self.excl.unpack(self.ex_w) if self.excl else {}
        excl_h = self.excl.unpack(self.ex_h) if self.excl else {}
        return SpmdState(self.w_sh, self.h_sh, excl_p, excl_h, it + 1,
                         comm_error), self._metrics(out)


def _wait(works) -> None:
    for w in works:
        if w is not None:
            w.wait()


def _with_shape(pdef, shape):
    return pdef if tuple(shape) == tuple(pdef.shape) else \
        dataclasses.replace(pdef, shape=tuple(shape))


def _merge(a: Dict, b: Dict) -> Dict:
    out = {k: dict(v) for k, v in a.items()}
    for lname, lp in b.items():
        out.setdefault(lname, {}).update(lp)
    return out


# --------------------------------------------------------------------------- #
# sharded-state converters (snapshots stay canonical per-leaf)
# --------------------------------------------------------------------------- #

def shard_train_state(params, state, step: SpmdTrainStep) -> SpmdState:
    """Canonical (params, TrainState) -> this rank's ``SpmdState`` of a
    sharded-state step: the arena buffers packed (rank 0's), taken at this
    rank's shard in shard-major order; tp leaves at its shard."""
    if not step.sharded_state:
        raise ValueError("shard_train_state needs a sharded_state step")
    with torch.no_grad():
        full = step.arena.pack(params)
        step.group.broadcast_(full)
        w_sh = full.index_select(0, step._shard_idx)
        full = step.arena.pack(state.solver.history)
        step.group.broadcast_(full)
        h_sh = full.index_select(0, step._shard_idx)
        excl_p = excl_h = {}
        if step.excl is not None:
            step._load_excl(params, step.ex_w)
            step._load_excl(state.solver.history, step.ex_h)
            excl_p = step.excl.unpack(step.ex_w)
            excl_h = step.excl.unpack(step.ex_h)
    return SpmdState(w_sh, h_sh, excl_p, excl_h, int(state.solver.it),
                     step._load_rows(params, state.comm_error))


def unshard_train_state(spmd_state: SpmdState, step: SpmdTrainStep):
    """``SpmdState`` -> canonical (params, TrainState): the shards
    all-gathered over fsdp into the arena's canonical order (exact copies),
    tp leaves gathered, residual rows stacked. A collective."""
    from .trainer import TrainState
    layout = step.arena
    with torch.no_grad():
        trees = []
        for sh in (spmd_state.flat_w, spmd_state.flat_h):
            flat = sh.new_zeros(layout.padded_total)
            step._gather_bucket(sh, flat, "unshard_ag_bucket")
            trees.append({l: {p: v.clone() for p, v in lv.items()}
                          for l, lv in layout.unpack(flat).items()})
    params = _merge(trees[0], step._gather_tp(spmd_state.excl_params))
    hist = _merge(trees[1], step._gather_tp(spmd_state.excl_hist))
    return params, TrainState(
        solver=SolverState(it=int(spmd_state.it), history=hist),
        comm_error=step.gather_comm_error(spmd_state.comm_error))
