"""Train and eval steps, on one device or data-parallel over a
``DataGroup`` (the port of ``poseidon_tpu/parallel/trainer.py``'s
``build_train_step``/``build_eval_step``: one process per rank, each given
its own per-rank batch as in the JAX engine).

One call of ``TrainStep.step`` is Caffe's ``Solver::Step`` iteration:

1. forward and loss through the net, its parameters given as per-leaf
   leaf tensors that share the storage of ONE flat arena tensor
   (``core/arena.py``), each leaf's ``.grad`` preset to its view of ONE
   flat gradient buffer, zeroed each step;
2. ``loss.backward()``: every leaf's gradient accumulates in place into
   the flat buffer the moment its layer's backward is done. With a data
   group, ``strategies.BucketSync`` all-reduces the DENSE buckets
   asynchronously as they fill (DWBP), SFB layers rebuild their global
   gradient from all-gathered factors (``strategies.SFBMatmul``), the
   step waits on every handle, and DENSE_FUSED buckets are reduced after
   backward; LOCAL layers are never synced;
3. the TOPK stage (JAX's managed-comm tier), on each TOPK leaf's range
   of the flat gradient buffer: on a two-tier group first a sum inside
   the slice, then ``strategies.topk_compress`` against this rank's
   error-feedback residual, a sum of the sparsified tensor over the
   slices (two tiers) or the world (flat), the mean divided by the world,
   written back into the range. Without a data group the step still
   compresses, as JAX's one-device mesh does;
4. one fused update over the arena (``solvers/updates.py``; SGD + L2 is
   the CUDA kernel of ``ops/sgd.py`` on the card), in place, on the
   current stream;
5. the iteration count bumped; metrics averaged over the ranks.

``input_transform`` (the TRAIN step only) runs on the batch before the
forward: the card's half of the data plane's uint8 split, ``(x - mean) *
scale`` in f32 (``runtime/engine.device_input_transform``).

Parameters and momentum live in the step's arena buffers. The step takes
and returns the canonical per-leaf trees, as the JAX step does; the trees
it returns are views of its buffers, so feeding them back costs no copy
and any other tree is packed in first. The update is in place, so the
trees a step returned are updated by the next step. ``load`` broadcasts
parameters and momentum from rank 0.

``TrainState.comm_error`` holds the TOPK residuals. There is one residual
group a rank on a flat group and one a slice on a two-tier group
(``comm_error_groups``); a snapshot stores them stacked, one row a group
(``(groups, *shape)``, JAX's layout). ``load`` takes that stacked form,
reconciled with the step's strategies and group count
(``reconcile_comm_error``), and keeps this rank's row; the states the
step returns hold that row alone, ``(1, *shape)``, and
``gather_comm_error`` stacks every group's row again for a snapshot.

``SSPTrainStep`` (``build_ssp_train_step``) is JAX's SSP step over the
same arena: local steps and a fold into the anchor every staleness+1
iterations (its docstring); its state is ``SSPState``.

``iter_size > 1`` (gradient accumulation) is later work and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.net import Net
from ..ops.sgd import sgd_update_
from ..proto.messages import SolverParameter
from ..solvers.updates import SolverState, init_state, make_arena_update_fn
from .mesh import DataGroup
from .strategies import (DENSE_FUSED, LOCAL, SFB, TOPK, BucketSync,
                         CommConfig, CommContext, budget_topk_fraction,
                         comm_salt, sync_kinds, topk_compress,
                         wire_all_reduce)


def param_mults(net: Net) -> Dict[str, Dict[str, tuple]]:
    return {lname: {p.name: (p.lr_mult, p.decay_mult) for p in defs}
            for lname, defs in net.param_defs.items()}


class TrainState(NamedTuple):
    """Solver state + the TOPK error-feedback residuals
    ({layer: {param: rows}}, rows as the module docstring says)."""
    solver: SolverState
    comm_error: Dict


def comm_error_groups(comm: Optional[CommConfig],
                      group: Optional[DataGroup]) -> int:
    """How many TOPK residuals exist: one a rank on a flat group (local
    gradients differ), one a slice on a two-tier group (each is taken
    from the slice's summed gradient, the same on every rank of the
    slice); one without a data group."""
    comm = comm or CommConfig()
    if group is None:
        return 1
    return group.slices if comm.dcn_axis is not None else group.world


def comm_error_row(comm: Optional[CommConfig],
                   group: Optional[DataGroup]) -> int:
    """This rank's row among the ``comm_error_groups`` residuals."""
    comm = comm or CommConfig()
    if group is None:
        return 0
    return group.slice_index if comm.dcn_axis is not None else group.rank


def init_comm_error(params, comm: Optional[CommConfig],
                    n_groups: int) -> Dict:
    """Zero residuals for every TOPK layer, stacked (n_groups, *shape)."""
    comm = comm or CommConfig()
    return {lname: {k: torch.zeros((n_groups,) + tuple(v.shape),
                                   dtype=v.dtype, device=v.device)
                    for k, v in lparams.items()}
            for lname, lparams in params.items()
            if comm.strategy_for(lname) == TOPK}


def reconcile_comm_error(params, err: Dict, comm: Optional[CommConfig],
                         n_groups: int) -> Dict:
    """Restored residuals under the current config (JAX's
    ``reconcile_comm_error``): a layer still TOPK keeps each residual
    whose stacked shape matches, layers that became TOPK start at zero,
    the rest are dropped."""
    fresh = init_comm_error(params, comm, n_groups)
    out = {}
    for lname, zeros in fresh.items():
        old = err.get(lname, {})
        out[lname] = {k: old[k] if k in old and tuple(old[k].shape)
                      == tuple(z.shape) else z for k, z in zeros.items()}
    return out


def init_train_state(params, comm: Optional[CommConfig] = None,
                     n_groups: int = 1) -> TrainState:
    return TrainState(solver=init_state(params),
                      comm_error=init_comm_error(params, comm, n_groups))


def _scalar_metrics(out) -> Dict[str, torch.Tensor]:
    metrics = {"loss": out.loss.detach()}
    for name, val in out.outputs.items():
        if val.dim() == 0:
            metrics[name] = val.detach().float()
    return metrics


def _rank_mean(metrics: Dict[str, torch.Tensor], group: Optional[DataGroup]
               ) -> Dict[str, torch.Tensor]:
    """Each scalar summed over the ranks and divided by the world (JAX:
    ``psum(val) / n_total``)."""
    if group is None or not group.distributed:
        return metrics
    names = sorted(metrics)
    buf = torch.stack([metrics[k].float() for k in names])
    group.all_reduce_(buf)
    buf = buf / group.world
    return dict(zip(names, buf.unbind()))


class TrainStep:
    """The training step over the flat parameter arena; data-parallel when
    given a distributed ``group``."""

    def __init__(self, net: Net, sp: SolverParameter,
                 group: Optional[DataGroup] = None,
                 comm: Optional[CommConfig] = None,
                 input_transform: Optional[Callable] = None):
        if max(1, int(sp.iter_size)) > 1:
            raise NotImplementedError(
                "iter_size > 1 (gradient accumulation) is not in the port "
                "yet")
        self.net = net
        self.sp = sp
        self.group = group
        self.comm = comm or CommConfig()
        self.comm.validate()
        self.input_transform = input_transform
        self.arena = net.arena_layout()
        if self.arena is None:
            raise ValueError(f"net {net.name!r} has no parameters to train")
        dev = net.device
        self.flat_w = torch.zeros(self.arena.total, dtype=torch.float32,
                                  device=dev)
        self.flat_g = torch.zeros_like(self.flat_w)
        self.flat_h = torch.zeros_like(self.flat_w)
        # the leaves the forward takes: they share flat_w's storage, and
        # autograd accumulates their gradients in place into flat_g
        self.leaves = [v.detach().requires_grad_(True)
                       for v in self.arena.views(self.flat_w)]
        for leaf, g in zip(self.leaves, self.arena.views(self.flat_g)):
            leaf.grad = g
        self._leaf_tree: Dict[str, Dict[str, torch.Tensor]] = {}
        for s, leaf in zip(self.arena.slots, self.leaves):
            self._leaf_tree.setdefault(s.layer, {})[s.pname] = leaf
        self.kinds = sync_kinds(net, self.comm)
        self.sync: Optional[BucketSync] = None
        self._ctx: Optional[CommContext] = None
        self._init_sync(group)
        # the TOPK stage: its leaves' arena slots (in the net's layer
        # order, as JAX walks them), the fraction, the residual groups and
        # this rank's row
        slot_of = {(s.layer, s.pname): s for s in self.arena.slots}
        self.topk_slots = [slot_of[(lname, p.name)]
                           for lname, defs in net.param_defs.items()
                           if self.kinds.get(lname) == TOPK for p in defs]
        self.topk_fraction = budget_topk_fraction(net, self.comm)
        self.n_err_groups = comm_error_groups(self.comm, group)
        self.err_row = comm_error_row(self.comm, group)
        self._comm_group = (group if group is not None
                            else DataGroup.single(dev))
        # the SGD + L2 update: the kernel wrapper; chip_smoke.py swaps in
        # the plain version to hold a step against the kernel on the card
        self.sgd_update: Callable = sgd_update_
        self._update = make_arena_update_fn(
            sp, self.arena, dev,
            sgd_update=lambda *a: self.sgd_update(*a))

    def _init_sync(self, group: Optional[DataGroup]) -> None:
        """The per-step gradient exchange: every rank, every step."""
        if group is not None and group.distributed:
            self._ctx = CommContext(self.comm, group, self.kinds)
            self.sync = BucketSync(group, self.comm, self.arena.slots,
                                   self.kinds, self.leaves, self.flat_g)

    def params(self):
        """The current parameters: per-leaf views of the arena."""
        return self.arena.unpack(self.flat_w)

    def load(self, params, state: TrainState):
        """Copy (params, state) into the arena (rank 0's, with a data
        group) and take this rank's residual row of ``state.comm_error``
        (stacked, reconciled as the module docstring says); returns them
        as views of the arena, the trees ``step`` takes without a
        copy."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
            if self.group is not None:
                self.group.broadcast_(self.flat_w)
                self.group.broadcast_(self.flat_h)
        stacked = reconcile_comm_error(params, state.comm_error, self.comm,
                                       self.n_err_groups)
        r = self.err_row
        rows = {lname: {k: v[r:r + 1].to(self.flat_w.device,
                                         dtype=torch.float32, copy=True)
                        for k, v in lv.items()}
                for lname, lv in stacked.items()}
        return self.params(), TrainState(
            solver=SolverState(it=int(state.solver.it),
                               history=self.arena.unpack(self.flat_h)),
            comm_error=rows)

    def load_weights(self, params):
        """Copy new parameters into the arena (rank 0's), leaving the
        momentum and the residuals as they are; returns the params
        views."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            if self.group is not None:
                self.group.broadcast_(self.flat_w)
        return self.params()

    def gather_comm_error(self, comm_error: Dict) -> Dict:
        """Every residual group's row stacked in group order (one a rank,
        or the first rank's of each slice), the form a snapshot stores.
        A collective: every rank calls it."""
        if not comm_error or self.group is None \
                or not self.group.distributed:
            return comm_error
        every = 1 if self.comm.dcn_axis is None else self.group.slice_size
        return {lname: {k: self.group.all_gather(v)[::every]
                        for k, v in lv.items()}
                for lname, lv in comm_error.items()}

    def _topk_stage(self, state: TrainState) -> Dict:
        """Compress, exchange and write back each TOPK leaf's gradient
        (JAX's managed-comm tier); returns the new residuals."""
        cfg, it = self.comm, int(state.solver.it)
        two_tier = cfg.dcn_axis is not None
        out = dict(state.comm_error)
        for s in self.topk_slots:
            view = self.flat_g[s.offset:s.offset + s.size]
            g = view.view(s.shape)
            if two_tier:
                # the fast tier: a dense sum inside the slice, at the
                # wire dtype, as JAX's
                g = wire_all_reduce(g, self._comm_group.intra(), "sum",
                                    cfg.wire_dtype)
            sent, resid = topk_compress(
                g, self.topk_fraction, state.comm_error[s.layer][s.pname][0],
                cfg.topk_policy, it, salt=comm_salt(s.layer, s.pname),
                block=cfg.topk_block, wire=cfg.wire_dtype)
            # sent is already rounded to the wire dtype: its cast is exact
            over = (self._comm_group.cross() if two_tier
                    else self._comm_group)
            synced = wire_all_reduce(sent, over, "sum", cfg.wire_dtype)
            if cfg.reduce == "mean":
                synced = synced / self._comm_group.world
            view.copy_(synced.view(-1))
            out[s.layer] = {**out.get(s.layer, {}), s.pname: resid[None]}
        return out

    def step(self, params, state: TrainState, batch: Dict[str, torch.Tensor]):
        """-> (params, state, metrics); metrics are 0-d device tensors
        (``loss`` and the net's scalar outputs), averaged over the ranks."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
            self.flat_g.zero_()
        if self.sync is not None:
            self.sync.begin()
        if self.input_transform is not None:
            batch = self.input_transform(batch)
        out = self.net.apply(self._leaf_tree, batch, train=True,
                             comm=self._ctx)
        out.loss.backward()
        if self.sync is not None:
            self.sync.finish()
        with torch.no_grad():
            comm_error = (self._topk_stage(state) if self.topk_slots
                          else state.comm_error)
            self._update(self.flat_w, self.flat_g, self.flat_h,
                         state.solver.it)
        new_state = TrainState(
            solver=SolverState(it=state.solver.it + 1,
                               history=self.arena.unpack(self.flat_h)),
            comm_error=comm_error)
        return (self.params(), new_state,
                _rank_mean(_scalar_metrics(out), self.group))


def build_train_step(net: Net, sp: SolverParameter,
                     group: Optional[DataGroup] = None,
                     comm: Optional[CommConfig] = None,
                     input_transform: Optional[Callable] = None
                     ) -> TrainStep:
    return TrainStep(net, sp, group, comm, input_transform)


def build_eval_step(net: Net, group: Optional[DataGroup] = None
                    ) -> Callable:
    """Test-phase forward: eval(params, batch) -> {loss, scalar outputs}
    as 0-d device tensors, averaged over the ranks."""

    def eval_step(params, batch):
        with torch.no_grad():
            return _rank_mean(
                _scalar_metrics(net.apply(params, batch, train=False)),
                group)

    return eval_step


# --------------------------------------------------------------------------- #
# SSP (staleness > 0): bounded staleness as periodic reconciliation
# --------------------------------------------------------------------------- #

class SSPState(NamedTuple):
    """The SSP carry (JAX's ``SSPState``): each group's divergent local
    parameters and momentum, the anchor they diverged from, the iteration,
    the TOPK residuals of the boundary's delta exchange, and under
    ``server_logic="adarevision"`` the server's accumulators
    ({layer: {param: {"z", "zmax"}}}, started at 1) and each group's raw
    gradient sum since its last boundary.

    Two forms, as ``TrainState.comm_error`` has: a STACKED form, one row a
    group in group order (``(groups, *shape)`` for ``local_params``,
    ``local_history``, ``comm_error`` and ``adarev_gsum``: JAX's snapshot
    layout, what ``init_ssp_state``, ``restore`` and
    ``SSPTrainStep.gather_state`` give), and the form a running
    ``SSPTrainStep`` returns: this rank's group alone, ``local_params``,
    ``local_history`` and ``adarev_gsum`` as per-leaf views of the step's
    buffers and ``comm_error`` as ``(1, *shape)`` rows."""
    local_params: Dict
    local_history: Dict
    anchor_params: Dict
    it: int
    comm_error: Dict
    adarev_server: Dict
    adarev_gsum: Dict


def init_adarev_state(params, comm: Optional[CommConfig],
                      n_groups: int) -> Tuple[Dict, Dict]:
    """(adarev_server, adarev_gsum) for ``server_logic="adarevision"``:
    z/zmax start at 1 (the AdaRevisionRow constructor), the gradient sums
    at 0, stacked (n_groups, *shape); both empty under "inc". LOCAL layers
    have neither."""
    comm = comm or CommConfig()
    if comm.server_logic != "adarevision":
        return {}, {}
    server = {lname: {pn: {"z": torch.ones_like(v), "zmax":
                           torch.ones_like(v)} for pn, v in lp.items()}
              for lname, lp in params.items()
              if comm.strategy_for(lname) != LOCAL}
    gsum = {lname: {pn: torch.zeros((n_groups,) + tuple(v.shape),
                                    dtype=v.dtype, device=v.device)
                    for pn, v in lp.items()}
            for lname, lp in params.items()
            if comm.strategy_for(lname) != LOCAL}
    return server, gsum


def init_ssp_state(params, n_groups: int,
                   comm: Optional[CommConfig] = None) -> SSPState:
    """The stacked SSP state of a fresh start: every group's local copy is
    ``params``, momentum zero, iteration 0."""
    def stack(tree):
        return {l: {p: v[None].expand((n_groups,) + tuple(v.shape)).clone()
                    for p, v in lp.items()} for l, lp in tree.items()}

    zeros = {l: {p: torch.zeros_like(v) for p, v in lp.items()}
             for l, lp in params.items()}
    server, gsum = init_adarev_state(params, comm, n_groups)
    return SSPState(local_params=stack(params), local_history=stack(zeros),
                    anchor_params=params, it=0,
                    comm_error=init_comm_error(params, comm, n_groups),
                    adarev_server=server, adarev_gsum=gsum)


def _runs(slots, keep) -> List[Tuple[int, int]]:
    """Maximal contiguous [lo, hi) ranges of the slots ``keep`` admits."""
    out: List[Tuple[int, int]] = []
    for s in slots:
        if not keep(s):
            continue
        if out and out[-1][1] == s.offset:
            out[-1] = (out[-1][0], s.offset + s.size)
        else:
            out.append((s.offset, s.offset + s.size))
    return out


class SSPTrainStep(TrainStep):
    """Staleness-s data parallelism (JAX's ``build_ssp_train_step``,
    ssp_consistency_controller.cpp:37-161) over the port's ``DataGroup``.

    Each group runs local steps on its own parameters (the arena update,
    the SGD kernel on the card, included) with no per-step gradient
    exchange on a flat group. When the iteration count, after its
    increment, is a multiple of s+1, the groups' deltas from the anchor
    are summed and folded in, ``anchor + scale * sum`` with ``scale =
    1/groups`` under ``reduce="mean"``, and every group restarts from the
    new anchor:

    - DENSE (and DENSE_FUSED, and SFB inside a two-tier slice): the flat
      delta's ranges in ``bucket_mb`` buckets, one all-reduce each, at the
      wire dtype;
    - TOPK: ``topk_compress`` of each leaf's delta against this group's
      residual, its rotation counter ``it // (s+1)`` (once a boundary, so
      a rotation never skips slabs);
    - LOCAL: never synced; the local copy stays;
    - ``server_logic="adarevision"``: the groups' raw gradient sums since
      the last boundary are all-gathered and applied in group order by
      the delay-corrected AdaGrad rule (adarevision_server_table_logic.
      cpp:52-175), ``reduce`` and the wire ignored as in JAX.

    On a two-tier group (``comm.dcn_axis``) a group is a slice: inside it
    DENSE and SFB sync every step during backward, and TOPK, LOCAL and
    DENSE_FUSED gradients are reduced after backward (``comm.reduce``,
    the wire dtype), so a slice's ranks hold one copy; the boundary runs
    across the slices. SFB on a flat group is refused: it is a per-step
    exchange and flat SSP has no per-step exchange for it to ride.

    The step returns (anchor, state, metrics): the anchor is the engine's
    view of the parameters (what the parameter server holds); the loss
    and scalar outputs are averaged over every rank every step."""

    def __init__(self, net: Net, sp: SolverParameter, staleness: int,
                 group: Optional[DataGroup] = None,
                 comm: Optional[CommConfig] = None,
                 input_transform: Optional[Callable] = None):
        comm = comm or CommConfig()
        comm.validate()
        if staleness < 1:
            raise ValueError(f"SSP needs staleness >= 1, got {staleness}")
        self.two_tier = comm.dcn_axis is not None
        for lname in net.param_defs:
            if comm.strategy_for(lname) == SFB and not self.two_tier:
                raise ValueError(
                    f"layer {lname!r}: SFB is a per-step backward-time "
                    f"exchange and cannot compose with flat-mesh SSP local "
                    f"steps; use DENSE or TOPK (delta compression), or a "
                    f"two-tier mesh (comm.dcn_axis) where SFB rides the "
                    f"intra-slice tier")
        self.adarev = comm.server_logic == "adarevision"
        if self.adarev and any(comm.strategy_for(l) == TOPK
                               for l in net.param_defs):
            raise ValueError(
                "server_logic='adarevision' does not compose with TOPK "
                "delta compression: the server logic consumes each group's "
                "RAW accumulated gradient (adarevision_server_table_logic."
                "cpp applies -eta*u + (eta_old-eta)*g_bck per update), "
                "while TOPK rewrites the delta; pick one")
        self.staleness = staleness
        self.period = staleness + 1
        super().__init__(net, sp, group, comm, input_transform)
        self.flat_a = torch.zeros_like(self.flat_w)       # the anchor
        # the groups and the tier the boundary runs across
        self.cross = (self._comm_group.cross() if self.two_tier
                      else self._comm_group)
        self.n_groups = self.n_err_groups
        self.row = self.err_row
        slot_kind = {s: self.comm.strategy_for(s.layer)
                     for s in self.arena.slots}
        self.nonlocal_runs = _runs(self.arena.slots,
                                   lambda s: slot_kind[s] != LOCAL)
        # the delta buckets: every non-LOCAL, non-TOPK range, cut at
        # bucket_mb elements as the per-step sync's buckets are
        step = (max(1, int(self.comm.bucket_mb * 1e6) // 4)
                if self.comm.bucket_mb > 0 else None)
        self.delta_buckets: List[Tuple[int, int]] = []
        dense = lambda s: slot_kind[s] not in (LOCAL, TOPK)  # noqa: E731
        runs = (_runs(self.arena.slots, dense) if step is not None else
                [(s.offset, s.offset + s.size) for s in self.arena.slots
                 if dense(s)])
        for lo, hi in runs:
            cut = step or (hi - lo)
            self.delta_buckets += [(b, min(b + cut, hi))
                                   for b in range(lo, hi, cut)]
        if self.adarev:
            self.flat_u = torch.zeros_like(self.flat_w)   # raw grad sum
            self.flat_z = torch.ones_like(self.flat_w)
            self.flat_zmax = torch.ones_like(self.flat_w)

    def _init_sync(self, group: Optional[DataGroup]) -> None:
        """Flat: no per-step exchange. Two tiers: the per-step tier inside
        the slice, DENSE hooked into backward, SFB on the slice's factors,
        and TOPK, LOCAL and DENSE_FUSED reduced after backward."""
        if group is None or not group.distributed \
                or self.comm.dcn_axis is None:
            return
        intra = group.intra()
        if intra.pg is None:
            return
        cfg = dataclasses.replace(self.comm, dcn_axis=None)
        kinds = {l: (DENSE_FUSED if k in (TOPK, LOCAL) else k)
                 for l, k in self.kinds.items()}
        self._ctx = CommContext(cfg, intra, kinds)
        self.sync = BucketSync(intra, cfg, self.arena.slots, kinds,
                               self.leaves, self.flat_g)

    # ---------------------------------------------------------------- #
    def _pack_rows(self, tree: Dict, row: int, out: torch.Tensor) -> None:
        """Row ``row`` of a stacked tree into a flat buffer (absent leaves
        keep what the buffer holds)."""
        for s in self.arena.slots:
            v = tree.get(s.layer, {}).get(s.pname)
            if v is not None:
                out[s.offset:s.offset + s.size].copy_(
                    v[row].reshape(-1).to(out.device, torch.float32))

    def _nonlocal(self, tree: Dict) -> Dict:
        return {l: v for l, v in tree.items()
                if self.comm.strategy_for(l) != LOCAL}

    def load(self, params, state: SSPState):
        """Copy a stacked ``SSPState`` in (this rank's group row; the
        anchor is rank 0's) and return (anchor, running state)."""
        if not isinstance(state, SSPState):
            raise TypeError("SSPTrainStep.load takes an SSPState "
                            "(runtime/checkpoint.coerce_state converts)")
        r = self.row
        with torch.no_grad():
            self.arena.pack(state.anchor_params, self.flat_a)
            if self.group is not None:
                self.group.broadcast_(self.flat_a)
            self._pack_rows(state.local_params, r, self.flat_w)
            self.flat_h.zero_()
            self._pack_rows(state.local_history, r, self.flat_h)
            if self.adarev:
                self.flat_u.zero_()
                self._pack_rows(state.adarev_gsum, r, self.flat_u)
                for s in self.arena.slots:
                    zz = state.adarev_server.get(s.layer, {}).get(s.pname)
                    if zz is None:
                        continue
                    for key, buf in (("z", self.flat_z),
                                     ("zmax", self.flat_zmax)):
                        buf[s.offset:s.offset + s.size].copy_(
                            zz[key].reshape(-1).to(buf.device))
        stacked = reconcile_comm_error(state.anchor_params,
                                       state.comm_error, self.comm,
                                       self.n_groups)
        rows = {lname: {k: v[r:r + 1].to(self.flat_w.device,
                                         dtype=torch.float32,
                                         copy=True)
                        for k, v in lv.items()}
                for lname, lv in stacked.items()}
        return self.arena.unpack(self.flat_a), self._state(
            int(state.it), rows)

    def load_weights(self, params):
        """New weights as the anchor and every group's local copy
        (momentum, residuals and accumulators stay)."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_a)
            if self.group is not None:
                self.group.broadcast_(self.flat_a)
            self.flat_w.copy_(self.flat_a)
        return self.arena.unpack(self.flat_a)

    def _state(self, it: int, comm_error: Dict) -> SSPState:
        server, gsum = {}, {}
        if self.adarev:
            z = self.arena.unpack(self.flat_z)
            zm = self.arena.unpack(self.flat_zmax)
            server = {l: {p: {"z": z[l][p], "zmax": zm[l][p]} for p in lp}
                      for l, lp in self._nonlocal(z).items()}
            gsum = self._nonlocal(self.arena.unpack(self.flat_u))
        return SSPState(local_params=self.params(),
                        local_history=self.arena.unpack(self.flat_h),
                        anchor_params=self.arena.unpack(self.flat_a),
                        it=it, comm_error=comm_error,
                        adarev_server=server, adarev_gsum=gsum)

    def gather_state(self, state: SSPState) -> SSPState:
        """The stacked form of a running state, every group's row in
        group order (one a rank, or the first rank's of each slice), the
        form a snapshot stores. A collective: every rank calls it."""
        every = self.group.slice_size if (
            self.two_tier and self.group is not None) else 1

        def rows(flat: torch.Tensor) -> torch.Tensor:
            if self.group is None or not self.group.distributed:
                return flat[None]
            return self.group.all_gather(flat[None])[::every]

        def stack(flat: torch.Tensor, only_nonlocal: bool) -> Dict:
            st = rows(flat)
            out: Dict = {}
            for s in self.arena.slots:
                if only_nonlocal and \
                        self.comm.strategy_for(s.layer) == LOCAL:
                    continue
                out.setdefault(s.layer, {})[s.pname] = \
                    st[:, s.offset:s.offset + s.size].reshape(
                        (st.shape[0],) + tuple(s.shape))
            return out

        return state._replace(
            local_params=stack(self.flat_w, False),
            local_history=stack(self.flat_h, False),
            comm_error=self.gather_comm_error(state.comm_error),
            adarev_gsum=stack(self.flat_u, True) if self.adarev else {})

    # ---------------------------------------------------------------- #
    def _adarev_fold(self) -> None:
        """The server's ApplyRowOpLog over this boundary's arriving
        updates, one group's sum after another in group order; g_bck (the
        mass applied since the sender's snapshot) is 0 at the boundary's
        start and grows by each applied update."""
        eta0 = float(self.comm.adarev_init_step)
        for lo, hi in self.nonlocal_runs:
            u_all = self.cross.all_gather(self.flat_u[None, lo:hi])
            p = self.flat_a[lo:hi]
            z = self.flat_z[lo:hi]
            zmax = self.flat_zmax[lo:hi]
            g_bck = torch.zeros_like(p)
            for u in u_all:
                eta_old = eta0 / torch.sqrt(zmax)
                z.copy_(z + u * (u + 2.0 * g_bck))
                torch.maximum(zmax, z, out=zmax)
                eta = eta0 / torch.sqrt(zmax)
                p.copy_(p - eta * u + (eta_old - eta) * g_bck)
                g_bck = g_bck + u
            self.flat_u[lo:hi].zero_()

    def _boundary(self, state_err: Dict, it: int) -> Dict:
        """Fold the groups' deltas into the anchor and restart every group
        from it; returns the new TOPK residual rows."""
        cfg = self.comm
        scale = 1.0 / self.n_groups if cfg.reduce == "mean" else 1.0
        out = dict(state_err)
        if self.adarev:
            self._adarev_fold()
        else:
            for lo, hi in self.delta_buckets:
                delta = self.flat_w[lo:hi] - self.flat_a[lo:hi]
                summed = wire_all_reduce(delta, self.cross, "sum",
                                         cfg.wire_dtype)
                if scale != 1.0:
                    summed = scale * summed
                self.flat_a[lo:hi] += summed
            for s in self.topk_slots:
                a = self.flat_a[s.offset:s.offset + s.size].view(s.shape)
                w = self.flat_w[s.offset:s.offset + s.size].view(s.shape)
                sent, resid = topk_compress(
                    w - a, self.topk_fraction,
                    state_err[s.layer][s.pname][0], cfg.topk_policy,
                    it // self.period, salt=comm_salt(s.layer, s.pname),
                    block=cfg.topk_block, wire=cfg.wire_dtype)
                summed = wire_all_reduce(sent, self.cross, "sum",
                                         cfg.wire_dtype)
                if scale != 1.0:
                    summed = scale * summed
                a += summed
                out[s.layer] = {**out.get(s.layer, {}),
                                s.pname: resid[None]}
        for lo, hi in self.nonlocal_runs:
            self.flat_w[lo:hi].copy_(self.flat_a[lo:hi])
        return out

    def step(self, params, state: SSPState, batch: Dict[str, torch.Tensor]):
        """-> (anchor, state, metrics): one local step, and on every
        (s+1)-th iteration the boundary."""
        with torch.no_grad():
            self.arena.pack(state.local_params, self.flat_w)
            self.arena.pack(state.local_history, self.flat_h)
            self.arena.pack(state.anchor_params, self.flat_a)
            self.flat_g.zero_()
        if self.sync is not None:
            self.sync.begin()
        if self.input_transform is not None:
            batch = self.input_transform(batch)
        out = self.net.apply(self._leaf_tree, batch, train=True,
                             comm=self._ctx)
        out.loss.backward()
        if self.sync is not None:
            self.sync.finish()
        it = int(state.it)
        comm_error = state.comm_error
        with torch.no_grad():
            if self.adarev:
                # the client's oplog: raw gradient mass since the last sync
                self.flat_u += self.flat_g
            self._update(self.flat_w, self.flat_g, self.flat_h, it)
            it += 1
            if it % self.period == 0:
                comm_error = self._boundary(comm_error, it)
        return (self.arena.unpack(self.flat_a), self._state(it, comm_error),
                _rank_mean(_scalar_metrics(out), self.group))


def build_ssp_train_step(net: Net, sp: SolverParameter, staleness: int,
                         group: Optional[DataGroup] = None,
                         comm: Optional[CommConfig] = None,
                         input_transform: Optional[Callable] = None
                         ) -> SSPTrainStep:
    return SSPTrainStep(net, sp, staleness, group, comm, input_transform)
