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

``iter_size > 1`` (gradient accumulation) is later work and raises.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.net import Net
from ..ops.sgd import sgd_update_
from ..proto.messages import SolverParameter
from ..solvers.updates import SolverState, init_state, make_arena_update_fn
from .mesh import DataGroup
from .strategies import (TOPK, BucketSync, CommConfig, CommContext,
                         budget_topk_fraction, comm_salt, sync_kinds,
                         topk_compress, wire_all_reduce)


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
        if group is not None and group.distributed:
            self._ctx = CommContext(self.comm, group, self.kinds)
            self.sync = BucketSync(group, self.comm, self.arena.slots,
                                   self.kinds, self.leaves, self.flat_g)
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
