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
3. one fused update over the arena (``solvers/updates.py``; SGD + L2 is
   the CUDA kernel of ``ops/sgd.py`` on the card), in place, on the
   current stream;
4. the iteration count bumped; metrics averaged over the ranks.

``input_transform`` (the TRAIN step only) runs on the batch before the
forward: the card's half of the data plane's uint8 split, ``(x - mean) *
scale`` in f32 (``runtime/engine.device_input_transform``).

Parameters and momentum live in the step's arena buffers. The step takes
and returns the canonical per-leaf trees, as the JAX step does; the trees
it returns are views of its buffers, so feeding them back costs no copy
and any other tree is packed in first. The update is in place, so the
trees a step returned are updated by the next step. ``load`` broadcasts
parameters and momentum from rank 0.

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
from .strategies import (BucketSync, CommConfig, CommContext, sync_kinds)


def param_mults(net: Net) -> Dict[str, Dict[str, tuple]]:
    return {lname: {p.name: (p.lr_mult, p.decay_mult) for p in defs}
            for lname, defs in net.param_defs.items()}


class TrainState(NamedTuple):
    """Solver state + managed-comm residuals (always empty: TOPK is not
    in the port; kept so snapshots have the JAX package's shape)."""
    solver: SolverState
    comm_error: Dict


def init_train_state(params) -> TrainState:
    return TrainState(solver=init_state(params), comm_error={})


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
        self.sync: Optional[BucketSync] = None
        self._ctx: Optional[CommContext] = None
        if group is not None and group.distributed:
            self.kinds = sync_kinds(net, self.comm)
            self._ctx = CommContext(self.comm, group, self.kinds)
            self.sync = BucketSync(group, self.comm, self.arena.slots,
                                   self.kinds, self.leaves, self.flat_g)
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
        group); returns them as views of it, the trees ``step`` takes
        without a copy."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
            if self.group is not None:
                self.group.broadcast_(self.flat_w)
                self.group.broadcast_(self.flat_h)
        return self.params(), TrainState(
            solver=SolverState(it=int(state.solver.it),
                               history=self.arena.unpack(self.flat_h)),
            comm_error=state.comm_error)

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
            self._update(self.flat_w, self.flat_g, self.flat_h,
                         state.solver.it)
        new_state = TrainState(
            solver=SolverState(it=state.solver.it + 1,
                               history=self.arena.unpack(self.flat_h)),
            comm_error=state.comm_error)
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
