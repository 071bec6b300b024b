"""Train and eval steps on one device (the single-device half of
``poseidon_tpu/parallel/trainer.py``: no mesh, no comm strategy, no TOPK).

One call of ``TrainStep.step`` is Caffe's ``Solver::Step`` iteration:

1. forward and loss through the net, with the per-leaf parameters as
   views of ONE flat arena tensor that requires grad (``core/arena.py``);
2. ``loss.backward()``, which writes the whole gradient into that tensor's
   ``.grad`` — one flat buffer in DWBP order, what a data-parallel sync
   will cut into buckets;
3. one fused update over the arena (``solvers/updates.py``; SGD + L2 is
   the CUDA kernel of ``ops/sgd.py`` on the card), in place;
4. the iteration count bumped.

Parameters and momentum live in the step's two arena buffers. The step
takes and returns the canonical per-leaf trees, as the JAX step does; the
trees it returns are views of its buffers, so feeding them back costs no
copy and any other tree is packed in first. The update is in place, so the
trees a step returned are updated by the next step.

``iter_size > 1`` (gradient accumulation) is later work and raises.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from ..core.net import Net
from ..ops.sgd import sgd_update_
from ..proto.messages import SolverParameter
from ..solvers.updates import SolverState, init_state, make_arena_update_fn


def param_mults(net: Net) -> Dict[str, Dict[str, tuple]]:
    return {lname: {p.name: (p.lr_mult, p.decay_mult) for p in defs}
            for lname, defs in net.param_defs.items()}


class TrainState(NamedTuple):
    """Solver state + managed-comm residuals (always empty on one device;
    kept so snapshots have the JAX package's shape)."""
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


class TrainStep:
    """The single-device training step over the flat parameter arena."""

    def __init__(self, net: Net, sp: SolverParameter):
        if max(1, int(sp.iter_size)) > 1:
            raise NotImplementedError(
                "iter_size > 1 (gradient accumulation) is not in the port "
                "yet")
        self.net = net
        self.sp = sp
        self.arena = net.arena_layout()
        if self.arena is None:
            raise ValueError(f"net {net.name!r} has no parameters to train")
        dev = net.device
        self.flat_w = torch.zeros(self.arena.total, dtype=torch.float32,
                                  device=dev).requires_grad_(True)
        self.flat_h = torch.zeros(self.arena.total, dtype=torch.float32,
                                  device=dev)
        # the SGD + L2 update: the kernel wrapper; chip_smoke.py swaps in
        # the plain version to hold a step against the kernel on the card
        self.sgd_update: Callable = sgd_update_
        self._update = make_arena_update_fn(
            sp, self.arena, dev,
            sgd_update=lambda *a: self.sgd_update(*a))

    def params(self):
        """The current parameters: per-leaf views of the arena."""
        return self.arena.unpack(self.flat_w.detach())

    def load(self, params, state: TrainState):
        """Copy (params, state) into the arena; returns them as views of
        it, the trees ``step`` takes without a copy."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
        return self.params(), TrainState(
            solver=SolverState(it=int(state.solver.it),
                               history=self.arena.unpack(self.flat_h)),
            comm_error=state.comm_error)

    def step(self, params, state: TrainState, batch: Dict[str, torch.Tensor]):
        """-> (params, state, metrics); metrics are 0-d device tensors
        (``loss`` and the net's scalar outputs)."""
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
        self.flat_w.grad = None
        out = self.net.apply(self.arena.unpack(self.flat_w), batch,
                             train=True)
        out.loss.backward()
        with torch.no_grad():
            self._update(self.flat_w, self.flat_w.grad, self.flat_h,
                         state.solver.it)
        self.flat_w.grad = None
        new_state = TrainState(
            solver=SolverState(it=state.solver.it + 1,
                               history=self.arena.unpack(self.flat_h)),
            comm_error=state.comm_error)
        return self.params(), new_state, _scalar_metrics(out)


def build_train_step(net: Net, sp: SolverParameter) -> TrainStep:
    return TrainStep(net, sp)


def build_eval_step(net: Net) -> Callable:
    """Test-phase forward: eval(params, batch) -> {loss, scalar outputs}
    as 0-d device tensors."""

    def eval_step(params, batch):
        with torch.no_grad():
            return _scalar_metrics(net.apply(params, batch, train=False))

    return eval_step
