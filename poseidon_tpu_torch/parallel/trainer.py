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

``iter_size`` K > 1 (gradient accumulation, JAX's ``iter_size``): a step
takes K micro-batches and runs forward and backward on each in turn, so
only one micro-batch's activations are live, the gradients summing in
place in the flat buffer; the sum is scaled by 1/K (Caffe's
``SGDSolver::Normalize``), synced once (``BucketSync(accumulate=True)``:
the DENSE buckets after the last backward, never K times; SFB and
DENSE_FUSED leaves one all-reduce a leaf), TOPK compresses the
accumulated gradient, and one update runs. The scalar metrics are the
mean over the micro-batches. The SSP and SPMD steps refuse K > 1: the
engine runs ``iter_size`` 1 under SSP staleness and ``--mesh``, with a
warning, as the JAX engine does.

``steps_per_dispatch`` K > 1 (JAX's ``scan_steps``): ``multi_step`` takes
a ``{top: tensor}`` dict with a leading ``[K]`` axis (``[K, iter_size,
...]`` under iter_size; none with ``reuse_batch``, JAX's
``scan_reuse_batch``, which feeds one batch to every step) and returns
``[K]``-stacked metrics after K optimizer steps. On the CPU it runs the K
steps one after another, the plain version of the card's path. On the card
the first dispatch of each batch shape runs the K steps eagerly on a side
stream (the warm-up: it is that dispatch's work) and then captures them,
once, into one ``torch.cuda.CUDAGraph``; every later dispatch copies the
stacked batch and the K rates into the graph's static inputs and replays
it. The host values a step reads are the graph's trap, each handled:

- the rate: the K rates are written into a device tensor before each
  replay and K7 reads its float there (``ops/sgd.py``'s device-rate
  entry; the other arms multiply the same tensor);
- the dropout generator and DUMMY_DATA's: registered with the graph, so
  each replay draws on from where the generator stands, the masks of
  single steps (K-chunked runs draw the same masks as single steps); a
  checkpointed DROPOUT replays its mask from slots the capture registers
  (``core/remat.RematRng``);
- the TOPK counter (``int(it)`` in ``_topk_stage``): the random and
  fixed_order policies pick by it on the host, so a CUDA graph refuses
  them; magnitude never reads it;
- the TOPK residuals live in step-owned buffers the steps update in
  place; the returned metrics are copies, never the graph's own outputs;
- gloo collectives cannot be captured (``graph_refusal``: the engine runs
  single steps with a warning); a failed capture raises, nothing falls
  back to eager steps.

A replay launches what the capture recorded and calls no wrapper, so the
kernels' counters do not move: ``graph_launches`` is what one replay
launches and ``replays`` how many ran.

``remat_plan`` (``core/remat.RematPlan``) names the layers whose forward
bodies are checkpointed (``Net.apply(remat=)``): bitwise to the stored
step, fewer activations held.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.net import Net
from ..core.remat import net_generators
from ..ops import _build
from ..ops.sgd import sgd_update_
from ..proto.messages import SolverParameter
from ..runtime.attribution import scope
from ..runtime.metrics import log
from ..solvers.updates import (SolverState, init_state, learning_rates,
                               make_arena_update_fn)
from .mesh import DataGroup
from .strategies import (DENSE, DENSE_FUSED, LOCAL, SFB, TOPK, BucketSync,
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


def _micro_mean(rows: List[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the micro-batches (JAX: ``jnp.mean`` of
    the stacked values)."""
    if len(rows) == 1:
        return rows[0]
    return {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}


def iter_size_refusal(step: str, rule: str) -> str:
    """The SSP and SPMD steps' refusal of iter_size > 1, naming the
    engine's rule."""
    return (f"iter_size > 1 does not compose with {step}: the engine "
            f"warns and runs iter_size 1 under {rule}, as the JAX engine "
            f"does (runtime/engine.py); build this step with iter_size 1")


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


# the TOPK policies that pick by the host's step counter
HOST_COUNTER_POLICIES = ("random", "fixed_order")


def graph_refusal(group: Optional[DataGroup], device) -> Optional[str]:
    """Why K train steps on ``device`` cannot be one CUDA graph, or None
    when they can (or when no graph is made: the CPU runs eager steps).
    Capture needs NCCL's collectives: gloo ranks sharing the card cannot be
    captured (the engine then runs single steps, as JAX's does under
    SSP)."""
    if torch.device(device).type != "cuda":
        return None
    if group is not None and group.distributed and group.backend != "nccl":
        return (f"a CUDA graph cannot capture {group.backend} collectives "
                f"(ranks sharing a card run gloo); capture needs NCCL")
    return None


class _Captured(NamedTuple):
    """A K-step dispatch captured for one batch shape: the graph, its
    static inputs (the stacked batch and the K rates), its metric
    outputs, the remat'ed dropouts' generator slots with each one's
    offset from the dispatch's start, and what one replay launches."""
    key: tuple
    graph: object
    inputs: Dict[str, torch.Tensor]
    rates: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    slots: List[torch.Generator]
    offsets: List[int]
    launches: Dict[str, int]


class TrainStep:
    """The training step over the flat parameter arena; data-parallel when
    given a distributed ``group``."""

    def __init__(self, net: Net, sp: SolverParameter,
                 group: Optional[DataGroup] = None,
                 comm: Optional[CommConfig] = None,
                 input_transform: Optional[Callable] = None,
                 steps_per_dispatch: int = 1, reuse_batch: bool = False,
                 remat_plan=None):
        self.iter_size = max(1, int(sp.iter_size))
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.reuse_batch = bool(reuse_batch)
        self.remat = (remat_plan.layer_set if remat_plan is not None
                      and remat_plan.layers else None)
        self.net = net
        self.sp = sp
        self.group = group
        self.comm = comm or CommConfig()
        self.comm.validate()
        self.input_transform = input_transform
        # the blobs each step keeps for the engine's HDF5_OUTPUT dump
        # (``dumped``: detached, by name, from the step's forward)
        self.dump_blobs: Tuple[str, ...] = ()
        self.dumped: Dict[str, torch.Tensor] = {}
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
        # the K-step dispatch: the graph, the step-owned TOPK residuals it
        # updates in place, and the replays' count
        self._captured: Optional[_Captured] = None
        self._err: Optional[Dict] = None
        self.replays = 0
        if self.steps_per_dispatch > 1 and dev.type == "cuda":
            reason = graph_refusal(group, dev)
            if reason is not None:
                raise ValueError(f"steps_per_dispatch "
                                 f"{self.steps_per_dispatch}: {reason}")
            if self.topk_slots and \
                    self.comm.topk_policy in HOST_COUNTER_POLICIES:
                raise ValueError(
                    f"steps_per_dispatch {self.steps_per_dispatch} on the "
                    f"card does not compose with topk_policy "
                    f"{self.comm.topk_policy!r}: it picks by the host's "
                    f"step counter, which a CUDA graph would freeze at the "
                    f"captured step's; use topk_policy 'magnitude' or "
                    f"steps_per_dispatch 1")

    @property
    def graph_launches(self) -> Dict[str, int]:
        """What one replay of the captured graph launches, by kernel
        (empty before a capture)."""
        return dict(self._captured.launches) if self._captured else {}

    def _init_sync(self, group: Optional[DataGroup]) -> None:
        """The per-step gradient exchange: every rank, every step; under
        iter_size > 1 once, after the accumulation."""
        if group is None or not group.distributed:
            return
        self._ctx = CommContext(self.comm, group, self.kinds)
        accumulate = self.iter_size > 1
        self.sync = BucketSync(group, self.comm, self.arena.slots,
                               self.kinds, self.leaves, self.flat_g,
                               accumulate=accumulate)
        if not accumulate:
            return
        # the per-backward strategies do not apply to the accumulated
        # step: say which layers fall back to one dense sync a leaf
        # (JAX's warning)
        what = []
        sfb = [l for l in self.net.param_defs
               if self.comm.strategy_for(l) == SFB]
        if sfb:
            what.append(f"SFB layers {sfb}")
        if not self.comm.param_arena:
            what.append(f"dwbp_bucket_mb={self.comm.bucket_mb:g}")
        if what:
            log(f"WARNING: iter_size={self.iter_size} accumulates gradients "
                f"before one dense post-accumulation psum per leaf for "
                f"{', '.join(what)}; per-backward comm strategies do not "
                f"apply to the accumulated step (DENSE layers ride the "
                f"parameter arena's buckets"
                + (")" if self.comm.param_arena else
                   " when param_arena is on)"), rank=group.rank)

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

    def canonical_params(self, params):
        """The canonical parameter tree eval and snapshots take (these
        params already are; an SPMD step gathers its tp shards)."""
        return params

    def export(self, params, state):
        """Canonical (params, state) for a snapshot, every residual
        group's row stacked. A collective: every rank calls it."""
        return params, state._replace(
            comm_error=self.gather_comm_error(state.comm_error))

    def _topk_stage(self, comm_error: Dict, it: int) -> Dict:
        """Compress, exchange and write back each TOPK leaf's gradient
        (JAX's managed-comm tier); returns the new residuals."""
        cfg = self.comm
        two_tier = cfg.dcn_axis is not None
        out = dict(comm_error)
        for s in self.topk_slots:
            view = self.flat_g[s.offset:s.offset + s.size]
            g = view.view(s.shape)
            if two_tier:
                # the fast tier: a dense sum inside the slice, at the
                # wire dtype, as JAX's
                g = wire_all_reduce(g, self._comm_group.intra(), "sum",
                                    cfg.wire_dtype)
            sent, resid = topk_compress(
                g, self.topk_fraction, comm_error[s.layer][s.pname][0],
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

    def _micro_batches(self, batch) -> list:
        k = self.iter_size
        micro = [batch] if k == 1 else list(batch)
        if len(micro) != k:
            raise ValueError(f"iter_size {k} takes {k} micro-batches a "
                             f"step, got {len(micro)}")
        if k > 1 and self.dump_blobs:
            raise ValueError("iter_size > 1 is incompatible with dump_blobs "
                             "(per-iteration HDF5 dump semantics)")
        return micro

    def _run(self, micro: list, it: int, comm_error: Dict, rate=None):
        """One step's work on the arena buffers: forward and backward over
        the micro-batches, the sync, the TOPK stage and the update (at
        ``rate``, a 0-d device tensor, when given; else the host's rate of
        iteration ``it``). -> (new residuals, metrics)."""
        k = self.iter_size
        with torch.no_grad():
            self.flat_g.zero_()
        if self.sync is not None:
            self.sync.begin()
        rows = []
        for mb in micro:
            if self.input_transform is not None:
                mb = self.input_transform(mb)
            # the accumulated step takes no per-backward exchange (JAX
            # applies the micro-batches with comm=None)
            out = self.net.apply(self._leaf_tree, mb, train=True,
                                 comm=self._ctx if k == 1 else None,
                                 keep_blobs=bool(self.dump_blobs),
                                 remat=self.remat)
            self.dumped = {b: out.blobs[b].detach() for b in self.dump_blobs}
            out.loss.backward()
            rows.append(_scalar_metrics(out))
            del out
        if k > 1:
            with torch.no_grad():
                self.flat_g.div_(k)
        if self.sync is not None:
            self.sync.finish()
        with torch.no_grad():
            comm_error = (self._topk_stage(comm_error, it) if self.topk_slots
                          else comm_error)
            with scope("optimizer_update"):
                self._update(self.flat_w, self.flat_g, self.flat_h, it, rate)
        return comm_error, _rank_mean(_micro_mean(rows), self.group)

    def step(self, params, state: TrainState, batch):
        """-> (params, state, metrics); metrics are 0-d device tensors
        (``loss`` and the net's scalar outputs), averaged over the
        micro-batches and the ranks. ``batch`` is one ``{top: tensor}``
        dict, or under iter_size K > 1 a sequence of K of them."""
        micro = self._micro_batches(batch)
        with torch.no_grad(), scope("arena_pack"):
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
        comm_error, metrics = self._run(micro, int(state.solver.it),
                                        state.comm_error)
        new_state = TrainState(
            solver=SolverState(it=state.solver.it + 1,
                               history=self.arena.unpack(self.flat_h)),
            comm_error=comm_error)
        return self.params(), new_state, metrics

    # ---------------------------------------------------------------- #
    # K steps a dispatch
    # ---------------------------------------------------------------- #
    def _step_batch(self, batches: Dict[str, torch.Tensor], i: int) -> list:
        """Step i's micro-batches out of the stacked dispatch input."""
        rows = batches if self.reuse_batch else {
            t: v[i] for t, v in batches.items()}
        if self.iter_size == 1:
            return [rows]
        return [{t: v[j] for t, v in rows.items()}
                for j in range(self.iter_size)]

    def _check_stack(self, batches: Dict[str, torch.Tensor]) -> None:
        lead = (() if self.reuse_batch else (self.steps_per_dispatch,)) + (
            (self.iter_size,) if self.iter_size > 1 else ())
        for t, v in batches.items():
            if tuple(v.shape[:len(lead)]) != lead:
                raise ValueError(
                    f"steps_per_dispatch {self.steps_per_dispatch}"
                    + (" (reuse_batch)" if self.reuse_batch else "")
                    + f", iter_size {self.iter_size}: input {t!r} needs "
                    f"the leading axes {lead}, got {tuple(v.shape)}")
        if self.dump_blobs:
            raise ValueError("steps_per_dispatch > 1 is incompatible with "
                             "dump_blobs (stacking K copies of every dumped "
                             "activation)")

    def _load_err(self, comm_error: Dict) -> Dict:
        """The step-owned residual buffers holding ``comm_error`` (a copy
        unless they already are those tensors)."""
        if self._err is None:
            self._err = {l: {p: v.detach().clone() for p, v in lv.items()}
                         for l, lv in comm_error.items()}
            return self._err
        with torch.no_grad():
            for l, lv in self._err.items():
                for p, buf in lv.items():
                    src = comm_error[l][p]
                    if src.data_ptr() != buf.data_ptr():
                        buf.copy_(src)
        return self._err

    def _steps(self, batches: Dict[str, torch.Tensor], it0: int,
               rates: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The K steps over the arena and the residual buffers (updated in
        place); -> their [K]-stacked metrics."""
        rows = []
        for i in range(self.steps_per_dispatch):
            new_err, m = self._run(self._step_batch(batches, i), it0 + i,
                                   self._err,
                                   None if rates is None else rates[i])
            if self.topk_slots:
                with torch.no_grad():
                    for l, lv in self._err.items():
                        for p, buf in lv.items():
                            buf.copy_(new_err[l][p])
            rows.append(m)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def multi_step(self, params, state: TrainState,
                   batches: Dict[str, torch.Tensor]):
        """-> (params, state, metrics): ``steps_per_dispatch`` K optimizer
        steps in one dispatch (the module docstring), metrics stacked [K].
        ``batches`` has the leading ``[K]`` axis (and ``[iter_size]``
        after it), none under ``reuse_batch``."""
        self._check_stack(batches)
        with torch.no_grad():
            self.arena.pack(params, self.flat_w)
            self.arena.pack(state.solver.history, self.flat_h)
        self._load_err(state.comm_error)
        it0 = int(state.solver.it)
        if self.flat_w.device.type == "cuda":
            metrics = self._graph_dispatch(batches, it0)
        else:
            metrics = self._steps(batches, it0, None)
        new_state = TrainState(
            solver=SolverState(it=it0 + self.steps_per_dispatch,
                               history=self.arena.unpack(self.flat_h)),
            comm_error=self._err)
        return self.params(), new_state, metrics

    def _graph_dispatch(self, batches: Dict[str, torch.Tensor],
                        it0: int) -> Dict[str, torch.Tensor]:
        """The card's K-step dispatch: warm up and capture at the first
        dispatch of a batch shape, replay after it."""
        rates = learning_rates(self.sp, it0, self.steps_per_dispatch)
        key = tuple((t, tuple(v.shape), v.dtype)
                    for t, v in sorted(batches.items()))
        cap = self._captured
        if cap is None or cap.key != key:
            return self._warm_up_and_capture(key, batches, it0, rates)
        with torch.no_grad():
            for t, v in batches.items():
                cap.inputs[t].copy_(v, non_blocking=True)
            cap.rates.copy_(rates.pin_memory(), non_blocking=True)
        if cap.slots:
            # each remat'ed dropout's slot at the offset its forward draws
            # from in this replay (core/remat.RematRng)
            gen = self.net.generator
            base, seed = gen.get_offset(), gen.initial_seed()
            for slot, rel in zip(cap.slots, cap.offsets):
                slot.manual_seed(seed)
                slot.set_offset(base + rel)
        cap.graph.replay()
        self.replays += 1
        with torch.no_grad():
            return {k: v.clone() for k, v in cap.metrics.items()}

    def _warm_up_and_capture(self, key: tuple,
                             batches: Dict[str, torch.Tensor], it0: int,
                             rates: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Run this dispatch's K steps eagerly on a side stream, then
        capture the same K steps (executing nothing) into a graph that
        reads ``inputs`` and ``rates``; -> the eager steps' metrics."""
        dev = self.flat_w.device
        self._captured = None
        inputs = {t: v.to(dev, copy=True).contiguous()
                  for t, v in batches.items()}
        rate_buf = rates.to(dev)
        rng, gen = self.net.remat_rng, self.net.generator
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        rng.log = [] if self.remat else None
        base = gen.get_offset()
        try:
            with torch.cuda.stream(side):
                eager = self._steps(inputs, it0, rate_buf)
            offsets = [o - base for o in (rng.log or [])]
        finally:
            rng.log = None
        graph = torch.cuda.CUDAGraph()
        for g in net_generators(self.net):
            graph.register_generator_state(g)
        slots = [gen.clone_state() for _ in offsets]
        for slot in slots:
            graph.register_generator_state(slot)
        before = _build.launch_counts()
        rng.begin_capture(slots)
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                outs = self._steps(inputs, it0, rate_buf)
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.steps_per_dispatch} train steps into a "
                f"CUDA graph failed ({type(e).__name__}: {e}); "
                f"steps_per_dispatch 1 runs them eagerly") from e
        finally:
            used = rng.end_capture()
        if used != len(slots):
            raise RuntimeError(f"the capture took {used} remat'ed dropout "
                               f"slots, the warm-up drew {len(slots)}")
        after = _build.launch_counts()
        cur.wait_stream(side)
        for v in eager.values():
            v.record_stream(cur)
        self._captured = _Captured(
            key=key, graph=graph, inputs=inputs, rates=rate_buf,
            metrics=outs, slots=slots, offsets=offsets,
            launches={k: after[k] - before[k] for k in after
                      if after[k] != before[k]})
        return eager


def build_train_step(net: Net, sp: SolverParameter,
                     group: Optional[DataGroup] = None,
                     comm: Optional[CommConfig] = None,
                     input_transform: Optional[Callable] = None,
                     plan=None, sharded_state: bool = False,
                     steps_per_dispatch: int = 1, reuse_batch: bool = False,
                     remat_plan=None):
    """The train step: ``TrainStep`` on one device or over a data group;
    with an active ``plan`` (``spmd.ShardingPlan``, ``train --mesh``) the
    SPMD step over the group's named mesh (``spmd.SpmdTrainStep``, which
    takes no K-step dispatch: the engine runs single steps under a mesh,
    as JAX's)."""
    if plan is not None and plan.active:
        if steps_per_dispatch > 1:
            raise ValueError("steps_per_dispatch > 1 does not compose with "
                             "an SPMD plan: the engine runs single steps "
                             "under --mesh")
        from .spmd import SpmdTrainStep
        return SpmdTrainStep(net, sp, group, plan, comm, input_transform,
                             sharded_state=sharded_state,
                             remat_plan=remat_plan)
    if sharded_state:
        raise ValueError("sharded_state needs an fsdp plan (--mesh)")
    return TrainStep(net, sp, group, comm, input_transform,
                     steps_per_dispatch, reuse_batch, remat_plan)


def build_eval_step(net: Net, group: Optional[DataGroup] = None,
                    plan=None) -> Callable:
    """Test-phase forward: eval(params, batch) -> {loss, scalar outputs}
    as 0-d device tensors, averaged over the ranks. With an active
    ``plan`` the batch shards over (data, fsdp) and tp replicas evaluate
    redundantly on canonical params: the mean is over the joint group."""
    if plan is not None and plan.active:
        group = group.mesh.joint

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
                 input_transform: Optional[Callable] = None,
                 plan=None):
        if max(1, int(sp.iter_size)) > 1:
            raise ValueError(iter_size_refusal("the SSP step",
                                               "SSP staleness"))
        comm = comm or CommConfig()
        comm.validate()
        if staleness < 1:
            raise ValueError(f"SSP needs staleness >= 1, got {staleness}")
        self.mesh = None
        if plan is not None and plan.active:
            if plan.mesh_cfg.tp > 1:
                raise ValueError(
                    "SSP staleness does not compose with tensor "
                    "parallelism: tp layers exchange activations every "
                    "step, which a local-step tier has no slot for; use "
                    "--mesh dpN,fsdpN")
            if comm.dcn_axis is not None:
                raise ValueError("--mesh and --dcn_slices do not compose")
            if comm.server_logic == "adarevision":
                raise ValueError(
                    "server_logic='adarevision' consumes per-leaf raw "
                    "gradient sums and does not compose with the fsdp-"
                    "sharded delta exchange")
            if group is None or group.mesh is None:
                raise ValueError("an SSP plan needs the named mesh's groups "
                                 "(init_distributed(mesh_cfg=...))")
            self.mesh = group.mesh
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
        # on an fsdp mesh the DENSE deltas go through JAX's fsdp-aligned
        # arena (DENSE layers only): reduce-scatter over fsdp, all-reduce
        # over data, all-gather back, bucket by bucket; the delta buckets
        # then leave DENSE out
        self.fsdp_layout = None
        if self.mesh is not None and self.comm.param_arena:
            dense_layers = frozenset(l for l in net.param_defs
                                     if self.comm.strategy_for(l) == DENSE)
            if dense_layers:
                self.fsdp_layout = net.arena_layout(
                    self.comm.bucket_mb, align=self.mesh.cfg.fsdp,
                    layers=dense_layers)
                slot_of = {(s.layer, s.pname): s for s in self.arena.slots}
                self._dense_slots = [slot_of[(s.layer, s.pname)]
                                     for s in self.fsdp_layout.slots]
        apart = ((LOCAL, TOPK, DENSE) if self.fsdp_layout is not None
                 else (LOCAL, TOPK))
        dense = lambda s: slot_kind[s] not in apart  # noqa: E731
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

    def export(self, params, state: SSPState):
        """(anchor, stacked state) for a snapshot. A collective."""
        return params, self.gather_state(state)

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

    def _fsdp_delta_exchange(self, scale: float) -> None:
        """The DENSE deltas in the fsdp-aligned layout's order, each bucket
        reduce-scattered over fsdp, its shard all-reduced over data and
        all-gathered back (JAX's ``delta_{rs,ar,ag}_bucket<i>``), then
        folded into the anchor: the same sums, the slow tier's bytes split
        by the fsdp size."""
        from .spmd import CENSUS
        lay, mesh = self.fsdp_layout, self.mesh
        f = mesh.cfg.fsdp
        wd = self.comm.wire_torch_dtype()
        delta = self.flat_w.new_zeros(lay.padded_total)
        for ls, ps in zip(lay.slots, self._dense_slots):
            torch.sub(self.flat_w[ps.offset:ps.offset + ps.size],
                      self.flat_a[ps.offset:ps.offset + ps.size],
                      out=delta[ls.offset:ls.offset + ls.size])
        wire = delta if wd is None else delta.to(wd)
        summed = torch.empty_like(wire)
        for i, (lo, hi) in enumerate(lay.bucket_ranges):
            sh = wire.new_empty((hi - lo) // f)
            with CENSUS.collective(f"delta_rs_bucket{i}", "reduce_scatter",
                                   "fsdp", sh.numel()):
                mesh.fsdp.reduce_scatter_(sh, wire[lo:hi])
            if mesh.cfg.data > 1:
                with CENSUS.collective(f"delta_ar_bucket{i}", "all_reduce",
                                       "data", sh.numel()):
                    mesh.data.all_reduce_(sh)
            with CENSUS.collective(f"delta_ag_bucket{i}", "all_gather",
                                   "fsdp", hi - lo):
                mesh.fsdp.all_gather_into(summed[lo:hi], sh)
        summed = summed.float()
        if scale != 1.0:
            summed = scale * summed
        for ls, ps in zip(lay.slots, self._dense_slots):
            self.flat_a[ps.offset:ps.offset + ps.size] += \
                summed[ls.offset:ls.offset + ls.size]

    def _boundary(self, state_err: Dict, it: int) -> Dict:
        """Fold the groups' deltas into the anchor and restart every group
        from it; returns the new TOPK residual rows."""
        cfg = self.comm
        scale = 1.0 / self.n_groups if cfg.reduce == "mean" else 1.0
        out = dict(state_err)
        if self.adarev:
            self._adarev_fold()
        else:
            if self.fsdp_layout is not None:
                self._fsdp_delta_exchange(scale)
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
                         input_transform: Optional[Callable] = None,
                         plan=None) -> SSPTrainStep:
    return SSPTrainStep(net, sp, staleness, group, comm, input_transform,
                        plan)
