"""Rematerialization: the transformer family's checkpoint policies and the
measured per-layer HBM planner of the CNN nets (the port of
``poseidon_tpu/core/remat.py``), on ``torch.utils.checkpoint``.

A checkpointed block keeps fewer of its forward activations for the
backward pass and recomputes the rest there: device memory drops from
O(layers x S x D) stored activations to about one block's worth, for about
one more forward pass of work. The policy names are the JAX package's:

- ``none``: no checkpoint, every block's internals are stored;
- ``dots_saveable``: checkpoint the block but keep the matrix products'
  results (``aten.mm``/``addmm``/``bmm``, through a selective-checkpoint
  context), recomputing the elementwise tissue between them;
- ``nothing_saveable``: keep only each block's inputs (the legacy
  ``remat=True``);
- ``auto``: follow a plan row (``resolve_lm_policy``).

Remat moves when activations are computed, never what: the recomputed
forward replays the same operations on the same inputs, so the loss is
bitwise equal across policies and the gradients equal to within the
summation orders of a recomputed graph. A custom autograd Function such as
flash attention is not a matrix product, so every checkpointing policy
recomputes it in the backward pass (its kernel launches again).

The planner (``RematPlan``, ``remat_candidates``, ``plan_remat``) makes
JAX's decisions: the ``act_bytes`` column of
``runtime/attribution.layer_cost_table`` priced against each layer's
forward FLOPs, a greedy cheapest-recompute-per-byte knapsack run until
the no-remat step's peak fits the budget. The measured side is the
card's: ``measured_peak_bytes`` runs one no-remat forward and backward on
copies of the parameters and reads the CUDA allocator's peak (0 on the
CPU, where the plan's source is then ``analytic``, as in JAX), and
``default_budget_bytes`` reads ``torch.cuda.mem_get_info``. The plan's
layers ride ``Net.apply(remat=)``: each one's forward body runs under a
non-reentrant ``torch.utils.checkpoint``, and a checkpointed DROPOUT
replays its forward's generator state in the recomputation
(``RematRng``), so remat arms stay bitwise equal to stored arms.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("none", "dots_saveable", "nothing_saveable", "auto")

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)


def normalize_policy(value) -> str:
    """Fold the legacy bool flag and the enum spellings into one policy
    name: ``True`` is ``nothing_saveable`` (a bare checkpoint saves
    nothing), ``False``/``None``/``""`` are ``none``."""
    if value is None or value is False or value == "":
        return "none"
    if value is True:
        return "nothing_saveable"
    v = str(value).lower()
    if v not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {value!r}; choose from {REMAT_POLICIES}")
    return v


def resolve_lm_policy(cfg_remat, plan_policy=None) -> str:
    """The effective policy from the config flag and an (optional) plan
    row, refusing on disagreement, exactly as the JAX package resolves it.

    ``False`` (the dataclass default) is unset: a plan may enable remat
    under it. ``True`` and the string spellings are explicit: one that
    contradicts a concrete plan value raises. ``auto`` (either side) defers
    to the other; when both defer, ``dots_saveable`` applies."""
    plan = normalize_policy(plan_policy) if plan_policy is not None \
        else None
    explicit = cfg_remat is not None and cfg_remat is not False \
        and cfg_remat != ""
    cfg = normalize_policy(cfg_remat)
    if cfg == "auto":
        explicit = False
        cfg = "dots_saveable" if plan is None else plan
    if plan is None or plan == "auto":
        return "dots_saveable" if (plan == "auto" and not explicit) else cfg
    if explicit and cfg != plan:
        raise ValueError(
            f"remat policy conflict: config says {cfg!r} but the plan "
            f"says {plan!r} — drop the explicit flag (or set remat="
            f"'auto') to follow the plan, or retire the plan row")
    return plan if not explicit else cfg


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_policy(name: str):
    """The selective-checkpoint policy function of one enum member (None for
    ``nothing_saveable``: a plain checkpoint)."""
    name = normalize_policy(name)
    if name in ("none", "auto"):
        raise ValueError(f"policy {name!r} does not name a checkpoint "
                         f"policy; resolve it first")
    return _save_dots if name == "dots_saveable" else None


def wrap_checkpoint(fn, policy_name: str):
    """``fn`` wrapped in a non-reentrant ``torch.utils.checkpoint`` under
    ``policy_name`` (identity for ``none``)."""
    policy_name = normalize_policy(policy_name)
    if policy_name == "none":
        return fn
    pol = checkpoint_policy(policy_name)
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    pol) if pol is not None else None)

    @functools.wraps(fn)
    def wrapped(*args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class RematPlan:
    """One resolved remat decision, made when the step is built.

    ``layers`` names the net's layers whose forward bodies ``Net.apply``
    checkpoints; ``lm_policy`` is the transformer family's block policy
    riding the same plan. The byte and FLOP fields record what the
    knapsack claimed, so stats.yaml can say why these layers were
    chosen."""

    budget_bytes: int = 0               # the target (0 = no budget given)
    measured_peak_bytes: int = 0        # the no-remat step's peak (0 = n/a)
    layers: Tuple[str, ...] = ()
    saved_bytes: int = 0                # analytic activation bytes dropped
    recompute_flops: float = 0.0        # analytic forward FLOPs re-paid
    lm_policy: str = "none"
    source: str = "analytic"            # analytic | measured | plan | flag

    @property
    def layer_set(self) -> frozenset:
        return frozenset(self.layers)

    @property
    def active(self) -> bool:
        return bool(self.layers) or self.lm_policy != "none"

    def describe(self) -> str:
        if not self.active:
            return "remat: off (fits the budget)"
        mb = self.saved_bytes / 2**20
        return (f"remat[{self.source}]: {len(self.layers)} layers, "
                f"~{mb:.1f} MiB reclaimed, "
                f"{self.recompute_flops / 1e6:.1f} MFLOP recompute"
                + (f", lm={self.lm_policy}"
                   if self.lm_policy != "none" else ""))

    def to_doc(self) -> Dict:
        return {"budget_bytes": int(self.budget_bytes),
                "measured_peak_bytes": int(self.measured_peak_bytes),
                "layers": list(self.layers),
                "saved_bytes": int(self.saved_bytes),
                "recompute_flops": float(self.recompute_flops),
                "lm_policy": self.lm_policy,
                "source": self.source}

    @classmethod
    def from_doc(cls, doc: Dict) -> "RematPlan":
        return cls(budget_bytes=int(doc.get("budget_bytes", 0)),
                   measured_peak_bytes=int(doc.get("measured_peak_bytes",
                                                   0)),
                   layers=tuple(doc.get("layers", ())),
                   saved_bytes=int(doc.get("saved_bytes", 0)),
                   recompute_flops=float(doc.get("recompute_flops", 0.0)),
                   lm_policy=normalize_policy(doc.get("lm_policy",
                                                      "none")),
                   source=str(doc.get("source", "plan")))


def remat_candidates(net) -> List[str]:
    """The layers per-layer checkpointing may take: those that consume
    bottoms (a data source has nothing to recompute from) and produce a
    top. Loss heads stay eligible, but their scalar tops price at ~0
    bytes, so the knapsack never spends a pick on them."""
    return [layer.name for layer in net.layers
            if layer.lp.bottom and layer.lp.top]


def plan_remat(cost_table: Dict[str, Dict], budget_bytes: int,
               peak_bytes: int,
               candidates: Optional[Sequence[str]] = None,
               lm_policy: str = "none",
               source: str = "analytic") -> RematPlan:
    """The greedy cheapest-recompute-per-byte knapsack (JAX's).

    ``cost_table`` is ``attribution.layer_cost_table(net)`` (its
    ``act_bytes`` and ``flops`` columns); ``peak_bytes`` is the no-remat
    step's peak (``measured_peak_bytes``, else the analytic activation
    total). Layers drop, cheapest forward recompute per reclaimed byte
    first, name breaking ties, until the deficit ``peak_bytes -
    budget_bytes`` is covered or every candidate is spent.

    ``budget_bytes <= 0`` means maximal remat (every candidate drops); a
    budget at or above the peak is the identity plan; a lower budget
    chooses a superset of a higher one's layers (the order is fixed)."""
    rows = []
    names = list(candidates) if candidates is not None \
        else list(cost_table)
    for name in names:
        row = cost_table.get(name)
        if not row:
            continue
        act = int(row.get("act_bytes", 0))
        if act <= 0:
            continue
        fwd_flops = float(row.get("flops", 0.0)) / 3.0   # table is 3x fwd
        rows.append((fwd_flops / act, name, act, fwd_flops))
    # the fixed order: every rank of a mesh must plan identically
    rows.sort(key=lambda r: (r[0], r[1]))
    deficit = (float("inf") if budget_bytes <= 0
               else int(peak_bytes) - int(budget_bytes))
    chosen: List[str] = []
    saved = 0
    flops = 0.0
    for _, name, act, fwd in rows:
        if saved >= deficit:
            break
        chosen.append(name)
        saved += act
        flops += fwd
    return RematPlan(budget_bytes=max(0, int(budget_bytes)),
                     measured_peak_bytes=int(peak_bytes),
                     layers=tuple(chosen), saved_bytes=saved,
                     recompute_flops=flops,
                     lm_policy=normalize_policy(lm_policy), source=source)


# --------------------------------------------------------------------------- #
# the measured side
# --------------------------------------------------------------------------- #

def net_generators(net) -> List[torch.Generator]:
    """Every generator the net's forward draws from: the dropout
    generator and each DUMMY_DATA layer's."""
    return [net.generator] + [l.generator for l in net.layers
                              if l.TYPE == "DUMMY_DATA"]


def measured_peak_bytes(net, params, batch: Dict[str, torch.Tensor],
                        input_transform=None) -> int:
    """The peak bytes the CUDA allocator holds over one no-remat TRAIN
    forward and backward of ``net`` on ``batch``, run on copies of
    ``params`` (nothing of the caller's changes: the net's generators are
    put back where they were, so a run planned as identity stays bitwise
    to one without the planner). 0 on the CPU, which has no allocator
    peak to read."""
    device = net.device
    if device.type != "cuda":
        return 0
    gens = net_generators(net)
    states = [g.get_state() for g in gens]
    leaves = {l: {k: v.detach().clone().requires_grad_(True)
                  for k, v in lp.items()} for l, lp in params.items()}
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        if input_transform is not None:
            batch = input_transform(batch)
        out = net.apply(leaves, batch, train=True)
        out.loss.backward()
        del out
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    finally:
        for g, st in zip(gens, states):
            g.set_state(st)


def default_budget_bytes(device=None, reserve_bytes: int = 0) -> int:
    """The default ``--hbm_budget_gb``: the memory this process may hold
    on ``device`` (what the card has free plus what PyTorch's allocator
    already holds, ``torch.cuda.mem_get_info`` and ``memory_reserved``)
    minus ``reserve_bytes``. 0 off the card (the CPU publishes no memory
    limit): callers then pass an explicit budget."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0
    free, _total = torch.cuda.mem_get_info(device)
    limit = int(free) + int(torch.cuda.memory_reserved(device))
    return max(0, limit - int(reserve_bytes))


def plan_for_net_step(net, params, batch: Dict[str, torch.Tensor],
                      budget_bytes: int, lm_policy: str = "none",
                      input_transform=None, agree=None) -> RematPlan:
    """A measured plan for the no-remat step of ``net``: its peak read
    from one forward and backward on ``batch`` (``measured_peak_bytes``;
    ``agree`` maps it to the peak every rank plans from), then the
    knapsack over the analytic activation column. Where nothing can be
    measured (the CPU) the analytic activation total stands in for the
    peak, so a budget still gives a plan (source ``analytic``)."""
    from ..runtime.attribution import layer_cost_table
    peak = measured_peak_bytes(net, params, batch, input_transform)
    if agree is not None:
        peak = agree(peak)
    table = layer_cost_table(net)
    if peak <= 0:
        peak = int(sum(r.get("act_bytes", 0) for r in table.values()))
        source = "analytic"
    else:
        source = "measured"
    return plan_remat(table, budget_bytes, peak,
                      candidates=remat_candidates(net),
                      lm_policy=lm_policy, source=source)


# --------------------------------------------------------------------------- #
# a checkpointed random layer's mask
# --------------------------------------------------------------------------- #

def _capturing(gen: torch.Generator) -> bool:
    return gen.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


class RematRng:
    """How a checkpointed DROPOUT draws its forward's mask again in the
    recomputation. ``torch.utils.checkpoint``'s ``preserve_rng_state``
    covers only the default generators; the net's dropout generator is
    its own, so the layer's checkpoint gets this pair of contexts
    (``contexts``, its ``context_fn``):

    - eager (the CPU, or the card outside a capture): the forward notes
      the generator's state; the recomputation sets it, draws, and puts
      back the state it found (the next draws are unchanged);
    - inside a CUDA graph capture, where a state cannot be read or set:
      the forward takes the next of ``slots``, generator states the
      capturing step registered with the graph before the capture and
      places before every replay at the offset this forward's draw had
      in the eager warm-up (``log`` notes those offsets); the
      recomputation draws from that slot through the graph-safe
      ``graphsafe_set_state`` and switches back.

    Nothing else of the layer changes: its forward draws from the
    generator as a stored arm's does."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.log: Optional[List[int]] = None
        self.slots: Optional[List[torch.Generator]] = None
        self._next = 0

    def begin_capture(self, slots: List[torch.Generator]) -> None:
        self.slots, self._next = list(slots), 0

    def end_capture(self) -> int:
        """-> how many slots the capture took."""
        used, self.slots, self._next = self._next, None, 0
        return used

    def contexts(self):
        gen = self.generator
        held: Dict[str, object] = {}

        @contextlib.contextmanager
        def forward():
            if _capturing(gen):
                if self.slots is None or self._next >= len(self.slots):
                    raise RuntimeError(
                        "a checkpointed DROPOUT inside a CUDA graph "
                        "capture needs a generator state registered with "
                        "the graph before the capture (the capturing "
                        "step's slots); none is left")
                held["slot"] = self.slots[self._next]
                self._next += 1
            else:
                held["state"] = gen.get_state()
                if self.log is not None and gen.device.type == "cuda":
                    self.log.append(gen.get_offset())
            yield

        @contextlib.contextmanager
        def recompute():
            if "slot" in held:
                cur = gen.graphsafe_get_state()
                gen.graphsafe_set_state(held["slot"])
                try:
                    yield
                finally:
                    gen.graphsafe_set_state(cur)
                return
            cur = gen.get_state()
            gen.set_state(held["state"])
            try:
                yield
            finally:
                gen.set_state(cur)

        return forward(), recompute()


def checkpoint_layer(fn, args: Sequence[torch.Tensor],
                     rng: Optional[RematRng] = None):
    """``fn(*args)`` under a non-reentrant checkpoint (the default
    generators are not stashed: the net's layers draw from their own);
    a random layer passes its ``RematRng``."""
    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    if rng is not None:
        kwargs["context_fn"] = rng.contexts
    return checkpoint(fn, *args, **kwargs)
