"""Gradient-communication strategies for data-parallel training over
``torch.distributed`` (the port of ``poseidon_tpu/parallel/strategies.py``):
DWBP overlap and SFB, per layer.

**DWBP — distributed wait-free backpropagation** (solver.cpp:405-531: one
sync thread per blob the moment its layer's backward completes). The JAX
package taps each gradient with a ``psum`` inside the backward graph and
chains the taps into buckets so XLA keeps one collective per bucket
(``_chained_sync_tap``, ``chained_bucket_psums``). Here the gradients land
in the flat arena's gradient buffer, and ``BucketSync`` hooks each leaf's
gradient accumulation: the moment a bucket's last leaf has accumulated,
and every bucket before it has been issued, the bucket's range goes out as
an asynchronous ``all_reduce`` while backward goes on. Buckets are DWBP
ordered (bucket 0 holds the last layers, whose gradients exist first).
The step waits on every handle before its update.

Why hooks on per-leaf leaves: views of one flat leaf taken before the
forward get their gradient only after every layer's backward (their view
nodes are older than the layers' nodes, so autograd's ready queue runs
them last), which would issue every bucket at the end of backward: the
torch form of the "degenerate DWBP" the JAX package's chained taps
prevent (every collective merged into one at the end). Leaves that
share the arena's storage, with ``.grad`` preset to views of the flat
gradient buffer, accumulate in place the moment their layer's backward is
done (``register_post_accumulate_grad_hook`` fires then).

**SFB — sufficient-factor broadcasting** (svb_worker.cpp,
inner_product_layer.cpp:126). For an FC layer ∇W = gᵀ·x is rank B:
``SFBMatmul``'s backward all-gathers the factors g (B, M) and x (B, K)
over the ranks and rebuilds the global ∇W locally, moving O(B(M+K))
instead of O(MK). These products are plain GEMMs, as in JAX, where they
run outside any Pallas kernel.

**Managed communication — TOPK with error feedback** (ssp_aggr_*:
bandwidth-budgeted, magnitude-prioritized partial pushes).
``topk_compress`` keeps a ``topk_fraction`` of the entries of
(gradient + residual), chosen by magnitude, at random or in a fixed
rotation (the server's UpdateSortPolicy), globally or per block; the rest
stays in the rank's residual for the next step, so nothing is lost, only
delayed. The step (``parallel/trainer.py``) exchanges the sparsified
tensor densely, as the JAX package does. The selection, gathers and
scatters are library calls here as in JAX, where they run outside any
Pallas kernel.

**The two-tier mesh** (``CommConfig.dcn_axis``, a ``DataGroup`` with
slices): DENSE and SFB ride the whole world, and TOPK is hierarchical: a
dense sum inside each slice (the fast links), then the compressed
exchange between slices, one residual a slice (the SSPAggr shape:
full-rate inside a machine, budgeted bytes across).

**DENSE_FUSED** reduces its buckets after the whole backward (the
no-overlap A/B); **LOCAL** is never synced.

**SSP server logic** (``CommConfig.server_logic``, read by the SSP step
of ``parallel/trainer.py``): ``"inc"`` adds the groups' deltas to the
anchor; ``"adarevision"`` applies each group's raw gradient sum by the
delay-corrected AdaGrad rule with ``adarev_init_step``. The int8 wire is
the async tier's delta format only (``parallel/async_ssp.py``, taken by
``train --async_ssp --wire_dtype int8``): the compiled collectives take
bf16/f16, and ``CommConfig`` refuses int8 as the JAX CLI does.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..numeric import policy
from ..runtime.attribution import scope

DENSE = "dense"      # all-reduce hooked into backward (DWBP) — the default
SFB = "sfb"          # sufficient-factor broadcast for FC layers
LOCAL = "local"      # never synced (the reference's LOCAL blob mode)
TOPK = "topk"        # top-k compressed sync with error feedback
DENSE_FUSED = "dense_fused"   # every bucket after backward (no overlap)
STRATEGIES = (DENSE, SFB, LOCAL, TOPK, DENSE_FUSED)

WIRE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16}
TOPK_POLICIES = ("magnitude", "random", "fixed_order")
SERVER_LOGICS = ("inc", "adarevision")


@dataclass
class CommConfig:
    """Per-layer strategy and wire settings, the JAX fields the port
    covers with the JAX defaults."""
    default_strategy: str = DENSE
    layer_strategies: Dict[str, str] = field(default_factory=dict)
    # "mean": synchronous SGD at the global batch; "sum": the reference's
    # PS accumulation (the rate scales with the world)
    reduce: str = "mean"
    # the share of each TOPK leaf's entries sent a step
    topk_fraction: float = 0.01
    # which entries TOPK sends (the server's UpdateSortPolicy): the
    # largest |g + residual| ("magnitude"), a fresh random subset a step
    # ("random") or contiguous slabs in rotation ("fixed_order")
    topk_policy: str = "magnitude"
    # a per-step budget in MB a device for the TOPK layers (8 bytes an
    # entry sent); when set, it decides the fraction
    # (``budget_topk_fraction``)
    bandwidth_budget_mb: Optional[float] = None
    # magnitude/random TOPK pick the top entries within blocks of this
    # many elements instead of one global selection
    topk_block: Optional[int] = None
    # None, "f32", "bf16" or "f16": gradients (and SFB's factors) cross
    # the wire in this dtype; sums come back to f32, the mean in f32. TOPK
    # folds the rounding of what it sends into its residual
    wire_dtype: Optional[str] = None
    # the size of each bucket of the arena's gradient buffer that goes out
    # as one all-reduce, in MB; <= 0: one bucket a leaf. The JAX package's
    # three knobs (dwbp_bucket_mb, param_arena, arena_bucket_mb) map onto
    # it in ``runtime/cli.py``'s ``bucket_mb_of``
    bucket_mb: float = 4.0
    # the SPMD planner's arena (``parallel/spmd.py``, ``train --mesh``):
    # False leaves every DENSE layer outside the arena, each leaf synced on
    # its own (JAX's --param_arena false); an fsdp mesh then has nothing
    # to shard and refuses. The flat data-parallel step reads
    # ``bucket_mb`` alone
    param_arena: bool = True
    # the two-tier mesh's slow axis (the slices of the step's DataGroup):
    # set, TOPK sums inside each slice and compresses between slices
    dcn_axis: Optional[str] = None
    # the SSP server logic (``build_ssp_train_step``): "inc" adds the
    # deltas to the anchor; "adarevision" is the delay-corrected AdaGrad
    # server rule over each group's raw gradient sum. It ignores
    # ``reduce``: every group's whole sum is applied in turn, so size
    # ``adarev_init_step`` by the group count
    server_logic: str = "inc"
    # the adarevision server's init_step_size (its gflags default)
    adarev_init_step: float = 0.1

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise for a setting the port cannot run (called again by the
        train step: ``layer_strategies`` is filled in after
        construction)."""
        if self.server_logic not in SERVER_LOGICS:
            raise ValueError(f"unknown server_logic {self.server_logic!r}; "
                             f"choose from {SERVER_LOGICS}")
        if self.reduce not in ("mean", "sum"):
            raise ValueError(f"reduce must be 'mean' or 'sum', got "
                             f"{self.reduce!r}")
        if self.topk_policy not in TOPK_POLICIES:
            raise ValueError(f"unknown topk_policy {self.topk_policy!r}; "
                             f"choose from {TOPK_POLICIES}")
        self.wire_torch_dtype()
        for s in (self.default_strategy, *self.layer_strategies.values()):
            if s not in STRATEGIES:
                raise ValueError(f"unknown strategy {s!r}; choose from "
                                 f"{STRATEGIES}")

    def strategy_for(self, layer: str) -> str:
        return self.layer_strategies.get(layer, self.default_strategy)

    def wire_torch_dtype(self) -> Optional[torch.dtype]:
        if self.wire_dtype is None:
            return None
        if self.wire_dtype == "int8":
            raise ValueError(
                "wire_dtype int8 is the async tier's delta format "
                "(train --async_ssp --wire_dtype int8); compiled "
                "collectives take bf16/f16")
        try:
            return WIRE_DTYPES[self.wire_dtype]
        except KeyError:
            raise ValueError(
                f"unknown wire_dtype {self.wire_dtype!r}; choose from "
                f"{sorted(WIRE_DTYPES)}") from None


def comm_salt(layer: str, pname: str) -> int:
    """A stable salt a tensor for the random policy, so that same-shaped
    tensors of different layers draw unrelated subsets."""
    return zlib.crc32(f"{layer}/{pname}".encode())


def _top_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k highest scores of each row (the last dim), ties going to the
    lower index as in ``lax.top_k`` (``torch.topk`` promises no order
    among equal values): every entry above the k-th value, then as many
    entries equal to it as are left, in index order."""
    kth = torch.topk(scores, k, dim=-1, sorted=False).values.amin(
        dim=-1, keepdim=True)
    above = scores > kth
    tied = scores == kth
    room = k - above.sum(dim=-1, keepdim=True, dtype=torch.int32)
    return above | (tied & (torch.cumsum(tied, dim=-1, dtype=torch.int32)
                            <= room))


def _global_select(flat: torch.Tensor, scores: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """``flat`` at its k highest-scoring entries, zero elsewhere."""
    return torch.where(_top_mask(scores, k), flat, 0.0)


def _blocked_select(flat: torch.Tensor, scores: torch.Tensor, k: int,
                    block: int) -> torch.Tensor:
    """``flat`` at the top-scoring entries of each block of ``block``
    elements, k // n_blocks (at least 1) a block, so at most k in all; the
    last block is padded with -inf scores, which never win while a real
    entry is left. Callers take this path only when k >= n_blocks."""
    n = flat.numel()
    nb = -(-n // block)
    kb = max(1, k // nb)
    pad = nb * block - n
    fp = F.pad(flat, (0, pad)).view(nb, block)
    sp = F.pad(scores, (0, pad), value=float("-inf")).view(nb, block)
    return torch.where(_top_mask(sp, kb), fp, 0.0).reshape(-1)[:n]


def _random_scores(n: int, salt: int, step: int, device) -> torch.Tensor:
    """The random policy's scores: uniform [0, 1) from a generator on
    ``device`` seeded from (17 + salt, step), never the global RNG. (JAX
    draws from threefry with the same key parts; torch cannot reproduce
    that stream, so the subsets differ from JAX's, not their law.)"""
    # hashed: the CPU generator keeps only the low 32 bits of a seed
    seed = hashlib.blake2b(f"{17 + salt}/{int(step)}".encode(),
                           digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(seed, "little"))
    return torch.rand(n, generator=gen, device=device)


def topk_compress(g: torch.Tensor, fraction: float, error: torch.Tensor,
                  policy: str = "magnitude", step=None, salt: int = 0,
                  block: Optional[int] = None, wire: Optional[str] = None):
    """Budgeted sparsification with error feedback (JAX's
    ``topk_compress``). Returns (sent, new_error), both of g's shape:
    ``sent`` keeps ``max(1, int(n * fraction))`` entries of g + error
    (fewer under ``block``) and zeroes the rest, which become the new
    error. ``policy`` picks the entries (``step`` is required by random
    and fixed_order); ``block`` switches magnitude and random to a
    selection within blocks when every block gets a slot (k >= the block
    count), else the global selection stays; ``wire`` rounds the sent
    values to the wire dtype, the rounding joining the residual."""
    flat = (g + error).reshape(-1)
    n = flat.numel()
    k = max(1, int(n * fraction))
    use_block = bool(block) and n > block and k >= -(-n // block)
    if policy in ("magnitude", "random"):
        if policy == "magnitude":
            scores = flat.abs()
        elif step is None:
            # a fixed subset every call would strand the rest in the
            # residual for good
            raise ValueError("random policy needs the step counter")
        else:
            scores = _random_scores(n, salt, step, flat.device)
        sent = (_blocked_select(flat, scores, k, block) if use_block
                else _global_select(flat, scores, k))
    elif policy == "fixed_order":
        if step is None:
            raise ValueError("fixed_order policy needs the step counter")
        n_slabs = -(-n // k)     # every entry once in n_slabs steps
        start = (int(step) % n_slabs) * k
        sent = torch.zeros_like(flat)
        sent[start:start + k] = flat[start:start + k]
    else:
        raise ValueError(f"unknown topk_policy {policy!r}")
    wd = WIRE_DTYPES.get(wire) if wire else None
    if wd is not None and sent.dtype != wd:
        sent = sent.to(wd).to(flat.dtype)
    return sent.view(g.shape), (flat - sent).view(g.shape)


def budget_topk_fraction(net, cfg: CommConfig) -> float:
    """The fraction a per-step budget allows: 8 bytes an entry sent
    (index and value), the budget spread over every TOPK layer's
    parameters; ``topk_fraction`` without a budget or a TOPK layer."""
    if cfg.bandwidth_budget_mb is None:
        return cfg.topk_fraction
    total = sum(p.count for lname, defs in net.param_defs.items()
                for p in defs if cfg.strategy_for(lname) == TOPK)
    if total == 0:
        return cfg.topk_fraction
    entries = cfg.bandwidth_budget_mb * 1e6 / 8.0
    return float(min(1.0, max(entries / total, 1e-5)))


def _to_wire(t: torch.Tensor, wd: Optional[torch.dtype]) -> torch.Tensor:
    return t if wd is None or t.dtype == wd else t.to(wd)


def wire_all_reduce(g: torch.Tensor, group, reduce: str,
                    wire: Optional[str]) -> torch.Tensor:
    """All-reduce through an optional reduced-precision wire (JAX's
    ``wire_psum``): cast to the wire dtype, sum over the ranks, back to
    f32, the mean divided by the world in f32, back to g's dtype. Returns
    a new tensor."""
    wd = WIRE_DTYPES.get(wire) if wire else None
    buf = g.to(wd) if wd is not None and g.dtype != wd else g.clone()
    group.all_reduce_(buf)
    s = buf.float()
    if reduce == "mean":
        s = s / group.world
    return s.to(g.dtype)


class SFBMatmul(torch.autograd.Function):
    """FC forward on the local shard, ``x2 @ w.T + b`` with the operands in
    the policy's compute dtype (its output stays in it); the backward keeps
    the input gradient local (compute-dtype operands, f32 accumulation,
    cast to x2's dtype) and rebuilds the global ∇W from the all-gathered
    factors (rank order) as one product of compute-dtype operands
    accumulated in f32 (JAX's ``preferred_element_type=accum_dtype``),
    divided by the world for the mean; the bias gradient goes through
    ``wire_all_reduce``. The wire dtype applies to the factors. ``layer``
    names the three collectives for ``comm.collective`` (the SPMD
    census)."""

    @staticmethod
    def forward(ctx, x2, w, b, comm, layer=None):
        cd = policy().compute_dtype
        ctx.save_for_backward(x2, w)
        ctx.comm = comm
        ctx.layer = layer
        ctx.cd = cd
        ctx.b_dtype = None if b is None else b.dtype
        return F.linear(x2.to(cd), w.to(cd), None if b is None else b.to(cd))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        cfg, group, cd = ctx.comm.cfg, ctx.comm.group, ctx.cd
        acc = policy().accum_dtype
        wd = cfg.wire_torch_dtype()
        # compute-dtype values are exact in f32, so an f32 product of them
        # is the compute-dtype product with f32 accumulation
        gx = (g.to(cd).to(acc).mm(w.to(cd).to(acc)).to(x2.dtype)
              if ctx.needs_input_grad[0] else None)
        n, m, k = g.shape[0] * group.world, g.shape[1], x2.shape[1]
        label = ctx.comm.collective
        with label(f"sfb_gfactor_{ctx.layer}", "all_gather", n * m):
            big_g = group.all_gather(_to_wire(g, wd))       # (B_global, M)
        with label(f"sfb_xfactor_{ctx.layer}", "all_gather", n * k):
            big_x = group.all_gather(_to_wire(x2, wd))      # (B_global, K)
        gw = big_g.to(cd).to(acc).t().mm(big_x.to(cd).to(acc))  # (M, K)
        if cfg.reduce == "mean":
            gw = gw / group.world
        gb = None
        if ctx.b_dtype is not None:
            with label(f"sfb_bias_{ctx.layer}", "all_reduce", m):
                gb = wire_all_reduce(g.sum(0), group, cfg.reduce,
                                     cfg.wire_dtype).to(ctx.b_dtype)
        return gx, gw.to(w.dtype), gb, None, None


class CommContext:
    """Threaded through ``Net.apply``, which runs each layer named in
    ``routed_layers`` (here the SFB layers of ``sync_kinds``) through
    ``layer_product`` in place of the layer's own forward, and asks
    ``is_tp_leaf`` before refusing a leaf of the wrong size."""

    def __init__(self, cfg: CommConfig, group, kinds: Dict[str, str]):
        self.cfg = cfg
        self.group = group
        self.sfb_layers = frozenset(l for l, k in kinds.items() if k == SFB)

    @property
    def routed_layers(self):
        return self.sfb_layers

    def is_tp_leaf(self, layer: str, pname: str) -> bool:
        return False

    def collective(self, name: str, kind: str, elems: int):
        """A context around one collective, named as the JAX package's
        scopes; nothing here (the SPMD context labels and counts it)."""
        return contextlib.nullcontext()

    def layer_product(self, layer: str, x, w, b) -> torch.Tensor:
        return self.inner_product(x, w, b)

    def inner_product(self, x, w, b) -> torch.Tensor:
        """The SFB product of an InnerProduct layer: x (N, ...) flattened
        to (N, K), w (M, K)."""
        return SFBMatmul.apply(x.reshape(x.shape[0], -1), w, b, self, None)


def auto_strategies(net, min_sfb_rank_saving: float = 2.0) -> Dict[str, str]:
    """SACP-style per-layer choice by the cost model: for an FC weight
    (M, K) at batch B, a dense all-reduce moves O(M*K) and SFB O(B*(M+K));
    SFB when M*K > min_sfb_rank_saving * B*(M+K)."""
    out: Dict[str, str] = {}
    for layer in net.layers:
        if layer.TYPE != "INNER_PRODUCT":
            continue
        wdef = next((p for p in layer.params if p.name == "w"), None)
        if wdef is None:
            continue
        m, k = wdef.shape
        batch = net.blob_shapes[layer.lp.bottom[0]][0]
        if m * k > min_sfb_rank_saving * batch * (m + k):
            out[layer.name] = SFB
    return out


def sync_kinds(net, cfg: CommConfig) -> Dict[str, str]:
    """How each param layer's gradient is synced: SFB (factors, FC layers
    only), DENSE (hooked buckets), DENSE_FUSED (buckets after backward) or
    LOCAL. An SFB layer that is no FC layer rides the dense buckets, as
    the JAX package taps it with a dense psum."""
    out = {}
    for layer in net.layers:
        if not layer.params:
            continue
        s = cfg.strategy_for(layer.name)
        if s == SFB and layer.TYPE != "INNER_PRODUCT":
            s = DENSE
        out[layer.name] = s
    return out


@dataclass(frozen=True)
class Bucket:
    lo: int                     # element range of the flat gradient
    hi: int
    leaves: Tuple[int, ...]     # the arena slots overlapping it


def plan_buckets(slots: Sequence, kinds: Dict[str, str], kind: str,
                 bucket_mb: float) -> List[Bucket]:
    """The DWBP-ordered buckets over the slots synced as ``kind``: each
    maximal run of such slots cut at exact ``bucket_mb`` element
    boundaries (leaves may span buckets), or one bucket a slot when
    ``bucket_mb <= 0``."""
    runs: List[List[int]] = []
    prev_end = None
    for i, s in enumerate(slots):
        if kinds.get(s.layer) != kind:
            prev_end = None
            continue
        if prev_end is None or s.offset != prev_end or bucket_mb <= 0:
            runs.append([])
        runs[-1].append(i)
        prev_end = s.offset + s.size
    step = max(1, int(bucket_mb * 1e6) // 4) if bucket_mb > 0 else None
    out: List[Bucket] = []
    for run in runs:
        lo_run = slots[run[0]].offset
        hi_run = slots[run[-1]].offset + slots[run[-1]].size
        cuts = ([(lo_run, hi_run)] if step is None else
                [(lo, min(lo + step, hi_run))
                 for lo in range(lo_run, hi_run, step)])
        for lo, hi in cuts:
            out.append(Bucket(lo, hi, tuple(
                i for i in run if slots[i].offset < hi
                and slots[i].offset + slots[i].size > lo)))
    return out


class BucketSync:
    """The DWBP bucketed gradient sync over the flat gradient buffer.

    ``begin`` before the forward; the leaves' accumulation hooks issue the
    hooked (DENSE) buckets, in order, during backward; ``finish`` after
    backward issues any bucket a missing gradient left unready and the
    DENSE_FUSED buckets, then waits on every handle (in issue order) and
    brings each range back to f32 and to the mean.

    ``issued`` lists the hooked buckets in issue order and
    ``issued_mid_backward`` counts those issued while other leaves still
    waited for their gradient. A shared (named) param is one leaf read by
    every sharer layer: autograd sums the sharers' gradients before the
    leaf's one accumulation, so its bucket goes out after all of them.

    ``accumulate`` (gradient accumulation, ``iter_size`` > 1: several
    backward passes before one sync) registers no hook: ``finish`` issues
    every DENSE bucket once, after the last backward, then the DENSE_FUSED
    buckets and one bucket a leaf of the SFB layers (JAX's dense
    post-accumulation psum per leaf)."""

    def __init__(self, group, cfg: CommConfig, slots: Sequence,
                 kinds: Dict[str, str], leaves: Sequence[torch.Tensor],
                 flat_g: torch.Tensor,
                 hooked: Optional[List[Bucket]] = None,
                 accumulate: bool = False):
        self.group = group
        self.cfg = cfg
        self.flat_g = flat_g
        self.wire = cfg.wire_torch_dtype()
        # the hooked buckets: the DENSE runs cut at bucket_mb, unless the
        # caller's layout fixes them (the SPMD step's aligned arena)
        self.hooked = (plan_buckets(slots, kinds, DENSE, cfg.bucket_mb)
                       if hooked is None else hooked)
        self.fused = plan_buckets(slots, kinds, DENSE_FUSED, cfg.bucket_mb)
        if accumulate:
            self.fused += plan_buckets(slots, kinds, SFB, 0.0)
        self._of_leaf: Dict[int, List[int]] = {}
        for b, bucket in enumerate(self.hooked):
            for i in bucket.leaves:
                self._of_leaf.setdefault(i, []).append(b)
        if not accumulate:
            for i in self._of_leaf:
                leaves[i].register_post_accumulate_grad_hook(
                    functools.partial(self._accumulated, i))
        self.issued: List[int] = []
        self.issued_mid_backward = 0
        self._pending: List = []
        self._left: List[int] = []
        self._next = 0
        self._leaves_left = 0

    def begin(self) -> None:
        self._left = [len(b.leaves) for b in self.hooked]
        self._leaves_left = len(self._of_leaf)
        self._next = 0
        self._pending = []
        self.issued = []
        self.issued_mid_backward = 0

    def _accumulated(self, i: int, _leaf) -> None:
        # runs on autograd's thread, right after leaf i's gradient landed
        self._leaves_left -= 1
        for b in self._of_leaf[i]:
            self._left[b] -= 1
        while self._next < len(self.hooked) and self._left[self._next] == 0:
            if self._leaves_left > 0:
                self.issued_mid_backward += 1
            self._issue_hooked()

    def _issue_hooked(self) -> None:
        self._issue(self.hooked[self._next])
        self.issued.append(self._next)
        self._next += 1

    def _issue(self, bucket: Bucket) -> None:
        with scope("grad_sync"):
            view = self.flat_g[bucket.lo:bucket.hi]
            buf = _to_wire(view, self.wire)
            self._pending.append((view, buf, self.group.all_reduce_(
                buf, async_op=True)))

    def finish(self) -> None:
        while self._next < len(self.hooked):
            self._issue_hooked()
        for bucket in self.fused:
            self._issue(bucket)
        with scope("grad_sync"):
            for view, buf, work in self._pending:
                if work is not None:
                    work.wait()
                if buf is not view:
                    view.copy_(buf)
                if self.cfg.reduce == "mean":
                    view.div_(self.group.world)
        self._pending = []
