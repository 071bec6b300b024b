"""The plain train-step reference and the comparison that decides
``correct``.

The reference imports nothing of the program. It works out again what
the program derived from the benchmark's inputs:

- the weights: the benchmark draws them from the seed (``make_weights``,
  the prototxt's fillers on a generator of the card, a few large calls)
  and hands the same tensors to the program (as ``train --weights``
  does) and to the reference;
- each step's rows, crops and mirrors: the program's data contract, as
  documented in its ``data/pipeline.py`` and ``native/
  poseidon_dataplane.cc`` (``crop_plan``): record order by
  ``numpy.random.RandomState(epoch).permutation``, the batch seed
  ``pipeline_seed * 1_000_003 + batch_no``, each record's splitmix64
  draws for the crop offsets and the flip, the mean file read at the
  source crop position;
- the dropout masks: one generator of the card seeded with the solver's
  ``random_seed``, drawn in layer order (``refnet.RefNet.forward``);
- the SGD update: Caffe's momentum rule with L2 decay and each leaf's
  ``lr_mult`` and ``decay_mult``, at the solver's learning-rate policy.

The comparison (``compare``) takes, at each checkpoint, the norms of the
program's and the reference's leaves and reads the worst leaf's gap
against the larger of that leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .refnet import ParamSpec, RefNet

Tree = Dict[str, Dict[str, torch.Tensor]]
M64 = (1 << 64) - 1
# leaves whose first reference gradient is under this share of the median
# leaf's move by round-off alone (PERF.md)
STILL_LEAF = 1e-3


# ---------------------------------------------------------------- weights
def make_weights(specs: Sequence[ParamSpec], seed: int, device) -> Tree:
    """Every leaf from its filler (gaussian, xavier or constant), drawn on
    ``device`` from ``seed``: one normal draw for all gaussian leaves and
    one uniform draw for all xavier leaves, sliced in prototxt order."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kinds = {"gaussian": [], "unit": []}
    for s in specs:
        t = str(s.filler.get("type", "constant"))
        if t == "gaussian":
            kinds["gaussian"].append(s)
        elif t == "xavier":
            kinds["unit"].append(s)
        elif t != "constant":
            raise ValueError(f"filler {t!r} of {s.layer}.{s.name} is not "
                             f"covered")
    draws = {}
    for kind, fn in (("gaussian", torch.randn), ("unit", torch.rand)):
        total = sum(math.prod(s.shape) for s in kinds[kind])
        flat = fn(total, generator=gen, device=device) if total else None
        off = 0
        for s in kinds[kind]:
            n = math.prod(s.shape)
            draws[(s.layer, s.name)] = flat[off:off + n].view(s.shape)
            off += n
    out: Tree = {}
    for s in specs:
        f = s.filler
        t = str(f.get("type", "constant"))
        if t == "gaussian":
            v = float(f.get("mean", 0.0)) + float(f.get("std", 1.0)) * \
                draws[(s.layer, s.name)]
        elif t == "xavier":
            scale = math.sqrt(3.0 / s.fan_in)
            v = draws[(s.layer, s.name)] * (2.0 * scale) - scale
        else:
            v = torch.full(s.shape, float(f.get("value", 0.0)),
                           device=device)
        out.setdefault(s.layer, {})[s.name] = v.contiguous()
    return out


# ---------------------------------------------------------------- inputs
def _mix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def shard_range(n: int, index: int, count: int) -> Tuple[int, int]:
    """The contiguous slice of an epoch's order that shard ``index`` of
    ``count`` reads (the first ``n % count`` shards one record more)."""
    base, extra = divmod(n, count)
    begin = index * base + min(index, extra)
    return begin, begin + base + (1 if index < extra else 0)


def crop_plan(n_records: int, batch: int, batch_no: int, crop: int,
              height: int, width: int, mirror: bool, shard=(0, 1),
              pipeline_seed: int = 0):
    """Batch ``batch_no`` of a TRAIN pipeline: its record indices, crop
    offsets and flips, as the program's data contract draws them."""
    lo, hi = shard_range(n_records, *shard)
    per_epoch = hi - lo
    idx = []
    for k in range(batch_no * batch, (batch_no + 1) * batch):
        epoch, pos = divmod(k, per_epoch)
        perm = np.random.RandomState(pipeline_seed + epoch).permutation(
            n_records)
        idx.append(int(perm[lo + pos]))
    bseed = (pipeline_seed * 1_000_003 + batch_no) & M64
    hoff, woff, flip = [], [], []
    for i in idx:
        s = _mix(bseed ^ i)
        r = _mix(s)
        hoff.append(r % (height - crop + 1))
        woff.append(_mix(r) % (width - crop + 1))
        flip.append(bool(mirror and (_mix(s ^ 0xABCD) & 1)))
    return idx, hoff, woff, flip


def make_batch(images: np.ndarray, labels: np.ndarray, plan, crop: int,
               device, mean_file: Optional[np.ndarray] = None,
               mean_values: Optional[Sequence[float]] = None,
               scale: float = 1.0):
    """The f32 batch and labels of ``plan``: each record cropped, less the
    mean (the file's at the source position, or per channel), times the
    scale, then flipped."""
    idx, hoff, woff, flip = plan
    rows = []
    for i, h, w, f in zip(idx, hoff, woff, flip):
        x = torch.from_numpy(images[i, :, h:h + crop, w:w + crop]).to(
            device).float()
        if mean_file is not None:
            x = x - torch.from_numpy(
                mean_file[:, h:h + crop, w:w + crop]).to(device)
        elif mean_values is not None:
            x = x - torch.tensor(list(mean_values), dtype=torch.float32,
                                 device=device).view(-1, 1, 1)
        if scale != 1.0:
            x = x * scale
        if f:
            x = x.flip(-1)
        rows.append(x)
    y = torch.from_numpy(labels[np.asarray(idx)]).to(device)
    return torch.stack(rows), y


# ---------------------------------------------------------------- solver
def learning_rate(solver: Dict, it: int) -> float:
    """The solver's rate at iteration ``it``, computed in f32."""
    f32 = torch.float32
    itf = torch.tensor(float(it), dtype=f32)
    base = torch.tensor(float(solver["base_lr"]), dtype=f32)
    policy = solver.get("lr_policy")
    if policy == "step":
        rate = base * torch.pow(torch.tensor(float(solver["gamma"]),
                                             dtype=f32),
                                torch.floor(itf / float(solver["stepsize"])))
    elif policy == "poly":
        rate = base * torch.pow(1.0 - itf / float(solver["max_iter"]),
                                float(solver["power"]))
    else:
        raise ValueError(f"lr_policy {policy!r} is not covered")
    return float(rate)


# ---------------------------------------------------------------- steps
def reference_steps(net: RefNet, weights: Tree, batches: Callable,
                    solver: Dict, dropout_seeds: Sequence[int], steps: int,
                    checkpoints: Sequence[int], device,
                    quant: Optional[Callable] = None,
                    half_batch: bool = False, frozen: bool = False,
                    local: bool = False):
    """``steps`` synchronous SGD steps of the plain net from ``weights``
    over the ranks that ``dropout_seeds`` seed: ``batches(i)`` gives step
    i's (data, labels) of each rank; the step's loss and gradient are the
    ranks' mean. -> (losses, {checkpoint: (w, h)}) with the trees on the
    host. The planted faults: ``half_batch``, a step that leaves out half
    of each batch and means over the rest; ``frozen``, a step that returns
    its state unchanged; ``local``, a step whose ranks exchange nothing
    (rank 0 updates with its own gradient)."""
    if solver.get("regularization_type", "L2") != "L2":
        raise ValueError("the reference covers L2 weight decay only")
    specs = net.param_specs()
    w = {s.layer: {} for s in specs}
    h = {s.layer: {} for s in specs}
    for s in specs:
        w[s.layer][s.name] = weights[s.layer][s.name].detach().clone()
        h[s.layer][s.name] = torch.zeros_like(w[s.layer][s.name])
    gens = [torch.Generator(device=device).manual_seed(int(d))
            for d in dropout_seeds]
    momentum = float(solver.get("momentum", 0.0))
    wd = float(solver.get("weight_decay", 0.0))
    losses: List[float] = []
    saved = {}
    for it in range(steps):
        rank_loss, grads = 0.0, None
        rows = batches(it)
        for r, (data, labels) in enumerate(rows):
            if half_batch:
                keep = data.shape[0] // 2
                data, labels = data[:keep], labels[:keep]
            leaves = {l: {n: v.detach().requires_grad_(True)
                          for n, v in d.items()} for l, d in w.items()}
            loss = net.forward(leaves, data, labels, gens[r], quant)
            g = torch.autograd.grad(
                loss, [leaves[s.layer][s.name] for s in specs])
            if r == 0 or not local:
                rank_loss += float(loss.detach())
                grads = list(g) if grads is None else [
                    a + b for a, b in zip(grads, g)]
            del leaves, loss, g
        n = 1 if local else len(rows)
        losses.append(rank_loss / n)
        if frozen:
            del grads
            if it + 1 in checkpoints:
                saved[it + 1] = host_trees(w, h)
            continue
        rate = torch.tensor(learning_rate(solver, it), dtype=torch.float32,
                            device=device)
        with torch.no_grad():
            for s, g in zip(specs, grads):
                g = g / n if n > 1 else g
                wl, hl = w[s.layer][s.name], h[s.layer][s.name]
                local_rate = rate * s.lr_mult
                decay = wd * s.decay_mult
                gr = g if decay == 0.0 else g + decay * wl
                hl.copy_(momentum * hl + local_rate * gr)
                wl.copy_(wl - hl)
        del grads
        if it + 1 in checkpoints:
            saved[it + 1] = host_trees(w, h)
    return losses, saved


def host_trees(w: Tree, h: Tree):
    return ({l: {n: v.detach().float().cpu().clone() for n, v in d.items()}
             for l, d in w.items()},
            {l: {n: v.detach().float().cpu().clone() for n, v in d.items()}
             for l, d in h.items()})


# ---------------------------------------------------------------- compare
def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: Dict[Tuple[str, str], torch.Tensor],
              ref: Dict[Tuple[str, str], torch.Tensor],
              keys: Sequence[Tuple[str, str]]) -> Tuple[float, str, float]:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), median leaf
    norm of ref); -> (the worst leaf's gap, its name, the median leaf's
    gap)."""
    ref_n = {k: _norm(ref[k]) for k in keys}
    med = float(np.median(list(ref_n.values())))
    gaps = {k: abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-30)
            for k in keys}
    worst = max(keys, key=lambda k: gaps[k])
    return gaps[worst], f"{worst[0]}.{worst[1]}", float(
        np.median(list(gaps.values())))


def elem_gap(prog: Dict[Tuple[str, str], torch.Tensor],
             ref: Dict[Tuple[str, str], torch.Tensor],
             keys: Sequence[Tuple[str, str]]) -> float:
    """The median leaf's median element gap: each element's |prog - ref|
    over its leaf's reference RMS, the median over the leaf's elements,
    then over the leaves. A lower precision moves nearly every element;
    the ReLU and max-pool decisions that f32 rounding flips move few."""
    meds = []
    for k in keys:
        r = ref[k].double().reshape(-1)
        rms = float(torch.sqrt(torch.mean(r * r)))
        d = (prog[k].double().reshape(-1) - r).abs() / max(rms, 1e-30)
        meds.append(float(torch.median(d)))
    return float(np.median(meds))


def first_gradient(h1: Tree, w0: Tree, specs: Sequence[ParamSpec],
                   solver: Dict) -> Dict[Tuple[str, str], torch.Tensor]:
    """The gradient the optimizer took at step 1, worked out from the
    momentum after it: h1 / (rate lr_mult) less the L2 term."""
    rate = learning_rate(solver, 0)
    wd = float(solver.get("weight_decay", 0.0))
    out = {}
    for s in specs:
        local = rate * s.lr_mult
        g = h1[s.layer][s.name].double() / local
        decay = wd * s.decay_mult
        if decay:
            g = g - decay * w0[s.layer][s.name].double()
        out[(s.layer, s.name)] = g
    return out


def compare(plan: Dict, specs: Sequence[ParamSpec], solver: Dict,
            w0: Tree, prog_losses: Sequence[float], prog_saved: Dict,
            ref_losses: Sequence[float], ref_saved: Dict
            ) -> Dict[str, Tuple[float, str]]:
    """Every reading of the traffic's ``check`` plan; -> {name: (value,
    where)}:

    - ``loss_gap``: the worst step's relative loss gap; ``loss1_gap``: the
      first step's;
    - ``grad_gap``: the first gradient (from the momentum after step 1,
      ``grad_at``) by the worst leaf; ``grad_elem_gap``: the same gradient
      by the median leaf's median element (``elem_gap``);
    - ``momentum_gap``: the momentum at ``momentum_at`` by the worst leaf;
    - ``change_gap``: the parameters' change from the start at
      ``change_at`` by the worst leaf, leaves that the reference's first
      gradient leaves still (under ``STILL_LEAF`` of the median leaf's)
      left out;
    - each leaf reading again as ``<name>_med``, the median leaf's gap.

    The plan's ``compare`` names the readings held to limits."""
    keys = [(s.layer, s.name) for s in specs]
    out: Dict[str, Tuple[float, str]] = {}
    n = min(len(prog_losses), len(ref_losses))
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses[:n],
                                                  ref_losses[:n])]
    worst = int(np.argmax(gaps)) if gaps else 0
    out["loss_gap"] = (max(gaps) if gaps else math.inf, f"step {worst + 1}")
    out["loss1_gap"] = (gaps[0] if gaps else math.inf, "step 1")

    def flat(t):
        return {(l, k): v for l, d in t.items() for k, v in d.items()}

    def put(name, reading):
        out[name] = reading[:2]
        out[f"{name}_med"] = (reading[2], "median leaf")

    first = plan.get("grad_at")
    ref_g = None
    if first:
        ref_g = first_gradient(ref_saved[first][1], w0, specs, solver)
        prog_g = first_gradient(prog_saved[first][1], w0, specs, solver)
        put("grad_gap", leaf_gaps(prog_g, ref_g, keys))
        out["grad_elem_gap"] = (elem_gap(prog_g, ref_g, keys),
                                "median leaf, median element")
    if plan.get("momentum_at"):
        c = plan["momentum_at"]
        put("momentum_gap", leaf_gaps(flat(prog_saved[c][1]),
                                      flat(ref_saved[c][1]), keys))
    if plan.get("change_at"):
        c = plan["change_at"]
        w0f = flat(w0)
        moving = keys
        if ref_g is not None:
            # leaves whose reference gradient is nought to rounding move by
            # round-off alone under momentum: left out by this rule
            med = float(np.median([_norm(ref_g[k]) for k in keys]))
            moving = [k for k in keys if _norm(ref_g[k]) >= STILL_LEAF * med]
        pw, rw = flat(prog_saved[c][0]), flat(ref_saved[c][0])
        put("change_gap", leaf_gaps(
            {k: pw[k].double() - w0f[k].double() for k in moving},
            {k: rw[k].double() - w0f[k].double() for k in moving}, moving))
    return out
