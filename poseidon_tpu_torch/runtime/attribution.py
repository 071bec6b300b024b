"""Per-layer device-time attribution of a training step from a
``torch.profiler`` trace, and the analytic per-layer cost model (the port
of ``poseidon_tpu/runtime/attribution.py``).

1. ``Net.apply`` opens a ``record_function(layer.name)`` range around each
   layer while a profiler is on (:func:`scope`; off the hot path and
   outside CUDA-graph captures nothing is opened). The solver update
   opens ``optimizer_update``, the DWBP sync ``grad_sync``, the arena pack
   ``arena_pack`` (:data:`EXTRA_SCOPES`, JAX's extra scopes).
2. A traced window is written as Chrome trace-event JSON
   (:func:`start_trace`, a step each ``prof.step()``, :func:`stop_trace`):
   one warm-up step first, whose events are dropped (the profiler lost
   the first step's early kernels on the card), then the traced steps;
   :func:`load_trace_events` reads it into JAX's
   event dicts (``{name, dur_us, t0_us, plane, line, stats}``). JAX's
   XSpace protobuf parser has no counterpart: torch writes JSON.
3. :func:`trace_scope_map` is the join JAX makes through HLO ``op_name``
   metadata, made here by ranges and autograd sequence numbers. A device
   kernel belongs to the CPU op that launched it (its ``cudaLaunchKernel``
   through the correlation id); an op inside a layer's range is that
   layer's forward; an op under the autograd node of a forward op (the
   node's sequence number is the forward op's) is that layer's backward,
   JAX's ``transpose(jvp(...))`` scopes, kernels launched through ctypes
   from a Function's ``backward`` (K5, K6) included. Op events are the
   device's kernels, memsets and device-to-device copies on the card
   (copies over the host link are not op time: JAX's op line carries
   none), the CPU ops on the CPU.
4. :func:`attribute` folds event durations into the per-layer table with
   an ``(unattributed)`` residual row (JAX's, on JAX's input and output
   schema: both packages can be fed the same events), :func:`format_table`
   prints it, and :func:`measure_then_trace` times first and traces one
   step after.

``layer_cost_table`` is computed from the port's ``Net.blob_shapes`` and
``param_defs`` exactly as the JAX package computes it from its own; its
``act_bytes`` column is what ``core/remat.py``'s budget knapsack ranks
against recompute FLOPs.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["layer_cost_table", "scope", "profiling", "EXTRA_SCOPES",
           "start_trace", "stop_trace", "load_trace_events",
           "trace_scope_map", "attribute", "format_table",
           "measure_then_trace", "RESIDUAL"]

# the non-layer scopes the step opens (JAX's ATTR_EXTRA_SCOPES that the
# port has): rows of their own, phase "misc"
EXTRA_SCOPES = frozenset({"arena_pack", "optimizer_update", "grad_sync"})


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording in this
    process."""
    import torch
    return torch.autograd._profiler_enabled()


def scope(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    no-op context: the hot path and CUDA-graph captures open nothing."""
    if profiling():
        import torch
        return torch.profiler.record_function(name)
    return nullcontext()


# --------------------------------------------------------------------------- #
# capture and loading
# --------------------------------------------------------------------------- #

def start_trace(trace_dir: str, steps: int = 1, name: str = "",
                cuda: Optional[bool] = None):
    """Start a ``torch.profiler`` session over one warm-up step and then
    ``steps`` traced steps (the caller calls ``prof.step()`` after each),
    recording the CPU and, on the card (``cuda``: default whether CUDA is
    available), the device. The traced steps' Chrome trace JSON goes to
    ``<trace_dir>/<name or pid>.trace.json`` (``prof.trace_path``) when
    the last one's ``prof.step()`` or :func:`stop_trace` comes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name or os.getpid()}.trace.json")
    prof = profile(activities=acts,
                   schedule=schedule(wait=0, warmup=1, active=steps),
                   on_trace_ready=lambda p: p.export_chrome_trace(path),
                   acc_events=True)
    prof.trace_path = path
    prof.start()
    return prof


def stop_trace(prof) -> str:
    """Stop ``prof`` (after synchronizing the card); -> its trace's
    path."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    return prof.trace_path


def load_trace_events(trace_path: str) -> List[Dict]:
    """The complete ("X") events of a Chrome trace JSON (``trace_path``,
    or the newest ``*.trace.json[.gz]`` under a directory), as JAX's
    event dicts: ``{name, dur_us, t0_us, plane, line, stats}`` with the
    event's ``args`` and its ``cat`` in ``stats``."""
    path = trace_path
    if os.path.isdir(trace_path):
        found = sorted(glob.glob(os.path.join(trace_path, "*.trace.json*")),
                       key=os.path.getmtime)
        if not found:
            return []
        path = found[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        doc = json.loads(f.read())
    out: List[Dict] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        stats = dict(ev.get("args", {}) or {})
        stats["cat"] = ev.get("cat", "")
        out.append({"name": ev.get("name", ""),
                    "dur_us": float(ev.get("dur", 0.0)),
                    "t0_us": float(ev.get("ts", 0.0)),
                    "plane": str(ev.get("pid", "")),
                    "line": str(ev.get("tid", "")),
                    "stats": stats})
    return out


# --------------------------------------------------------------------------- #
# the join: op event -> (layer or extra scope, phase)
# --------------------------------------------------------------------------- #

_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_BWD_NODE = "autograd::engine::evaluate_function: "


def _is_device_op(ev: Dict) -> bool:
    cat = ev["stats"].get("cat", "")
    if cat in ("kernel", "gpu_memset"):
        return True
    if cat == "gpu_memcpy":
        name = ev["name"]
        return "HtoD" not in name and "DtoH" not in name
    return False


def _decision(ev: Dict, layers, extras):
    """What an enclosing event says of the ops inside it, or None: a
    layer's range (fwd), an extra scope's (misc), an autograd node with a
    sequence number (bwd of the forward op that made it)."""
    cat, name = ev["stats"].get("cat"), ev["name"]
    if cat == "user_annotation":
        if name in layers:
            return ("layer", name)
        if name in extras:
            return ("extra", name)
        return None
    if cat == "cpu_op" and name.startswith(_BWD_NODE):
        seq = ev["stats"].get("Sequence number")
        return None if seq is None else ("bwd", int(seq))
    return None


def trace_scope_map(events: List[Dict], layer_names,
                    extra_scopes=EXTRA_SCOPES
                    ) -> Dict[str, Tuple[str, str]]:
    """Mark every op event of a torch trace with a join key
    (``stats["hlo_op"]``) and return ``{key: (scope, phase)}`` for those
    that join a layer or an extra scope, the shape of JAX's
    ``hlo_scope_map``; an op that joins nothing keeps its name as its key
    and lands in :func:`attribute`'s residual row. See the module
    docstring for the rules."""
    layers, extras = set(layer_names), set(extra_scopes)
    host = [i for i, e in enumerate(events)
            if e["stats"].get("cat") in _HOST_CATS]
    ops = [i for i, e in enumerate(events) if _is_device_op(e)]
    cpu_mode = not ops
    if cpu_mode:
        ops = [i for i in host if events[i]["stats"].get("cat") == "cpu_op"]
    # the sweep: each host thread's events nest; an event's decision is
    # its own, else its innermost enclosing deciding event's
    decided: Dict[int, Optional[Tuple]] = {}
    by_line: Dict[Tuple[str, str], List[int]] = {}
    for i in host:
        e = events[i]
        by_line.setdefault((e["plane"], e["line"]), []).append(i)
    for idxs in by_line.values():
        idxs.sort(key=lambda i: (events[i]["t0_us"], -events[i]["dur_us"]))
        stack: List[Tuple[float, Optional[Tuple]]] = []  # (end, decision)
        for i in idxs:
            e = events[i]
            t0 = e["t0_us"]
            while stack and t0 >= stack[-1][0]:
                stack.pop()
            own = _decision(e, layers, extras)
            d = own if own is not None else (stack[-1][1] if stack
                                             else None)
            decided[i] = d
            stack.append((t0 + e["dur_us"], d))
    # forward op -> its layer, by sequence number (the first forward op
    # of a sequence number inside a layer's range names it)
    seq_layer: Dict[int, str] = {}
    for i in host:
        e = events[i]
        seq = e["stats"].get("Sequence number")
        if seq is None or e["stats"].get("cat") != "cpu_op" \
                or e["name"].startswith(_BWD_NODE):
            continue
        d = decided.get(i)
        if d is not None and d[0] == "layer":
            seq_layer.setdefault(int(seq), d[1])

    def resolve(d) -> Optional[Tuple[str, str]]:
        if d is None:
            return None
        kind, val = d
        if kind == "layer":
            return (val, "fwd")
        if kind == "extra":
            return (val, "misc")
        layer = seq_layer.get(val)
        return None if layer is None else (layer, "bwd")

    # device op -> its launch (correlation id), else the op of its
    # external id
    launch: Dict[int, int] = {}
    external: Dict[int, int] = {}
    if not cpu_mode:
        for i in host:
            st = events[i]["stats"]
            if st.get("cat") in ("cuda_runtime", "cuda_driver") \
                    and "correlation" in st:
                launch[int(st["correlation"])] = i
            elif st.get("cat") == "cpu_op" and "External id" in st:
                external.setdefault(int(st["External id"]), i)
    scope_map: Dict[str, Tuple[str, str]] = {}
    for i in ops:
        e = events[i]
        if cpu_mode:
            d = decided.get(i)
        else:
            st = e["stats"]
            src = launch.get(int(st.get("correlation", -1)))
            if src is None:
                src = external.get(int(st.get("External id", -1)))
            d = decided.get(src) if src is not None else None
        where = resolve(d)
        if where is None:
            e["stats"]["hlo_op"] = e["name"]
            continue
        key = f"{e['name']}#{i}"
        e["stats"]["hlo_op"] = key
        scope_map[key] = where
    return scope_map


def _shape_elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def layer_cost_table(net, dtype_bytes: int = 4) -> Dict[str, Dict]:
    """{layer: {flops, bytes, act_bytes, intensity}} for one train step
    (forward and backward), from the blob and parameter shapes.

    Conv and FC are exact MAC counts (x2 for the multiply and the add; the
    backward, dW + dX, is twice the forward). Pooling, LRN and elementwise
    layers are per-element estimates: they rank the sinks and give an
    intensity, they are not a simulator. Bytes are the activations in and
    out plus the params, x3 for the backward's re-reads and gradient
    writes.

    ``act_bytes`` is the layer's stored forward activation footprint, its
    top blobs; an in-place top (named as a bottom) counts once."""
    out: Dict[str, Dict] = {}
    for layer in net.layers:
        lp = layer.lp
        tops = [net.blob_shapes[t] for t in lp.top if t in net.blob_shapes]
        bots = [net.blob_shapes[b] for b in lp.bottom
                if b in net.blob_shapes]
        out_elems = sum(_shape_elems(s) for s in tops)
        in_elems = sum(_shape_elems(s) for s in bots)
        defs = net.param_defs.get(layer.name, [])
        pcount = sum(p.count for p in defs)
        t = layer.TYPE
        if t == "CONVOLUTION" and defs and len(defs[0].shape) == 4:
            k, cg, r, s = defs[0].shape
            n, _, ho, wo = tops[0]
            fwd = 2.0 * n * ho * wo * k * cg * r * s
        elif t in ("INNER_PRODUCT",) and defs:
            batch = bots[0][0] if bots else 1
            wcount = max((p.count for p in defs if len(p.shape) == 2),
                         default=pcount)
            fwd = 2.0 * batch * wcount
        elif t == "POOLING":
            ksz = max(1, int(getattr(lp.pooling_param, "kernel_size", 2)))
            fwd = float(out_elems) * ksz * ksz
        elif t == "LRN":
            local = max(1, int(getattr(lp.lrn_param, "local_size", 5)))
            fwd = float(in_elems) * (2 * local + 4)
        elif t in ("SOFTMAX", "SOFTMAX_LOSS"):
            fwd = 5.0 * in_elems
        else:
            fwd = float(max(in_elems, out_elems))
        flops = 3.0 * fwd                       # fwd + (dW + dX) backward
        bytes_ = 3.0 * (in_elems + out_elems + pcount) * dtype_bytes
        out[layer.name] = {
            "flops": flops,
            "bytes": bytes_,
            "act_bytes": int(out_elems) * int(dtype_bytes),
            "intensity": round(flops / bytes_, 3) if bytes_ else None,
        }
    return out


# --------------------------------------------------------------------------- #
# the per-layer table (JAX's, on JAX's schemas)
# --------------------------------------------------------------------------- #

RESIDUAL = "(unattributed)"


def attribute(events: Sequence[Dict], scope_map: Dict[str, Tuple[str, str]],
              cost_table: Optional[Dict[str, Dict]] = None,
              peak_flops: Optional[float] = None,
              steps: int = 1,
              tracer_overhead_ms: Optional[float] = None) -> Dict:
    """Fold trace events into the per-layer table.

    JAX's function on JAX's schema. Only OP events enter the accounting:
    an event whose ``stats`` carry an ``hlo_op`` (the join key
    :func:`trace_scope_map` sets on every op event), whose name is a known
    key, or that sits on a device op line. Annotations, runtime calls and
    Python events are excluded from both numerator and denominator: the
    table answers "where does the traced op time go", and the residual
    row reports op time that joined no known scope.

    Accounting is SELF time: op events nest (a while op contains its body
    ops on the same thread line, a fusion its producers), so each event is
    billed its duration minus its direct op children's — flame-graph
    attribution, never double-counted. ``steps`` divides a multi-step
    trace down to per-step ms.

    ``tracer_overhead_ms``: on the CPU the tracer costs a few us per op
    event. Pass ``traced_wall - untimed_wall`` here and the overhead is
    stripped uniformly per event before accounting (reported back as
    ``tracer_overhead_ms_stripped``). Leave None on the card: device
    events are hardware timings and carry no host tracer cost."""
    steps = max(1, int(steps))

    # 1) select op events, keyed for the scope join
    ops: List[Tuple] = []          # (plane, line, t0, dur, key, known)
    for ev in events:
        key = ev.get("stats", {}).get("hlo_op") or ev.get("name", "")
        if isinstance(key, bytes):
            key = key.decode("utf-8", "replace")
        known = key in scope_map
        if not known:
            # device event names sometimes decorate the instruction name
            # ('%fusion.3', an extra trailing '.<n>'); strip and retry
            # before consigning the event to the residual row
            alt = key.lstrip("%")
            if alt not in scope_map:
                alt = re.sub(r"\.\d+$", "", alt)
            if alt in scope_map:
                key, known = alt, True
        # TPU device planes also carry whole-step lines ("XLA Modules",
        # "Steps") whose events span the entire dispatch — counting those
        # as residual would halve coverage. Only the op line ("XLA Ops")
        # qualifies an unknown device event as op time.
        on_device_op_line = (
            str(ev.get("plane", "")).startswith("/device:")
            and "op" in str(ev.get("line", "")).lower())
        if not known and "hlo_op" not in ev.get("stats", {}) \
                and not on_device_op_line:
            continue                       # not an op event at all
        ops.append((ev.get("plane", ""), ev.get("line", ""),
                    float(ev.get("t0_us", 0.0)),
                    float(ev.get("dur_us", 0.0)), key, known))

    # 2) per thread line, subtract each op's direct op-children time
    self_us: List[float] = [0.0] * len(ops)
    children: List[int] = [0] * len(ops)   # direct op-children count
    by_line: Dict[Tuple, List[int]] = {}
    for i, op in enumerate(ops):
        by_line.setdefault((op[0], op[1]), []).append(i)
    for idxs in by_line.values():
        idxs.sort(key=lambda i: (ops[i][2], -ops[i][3]))
        stack: List[int] = []              # enclosing-op indices
        for i in idxs:
            _, _, t0, dur, _, _ = ops[i]
            while stack and t0 >= ops[stack[-1]][2] + ops[stack[-1]][3]:
                stack.pop()
            self_us[i] = dur
            if stack:
                self_us[stack[-1]] -= dur  # parent loses the child's time
                children[stack[-1]] += 1
            stack.append(i)

    # the tracer bills ~c per EVENT, and a child's bookkeeping lands in
    # its parent's self-time window — so debit each op c * (1 + its
    # direct children). This is what rescues the while-loop ops (one
    # thunk event per loop trip) from reading as the top sink.
    per_event_oh = 0.0
    if tracer_overhead_ms and ops:
        per_event_oh = max(tracer_overhead_ms, 0.0) * 1e3 / len(ops)

    per_scope: Dict[str, Dict[str, float]] = {}
    residual_us = 0.0
    residual_ops: Dict[str, float] = {}
    total_us = 0.0
    for (_, _, _t0, _dur, key, known), dur, nchild in zip(ops, self_us,
                                                          children):
        dur = max(dur - per_event_oh * (1 + nchild), 0.0)
        total_us += dur
        if not known:
            residual_us += dur
            residual_ops[key] = residual_ops.get(key, 0.0) + dur
            continue
        scope, phase = scope_map[key]
        row = per_scope.setdefault(scope, {"fwd": 0.0, "bwd": 0.0,
                                           "misc": 0.0})
        row[phase if phase in row else "misc"] += dur
    rows: List[Dict] = []
    for scope, acc in per_scope.items():
        tot_ms = (acc["fwd"] + acc["bwd"] + acc["misc"]) / 1e3 / steps
        row = {
            "layer": scope,
            "fwd_ms": round(acc["fwd"] / 1e3 / steps, 4),
            "bwd_ms": round(acc["bwd"] / 1e3 / steps, 4),
            "total_ms": round(tot_ms, 4),
            "pct_of_traced": round(100.0 * (acc["fwd"] + acc["bwd"] +
                                          acc["misc"]) / total_us, 2)
            if total_us else 0.0,
        }
        cost = (cost_table or {}).get(scope)
        if cost:
            row["flops"] = cost["flops"]
            row["intensity"] = cost["intensity"]
            if peak_flops and tot_ms > 0:
                row["mfu"] = round(cost["flops"] / (tot_ms / 1e3)
                                   / peak_flops, 4)
        rows.append(row)
    rows.sort(key=lambda r: -r["total_ms"])
    total_ms = total_us / 1e3 / steps
    res_ms = residual_us / 1e3 / steps
    coverage = 1.0 - (residual_us / total_us) if total_us else 0.0
    top_res = sorted(residual_ops.items(), key=lambda kv: -kv[1])[:5]
    return {
        "rows": rows,
        "residual": {
            "layer": RESIDUAL,
            "total_ms": round(res_ms, 4),
            "pct_of_traced": round(100.0 * residual_us / total_us, 2)
            if total_us else 0.0,
            "top_ops": [{"op": k, "ms": round(v / 1e3 / steps, 4)}
                        for k, v in top_res],
        },
        "total_ms": round(total_ms, 4),
        "coverage": round(coverage, 4),
        "top_sinks": [r["layer"] for r in rows[:3]],
        "op_events": len(ops),
        "tracer_overhead_ms_stripped": round(per_event_oh * len(ops) / 1e3,
                                             3),
    }


def format_table(result: Dict, title: str = "") -> str:
    """Human-readable rendering of one attribution result."""
    lines = []
    if title:
        lines.append(title)
    hdr = (f"{'layer':<28}{'fwd ms':>9}{'bwd ms':>9}{'total':>9}"
           f"{'%traced':>8}{'GFLOPs':>9}{'F/B':>7}{'MFU':>7}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for r in result["rows"]:
        gf = r.get("flops")
        lines.append(
            f"{r['layer']:<28}{r['fwd_ms']:>9.3f}{r['bwd_ms']:>9.3f}"
            f"{r['total_ms']:>9.3f}{r['pct_of_traced']:>8.2f}"
            f"{(gf / 1e9 if gf else 0):>9.2f}"
            f"{(r.get('intensity') or 0):>7.1f}"
            f"{(r['mfu'] if r.get('mfu') is not None else float('nan')):>7.3f}")
    res = result["residual"]
    lines.append(f"{res['layer']:<28}{'':>9}{'':>9}"
                 f"{res['total_ms']:>9.3f}{res['pct_of_traced']:>8.2f}")
    lines.append(f"named coverage: {result['coverage']:.1%} of "
                 f"{result['total_ms']:.3f} ms traced op time; top sinks: "
                 f"{', '.join(result['top_sinks'])}")
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# capture discipline: timing FIRST, trace capture AFTER
# --------------------------------------------------------------------------- #

def measure_then_trace(run_step, trace_dir: str, iters: int = 3) -> Dict:
    """Run the timed loop first (min-wall over ``iters`` calls), then
    trace exactly one step into ``trace_dir`` after the session's
    warm-up step (:func:`start_trace`, :func:`stop_trace`), so the
    profiler never touches a timed step. ``run_step`` is a zero-arg
    callable that runs one step and returns when it completed (on the
    card: after ``torch.cuda.synchronize()``). Returns {"step_ms",
    "walls_ms", "traced_step_ms", "trace"}."""
    walls = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        run_step()
        walls.append(time.perf_counter() - t0)
    prof = start_trace(trace_dir)
    try:
        run_step()                     # the warm-up step, not recorded
        prof.step()
        t0 = time.perf_counter()
        run_step()
        traced_wall = time.perf_counter() - t0
        prof.step()
    finally:
        path = stop_trace(prof)
    return {"step_ms": round(min(walls) * 1e3, 4),
            "walls_ms": [round(w * 1e3, 3) for w in walls],
            # traced-vs-untraced gap = the tracer's whole cost; attribute()
            # strips it per event on CPU traces
            "traced_step_ms": round(traced_wall * 1e3, 4),
            "trace": path}
