"""One run of a cell: set-up, the measured window, the reference and the
metrics.

The program is driven as a user drives it: ``python -m poseidon_tpu_torch
train`` through its own CLI (``runtime/cli.main``), which builds the
``Engine`` from the run's solver and flags. The harness hands the CLI an
``Engine`` subclass whose ``train()`` runs the run's phases by calling the
engine's own ``train(max_iter=...)`` on that one object:

1. the checked steps (the traffic's ``check`` plan): the first dispatches
   from the benchmark's weights, with the parameters and momentum copied
   to the host at each checkpoint;
2. warm-up to a display boundary, whose last display period gives the
   rate that sizes the window;
3. the window: one ``train(max_iter=...)`` call of a whole number of
   display periods, from its first dispatch to its final hard sync. In a
   traced run a ``torch.profiler`` session opens one dispatch before the
   second display period of the window and traces that period.

The harness's own instruments are CUDA events recorded after each
dispatch (by wrapping ``TrainStep.step`` and ``multi_step`` on the
engine's instance) and, in a traced run, the engine's span recorder
(``--trace_out``). The engine is not edited.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import costs, manifest, prototxt, reference, synth
from .refnet import RefNet

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")


def cache_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout:
    the kernel store (``--compile_cache_dir``), Triton's and torch's
    extension caches."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


# ---------------------------------------------------------------- files
def _sub_data_layer(text: str, batch: int, source: str,
                    transform: Dict) -> str:
    """The net's text with every DATA layer reading ``source`` at
    ``batch`` and the TRAIN transform's mean as the traffic states (the
    mean file written for the run, or per-channel values)."""
    text = re.sub(r'source:\s*"[^"]*"', f'source: "{source}"', text)
    text = re.sub(r"batch_size:\s*\d+", f"batch_size: {batch}", text)
    if "mean_values" in transform:
        vals = " ".join(f"mean_value: {v}" for v in transform["mean_values"])
        text = re.sub(r'mean_file:\s*"[^"]*"', vals, text)
    else:
        text = re.sub(r'mean_file:\s*"[^"]*"',
                      f'mean_file: "{transform["mean_file"]}"', text)
    return text


# the solver fields the run keeps from the published solver; the test
# phase and snapshots are off in the run, the net and the seed are the run's
SOLVER_KEEP = ("base_lr", "lr_policy", "gamma", "stepsize", "power",
               "max_iter", "momentum", "weight_decay", "display",
               "regularization_type")


def solver_dict(msg: prototxt.Msg) -> Dict:
    return {k: msg.get(k) for k in SOLVER_KEEP if k in msg}


def _solver_text(solver: Dict, net_path: str, seed: int) -> str:
    lines = [f'net: "{net_path}"']
    for k, v in solver.items():
        lines.append(f'{k}: "{v}"' if k in ("lr_policy",
                                            "regularization_type")
                     else f"{k}: {v}")
    lines += [f"random_seed: {seed}", "snapshot: 0",
              "snapshot_after_train: false"]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- timing
class StepClock:
    """A mark after each dispatch: a CUDA event on the card, the host
    clock after a synchronous CPU step."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: List = []
        self.steps: List[int] = []

    def mark(self, k: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        self.steps.append(k)

    def step_ms(self) -> List[float]:
        """Each step's ms: the interval between consecutive dispatch ends
        over the dispatch's steps."""
        out = []
        for i in range(1, len(self.marks)):
            a, b = self.marks[i - 1], self.marks[i]
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out.append(ms / self.steps[i])
        return out


class Tracer:
    """The traced stretch: a profiler session opened one dispatch early,
    a ``bench_window`` annotation over one display period."""

    def __init__(self, cuda: bool, out_dir: str):
        self.cuda = cuda
        self.path = os.path.join(out_dir, "device_trace.json")
        self.prof = None
        self.annotation = None
        self.state = "idle"     # -> open -> annotating -> done
        self.host = (0.0, 0.0)
        self.steps = 0

    def advance(self, it: int, lo: int, hi: int, k: int) -> None:
        """At the dispatch that starts at iteration ``it``: open one
        dispatch before ``lo``, annotate from ``lo``, end at ``hi``."""
        if self.state == "idle" and it >= lo - k:
            self.open()
            self.state = "open"
        if self.state == "open" and it >= lo:
            self.begin()
            self.state = "annotating"
        elif self.state == "annotating" and it >= hi:
            self.end(it - lo)

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()

    def begin(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.annotation = torch.profiler.record_function("bench_window")
        self.annotation.__enter__()
        self.host = (t, 0.0)

    def end(self, steps: int) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.annotation.__exit__(None, None, None)
        self.host = (self.host[0], time.perf_counter())
        self.steps = steps
        self.state = "done"
        self.prof.stop()

    def export(self) -> str:
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        return self.path


# ---------------------------------------------------------------- the run
RunState = SimpleNamespace


def host_tree(tree) -> Dict:
    return {l: {n: v.detach().float().cpu().clone() for n, v in d.items()}
            for l, d in tree.items()}


def _bench_engine(base, st: RunState):
    """The ``Engine`` the CLI builds for this run (see the module
    docstring)."""

    class BenchEngine(base):
        def train(self, max_iter=None):
            return _drive(self, base, st)

    return BenchEngine


def _wrap_dispatch(eng, st: RunState) -> None:
    ts = eng.train_step
    step, multi = ts.step, ts.multi_step
    if st.fault == "noexchange":
        # a planted fault: the ranks' gradient exchange left out (each
        # DWBP bucket's all-reduce is never issued)
        ts.sync._issue = lambda bucket: None

    def wrap(fn, k):
        def dispatch(params, state, batch):
            it = int(state.solver.it)
            st.before(it)
            if st.fault == "half":
                batch = _half(batch, k > 1)
            if st.fault == "frozen":
                saved = (ts.flat_w.clone(), ts.flat_h.clone())
            out = fn(params, state, batch)
            if st.fault == "frozen":
                with torch.no_grad():
                    ts.flat_w.copy_(saved[0])
                    ts.flat_h.copy_(saved[1])
            st.after(it, k, out[2])
            return out
        return dispatch

    ts.step = wrap(step, 1)
    ts.multi_step = wrap(multi, ts.steps_per_dispatch)


def _half(batch, stacked: bool):
    """A planted fault: the first half of each step's rows (the test's
    broken timed path)."""
    def cut(v):
        return v[:, :v.shape[1] // 2] if stacked else v[:v.shape[0] // 2]
    return {t: cut(v) for t, v in batch.items()}


def _drive(eng, base, st: RunState):
    cuda = eng.device.type == "cuda"
    ts = eng.train_step
    # the benchmark's weights, loaded as ``train --weights`` loads them
    eng.params = ts.load_weights(
        {l: {n: v.to(eng.device) for n, v in d.items()}
         for l, d in st.weights.items()})
    _wrap_dispatch(eng, st)
    orig_hard_sync = eng._hard_sync

    def hard_sync(fetcher, boundary, last):
        out = orig_hard_sync(fetcher, boundary, last)
        if boundary == "final" and st.phase == "window":
            st.t_final = time.perf_counter()
            if st.tracer is not None and st.tracer.state == "annotating":
                st.tracer.end(eng.iteration() - st.trace_iters[0])
        return out

    eng._hard_sync = hard_sync
    train = lambda n: base.train(eng, max_iter=n)

    # 1. the checked steps
    st.phase = "check"
    for c in st.check_points:
        train(c)
        st.prog_saved[c] = (host_tree(eng.params),
                            host_tree(eng.state.solver.history))
    # 2. warm-up to a display boundary; its last period sizes the window
    st.phase = "warm"
    disp = max(1, int(eng.sp.display or 20))
    start = (st.check_points[-1] // disp + 1) * disp + disp
    train(start - disp)
    t0 = time.perf_counter()
    train(start)
    rate = disp / (time.perf_counter() - t0)
    periods = max(3 if st.trace else 1,
                  int(round(st.seconds * rate / disp)))
    if eng.world > 1:
        # every rank runs rank 0's window
        import torch.distributed as dist
        agreed = torch.tensor([periods], device=eng.device)
        dist.broadcast(agreed, 0)
        periods = int(agreed.item())
    n = periods * disp
    st.window_iters = (start, start + n)
    if st.trace:
        st.trace_iters = (start + disp, start + 2 * disp)
    st.setup_s = time.perf_counter() - st.t_process
    # 3. the window
    st.phase = "window"
    st.clock = StepClock(cuda)
    st.clock.mark(0)
    st.t_window = time.perf_counter()
    train(start + n)
    st.window_s = st.t_final - st.t_window
    st.window_steps = n
    st.phase = "done"
    if cuda:
        torch.cuda.synchronize()
        st.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    return {}


def _before(st: RunState, it: int) -> None:
    if st.tracer is not None and st.phase == "window":
        st.tracer.advance(it, *st.trace_iters, st.k)


def _after(st: RunState, it: int, k: int, metrics) -> None:
    if st.phase == "check":
        st.prog_losses.extend(
            metrics["loss"].detach().float().reshape(-1).cpu().tolist())
    elif st.phase == "window":
        st.clock.mark(k)


def _prepare(cell, seed, batch, n_records, device, run_dir):
    """The run's inputs from the seed, made on the device: the records,
    their LMDB and mean file, the run's net and solver prototxts and the
    reference net. -> a namespace of them."""
    cfg, traffic = cell.config, cell.traffic
    shape = tuple(cfg["record_shape"])
    crop = int(cfg["crop_size"])
    solver = solver_dict(prototxt.read(manifest.config_path(cell, "solver")))
    ref_net = RefNet(prototxt.read(manifest.config_path(cell, "net")), batch,
                     crop, channels=shape[0])
    images, labels = synth.make_records(seed, n_records, int(cfg["classes"]),
                                        shape, device)
    mean = synth.image_mean(images)
    db, mean_path = synth.write_dataset(run_dir, images, labels, mean)
    transform = dict(traffic.get("transform", {}))
    if "mean_values" not in transform:
        transform["mean_file"] = mean_path
    with open(manifest.config_path(cell, "net")) as f:
        net_text = _sub_data_layer(f.read(), batch, db, transform)
    net_path = os.path.join(run_dir, "train.prototxt")
    with open(net_path, "w") as f:
        f.write(net_text)
    solver_path = os.path.join(run_dir, "solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(_solver_text(solver, net_path, seed))
    return SimpleNamespace(images=images, labels=labels, mean=mean,
                           solver=solver, ref_net=ref_net, crop=crop,
                           solver_path=solver_path)


def train_rank(cell, seed, seconds, trace, device, t_process, run_dir,
               specs, fault=None) -> RunState:
    """This process's rank of the run: the benchmark's weights, then the
    program's ``train`` CLI driven through the run's phases."""
    cuda = device == "cuda"
    traffic = cell.traffic
    st = RunState(
        t_process=t_process, seconds=seconds, trace=trace, fault=fault,
        check_points=list(traffic["check"]["points"]), prog_saved={},
        prog_losses=[], phase="setup", tracer=None, t_final=None,
        memory_peak_bytes=0, k=int(traffic.get("steps_per_dispatch", 1)),
        rank=int(os.environ.get("POSEIDON_PROC_ID", "0")))
    st.before = lambda it: _before(st, it)
    st.after = lambda it, k, m: _after(st, it, k, m)
    st.weights = reference.make_weights(specs, seed + 1, device)
    if trace:
        st.tracer = Tracer(cuda, os.path.join(run_dir, f"rank{st.rank}"))
        os.makedirs(os.path.join(run_dir, f"rank{st.rank}"), exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    argv = ["train", "--solver", os.path.join(run_dir, "solver.prototxt"),
            "--output_dir", os.path.join(run_dir, f"rank{st.rank}", "out"),
            "--tuned_plan", "off",
            "--compile_cache_dir", os.path.join(CACHE, "kernels")]
    argv += list(traffic.get("flags", []))
    if trace:
        argv += ["--trace_out", "spans.json"]
    if not cuda:
        argv += ["--device", "cpu"]
    _run_cli(argv, st)
    st.weights = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return st


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the program's launcher env contract (runtime/cluster.py), which rank 0
# sets for the run and puts back after it
LAUNCH_ENV = ("POSEIDON_PROC_ID", "POSEIDON_NUM_PROCS",
              "POSEIDON_COORDINATOR")


def _spawn_ranks(cell, seed, seconds, trace, device, run_dir, fault, ranks):
    """Ranks 1.. as processes of ``benchmark.rank``; this process is rank
    0 (the program's launcher env contract, ``runtime/cluster.py``)."""
    import subprocess
    # the cell's entry, for ranks of a cell the manifest may not list yet
    with open(os.path.join(run_dir, "cell.json"), "w") as f:
        json.dump({"name": cell.name, "config": cell.config_name,
                   "traffic": cell.traffic_name, "chips": cell.chips}, f)
    coord = f"tcp://127.0.0.1:{_free_port()}"
    os.environ.update(POSEIDON_PROC_ID="0", POSEIDON_NUM_PROCS=str(ranks),
                      POSEIDON_COORDINATOR=coord)
    procs = []
    for r in range(1, ranks):
        env = dict(os.environ, POSEIDON_PROC_ID=str(r))
        log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "benchmark.rank", "--workload", cell.name,
             "--seed", str(seed), "--seconds", str(seconds), "--trace",
             str(int(trace)), "--device", device, "--run_dir", run_dir]
            + (["--fault", fault] if fault else []),
            cwd=manifest.ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _join_ranks(procs, run_dir, timeout: float = 120.0) -> List[Dict]:
    """Wait for ranks 1..; -> each one's report (``rank<r>.json``)."""
    import subprocess
    out = []
    for r, (proc, log) in enumerate(procs, start=1):
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        path = os.path.join(run_dir, f"rank{r}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(run_dir, f"rank{r}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"rank {r} exited with {proc.returncode}:\n"
                               f"{tail}")
        with open(path) as f:
            out.append(json.load(f))
    return out


def rank_report(st: RunState, trace_view) -> Dict:
    return {"memory_peak_bytes": st.memory_peak_bytes,
            "busy_s": trace_view.busy_s if trace_view else None,
            "window_s": trace_view.window_s if trace_view else None}


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             batch: Optional[int] = None, records: Optional[int] = None,
             fault: Optional[str] = None) -> Dict:
    """One run of ``cell`` (its rank 0 when it has more); -> the result's
    fields. ``batch`` and ``records`` cut the cell for a CPU rehearsal,
    ``fault`` plants a fault in the timed path (the tests' broken runs)."""
    t_process = time.perf_counter() if t_process is None else t_process
    traffic = cell.traffic
    batch = batch or int(traffic["batch"])
    ranks = int(traffic.get("ranks", 1))
    run_dir = tempfile.mkdtemp(prefix="bench-")
    procs = []
    env_saved = {k: os.environ.get(k) for k in LAUNCH_ENV}
    try:
        inp = _prepare(cell, seed, batch, records or int(traffic["records"]),
                       device, run_dir)
        specs = inp.ref_net.param_specs()
        w0 = host_tree(reference.make_weights(specs, seed + 1, device))
        if ranks > 1:
            procs = _spawn_ranks(cell, seed, seconds, trace, device, run_dir,
                                 fault, ranks)
        st = train_rank(cell, seed, seconds, trace, device, t_process,
                        run_dir, specs, fault)
        spans = read_spans() if trace else []
        device_trace = st.tracer.export() if trace else None
        others = _join_ranks(procs, run_dir) if procs else []
        procs = []

        # the reference, after the window, on the same inputs
        ref = reference_run(cell, inp.ref_net, inp.solver, seed, inp.images,
                            inp.labels, inp.mean, batch, inp.crop, device,
                            st.check_points, w0)
        checks = reference.compare(
            traffic["check"], specs, inp.solver, w0, st.prog_losses,
            st.prog_saved, ref[0], ref[1])
        ctx = _context(cell, inp.ref_net, st, batch, spans, device_trace,
                       device)
        return _result(cell, st, checks, ctx, trace, device, others)
    finally:
        for proc, log in procs:
            proc.kill()
            proc.wait()
            log.close()
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(run_dir, ignore_errors=True)


def _run_cli(argv: List[str], st: RunState) -> None:
    """``python -m poseidon_tpu_torch train`` with the run's Engine; the
    program's log goes to standard error."""
    from poseidon_tpu_torch.runtime import cli
    from poseidon_tpu_torch.runtime import engine as engine_mod
    base = engine_mod.Engine
    engine_mod.Engine = _bench_engine(base, st)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(argv)
    finally:
        engine_mod.Engine = base
    if rc:
        raise RuntimeError(f"train exited with {rc}")


def read_spans():
    """The engine's host spans (``runtime/spans.py``) on the host clock of
    ``time.perf_counter``: (name, start s, seconds)."""
    from poseidon_tpu_torch.runtime.spans import recorder
    off_us = time.time() * 1e6 - time.perf_counter() * 1e6
    out = []
    for ev in recorder.trace_events():
        if ev.get("ph") == "X":
            out.append((ev["name"], (ev["ts"] - off_us) / 1e6,
                        ev["dur"] / 1e6))
    recorder.clear()
    return out


def reference_run(cell, ref_net, solver, seed, images, labels, mean, batch,
                  crop, device, check_points, w0, quant=None,
                  half_batch=False, frozen=False, local=False, tf32=False):
    """The plain reference over the checked steps from the host weights
    ``w0``, every rank's rows and dropout masks, in f32 with TF32 off
    unless ``tf32``; -> (losses, saved)."""
    traffic, cfg = cell.traffic, cell.config
    transform = traffic.get("transform", {})
    mean_values = transform.get("mean_values")
    height, width = cfg["record_shape"][1:]
    ranks = int(traffic.get("ranks", 1))

    def batches(i):
        return [reference.make_batch(
            images, labels,
            reference.crop_plan(len(images), batch, i, crop, height, width,
                                bool(cfg.get("mirror", True)),
                                shard=(r, ranks)),
            crop, device, mean_file=None if mean_values else mean,
            mean_values=mean_values) for r in range(ranks)]

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        weights = {l: {n: v.to(device) for n, v in d.items()}
                   for l, d in w0.items()}
        # rank r's dropout seed: the solver's with r in the high word (the
        # program's documented rank_seed)
        return reference.reference_steps(
            ref_net, weights, batches, solver,
            [seed + (r << 32) for r in range(ranks)], max(check_points),
            check_points, device, quant=quant, half_batch=half_batch,
            frozen=frozen, local=local)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- metrics
def _context(cell, ref_net, st, batch, spans, device_trace, device):
    from . import trace as tr
    precision = cell.traffic.get("precision", "f32")
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    pk = costs.peaks(name) if device == "cuda" else None
    ctx = SimpleNamespace(
        cell=cell, batch=batch, chips=cell.chips, precision=precision,
        elem_bytes=2 if precision == "bf16" else 4, peaks=pk,
        net=ref_net, costs=costs, window_s=getattr(st, "window_s", None),
        window_steps=getattr(st, "window_steps", 0),
        setup_s=getattr(st, "setup_s", None),
        step_ms=st.clock.step_ms() if getattr(st, "clock", None) else [],
        spans=spans, trace=None)
    if device_trace is not None:
        ctx.trace = tr.load(device_trace, st.tracer, spans)
    return ctx


def _result(cell, st, checks, ctx, trace, device, others=()) -> Dict:
    """The result's fields; ``others`` are ranks 1..'s reports (the
    memory peak of the fullest card, the busy seconds averaged over the
    cards)."""
    metrics: Dict[str, Dict] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = True
    compared = {}
    for key in cell.traffic["check"]["compare"]:
        value, where = checks[key]
        limit = float(cell.limits[key])
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        compared[key] = {"value": value, "limit": limit, "worst": where}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": max([st.memory_peak_bytes] + [
               o["memory_peak_bytes"] for o in others])}
    dev.update(_card_limits() if device == "cuda" else {})
    out = {"correct": correct, "attempted": ctx.window_steps, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        busy = [ctx.trace.busy_s] + [o["busy_s"] for o in others]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = compared
    out["readings"] = {k: v[0] for k, v in checks.items()}
    return out


def _card_limits() -> Dict:
    """The card's power limit and top SM clock, as ``nvidia-smi`` reads
    them."""
    import subprocess
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        first = proc.stdout.strip().splitlines()[0]
        limit, clock = [s.strip() for s in first.split(",")]
        return {"power_limit": limit, "max_sm_clock": clock}
    except (OSError, IndexError, ValueError, subprocess.TimeoutExpired):
        return {"power_limit": "unknown"}
