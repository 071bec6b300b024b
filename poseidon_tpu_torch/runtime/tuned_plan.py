"""TunedPlan: one measured, persisted artifact for every policy knob (the
port of ``poseidon_tpu/runtime/tuned_plan.py``, Caffe con Troll's
cost-based optimizer, arXiv:1504.04343, applied to the system's own
knobs):

  conv_layout          the CNN graph's activation layout (the "auto" table
                       of ``numeric.resolve_conv_layout`` becomes one
                       measured row of the plan)
  conv_strategy        the per-layer conv lowering ("auto" = the measured
                       per-layer store of ``ops/conv_tune.py``, kept in
                       this plan's store)
  arena_bucket_mb      the flat arena's DWBP bucket size
  mesh                 the ``--mesh`` factorization of the devices
  device_prefetch /    the loop's input prefetch depth and in-flight
  max_in_flight        dispatch window
  steps_per_dispatch   optimizer steps a dispatch (a CUDA graph on the
                       card)
  serve_buckets        the serving tier's bucket ladder
  llm_*                the LM serving knobs (page size, decode rungs,
                       prompt buckets, replicas x tp)
  wire_dtype           the managed tier's delta wire dtype
  remat / batch_size / the measured memory budget pair (core/remat.py)
  hbm_budget_gb

One plan JSON per (model, backend, device count) lives in the tuned store
(``runtime/compile_cache.load_tuned/save_tuned``, namespace "plan").
Provenance is checked when a plan loads: a plan whose device kind
(``torch.cuda.get_device_name()``, or "cpu") or torch version differs
from this process's refuses to load, loudly, and the built-in defaults
apply; a plan written by the JAX package (no ``torch_version``) refuses
the same way. The CUDA version is recorded beside them. The port's plans
never collide with the JAX package's: every key has a ``framework``
part ("torch"), and the default store is the port's own
(``~/.cache/poseidon_tpu_torch``).

Resolution is strict and recorded knob by knob:

    explicit CLI flag  >  persisted TunedPlan  >  built-in default

``train``, ``serve`` and ``bench_serve`` load the matching plan at start
(``runtime/cli.py``); the active resolution is published process-wide
(:func:`set_active_resolution`), so ``numeric.resolve_conv_layout``'s
"auto" reads the measured row, ``ops/conv_tune.py`` finds the per-layer
store and the engine writes the provenance into stats.yaml.

Trials are wall-clock measurements with the bench's hygiene
(:func:`interleaved_min_ms`): every arm warms before timing and the
candidates run in interleaved, order-alternating windows, each kept at
its best window. On the card every callable timed here ends in
``torch.cuda.synchronize()``, so a time is the work's, not the launches'.
The search always has the built-in default among the candidates and ends
with a composite default-vs-tuned step A/B; a plan that measures slower
than the defaults is never shipped (the step knobs revert, loudly).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..config import PipelineConfig
from .compile_cache import load_tuned, save_tuned, step_key, tuned_path
from .metrics import log

PLAN_NAMESPACE = "plan"
PLAN_VERSION = 1
FRAMEWORK = "torch"

# the built-in defaults every knob falls back to when neither a flag nor a
# plan covers it (the JAX package's; the pipeline knobs from config.py)
_PC = PipelineConfig()
BUILTIN_DEFAULTS: Dict[str, Any] = {
    "conv_layout": "auto",        # numeric.resolve_conv_layout's table
    "conv_strategy": "",          # the policy's conv_s2d
    "arena_bucket_mb": 4.0,
    "mesh": "",                   # plain data parallelism over the ranks
    "device_prefetch": _PC.device_prefetch,
    "max_in_flight": _PC.max_in_flight,
    "steps_per_dispatch": 1,
    "serve_buckets": "1,4,16,64",
    # LM serving (serving/continuous.py): KV page size, the decode-batch
    # rung ladder, the prompt-length prefill buckets
    "llm_page_size": 64,
    "llm_decode_rungs": "1,2,4,8",
    "llm_prompt_buckets": "16,64,256",
    "llm_replicas_tp": "",        # "RxT" replica x tp factorization
    # the managed tier's delta wire dtype ('' = f32 byte for byte)
    "wire_dtype": "",
    # the measured memory budget planner (core/remat.py): '' = no remat,
    # 'auto' = the budget knapsack; hbm_budget_gb 0 = no budget;
    # batch_size is the largest admissible batch measured at that budget
    # (informational: the prototxt owns the batch; 0 = unmeasured)
    "remat": "",
    "hbm_budget_gb": 0.0,
    "batch_size": 0,
}
TRAIN_KNOBS = ("conv_layout", "conv_strategy", "arena_bucket_mb", "mesh",
               "device_prefetch", "max_in_flight", "steps_per_dispatch",
               "wire_dtype", "remat", "hbm_budget_gb")


# --------------------------------------------------------------------------- #
# the store: where plans live, how they are keyed, when they refuse to load
# --------------------------------------------------------------------------- #

def store_dir(cache_dir: Optional[str] = None) -> str:
    """The plan store: an explicit argument, else the configured
    compile-cache dir (``--compile_cache_dir``), else POSEIDON_TUNED_DIR,
    else the port's per-user default, so ``tune`` then ``train`` round
    trip with no flags."""
    if cache_dir:
        return cache_dir
    from ..config import compile_cache_config
    return (compile_cache_config().cache_dir
            or os.environ.get("POSEIDON_TUNED_DIR", "")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "poseidon_tpu_torch"))


def plan_key(model: str, backend: str, n_devices: int) -> str:
    """Content key of one plan. The device kind and the torch version are
    not in it: they are the provenance, checked at load, so a mismatch is
    a loud refusal rather than a silent miss. ``framework`` keeps the
    port's plans apart from the JAX package's in a shared store."""
    return step_key(kind=PLAN_NAMESPACE, model=model.lower(),
                    backend=backend, n_devices=int(n_devices),
                    framework=FRAMEWORK)


def plan_path(model: str, backend: str, n_devices: int,
              cache_dir: Optional[str] = None) -> str:
    return tuned_path(store_dir(cache_dir), PLAN_NAMESPACE,
                      plan_key(model, backend, n_devices))


def save_plan(doc: Dict, cache_dir: Optional[str] = None) -> Optional[str]:
    return save_tuned(store_dir(cache_dir), PLAN_NAMESPACE, doc["key"], doc)


def device_provenance(device=None) -> Dict[str, Any]:
    """(backend, device kind, device count, torch and CUDA versions) of
    ``device`` (the GPU unless given; raises without one unless the CPU
    is asked for)."""
    import torch

    from ..numeric import resolve_device
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {"backend": dev.type,
            "device_kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}


def load_plan(model: str, backend: Optional[str] = None,
              n_devices: Optional[int] = None,
              cache_dir: Optional[str] = None, device=None) -> Optional[Dict]:
    """The persisted plan for (model, backend, n_devices) on ``device``'s
    side, or None. A plan whose provenance names another device kind or
    torch version refuses to load, loudly (measured winners do not
    transfer across hardware or toolchains); any store failure is a miss
    (``compile_cache.load_tuned`` logs torn entries)."""
    prov = device_provenance(device)
    backend = backend or prov["backend"]
    n_devices = prov["n_devices"] if n_devices is None else n_devices
    doc = load_tuned(store_dir(cache_dir), PLAN_NAMESPACE,
                     plan_key(model, backend, n_devices))
    if doc is None:
        return None
    for fld in ("device_kind", "torch_version"):
        have, want = doc.get(fld), prov[fld]
        if have != want:
            log(f"[tuned_plan] REFUSING plan for {model!r}: {fld} "
                f"{have!r} != current {want!r} (tuned winners do not "
                f"transfer across hardware/toolchains — re-run "
                f"`python -m poseidon_tpu_torch tune`); using built-in "
                f"defaults")
            return None
    return doc


# --------------------------------------------------------------------------- #
# resolution: flag > plan > default, sources and overrides recorded
# --------------------------------------------------------------------------- #

@dataclass
class PlanResolution:
    """Per-knob values with their source ("flag" | "plan" | "default"),
    the plan document (if any) and the store it came from.
    ``overridden`` names the knobs where a flag shadowed a plan value
    that differs from it: the provenance records them, so a stats.yaml
    always says which measured winners were not in effect."""

    values: Dict[str, Any] = field(default_factory=dict)
    sources: Dict[str, str] = field(default_factory=dict)
    doc: Optional[Dict] = None
    store: str = ""

    @property
    def overridden(self) -> List[str]:
        knobs = (self.doc or {}).get("knobs", {})
        return [k for k, src in sorted(self.sources.items())
                if src == "flag" and k in knobs
                and knobs[k] != self.values[k]]

    def provenance(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            k: f"{self.values[k]} ({self.sources[k]})"
            for k in sorted(self.values)}
        if self.doc is not None:
            out["plan_key"] = self.doc.get("key")
            out["plan_model"] = self.doc.get("model")
            out["plan_measured_at"] = self.doc.get("measured_at")
            out["plan_device_kind"] = self.doc.get("device_kind")
            out["plan_torch_version"] = self.doc.get("torch_version")
            out["plan_cuda_version"] = self.doc.get("cuda_version")
        if self.overridden:
            out["overridden_by_flags"] = ",".join(self.overridden)
        return out

    def describe(self) -> str:
        head = ("plan " + str(self.doc.get("key"))[:12]
                if self.doc is not None else "no plan (defaults)")
        body = " ".join(f"{k}={self.values[k]}[{self.sources[k][0]}]"
                        for k in TRAIN_KNOBS if k in self.values)
        tail = (f" OVERRIDDEN: {','.join(self.overridden)}"
                if self.overridden else "")
        return f"{head}: {body}{tail}"


def resolve(doc: Optional[Dict], explicit: Dict[str, Any],
            knobs: Tuple[str, ...] = TRAIN_KNOBS,
            store: str = "") -> PlanResolution:
    """Fold the three layers into one resolution. ``explicit`` holds only
    the knobs the user set (the CLI's None sentinels keep unset flags out
    of it)."""
    res = PlanResolution(doc=doc, store=store)
    plan_knobs = (doc or {}).get("knobs", {})
    for k in knobs:
        if k in explicit and explicit[k] is not None:
            res.values[k], res.sources[k] = explicit[k], "flag"
        elif k in plan_knobs:
            res.values[k], res.sources[k] = plan_knobs[k], "plan"
        else:
            res.values[k], res.sources[k] = BUILTIN_DEFAULTS[k], "default"
    return res


# the process-wide active resolution: set by the CLI after the plan loads,
# read by numeric.resolve_conv_layout (the measured "auto" row), conv_tune
# (the per-layer store) and the engine (stats.yaml's tuned_plan section)
_active: Optional[PlanResolution] = None


def set_active_resolution(res: Optional[PlanResolution]) -> None:
    global _active
    _active = res


def active_resolution() -> Optional[PlanResolution]:
    return _active


def active_plan_value(knob: str) -> Optional[Any]:
    """The active resolution's value for ``knob`` if it came from a
    measured plan (never a flag or a default)."""
    if _active is None or _active.sources.get(knob) != "plan":
        return None
    return _active.values.get(knob)


def active_store_dir() -> str:
    """Where the active plan was loaded from (``ops/conv_tune.py`` falls
    back here, so a plan's conv_strategy="auto" finds the per-layer
    winners its tune persisted). Empty unless a plan loaded: a
    defaults-only resolution must not send conv_tune's winners into the
    directory that was merely searched."""
    if _active is None or _active.doc is None:
        return ""
    return _active.store


def apply_training_resolution(res: PlanResolution) -> Dict[str, Any]:
    """Install the resolved values where the training path reads them (the
    numeric policy for conv_layout and conv_strategy, the pipeline config,
    the managed tier's wire dtype) and publish the resolution. Returns
    the knobs the caller passes on: {arena_bucket_mb, mesh,
    steps_per_dispatch, device_prefetch, max_in_flight, remat,
    hbm_budget_gb}. Applying a plan and passing the same values as flags
    build bitwise-equal training runs."""
    from .. import config
    from ..numeric import set_policy
    v = res.values
    set_policy(conv_layout=str(v["conv_layout"]).upper())
    if v["conv_strategy"]:
        set_policy(conv_strategy=v["conv_strategy"])
    config.set_pipeline_config(device_prefetch=int(v["device_prefetch"]),
                               max_in_flight=int(v["max_in_flight"]))
    # the managed tier reads its wire dtype from ManagedCommConfig when no
    # flag rode its arguments; never returned: the compiled collectives
    # take the flag only
    config.set_managed_comm_config(wire_dtype=str(v.get("wire_dtype", "")))
    mesh = v["mesh"]
    if mesh and res.sources.get("mesh") == "plan":
        # plans are keyed by the device count, so this should not fire; a
        # copied plan degrades loudly, never deep in the engine
        from ..config import MeshConfig
        from .cluster import env_world
        world = env_world()[1]
        try:
            need = MeshConfig.parse(mesh).n_devices
        except ValueError as e:
            log(f"[tuned_plan] plan mesh {mesh!r} unparseable ({e}); "
                f"using plain data parallelism")
            mesh, res.values["mesh"], res.sources["mesh"] = "", "", "default"
        else:
            if need != world:
                log(f"[tuned_plan] plan mesh {mesh!r} needs {need} ranks, "
                    f"the job has {world}; using plain data parallelism")
                mesh, res.values["mesh"], res.sources["mesh"] = \
                    "", "", "default"
    set_active_resolution(res)
    return {"arena_bucket_mb": float(v["arena_bucket_mb"]),
            "mesh": mesh,
            "steps_per_dispatch": int(v["steps_per_dispatch"]),
            "device_prefetch": int(v["device_prefetch"]),
            "max_in_flight": int(v["max_in_flight"]),
            "remat": str(v.get("remat", "")),
            "hbm_budget_gb": float(v.get("hbm_budget_gb", 0.0))}


# --------------------------------------------------------------------------- #
# the measured-trial estimator (shared with ops/conv_tune.py)
# --------------------------------------------------------------------------- #

def interleaved_min_ms(fns: Dict[str, Callable[[], Any]],
                       windows: int = 4, iters: int = 3,
                       warmup: int = 2) -> Dict[str, float]:
    """Wall-clock ms a call per candidate: warm every candidate
    ``warmup`` times first (a first call pays builds, captures and
    allocations; none may decide a winner), then time ``windows``
    interleaved windows of ``iters`` calls each, alternating the order a
    window, and keep each candidate's best window (a window can be slowed
    by background load, never sped up). On the card each callable must
    end in ``torch.cuda.synchronize()``."""
    order = list(fns)
    for name in order:
        for _ in range(max(1, warmup)):
            fns[name]()
    best = {name: float("inf") for name in order}
    for w in range(max(1, windows)):
        seq = order if w % 2 == 0 else list(reversed(order))
        for name in seq:
            t0 = time.perf_counter()
            for _ in range(max(1, iters)):
                fns[name]()
            best[name] = min(best[name],
                             (time.perf_counter() - t0) / max(1, iters))
    return {name: v * 1e3 for name, v in best.items()}


# --------------------------------------------------------------------------- #
# the search: `tune` lands here
# --------------------------------------------------------------------------- #

TUNE_MODELS = ("lenet", "alexnet", "googlenet")

# the engine-loop A/B net of the pipeline knobs (they act on the host and
# device boundary, so they are measured through real Engine.train loops)
_PIPE_NET = """
name: "tune_pipe"
layers { name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: %d channels: 3 height: 20 width: 20 } }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 12 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "ip1" type: INNER_PRODUCT bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 10
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""

# the serving-ladder probe net when no deploy prototxt is given (the doc
# records that the probe was synthetic)
_SERVE_NET = """
name: "tune_serve_synthetic"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 24 input_dim: 24
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "fc" type: INNER_PRODUCT bottom: "conv1" top: "fc"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
"""


def search_space(smoke: bool, n_devices: int) -> Dict[str, List]:
    """The candidates of each knob (JAX's). Smoke keeps every measured
    knob at two points; the full space is what a card's tune sweeps. The
    built-in default is always a candidate."""
    return {
        "conv_layout": ["NCHW", "NHWC"],
        "conv_strategy": ["", "auto"],
        "arena_bucket_mb": [1.0, 4.0] if smoke else [1.0, 4.0, 16.0],
        "steps_per_dispatch": [1] if smoke else [1, 4],
        "pipeline": ([(0, 1), (2, 2)] if smoke
                     else [(0, 1), (2, 2), (2, 4)]),
        "serve_buckets": (["1,4", "1,2,4"] if smoke
                          else ["1,4,16,64", "1,8,32,64", "1,2,8,32,64"]),
        "mesh": _mesh_candidates(n_devices, smoke),
        "llm_page_size": [16, 64] if smoke else [16, 64, 128],
        "llm_decode_rungs": (["1,2,4,8", "1,4"] if smoke
                             else ["1,2,4,8", "1,4,8", "1,2,4,8,16"]),
        "llm_replicas_tp": _llm_factorizations(n_devices, smoke),
        "wire_dtype": ["", "bf16"] if smoke else ["", "bf16", "f16", "int8"],
        "remat_batch": ["", "auto"],
    }


def _llm_factorizations(n_devices: int, smoke: bool) -> List[str]:
    """Replica x tp candidates ("RxT"): every device a replica, or pairs
    of devices as tp2 replicas. One device (or smoke) has the trivial
    arm alone, recorded as the only candidate."""
    if n_devices <= 1 or smoke:
        return ["1x1"]
    cands = [f"{n_devices}x1"]
    if n_devices % 2 == 0:
        cands.append(f"{n_devices // 2}x2")
    return cands


def _mesh_candidates(n_devices: int, smoke: bool) -> List[str]:
    if n_devices <= 1 or smoke:
        # one device has one factorization; smoke skips the spmd arms:
        # either way the trial row records the only candidate
        return [""]
    cands = [""]
    if n_devices % 2 == 0:
        cands += [f"dp{n_devices // 2},fsdp2", f"dp{n_devices // 2},tp2"]
    return cands


def _model_setup(model: str, smoke: bool):
    """(net_param, source_shapes) of one tune target at a measurement
    batch (JAX's: AlexNet at 32 x 227², GoogLeNet at 16 x 224²; the smoke
    shapes keep the CPU tests fast)."""
    from ..models import zoo
    if model == "lenet":
        batch = 8 if smoke else 64
        return zoo.lenet(with_accuracy=False), \
            {"data": (batch, 1, 28, 28), "label": (batch,)}
    if model == "alexnet":
        batch, image = (4, 67) if smoke else (32, 227)
        return zoo.alexnet(num_classes=1000, with_accuracy=False), \
            {"data": (batch, 3, image, image), "label": (batch,)}
    if model == "googlenet":
        batch = 2 if smoke else 16
        return zoo.googlenet(num_classes=1000, with_accuracy=False), \
            {"data": (batch, 3, 224, 224), "label": (batch,)}
    raise ValueError(f"unknown tune model {model!r}; choose from "
                     f"{TUNE_MODELS}")


def _build_step_arm(net_param, shapes, conv_layout: str, arena_mb: float,
                    scan_steps: int, mesh_spec: str,
                    conv_strategy: str = "", remat: str = "",
                    measure_peak: bool = False, device=None):
    """One measured arm: the port's ``TrainStep`` under one knob
    assignment, as a zero-arg callable that runs the step and
    synchronizes (successive calls are successive steps on the step's
    arena). ``scan_steps`` K > 1 runs ``multi_step`` with
    ``reuse_batch=True``: one CUDA graph of K steps on the card. Its
    ``per_call_steps`` turns a call's time into an optimizer step's.

    ``remat="auto"`` checkpoints every eligible layer (the zero-budget
    maximal plan, ``plan_remat(layer_cost_table(net), 0, 0, ...)``); any
    other non-empty ``remat`` is a comma-joined layer list.
    ``measure_peak=True`` records ``peak_bytes``: the allocator's peak
    over one call above what it held when the arm began (so an arm is not
    billed for the other live arms' tensors); 0 on the CPU."""
    import torch

    from ..core import remat as remat_mod
    from ..core.net import Net
    from ..numeric import policy_scope, resolve_device
    from ..parallel.strategies import CommConfig
    from ..parallel.trainer import build_train_step, init_train_state
    from ..proto.messages import SolverParameter
    from .attribution import layer_cost_table

    device = resolve_device(device)
    if mesh_spec:
        raise NotImplementedError(
            f"mesh arm {mesh_spec!r}: the port's mesh runs a process a "
            f"rank, and the tune drives one process")
    cuda = device.type == "cuda"
    if cuda and measure_peak:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with policy_scope(conv_layout=conv_layout):
        net = Net(net_param, phase="TRAIN", device=device,
                  source_shapes=dict(shapes),
                  conv_strategy=conv_strategy or None)
    sp = SolverParameter(base_lr=0.01, lr_policy="fixed", momentum=0.9,
                         weight_decay=5e-4)
    comm = CommConfig(param_arena=True, bucket_mb=float(arena_mb))
    rp = None
    if remat == "auto":
        rp = remat_mod.plan_remat(
            layer_cost_table(net), 0, 0,
            candidates=remat_mod.remat_candidates(net), source="plan")
    elif remat:
        rp = remat_mod.RematPlan(
            layers=tuple(t.strip() for t in remat.split(",") if t.strip()),
            source="flag")
    k = max(1, int(scan_steps))
    ts = build_train_step(net, sp, None, comm, steps_per_dispatch=k,
                          reuse_batch=True, remat_plan=rp)
    params = net.init(torch.Generator().manual_seed(0))
    params, state = ts.load(params, init_train_state(params, comm,
                                                     ts.n_err_groups))
    rows = int(shapes["data"][0])
    gen = torch.Generator().manual_seed(0)
    data = torch.rand(tuple(shapes["data"]), generator=gen).to(device)
    if net.conv_layout == "NHWC" and data.dim() == 4:
        # NHWC arms feed channels-last, so the graph carries no entry
        # transpose
        data = data.contiguous(memory_format=torch.channels_last)
    # labels within the classifier's width (the first loss layer's
    # scores; JAX's draws from [0, 10), which its gather clamps)
    classes = next((net.blob_shapes[l.lp.bottom[0]][1] for l in net.layers
                    if l.TYPE.endswith("_LOSS") and l.lp.bottom), 10)
    batch = {"data": data,
             "label": torch.randint(0, min(10, classes), (rows,),
                                    generator=gen).to(
                 device=device, dtype=torch.float32)}
    holder = {"params": params, "state": state}
    step = ts.multi_step if k > 1 else ts.step

    def run():
        holder["params"], holder["state"], _ = step(
            holder["params"], holder["state"], batch)
        if cuda:
            torch.cuda.synchronize(device)

    run.per_call_steps = k  # type: ignore[attr-defined]
    run.global_rows = rows  # type: ignore[attr-defined]
    run.peak_bytes = 0  # type: ignore[attr-defined]
    if measure_peak and cuda:
        run()
        run.peak_bytes = int(  # type: ignore[attr-defined]
            torch.cuda.max_memory_allocated(device) - base)
    return run


def _measure_step_knob(net_param, shapes, current: Dict[str, Any],
                       knob: str, candidates: List, windows: int,
                       iters: int, device=None) -> Dict[str, float]:
    """One step-level knob's candidates, every other knob at its current
    best; ms are per optimizer step."""
    arms: Dict[str, Callable] = {}
    for cand in candidates:
        cfg = dict(current)
        cfg[knob] = cand
        arms[str(cand)] = _build_step_arm(
            net_param, shapes,
            conv_layout=cfg["conv_layout"],
            arena_mb=float(cfg["arena_bucket_mb"]),
            scan_steps=int(cfg["steps_per_dispatch"]),
            mesh_spec=cfg.get("mesh", ""),
            conv_strategy=cfg.get("conv_strategy", ""), device=device)
    raw = interleaved_min_ms(arms, windows=windows, iters=iters)
    return {name: round(raw[name] / arms[name].per_call_steps, 4)
            for name in raw}


def _measure_remat_batch(net_param, shapes, current: Dict[str, Any],
                         windows: int, iters: int,
                         max_doublings: int = 3,
                         device=None) -> Dict[str, Any]:
    """The (remat, batch_size) pair at a fixed byte budget (JAX's): the
    budget is the no-remat default-batch step's measured peak above its
    start. For each remat policy ('' stored, 'auto' maximal) the largest
    admissible batch is found by doubling from the default while the
    measured peak stays within the budget (at most ``max_doublings``,
    recorded); the arms then race on img/s. Remat wins only when the
    batch it buys beats the default's throughput.

    Returns {"remat", "batch_size", "hbm_budget_gb", "trial"}."""
    def make(policy: str, batch: int, measure_peak: bool):
        s = dict(shapes)
        s["data"] = (batch,) + tuple(shapes["data"][1:])
        s["label"] = (batch,)
        return _build_step_arm(
            net_param, s, current["conv_layout"],
            float(current["arena_bucket_mb"]), 1, "",
            current.get("conv_strategy", ""), remat=policy,
            measure_peak=measure_peak, device=device)

    base_batch = int(shapes["data"][0])
    base = make("", base_batch, True)
    budget = int(base.peak_bytes)
    trial: Dict[str, Any] = {
        "budget_bytes": budget, "base_batch": base_batch,
        "max_doublings": max_doublings, "arms": {}}
    if budget <= 0:
        # no allocator peak on this backend: nothing to plan against, the
        # default wins by fiat, and the doc says why
        trial["note"] = ("the allocator reported no peak; remat/batch not "
                         "measured on this backend")
        return {"remat": "", "batch_size": 0, "hbm_budget_gb": 0.0,
                "trial": trial}
    best: Dict[str, Tuple[int, Any]] = {}
    for policy in ("", "auto"):
        b, arm = base_batch, (base if not policy
                              else make(policy, base_batch, True))
        if arm.peak_bytes > budget and policy:
            trial["arms"][policy or "default"] = {
                "batch": base_batch, "peak_bytes": int(arm.peak_bytes),
                "admissible": False}
            continue
        for _ in range(max_doublings):
            nxt = make(policy, b * 2, True)
            if nxt.peak_bytes > budget:
                del nxt
                break
            b, arm = b * 2, nxt
        best[policy] = (b, arm)
        trial["arms"][policy or "default"] = {
            "batch": b, "peak_bytes": int(arm.peak_bytes),
            "admissible": True}
    fns = {(p or "default"): arm for p, (b, arm) in best.items()}
    raw = interleaved_min_ms(fns, windows=windows, iters=iters)
    imgs = {}
    for p, (b, arm) in best.items():
        name = p or "default"
        ms = raw[name] / arm.per_call_steps
        imgs[name] = arm.global_rows / max(ms, 1e-9) * 1e3  # img/s
        trial["arms"][name].update(step_ms=round(ms, 4),
                                   img_per_s=round(imgs[name], 1))
    winner = max(imgs, key=imgs.get)
    default_ips = imgs.get("default", 0.0)
    if winner != "default" and imgs[winner] <= default_ips:
        winner = "default"
    trial["winner"] = winner
    trial["speedup"] = round(imgs[winner] / max(default_ips, 1e-9), 4)
    policy = "" if winner == "default" else winner
    # the budget ships only with a winning remat row (a default win must
    # not make every later train run pay the measuring pass for an
    # identity plan; the trial keeps budget_bytes either way)
    return {"remat": policy,
            "batch_size": int(best[policy][0]) if policy in best
            else base_batch,
            "hbm_budget_gb": (round(budget / 2**30, 6) if policy
                              else 0.0),
            "trial": trial}


def _measure_pipeline_knob(candidates: List[Tuple[int, int]], windows: int,
                           iters: int, device=None) -> Dict[str, float]:
    """Engine-loop wall an iteration for (device_prefetch, max_in_flight)
    candidates, through real ``Engine.train`` loops over a small
    MEMORY_DATA net (the knobs act where the host blocks, which a bare
    step cannot show); interleaved windows, the best of each. Every
    engine closes (its threads join) before this returns."""
    import shutil
    import tempfile

    import numpy as np

    from ..proto.messages import SolverParameter, load_net_from_string
    from .engine import Engine

    rs = np.random.RandomState(0)
    md = {"data": rs.randn(256, 3, 20, 20).astype(np.float32),
          "label": rs.randint(0, 10, 256)}
    net_param = load_net_from_string(_PIPE_NET % 8)
    engines: Dict[str, Any] = {}
    scratch = tempfile.mkdtemp(prefix="tune_pipe_")
    try:
        for pf, mif in candidates:
            sp = SolverParameter(train_net_param=net_param, base_lr=0.01,
                                 lr_policy="fixed", momentum=0.9, display=0,
                                 max_iter=0, random_seed=3)
            out_dir = os.path.join(scratch, f"{pf}_{mif}")
            os.makedirs(out_dir, exist_ok=True)
            eng = Engine(sp, memory_data=md, output_dir=out_dir,
                         device=device, device_prefetch=pf,
                         max_in_flight=mif)
            eng._write_artifacts = lambda: None   # disk noise off the clock
            engines[f"{pf},{mif}"] = eng
        done = {name: 0 for name in engines}
        for name, eng in engines.items():        # warm: build + fill
            eng.train(max_iter=2)
            done[name] = 2
        best = {name: float("inf") for name in engines}
        order = list(engines)
        for w in range(max(1, windows)):
            seq = order if w % 2 == 0 else list(reversed(order))
            for name in seq:
                eng = engines[name]
                t0 = time.perf_counter()
                # train() ends with a hard sync: the window's steps ran
                eng.train(max_iter=done[name] + iters)
                best[name] = min(best[name],
                                 (time.perf_counter() - t0) / iters)
                done[name] += iters
        return {name: round(v * 1e3, 4) for name, v in best.items()}
    finally:
        for eng in engines.values():
            eng.close()
        shutil.rmtree(scratch, ignore_errors=True)


def _measure_serve_knob(candidates: List[str], windows: int, iters: int,
                        deploy: str = "", device=None) -> Dict[str, float]:
    """Mean request wall (ms) a bucket ladder: every ladder serves the same
    request-size sweep (1..max rows) through a warmed
    ``BucketedExecutor`` (each request returns host arrays, so it ends
    synchronized). The deploy prototxt when given, else the synthetic
    probe net."""
    import numpy as np
    import torch

    from ..core.net import Net
    from ..proto.messages import load_net, load_net_from_string
    from ..serving.executor import BucketedExecutor, parse_buckets

    net_param = (load_net(deploy) if deploy
                 else load_net_from_string(_SERVE_NET))
    net = Net(net_param, "TEST", device=device)
    params = net.init(torch.Generator().manual_seed(0))
    name = net.input_names[0]
    row_shape = tuple(net.blob_shapes[name][1:])
    max_rows = max(parse_buckets(spec)[-1] for spec in candidates)
    frames = np.random.RandomState(0).randn(
        max_rows, *row_shape).astype(np.float32)
    arms: Dict[str, Callable] = {}
    n_requests: Dict[str, int] = {}
    for spec in candidates:
        ex = BucketedExecutor(net, params, buckets=parse_buckets(spec))
        sizes = list(range(1, ex.max_batch + 1))
        n_requests[spec] = len(sizes)

        def run(ex=ex, sizes=sizes):
            for n in sizes:
                ex.infer({name: frames[:n]})

        arms[spec] = run
    raw = interleaved_min_ms(arms, windows=windows, iters=iters, warmup=1)
    return {spec: round(raw[spec] / n_requests[spec], 4) for spec in raw}


def _llm_devices(reps: int, tp: int, device) -> List[List]:
    """The devices of each of ``reps`` replicas of ``tp`` shards: one
    device a shard, in order (the CPU: every shard on it)."""
    import torch
    if device.type != "cuda":
        return [[device] * tp for _ in range(reps)]
    n = torch.cuda.device_count()
    if reps * tp > n:
        raise ValueError(f"{reps}x{tp} needs {reps * tp} devices, "
                         f"{n} present")
    return [[torch.device("cuda", r * tp + t) for t in range(tp)]
            for r in range(reps)]


def _measure_llm_knob(arm_specs: Dict[str, Tuple[int, str, int, int]],
                      windows: int, iters: int,
                      device=None) -> Dict[str, float]:
    """ms a generated token at deep overload for each LM serving arm.

    ``arm_specs``: name -> (page_size, decode_rungs, replicas, tp). Every
    arm serves the same burst of concurrent generate requests (more than
    any rung holds: the saturated end of the offered-load curve) through
    real ``ContinuousScheduler``s (``GenerateExecutor.make_batcher``) over
    a tiny probe transformer; tp > 1 arms shard each replica over tp
    devices. Every request returns host tokens, so a call ends
    synchronized. Every worker thread joins and every scheduler closes."""
    import threading

    import numpy as np
    import torch

    from ..config import MeshConfig
    from ..models.transformer import TransformerConfig, init_params
    from ..numeric import resolve_device
    from ..serving.continuous import GenerateExecutor, parse_rungs

    device = resolve_device(device)
    cfg = TransformerConfig(vocab_size=128, d_model=32, n_heads=4,
                            n_layers=2, d_ff=128, max_seq=256)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    p_len, max_new, n_req = 8, 8, 12
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(n_req, p_len)).astype(np.int32)
    arms: Dict[str, Callable] = {}
    all_scheds = []
    try:
        for aname, (page, rungs, reps, tp) in arm_specs.items():
            scheds = []
            for devs in _llm_devices(int(reps), int(tp), device):
                kw = ({"mesh_cfg": MeshConfig(data=1, fsdp=1, tp=int(tp)),
                       "devices": tuple(devs)} if int(tp) > 1
                      else {"device": devs[0]})
                ex = GenerateExecutor(
                    cfg, params, page_size=int(page),
                    decode_rungs=parse_rungs(rungs), prompt_buckets=(p_len,),
                    max_seq_len=cfg.max_seq, default_max_new=max_new, **kw)
                scheds.append(ex.make_batcher(max_queue=n_req))
                all_scheds.append(scheds[-1])

            def run(scheds=scheds):
                errs: List[BaseException] = []

                def worker(i):
                    try:
                        scheds[i % len(scheds)].submit(
                            {"prompt": prompts[i], "max_new": max_new},
                            timeout_s=120.0)
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        errs.append(e)

                ts = [threading.Thread(target=worker, args=(i,))
                      for i in range(n_req)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                if errs:
                    raise errs[0]

            arms[aname] = run
        raw = interleaved_min_ms(arms, windows=windows, iters=iters,
                                 warmup=1)
    finally:
        for s in all_scheds:
            s.close(drain=False, timeout_s=5.0)
    per_tok = n_req * max_new
    return {name: round(raw[name] / per_tok, 4) for name in raw}


def _measure_wire_knob(candidates: List[str], windows: int, iters: int,
                       link_mbps: float = 8.0, side: int = 96,
                       clocks: int = 4, staleness: int = 0
                       ) -> Dict[str, float]:
    """Wall time of a fixed push/gate cadence per wire dtype over a
    throttled loopback link (``FaultProxy``'s token bucket): the
    operating point where wire compression pays its encode cost back.
    Each arm drives its own ``ParamService`` through its own throttled
    proxy with an ``AsyncSSPClient`` of that dtype. The sync point is the
    service: the applied clock is polled until every push landed (push()
    is asynchronous and a one-worker gate never waits on its own clock).
    The '' (f32) default is always a candidate. Every client, proxy and
    service closes before this returns."""
    import numpy as np

    from ..parallel.async_ssp import AsyncSSPClient, ParamService
    from .faults import FaultProxy, FaultRule

    rate_bps = link_mbps * 1e6 / 8.0
    params = {"fc": {"w": np.zeros((side, side), np.float32)}}
    arms: Dict[str, Callable] = {}
    closers = []
    try:
        for wd in candidates:
            svc = ParamService(params, n_workers=1)
            closers.append(svc)
            proxy = FaultProxy(("127.0.0.1", svc.port))
            closers.append(proxy)
            # burst far below one frame, so transfer time tracks bytes
            proxy.add_rule(FaultRule(action="throttle", rate_bps=rate_bps,
                                     burst_bytes=8192))
            # no budget: every push is a full (still wire-compressed)
            # flush, so the arm measures the dtype's bytes over the link
            cli = AsyncSSPClient(0, proxy.addr, staleness, n_workers=1,
                                 wire_dtype=wd)
            closers.append(cli)
            rng = np.random.RandomState(11)
            state = {"clock": 0}

            def run(cli=cli, svc=svc, rng=rng, state=state):
                for _ in range(clocks):
                    state["clock"] += 1
                    cli.push({"fc": {"w": rng.randn(side, side)
                                     .astype(np.float32) * 1e-3}})
                    cli.gate(state["clock"])
                deadline = time.monotonic() + 60.0
                while svc.clocks.get(0, -1) < state["clock"] - 1:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "wire-knob arm: pushes not applied")
                    time.sleep(0.001)

            arms[wd or "f32"] = run
        return interleaved_min_ms(arms, windows=windows, iters=iters,
                                  warmup=1)
    finally:
        # clients first, then their proxies, then the services
        for obj in closers[2::3] + closers[1::3] + closers[0::3]:
            obj.close()


def _conv_strategy_rows(net_param, shapes, conv_layout: str,
                        cache_dir: str, device=None) -> Dict[str, Dict]:
    """Run the per-layer conv tuner for this model (persisting the winners
    into this plan's store, so a plan's conv_strategy="auto" memo-hits)
    and return each conv layer's decision."""
    from .. import config
    from ..core.net import Net
    from ..numeric import policy_scope
    from ..ops import conv_tune

    saved = config.compile_cache_config().cache_dir
    config.set_compile_cache_config(cache_dir=cache_dir)
    try:
        with policy_scope(conv_layout=conv_layout):
            net = Net(net_param, phase="TRAIN", device=device,
                      source_shapes=dict(shapes), conv_strategy="auto")
        rows: Dict[str, Dict] = {}
        for layer in net.layers:
            if layer.TYPE != "CONVOLUTION":
                continue
            n, c, h, w = net.blob_shapes[layer.lp.bottom[0]]
            doc = conv_tune.resolve(       # memo hit: the Net measured it
                layer.name, c, h, w, layer.kernel, layer.stride, layer.pad,
                layer.group, layer.params[0].shape[0], net.conv_layout, n,
                cache_dir=cache_dir, device=net.device)
            rows[layer.name] = {"winner": doc["winner"],
                                "source": doc.get("source"),
                                "timings_ms": doc.get("timings_ms", {})}
        return rows
    finally:
        config.set_compile_cache_config(cache_dir=saved)


def _builtin_layout(backend: str) -> str:
    """The built-in per-backend row: the default arm every conv_layout
    trial measures against."""
    from ..numeric import resolve_conv_layout
    return resolve_conv_layout("auto", backend=backend, consult_plan=False)


def run_tune(model: str, *, smoke: bool = False, force: bool = False,
             cache_dir: Optional[str] = None, deploy: str = "",
             windows: Optional[int] = None, iters: Optional[int] = None,
             net_param=None, source_shapes=None,
             knobs: Optional[List[str]] = None, device=None
             ) -> Dict[str, Any]:
    """The tune search on ``device`` (the GPU unless the CPU is asked
    for): short measured trials over the policy space, one persisted
    plan with provenance. Returns ``{"doc", "source", "path", "store"}``
    where source is "persisted" (a valid plan for this model, backend,
    device count, device kind and torch version exists: no measurement)
    or "measured".

    ``net_param``/``source_shapes`` tune a programmatic net under
    ``model`` as the plan's name; ``knobs`` restricts the measured subset
    (restrictions are recorded in the doc's ``skipped``)."""
    from ..numeric import resolve_device

    device = resolve_device(device)
    prov = device_provenance(device)
    backend, kind = prov["backend"], prov["device_kind"]
    n_devices = prov["n_devices"]
    store = store_dir(cache_dir)
    key = plan_key(model, backend, n_devices)

    if not force:
        doc = load_plan(model, backend, n_devices, cache_dir=store,
                        device=device)
        if doc is not None:
            log(f"[tune] {model}/{backend}: plan {key[:12]} already "
                f"persisted (measured {doc.get('measured_at')}); "
                f"memo-hit, skipping re-measurement (--force re-tunes)")
            return {"doc": doc, "source": "persisted", "store": store,
                    "path": tuned_path(store, PLAN_NAMESPACE, key)}

    t_start = time.perf_counter()
    if net_param is None:
        net_param, source_shapes = _model_setup(model, smoke)
    windows = windows if windows is not None else (2 if smoke else 4)
    iters = iters if iters is not None else (2 if smoke else 4)
    space = search_space(smoke, n_devices)
    wanted = list(knobs) if knobs else list(space)
    skipped = {k: "restricted by knobs argument"
               for k in space if k not in wanted}
    trials: Dict[str, Dict] = {}
    current: Dict[str, Any] = {
        "conv_layout": _builtin_layout(backend),
        "conv_strategy": "",
        "arena_bucket_mb": BUILTIN_DEFAULTS["arena_bucket_mb"],
        "steps_per_dispatch": BUILTIN_DEFAULTS["steps_per_dispatch"],
        "mesh": "",
    }
    default_cfg = dict(current)

    def note(knob, cands, timings, winner, source):
        trials[knob] = {"candidates": [str(c) for c in cands],
                        "timings_ms": timings, "winner": str(winner),
                        "source": source}
        ranked = ", ".join(f"{n}={timings[n]}ms"
                           for n in sorted(timings, key=timings.get))
        log(f"[tune] {model}.{knob}: -> {winner} [{source}]"
            + (f" ({ranked})" if ranked else ""))

    # ---- step-level knobs, greedy coordinate order ---------------------- #
    for knob, cands in (("conv_layout", space["conv_layout"]),
                        ("arena_bucket_mb", space["arena_bucket_mb"]),
                        ("steps_per_dispatch",
                         space["steps_per_dispatch"]),
                        ("mesh", space["mesh"])):
        if knob in skipped:
            continue
        if knob == "mesh" and len(cands) > 1:
            # the port's mesh arms run a process a rank; the tune is one
            # process: the flat arm is the only one it can measure here,
            # and the row says so
            current[knob] = cands[0]
            note(knob, cands, {}, cands[0],
                 "only-candidate (the spmd arms run a process a rank; "
                 "tune drives one)")
            continue
        if len(cands) == 1:
            current[knob] = cands[0]
            note(knob, cands, {}, cands[0],
                 "only-candidate" + (" (smoke skips the spmd arms)"
                                     if knob == "mesh" and n_devices > 1
                                     else ""))
            continue
        timings = _measure_step_knob(net_param, source_shapes, current,
                                     knob, cands, windows, iters,
                                     device=device)
        winner_s = min(timings, key=timings.get)
        current[knob] = next(c for c in cands if str(c) == winner_s)
        note(knob, cands, timings, current[knob], "measured")

    # ---- per-layer conv strategy (the conv tuner, one plan row) --------- #
    if "conv_strategy" not in skipped:
        if any(lp.canonical_type() == "CONVOLUTION"
               for lp in net_param.layers):
            rows = _conv_strategy_rows(net_param, source_shapes,
                                       current["conv_layout"], store,
                                       device=device)
            current["conv_strategy"] = "auto"
            trials["conv_strategy"] = {
                "candidates": ["", "auto"], "winner": "auto",
                "source": "measured-per-layer", "per_layer": rows}
            log(f"[tune] {model}.conv_strategy: -> auto (per-layer: "
                + ", ".join(f"{k}={v['winner']}" for k, v in rows.items())
                + ")")
        else:
            skipped["conv_strategy"] = "model has no conv layers"

    # ---- composite default-vs-tuned full-step A/B ----------------------- #
    if any(current[k] != default_cfg[k] for k in default_cfg):
        from .. import config
        saved_cc = config.compile_cache_config().cache_dir
        if current["conv_strategy"]:
            # the tuned arm's Net(conv_strategy="auto") must memo-hit the
            # winners persisted above, not measure inside the A/B
            config.set_compile_cache_config(cache_dir=store)
        try:
            arms = {
                "default": _build_step_arm(
                    net_param, source_shapes, default_cfg["conv_layout"],
                    float(default_cfg["arena_bucket_mb"]),
                    int(default_cfg["steps_per_dispatch"]),
                    default_cfg["mesh"], default_cfg["conv_strategy"],
                    device=device),
                "tuned": _build_step_arm(
                    net_param, source_shapes, current["conv_layout"],
                    float(current["arena_bucket_mb"]),
                    int(current["steps_per_dispatch"]),
                    current["mesh"], current["conv_strategy"],
                    device=device),
            }
        finally:
            config.set_compile_cache_config(cache_dir=saved_cc)
        raw = interleaved_min_ms(arms, windows=max(windows, 3), iters=iters)
        d_ms = raw["default"] / arms["default"].per_call_steps
        t_ms = raw["tuned"] / arms["tuned"].per_call_steps
        del arms
        ab = {"default_step_ms": round(d_ms, 4),
              "tuned_step_ms": round(t_ms, 4),
              "speedup": round(d_ms / max(t_ms, 1e-9), 4),
              "reverted": False}
        if ab["speedup"] < 1.0:
            # a cost-based optimizer never ships a plan it measured slower
            # than the defaults: revert the step knobs, keep the record
            log(f"[tune] {model}: composite tuned arm measured "
                f"{ab['speedup']}x vs defaults — REVERTING step knobs to "
                f"built-in defaults (per-knob wins did not compose)")
            ab.update(raw_speedup=ab["speedup"], reverted=True, speedup=1.0)
            current.update(default_cfg)
    else:
        ab = {"speedup": 1.0,
              "note": "every measured winner equals the built-in default; "
                      "the arms are the same program"}

    # ---- engine-loop pipeline knobs ------------------------------------- #
    pf = BUILTIN_DEFAULTS["device_prefetch"]
    mif = BUILTIN_DEFAULTS["max_in_flight"]
    if "pipeline" not in skipped:
        timings = _measure_pipeline_knob(space["pipeline"], windows, iters,
                                         device=device)
        winner_s = min(timings, key=timings.get)
        pf, mif = (int(tok) for tok in winner_s.split(","))
        note("pipeline", space["pipeline"], timings, winner_s, "measured")

    # ---- serving bucket ladder ------------------------------------------ #
    serve_buckets = BUILTIN_DEFAULTS["serve_buckets"]
    if "serve_buckets" not in skipped:
        timings = _measure_serve_knob(space["serve_buckets"], windows,
                                      iters, deploy=deploy, device=device)
        serve_buckets = min(timings, key=timings.get)
        note("serve_buckets", space["serve_buckets"], timings,
             serve_buckets,
             "measured" + ("" if deploy else " (synthetic probe net)"))

    # ---- managed wire dtype ---------------------------------------------- #
    wire_dtype = str(BUILTIN_DEFAULTS["wire_dtype"])
    if "wire_dtype" not in skipped:
        cands = space["wire_dtype"]
        timings = _measure_wire_knob(cands, windows, iters)
        winner_s = min(timings, key=timings.get)
        wire_dtype = next(c for c in cands if (c or "f32") == winner_s)
        note("wire_dtype", [c or "f32" for c in cands], timings,
             wire_dtype or "f32",
             "measured (throttled loopback; f32 default always a "
             "candidate)")

    # ---- the memory budget: the (remat, batch_size) pair ---------------- #
    remat = str(BUILTIN_DEFAULTS["remat"])
    tuned_batch = int(BUILTIN_DEFAULTS["batch_size"])
    hbm_gb = float(BUILTIN_DEFAULTS["hbm_budget_gb"])
    if "remat_batch" not in skipped:
        rb = _measure_remat_batch(net_param, source_shapes, current,
                                  windows, iters, device=device)
        remat, tuned_batch = rb["remat"], rb["batch_size"]
        hbm_gb = rb["hbm_budget_gb"]
        arms_rb = rb["trial"].get("arms", {})
        note("remat_batch", list(arms_rb),
             {n: a.get("step_ms", 0.0) for n, a in arms_rb.items()
              if "step_ms" in a},
             f"{remat or 'default'}@batch{tuned_batch or '-'}",
             "measured (img/s at fixed measured-peak budget)")
        trials["remat_batch"].update(rb["trial"])  # the per-arm rows

    # ---- LM serving: page size, rung ladder, replica x tp ---------------- #
    llm_page = int(BUILTIN_DEFAULTS["llm_page_size"])
    llm_rungs = str(BUILTIN_DEFAULTS["llm_decode_rungs"])
    llm_rt = str(BUILTIN_DEFAULTS["llm_replicas_tp"])
    if "llm_page_size" not in skipped:
        cands = space["llm_page_size"]
        timings = _measure_llm_knob(
            {str(p): (p, llm_rungs, 1, 1) for p in cands}, windows, iters,
            device=device)
        llm_page = int(min(timings, key=timings.get))
        note("llm_page_size", cands, timings, llm_page, "measured")
    if "llm_decode_rungs" not in skipped:
        cands = space["llm_decode_rungs"]
        timings = _measure_llm_knob(
            {r: (llm_page, r, 1, 1) for r in cands}, windows, iters,
            device=device)
        llm_rungs = min(timings, key=timings.get)
        note("llm_decode_rungs", cands, timings, llm_rungs, "measured")
    if "llm_replicas_tp" not in skipped:
        cands = space["llm_replicas_tp"]
        if len(cands) == 1:
            llm_rt = cands[0]
            note("llm_replicas_tp", cands, {}, llm_rt,
                 "only-candidate" + (" (smoke skips the fleet arms)"
                                     if smoke and n_devices > 1 else ""))
        else:
            specs = {}
            for c in cands:
                reps, tp = (int(t) for t in c.split("x"))
                specs[c] = (llm_page, llm_rungs, reps, tp)
            timings = _measure_llm_knob(specs, windows, iters,
                                        device=device)
            llm_rt = min(timings, key=timings.get)
            note("llm_replicas_tp", cands, timings, llm_rt, "measured")

    search_cost_s = round(time.perf_counter() - t_start, 2)
    doc = {
        "version": PLAN_VERSION,
        "model": model.lower(),
        "framework": FRAMEWORK,
        "backend": backend,
        "device_kind": kind,
        "torch_version": prov["torch_version"],
        "cuda_version": prov["cuda_version"],
        "n_devices": n_devices,
        "key": key,
        "smoke": smoke,
        "knobs": {
            "conv_layout": current["conv_layout"],
            "conv_strategy": current["conv_strategy"],
            "arena_bucket_mb": float(current["arena_bucket_mb"]),
            "steps_per_dispatch": int(current["steps_per_dispatch"]),
            "mesh": current["mesh"],
            "device_prefetch": int(pf),
            "max_in_flight": int(mif),
            "serve_buckets": serve_buckets,
            "llm_page_size": llm_page,
            "llm_decode_rungs": llm_rungs,
            # prompt buckets ride the defaults (the prompt-length
            # distribution is workload data no probe stands in for)
            "llm_prompt_buckets": str(BUILTIN_DEFAULTS["llm_prompt_buckets"]),
            "llm_replicas_tp": llm_rt,
            "wire_dtype": wire_dtype,
            "remat": remat,
            "batch_size": tuned_batch,
            "hbm_budget_gb": hbm_gb,
        },
        "trials": trials,
        "ab": ab,
        "search_space": {k: [str(c) for c in v] for k, v in space.items()},
        "skipped": skipped,
        "search_cost_s": search_cost_s,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    path = save_plan(doc, cache_dir=store)
    log(f"[tune] {model}/{backend}/{kind}: plan {key[:12]} persisted to "
        f"{path} ({search_cost_s}s search"
        + (f", skipped: {skipped}" if skipped else "") + ")")
    return {"doc": doc, "source": "measured", "store": store, "path": path}
