"""Command line of the port (the commands of ``poseidon_tpu/runtime/
cli.py``)::

    python -m poseidon_tpu_torch train --solver=<solver.prototxt> \\
        [--snapshot=<.solverstate.npz>|auto] [--weights=<.caffemodel>] \\
        [--output_dir .] [--device cuda|cpu] [--strategy dense|sfb|topk] \\
        [--sfb-auto] [--grad-reduce mean|sum] [--wire_dtype f32|bf16|f16] \\
        [--topk_policy magnitude|random|fixed_order] [--topk_block N] \\
        [--dcn_slices N] [--mesh dpD,fsdpF,tpT[,replicated]] [--staleness S] \\
        [--server_logic inc|adarevision] [--adarev_init_step X] \\
        [--async_ssp [--slice] [--async_sync_every N] \\
         [--comm_budget_mbps X] \\
         [--comm_priority_frac X] [--comm_adaptive] \\
         [--async_{heartbeat,liveness_timeout,reconnect_deadline,\\
                   gate_timeout,first_gate_timeout}_s X]] \\
        [--dwbp_bucket_mb N] [--param_arena true|false] \\
        [--arena_bucket_mb N] [--device_prefetch N] [--max_in_flight N] \\
        [--async_snapshot] [--device_transform] [--trace_out <file>] \\
        [--bf16] [--conv_layout nchw|nhwc|auto] \\
        [--conv_strategy auto|direct|im2col|s2d] [--steps_per_dispatch K] \\
        [--remat auto|none|L1,L2 [--hbm_budget_gb G]] [--profile N] \\
        [--tuned_plan auto|off] [--compile_cache_dir D] \\
        [--aot_steps true|false] [--census] \\
        [--metrics_port P] [--hostfile <file> --node_id N]
    python -m poseidon_tpu_torch tune [--model lenet|alexnet|googlenet] \\
        [--smoke] [--force] [--deploy <deploy.prototxt>] [--windows W] \\
        [--iters I] [--out <plan.json>] [--compile_cache_dir D] \\
        [--device cuda|cpu]
    python -m poseidon_tpu_torch test --model=<train_val.prototxt> \\
        [--weights=<.caffemodel>] [--iterations 50] [--device cuda|cpu] \\
        [--hostfile <file> --node_id N]
    python -m poseidon_tpu_torch time --model=<net.prototxt> \\
        [--iterations 50] [--batch_size 64] [--per_layer \\
         [--comm_devices N [--dcn_slices S]] [--strategy dense|sfb|topk] \\
         [--sfb-auto] [--wire_dtype f32|bf16|f16] [--topk_block N]] \\
        [--device cuda|cpu]
    python -m poseidon_tpu_torch device_query [--device cpu]
    python -m poseidon_tpu_torch convert_imageset <listfile> <out_db> \\
        [--root_folder D] [--resize_height H --resize_width W] [--shuffle] \\
        [--gray]
    python -m poseidon_tpu_torch compute_image_mean <db> <out.binaryproto>
    python -m poseidon_tpu_torch partition_data <db> <num_shards>
    python -m poseidon_tpu_torch convert_db <src> <out> [--backend LMDB|LEVELDB]
    python -m poseidon_tpu_torch extract_features --model=<net.prototxt> \\
        --blobs fc7[,...] --out_prefix <prefix> [--weights=<.caffemodel>] \\
        [--num_batches 10] [--device cuda|cpu] [--hostfile <file> --node_id N]
    python -m poseidon_tpu_torch serve --model=<deploy.prototxt> \\
        [--weights=<.caffemodel|.solverstate.npz>] [--buckets 1,4,16,64] \\
        [--tuned_plan auto|off] [--compile_cache_dir D] \\
        [--host 127.0.0.1] [--port 0] [--max_delay_ms 5] [--max_queue 64] \\
        [--deadline_ms 0] [--watch <prefix>|auto] [--poll_s 1] \\
        [--replicas N] [--devices 0,0] [--metrics_port P] [--device cuda|cpu]
    python -m poseidon_tpu_torch serve --generate --model tiny|gpt_small \\
        [--tuned_plan auto|off] [--host 127.0.0.1] [--port 0] \\
        [--max_queue 64] [--deadline_ms 0] \\
        [--replicas N] [--devices 0,0] [--metrics_port P] [--device cuda|cpu]
    python -m poseidon_tpu_torch bench_serve [--model <deploy.prototxt>] \\
        [--weights ...] [--buckets 1,4,16,64] [--tuned_plan auto|off] \\
        [--compile_cache_dir D] [--requests 200] \\
        [--concurrency 4] [--batch 8] [--replicas N] [--devices ...] \\
        [--offered_rps R] [--device cuda|cpu]

``train`` runs the solver on one GPU and writes the snapshots and the
``<net>_train_outputs.csv`` / ``<net>_test<i>_outputs.csv`` files under
``--output_dir``, through the pipelined loop: LMDB data through the
native C++ batcher (``g++`` builds it at first use into
``build/poseidon_tpu_torch/``), ``--device_prefetch`` batches staged on the
card ahead of the step, ``--max_in_flight`` steps dispatched before the
oldest one's metrics are read, snapshots written in the background under
``--async_snapshot``, uint8 batches normalized on the card under
``--device_transform``, and a Chrome trace of the host spans under
``--trace_out``. ``--bf16`` trains under the perf numeric policy
(``numeric.set_perf_policy``: bfloat16 activations and conv/GEMM operands,
f32 parameters, momentum and update, the space-to-depth stem);
``--conv_layout`` plans the CNN graph NCHW or NHWC (channels-last), unset
meaning "auto" (NHWC on the card, NCHW on the CPU), and
``--conv_strategy`` forces a conv lowering net-wide ("auto": a measured
winner a conv layer, ``ops/conv_tune.py``). The policy holds for
the command and is restored when it returns. ``--tuned_plan auto`` (the
default) loads the persisted plan of the train net (``tune``'s,
``runtime/tuned_plan.py``, from ``--compile_cache_dir`` or the default
store) and resolves every policy knob flag > plan > built-in default; the
unset flags (``--conv_layout``, ``--conv_strategy``, ``--arena_bucket_mb``,
``--mesh``, ``--device_prefetch``, ``--max_in_flight``,
``--steps_per_dispatch``, ``--wire_dtype``, ``--remat``,
``--hbm_budget_gb``) take the plan's values; ``off`` skips the store.
``--compile_cache_dir D`` also makes ``D/kernels/`` the kernel store (the
kernel libraries and the data plane build and load there), and with
``--aot_steps true`` (the default) the engine keys its step and builds or
loads every kernel library before the first step
(``runtime/compile_cache.py``). ``--census`` records the first train
step under the op census and writes ``<output_dir>/census.json``: the
collectives it really sent, its layout conversions and dtypes
(``runtime/hlo_comm.py``, ``runtime/hlo_layout.py``).
``--profile N`` traces N single steps from the third with
``torch.profiler`` into ``<output_dir>/profile/`` and prints the
per-layer attribution table (``runtime/attribution.py``).
Data-parallel runs start one ``train`` process per rank under the env
contract of ``runtime/cluster.py`` (``POSEIDON_PROC_ID``,
``POSEIDON_NUM_PROCS``, ``POSEIDON_COORDINATOR``; ``scripts/launch.py``'s
``launch_local(..., program=[python, "-m", "poseidon_tpu_torch"])`` sets
them), with the comm flags of the JAX ``train`` command that the port
covers: TOPK at the JAX default fraction 0.01 (``--topk_policy``,
``--topk_block``) and the two-tier group (``--dcn_slices``) among them.
``--staleness S`` trains by SSP (each rank's local steps, the deltas
folded into the anchor every S+1 iterations; ``--server_logic
adarevision`` folds raw gradient sums by the delay-corrected AdaGrad
rule). ``--async_ssp`` trains by the wait-free async tier instead: no
process group, rank 0 hosts the parameter service (at
``POSEIDON_ASYNC_SERVICE=host:port``, or the coordinator's port + 1), the
reads gated on ``--staleness``, every connection authenticated by HMAC
when ``POSEIDON_ASYNC_TOKEN`` is set, managed communication under
``--comm_budget_mbps``, and ``--wire_dtype bf16|f16|int8`` compressing
the deltas with exact error feedback. ``--mesh dp2,fsdp2,tp1`` trains
over the named SPMD mesh (``parallel/spmd.py``: one rank a device, the
world exactly the mesh's size; the fsdp-sharded arena buckets of
``--arena_bucket_mb``, column/row tensor-parallel FC layers; a trailing
``replicated`` runs the control arm; the fsdp arm keeps the full buffers
on every rank, so it saves no memory: only the ``sharded_state`` API of
``SpmdTrainStep`` holds 1/F a rank) and composes with ``--staleness``
(the fsdp delta exchange) but not with ``--dcn_slices``. ``--async_ssp
--slice [--mesh M]`` trains by the two-tier fabric (``parallel/fabric.py``):
under ``POSEIDON_SLICE_ID``/``POSEIDON_SLICE_SIZE`` the processes form
slices of contiguous ranks, each slice runs the mesh synchronously over
its own process group (``runtime/cluster.init_slice_group``), and its
leader speaks the async tier with the slice id as its worker id.
``--slice`` without ``--async_ssp`` is refused, and so is a mesh of more
than one device under ``--async_ssp`` without ``--slice``. ``test`` scores a
net's TEST phase and prints one ``<output>: <mean>`` line per scalar output. ``serve`` warms every bucket,
logs ``serve: listening on <host>:<port>``, serves until SIGTERM/SIGINT,
drains every admitted request, prints one ``serving_final_stats`` JSON line
and exits 0. ``serve --generate`` serves a transformer preset with seeded
weights (paged KV cache, continuous batching, the ``generate`` wire op)
behind the same front door and the same shutdown. ``--replicas N`` (or
``--devices``) serves N replicas behind that door (``serving/fleet.py``:
least-loaded routing, failover, rolling reload); ``--watch`` hot-reloads
newer snapshots under a prefix (through the fleet, one replica draining
at a time); ``--metrics_port`` serves the stats as ``key=value`` lines
over HTTP. ``bench_serve`` stands the server up in process, drives it
closed- or open-loop (``--offered_rps``) and prints one JSON line.
``train --metrics_port`` serves the engine's stats (``stats.yaml``, written
under ``--output_dir`` at every display and at exit) over HTTP while it
trains. ``train``, ``test`` and ``extract_features`` take a cluster
``--hostfile`` ('<id> <ip> <port>' lines, host 0 the coordinator) and
``--node_id`` in place of the env contract; under ``--async_ssp`` a
hostfile without the env contract is refused, as in the JAX CLI.

``time`` builds the TRAIN net (data layers shaped from one record of their
source), times the whole forward and forward+backward (CUDA events on the
card) and, with ``--per_layer``, each layer's forward and backward alone
and the static per-layer comm bytes over ``--comm_devices``.
``device_query`` lists the CUDA devices (it exits non-zero when there is
none, unless ``--device cpu``). ``convert_imageset``,
``compute_image_mean``, ``partition_data`` and ``convert_db`` are the
dataset tools of ``runtime/tools.py``; ``extract_features`` dumps named
blobs of the TEST phase's forward to LMDBs. ``time`` and
``extract_features`` plan the layout an unflagged ``train`` plans ("auto":
NHWC on the card). ``tune`` runs the measured autotuner
(``runtime/tuned_plan.run_tune``) and prints one JSON line; a second
``tune`` of the same model on the same card loads the persisted plan
(``"source": "persisted"``), ``--force`` measures again. ``serve`` and
``bench_serve`` take an unset ``--buckets`` (and ``serve --generate``
its page size, decode rungs and prompt buckets) from the plan under
``--tuned_plan auto``. Every command runs on ``cuda`` unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from contextlib import contextmanager
from typing import List, Optional

from .metrics import log

LLM_PRESETS = ("tiny", "gpt_small")

# bench_serve's built-in deploy net when no --model is given (the JAX
# package's, kept as the port's own copy)
_BENCH_SERVE_NET = """
name: "bench_serve_synthetic"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 32 input_dim: 32
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "fc" type: INNER_PRODUCT bottom: "pool1" top: "fc"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
"""


def _resolve_serve_buckets(args) -> str:
    """The bucket ladder through the tuned plan (JAX's): an explicit
    --buckets wins; else the persisted plan of the deploy net (keyed by
    its name, the backend and the device count) gives its measured
    ladder; else the built-in default. The source is logged."""
    from .tuned_plan import BUILTIN_DEFAULTS, load_plan

    spec = getattr(args, "buckets", "")
    if spec:
        return spec
    if getattr(args, "model", "") and \
            getattr(args, "tuned_plan", "auto") != "off":
        try:
            from ..proto.messages import load_net
            model_name = (load_net(args.model).name or "").lower()
        except Exception as e:  # noqa: BLE001 — the executor build will
            model_name = ""     # surface a real model problem loudly
            log(f"[tuned_plan] could not read {args.model!r} for plan "
                f"lookup ({type(e).__name__}: {e}); default ladder")
        if model_name:
            doc = load_plan(model_name, device=args.device or None)
            ladder = (doc or {}).get("knobs", {}).get("serve_buckets")
            if ladder:
                log(f"[tuned_plan] serve_buckets={ladder} "
                    f"(plan {str(doc.get('key', '?'))[:12]})")
                return ladder
    return BUILTIN_DEFAULTS["serve_buckets"]


def _resolve_llm_knobs(args) -> dict:
    """The LM serving knobs through the tuned plan (JAX's): a persisted
    plan's ``llm_page_size``, ``llm_decode_rungs`` and
    ``llm_prompt_buckets`` win over the built-in defaults; the source is
    logged."""
    from .tuned_plan import BUILTIN_DEFAULTS, load_plan

    keys = ("llm_page_size", "llm_decode_rungs", "llm_prompt_buckets")
    knobs = {k: BUILTIN_DEFAULTS[k] for k in keys}
    if getattr(args, "tuned_plan", "auto") != "off":
        doc = load_plan(args.model, device=args.device or None)
        hits = {k: (doc or {}).get("knobs", {}).get(k) for k in keys}
        knobs.update({k: v for k, v in hits.items() if v})
        if any(hits.values()):
            log(f"[tuned_plan] llm serving knobs {knobs} "
                f"(plan {str((doc or {}).get('key', '?'))[:12]})")
    return knobs


@contextmanager
def _store_scope(args):
    """``--compile_cache_dir`` (else ``POSEIDON_COMPILE_CACHE_DIR``): the
    directory of the tuned store and of the kernel store
    (``compile_cache.enable_compile_cache``), and ``--aot_steps``, for the
    command only."""
    from .. import config
    from .compile_cache import disable_compile_cache, enable_compile_cache
    cc = config.compile_cache_config()
    saved = (cc.cache_dir, cc.aot_steps)
    cache_dir = getattr(args, "compile_cache_dir", "") or cc.cache_dir
    aot = getattr(args, "aot_steps", "true") == "true"
    if cache_dir:
        cache_dir = enable_compile_cache(cache_dir)
        log(f"compile cache: kernel store and tuned store at {cache_dir} "
            f"(aot_steps={str(aot).lower()})")
    config.set_compile_cache_config(cache_dir=cache_dir, aot_steps=aot)
    try:
        yield
    finally:
        if cache_dir:
            disable_compile_cache()
        config.set_compile_cache_config(cache_dir=saved[0],
                                        aot_steps=saved[1])


def _build_serving_executor(model: str, weights: str, buckets: str,
                            device=None):
    """Shared by serve and bench_serve: a deploy net (or the built-in
    synthetic one) with optional weights (seed-0 filler weights otherwise)
    -> a warmed ``BucketedExecutor`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``), the fleet's placement unit."""
    import torch

    from ..core.net import Net
    from ..numeric import resolve_device
    from ..proto.messages import load_net_from_string
    from ..serving.executor import (BucketedExecutor, load_serving_params,
                                    parse_buckets)
    bucket_sizes = parse_buckets(buckets)
    if model:
        return BucketedExecutor.from_files(model, weights or None,
                                           buckets=bucket_sizes,
                                           device=device)
    net = Net(load_net_from_string(_BENCH_SERVE_NET), "TEST",
              device=resolve_device(device))
    params = net.init(torch.Generator().manual_seed(0))
    if weights:
        params = load_serving_params(net, params, weights)
    return BucketedExecutor(net, params, buckets=bucket_sizes)


def _resolve_fleet_devices(spec: str, n_replicas: int, device: str = "",
                           n_devices=None):
    """``--devices "0,2,3"`` -> those CUDA devices; "" -> round-robin over
    every visible GPU when the fleet has more than one replica (a single
    replica keeps the default device). ``n_devices`` defaults to
    ``torch.cuda.device_count()``; an index that does not exist fails
    loudly (the JAX package's messages), as does a fleet with no GPU
    unless ``device`` is ``cpu``, which puts every replica on the CPU
    and takes no ``--devices``."""
    import torch

    from ..numeric import resolve_device
    if device and torch.device(device).type == "cpu":
        if spec:
            raise SystemExit(f"--devices {spec!r}: device indices name GPUs; "
                             f"--device cpu puts every replica on the CPU")
        return [torch.device("cpu")]
    if n_devices is None:
        resolve_device(device or None)   # no GPU, no CPU asked for: refuse
        n_devices = torch.cuda.device_count()
    local = [torch.device("cuda", i) for i in range(n_devices)]
    if spec:
        try:
            idxs = [int(tok) for tok in spec.split(",") if tok.strip()]
        except ValueError:
            raise SystemExit(f"--devices {spec!r}: expected comma-separated "
                             f"device indices") from None
        bad = [i for i in idxs if i < 0 or i >= len(local)]
        if bad:
            raise SystemExit(f"--devices {spec!r}: no such device index "
                             f"{bad} (have {len(local)} local devices)")
        return [local[i] for i in idxs]
    if n_replicas <= 1:
        return []
    return local


def build_serving_fleet(model: str, weights: str, buckets: str,
                        n_replicas: int, devices_spec: str = "",
                        max_delay_s: float = 0.005, max_queue: int = 64,
                        device: str = "", **manager_kw):
    """N warmed replicas under one ``ReplicaManager``, round-robin over
    the resolved devices (replicas > devices is fine: every replica on
    one card is its own executor and batcher)."""
    from ..serving.fleet import ReplicaManager
    devices = _resolve_fleet_devices(devices_spec, n_replicas, device)

    def factory(dev):
        return _build_serving_executor(
            model, weights, buckets,
            device=dev if dev is not None else (device or None))

    return ReplicaManager.build(factory, n_replicas, devices=devices,
                                max_delay_s=max_delay_s,
                                max_queue=max_queue, **manager_kw)


def build_generate_executor(preset: str, device=None, seed: int = 0,
                            mesh_cfg=None, devices=None, knobs=None):
    """A warmed paged-KV ``GenerateExecutor`` over a named transformer
    preset with weights drawn from ``seed`` (``--generate`` has no
    snapshot format yet, as in the JAX package), with ``knobs``' page
    size, decode rungs and prompt buckets (``_resolve_llm_knobs``; the
    built-in ones when None); tensor-parallel under an active
    ``mesh_cfg`` over ``devices`` (``GenerateExecutor``'s), a library path
    with no CLI flag, as in the JAX package."""
    import torch

    from ..models.transformer import (TransformerConfig, gpt_small_config,
                                      init_params)
    from ..numeric import resolve_device
    from ..serving.continuous import (DEFAULT_DECODE_RUNGS,
                                      DEFAULT_PAGE_SIZE,
                                      DEFAULT_PROMPT_BUCKETS,
                                      GenerateExecutor, parse_rungs)

    if mesh_cfg is None or not mesh_cfg.active:
        device = resolve_device(device)   # refuse before drawing weights
    if preset == "gpt_small":
        cfg = gpt_small_config(max_seq=512)
    elif preset == "tiny":
        cfg = TransformerConfig(vocab_size=256, d_model=32, n_heads=4,
                                n_layers=2, d_ff=128, max_seq=128)
    else:
        raise SystemExit(
            f"--generate serves a transformer preset, not a deploy "
            f"prototxt; --model must be one of {'|'.join(LLM_PRESETS)} "
            f"(got {preset!r})")
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    page_size, rungs = DEFAULT_PAGE_SIZE, DEFAULT_DECODE_RUNGS
    ladder = DEFAULT_PROMPT_BUCKETS
    if knobs is not None:
        page_size = int(knobs["llm_page_size"])
        rungs = parse_rungs(str(knobs["llm_decode_rungs"]))
        ladder = parse_rungs(str(knobs["llm_prompt_buckets"]))
    # a preset smaller than the ladder drops the buckets it cannot hold
    # rather than refusing to serve
    buckets = tuple(b for b in ladder if b < cfg.max_seq)
    return GenerateExecutor(cfg, params, page_size=page_size,
                            decode_rungs=rungs, prompt_buckets=buckets,
                            device=device, mesh_cfg=mesh_cfg,
                            devices=devices)


def build_generate_fleet(preset: str, n_replicas: int, devices_spec: str = "",
                         max_queue: int = 64, device: str = "", knobs=None,
                         **manager_kw):
    """N warmed generate replicas (``build_generate_executor``) under one
    ``ReplicaManager``, placed as ``build_serving_fleet`` places CNN
    replicas."""
    from ..serving.fleet import ReplicaManager
    devices = _resolve_fleet_devices(devices_spec, n_replicas, device)

    def factory(dev):
        return build_generate_executor(
            preset, device=dev if dev is not None else (device or None),
            knobs=knobs)

    return ReplicaManager.build(factory, n_replicas, devices=devices,
                                max_queue=max_queue, **manager_kw)


def _watch_prefix(args):
    """(the snapshot prefix to watch or "", the --weights snapshot the
    reloader starts from or None): ``--watch auto`` derives the prefix
    from ``--weights``' ``_iter_`` naming, and a ``--weights`` snapshot
    under the watched prefix seeds the reloader so its first poll swaps
    only to something strictly newer."""
    watch = args.watch
    if watch == "auto":
        if args.weights and "_iter_" in args.weights:
            watch = args.weights.split("_iter_")[0]
        else:
            # checked before the warm-up
            raise SystemExit(
                "--watch auto needs --weights pointing at a "
                "<prefix>_iter_N artifact to derive the prefix from; "
                "pass the snapshot prefix explicitly instead")
    serving_snap = (args.weights if watch and args.weights
                    and "_iter_" in args.weights
                    and args.weights.split("_iter_")[0] == watch
                    else None)
    return watch, serving_snap


def cmd_serve(args) -> int:
    with _store_scope(args):
        return _serve(args)


def _serve(args) -> int:
    """Serve a deploy net over TCP (dynamic micro-batching, the bucketed
    executor, hot reload under ``--watch``, graceful drain on SIGTERM), or
    with ``--generate`` a transformer preset through the paged-KV
    continuous batcher. ``--replicas N`` (or ``--devices``) puts a fleet
    behind the same front door: least-loaded routing, per-replica health
    and failover, rolling reload."""
    from ..config import fleet_config
    from ..serving.reloader import CheckpointReloader, FleetReloader
    from ..serving.server import InferenceServer

    replicas = max(1, args.replicas)
    fleet_mode = replicas > 1 or bool(args.devices)
    manager = executor = reloader = None
    if args.generate:
        if args.weights or args.watch:
            raise SystemExit("--generate serves preset-initialized params; "
                             "--weights/--watch have no LLM snapshot format "
                             "to load yet")
        watch = ""
        knobs = _resolve_llm_knobs(args)
        if fleet_mode:
            manager = build_generate_fleet(args.model, replicas,
                                           args.devices, args.max_queue,
                                           device=args.device, knobs=knobs)
            ref = manager.reference_executor()
            log(f"serve: warmed {len(manager.replicas)} generate replicas "
                f"({args.model}, {ref.cfg.n_params()} params each, "
                f"page_size={ref.page_size}, rungs={ref.decode_rungs}, "
                f"buckets={ref.prompt_buckets}) on "
                f"{[r.device_label for r in manager.replicas]}")
        else:
            executor = build_generate_executor(args.model,
                                               device=args.device or None,
                                               knobs=knobs)
            log(f"serve: warmed generate executor ({args.model}, "
                f"{executor.cfg.n_params()} params, page_size="
                f"{executor.page_size}, rungs={executor.decode_rungs}, "
                f"buckets={executor.prompt_buckets}) on {executor.device}")
    else:
        watch, serving_snap = _watch_prefix(args)
        buckets = _resolve_serve_buckets(args)
        if fleet_mode:
            manager = build_serving_fleet(
                args.model, args.weights, buckets, replicas,
                args.devices, max_delay_s=args.max_delay_ms / 1e3,
                max_queue=args.max_queue, device=args.device)
            ref = manager.reference_executor()
            log(f"serve: warmed {len(manager.replicas)} replicas, buckets "
                f"{ref.buckets} ({ref.net.name or 'net'}, "
                f"{ref.net.param_count()} params each) on "
                f"{[r.device_label for r in manager.replicas]}")
            if watch:
                reloader = FleetReloader(manager, watch, poll_s=args.poll_s,
                                         current_path=serving_snap)
        else:
            executor = _build_serving_executor(args.model, args.weights,
                                               buckets,
                                               device=args.device or None)
            log(f"serve: warmed buckets {executor.buckets} on "
                f"{executor.device} ({executor.net.name or 'net'}, "
                f"{executor.net.param_count()} params)")
            if watch:
                reloader = CheckpointReloader(executor, watch,
                                              poll_s=args.poll_s,
                                              current_path=serving_snap)
        if watch:
            log(f"serve: watching {watch!r} for newer snapshots "
                f"(every {args.poll_s}s)")
    if args.host not in ("127.0.0.1", "localhost", "::1"):
        log(f"serve: WARNING: binding {args.host!r} — the wire format is "
            f"pickled frames (arbitrary code execution for anyone who can "
            f"connect); serve only on loopback or a trusted network")
    server = InferenceServer(
        executor=executor, fleet=manager, host=args.host, port=args.port,
        max_delay_s=args.max_delay_ms / 1e3, max_queue=args.max_queue,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms > 0 else None),
        reloader=reloader,
        # the refresher keeps the registry section live for any metrics
        # endpoint, and for the fleet's health rows
        stats_refresh_s=(fleet_config().stats_refresh_s
                         if fleet_mode or args.metrics_port >= 0 else 0.0))
    tags = (["generate op"] if args.generate else []) \
        + ([f"{replicas} replicas"] if fleet_mode else [])
    log(f"serve: listening on {server.host}:{server.port}"
        + (f" ({', '.join(tags)})" if tags else ""))
    metrics_srv = None
    if args.metrics_port >= 0:
        from .metrics import MetricsServer
        server.stats_snapshot()        # seed the section before a poll
        metrics_srv = MetricsServer(server.stats, port=args.metrics_port)
        log(f"serve: metrics endpoint on "
            f"http://127.0.0.1:{metrics_srv.port}/")

    def _graceful(signum, frame):
        log(f"serve: signal {signum}; draining in-flight requests")
        # the handler only flips flags; the drain runs on the main thread
        server.request_stop()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        server.wait_until_stopped()
    except KeyboardInterrupt:
        pass
    server.shutdown(drain=True)
    if metrics_srv is not None:
        metrics_srv.close()
    print(json.dumps({"serving_final_stats": server.stats_snapshot()}),
          flush=True)
    return 0


def run_serving_bench(executor, requests: int, concurrency: int, batch: int,
                      max_delay_ms: float = 5.0, max_queue: int = 64,
                      deadline_ms=None, fleet=None, offered_rps=None):
    """The in-process serving bench of ``bench_serve``: a port-0 server
    and the load generator, request sizes cycling 1..batch over the bucket
    ladder. Pass ``fleet`` (a ReplicaManager; ``executor=None``) to stand
    the fleet behind the front door, ``offered_rps`` for the open loop.
    Returns (run_load's result, the server's stats snapshot)."""
    import numpy as np

    from ..serving.client import run_load
    from ..serving.server import InferenceServer

    # in the fleet form the batching knobs live on the replicas (set when
    # the fleet was built)
    server = (InferenceServer(fleet=fleet) if fleet is not None else
              InferenceServer(executor=executor,
                              max_delay_s=max_delay_ms / 1e3,
                              max_queue=max_queue))
    ref = executor if executor is not None else fleet.reference_executor()
    name = ref.input_names[0]
    row_shape = tuple(ref.net.blob_shapes[name][1:])
    max_rows = max(1, min(batch, ref.max_batch))
    frames = np.random.RandomState(0).randn(
        max_rows, *row_shape).astype(np.float32)

    def make_inputs(i):
        return {name: frames[: 1 + i % max_rows]}

    try:
        result = run_load(server.addr, make_inputs, n_requests=requests,
                          concurrency=concurrency, deadline_ms=deadline_ms,
                          offered_rps=offered_rps)
        stats = server.stats_snapshot()
    finally:
        server.shutdown()
    return result, stats


def cmd_bench_serve(args) -> int:
    with _store_scope(args):
        return _bench_serve(args)


def _bench_serve(args) -> int:
    """In-process serving microbenchmark: the server on port 0 driven by
    the load generator; prints ONE JSON line (p50/p99, throughput, shed
    and fill telemetry). ``--replicas N`` benches the fleet path;
    ``--offered_rps R`` switches to the open loop."""
    replicas = max(1, args.replicas)
    offered = args.offered_rps if args.offered_rps > 0 else None
    buckets = _resolve_serve_buckets(args)
    if replicas > 1 or args.devices:
        fleet = build_serving_fleet(
            args.model, args.weights, buckets, replicas, args.devices,
            max_delay_s=args.max_delay_ms / 1e3, max_queue=args.max_queue,
            device=args.device)
        executor = None
    else:
        fleet = None
        executor = _build_serving_executor(args.model, args.weights,
                                           buckets,
                                           device=args.device or None)
    result, stats = run_serving_bench(
        executor, args.requests, args.concurrency, args.batch,
        max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
        deadline_ms=args.deadline_ms if args.deadline_ms > 0 else None,
        fleet=fleet, offered_rps=offered)
    if fleet is not None:
        result["replicas"] = replicas
        result["routing"] = stats["routing"]
        result["states"] = stats["states"]
        result["batches"] = stats["batches"]
        fills = [r.get("batch_fill") for r in stats["replicas"].values()
                 if r.get("batch_fill") is not None]
        result["batch_fill"] = (round(sum(fills) / len(fills), 4)
                                if fills else None)
    else:
        result["batch_fill"] = stats["batch_fill"]
        result["batches"] = stats["batches"]
        result["bucket_calls"] = stats["bucket_calls"]
    if not result.get("ok") or result.get("p99_ms") is None:
        # every request shed or errored: fail loudly, never a clean line
        # (result first: its integer "error" count must not clobber the
        # diagnostic string)
        print(json.dumps({**result, "metric": "serving_p99_ms",
                          "value": 0.0, "unit": "ms",
                          "error_counts": result.get("error"),
                          "error": "no successful requests"}),
              flush=True)
        return 1
    print(json.dumps({"metric": "serving_p99_ms", "value": result["p99_ms"],
                      "unit": "ms", **result}), flush=True)
    return 0


def cmd_tune(args) -> int:
    """The measured autotuner (``runtime/tuned_plan.run_tune``): short
    wall-clock trials over the policy space, persisted as one plan with
    provenance in the tuned store (``--compile_cache_dir``, else the
    default store) that ``train``, ``serve`` and ``bench_serve`` load. A
    second ``tune`` loads the persisted plan and measures nothing
    (``--force`` measures again). Prints one JSON line."""
    import os

    from .tuned_plan import run_tune

    with _store_scope(args):
        result = run_tune(args.model, smoke=args.smoke, force=args.force,
                          deploy=args.deploy, windows=args.windows or None,
                          iters=args.iters or None,
                          device=args.device or None)
    doc = result["doc"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, args.out)
    print(json.dumps({
        "metric": "tune", "model": doc["model"],
        "backend": doc["backend"], "device_kind": doc["device_kind"],
        "source": result["source"], "path": result["path"],
        "knobs": doc["knobs"],
        "search_cost_s": doc.get("search_cost_s"),
        "tuned_vs_default_speedup": doc.get("ab", {}).get("speedup"),
    }), flush=True)
    return 0


def bucket_mb_of(dwbp_bucket_mb: float, param_arena: bool,
                 arena_bucket_mb: float) -> float:
    """The JAX ``train`` command's three bucket knobs as the port's one
    ``CommConfig.bucket_mb``: an explicit ``--dwbp_bucket_mb`` (>= 0)
    wins, else the arena's ``--arena_bucket_mb``, else (``--param_arena
    false``, the JAX package's per-leaf taps) one bucket a leaf."""
    if dwbp_bucket_mb >= 0:
        return dwbp_bucket_mb
    return arena_bucket_mb if param_arena else 0.0


def comm_from_args(args):
    """The ``CommConfig`` of the ``train`` flags (the JAX CLI's
    ``_engine_from_args`` for the flags the port covers)."""
    from ..parallel.mesh import DCN_AXIS
    from ..parallel.strategies import CommConfig

    from .tuned_plan import BUILTIN_DEFAULTS
    # an unset --arena_bucket_mb (not resolved through a tuned plan) is
    # the built-in default
    arena_mb = (BUILTIN_DEFAULTS["arena_bucket_mb"]
                if args.arena_bucket_mb is None else args.arena_bucket_mb)
    bucket_mb = bucket_mb_of(args.dwbp_bucket_mb, args.param_arena == "true",
                             arena_mb)
    if args.mesh:
        if args.dcn_slices > 1:
            raise SystemExit("--mesh and --dcn_slices do not compose: the "
                             "named mesh's axes carry the whole topology")
        if mesh_from_args(args).active:
            # the planned mesh buckets the arena by --arena_bucket_mb, as
            # JAX's; a DWBP bucket request has no meaning there
            if args.dwbp_bucket_mb >= 0:
                from .metrics import log
                log("WARNING: dwbp_bucket_mb is superseded by the arena's "
                    "bucketed reduce-scatter schedule on a named mesh; "
                    "ignoring")
            bucket_mb = arena_mb
    # --wire_dtype rides two tiers: the compiled collectives (bf16/f16)
    # and the async tier's delta payloads, which also take int8; int8
    # never enters the compiled config
    wire = args.wire_dtype or None
    if wire == "int8":
        if not args.async_ssp:
            raise SystemExit(
                "--wire_dtype int8 is a managed-tier (async DCN) wire "
                "format; compiled collectives take bf16/f16")
        wire = None
    # an SFB auto pick keeps DENSE as the default for the other layers
    return CommConfig(
        default_strategy="dense" if args.sfb_auto else args.strategy,
        reduce=args.grad_reduce, topk_policy=args.topk_policy,
        wire_dtype=wire,
        topk_block=args.topk_block or None,
        bucket_mb=bucket_mb, param_arena=args.param_arena == "true",
        dcn_axis=DCN_AXIS if args.dcn_slices > 1 else None,
        server_logic=args.server_logic,
        adarev_init_step=args.adarev_init_step)


def mesh_from_args(args):
    """The ``config.MeshConfig`` of ``--mesh`` (None unset)."""
    from ..config import MeshConfig
    return MeshConfig.parse(args.mesh) if args.mesh else None


# the async tier's fault knobs: a negative flag keeps the FaultConfig (or
# tier) default, as in the JAX CLI
_ASYNC_FAULT_FLAGS = (("heartbeat_s", "async_heartbeat_s"),
                      ("liveness_timeout_s", "async_liveness_timeout_s"),
                      ("reconnect_deadline_s", "async_reconnect_deadline_s"),
                      ("gate_timeout_s", "async_gate_timeout_s"),
                      ("first_gate_timeout_s", "async_first_gate_timeout_s"))


def async_from_args(args):
    """(engine staleness, async tier arguments or None) of the ``train``
    flags, as the JAX CLI's ``_engine_from_args``: under ``--async_ssp``
    the staleness bound belongs to the tier and the local step is the
    synchronous one."""
    if not args.async_ssp:
        if args.slice:
            raise SystemExit("--slice composes the two-tier fabric on top "
                             "of the async tier; it requires --async_ssp")
        return args.staleness, None
    mesh = mesh_from_args(args)
    if not args.slice and mesh is not None and mesh.n_devices > 1:
        from .engine import mesh_async_refusal
        raise SystemExit(mesh_async_refusal(mesh))
    cfg = {"staleness": args.staleness,
           "sync_every": args.async_sync_every}
    if args.slice:
        # the leader of each slice speaks the tier as the slice
        # (runtime/async_tier.FabricTier); the slice env names the slices
        cfg["slice"] = True
    for key, flag in _ASYNC_FAULT_FLAGS:
        v = getattr(args, flag)
        if v is not None and v >= 0:
            cfg[key] = v
    # negative budget: the ManagedCommConfig default (off); 0 is an
    # explicit "unlimited"
    if args.comm_budget_mbps >= 0:
        cfg["comm_budget_mbps"] = args.comm_budget_mbps
    if args.comm_priority_frac > 0:
        cfg["comm_priority_frac"] = args.comm_priority_frac
    if args.comm_adaptive:
        cfg["comm_adaptive"] = True
    if args.wire_dtype:
        cfg["comm_wire_dtype"] = args.wire_dtype
    return 0, cfg


def train_policy(args, res=None) -> dict:
    """The numeric-policy fields of a ``train`` (JAX's ``cmd_train``:
    ``--bf16`` is ``set_perf_policy``, then the layout and strategy):
    from the tuned-plan resolution ``res`` when given, else from the
    flags, where an unset ``--conv_layout`` is "auto"."""
    import torch
    if res is not None:
        layout, strategy = res.values["conv_layout"], \
            res.values["conv_strategy"]
    else:
        layout, strategy = args.conv_layout or "auto", args.conv_strategy
    out = {"conv_layout": str(layout).upper()}
    if args.bf16:
        out.update(compute_dtype=torch.bfloat16, conv_s2d=True)
    if strategy:
        out["conv_strategy"] = strategy
    return out


def resolve_train_plan(args):
    """The tuned-plan resolution of a ``train`` (JAX's
    ``_apply_tuned_plan_train``): the flags the user set, then the
    persisted plan of the train net (keyed by its name, the backend and
    the device count; ``--tuned_plan off`` skips the store), then the
    built-in defaults, knob by knob. A missing or refused plan is logged
    and the defaults apply."""
    from .tuned_plan import TRAIN_KNOBS, load_plan, resolve, store_dir

    # each knob's flag has the knob's name; None or "" is unset
    explicit = {}
    for knob in TRAIN_KNOBS:
        v = getattr(args, knob, None)
        if v is None or v == "":
            continue
        explicit[knob] = v.upper() if knob == "conv_layout" else v
    doc, store = None, ""
    if getattr(args, "tuned_plan", "auto") != "off":
        from ..proto.messages import load_solver
        from .engine import resolve_nets
        try:
            train_param, _ = resolve_nets(load_solver(args.solver))
            model = (train_param.name or "net").lower()
        except Exception as e:  # noqa: BLE001 — the engine's build will
            model = ""          # surface a real solver problem loudly
            log(f"[tuned_plan] could not read {args.solver!r} for plan "
                f"lookup ({type(e).__name__}: {e}); built-in defaults")
        store = store_dir()
        doc = (load_plan(model, cache_dir=store, device=args.device or None)
               if model else None)
        if doc is None and model:
            log(f"[tuned_plan] no plan for {model!r} in {store}; built-in "
                f"defaults apply (run `python -m poseidon_tpu_torch tune "
                f"--model ...` to measure one)")
    return resolve(doc, explicit, store=store)


def cmd_train(args) -> int:
    """``train`` under its tuned-plan resolution: the policy, the
    pipeline config, the managed tier's wire dtype and the active
    resolution hold for the command and are restored when it returns."""
    import dataclasses

    from .. import config
    from ..numeric import policy_scope
    from . import tuned_plan

    saved_pipe = dataclasses.asdict(config.pipeline_config())
    saved_wire = config.managed_comm_config().wire_dtype
    saved_active = tuned_plan.active_resolution()
    try:
        with _store_scope(args):
            res = resolve_train_plan(args)
            with policy_scope(**train_policy(args, res)):
                knobs = tuned_plan.apply_training_resolution(res)
                log(f"[tuned_plan] {res.describe()}")
                for k, v in knobs.items():
                    setattr(args, k, v)
                return _train(args)
    finally:
        config.set_pipeline_config(**saved_pipe)
        config.set_managed_comm_config(wire_dtype=saved_wire)
        tuned_plan.set_active_resolution(saved_active)


def _train(args) -> int:
    import os

    from ..proto.messages import load_solver
    from .engine import Engine

    comm = comm_from_args(args)
    staleness, async_cfg = async_from_args(args)
    if async_cfg is not None and args.hostfile \
            and "POSEIDON_PROC_ID" not in os.environ:
        # the async tier reads the local launcher's env contract; a
        # hostfile launch does not set it, and N isolated full-data runs
        # would be worse than refusing
        raise SystemExit(
            "--async_ssp currently rides the launch_local env contract "
            "(POSEIDON_PROC_ID/NUM_PROCS/COORDINATOR); for a hostfile "
            "cluster, start each node under that env (see "
            "scripts/launch.py) instead of --hostfile/--node_id")
    eng = Engine(load_solver(args.solver), output_dir=args.output_dir,
                 device=args.device or None, comm=comm,
                 staleness=staleness, async_ssp=async_cfg,
                 sfb_auto=args.sfb_auto,
                 device_prefetch=args.device_prefetch,
                 max_in_flight=args.max_in_flight,
                 async_snapshot=args.async_snapshot,
                 device_transform=args.device_transform,
                 trace_out=args.trace_out or None,
                 dcn_slices=args.dcn_slices, mesh_cfg=mesh_from_args(args),
                 metrics_port=(args.metrics_port if args.metrics_port >= 0
                               else None),
                 hostfile=args.hostfile or None, node_id=_node_id(args),
                 steps_per_dispatch=args.steps_per_dispatch or 1,
                 remat=args.remat or None, hbm_budget_gb=args.hbm_budget_gb,
                 profile_steps=args.profile, census=args.census)
    try:
        if args.snapshot == "auto":
            if eng.auto_resume() is None and args.weights:
                eng.restore_from(args.weights)
        elif args.snapshot:
            eng.restore_from(args.snapshot)
        elif args.weights:
            eng.restore_from(args.weights)
        eng.train()
    finally:
        eng.close()
    return 0


def _node_id(args) -> Optional[int]:
    return args.node_id if args.node_id >= 0 else None


def cmd_test(args) -> int:
    """Score the TEST phase; over a process group (env contract or
    hostfile) each rank scores its own shard of the records and the means
    are over the ranks (rank 0 prints)."""
    import torch

    from ..core.net import Net
    from ..data.pipeline import build_phase_pipelines
    from ..data.workload import Shard
    from ..numeric import resolve_device
    from ..parallel.trainer import build_eval_step
    from ..proto.messages import load_net
    from .checkpoint import load_caffemodel
    from .cluster import init_distributed

    group = init_distributed(resolve_device(args.device or None),
                             hostfile=args.hostfile or None,
                             node_id=_node_id(args))
    try:
        net_param = load_net(args.model)
        pipes, shapes = build_phase_pipelines(
            net_param, "TEST", shard=Shard(group.rank, group.world))
        try:
            net = Net(net_param, "TEST", device=group.device,
                      source_shapes=shapes)
            params = net.init(torch.Generator().manual_seed(0))
            if args.weights:
                params = load_caffemodel(args.weights, net, params)
            ev = build_eval_step(net, group if group.distributed else None)
            acc = {}
            for _ in range(args.iterations):
                batch = {}
                for pipe in pipes:
                    for k, v in next(pipe).items():
                        batch[k] = torch.from_numpy(v).to(net.device)
                for k, v in ev(params, batch).items():
                    acc[k] = acc.get(k, 0.0) + float(v)
        finally:
            for p in pipes:
                p.close()
    finally:
        group.close()
    if group.rank == 0:
        for k in sorted(acc):
            print(f"{k}: {acc[k] / args.iterations:.4f}", flush=True)
    return 0


def cmd_device_query(args) -> int:
    """The CUDA devices this process sees (index, name, compute
    capability, memory) and its rank and world under the env contract;
    non-zero without a GPU unless ``--device cpu``."""
    import torch

    from .cluster import env_world
    rank, world, _ = env_world()
    cpu = bool(args.device) and torch.device(args.device).type == "cpu"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n):
        prop = torch.cuda.get_device_properties(i)
        print(f"device {i}: platform=cuda kind={prop.name} "
              f"compute_capability={prop.major}.{prop.minor} "
              f"memory_bytes={prop.total_memory} "
              f"multiprocessors={prop.multi_processor_count}", flush=True)
    if cpu:
        print("device cpu: platform=cpu", flush=True)
    print(f"process rank={rank} world={world} cuda_devices={n} "
          f"torch={torch.__version__} cuda={torch.version.cuda}",
          flush=True)
    if n == 0 and not cpu:
        print("device_query: no CUDA device is visible (pass --device cpu "
              "to query the CPU alone)", file=sys.stderr, flush=True)
        return 1
    return 0


def _time_shapes(net_param, batch_size: int) -> dict:
    """The source shapes of the TRAIN net's data layers: each layer's
    batch (else ``batch_size``) and the (C, H, W) of one record of its
    source (3x224x224 when it cannot be read), cropped to the layer's
    crop_size (the JAX ``time`` command's rule)."""
    from ..core.layers import DATA_SOURCE_TYPES
    from ..core.net import filter_net
    from ..data.pipeline import build_source, layer_batch_size
    from ..proto.messages import NetState

    shapes = {}
    for lp in filter_net(net_param, NetState(phase="TRAIN")):
        if lp.canonical_type() not in DATA_SOURCE_TYPES:
            continue
        b = layer_batch_size(lp) or batch_size
        chw = None
        src = (lp.data_param.source or lp.image_data_param.source
               or lp.hdf5_data_param.source or lp.window_data_param.source)
        if src:
            # one record gives the true (C, H, W): a 3x224x224 guess
            # would mis-size every layer downstream
            try:
                source = build_source(lp)
                try:
                    chw = source.read(0)[0].shape
                finally:
                    source.close()
            except Exception:  # noqa: BLE001 — fall back to the guess
                chw = None
        if chw is None:
            c = lp.transform_param.crop_size or 224
            chw = (3, c, c)
        if lp.transform_param.crop_size:
            chw = (chw[0], lp.transform_param.crop_size,
                   lp.transform_param.crop_size)
        shapes[lp.top[0]] = (b,) + tuple(chw)
        if len(lp.top) > 1:
            shapes[lp.top[1]] = (b,)
    return shapes


def _timed_ms(fn, iterations: int, device) -> float:
    """Mean ms of ``fn`` over ``iterations`` calls after one warm-up call:
    CUDA events around the calls on the card, the host clock on the
    CPU."""
    import time

    import torch
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iterations
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    return (time.perf_counter() - t0) / iterations * 1e3


def _zeros(shape, device, nhwc: bool):
    """A zero input of ``shape``: f32 (channels-last when the net plans
    NHWC and it is 4-D), 1-D labels as int32 (the JAX command's)."""
    import torch
    if len(shape) <= 1:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    t = torch.zeros(shape, dtype=torch.float32, device=device)
    if nhwc and t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _layer_times(net, params, iterations: int) -> None:
    """Each layer's forward alone, and its backward (the forward and
    backward of the sum of its tops, less the forward) with respect to
    its params and float bottoms; 'skip' when the forward fails on zero
    inputs, '-' when the layer has no backward."""
    import torch

    from ..core.net import SPATIAL_TYPES
    nhwc = net.conv_layout == "NHWC"
    print(f"{'layer':<24}{'type':<22}{'fwd ms':>10}{'bwd ms':>10}",
          flush=True)
    for layer in net.layers:
        bottoms = [_zeros(net.blob_shapes[b], net.device,
                          nhwc and layer.TYPE in SPATIAL_TYPES).float()
                   for b in layer.lp.bottom]
        lparams = net._layer_params(params, layer)

        def run(ps=lparams, bs=bottoms, _l=layer):
            with torch.no_grad():
                return _l(ps, bs, True)

        try:
            fwd_l = _timed_ms(run, iterations, net.device)
        except Exception as e:  # noqa: BLE001 — e.g. a label fed zeros
            print(f"{layer.name:<24}{layer.TYPE:<22}{'skip':>10}"
                  f"{'skip':>10} ({e})", flush=True)
            continue
        leaves = [v.detach().requires_grad_(True) for v in lparams.values()]
        ps = dict(zip(lparams, leaves))
        bs = [b.detach().requires_grad_(True) for b in bottoms]

        def fb(ps=ps, bs=bs, leaves=leaves, _l=layer):
            tops = _l(ps, bs, True)
            total = sum(t.float().sum() for t in tops)
            return torch.autograd.grad(total, leaves + bs,
                                       allow_unused=True)

        try:
            bwd_l = max(_timed_ms(fb, iterations, net.device) - fwd_l, 0.0)
            print(f"{layer.name:<24}{layer.TYPE:<22}{fwd_l:>10.3f}"
                  f"{bwd_l:>10.3f}", flush=True)
        except Exception:  # noqa: BLE001 — no backward (data, accuracy)
            print(f"{layer.name:<24}{layer.TYPE:<22}{fwd_l:>10.3f}"
                  f"{'-':>10}", flush=True)


def _comm_table(net, args, fb_ms: float) -> None:
    """The static per-layer comm bytes over ``--comm_devices`` devices
    (``--dcn_slices`` of them two-tier), as the JAX command prints it."""
    from ..parallel.mesh import DATA_AXIS, DCN_AXIS
    from ..parallel.strategies import CommConfig, auto_strategies
    from .comm_stats import comm_summary, layer_comm_table

    n, slices = args.comm_devices, args.dcn_slices
    wire = args.wire_dtype or None
    block = args.topk_block or None
    if slices > 1:
        if n % slices:
            raise SystemExit(f"--dcn_slices {slices} does not divide "
                             f"--comm_devices {n}")
        shape = {DCN_AXIS: slices, DATA_AXIS: n // slices}
        cc = CommConfig(dcn_axis=DCN_AXIS, default_strategy=args.strategy,
                        wire_dtype=wire, topk_block=block)
    else:
        shape = {DATA_AXIS: n}
        cc = CommConfig(default_strategy=args.strategy, wire_dtype=wire,
                        topk_block=block)
    if args.sfb_auto:
        cc.layer_strategies.update(auto_strategies(net))
    table = layer_comm_table(net, cc, shape)
    print(f"\nComm bytes/step/device over {n} devices"
          + (f" ({slices} DCN slices)" if slices > 1 else "") + ":")
    print(f"{'layer':<24}{'strategy':<8}{'ici B':>12}{'dcn B':>12}"
          f"{'vs dense':>10}{'est ms':>9}")
    for lname, row in table.items():
        print(f"{lname:<24}{row['strategy']:<8}"
              f"{row['ici_bytes_per_step']:>12}"
              f"{row['dcn_bytes_per_step']:>12}"
              f"{str(row['savings_vs_dense'] or '-'):>10}"
              f"{row['est_comm_ms']:>9}")
    summary = comm_summary(table, fb_ms)
    print(f"total: {summary['total_bytes_per_step']} B/step/dev, "
          f"{summary['savings_vs_dense'] or '-'}x vs dense, "
          f"est comm {summary['est_comm_ms_per_step']} ms "
          f"({summary.get('est_comm_fraction_if_unoverlapped', 0):.0%} of "
          f"measured step if unoverlapped)", flush=True)


def cmd_time(args) -> int:
    """The reference's ``caffe time`` (tools/caffe_main.cpp:256-328): the
    TRAIN net's forward and forward+backward, each after one warm-up call
    and averaged over ``--iterations``; with ``--per_layer`` each layer
    alone first, and the comm table."""
    import torch

    from ..core.net import Net
    from ..proto.messages import load_net

    net_param = load_net(args.model)
    shapes = {} if net_param.input else _time_shapes(net_param,
                                                     args.batch_size)
    net = Net(net_param, "TRAIN", device=args.device or None,
              source_shapes=shapes, conv_layout="AUTO")
    batch = net.blob_shapes[net.input_names[0]][0]
    params = net.init(torch.Generator().manual_seed(0))
    nhwc = net.conv_layout == "NHWC"
    inputs = {name: _zeros(net.blob_shapes[name], net.device, nhwc)
              for name in net.input_names}

    if args.per_layer:
        _layer_times(net, params, args.iterations)

    def forward():
        with torch.no_grad():
            return net.apply(params, inputs, train=True).loss

    leaves = [v.detach().requires_grad_(True)
              for lp in params.values() for v in lp.values()]
    it = iter(leaves)
    grad_params = {l: {p: next(it) for p in lp} for l, lp in params.items()}

    def forward_backward():
        loss = net.apply(grad_params, inputs, train=True).loss
        if not loss.requires_grad:    # no loss layer: nothing to derive
            return loss
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    fwd_ms = _timed_ms(forward, args.iterations, net.device)
    fb_ms = _timed_ms(forward_backward, args.iterations, net.device)
    if args.per_layer and args.comm_devices > 1:
        _comm_table(net, args, fb_ms)
    print(f"Average Forward pass: {fwd_ms:.3f} ms")
    print(f"Average Forward-Backward: {fb_ms:.3f} ms")
    print(f"Throughput: {batch / (fb_ms / 1e3):.1f} images/s "
          f"(batch {batch})", flush=True)
    return 0


def cmd_convert_imageset(args) -> int:
    from .tools import convert_imageset
    convert_imageset(args.listfile, args.out_db, root_folder=args.root_folder,
                     resize_height=args.resize_height,
                     resize_width=args.resize_width, shuffle=args.shuffle,
                     gray=args.gray)
    return 0


def cmd_compute_image_mean(args) -> int:
    from .tools import compute_image_mean
    compute_image_mean(args.db, args.out_file)
    return 0


def cmd_partition_data(args) -> int:
    from .tools import partition_data
    partition_data(args.db, args.num_shards)
    return 0


def cmd_convert_db(args) -> int:
    from .tools import convert_db
    convert_db(args.src, args.out, args.backend)
    return 0


def cmd_extract_features(args) -> int:
    """Dump named blobs of the TEST phase's forward; each rank of a
    hostfile or env-contract cluster extracts its own record shard into
    its own databases ('<prefix>_client<rank>', feature_extractor.cpp's
    per-client naming). No collective runs, so no process group is
    made."""
    import torch

    from ..core.net import Net
    from ..data.pipeline import build_phase_pipelines
    from ..data.workload import Shard
    from ..numeric import resolve_device
    from ..proto.messages import load_net
    from .checkpoint import load_caffemodel
    from .cluster import env_world, hostfile_world, local_device
    from .tools import extract_features

    rank, world, _ = (hostfile_world(args.hostfile, _node_id(args))
                      if args.hostfile else env_world())
    device = local_device(resolve_device(args.device or None), rank)
    net_param = load_net(args.model)
    pipes, shapes = build_phase_pipelines(net_param, "TEST",
                                          shard=Shard(rank, world))
    try:
        net = Net(net_param, "TEST", device=device, source_shapes=shapes,
                  conv_layout="AUTO")
        params = net.init(torch.Generator().manual_seed(0))
        if args.weights:
            params = load_caffemodel(args.weights, net, params)
        prefix = (args.out_prefix if world == 1
                  else f"{args.out_prefix}_client{rank}")
        extract_features(net, params, args.blobs.split(","), pipes[0],
                         args.num_batches, prefix)
    finally:
        for p in pipes:
            p.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="poseidon_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train a model from a solver prototxt")
    t.add_argument("--solver", required=True)
    t.add_argument("--snapshot", default="",
                   help="resume from a .solverstate.npz, or 'auto' for the "
                        "newest one under the solver's snapshot_prefix")
    t.add_argument("--weights", default="",
                   help="initialize from a .caffemodel")
    t.add_argument("--output_dir", default=".")
    t.add_argument("--device", default="",
                   help="cuda (the default; refuses to run without a GPU) "
                        "or cpu")
    t.add_argument("--strategy", default="dense",
                   choices=["dense", "sfb", "topk"],
                   help="default gradient sync strategy (topk: top-k "
                        "compressed sync with error feedback, fraction "
                        "0.01)")
    t.add_argument("--sfb-auto", action="store_true",
                   help="pick SFB per FC layer by the cost model (SACP)")
    t.add_argument("--grad-reduce", default="mean", choices=["mean", "sum"])
    t.add_argument("--wire_dtype", default="",
                   choices=["", "f32", "bf16", "f16", "int8"],
                   help="cast gradients (and SFB factors) to this dtype for "
                        "every collective; empty = the gradient's dtype "
                        "(int8: the async tier's deltas only, with "
                        "--async_ssp)")
    t.add_argument("--dwbp_bucket_mb", type=float, default=-1.0,
                   help="bucket size of the all-reduces issued during "
                        "backward; 0 = one a leaf, negative = the arena's "
                        "(--arena_bucket_mb)")
    t.add_argument("--param_arena", default="true", choices=["true", "false"],
                   help="false: one all-reduce a leaf. Unlike the JAX "
                        "flag it keeps the arena and its one fused update: "
                        "the JAX package's per-leaf update path is not "
                        "in the port")
    t.add_argument("--arena_bucket_mb", type=float, default=None,
                   help="arena gradient-sync bucket size in MB, DWBP-"
                        "ordered exact element ranges; <= 0 = one a leaf "
                        "(unset: the tuned plan's, else 4)")
    t.add_argument("--topk_policy", default="magnitude",
                   choices=["magnitude", "random", "fixed_order"],
                   help="which entries the TOPK budget sends (the "
                        "server's UpdateSortPolicy)")
    t.add_argument("--topk_block", type=int, default=0,
                   help="blocked top-k: pick within blocks of this many "
                        "elements instead of one global selection; 0 = "
                        "global")
    t.add_argument("--dcn_slices", type=int, default=0,
                   help="split the ranks into N slices (the two-tier "
                        "group): dense sync inside a slice, TOPK-"
                        "compressed exchange between slices; N must "
                        "divide the world")
    t.add_argument("--staleness", type=int, default=0,
                   help="SSP bound s: devices run local steps, reconciling "
                        "every s+1 iters (0 = synchronous, the reference's "
                        "recommended setting)")
    t.add_argument("--server_logic", default="inc",
                   choices=["inc", "adarevision"],
                   help="SSP anchor update rule: plain delta increment "
                        "(inc) or delay-corrected AdaGrad (the server's "
                        "adarevision_server_table_logic); needs --staleness")
    t.add_argument("--adarev_init_step", type=float, default=0.1,
                   help="adarevision server init_step_size; scales the SUM "
                        "of group updates (reduce is ignored — the server "
                        "applies every group's full update, the reference's "
                        "RowBatchInc semantics), so ~base_lr/n_groups is "
                        "the stable regime")
    t.add_argument("--async_ssp", action="store_true",
                   help="wait-free asynchronous SSP across launcher "
                        "processes (the Bösen execution model, "
                        "parallel/async_ssp.py): each process trains on "
                        "its own device, parameter increments stream to a "
                        "rank-0 service, reads gate on --staleness; no "
                        "process group, no cross-process barrier")
    t.add_argument("--async_sync_every", type=int, default=1,
                   help="optimizer iterations per async-SSP flush clock")
    t.add_argument("--comm_budget_mbps", type=float, default=-1.0,
                   help="managed communication (SSPAggr): per-link "
                        "bandwidth budget in Mbit/s for the async-SSP "
                        "tier, metered as a token bucket over ACTUAL "
                        "frame bytes on both push and pull channels. A "
                        "tight budget switches to magnitude-prioritized "
                        "PARTIAL pushes (top --comm_priority_frac of the "
                        "delta by |value|, TOPK index+value wire form) "
                        "with the exact complement carried locally and "
                        "force-flushed every staleness+1 clocks; read "
                        "gates run on fully-flushed (durable) clocks so "
                        "the SSP bound is preserved exactly. <= 0 = "
                        "unlimited — byte-for-byte the dense path")
    t.add_argument("--comm_priority_frac", type=float, default=-1.0,
                   help="fraction of delta entries a budget-tight partial "
                        "push ships, ranked by |value| across the whole "
                        "update (default 0.1); negative = the "
                        "ManagedCommConfig default")
    t.add_argument("--comm_adaptive", action="store_true",
                   help="adaptive push cadence: under congestion (token-"
                        "bucket deficit or flushes queuing behind a slow "
                        "link) intermediate clocks ship as ~100-byte "
                        "ticks and the payload rides the next boundary "
                        "flush, recovering as the link drains "
                        "(cadence_backoffs counts escalations)")
    t.add_argument("--async_heartbeat_s", type=float, default=-1.0,
                   help="async-SSP client heartbeat cadence (liveness "
                        "signal when the flush queue is idle); negative = "
                        "FaultConfig default")
    t.add_argument("--async_liveness_timeout_s", type=float, default=-1.0,
                   help="async-SSP service evicts a worker silent this "
                        "long (survivors' gates unblock; 0 disables — the "
                        "reference's hang-forever semantics); negative = "
                        "FaultConfig default")
    t.add_argument("--async_reconnect_deadline_s", type=float, default=-1.0,
                   help="async-SSP client gives up reconnecting (and "
                        "surfaces permanent failure to the training loop) "
                        "after this long; negative = FaultConfig default")
    t.add_argument("--async_gate_timeout_s", type=float, default=-1.0,
                   help="async-SSP read-gate backstop per clock; negative "
                        "= tier default (120 s)")
    t.add_argument("--async_first_gate_timeout_s", type=float, default=-1.0,
                   help="async-SSP FIRST-clock gate backstop (covers "
                        "peers' first kernel builds); negative = "
                        "max(1800 s, 10x gate timeout)")
    t.add_argument("--mesh", default="",
                   help="named SPMD mesh spec, e.g. 'dp2,fsdp2,tp1' "
                        "(axes: dp = data parallel, fsdp = sharded "
                        "parameter arena with reduce-scatter/all-gather "
                        "buckets, tp = tensor-parallel FC column/row "
                        "shards planned per layer; one rank a device, "
                        "the world exactly dp*fsdp*tp); a trailing "
                        "'replicated' runs the control arm. fsdp here "
                        "keeps the full buffers on every rank and saves "
                        "no memory (only the sharded_state API holds 1/F "
                        "a rank). Empty = the flat data group")
    # a flag of the JAX CLI that the port does not cover yet: it raises
    # NotImplementedError naming its ROADMAP item
    t.add_argument("--slice", action="store_true",
                   help="two-tier fabric (parallel/fabric.py): under "
                        "--async_ssp and the POSEIDON_SLICE_ID/"
                        "POSEIDON_SLICE_SIZE env contract, each slice of "
                        "contiguous ranks trains synchronously over its "
                        "own process group (--mesh inside the slice) and "
                        "its leader speaks the async tier with the slice "
                        "id as its worker id")
    t.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="run K optimizer steps per dispatch (on the card "
                        "one CUDA graph of the K steps, captured once and "
                        "replayed): amortizes the host's per-step launch "
                        "cost; falls back to single steps near "
                        "display/test/snapshot boundaries and inside the "
                        "--profile window (unset: the tuned plan's, "
                        "else 1)")
    t.add_argument("--hbm_budget_gb", type=float, default=None,
                   help="per-device memory budget (GiB) for the measured "
                        "remat planner (core/remat.py): one no-remat "
                        "forward and backward measures the card's peak, "
                        "and a greedy cheapest-recompute-per-byte "
                        "knapsack checkpoints layers until the step fits. "
                        "Negative = the device's own limit (none on the "
                        "CPU: a warning, no plan); 0 or unset = no budget")
    t.add_argument("--remat", default=None,
                   help="activation remat override: a comma-separated "
                        "layer list checkpoints exactly those layers (no "
                        "measuring run), 'auto' plans against "
                        "--hbm_budget_gb, 'none' forces remat off "
                        "(unset = off)")
    t.add_argument("--device_prefetch", type=int, default=None,
                   help="device-side input prefetch depth: a background "
                        "stage copies the next N host batches onto the "
                        "card (pinned buffers, its own CUDA stream) while "
                        "the current step runs; 0 copies each batch inline "
                        "(default: the PipelineConfig policy, 2)")
    t.add_argument("--max_in_flight", type=int, default=None,
                   help="bounded in-flight dispatch window: dispatch step "
                        "k+1 before step k's metrics are read, blocking "
                        "only when this many dispatches are unread; 1 = "
                        "the serial loop. Loss display and NaN detection "
                        "lag by at most this many steps (default: the "
                        "PipelineConfig policy, 2)")
    t.add_argument("--async_snapshot", action="store_true", default=None,
                   help="serialize mid-train snapshots on a background "
                        "thread (host copy taken at the sync point; the "
                        "atomic tmp-rename protocol and auto-resume "
                        "semantics are unchanged; default: the "
                        "PipelineConfig policy, off)")
    t.add_argument("--device_transform", action="store_true",
                   help="ship uint8 crops and apply (x - mean_value) * "
                        "scale on the card (4x fewer host->device bytes; "
                        "needs the native batcher, mean_value-style mean)")
    t.add_argument("--bf16", action="store_true",
                   help="the bf16 training path (numeric.set_perf_policy): "
                        "bfloat16 activations and conv/GEMM operands, f32 "
                        "parameters, momentum, update and softmax "
                        "statistics, the space-to-depth stem rewrite; "
                        "accuracy band numeric.BF16_SMOKE_*. Default f32 "
                        "keeps Caffe numerics")
    t.add_argument("--conv_layout", default="", type=lambda s: s.lower(),
                   choices=["", "nchw", "nhwc", "auto"],
                   help="activation layout of the whole CNN graph "
                        "(core/net.py plans conv/pool/LRN natively in it; "
                        "snapshots stay canonical NCHW). Unset = 'auto': "
                        "NHWC (channels-last) on the card, NCHW on the CPU")
    t.add_argument("--conv_strategy", default="",
                   choices=["", "auto", "direct", "im2col", "s2d"],
                   help="conv lowering: 'direct', 'im2col' (patches and "
                        "one GEMM) or 's2d' (the space-to-depth stem "
                        "rewrite where a conv's shape allows it) net-wide, "
                        "or 'auto': a measured winner a conv layer "
                        "(ops/conv_tune.py, persisted in the tuned store); "
                        "empty = the tuned plan's, else the policy's "
                        "conv_s2d (on under --bf16)")
    t.add_argument("--tuned_plan", default="auto", choices=["auto", "off"],
                   help="'auto' loads the persisted tuned plan of (train "
                        "net, backend, devices) and fills every knob no "
                        "flag set (provenance in stats.yaml); 'off' = "
                        "built-in defaults and flags only")
    t.add_argument("--compile_cache_dir", default="",
                   help="fast restart: the kernel store (the nvcc-built "
                        "kernel libraries and the data plane under "
                        "<dir>/kernels/, keyed by source, headers, "
                        "compiler and flags) and the tuned store (plans "
                        "and conv winners under <dir>/tuned/); empty = "
                        "POSEIDON_COMPILE_CACHE_DIR, else kernels build "
                        "into the checkout's build/ and plans use the "
                        "default store")
    t.add_argument("--census", action="store_true",
                   help="record the first train step's ops (its "
                        "collectives, layout conversions and dtypes) and "
                        "write <output_dir>/census.json "
                        "(runtime/op_census.py; needs --steps_per_dispatch "
                        "1)")
    t.add_argument("--aot_steps", default="true", choices=["true", "false"],
                   help="with --compile_cache_dir: key the train step and "
                        "build or load every kernel library before the "
                        "first step (no step executable is stored: see "
                        "runtime/compile_cache.py)")
    t.add_argument("--profile", type=int, default=0,
                   help="trace N single steps from the third with "
                        "torch.profiler into <output_dir>/profile/ and "
                        "print the per-layer attribution table")
    t.add_argument("--trace_out", default="",
                   help="host-side span timeline: record prefetch-wait/"
                        "dispatch/hard-sync/snapshot spans and write "
                        "Chrome trace-event JSON here (relative to "
                        "--output_dir), refreshed atomically at every "
                        "display boundary")
    t.add_argument("--metrics_port", type=int, default=-1,
                   help="serve the run's stats (stats.yaml's counters, "
                        "gauges and sections) read-only over HTTP on this "
                        "port, bound by rank 0 (0 = ephemeral on every "
                        "rank, printed at startup); -1 = off")
    _cluster_flags(t)
    t.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="score a net's TEST phase")
    te.add_argument("--model", required=True)
    te.add_argument("--weights", default="")
    te.add_argument("--iterations", type=int, default=50)
    te.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    _cluster_flags(te)
    te.set_defaults(fn=cmd_test)

    ti = sub.add_parser("time", help="time a model's forward and backward")
    ti.add_argument("--model", required=True)
    ti.add_argument("--iterations", type=int, default=50)
    ti.add_argument("--batch_size", type=int, default=64,
                    help="the batch of a data layer that names none")
    ti.add_argument("--per_layer", action="store_true",
                    help="also time each layer's forward and backward "
                         "alone")
    ti.add_argument("--comm_devices", type=int, default=0,
                    help="with --per_layer: print the static per-layer "
                         "comm bytes and savings over this many devices")
    ti.add_argument("--dcn_slices", type=int, default=0,
                    help="with --comm_devices: a two-tier group of this "
                         "many slices")
    ti.add_argument("--strategy", default="dense",
                    choices=["dense", "sfb", "topk"])
    ti.add_argument("--sfb-auto", action="store_true",
                    help="pick SFB per FC layer by the cost model")
    ti.add_argument("--wire_dtype", default="",
                    choices=["", "f32", "bf16", "f16"],
                    help="bill the comm table at this wire width")
    ti.add_argument("--topk_block", type=int, default=0)
    ti.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    ti.set_defaults(fn=cmd_time)

    dq = sub.add_parser("device_query", help="show the CUDA devices")
    dq.add_argument("--device", default="",
                    help="cpu: also report the CPU, and succeed without a "
                         "GPU")
    dq.set_defaults(fn=cmd_device_query)
    sv = sub.add_parser("serve", help="serve a deploy net over TCP "
                                      "(dynamic micro-batching, bucketed "
                                      "executor), or with --generate a "
                                      "transformer LM (continuous batching)")
    sv.add_argument("--model", required=True,
                    help="deploy prototxt; with --generate a preset: "
                         + "|".join(LLM_PRESETS))
    sv.add_argument("--generate", action="store_true",
                    help="serve the generate op: paged KV cache and "
                         "continuous batching over a seeded transformer "
                         "preset")
    sv.add_argument("--weights", default="",
                    help="a .caffemodel or .solverstate.npz to serve; "
                         "empty serves filler init (smoke mode)")
    sv.add_argument("--buckets", default="",
                    help="batch bucket ladder; every bucket is warmed at "
                         "startup (unset: the tuned plan's, else "
                         "1,4,16,64)")
    sv.add_argument("--tuned_plan", default="auto", choices=["auto", "off"],
                    help="'auto' resolves an unset --buckets (with "
                         "--generate: the page size, decode rungs and "
                         "prompt buckets) through the persisted tuned "
                         "plan; 'off' = built-in defaults")
    sv.add_argument("--compile_cache_dir", default="",
                    help="the kernel store's and the tuned store's "
                         "directory (<dir>/kernels/, <dir>/tuned/; empty "
                         "= POSEIDON_COMPILE_CACHE_DIR, else build/ and "
                         "the default store)")
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address; the protocol is pickle-framed and "
                         "unauthenticated — loopback/trusted networks only")
    sv.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    sv.add_argument("--max_delay_ms", type=float, default=5.0,
                    help="micro-batcher flush deadline")
    sv.add_argument("--max_queue", type=int, default=64,
                    help="admission bound; a full queue sheds explicitly")
    sv.add_argument("--deadline_ms", type=float, default=0.0,
                    help="default per-request deadline (0 = none)")
    sv.add_argument("--watch", default="",
                    help="snapshot prefix to poll for hot reload (e.g. "
                         "out/snap/lenet), or 'auto' to derive it from "
                         "--weights' _iter_ naming")
    sv.add_argument("--poll_s", type=float, default=1.0,
                    help="hot-reload watch cadence")
    _fleet_flags(sv)
    sv.add_argument("--metrics_port", type=int, default=-1,
                    help="serve live fleet health over HTTP on this port "
                         "(0 = ephemeral, printed at startup); -1 = off")
    sv.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    sv.set_defaults(fn=cmd_serve)

    bs = sub.add_parser(
        "bench_serve", help="serving latency microbenchmark (in-process "
                            "server + load generator, ONE JSON line)")
    bs.add_argument("--model", default="",
                    help="deploy prototxt; empty uses a built-in synthetic "
                         "conv net")
    bs.add_argument("--weights", default="")
    bs.add_argument("--buckets", default="",
                    help="batch bucket ladder (unset: the tuned plan's "
                         "for --model, else 1,4,16,64)")
    bs.add_argument("--tuned_plan", default="auto", choices=["auto", "off"])
    bs.add_argument("--compile_cache_dir", default="",
                    help="the kernel store's and the tuned store's "
                         "directory (as serve's)")
    bs.add_argument("--requests", type=int, default=200)
    bs.add_argument("--concurrency", type=int, default=4)
    bs.add_argument("--batch", type=int, default=8,
                    help="request sizes cycle 1..batch (exercises the "
                         "bucket ladder)")
    bs.add_argument("--max_delay_ms", type=float, default=5.0)
    bs.add_argument("--max_queue", type=int, default=64)
    bs.add_argument("--deadline_ms", type=float, default=0.0)
    _fleet_flags(bs)
    bs.add_argument("--offered_rps", type=float, default=0.0,
                    help="open-loop mode: fixed arrival rate (req/s); "
                         "0 = closed loop")
    bs.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    bs.set_defaults(fn=cmd_bench_serve)

    tu = sub.add_parser(
        "tune", help="measured autotuner: short wall-clock trials over "
                     "the policy space (conv layout and strategy, arena "
                     "buckets, steps a dispatch, pipeline, serving rungs, "
                     "LM serving, wire dtype, remat and batch), persisted "
                     "as one plan that train/serve load")
    tu.add_argument("--model", default="lenet",
                    choices=["lenet", "alexnet", "googlenet"],
                    help="tune target (the plan is keyed by the net's name, "
                         "so a train run of the same model loads it)")
    tu.add_argument("--smoke", action="store_true",
                    help="small shapes and 2-point search spaces (the CPU "
                         "tests' size)")
    tu.add_argument("--force", action="store_true",
                    help="measure again even when a matching plan is "
                         "persisted")
    tu.add_argument("--deploy", default="",
                    help="deploy prototxt for the serving-ladder trials "
                         "(default: a synthetic probe net, labeled)")
    tu.add_argument("--windows", type=int, default=0,
                    help="interleaved timing windows a trial (0 = 2 under "
                         "--smoke, else 4)")
    tu.add_argument("--iters", type=int, default=0,
                    help="calls a window (0 = 2 under --smoke, else 4)")
    tu.add_argument("--out", default="",
                    help="also write the plan document here")
    tu.add_argument("--compile_cache_dir", default="",
                    help="the kernel store's and the tuned store's "
                         "directory (<dir>/kernels/, <dir>/tuned/; empty "
                         "= POSEIDON_COMPILE_CACHE_DIR, else build/ and "
                         "the default store)")
    tu.add_argument("--aot_steps", default="true",
                    choices=["true", "false"], help=argparse.SUPPRESS)
    tu.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    tu.set_defaults(fn=cmd_tune)

    ci = sub.add_parser("convert_imageset", help="image list -> LMDB")
    ci.add_argument("listfile")
    ci.add_argument("out_db")
    ci.add_argument("--root_folder", default="")
    ci.add_argument("--resize_height", type=int, default=0)
    ci.add_argument("--resize_width", type=int, default=0)
    ci.add_argument("--shuffle", action="store_true")
    ci.add_argument("--gray", action="store_true")
    ci.set_defaults(fn=cmd_convert_imageset)

    cm = sub.add_parser("compute_image_mean", help="LMDB -> mean binaryproto")
    cm.add_argument("db")
    cm.add_argument("out_file")
    cm.set_defaults(fn=cmd_compute_image_mean)

    pd = sub.add_parser("partition_data", help="split LMDB into k shards")
    pd.add_argument("db")
    pd.add_argument("num_shards", type=int)
    pd.set_defaults(fn=cmd_partition_data)

    cd = sub.add_parser("convert_db", help="copy LevelDB<->LMDB")
    cd.add_argument("src")
    cd.add_argument("out")
    cd.add_argument("--backend", default="LMDB", choices=["LMDB", "LEVELDB"])
    cd.set_defaults(fn=cmd_convert_db)

    ef = sub.add_parser("extract_features",
                        help="dump named blobs to LMDBs")
    ef.add_argument("--model", required=True)
    ef.add_argument("--weights", default="")
    ef.add_argument("--blobs", required=True,
                    help="comma-separated blob names")
    ef.add_argument("--num_batches", type=int, default=10)
    ef.add_argument("--out_prefix", required=True)
    ef.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    _cluster_flags(ef)
    ef.set_defaults(fn=cmd_extract_features)
    return p


def _cluster_flags(sp) -> None:
    """``--hostfile`` and ``--node_id`` (the JAX CLI's)."""
    sp.add_argument("--hostfile", default="",
                    help="cluster hostfile ('<id> <ip> <port>' lines; host "
                         "0 is the coordinator) in place of the env "
                         "contract")
    sp.add_argument("--node_id", type=int, default=-1,
                    help="this process's hostfile id")



def _fleet_flags(sp) -> None:
    """``--replicas`` and ``--devices``, shared by serve and bench_serve."""
    sp.add_argument("--replicas", type=int, default=1,
                    help="serving replicas behind the one front door, each "
                         "its own executor + batcher (least-loaded routing, "
                         "per-replica health, rolling reload); 1 = the "
                         "single-engine path")
    sp.add_argument("--devices", default="",
                    help="comma-separated CUDA device indices to pin "
                         "replicas to, round-robin (e.g. '0,1', or '0,0' "
                         "for two on one card); empty = every visible GPU "
                         "when --replicas > 1")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
