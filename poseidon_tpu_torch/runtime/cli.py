"""Command line of the port (the ``train``, ``test`` and ``serve`` commands
of ``poseidon_tpu/runtime/cli.py``)::

    python -m poseidon_tpu_torch train --solver=<solver.prototxt> \\
        [--snapshot=<.solverstate.npz>|auto] [--weights=<.caffemodel>] \\
        [--output_dir .] [--device cuda|cpu] [--strategy dense|sfb|topk] \\
        [--sfb-auto] [--grad-reduce mean|sum] [--wire_dtype f32|bf16|f16] \\
        [--topk_policy magnitude|random|fixed_order] [--topk_block N] \\
        [--dcn_slices N] [--staleness S] \\
        [--server_logic inc|adarevision] [--adarev_init_step X] \\
        [--async_ssp [--async_sync_every N] [--comm_budget_mbps X] \\
         [--comm_priority_frac X] [--comm_adaptive] \\
         [--async_{heartbeat,liveness_timeout,reconnect_deadline,\\
                   gate_timeout,first_gate_timeout}_s X]] \\
        [--dwbp_bucket_mb N] [--param_arena true|false] \\
        [--arena_bucket_mb N] [--device_prefetch N] [--max_in_flight N] \\
        [--async_snapshot] [--device_transform] [--trace_out <file>] \\
        [--bf16] [--conv_layout nchw|nhwc|auto] [--conv_strategy direct|s2d]
    python -m poseidon_tpu_torch test --model=<train_val.prototxt> \\
        [--weights=<.caffemodel>] [--iterations 50] [--device cuda|cpu]
    python -m poseidon_tpu_torch serve --model=<deploy.prototxt> \\
        [--weights=<.caffemodel|.solverstate.npz>] [--buckets 1,4,16,64] \\
        [--host 127.0.0.1] [--port 0] [--max_delay_ms 5] [--max_queue 64] \\
        [--deadline_ms 0] [--device cuda|cpu]
    python -m poseidon_tpu_torch serve --generate --model tiny|gpt_small \
        [--host 127.0.0.1] [--port 0] [--max_queue 64] [--deadline_ms 0] \
        [--device cuda|cpu]

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
``--conv_strategy`` forces a conv lowering net-wide. The policy holds for
the command and is restored when it returns. Data-parallel runs start one ``train`` process per rank
under the env contract of ``runtime/cluster.py`` (``POSEIDON_PROC_ID``,
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
the deltas with exact error feedback. ``--mesh`` and ``--slice`` raise
``NotImplementedError`` naming their ROADMAP item. ``test`` scores a
net's
TEST phase and prints one ``<output>: <mean>`` line per scalar output. ``serve`` warms every bucket,
logs ``serve: listening on <host>:<port>``, serves until SIGTERM/SIGINT,
drains every admitted request, prints one ``serving_final_stats`` JSON line
and exits 0. ``serve --generate`` serves a transformer preset with seeded
weights (paged KV cache, continuous batching, the ``generate`` wire op)
behind the same front door and the same shutdown. Every command runs on
``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import signal
from typing import List, Optional

from .metrics import log

LLM_PRESETS = ("tiny", "gpt_small")


def build_generate_executor(preset: str, device=None):
    """A warmed paged-KV ``GenerateExecutor`` over a named transformer
    preset with seeded weights (``--generate`` has no snapshot format yet,
    as in the JAX package), with the built-in page size, decode rungs and
    prompt buckets."""
    import torch

    from ..models.transformer import (TransformerConfig, gpt_small_config,
                                      init_params)
    from ..numeric import resolve_device
    from ..serving.continuous import (DEFAULT_DECODE_RUNGS,
                                      DEFAULT_PAGE_SIZE,
                                      DEFAULT_PROMPT_BUCKETS,
                                      GenerateExecutor)

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
    params = init_params(cfg, torch.Generator().manual_seed(0))
    # a preset smaller than the default ladder drops the buckets it cannot
    # hold rather than refusing to serve
    buckets = tuple(b for b in DEFAULT_PROMPT_BUCKETS if b < cfg.max_seq)
    return GenerateExecutor(cfg, params, page_size=DEFAULT_PAGE_SIZE,
                            decode_rungs=DEFAULT_DECODE_RUNGS,
                            prompt_buckets=buckets, device=device)


def cmd_serve(args) -> int:
    from ..serving.server import InferenceServer

    if args.generate:
        if args.weights:
            raise SystemExit("--generate serves seeded preset weights; "
                             "--weights has no LLM snapshot format yet")
        executor = build_generate_executor(args.model,
                                           device=args.device or None)
        log(f"serve: warmed generate executor ({args.model}, "
            f"{executor.cfg.n_params()} params, page_size="
            f"{executor.page_size}, rungs={executor.decode_rungs}, "
            f"buckets={executor.prompt_buckets}) on {executor.device}")
    else:
        from ..serving.executor import BucketedExecutor, parse_buckets
        executor = BucketedExecutor.from_files(
            args.model, args.weights or None,
            buckets=parse_buckets(args.buckets), device=args.device or None)
        log(f"serve: warmed buckets {executor.buckets} on {executor.device} "
            f"({executor.net.name or 'net'}, {executor.net.param_count()} "
            f"params)")
    if args.host not in ("127.0.0.1", "localhost", "::1"):
        log(f"serve: WARNING: binding {args.host!r} — the wire format is "
            f"pickled frames (arbitrary code execution for anyone who can "
            f"connect); serve only on loopback or a trusted network")
    server = InferenceServer(
        executor, host=args.host, port=args.port,
        max_delay_s=args.max_delay_ms / 1e3, max_queue=args.max_queue,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms > 0 else None))
    log(f"serve: listening on {server.host}:{server.port}"
        + (" (generate op)" if args.generate else ""))

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
    print(json.dumps({"serving_final_stats": server.stats_snapshot()}),
          flush=True)
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

    if args.mesh:
        if args.dcn_slices > 1:
            raise SystemExit("--mesh and --dcn_slices do not compose: the "
                             "named mesh's axes carry the whole topology")
        raise NotImplementedError(
            "--mesh (the SPMD mesh planner, parallel/spmd.py) is not in "
            "the port yet (ROADMAP queue A item 9, part 5)")
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
        bucket_mb=bucket_mb_of(args.dwbp_bucket_mb,
                               args.param_arena == "true",
                               args.arena_bucket_mb),
        dcn_axis=DCN_AXIS if args.dcn_slices > 1 else None,
        server_logic=args.server_logic,
        adarev_init_step=args.adarev_init_step)


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
    if args.slice:
        raise NotImplementedError(
            "--slice (the two-tier fabric, parallel/fabric.py) is not in "
            "the port yet (ROADMAP queue A item 9, part 6)")
    if not args.async_ssp:
        return args.staleness, None
    cfg = {"staleness": args.staleness,
           "sync_every": args.async_sync_every}
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


def train_policy(args) -> dict:
    """The numeric-policy fields the ``train`` flags set (JAX's
    ``cmd_train``: ``--bf16`` is ``set_perf_policy``, then the layout and
    strategy flags; an unset ``--conv_layout`` is "auto", as in JAX without
    a tuned plan)."""
    import torch
    out = {"conv_layout": (args.conv_layout or "auto").upper()}
    if args.bf16:
        out.update(compute_dtype=torch.bfloat16, conv_s2d=True)
    if args.conv_strategy:
        out["conv_strategy"] = args.conv_strategy
    return out


def cmd_train(args) -> int:
    from ..numeric import policy_scope

    with policy_scope(**train_policy(args)):
        return _train(args)


def _train(args) -> int:
    from ..proto.messages import load_solver
    from .engine import Engine

    comm = comm_from_args(args)
    staleness, async_cfg = async_from_args(args)
    eng = Engine(load_solver(args.solver), output_dir=args.output_dir,
                 device=args.device or None, comm=comm,
                 staleness=staleness, async_ssp=async_cfg,
                 sfb_auto=args.sfb_auto,
                 device_prefetch=args.device_prefetch,
                 max_in_flight=args.max_in_flight,
                 async_snapshot=args.async_snapshot,
                 device_transform=args.device_transform,
                 trace_out=args.trace_out or None,
                 dcn_slices=args.dcn_slices)
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


def cmd_test(args) -> int:
    import torch

    from ..core.net import Net
    from ..data.pipeline import build_phase_pipelines
    from ..parallel.trainer import build_eval_step
    from ..proto.messages import load_net
    from .checkpoint import load_caffemodel

    net_param = load_net(args.model)
    pipes, shapes = build_phase_pipelines(net_param, "TEST")
    try:
        net = Net(net_param, "TEST", device=args.device or None,
                  source_shapes=shapes)
        params = net.init(torch.Generator().manual_seed(0))
        if args.weights:
            params = load_caffemodel(args.weights, net, params)
        ev = build_eval_step(net)
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
    for k in sorted(acc):
        print(f"{k}: {acc[k] / args.iterations:.4f}", flush=True)
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
    t.add_argument("--arena_bucket_mb", type=float, default=4.0,
                   help="arena gradient-sync bucket size in MB, DWBP-"
                        "ordered exact element ranges; <= 0 = one a leaf")
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
    # flags of the JAX CLI that the port does not cover yet: each raises
    # NotImplementedError naming its ROADMAP item
    t.add_argument("--mesh", default="")
    t.add_argument("--slice", action="store_true")
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
                   choices=["", "direct", "s2d"],
                   help="conv lowering forced net-wide: 'direct', or 's2d' "
                        "(the space-to-depth stem rewrite where a conv's "
                        "shape allows it); empty = the policy's conv_s2d "
                        "(on under --bf16). The JAX package's measured "
                        "'auto' and 'im2col' need ops/conv_tune.py, not in "
                        "the port yet")
    t.add_argument("--trace_out", default="",
                   help="host-side span timeline: record prefetch-wait/"
                        "dispatch/hard-sync/snapshot spans and write "
                        "Chrome trace-event JSON here (relative to "
                        "--output_dir), refreshed atomically at every "
                        "display boundary")
    t.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="score a net's TEST phase")
    te.add_argument("--model", required=True)
    te.add_argument("--weights", default="")
    te.add_argument("--iterations", type=int, default=50)
    te.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    te.set_defaults(fn=cmd_test)
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
    sv.add_argument("--buckets", default="1,4,16,64",
                    help="batch bucket ladder; every bucket is warmed at "
                         "startup")
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
    sv.add_argument("--device", default="",
                    help="cuda (the default; refuses to run without a GPU) "
                         "or cpu")
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
