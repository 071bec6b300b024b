"""Command line of the port (the ``train``, ``test`` and ``serve`` commands
of ``poseidon_tpu/runtime/cli.py``)::

    python -m poseidon_tpu_torch train --solver=<solver.prototxt> \\
        [--snapshot=<.solverstate.npz>|auto] [--weights=<.caffemodel>] \\
        [--output_dir .] [--device cuda|cpu]
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
``--output_dir``. ``test`` scores a net's TEST phase and prints one
``<output>: <mean>`` line per scalar output. ``serve`` warms every bucket,
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


def cmd_train(args) -> int:
    from ..proto.messages import load_solver
    from .engine import Engine

    eng = Engine(load_solver(args.solver), output_dir=args.output_dir,
                 device=args.device or None)
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
