"""Byte-level character LM: the port of ``examples/lm/train_lm.py``, every
``--mode`` (sp, tp, pp, ep), on one device or one process a rank.

    python -m poseidon_tpu_torch.models.train_lm                 # the card
    python -m poseidon_tpu_torch.models.train_lm --device cpu --steps 40
    # two ranks (the launch env contract), a seq axis of 2:
    POSEIDON_NUM_PROCS=2 POSEIDON_PROC_ID=<r> \
    POSEIDON_COORDINATOR=file:///tmp/lm_store \
        python -m poseidon_tpu_torch.models.train_lm --mode sp --par_axis 2

Same flags and defaults as the JAX script (``--steps 200 --seq 256 --batch
8 --d_model 128 --n_layers 2 --n_heads 4 --lr 0.05 --microbatches 2
--experts 8 --remat --display 20 --generate N``), plus ``--device``. The corpus is the same bytes: the JAX
script's own source file, read as data from ``examples/lm/train_lm.py``
and tiled so any ``--seq`` fits; batches are drawn from
``np.random.RandomState(0)`` as its ``sample_batch`` draws them. The loss
falls from about 5.5 (ln 256) as the model memorizes the file. Prints the
JAX script's display lines (``step N  loss L  T tok/s``); ``--generate N``
greedy-decodes N bytes from a 32-byte corpus prompt with the port's dense
``generate``.

``--bf16`` sets ``compute_dtype`` to bfloat16 and nothing else, as the JAX
script does (no s2d: the LM has no conv); the policy holds for ``main``
and is restored when it returns.

The mesh is the JAX script's: the world is ``POSEIDON_NUM_PROCS`` ranks
(one a device); ``--par_axis`` sizes the mode's axis (``seq`` for sp,
``model`` for tp, ``stage`` for pp, ``expert`` for ep; 0 picks the
largest of 4, 3, 2 and 1 that divides the world) and ``--data_axis`` the
data axis (0: the rest); both must multiply to the world, and the batch
(over data, or data x expert under ep), the sequence (sp), the heads and
d_ff (tp), the layers and the local batch's microbatches (pp) and the
experts (ep) must divide as the JAX script requires, with its messages.
Every rank draws the same global batch and trains on its block of it
(rows by its data index, or by ``data * E + expert`` under ep; sp:
columns by its seq index). A tp rank holds its ``tp_shard`` of the
params, a pp rank its stage's ``pp_shard`` of ``to_pp_layout`` (the
pipeline step, ``--microbatches`` a rank's rows), an ep rank its
``ep_shard`` of a ``MoEConfig`` model of ``--experts`` experts (the
default capacity factor, so tokens drop as in training). Rank 0 prints
the mesh and the display lines; ``--generate`` runs in one process only
(tp and pp params gathered back to the canonical layout first; an ep
model decodes dropless through its ``MoEConfig``). The script writes no
snapshot, as the JAX script writes none.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

CORPUS = (Path(__file__).resolve().parents[2] / "examples" / "lm"
          / "train_lm.py")

_AXIS = {"sp": "seq", "tp": "model", "pp": "stage", "ep": "expert"}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m poseidon_tpu_torch.models.train_lm")
    ap.add_argument("--mode", choices=("sp", "tp", "pp", "ep"), default="sp")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--data_axis", type=int, default=0,
                    help="data-axis size; 0 = auto (ranks/par_axis)")
    ap.add_argument("--par_axis", type=int, default=0,
                    help="size of the mode's axis (seq/model/stage/expert "
                         "ranks); 0 = auto (up to 4)")
    ap.add_argument("--microbatches", type=int, default=2, help="pp only")
    ap.add_argument("--experts", type=int, default=8, help="ep only")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--display", type=int, default=20)
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, greedy-decode N bytes from a "
                         "corpus prompt (all modes; MoE decodes dropless)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    return ap.parse_args(argv)


def plan_mesh(args: argparse.Namespace, n_dev: int):
    """(data axis, par axis) over ``n_dev`` ranks, with the JAX script's
    refusals (``SystemExit``, its messages, in its order)."""
    if args.par_axis:
        par_ax = args.par_axis
    else:  # largest divisor of the device count, at most 4
        par_ax = next(d for d in (4, 3, 2, 1) if n_dev % d == 0)
    data_ax = args.data_axis or max(1, n_dev // par_ax)
    if data_ax * par_ax != n_dev:
        raise SystemExit(f"mesh {data_ax}x{par_ax} != {n_dev} devices "
                         f"(pick --data_axis/--par_axis that multiply to "
                         f"{n_dev})")
    batch_div = data_ax * (par_ax if args.mode == "ep" else 1)
    if args.batch % batch_div or (args.mode == "sp" and args.seq % par_ax):
        raise SystemExit(
            f"--batch {args.batch} must divide by {batch_div}"
            + (f" and --seq {args.seq} by {par_ax}"
               if args.mode == "sp" else ""))
    if args.mode == "tp" and (args.n_heads % par_ax
                              or (4 * args.d_model) % par_ax):
        raise SystemExit(f"--n_heads {args.n_heads} and d_ff "
                         f"{4 * args.d_model} must divide by the "
                         f"model axis {par_ax}")
    if args.mode == "pp":
        if args.n_layers % par_ax:
            raise SystemExit(f"--n_layers {args.n_layers} must divide by "
                             f"the stage axis {par_ax} (try --n_layers "
                             f"{par_ax})")
        if (args.batch // data_ax) % args.microbatches:
            raise SystemExit(f"local batch {args.batch // data_ax} must "
                             f"divide by --microbatches "
                             f"{args.microbatches}")
    if args.mode == "ep" and args.experts % par_ax:
        raise SystemExit(f"--experts {args.experts} must divide by the "
                         f"expert axis {par_ax}")
    return data_ax, par_ax


def load_corpus(seq: int):
    """The JAX script's bytes as uint8, tiled so ``seq + 1`` fits."""
    import numpy as np
    corpus = np.frombuffer(CORPUS.read_bytes(), np.uint8)
    if len(corpus) <= seq + 1:
        corpus = np.tile(corpus, seq // len(corpus) + 2)
    return corpus


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from ..runtime.cluster import env_world
    args.mesh = plan_mesh(args, env_world()[1])

    import torch

    from ..numeric import policy_scope

    with policy_scope(**({"compute_dtype": torch.bfloat16} if args.bf16
                         else {})):
        _main(args)


def _main(args: argparse.Namespace) -> None:
    from ..numeric import resolve_device
    from ..runtime.cluster import init_distributed

    group = init_distributed(resolve_device(args.device),
                             named=(("data", _AXIS[args.mode]), args.mesh))
    try:
        _train(args, group)
    finally:
        group.close()


def _train(args: argparse.Namespace, group) -> None:
    import numpy as np
    import torch

    from ..proto.messages import SolverParameter
    from ..solvers.updates import init_state
    from . import moe
    from . import transformer as tfm
    from .generate import generate

    axis = _AXIS[args.mode]
    mesh = group.mesh
    device, rank = group.device, group.rank
    data_ax, par_ax = mesh.shape
    if rank == 0:
        print(f"device: {device}" + (", bf16 compute" if args.bf16 else ""),
              flush=True)
        print(f"mesh: data={data_ax} x {axis}={par_ax} "
              f"({group.world} devices)", flush=True)
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model, max_seq=args.seq,
        remat=args.remat)
    sp = SolverParameter(base_lr=args.lr, lr_policy="fixed", momentum=0.9)
    gen = torch.Generator().manual_seed(0)
    gen_cfg = cfg            # the config --generate decodes with
    if args.mode == "ep":
        gen_cfg = moe.MoEConfig(base=cfg, n_experts=args.experts)
        params = moe.ep_shard(moe.init_moe_params(gen_cfg, gen, device),
                              gen_cfg, mesh.index("expert"), par_ax)
        step = moe.build_dp_ep_train_step(gen_cfg, sp, mesh)
    else:
        params = tfm.init_params(cfg, gen, device=device)
        if args.mode == "sp":
            step = tfm.build_dp_sp_train_step(cfg, sp, groups=mesh)
        elif args.mode == "tp":
            params = tfm.tp_shard(tfm.to_tp_layout(params, cfg), cfg,
                                  mesh.index("model"), par_ax)
            step = tfm.build_dp_tp_train_step(cfg, sp, mesh)
        else:
            params = tfm.pp_shard(tfm.to_pp_layout(params, cfg), cfg,
                                  mesh.index("stage"), par_ax)
            step = tfm.build_dp_pp_train_step(cfg, sp, mesh,
                                              args.microbatches)

    corpus = load_corpus(args.seq)
    rs = np.random.RandomState(0)
    # ep shards the batch over data x expert (row block d * E + e, the
    # joint group's rank); the other modes over data
    shard, n_shards = ((mesh.batch_index, mesh.n_dp) if args.mode == "ep"
                       else (mesh.index("data"), data_ax))
    b_local = args.batch // n_shards
    s_local = args.seq // (par_ax if args.mode == "sp" else 1)
    rows = slice(shard * b_local, (shard + 1) * b_local)
    cols = slice(mesh.index("seq") * s_local,
                 (mesh.index("seq") + 1) * s_local)

    def sample_batch():
        # every rank draws the same global batch and keeps its block
        starts = rs.randint(0, len(corpus) - args.seq - 1, size=args.batch)
        toks = np.stack([corpus[s:s + args.seq + 1] for s in starts])
        return (torch.from_numpy(toks[rows, :-1][:, cols].astype(np.int64))
                .to(device),
                torch.from_numpy(toks[rows, 1:][:, cols].astype(np.int64))
                .to(device))

    state = init_state(params)
    t0 = steps_timed = 0
    for it in range(1, args.steps + 1):
        tokens, targets = sample_batch()
        params, state, metrics = step(params, state, tokens, targets)
        if it == 1:
            # the first step builds the kernels (and warms the allocator):
            # report it, then restart the throughput clock
            if rank == 0:
                print(f"step {it:5d}  loss {float(metrics['loss']):.4f}  "
                      f"(warm-up)", flush=True)
            t0, steps_timed = time.perf_counter(), 0
            continue
        steps_timed += 1
        if it % args.display == 0 and rank == 0:
            loss = float(metrics["loss"])     # synchronizes the device
            dt = time.perf_counter() - t0
            tps = steps_timed * args.batch * args.seq / dt
            print(f"step {it:5d}  loss {loss:.4f}  {tps:,.0f} tok/s",
                  flush=True)

    if args.generate and group.world > 1:
        if rank == 0:
            print("--generate: single-process only; skipping")
    elif args.generate:
        if args.generate > cfg.max_seq - 8:
            raise SystemExit(f"--generate {args.generate} must be < "
                             f"max_seq - 8 = {cfg.max_seq - 8} (learned "
                             f"positions cover prompt + generation)")
        # decoding runs on canonical (one-device) params; MoE decodes
        # dropless with every expert local
        if args.mode == "tp":
            params = tfm.from_tp_layout(
                tfm.tp_unshard(params, mesh["model"]), cfg)
        elif args.mode == "pp":
            params = tfm.from_pp_layout(
                tfm.pp_unshard(params, mesh["stage"]), cfg)
        p_len = max(1, min(32, cfg.max_seq - args.generate))
        prompt = torch.from_numpy(corpus[None, :p_len].astype(np.int64))
        with torch.inference_mode():
            toks, _ = generate(params, gen_cfg, prompt.to(device),
                               args.generate)
        text = bytes(toks[0].cpu().numpy().astype(np.uint8)).decode(
            "utf-8", errors="replace")
        print(f"prompt: "
              f"{bytes(corpus[:p_len]).decode('utf-8', errors='replace')!r}")
        print(f"generated: {text!r}")
    if rank == 0:
        print("done")


if __name__ == "__main__":
    main()
