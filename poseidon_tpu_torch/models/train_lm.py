"""Byte-level character LM: the port of ``examples/lm/train_lm.py``'s
``--mode sp`` and ``--mode tp``, on one device or one process a rank.

    python -m poseidon_tpu_torch.models.train_lm                 # the card
    python -m poseidon_tpu_torch.models.train_lm --device cpu --steps 40
    # two ranks (the launch env contract), a seq axis of 2:
    POSEIDON_NUM_PROCS=2 POSEIDON_PROC_ID=<r> \
    POSEIDON_COORDINATOR=file:///tmp/lm_store \
        python -m poseidon_tpu_torch.models.train_lm --mode sp --par_axis 2

Same flags and defaults as the JAX script (``--steps 200 --seq 256 --batch
8 --d_model 128 --n_layers 2 --n_heads 4 --lr 0.05 --remat --display 20
--generate N``), plus ``--device``. The corpus is the same bytes: the JAX
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
``model`` for tp; 0 picks the largest of 4, 3, 2 and 1 that divides the
world) and ``--data_axis`` the data axis (0: the rest); both must
multiply to the world, and the batch, the sequence and (tp) the heads and
d_ff must divide as the JAX script requires, with its messages. Every
rank draws the same global batch and trains on its block of it (rows by
its data index; sp: columns by its seq index); a tp rank holds its
``tp_shard`` of the params. Rank 0 prints the mesh and the display
lines; ``--generate`` runs in one process only (tp params gathered back
to the canonical layout first). ``--mode pp|ep`` raise: the pipeline and
MoE come in the next slice.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

CORPUS = (Path(__file__).resolve().parents[2] / "examples" / "lm"
          / "train_lm.py")

_LATER = {
    "pp": "pipeline parallelism (ROADMAP A.10, its next part)",
    "ep": "MoE expert parallelism (ROADMAP A.10, its next part)",
}
_AXIS = {"sp": "seq", "tp": "model"}


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
                    help="size of the mode's axis (seq or model ranks); "
                         "0 = auto (up to 4)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--display", type=int, default=20)
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="after training, greedy-decode N bytes from a "
                         "corpus prompt")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    return ap.parse_args(argv)


def check_supported(args: argparse.Namespace) -> None:
    """Raise for what the port does not run yet."""
    if args.mode in _LATER:
        raise NotImplementedError(f"--mode {args.mode}: {_LATER[args.mode]} "
                                  f"is not ported yet; use --mode sp or tp")


def plan_mesh(args: argparse.Namespace, n_dev: int):
    """(data axis, par axis) over ``n_dev`` ranks, with the JAX script's
    refusals (``SystemExit``, its messages)."""
    if args.par_axis:
        par_ax = args.par_axis
    else:  # largest divisor of the device count, at most 4
        par_ax = next(d for d in (4, 3, 2, 1) if n_dev % d == 0)
    data_ax = args.data_axis or max(1, n_dev // par_ax)
    if data_ax * par_ax != n_dev:
        raise SystemExit(f"mesh {data_ax}x{par_ax} != {n_dev} devices "
                         f"(pick --data_axis/--par_axis that multiply to "
                         f"{n_dev})")
    if args.batch % data_ax or (args.mode == "sp" and args.seq % par_ax):
        raise SystemExit(
            f"--batch {args.batch} must divide by {data_ax}"
            + (f" and --seq {args.seq} by {par_ax}"
               if args.mode == "sp" else ""))
    if args.mode == "tp" and (args.n_heads % par_ax
                              or (4 * args.d_model) % par_ax):
        raise SystemExit(f"--n_heads {args.n_heads} and d_ff "
                         f"{4 * args.d_model} must divide by the "
                         f"model axis {par_ax}")
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
    check_supported(args)
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
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    if args.mode == "sp":
        step = tfm.build_dp_sp_train_step(cfg, sp, groups=mesh)
    else:
        params = tfm.tp_shard(tfm.to_tp_layout(params, cfg), cfg,
                              mesh.index("model"), par_ax)
        step = tfm.build_dp_tp_train_step(cfg, sp, mesh)

    corpus = load_corpus(args.seq)
    rs = np.random.RandomState(0)
    b_local = args.batch // data_ax
    s_local = args.seq // (par_ax if args.mode == "sp" else 1)
    rows = slice(mesh.index("data") * b_local,
                 (mesh.index("data") + 1) * b_local)
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
        if args.mode == "tp":
            # decoding runs on canonical (one-device) params
            params = tfm.from_tp_layout(
                tfm.tp_unshard(params, mesh["model"]), cfg)
        p_len = max(1, min(32, cfg.max_seq - args.generate))
        prompt = torch.from_numpy(corpus[None, :p_len].astype(np.int64))
        with torch.inference_mode():
            toks, _ = generate(params, cfg, prompt.to(device), args.generate)
        text = bytes(toks[0].cpu().numpy().astype(np.uint8)).decode(
            "utf-8", errors="replace")
        print(f"prompt: "
              f"{bytes(corpus[:p_len]).decode('utf-8', errors='replace')!r}")
        print(f"generated: {text!r}")
    if rank == 0:
        print("done")


if __name__ == "__main__":
    main()
