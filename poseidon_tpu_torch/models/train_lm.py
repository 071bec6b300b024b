"""Byte-level character LM on one device: the port of
``examples/lm/train_lm.py`` (its ``--mode sp`` at one device).

    python -m poseidon_tpu_torch.models.train_lm                 # the card
    python -m poseidon_tpu_torch.models.train_lm --device cpu --steps 40

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
and is restored when it returns. Only ``--mode sp`` at one device is
ported: ``tp``, ``pp``, ``ep`` and a data or mode axis larger than 1
raise, naming the part of the ROADMAP that brings each.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

CORPUS = (Path(__file__).resolve().parents[2] / "examples" / "lm"
          / "train_lm.py")

_LATER = {
    "tp": "tensor parallelism (ROADMAP queue A item 10)",
    "pp": "pipeline parallelism (ROADMAP queue A item 10)",
    "ep": "MoE expert parallelism (ROADMAP queue A item 10)",
}


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
                    help="data-axis size; 0 = 1 (one device)")
    ap.add_argument("--par_axis", type=int, default=0,
                    help="size of the mode's axis; 0 = 1 (one device)")
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
    """Raise for what this slice does not run."""
    if args.mode != "sp":
        raise NotImplementedError(f"--mode {args.mode}: {_LATER[args.mode]} "
                                  f"is not ported yet; use --mode sp")
    if args.data_axis > 1 or args.par_axis > 1:
        raise NotImplementedError(
            f"--data_axis {args.data_axis} --par_axis {args.par_axis}: more "
            f"than one device (LM data parallelism, ROADMAP queue A item "
            f"10) is not ported yet; this script trains on one device")


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

    import torch

    from ..numeric import policy_scope

    with policy_scope(**({"compute_dtype": torch.bfloat16} if args.bf16
                         else {})):
        _main(args)


def _main(args: argparse.Namespace) -> None:
    import numpy as np
    import torch

    from ..numeric import resolve_device
    from ..proto.messages import SolverParameter
    from ..solvers.updates import init_state
    from . import transformer as tfm
    from .generate import generate

    device = resolve_device(args.device)
    print(f"device: {device} (one device: data=1 x seq=1)"
          + (", bf16 compute" if args.bf16 else ""), flush=True)
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model, max_seq=args.seq,
        remat=args.remat)
    sp = SolverParameter(base_lr=args.lr, lr_policy="fixed", momentum=0.9)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    step = tfm.build_dp_sp_train_step(cfg, sp, device)

    corpus = load_corpus(args.seq)
    rs = np.random.RandomState(0)

    def sample_batch():
        starts = rs.randint(0, len(corpus) - args.seq - 1, size=args.batch)
        toks = np.stack([corpus[s:s + args.seq + 1] for s in starts])
        return (torch.from_numpy(toks[:, :-1].astype(np.int64)).to(device),
                torch.from_numpy(toks[:, 1:].astype(np.int64)).to(device))

    state = init_state(params)
    t0 = steps_timed = 0
    for it in range(1, args.steps + 1):
        tokens, targets = sample_batch()
        params, state, metrics = step(params, state, tokens, targets)
        if it == 1:
            # the first step builds the kernels (and warms the allocator):
            # report it, then restart the throughput clock
            print(f"step {it:5d}  loss {float(metrics['loss']):.4f}  "
                  f"(warm-up)", flush=True)
            t0, steps_timed = time.perf_counter(), 0
            continue
        steps_timed += 1
        if it % args.display == 0:
            loss = float(metrics["loss"])     # synchronizes the device
            dt = time.perf_counter() - t0
            tps = steps_timed * args.batch * args.seq / dt
            print(f"step {it:5d}  loss {loss:.4f}  {tps:,.0f} tok/s",
                  flush=True)

    if args.generate:
        if args.generate > cfg.max_seq - 8:
            raise SystemExit(f"--generate {args.generate} must be < "
                             f"max_seq - 8 = {cfg.max_seq - 8} (learned "
                             f"positions cover prompt + generation)")
        p_len = max(1, min(32, cfg.max_seq - args.generate))
        prompt = torch.from_numpy(corpus[None, :p_len].astype(np.int64))
        with torch.inference_mode():
            toks, _ = generate(params, cfg, prompt.to(device), args.generate)
        text = bytes(toks[0].cpu().numpy().astype(np.uint8)).decode(
            "utf-8", errors="replace")
        print(f"prompt: "
              f"{bytes(corpus[:p_len]).decode('utf-8', errors='replace')!r}")
        print(f"generated: {text!r}")
    print("done")


if __name__ == "__main__":
    main()
