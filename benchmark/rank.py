"""Rank 1.. of a cell that spans several cards: started by rank 0
(``harness.run_cell``) with the program's launcher env contract
(``POSEIDON_PROC_ID``, ``POSEIDON_NUM_PROCS``, ``POSEIDON_COORDINATOR``),
it drives its rank of the same run over rank 0's inputs and writes its
report to ``<run_dir>/rank<r>.json``. It prints no result."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    t_process = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    from . import harness, manifest, prototxt, trace
    from .refnet import RefNet
    harness.cache_env()
    with open(os.path.join(args.run_dir, "cell.json")) as f:
        cell = manifest.load_cell(args.workload, json.load(f))
    specs = RefNet(prototxt.read(manifest.config_path(cell, "net")),
                   int(cell.traffic["batch"]),
                   int(cell.config["crop_size"])).param_specs()
    st = harness.train_rank(cell, args.seed, args.seconds, bool(args.trace),
                            args.device, t_process, args.run_dir, specs,
                            args.fault)
    view = None
    if args.trace:
        spans = harness.read_spans()
        view = trace.load(st.tracer.export(), st.tracer, spans)
    path = os.path.join(args.run_dir, f"rank{st.rank}.json")
    with open(path, "w") as f:
        json.dump(harness.rank_report(st, view), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
