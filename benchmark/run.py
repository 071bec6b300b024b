"""Run one cell of the benchmark of ``poseidon_tpu_torch``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared for ``correct`` end standard error,
each beside its limit. A run needs the cards the cell asks for: without
them it exits with 2 and prints no result. It exits with 3 and prints no
result when a JAX module is loaded in the process once the window has
closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from
    ``/proc/self/stat``; this module's import where that is unreadable)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "poseidon_tpu")


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness, manifest
    harness.cache_env()
    cell = manifest.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" (no result)", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_process=T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: JAX modules loaded in the run: {bad} (no "
              f"result)", file=sys.stderr)
        return 3
    readings = result.pop("readings")
    print("readings: " + json.dumps(readings), file=sys.stderr)
    print(f"correct: {result['correct']}; the numbers compared, each "
          f"beside its limit:", file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"{key} {c['value']!r} limit {c['limit']!r} (worst "
              f"{c['worst']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
