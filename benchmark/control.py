"""The control and the planted faults of a cell, read on the card at the
cell's own size: the plain reference put in the program's place in a
lower precision, or broken, and compared with the f32 reference by the
cell's own numbers (``reference.compare``). The benchmark's runs do not
run this; ``tests/test_control.py`` does, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed and arm: ``tf32`` (the f32 configuration's
control: TF32 on), ``fp8`` (the bf16 configuration's control: every conv
and FC operand rounded to float8 e4m3 with a per-tensor scale), ``half``
(the fault of a step that leaves out half its batch and means over the
rest), ``frozen`` (the fault of a step that returns its state unchanged),
``local`` (a cell over several cards: the exchange between them left out)
and ``nudge`` (the f32 reference from weights moved by one part in
2^23: how far rounding alone carries the cell's numbers).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import torch

from . import harness, manifest, prototxt, reference, synth
from .refnet import RefNet

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, back in x's
    dtype (gradients pass straight through)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def arms_for(cell: manifest.Cell) -> List[str]:
    low = "fp8" if cell.traffic.get("precision") == "bf16" else "tf32"
    faults = ["half", "frozen"] + (
        ["local"] if int(cell.traffic.get("ranks", 1)) > 1 else [])
    return [low] + faults + ["nudge"]


def read_seed(cell: manifest.Cell, seed: int, arms: List[str],
              device: str = "cuda") -> List[Dict]:
    cfg, traffic = cell.config, cell.traffic
    net_msg = prototxt.read(manifest.config_path(cell, "net"))
    solver = harness.solver_dict(prototxt.read(manifest.config_path(
        cell, "solver")))
    batch, crop = int(traffic["batch"]), int(cfg["crop_size"])
    shape = tuple(cfg["record_shape"])
    net = RefNet(net_msg, batch, crop, channels=shape[0])
    specs = net.param_specs()
    images, labels = synth.make_records(seed, int(traffic["records"]),
                                        int(cfg["classes"]), shape, device)
    mean = synth.image_mean(images)
    w0 = harness.host_tree(reference.make_weights(specs, seed + 1,
                                                   device))
    points = list(traffic["check"]["points"])

    def run(w=w0, **kw):
        return harness.reference_run(cell, net, solver, seed, images, labels,
                                     mean, batch, crop, device, points, w,
                                     **kw)

    base = run()
    out = []
    for arm in arms:
        if arm == "tf32":
            got = run(tf32=True)
        elif arm == "fp8":
            got = run(quant=fp8)
        elif arm == "half":
            got = run(half_batch=True)
        elif arm == "frozen":
            got = run(frozen=True)
        elif arm == "local":
            got = run(local=True)
        elif arm == "nudge":
            gen = torch.Generator().manual_seed(seed)
            w = {l: {n: v * (1 + 2.0 ** -23 * torch.randn(
                v.shape, generator=gen)) for n, v in d.items()}
                for l, d in w0.items()}
            got = run(w=w)
        else:
            raise ValueError(f"unknown arm {arm!r}")
        nums = reference.compare(traffic["check"], specs, solver, w0,
                                 got[0], got[1], base[0], base[1])
        out.append({"workload": cell.name, "seed": seed, "arm": arm,
                    **{k: v[0] for k, v in nums.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--arms", default="")
    args = ap.parse_args(argv)
    harness.cache_env()
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    arms = args.arms.split(",") if args.arms else arms_for(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in read_seed(cell, seed, arms):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
