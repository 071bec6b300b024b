"""On the card: the cell's control (the plain reference in the next lower
precision in the program's place) and its planted faults fail at least
one of the numbers the cell compares, at the cell's own size, on three
seeds. Run with ``python -m pytest benchmark/tests -m gpu``."""

import pytest
import torch

from benchmark import control, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control runs at the cell's "
                    "own size on the card)")
    cell = manifest.load_cell(name)
    compared = cell.traffic["check"]["compare"]
    arms = [a for a in control.arms_for(cell) if a != "nudge"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        for row in control.read_seed(cell, seed, arms):
            assert any(row[k] > cell.limits[k] for k in compared), row
