"""A CPU rehearsal of each cell's harness path at a cut batch: the
program's ``train`` CLI over the synthetic LMDB, the checked steps, the
warm-up, the window and the plain reference, with the run's readings
against the reference. Then the same path with the timed step broken
underneath, as each fault a training cell can have: the readings that
catch it must read far over the sound run's. The card's own numbers and
limits come from the chip (``PERF.md``); on the CPU the first step and
its gradient by the median leaf are held, which no chaos of later steps
moves."""

import time

import pytest

from benchmark import harness, manifest

CELLS = sorted(w["name"] for w in manifest.manifest()["workloads"])


# the four-card cell, staged with its files (traffic, limits) before the
# manifest lists it: its rank processes rehearse on gloo
STAGED = {"alexnet_b256_f32_u8_dp4": {
    "name": "alexnet_b256_f32_u8_dp4", "config": "alexnet",
    "traffic": "b256_f32_u8_dp4", "chips": 4}}


def _run(name, fault=None):
    harness.cache_env()
    cell = manifest.load_cell(name, STAGED.get(name))
    return harness.run_cell(cell, 2**31 + 7, 0.5, False, device="cpu",
                            batch=2, records=32, fault=fault)


@pytest.mark.parametrize("name", CELLS + sorted(STAGED))
def test_rehearsal(name):
    t = time.perf_counter()
    r = _run(name)
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device",
                      "checks", "readings"}
    assert list(r)[-1] == "readings" and list(r)[-2] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    m = r["metrics"]
    assert m["train_img_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert 0 < m["setup_s"]["value"] < time.perf_counter() - t + 1
    rd = r["readings"]
    assert set(r["checks"]) == set(manifest.load_cell(
        name, STAGED.get(name)).traffic["check"]["compare"])
    # the first step from the same weights, rows, crops and masks. Later
    # steps at batch 2 on the CPU amplify rounding chaotically
    # (GoogLeNet's within two steps), so the first gradient is held where
    # the plan reads it, and no later reading
    assert rd["loss1_gap"] < 1e-5
    if "grad_gap_med" in rd:
        assert rd["grad_gap_med"] < 1e-2


@pytest.mark.parametrize("cell,fault,reading,floor", [
    # the state returned unchanged
    ("alexnet_b256_f32_u8", "frozen", "change_gap", 0.5),
    # half the batch left out, the mean taken over the rest
    ("alexnet_b256_f32_u8", "half", "grad_gap", 0.1),
] + [
    # the exchange between the ranks left out (gloo processes)
    (name, "noexchange", "grad_gap", 0.1) for name in sorted(STAGED)])
def test_broken_step_reads_far_off(cell, fault, reading, floor):
    r = _run(cell, fault=fault)
    assert r["readings"][reading] > floor
    assert r["correct"] is False
