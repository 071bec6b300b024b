"""BENCHMARK.json against its contract's shapes: names, units and
one-line texts of the allowed characters, every cell's and metric's
files found by name, and what each metric says it moves."""

import json
import os
import re

import pytest

from benchmark import manifest

ROOT = manifest.ROOT
DOC = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer",
               "moves", "workloads"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= DOC["run_seconds"] <= 51
    assert 1 <= len(DOC["paths"]) <= 16
    for p in DOC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(DOC["command"]) <= 32 and all(_line(w)
                                             for w in DOC["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_unique_and_allowed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in DOC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        doc = json.load(open(os.path.join(ROOT, c["file"])))
        assert doc["name"] == c["name"]
        # every reduced key is explained in the file
        assert set(c["reduced"]) <= set(doc["reduced_as"])
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    configs = {c["name"] for c in DOC["configs"]}
    pairs = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.load_cell(w["name"])
        # every compared number has its limit
        for key in cell.traffic["check"]["compare"]:
            assert key in cell.limits
    assert {w["config"] for w in DOC["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(DOC["workloads"]) // 4)


@pytest.mark.parametrize("m", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert set(m) <= METRIC_KEYS
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.isfile(os.path.join(manifest.HERE, "metrics",
                                       f"{m['name']}.py"))
    cells = {w["name"] for w in DOC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] == "train_img_s"
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in DOC["workloads"]:
        cell = manifest.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
    assert next(m for m in DOC["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
