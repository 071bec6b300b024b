"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell's configuration and traffic; a
configuration is ``configs/<name>.json`` (its file in the manifest), a
traffic mix ``traffic/<name>.json``, a cell's correctness limits
``limits/<cell>.json`` and a metric's reader ``metrics/<metric>.py``.
Adding any of them is adding files and a manifest entry."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file's contents
    config_name: str
    traffic: Dict           # the traffic file's contents
    traffic_name: str
    limits: Dict[str, float]
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str, entry: Optional[Dict] = None) -> Cell:
    """The cell ``name`` with its files and the metrics it reports;
    ``entry`` stands in for its ``workloads`` entry (a cell staged with
    its files before the manifest lists it)."""
    doc = manifest()
    cells = {w["name"]: w for w in doc["workloads"]}
    if entry is None and name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = entry or cells[name]
    cfg = next(c for c in doc["configs"] if c["name"] == w["config"])

    def reports(m: Dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(ROOT, cfg["file"])),
        config_name=cfg["name"],
        traffic=_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        traffic_name=w["traffic"],
        limits=_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=[m for m in doc["end_to_end"] if reports(m)],
        per_layer=[m for m in doc["per_layer"] if reports(m)])


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``: a number, or None when
    the run gave it nothing to read."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def config_path(cell: Cell, key: str) -> str:
    """A file the configuration names (its prototxts), beside it."""
    return os.path.join(HERE, "configs", cell.config[key])
