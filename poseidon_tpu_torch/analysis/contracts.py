"""Step contracts: checked-in per-model goldens of what one train step of
the port really does (the port's ``poseidon_tpu/analysis/contracts.py``).

The JAX package pins countable properties of its compiled train step
(bucketed gradient psums, the NHWC transposes, donated buffers, an
f64-free program) as one golden JSON per model. The port pins the same
properties of its eager step, read off the dispatcher
(``runtime/op_census.py``): one data-parallel step of the model as rank 0
of an 8-rank world on PyTorch's fake backend (``op_census.fake_world``:
the collectives are recorded and move nothing), so the goldens are those
of JAX's 8-device contract config (global batch 8, one image a rank,
4 MB buckets). Each contract records:

- ``step``: the gradient all-reduces (the DWBP buckets), the layout
  conversions of the step in the net's default layout, ``f64_tensors``,
  the dtype census of the ops' outputs, and the counterpart of donation:
  ``in_place`` says whether the arena's params and momentum kept their
  storage across the step (the fused update writes them in place);
- ``nhwc`` (AlexNet): the layout conversions of the channels-last plain
  step at 227 px (``runtime/hlo_layout.net_transpose_report``), op by op;
- ``collective_schedule`` (LeNet, AlexNet): the ``dp2,fsdp2,tp2`` SPMD
  step's collectives as planned (``spmd.ShardingPlan.
  collective_schedule``), as its call sites counted them (``spmd.
  CENSUS``) and as the dispatcher recorded them, and the ordered
  sequence the cross-participant gate (``collective_consistency``)
  compares.

The JAX package's ``optimized`` section (XLA's fusion count) has no
counterpart: the port has no fusion pass. The goldens live beside this
module (``contracts/<model>.json``). Under another torch version only the
robust subset (``ROBUST_KEYS``) is compared, and the diff says so.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

CONTRACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "contracts")
MODELS = ("lenet", "alexnet", "googlenet")

_SPECS = {
    "lenet": {"image": 28, "channels": 1, "classes": 10, "nhwc": False,
              "mesh": True},
    "alexnet": {"image": 67, "channels": 3, "classes": 10, "nhwc": True,
                "nhwc_image": 227, "mesh": True},
    "googlenet": {"image": 224, "channels": 3, "classes": 10,
                  "nhwc": False, "mesh": False},
}
_WORLD = 8
_BATCH = 8          # one row a rank of the 8-rank world
_BUCKET_MB = 4.0

ROBUST_KEYS = ("gradient_all_reduces", "layout_transposes", "f64_tensors",
               "in_place", "mesh", "arena_buckets", "tp_modes",
               "planned_counts", "recorded_counts", "census_counts",
               "planned_matches_recorded")


class ContractEnvironmentError(RuntimeError):
    """The measurement cannot be made as the golden's was (a process
    group is up already in this process): refused, CLI exit 4."""


def contract_path(model: str) -> str:
    return os.path.join(CONTRACT_DIR, f"{model}.json")


def _solver():
    from ..proto.messages import SolverParameter
    return SolverParameter(base_lr=0.01, lr_policy="fixed", momentum=0.9,
                           weight_decay=0.0005)


def _net(model: str, rows: int, conv_layout: Optional[str] = None,
         image: Optional[int] = None):
    from ..core.net import Net
    from ..models import zoo
    spec = _SPECS[model]
    image = image or spec["image"]
    if model == "lenet":
        np_ = zoo.lenet(with_accuracy=False)
    else:
        np_ = getattr(zoo, model)(num_classes=spec["classes"],
                                  with_accuracy=False)
    shapes = {"data": (rows, spec["channels"], image, image),
              "label": (rows,)}
    kw = {"conv_layout": conv_layout} if conv_layout else {}
    return Net(np_, "TRAIN", device="cpu", source_shapes=shapes, **kw)


def _batch(model: str, rows: int, seed: int = 0):
    import numpy as np
    import torch
    spec = _SPECS[model]
    rs = np.random.RandomState(seed)
    shape = (rows, spec["channels"], spec["image"], spec["image"])
    return {"data": torch.from_numpy(rs.randn(*shape).astype(np.float32)),
            "label": torch.from_numpy(rs.randint(
                0, spec["classes"], size=(rows,)).astype(np.int64))}


def _dtype_census(records) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in records:
        for m in r.outputs:
            out[m.dtype] = out.get(m.dtype, 0) + 1
    return dict(sorted(out.items()))


def dp_step_records(model: str, world: int = _WORLD,
                    comm=None) -> Tuple[List, Dict]:
    """One data-parallel step of ``model`` as rank 0 of ``world`` (inside
    ``fake_world``), after an unrecorded warm-up step (a first step also
    fills process-wide caches, such as AVE pooling's divisor, whose ops a
    later step does not repeat): (its records, facts of the step: the DWBP
    bucket plan and whether params and momentum kept their storage)."""
    import torch
    from ..parallel.mesh import DataGroup
    from ..parallel.strategies import CommConfig
    from ..parallel.trainer import build_train_step, init_train_state
    from ..runtime.op_census import record
    import torch.distributed as dist
    comm = comm or CommConfig(bucket_mb=_BUCKET_MB)
    group = DataGroup(rank=0, world=world, device=torch.device("cpu"),
                      backend="fake", pg=dist.group.WORLD)
    net = _net(model, 1)
    ts = build_train_step(net, _solver(), group, comm)
    params = net.init(torch.Generator().manual_seed(0))
    params, state = ts.load(params, init_train_state(params, comm,
                                                     ts.n_err_groups))
    batch = _batch(model, 1)
    params, state, _ = ts.step(params, state, batch)
    ptrs = (ts.flat_w.data_ptr(), ts.flat_h.data_ptr())
    (params, state, _), records = record(ts.step, params, state, batch)
    first = next(iter(next(iter(params.values())).values()))
    lo = ts.flat_w.data_ptr()
    hi = lo + ts.flat_w.numel() * ts.flat_w.element_size()
    facts = {
        "hooked_buckets": len(ts.sync.hooked) if ts.sync else 0,
        "in_place": {
            "params": (ts.flat_w.data_ptr() == ptrs[0]
                       and lo <= first.data_ptr() < hi),
            "momentum": ts.flat_h.data_ptr() == ptrs[1]},
        "kinds": dict(ts.kinds), "net": net, "step": ts}
    return records, facts


def mesh_step_records(model: str, spec: str = "dp2,fsdp2,tp2",
                      comm=None) -> Dict:
    """One SPMD step of ``model`` on ``spec`` as rank 0 of its world
    (inside ``fake_world`` of that size), built fresh (a fresh net, plan
    and step: one participant), after an unrecorded warm-up step: its
    records, the plan's schedule and ``spmd.CENSUS``'s count of the
    step."""
    import torch
    import torch.distributed as dist
    from ..config import MeshConfig
    from ..parallel import spmd
    from ..parallel.mesh import DataGroup
    from ..parallel.strategies import CommConfig
    from ..parallel.trainer import build_train_step, init_train_state
    from ..runtime import cluster
    from ..runtime.op_census import record
    cfg = MeshConfig.parse(spec)
    comm = comm or CommConfig(bucket_mb=_BUCKET_MB)
    mesh = cluster.build_mesh_groups(cfg, 0, torch.device("cpu"), "fake")
    group = DataGroup(rank=0, world=cfg.n_devices,
                      device=torch.device("cpu"), backend="fake",
                      pg=dist.group.WORLD, mesh=mesh)
    rows = _BATCH // (cfg.data * cfg.fsdp)
    net = _net(model, rows)
    plan = spmd.ShardingPlan.build(net, cfg, comm, shard_params=cfg.shard,
                                   enable_tp=cfg.shard)
    ts = build_train_step(net, _solver(), group, comm, plan=plan)
    params = net.init(torch.Generator().manual_seed(0))
    params, state = ts.load(params, init_train_state(params, comm,
                                                     plan.n_dp))
    batch = _batch(model, rows)
    params, state, _ = ts.step(params, state, batch)
    _, records = record(ts.step, params, state, batch)
    return {"records": records, "plan": plan, "cfg": cfg, "step": ts,
            "schedule": plan.collective_schedule(ts.arena, net, comm),
            "census": spmd.CENSUS.scheduled()}


def build_contract(model: str) -> Dict:
    """Measure one model's contract (seconds on the CPU)."""
    import torch
    from ..runtime import hlo_comm, hlo_layout
    from ..runtime.op_census import f64_tensors, fake_world
    import torch.distributed as dist
    if dist.is_initialized():
        raise ContractEnvironmentError(
            "a process group is initialized in this process; the contract "
            "steps run as rank 0 of an 8-rank fake world of their own")
    spec = _SPECS[model]
    with fake_world(_WORLD):
        records, facts = dp_step_records(model)
    colls = hlo_comm.collectives(records)
    census = _dtype_census(records)
    net = facts["net"]
    contract: Dict = {
        "model": model,
        "generated_with": {"torch": torch.__version__, "backend": "cpu",
                           "world": _WORLD},
        "config": {"image": spec["image"], "channels": spec["channels"],
                   "batch": _BATCH, "num_classes": spec["classes"],
                   "conv_layout": net.conv_layout,
                   "bucket_mb": _BUCKET_MB,
                   "dwbp_buckets": facts["hooked_buckets"]},
        "step": {
            "gradient_all_reduces":
                hlo_comm.count_gradient_all_reduces(colls),
            "layout_transposes":
                hlo_layout.count_layout_transposes(records),
            "in_place": facts["in_place"],
            "f64_tensors": f64_tensors(records),
            "dtype_census": census,
        },
    }
    if spec["nhwc"]:
        img = spec["nhwc_image"]
        nhwc = _net(model, 2, conv_layout="NHWC", image=img)
        rep = hlo_layout.net_transpose_report(nhwc, _solver(),
                                              per_dev_batch=2, image=img)
        contract["nhwc"] = {
            "level": rep["level"],
            "layout_transposes": rep["layout_transposes"],
            "layout_transpose_shapes": rep["layout_transpose_shapes"]}
    if spec["mesh"]:
        with fake_world(_WORLD):
            m = mesh_step_records(model)
        mcolls = hlo_comm.collectives(m["records"])
        recorded = hlo_comm.collective_census(mcolls)
        sched = m["schedule"]
        contract["collective_schedule"] = {
            "mesh": m["cfg"].describe(),
            "arena_buckets": (m["step"].arena.n_buckets
                              if m["step"].arena is not None else 0),
            "tp_modes": {l: d.mode
                         for l, d in sorted(m["plan"].tp_layers.items())},
            "planned_counts": sched["counts"],
            "census_counts": m["census"]["counts"],
            "recorded_counts": recorded,
            "planned_matches_recorded": recorded == sched["counts"],
            "sequence": hlo_comm.collective_sequence(mcolls),
        }
    return contract


def collective_consistency(models: Sequence[str] = ("lenet",),
                           participants: int = 2) -> Tuple[bool, Dict]:
    """The cross-participant gate: build and run the ``dp2,fsdp2,tp2``
    step ``participants`` times independently (fresh net, plan and step:
    what each process of the mesh does on its own) and require the same
    recorded collective sequence (kinds in order, groups, shapes,
    dtypes). A divergence is the mismatched-collective hang, caught
    here."""
    from ..runtime import hlo_comm
    from ..runtime.op_census import fake_world
    report: Dict = {}
    ok = True
    for model in models:
        if not _SPECS.get(model, {}).get("mesh"):
            report[model] = {"ok": True, "skipped":
                             "no mesh spec for this model", "diffs": []}
            continue
        seqs = []
        for _ in range(max(2, participants)):
            with fake_world(_WORLD):
                seqs.append(hlo_comm.collective_sequence(
                    hlo_comm.collectives(
                        mesh_step_records(model)["records"])))
        for p, seq in enumerate(seqs):
            if not seq or any(e.split("|")[1] == "" for e in seq):
                raise RuntimeError(
                    f"{model} participant {p}: collective sequence "
                    f"extraction degenerated (no collectives, or one "
                    f"without its group's ranks)")
        diffs: List[str] = []
        base = seqs[0]
        for p, seq in enumerate(seqs[1:], start=1):
            if len(seq) != len(base):
                diffs.append(f"participant {p}: {len(seq)} collectives "
                             f"vs participant 0's {len(base)}")
            for i, (a, b) in enumerate(zip(base, seq)):
                if a != b:
                    diffs.append(f"participant {p} diverges at "
                                 f"collective #{i}: {a!r} vs {b!r}")
                    break
        report[model] = {"ok": not diffs, "participants": len(seqs),
                         "sequence_len": len(base), "diffs": diffs}
        ok = ok and not diffs
    return ok, report


def load_contract(model: str) -> Optional[Dict]:
    path = contract_path(model)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def diff_contracts(golden: Dict, fresh: Dict) -> List[str]:
    """Human-readable mismatches, empty when the contract holds. Pure:
    the tests feed it synthetic violations."""
    diffs: List[str] = []
    same_torch = (golden.get("generated_with", {}).get("torch")
                  == fresh.get("generated_with", {}).get("torch"))

    def cmp(section: str, key: str, robust: bool) -> None:
        g = golden.get(section, {}).get(key)
        f = fresh.get(section, {}).get(key)
        if g is None or (not same_torch and not robust):
            return
        if g != f:
            diffs.append(f"{section}.{key}: golden {g!r} != measured {f!r}")

    for section in ("config", "step", "nhwc", "collective_schedule"):
        gsec = golden.get(section)
        if gsec is None:
            continue
        if fresh.get(section) is None:
            diffs.append(f"{section}: section missing from measurement")
            continue
        for key in gsec:
            cmp(section, key, robust=section == "config"
                or key in ROBUST_KEYS)
    if not same_torch and diffs:
        diffs.append(
            f"note: golden generated under torch "
            f"{golden.get('generated_with', {}).get('torch')!r}, running "
            f"{fresh.get('generated_with', {}).get('torch')!r}: only the "
            f"robust subset was compared")
    return diffs


def check_model(model: str,
                fresh: Optional[Dict] = None) -> Tuple[bool, List[str]]:
    golden = load_contract(model)
    if golden is None:
        return False, [f"no checked-in contract for {model!r} "
                       f"(run --refresh-contracts)"]
    diffs = diff_contracts(golden, fresh or build_contract(model))
    return not diffs, diffs


def check_all(models: Sequence[str] = MODELS) -> Tuple[bool, Dict]:
    report: Dict = {}
    ok = True
    for m in models:
        m_ok, diffs = check_model(m)
        report[m] = {"ok": m_ok, "diffs": diffs}
        ok = ok and m_ok
    return ok, report


def refresh(models: Sequence[str] = MODELS, out=print) -> None:
    """Rewrite the goldens, printing old->new for review: a contract
    change must be a decision, never an accident."""
    os.makedirs(CONTRACT_DIR, exist_ok=True)
    for m in models:
        fresh = build_contract(m)
        old = load_contract(m)
        if old is not None:
            for d in diff_contracts(old, fresh):
                out(f"  {m}: {d}")
        with open(contract_path(m), "w") as f:
            json.dump(fresh, f, indent=2)
            f.write("\n")
        out(f"refreshed {contract_path(m)}")
