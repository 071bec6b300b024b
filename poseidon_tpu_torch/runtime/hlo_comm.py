"""Measured comm accounting: the collectives one train step really issues
(the port's ``poseidon_tpu/runtime/hlo_comm.py``).

The static table (``comm_stats.py``) predicts what each layer's strategy
should move a step, and ``parallel/spmd.CENSUS`` counts what the port's
call sites say they issue. This module reads what the step really sent:
the c10d ops recorded by ``runtime/op_census.py`` (the counterpart of the
collectives in JAX's compiled program), each with its kind, payload shape
and dtype (a bf16 wire is visible), its process group's size and ranks
(the tier split is visible) and whether it was issued async (the DWBP
buckets are async starts whose waits come at the end of backward).

Usage::

    _, records = op_census.record(step.step, params, state, batch)
    colls = collectives(records)
    summary = measured_comm_summary(colls)
    # -> totals comparable against comm_stats.comm_summary()

``count_gradient_all_reduces``, ``measured_comm_summary`` and
``compare_static_vs_measured`` are the JAX package's functions over the
same ``Collective`` fields.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .op_census import OpRecord, metas

__all__ = ["Collective", "collectives", "count_gradient_all_reduces",
           "collective_census", "collective_sequence",
           "measured_comm_summary", "compare_static_vs_measured",
           "C10D_KINDS"]

# the c10d ops the port's collectives dispatch (``parallel/mesh.DataGroup``)
# -> (JAX's collective kind, which argument holds the full logical
# payload: the reduced tensor, the gathered result, the full reduce-scatter
# input, the all-to-all input, the sent tensor)
C10D_KINDS: Dict[str, Tuple[str, int]] = {
    "c10d.allreduce_.default": ("all-reduce", 0),
    "c10d._allgather_base_.default": ("all-gather", 0),
    "c10d.allgather_.default": ("all-gather", 0),
    "c10d._reduce_scatter_base_.default": ("reduce-scatter", 1),
    "c10d.alltoall_base_.default": ("all-to-all", 1),
    "c10d.send.default": ("collective-permute", 0),
    "c10d.broadcast_.default": ("broadcast", 0),
}

_SHORT_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
                "float64": "f64", "int64": "s64", "int32": "s32",
                "int8": "s8", "uint8": "u8", "bool": "pred"}


@dataclass
class Collective:
    kind: str            # all-reduce | all-gather | ...
    dtype: str           # dtype of the (first) payload, JAX's short names
    shape: tuple         # shape of the (first) payload
    payload_bytes: int   # the FULL logical payload (see C10D_KINDS)
    group_size: int      # participants of the process group (1 = trivial)
    n_groups: int = 1
    async_op: bool = False
    ranks: Optional[tuple] = None    # the group's global ranks
    thread: str = ""

    def wire_bytes_per_device(self) -> float:
        """Bytes each participant moves, ring-algorithm convention (the
        convention comm_stats.py bills)."""
        n = self.group_size
        if n <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * (n - 1) / n * self.payload_bytes
        if self.kind in ("all-gather", "reduce-scatter", "all-to-all"):
            return (n - 1) / n * self.payload_bytes
        return float(self.payload_bytes)  # permute (a send), broadcast


def collectives(records: Sequence[OpRecord]) -> List[Collective]:
    """Every collective among a step's records, in issue order."""
    out: List[Collective] = []
    for r in records:
        spec = C10D_KINDS.get(r.op)
        if spec is None:
            continue
        kind, i = spec
        found = metas(r.args[i]) if i < len(r.args) else []
        if not found:
            continue
        first = found[0]
        out.append(Collective(
            kind=kind, dtype=_SHORT_DTYPE.get(first.dtype, first.dtype),
            shape=first.shape, payload_bytes=sum(m.nbytes for m in found),
            group_size=r.group_size or 1, async_op=bool(r.async_op),
            ranks=r.group_ranks, thread=r.thread))
    return out


def count_gradient_all_reduces(colls: Sequence[Collective],
                               min_payload_bytes: int = 1024) -> int:
    """Gradient all-reduces of a step: all-reduces with a non-trivial
    group and a payload big enough to be a gradient (the metrics'
    all-reduce is a scalar and falls under the threshold): the DWBP
    bucket count."""
    return sum(1 for c in colls
               if c.kind == "all-reduce" and c.group_size > 1
               and c.payload_bytes >= min_payload_bytes)


def collective_census(colls: Sequence[Collective],
                      min_elements: int = 256) -> Dict[str, int]:
    """Counts of all-reduce / reduce-scatter / all-gather with a payload
    of at least ``min_elements`` elements, in the keys of
    ``spmd.ShardingPlan.collective_schedule``'s counts (the measured side
    of the planned-vs-issued gate; JAX's ``collective_census_stablehlo``).
    """
    out = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    for c in colls:
        key = c.kind.replace("-", "_")
        n = 1
        for d in c.shape:
            n *= d
        if key in out and n >= min_elements:
            out[key] += 1
    return out


def collective_sequence(colls: Sequence[Collective]) -> List[str]:
    """The ordered schedule, one ``kind|ranks|shape|dtype`` entry a
    collective: two participants of one mesh must issue the same
    sequence, or one waits in a collective the other never enters."""
    return [f"{c.kind}|{','.join(map(str, c.ranks or ()))}|"
            f"{'x'.join(map(str, c.shape))}|{c.dtype}" for c in colls]


def measured_comm_summary(colls: Sequence[Collective],
                          min_payload_bytes: int = 16) -> Dict:
    """Totals comparable against comm_stats.comm_summary(): per-device
    wire bytes by collective kind and dtype, scalars filtered out."""
    total = 0.0
    by_kind: Dict[str, float] = {}
    by_dtype: Dict[str, float] = {}
    n_colls = 0
    for c in colls:
        if c.payload_bytes < min_payload_bytes or c.group_size <= 1:
            continue
        w = c.wire_bytes_per_device()
        total += w
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + w
        by_dtype[c.dtype] = by_dtype.get(c.dtype, 0.0) + w
        n_colls += 1
    return {
        "measured_bytes_per_step": int(total),
        "n_collectives": n_colls,
        "by_kind": {k: int(v) for k, v in sorted(by_kind.items())},
        "by_dtype": {k: int(v) for k, v in sorted(by_dtype.items())},
    }


def compare_static_vs_measured(static_summary: Dict,
                               measured: Dict) -> Dict:
    """The validation row: static prediction vs the step's measurement
    and their ratio."""
    s = float(static_summary.get("total_bytes_per_step", 0))
    m = float(measured.get("measured_bytes_per_step", 0))
    return {
        "static_bytes_per_step": int(s),
        "measured_bytes_per_step": int(m),
        "measured_over_static": round(m / s, 4) if s else None,
    }
