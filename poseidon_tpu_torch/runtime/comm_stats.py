"""Static communication accounting (the port of
``poseidon_tpu/runtime/comm_stats.py``'s ``CommCostModel``,
``layer_comm_table`` and ``comm_summary``).

What a data-parallel step sends is fixed by the parameter shapes, each
layer's strategy and the group, so it can be counted exactly, per layer,
before the first step:

- DENSE: a ring all-reduce, 2 (n - 1) / n of the gradient's bytes each
  way a device;
- SFB: the all-gather of the two factors (B_global, M) and (B_global, K),
  (n - 1) / n of both, and the bias on a dense all-reduce;
- TOPK: the entries sent, counted as an index and a value each (the
  SSPAggr budget's bill, what a sparse wire format would pay; the step
  itself, as the JAX package's, exchanges the sparsified tensor densely);
- LOCAL: nothing.

On a two-tier group the bytes split by tier: DENSE and SFB ride both,
TOPK pays a dense all-reduce inside the slice and the compressed exchange
between slices. The table keeps the JAX package's column names: "ici" is
the fast tier (inside a slice), "dcn" the slow one (between slices).

``est_comm_ms`` applies a rate model to those bytes. Its defaults are the
NVIDIA H100 SXM's published link rates, not measurements: NVLink 4 at
450 GB/s a direction a GPU inside a node, and one 400 Gb/s NIC (50 GB/s)
a GPU between nodes. The membership and managed-comm counters of the
JAX module belong to the async tier (ROADMAP queue A item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

from ..numeric import policy
from ..parallel.mesh import DATA_AXIS, DataGroup
from ..parallel.strategies import (DENSE, LOCAL, SFB, TOPK, CommConfig,
                                   budget_topk_fraction)

# published H100 SXM link rates a GPU, in GB/s (NVIDIA's data sheets):
# NVLink 4 (900 GB/s both directions together) inside a node, and one
# ConnectX-7 400 Gb/s NIC a GPU between nodes
NVLINK_GBPS = 450.0
NIC_GBPS = 50.0


@dataclass
class CommCostModel:
    ici_gbps: float = NVLINK_GBPS     # the fast tier, inside a slice
    dcn_gbps: float = NIC_GBPS        # the slow tier, between slices
    topk_index_bytes: int = 4


def _allreduce_bytes(param_bytes: float, n: int) -> float:
    """Ring all-reduce: reduce-scatter + all-gather, 2 (n - 1) / n."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * param_bytes


def _allgather_bytes(total_bytes: float, n: int) -> float:
    """Ring all-gather: each device receives everyone else's shard."""
    if n <= 1:
        return 0.0
    return (n - 1) / n * total_bytes


def _tiers(comm: CommConfig, group: Union[DataGroup, Dict[str, int]]):
    """(devices a slice, slices) of a ``DataGroup`` or an {axis: size}
    dict (``"data"`` and, with ``comm.dcn_axis``, that axis)."""
    if isinstance(group, DataGroup):
        if comm.dcn_axis is None:
            return group.world, 1
        return group.slice_size, group.slices
    shape = dict(group)
    return shape[DATA_AXIS], (shape[comm.dcn_axis] if comm.dcn_axis
                              else 1)


def layer_comm_table(net, comm: Optional[CommConfig],
                     group: Union[DataGroup, Dict[str, int]],
                     cost: Optional[CommCostModel] = None
                     ) -> Dict[str, Dict]:
    """Per-layer static comm accounting: strategy, bytes a step a device
    by tier, the dense alternative's bytes, the saving, and the estimated
    comm time under ``cost``. ``group`` is the step's ``DataGroup`` or a
    hypothetical {axis: size} shape."""
    comm = comm or CommConfig()
    cost = cost or CommCostModel()
    # exchanged bytes ride the wire dtype when one is set; the dense
    # alternative stays at the gradient's
    wd = comm.wire_torch_dtype()
    # gradients are counted at the policy's compute dtype, as in JAX
    grad_bytes = policy().compute_dtype.itemsize
    wire_bytes = wd.itemsize if wd is not None else grad_bytes
    n_ici, n_dcn = _tiers(comm, group)
    n_total = n_ici * n_dcn
    fast_n = n_total if n_dcn == 1 else n_ici
    topk_fraction = budget_topk_fraction(net, comm)

    table: Dict[str, Dict] = {}
    for layer in net.layers:
        defs = net.param_defs.get(layer.name)
        if not defs:
            continue
        strategy = comm.strategy_for(layer.name)
        param_count = sum(p.count for p in defs)
        param_bytes = param_count * grad_bytes
        sent_param_bytes = param_count * wire_bytes
        dense_ici = _allreduce_bytes(param_bytes, fast_n)
        dense_dcn = _allreduce_bytes(param_bytes, n_dcn)
        sent_ici = _allreduce_bytes(sent_param_bytes, fast_n)
        sent_dcn = _allreduce_bytes(sent_param_bytes, n_dcn)

        ici_b = dcn_b = 0.0
        if strategy == DENSE:
            ici_b, dcn_b = sent_ici, sent_dcn
        elif strategy == SFB:
            wdef = next((p for p in defs if len(p.shape) == 2), None)
            if wdef is not None:
                m, k = wdef.shape
                b_global = net.blob_shapes[layer.lp.bottom[0]][0] * n_total
                total = b_global * (m + k) * wire_bytes
                ici_b = _allgather_bytes(total, fast_n)
                dcn_b = _allgather_bytes(total, n_dcn)
                # the bias rides a dense all-reduce
                bias = param_count - m * k
                ici_b += _allreduce_bytes(bias * wire_bytes, fast_n)
            else:
                ici_b, dcn_b = sent_ici, sent_dcn
        elif strategy == TOPK:
            k_entries = max(1, int(param_count * topk_fraction))
            logical = k_entries * (cost.topk_index_bytes + wire_bytes)
            if n_dcn > 1:
                # dense inside the slice, compressed between slices
                ici_b = sent_ici
                dcn_b = _allreduce_bytes(logical, n_dcn)
            else:
                ici_b = _allreduce_bytes(logical, n_total)
        elif strategy == LOCAL:
            pass

        dense_total = dense_ici + dense_dcn
        sent_total = ici_b + dcn_b
        est_ms = (ici_b / (cost.ici_gbps * 1e9)
                  + dcn_b / (cost.dcn_gbps * 1e9)) * 1e3
        table[layer.name] = {
            "strategy": strategy,
            "param_count": int(param_count),
            "ici_bytes_per_step": int(ici_b),
            "dcn_bytes_per_step": int(dcn_b),
            "dense_alternative_bytes": int(dense_total),
            # None when nothing is sent
            "savings_vs_dense": (round(dense_total / sent_total, 2)
                                 if sent_total else None),
            "est_comm_ms": round(est_ms, 4),
        }
    return table


def comm_summary(table: Dict[str, Dict],
                 measured_step_ms: Optional[float] = None) -> Dict:
    """Run-level totals and, given a measured step, the comm share if
    nothing overlapped."""
    ici = sum(r["ici_bytes_per_step"] for r in table.values())
    dcn = sum(r["dcn_bytes_per_step"] for r in table.values())
    dense = sum(r["dense_alternative_bytes"] for r in table.values())
    est_ms = sum(r["est_comm_ms"] for r in table.values())
    out = {
        "ici_bytes_per_step": int(ici),
        "dcn_bytes_per_step": int(dcn),
        "total_bytes_per_step": int(ici + dcn),
        "dense_alternative_bytes": int(dense),
        "savings_vs_dense": (round(dense / (ici + dcn), 2)
                             if (ici + dcn) else None),
        "est_comm_ms_per_step": round(est_ms, 4),
    }
    if measured_step_ms:
        # an upper bound: DWBP exists to hide this share behind compute
        out["measured_step_ms"] = round(measured_step_ms, 4)
        out["est_comm_fraction_if_unoverlapped"] = round(
            min(1.0, est_ms / measured_step_ms), 4)
    return out
