"""Layout evidence: the layout conversions one train step really makes
(the port's ``poseidon_tpu/runtime/hlo_layout.py``).

The channels-last plan (``core/net.py`` under ``conv_layout`` "NHWC")
claims a conversion-free spatial chain: activations enter channels-last
once, every conv, pool and LRN runs in it, and the layout goes back to
NCHW only at a real boundary (the FC flatten). The JAX package checks
that claim on the lowered program: it counts the rank-4 transposes that
reorder non-degenerate dims (2 for AlexNet, the fc6 pair). The port's
step has no program text, so this module counts the same thing on what
the step dispatches (``runtime/op_census.py``): a copy-like op (``clone``,
``_to_copy``, ``copy_``, ``contiguous``) whose source and destination lie
in different memory orders is a transpose of the physical array, from the
source's order to the destination's. A ``permute`` that is then
materialized is one such copy; a permute that stays a view moves nothing
and is not counted. The JAX definition of a layout transpose then
applies unchanged (``TransposeOp.is_layout``: rank 4, reordering dims of
extent > 1).

What the dispatcher sees is the port's own plan: a conversion inside a
hand-written kernel, or inside an aten kernel below the dispatcher
(cuDNN's filter transform), is not an op and is not counted. On the card
``device_conversion_kernels`` lists the copy and transpose kernels that
``torch.profiler`` records, beside the count.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .op_census import OpRecord, TensorMeta, record

__all__ = ["TransposeOp", "parse_transposes", "count_layout_transposes",
           "layout_report", "build_plain_step", "step_avals",
           "step_inputs", "net_transpose_report",
           "device_conversion_kernels", "COPY_OPS"]

# the dispatcher ops that materialize a tensor in a (possibly) new layout
COPY_OPS = ("aten.clone.default", "aten._to_copy.default",
            "aten.copy_.default", "aten.contiguous.default")


@dataclass
class TransposeOp:
    out_shape: tuple
    perm: tuple
    op: str = ""

    @property
    def rank(self) -> int:
        return len(self.perm)

    @property
    def nontrivial(self) -> bool:
        """Reorders dims that actually have extent (> 1)?"""
        # operand dim d has size out_shape[i] where perm[i] == d
        op_size = {d: self.out_shape[i] for i, d in enumerate(self.perm)}
        nondeg = [d for d in self.perm if op_size.get(d, 1) > 1]
        return nondeg != sorted(nondeg)

    @property
    def is_layout(self) -> bool:
        return self.rank == 4 and self.nontrivial


def _transpose(op: str, src: TensorMeta,
               dst: TensorMeta) -> Optional[TransposeOp]:
    """The physical transpose of a copy from ``src``'s memory order to
    ``dst``'s, or None when the orders agree."""
    if len(src.shape) != len(dst.shape):
        return None
    so, do = src.memory_order(), dst.memory_order()
    if so == do:
        return None
    # out physical dim i holds logical dim do[i], which is the input's
    # physical dim so.index(do[i])
    return TransposeOp(out_shape=tuple(dst.shape[d] for d in do),
                       perm=tuple(so.index(d) for d in do), op=op)


def parse_transposes(records: Sequence[OpRecord]) -> List[TransposeOp]:
    """Every copy-like op of a step whose source and destination memory
    orders differ, in dispatch order."""
    out: List[TransposeOp] = []
    for r in records:
        if r.op not in COPY_OPS or not r.outputs:
            continue
        if r.op == "aten.copy_.default":
            dst, src = r.args[0], r.args[1]
        else:
            src, dst = r.args[0], r.outputs[0]
        if isinstance(src, TensorMeta) and isinstance(dst, TensorMeta):
            t = _transpose(r.op, src, dst)
            if t is not None:
                out.append(t)
    return out


def count_layout_transposes(records: Sequence[OpRecord]) -> int:
    """Rank-4, non-degenerate conversions: the activation layout
    changes."""
    return sum(1 for t in parse_transposes(records) if t.is_layout)


def layout_report(records: Sequence[OpRecord]) -> Dict:
    """The evidence row: total / layout / per-shape detail (JAX's keys,
    with the op of each)."""
    ops = parse_transposes(records)
    layout_ops = [t for t in ops if t.is_layout]
    return {
        "transposes_total": len(ops),
        "layout_transposes": len(layout_ops),
        "layout_transpose_shapes": [
            {"shape": list(t.out_shape), "perm": list(t.perm), "op": t.op}
            for t in layout_ops],
    }


def build_plain_step(net, sp=None, input_layout: Optional[str] = None):
    """The port's mesh-free optimizer step over ``net``: the one-device
    ``TrainStep`` (arena pack, forward, backward, the fused update);
    ``ts.step(params, state, batch) -> (params, state, metrics)``. ``sp``
    defaults to JAX's (fixed lr 0.01, momentum 0.9). ``input_layout`` must
    be the net's: the step takes its batch in the net's layout, as the
    JAX package's plain step does."""
    from ..parallel.strategies import CommConfig
    from ..parallel.trainer import build_train_step
    from ..proto.messages import SolverParameter
    if input_layout not in (None, net.conv_layout):
        raise ValueError(f"input_layout {input_layout!r} differs from the "
                         f"net's conv_layout {net.conv_layout!r}")
    sp = sp or SolverParameter(base_lr=0.01, lr_policy="fixed",
                               momentum=0.9)
    return build_train_step(net, sp, None, CommConfig())


def step_avals(net, per_dev_batch: int, image: int,
               input_layout: Optional[str] = None) -> Dict:
    """The shapes and dtypes of the plain step's arguments: ``{"params":
    {layer: {name: (shape, dtype)}}, "batch": {top: (shape, dtype,
    memory format)}}``; the data is channels-last under "NHWC" (JAX's
    NHWC aval)."""
    if input_layout is None:
        input_layout = net.conv_layout
    params = {l.name: {p.name: (tuple(p.shape), "float32")
                       for p in l.params} for l in net.layers if l.params}
    fmt = "channels_last" if input_layout == "NHWC" else "contiguous"
    return {"params": params,
            "batch": {"data": ((per_dev_batch, 3, image, image), "float32",
                               fmt),
                      "label": ((per_dev_batch,), "int64", "contiguous")}}


def step_inputs(ts, net, per_dev_batch: int, image: int, seed: int = 0,
                num_classes: int = 10):
    """(params, state, batch) for ``ts`` (``build_plain_step``'s), on its
    device: the net's filler weights from ``seed`` loaded into its arena,
    a numpy batch from ``seed`` in the layout of ``step_avals``."""
    from ..parallel.trainer import init_train_state
    av = step_avals(net, per_dev_batch, image)
    device = ts.flat_w.device
    params = net.init(torch.Generator().manual_seed(seed))
    params, state = ts.load(params, init_train_state(params, ts.comm,
                                                     ts.n_err_groups))
    rs = np.random.RandomState(seed)
    dshape, _, fmt = av["batch"]["data"]
    data = torch.from_numpy(rs.randn(*dshape).astype(np.float32)).to(device)
    if fmt == "channels_last":
        data = data.contiguous(memory_format=torch.channels_last)
    label = torch.from_numpy(rs.randint(0, num_classes, size=(
        per_dev_batch,)).astype(np.int64)).to(device)
    return params, state, {"data": data, "label": label}


def net_transpose_report(net, sp=None, per_dev_batch: int = 4,
                         image: int = 227, seed: int = 0) -> Dict:
    """One untraced warm-up step of ``net`` (on its device), then one step
    under the census: its layout report (JAX's keys), ``level`` "aten"
    (the dispatcher: the counterpart of JAX's StableHLO level)."""
    ts = build_plain_step(net, sp)
    params, state, batch = step_inputs(ts, net, per_dev_batch, image, seed)
    params, state, _ = ts.step(params, state, batch)
    _, records = record(ts.step, params, state, batch)
    rep = layout_report(records)
    rep["level"] = "aten"
    rep["conv_layout"] = net.conv_layout
    return rep


# the kernels a profiler names for copies and layout transforms on the
# card (ATen's copy kernels, cuDNN's and cuBLAS's transposes)
_CONVERSION_KERNEL_RE = re.compile(
    r"copy|transpose|nchw|nhwc|Nchw|Nhwc|NCHW|NHWC", re.I)


def device_conversion_kernels(fn: Callable, *args) -> Dict[str, int]:
    """Run ``fn(*args)`` twice under ``torch.profiler`` with the card
    recorded, the first call a warm-up the session drops (a session opened
    after earlier ones loses its first step's launches), the card
    synchronized before each profiler step: {kernel name: launches} of the
    copy and layout-transform kernels among the second call's device
    events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            fn(*args)
            torch.cuda.synchronize()
            prof.step()
    out: Dict[str, int] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                _CONVERSION_KERNEL_RE.search(ev.name):
            out[ev.name] = out.get(ev.name, 0) + 1
    return dict(sorted(out.items()))
