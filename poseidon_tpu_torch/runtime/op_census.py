"""What one eager step really runs: every aten and c10d op, recorded.

The JAX package reads a step's collectives and layout transposes off the
compiled program's text (``poseidon_tpu/runtime/hlo_comm.py``,
``hlo_layout.py``). The port's step has no program text: it is eager
PyTorch. Its counterpart of the StableHLO level is the dispatcher: a
``TorchDispatchMode`` sees every op the step issues below autograd, on
the CPU and on the card alike, with its tensors' shapes, dtypes and
strides, and every c10d collective with its process group. The mode is
thread-local state that autograd carries to its device threads, so the
DWBP buckets issued from backward hooks are recorded too (``OpRecord``
keeps the thread's name).

``record(fn, *args)`` runs ``fn`` once under the mode and returns its
result and the ``OpRecord`` list; ``fake_world(n)`` lets one process act
as rank 0 of n, so an n-way step's collectives can be recorded without n
processes. A CUDA graph's replay issues no op:
census single eager steps only, as the JAX package censuses one compiled
step. ``runtime/hlo_layout.py`` and ``runtime/hlo_comm.py`` read the
records.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["TensorMeta", "OpRecord", "StepCensus", "record", "metas",
           "f64_tensors", "fake_world"]


@dataclass(frozen=True)
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: str           # "float32", "bfloat16", ...
    stride: Tuple[int, ...]
    element_size: int

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorMeta":
        return cls(tuple(t.shape), str(t.dtype).replace("torch.", ""),
                   tuple(t.stride()), t.element_size())

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.element_size

    def memory_order(self) -> Tuple[int, ...]:
        """The logical dims from outermost to innermost in memory (by
        stride, ties by index: a size-1 dim's stride is arbitrary)."""
        return tuple(sorted(range(len(self.shape)),
                            key=lambda d: (-self.stride[d], d)))


@dataclass
class OpRecord:
    op: str                          # "aten.clone.default", "c10d...."
    args: Tuple[Any, ...]            # TensorMeta, lists of them, or None
    outputs: Tuple[TensorMeta, ...]
    thread: str
    # c10d ops: the process group's size and global ranks, async or not
    group_size: Optional[int] = None
    group_ranks: Optional[Tuple[int, ...]] = None
    async_op: Optional[bool] = None


def _meta(a):
    if isinstance(a, torch.Tensor):
        return TensorMeta.of(a)
    if isinstance(a, (list, tuple)) and a and all(
            isinstance(x, (torch.Tensor, list, tuple)) for x in a):
        return tuple(_meta(x) for x in a)
    return None


def _flat_tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    return []


def _group_of(args) -> Tuple[Optional[int], Optional[Tuple[int, ...]]]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = ProcessGroup.unbox(a)
            except RuntimeError:
                continue
            try:
                ranks = tuple(dist.get_process_group_ranks(pg))
            except (RuntimeError, ValueError, KeyError):
                ranks = None
            return pg.size(), ranks
    return None, None


def _async_of(func, args, kwargs) -> Optional[bool]:
    for i, a in enumerate(func._schema.arguments):
        if a.name == "async_op":
            if i < len(args):
                return bool(args[i])
            return bool(kwargs.get("async_op", a.default_value))
    return None


class StepCensus(TorchDispatchMode):
    """Records every op dispatched while it is active (``records``)."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        rec = OpRecord(op=name, args=tuple(_meta(a) for a in args),
                       outputs=tuple(TensorMeta.of(t)
                                     for t in _flat_tensors(out)),
                       thread=threading.current_thread().name)
        if name.startswith("c10d."):
            rec.group_size, rec.group_ranks = _group_of(args)
            rec.async_op = _async_of(func, args, kwargs)
        # list.append is atomic: backward hooks record from autograd's
        # device threads
        self.records.append(rec)
        return out


def metas(arg) -> List[TensorMeta]:
    """The ``TensorMeta``s in one recorded argument (a tensor's, or those
    of a list of them, nested)."""
    if isinstance(arg, TensorMeta):
        return [arg]
    if isinstance(arg, tuple):
        return [m for a in arg for m in metas(a)]
    return []


def f64_tensors(records) -> int:
    """float64 tensors among the recorded ops' inputs and outputs."""
    return sum(1 for r in records
               for m in [*r.outputs, *(x for a in r.args for x in metas(a))]
               if m.dtype == "float64")


def record(fn: Callable, *args, **kwargs) -> Tuple[Any, List[OpRecord]]:
    """``fn(*args, **kwargs)`` once under a ``StepCensus``: (its result,
    the records)."""
    mode = StepCensus()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.records


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """One process acting as rank ``rank`` of ``world`` on PyTorch's
    "fake" backend (``torch.testing._internal.distributed.fake_pg``): its
    collectives pass through the dispatcher, so a ``StepCensus`` records
    them, and move no data. The cheap way to census an N-way step in one
    process. Refuses when a process group is up already; destroys its own
    (and every group made under it) on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is initialized "
                           "already in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
