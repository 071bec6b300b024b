"""Flat parameter arena: packed leaves, static offsets, bucketed ranges (the
port of ``poseidon_tpu/core/arena.py``).

- **Offset table** (``ArenaSlot``): every f32 parameter leaf gets a static
  ``[offset, offset+size)`` range in one flat buffer, in DWBP order —
  REVERSE forward layer order, the order gradients materialize during
  backward — so the data-parallel sync (``parallel/strategies.py``) cuts
  the gradient buffer into buckets whose gradients exist first.
- **Buckets** (``bucket_ranges``): the flat range cut at exact
  ``bucket_mb`` element boundaries (leaves may span buckets).
- **Views** (``views``): the per-leaf tree as views of one flat tensor,
  ``flat[off:off+n].view(shape)``, taken with one ``split``. The train
  step makes its leaves from the views of the parameter buffer and points
  their ``.grad`` at the views of a gradient buffer, so autograd writes
  the whole gradient into one flat buffer (``parallel/trainer.py``). The
  JAX package needs a custom-vjp for this; torch views do it natively.
- **Multiplier segments** (``mult_vectors``): per-leaf ``lr_mult`` and
  ``weight_decay * decay_mult`` expanded to f32 vectors over the buffer,
  so the whole update is one elementwise pass (``ops/sgd.py``).

The offsets, buckets and multiplier vectors equal the JAX package's for the
same net, so the two stay interchangeable for tools that re-derive them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class ArenaSlot:
    """One parameter leaf's static range within the flat buffer."""
    layer: str
    pname: str
    shape: Tuple[int, ...]
    offset: int          # element offset within the flat f32 buffer
    size: int
    lr_mult: float
    decay_mult: float


class ArenaLayout:
    """Static offset table + bucket ranges for one Net's leaves."""

    def __init__(self, slots: Sequence[ArenaSlot], bucket_mb: Optional[float]):
        if not slots:
            raise ValueError("empty arena")
        self.slots: Tuple[ArenaSlot, ...] = tuple(slots)
        self.total = slots[-1].offset + slots[-1].size
        self.dtype = torch.float32
        if bucket_mb is None or bucket_mb <= 0:
            # per-leaf buckets (the dwbp_bucket_mb=0 convention)
            self.bucket_ranges = [(s.offset, s.offset + s.size)
                                  for s in self.slots]
        else:
            b = max(1, int(bucket_mb * 1e6) // 4)
            self.bucket_ranges = [(lo, min(lo + b, self.total))
                                  for lo in range(0, self.total, b)]
        self.n_buckets = len(self.bucket_ranges)

    def pack(self, tree: Tree, out: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """Per-leaf tree -> flat 1-D f32 buffer in slot order (copied into
        ``out`` when given; a leaf that already is that view is left)."""
        if out is None:
            out = torch.empty(self.total, dtype=self.dtype,
                              device=self._leaf(tree, self.slots[0]).device)
        for s, view in zip(self.slots, self.views(out)):
            leaf = self._leaf(tree, s)
            if not _same_view(leaf, view):
                view.copy_(leaf.detach())
        return out

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The leaves as views of ``flat``, in slot order."""
        if flat.shape != (self.total,):
            raise ValueError(f"arena buffer has shape {tuple(flat.shape)}, "
                             f"the layout {self.total} elements")
        parts = flat.split([s.size for s in self.slots])
        return [p.view(s.shape) for p, s in zip(parts, self.slots)]

    def unpack(self, flat: torch.Tensor) -> Tree:
        """Flat buffer -> per-leaf tree of views (no copy)."""
        out: Tree = {}
        for s, v in zip(self.slots, self.views(flat)):
            out.setdefault(s.layer, {})[s.pname] = v
        return out

    def _leaf(self, tree: Tree, slot: ArenaSlot) -> torch.Tensor:
        v = tree[slot.layer][slot.pname]
        if v.dtype != self.dtype:
            raise TypeError(
                f"arena leaf {slot.layer}/{slot.pname} is {v.dtype}, not "
                f"{self.dtype}; the flat parameter arena is f32-homogeneous")
        if tuple(v.shape) != slot.shape:
            raise ValueError(f"arena leaf {slot.layer}/{slot.pname} has shape "
                             f"{tuple(v.shape)}, the net {slot.shape}")
        return v

    def mult_vectors(self, weight_decay: float):
        """(lr_mults, local_decays) as f32 numpy vectors over the buffer:
        f32(lr_mult) and f32(weight_decay * decay_mult), the product taken
        in Python float first, as the JAX package's per-leaf rule does."""
        lr = np.zeros(self.total, np.float32)
        dec = np.zeros(self.total, np.float32)
        for s in self.slots:
            lr[s.offset:s.offset + s.size] = np.float32(s.lr_mult)
            dec[s.offset:s.offset + s.size] = np.float32(
                weight_decay * s.decay_mult)
        return lr, dec


def _same_view(leaf: torch.Tensor, view: torch.Tensor) -> bool:
    return (leaf.device == view.device and leaf.data_ptr() == view.data_ptr()
            and leaf.shape == view.shape and leaf.stride() == view.stride())


def build_arena(order: Sequence[Tuple[str, object]],
                bucket_mb: Optional[float]) -> Optional[ArenaLayout]:
    """ArenaLayout over ``order``, the Net's DWBP-ordered (layer, ParamDef)
    table. None when it is empty."""
    slots: List[ArenaSlot] = []
    off = 0
    for lname, pdef in order:
        slots.append(ArenaSlot(lname, pdef.name, tuple(pdef.shape), off,
                               pdef.count, pdef.lr_mult, pdef.decay_mult))
        off += pdef.count
    if not slots:
        return None
    return ArenaLayout(slots, bucket_mb)
