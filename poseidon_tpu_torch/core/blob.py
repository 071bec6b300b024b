"""Parameter definitions (the port of ``poseidon_tpu/core/blob.py``).

``ParamDef`` captures what Caffe spreads across ``Layer::SetUp`` +
``ParamSpec``/``blobs_lr``/``weight_decay``: the shape, the filler, and the
per-blob learning-rate / weight-decay multipliers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

from ..proto.messages import FillerParameter


@dataclass(frozen=True)
class ParamDef:
    """Definition of one learnable parameter blob of a layer."""

    name: str                    # short name within the layer: "w" / "b"
    shape: Tuple[int, ...]
    filler: FillerParameter
    lr_mult: float = 1.0
    decay_mult: float = 1.0

    @property
    def count(self) -> int:
        return int(math.prod(self.shape))

    @property
    def fan_in(self) -> int:
        """Caffe's ``blob->count() / blob->num()`` (filler.hpp)."""
        return self.count // self.shape[0] if self.shape else 1
