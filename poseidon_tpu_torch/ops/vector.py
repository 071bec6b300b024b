"""The vector width of the channels-last kernels (``csrc/vec.cuh``): how many
consecutive channels a thread of K4-NHWC (``csrc/lrn_fwd.cu``), K5-NHWC
(``csrc/lrn_bwd.cu``) or K6-NHWC (``csrc/pool_bwd.cu``) moves as one
access. Decided here, where a CPU test
reaches it, and passed to the C entries, which refuse a width that does not
divide C or that a pointer is not aligned to."""

from __future__ import annotations

VECTOR_BYTES = 16


def vector_width(channels: int, elem_size: int, *addresses: int,
                 most: int = VECTOR_BYTES) -> int:
    """The most elements, a power of two within VECTOR_BYTES bytes and
    ``most`` elements, that divide ``channels`` and whose bytes divide every
    address: 4 float32 or 8 bfloat16 channels for AlexNet's widths on a
    fresh tensor, fewer for a C off that multiple or a tensor that starts
    off a 16-byte boundary; at least one element."""
    v = min(VECTOR_BYTES // elem_size, most)
    while v > 1 and (channels % v
                     or any(a % (v * elem_size) for a in addresses)):
        v //= 2
    return v
