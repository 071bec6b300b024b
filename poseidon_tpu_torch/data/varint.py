"""Shared LEB128 varint helpers (LevelDB + snappy wire formats): the port's
copy of ``poseidon_tpu/data/varint.py``."""

from __future__ import annotations

from typing import Tuple


class VarintError(ValueError):
    pass


def read_varint(buf: bytes, pos: int, max_shift: int = 70) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise VarintError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > max_shift:
            raise VarintError("varint too long")


def write_varint(out: bytearray, v: int) -> None:
    while True:
        bits = v & 0x7F
        v >>= 7
        if v:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return
