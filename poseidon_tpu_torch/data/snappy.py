"""Snappy codec (block format): the port's copy of
``poseidon_tpu/data/snappy.py``.

LevelDB compresses SSTable blocks with snappy; reading Caffe's default-backend
databases therefore needs a decompressor. Format (public spec): a varint32
uncompressed length, then tagged elements — literals (tag & 3 == 0) and
back-references (copy-1/2/4 byte offsets). ``uncompress`` decodes through
the native data plane's ``pdp_snappy_uncompress`` when its library is built
(``native.built_library``), else in Python; both raise ``SnappyError`` on
a malformed stream. The compressor emits the trivial all-literals encoding
(valid snappy, no compression), enough for writing databases other LevelDB
readers accept.
"""

from __future__ import annotations


from .varint import VarintError, read_varint, write_varint


class SnappyError(ValueError):
    pass


def _read_varint32(buf: bytes, pos: int):
    try:
        return read_varint(buf, pos, max_shift=32)
    except VarintError as e:
        raise SnappyError(str(e)) from e


def uncompress(buf: bytes) -> bytes:
    from .native import built_library, snappy_uncompress
    lib = built_library()
    if lib is None:
        return _uncompress_py(buf)
    try:
        return snappy_uncompress(buf, lib)
    except ValueError as e:
        raise SnappyError(str(e)) from e


def _uncompress_py(buf: bytes) -> bytes:
    expected, pos = _read_varint32(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        elem_type = tag & 3
        if elem_type == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += buf[pos:pos + length]
            pos += length
            continue
        if elem_type == 1:  # copy, 1-byte offset
            length = 4 + ((tag >> 2) & 0x7)
            if pos >= n:
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif elem_type == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("bad copy offset")
        start = len(out) - offset
        if offset >= length:
            # disjoint: one slice copy
            out += out[start:start + length]
        else:
            # overlapping copy: the source region repeats; double it up
            # (chunk + chunk, not +=: in-place extend from itself raises
            # BufferError on bytearray)
            chunk = out[start:]
            while len(chunk) < length:
                chunk = chunk + chunk
            out += chunk[:length]
    if len(out) != expected:
        raise SnappyError(f"length mismatch: {len(out)} != {expected}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """All-literals encoding: valid snappy output, no actual compression."""
    out = bytearray()
    write_varint(out, len(data))
    pos = 0
    while pos < len(data):
        chunk = min(len(data) - pos, 1 << 24)
        length = chunk - 1
        if length < 60:
            out.append(length << 2)
        elif length < (1 << 8):
            out.append(60 << 2)
            out += length.to_bytes(1, "little")
        elif length < (1 << 16):
            out.append(61 << 2)
            out += length.to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += length.to_bytes(3, "little")
        out += data[pos:pos + chunk]
        pos += chunk
    return bytes(out)
