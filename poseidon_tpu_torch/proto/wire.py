"""Socket framing, the binary tensor codec, and ``.caffemodel`` decoding.

The port's own copy of the parts of ``poseidon_tpu/proto/wire.py`` that the
serving slice uses:

- the length-prefixed socket framing (8-byte big-endian length + payload)
  with its configurable frame cap and malformed-frame containment;
- the zero-copy binary tensor codec (wire codec v1), negotiated per
  connection, so a client of either package talks to a server of either
  package byte for byte, with its kill-switch (``POSEIDON_WIRE_CODEC`` /
  ``set_wire_codec``) and its encode/decode telemetry (``wire_stats``);
- bf16 leaves without ``ml_dtypes``: ``Bf16Array`` is a uint16 array of
  bf16 bit patterns that rides the codec under the dtype NAME
  ``bfloat16``, the name the JAX package's bf16 arrays carry, so a bf16
  frame from either package decodes to the same f32 values in the other;
- the shared-secret HMAC handshake of the async-SSP tier
  (``server_handshake``/``client_handshake``), run over raw bytes before
  any frame is parsed;
- the protobuf wire-format reader behind ``decode_caffemodel``;
- the writers the training slice needs: ``Datum`` records
  (``decode_datum``/``encode_datum``, for LMDB data), ``BlobProto``
  (``encode_blob``/``read_blob_file``, for mean files) and
  ``encode_caffemodel`` (snapshots).

Payloads are either a codec frame (magic ``PTC\\x01``) or a pickle; the
receiver tells them apart by the magic, as the JAX package does.
"""

from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

WIRETYPE_VARINT = 0
WIRETYPE_64BIT = 1
WIRETYPE_LEN = 2
WIRETYPE_32BIT = 5


class WireError(ValueError):
    pass


# --------------------------------------------------------------------------- #
# Length-prefixed socket framing. A malformed or truncated frame raises
# FrameError so the receiving service drops ONE connection instead of dying
# in its handler.
# --------------------------------------------------------------------------- #

class FrameError(ConnectionError):
    """Malformed or truncated wire frame (mid-message EOF, oversized
    length, undecodable payload)."""


class FrameTooLargeError(ValueError):
    """Send-side refusal of an over-cap frame: deterministic and local, so
    it is not a ConnectionError that reconnect logic would retry."""


DEFAULT_MAX_FRAME = 1 << 30          # 1 GiB
MAX_FRAME_ENV = "POSEIDON_MAX_FRAME_BYTES"


def max_frame_bytes() -> int:
    """The frame cap: ``POSEIDON_MAX_FRAME_BYTES`` when it is a positive
    integer, else 1 GiB (a garbage header fails before any allocation)."""
    env = os.environ.get(MAX_FRAME_ENV)
    if env:
        try:
            n = int(env)
        except ValueError:
            n = -1
        if n > 0:
            return n
    return DEFAULT_MAX_FRAME


# --------------------------------------------------------------------------- #
# Zero-copy binary tensor codec (wire codec v1):
#
#   CODEC_MAGIC(4) | u32 skeleton_len | skeleton | raw tensor buffers
#
# The skeleton is a pickle-free tag encoding of the message tree; every
# ndarray leaf is a dtype-name + shape reference whose bytes follow the
# skeleton in reference order. Whether a SENDER may use the codec is
# negotiated per connection (the "wire" request kind) and recorded in a
# WeakSet of sockets; a peer that does not affirm it stays on pickle.
# --------------------------------------------------------------------------- #

CODEC_MAGIC = b"PTC\x01"
WIRE_CODEC_VERSION = 1
WIRE_CODEC_ENV = "POSEIDON_WIRE_CODEC"
_codec_override: Optional[bool] = None
_codec_socks: "weakref.WeakSet" = weakref.WeakSet()

_wire_stats_lock = threading.Lock()
_wire_stats = {
    "frames_encoded": 0, "encode_ns": 0, "encoded_bytes": 0,
    "frames_decoded": 0, "decode_ns": 0, "decoded_bytes": 0,
    "pickle_frames_sent": 0, "pickle_frames_recv": 0,
}


def wire_stats() -> Dict[str, int]:
    """Process-wide codec telemetry: (de)serialization time and bytes
    (socket time excluded), and the pickle frames sent and received."""
    with _wire_stats_lock:
        return dict(_wire_stats)


def reset_wire_stats() -> None:
    with _wire_stats_lock:
        for k in _wire_stats:
            _wire_stats[k] = 0


def wire_codec_enabled() -> bool:
    """Codec kill-switch: :func:`set_wire_codec` wins, then the
    ``POSEIDON_WIRE_CODEC`` env, then on. Off: negotiation is never
    offered or accepted and every frame is the pickle wire."""
    if _codec_override is not None:
        return _codec_override
    env = os.environ.get(WIRE_CODEC_ENV)
    if env is not None:
        return env.strip().lower() not in ("0", "off", "false", "no", "")
    return True


def set_wire_codec(on: Optional[bool]) -> None:
    """Process-wide codec override (None restores env/default)."""
    global _codec_override
    _codec_override = on


class Bf16Array(np.ndarray):
    """bf16 values as their uint16 bit patterns (the high half of the f32
    bits). The codec sends it under the dtype name ``bfloat16`` and
    decodes that name back into one, so the port needs no bf16 numpy
    dtype. Rounding from f32 is torch's (round to nearest even), the
    rounding of ``ml_dtypes``."""


def bf16_from_f32(v: np.ndarray) -> Bf16Array:
    """Round f32 values to bf16 (nearest even) and keep the bits."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    bits = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits.reshape(np.shape(v)).view(Bf16Array)


def bf16_to_f32(b: np.ndarray) -> np.ndarray:
    """The exact f32 value of each bf16 bit pattern."""
    return (np.asarray(b).astype(np.uint32) << 16).view(np.float32)


def mark_codec_socket(sock: socket.socket) -> None:
    """Record that the peer on ``sock`` negotiated wire codec v1."""
    _codec_socks.add(sock)


def socket_uses_codec(sock: socket.socket) -> bool:
    return sock in _codec_socks


class _CodecUnsupported(Exception):
    """The message holds something the skeleton cannot carry; the frame
    falls back to pickle."""


_MAX_SKELETON_DEPTH = 64
BF16_NAME = "bfloat16"


def _dtype_from_name(name: str) -> np.dtype:
    """A wire dtype name; ``bfloat16`` reads as its uint16 bits."""
    return np.dtype(np.uint16) if name == BF16_NAME else np.dtype(name)


def _dtype_wire_ok(dt: np.dtype) -> bool:
    """A dtype rides the codec iff its NAME round-trips to itself."""
    try:
        return (not dt.hasobject) and np.dtype(dt.name) == dt
    except TypeError:
        return False


def _enc_skeleton(obj, out: bytearray, arrays: List[np.ndarray],
                  depth: int) -> None:
    if depth > _MAX_SKELETON_DEPTH:
        raise _CodecUnsupported("nesting too deep")
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif type(obj) is int:
        try:
            out += b"i" + struct.pack("!q", obj)
        except struct.error:
            raise _CodecUnsupported("int out of i64 range") from None
    elif type(obj) is float:
        out += b"f" + struct.pack("!d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        out += b"s" + struct.pack("!I", len(raw))
        out += raw
    elif type(obj) is bytes:
        out += b"y" + struct.pack("!I", len(obj))
        out += obj
    elif isinstance(obj, np.ndarray):
        bf16 = isinstance(obj, Bf16Array)
        if not (bf16 or _dtype_wire_ok(obj.dtype)) or obj.ndim > 255:
            raise _CodecUnsupported(f"array dtype {obj.dtype}")
        nm = (BF16_NAME if bf16 else obj.dtype.name).encode("ascii")
        out += b"a" + struct.pack("!B", len(nm)) + nm
        out += struct.pack("!B", obj.ndim)
        for d in obj.shape:
            out += struct.pack("!Q", d)
        arrays.append(obj)
    elif isinstance(obj, np.generic):
        dt = np.asarray(obj).dtype
        if not _dtype_wire_ok(dt):
            raise _CodecUnsupported(f"scalar dtype {dt}")
        nm = dt.name.encode("ascii")
        raw = obj.tobytes()
        out += b"z" + struct.pack("!B", len(nm)) + nm
        out += struct.pack("!B", len(raw))
        out += raw
    elif type(obj) in (list, tuple):
        out += (b"l" if type(obj) is list else b"t")
        out += struct.pack("!I", len(obj))
        for item in obj:
            _enc_skeleton(item, out, arrays, depth + 1)
    elif type(obj) is dict:
        out += b"d" + struct.pack("!I", len(obj))
        for k, v in obj.items():
            _enc_skeleton(k, out, arrays, depth + 1)
            _enc_skeleton(v, out, arrays, depth + 1)
    else:
        raise _CodecUnsupported(type(obj).__name__)


def encode_codec_payload(obj):
    """``(parts, nbytes)`` for a scatter-gather send, or None when the
    message needs the pickle fallback."""
    out = bytearray()
    arrays: List[np.ndarray] = []
    try:
        _enc_skeleton(obj, out, arrays, 0)
    except _CodecUnsupported:
        return None
    if len(out) > 0xFFFFFFFF:
        return None
    parts: List = [CODEC_MAGIC + struct.pack("!I", len(out)) + bytes(out)]
    total = len(parts[0])
    for arr in arrays:
        mv = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        parts.append(mv)
        total += len(mv)
    return parts, total


class _DecCursor:
    """Bounds-checked cursors over one payload: ``pos`` walks the
    skeleton, ``data`` walks the trailing tensor region."""

    __slots__ = ("mv", "pos", "skel_end", "data", "end")

    def __init__(self, mv: memoryview, skel_end: int):
        self.mv = mv
        self.pos = 8
        self.skel_end = skel_end
        self.data = skel_end
        self.end = len(mv)

    def take(self, n: int) -> memoryview:
        if self.pos + n > self.skel_end:
            raise FrameError("codec skeleton truncated")
        v = self.mv[self.pos:self.pos + n]
        self.pos += n
        return v

    def take_data(self, n: int) -> memoryview:
        if self.data + n > self.end:
            raise FrameError("codec tensor data truncated")
        v = self.mv[self.data:self.data + n]
        self.data += n
        return v


def _dec_skeleton(cur: _DecCursor, depth: int):
    if depth > _MAX_SKELETON_DEPTH:
        raise FrameError("codec skeleton too deep")
    tag = bytes(cur.take(1))
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return struct.unpack("!q", cur.take(8))[0]
    if tag == b"f":
        return struct.unpack("!d", cur.take(8))[0]
    if tag == b"s":
        (n,) = struct.unpack("!I", cur.take(4))
        return bytes(cur.take(n)).decode("utf-8")
    if tag == b"y":
        (n,) = struct.unpack("!I", cur.take(4))
        return bytes(cur.take(n))
    if tag == b"a":
        (nml,) = struct.unpack("!B", cur.take(1))
        name = bytes(cur.take(nml)).decode("ascii")
        dt = _dtype_from_name(name)
        (nd,) = struct.unpack("!B", cur.take(1))
        shape = tuple(struct.unpack("!Q", cur.take(8))[0]
                      for _ in range(nd))
        count = 1
        for d in shape:
            count *= d
        raw = cur.take_data(count * dt.itemsize)
        arr = np.frombuffer(raw, dtype=dt).reshape(shape)
        return arr.view(Bf16Array) if name == BF16_NAME else arr
    if tag == b"z":
        (nml,) = struct.unpack("!B", cur.take(1))
        dt = np.dtype(bytes(cur.take(nml)).decode("ascii"))
        (n,) = struct.unpack("!B", cur.take(1))
        return np.frombuffer(bytes(cur.take(n)), dtype=dt)[0]
    if tag in (b"l", b"t"):
        (n,) = struct.unpack("!I", cur.take(4))
        items = [_dec_skeleton(cur, depth + 1) for _ in range(n)]
        return items if tag == b"l" else tuple(items)
    if tag == b"d":
        (n,) = struct.unpack("!I", cur.take(4))
        return {_dec_skeleton(cur, depth + 1): _dec_skeleton(cur, depth + 1)
                for _ in range(n)}
    raise FrameError(f"unknown codec skeleton tag {tag!r}")


def decode_codec_payload(buf) -> object:
    """Decode one codec payload (INCLUDING the magic); any mismatch between
    the skeleton's tensor extents and the payload size raises FrameError."""
    mv = memoryview(buf)
    if len(mv) < 8 or bytes(mv[:4]) != CODEC_MAGIC:
        raise FrameError("not a codec payload")
    (skel_len,) = struct.unpack("!I", mv[4:8])
    if 8 + skel_len > len(mv):
        raise FrameError("codec skeleton overruns frame")
    cur = _DecCursor(mv, 8 + skel_len)
    try:
        obj = _dec_skeleton(cur, 0)
    except FrameError:
        raise
    except Exception as e:  # noqa: BLE001 — any malformed skeleton
        raise FrameError(
            f"bad codec skeleton: {type(e).__name__}: {e}") from e
    if cur.pos != cur.skel_end:
        raise FrameError("codec skeleton has trailing bytes")
    if cur.data != cur.end:
        raise FrameError(
            f"codec frame size mismatch: skeleton consumed "
            f"{cur.data - cur.skel_end} tensor bytes of "
            f"{cur.end - cur.skel_end} in the frame")
    return obj


_SENDMSG_BATCH = 64  # stay far under IOV_MAX for one sendmsg call


def _sendmsg_all(sock: socket.socket, parts: List) -> None:
    """sendall() for a scatter-gather buffer list."""
    bufs = [p if isinstance(p, memoryview) else memoryview(p)
            for p in parts]
    while bufs:
        n = sock.sendmsg(bufs[:_SENDMSG_BATCH])
        while bufs and n >= len(bufs[0]):
            n -= len(bufs[0])
            bufs.pop(0)
        if bufs and n:
            bufs[0] = bufs[0][n:]


def _check_cap(n: int) -> None:
    cap = max_frame_bytes()
    if n > cap:
        raise FrameTooLargeError(
            f"refusing to send a {n}-byte frame over the {cap}-byte cap "
            f"(raise {MAX_FRAME_ENV} on both ends for frames this large)")


def send_frame(sock: socket.socket, obj, codec: Optional[bool] = None) -> int:
    """Send one frame; returns the wire bytes (header + payload).
    ``codec=None`` resolves per socket (set during negotiation)."""
    if codec is None:
        codec = socket_uses_codec(sock)
    if codec and wire_codec_enabled():
        t0 = time.perf_counter_ns()
        enc = encode_codec_payload(obj)
        dt = time.perf_counter_ns() - t0
        if enc is not None:
            parts, n = enc
            _check_cap(n)
            _sendmsg_all(sock, [struct.pack("!Q", n)] + parts)
            with _wire_stats_lock:
                _wire_stats["frames_encoded"] += 1
                _wire_stats["encode_ns"] += dt
                _wire_stats["encoded_bytes"] += n
            return n + 8
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    data = buf.getvalue()
    _check_cap(len(data))
    sock.sendall(struct.pack("!Q", len(data)) + data)
    with _wire_stats_lock:
        _wire_stats["pickle_frames_sent"] += 1
    return len(data) + 8


def recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    want = n
    while want:
        c = sock.recv(min(want, 1 << 20))
        if not c:
            if want == n:
                raise ConnectionError("peer closed")
            raise FrameError(f"mid-message EOF ({n - want}/{n} bytes)")
        chunks.append(c)
        want -= len(c)
    return b"".join(chunks)


def recv_frame_sized(sock: socket.socket):
    """Receive one frame; returns (obj, wire bytes: header + payload), the
    pull side of the managed tier's bandwidth accounting. The payload
    buffer is allocated once, sized by the cap-checked length prefix;
    codec frames are detected by magic."""
    (n,) = struct.unpack("!Q", recv_exact(sock, 8))
    cap = max_frame_bytes()
    if n > cap:
        raise FrameError(
            f"frame length {n} exceeds cap {cap} (garbage header, or a "
            f"legitimately huge frame — raise {MAX_FRAME_ENV} on both ends "
            f"if it is the latter)")
    payload = bytearray(n)
    view = memoryview(payload)
    got = 0
    try:
        while got < n:
            r = sock.recv_into(view[got:], min(n - got, 1 << 20))
            if r == 0:
                raise FrameError(
                    f"mid-message EOF in payload ({got}/{n} bytes)")
            got += r
    except FrameError:
        raise
    except ConnectionError as e:
        raise FrameError(f"mid-message EOF in payload ({e})") from e
    if n >= len(CODEC_MAGIC) and payload[:4] == CODEC_MAGIC:
        t0 = time.perf_counter_ns()
        obj = decode_codec_payload(payload)
        with _wire_stats_lock:
            _wire_stats["frames_decoded"] += 1
            _wire_stats["decode_ns"] += time.perf_counter_ns() - t0
            _wire_stats["decoded_bytes"] += n
        return obj, n + 8
    try:
        obj = pickle.loads(bytes(payload))
    except Exception as e:  # noqa: BLE001 — any undecodable payload
        raise FrameError(f"bad frame payload: {type(e).__name__}: {e}") from e
    with _wire_stats_lock:
        _wire_stats["pickle_frames_recv"] += 1
    return obj, n + 8


def recv_frame(sock: socket.socket):
    """Receive one frame (see :func:`recv_frame_sized`)."""
    return recv_frame_sized(sock)[0]


# --------------------------------------------------------------------------- #
# Shared-secret connection handshake (the JAX package's, byte for byte).
# Frame payloads may be pickles, so an auth-enabled tier authenticates every
# connection MUTUALLY over raw bytes before either side parses a frame:
#
#   server -> client : MAGIC + nonce_s                 (challenge)
#   client -> server : HMAC(token, nonce_s) + nonce_c  (proof + challenge)
#   server -> client : HMAC(token, nonce_c + b"srv")   (proof)
#
# Digests are HMAC-SHA256, compared in constant time. The token rides the
# launcher env (POSEIDON_ASYNC_TOKEN).
# --------------------------------------------------------------------------- #

AUTH_MAGIC = b"PSDNAUTH"
AUTH_NONCE_LEN = 16
AUTH_DIGEST_LEN = 32  # sha256
_AUTH_SERVER_TAG = b"srv"


class AuthError(ConnectionError):
    """Handshake failed: bad token, wrong protocol bytes, or a peer that
    speaks frames at an auth-required service."""


def _hmac_digest(token: str, nonce: bytes) -> bytes:
    import hashlib
    import hmac
    return hmac.new(token.encode("utf-8"), nonce, hashlib.sha256).digest()


def server_handshake(sock: socket.socket, token: str,
                     timeout_s: float = 5.0) -> bool:
    """Authenticate one inbound connection and prove our own token back.
    True on success; False (the caller then closes the socket without
    reading a frame) on any mismatch, timeout or protocol violation."""
    import hmac
    nonce = os.urandom(AUTH_NONCE_LEN)
    prev = sock.gettimeout()
    sock.settimeout(timeout_s)
    try:
        sock.sendall(AUTH_MAGIC + nonce)
        got = recv_exact(sock, AUTH_DIGEST_LEN + AUTH_NONCE_LEN)
        digest, nonce_c = got[:AUTH_DIGEST_LEN], got[AUTH_DIGEST_LEN:]
        if not hmac.compare_digest(digest, _hmac_digest(token, nonce)):
            return False
        sock.sendall(_hmac_digest(token, nonce_c + _AUTH_SERVER_TAG))
        return True
    except (OSError, ConnectionError, socket.timeout):
        return False
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            pass


def client_handshake(sock: socket.socket, token: str,
                     timeout_s: float = 5.0) -> None:
    """Answer the server's challenge and verify the server's proof before
    the caller parses any frame; AuthError on a protocol mismatch (a
    service without a token sends no challenge) or a server that cannot
    prove the token."""
    import hmac
    prev = sock.gettimeout()
    sock.settimeout(timeout_s)
    try:
        head = recv_exact(sock, len(AUTH_MAGIC) + AUTH_NONCE_LEN)
        if not head.startswith(AUTH_MAGIC):
            raise AuthError("peer did not offer an auth challenge "
                            "(token configured on one side only?)")
        nonce_s = head[len(AUTH_MAGIC):]
        nonce_c = os.urandom(AUTH_NONCE_LEN)
        sock.sendall(_hmac_digest(token, nonce_s) + nonce_c)
        proof = recv_exact(sock, AUTH_DIGEST_LEN)
        if not hmac.compare_digest(
                proof, _hmac_digest(token, nonce_c + _AUTH_SERVER_TAG)):
            raise AuthError("peer failed to prove the shared token "
                            "(spoofed service?)")
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            pass


# --------------------------------------------------------------------------- #
# Protobuf wire-format reader (proto2) for ``.caffemodel`` weight exchange.
# --------------------------------------------------------------------------- #

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    LEN fields yield raw bytes; VARINT yields int; 32/64-bit yield raw
    ints."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == WIRETYPE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == WIRETYPE_64BIT:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wtype == WIRETYPE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            if len(val) != ln:
                raise WireError("truncated length-delimited field")
            pos += ln
        elif wtype == WIRETYPE_32BIT:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _floats(wtype: int, val) -> np.ndarray:
    """A repeated-float field: packed bytes, or one 32-bit value."""
    if wtype == WIRETYPE_LEN:
        return np.frombuffer(val, dtype="<f4")
    if wtype == WIRETYPE_32BIT:
        return np.asarray(
            struct.unpack("<f", val.to_bytes(4, "little")), np.float32)
    raise WireError("expected a float field")


def decode_blob(buf: bytes) -> np.ndarray:
    """One BlobProto as a (num, channels, height, width) float32 array."""
    dims = [0, 0, 0, 0]
    parts: List[np.ndarray] = []
    for fnum, wtype, val in iter_fields(buf):
        if 1 <= fnum <= 4:
            dims[fnum - 1] = val
        elif fnum == 5:
            parts.append(_floats(wtype, val))
    data = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return np.asarray(data, np.float32).reshape(dims)


def decode_caffemodel(buf: bytes) -> Dict[str, List[np.ndarray]]:
    """Extract {layer_name: [blob arrays]} from a serialized NetParameter:
    the V1 ``layers`` field (2), layer name field 4, blobs field 6."""
    weights: Dict[str, List[np.ndarray]] = {}
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 2 and wtype == WIRETYPE_LEN:
            name = ""
            blobs: List[np.ndarray] = []
            for lf, lw, lv in iter_fields(val):
                if lf == 4 and lw == WIRETYPE_LEN:
                    name = lv.decode("utf-8", "replace")
                elif lf == 6 and lw == WIRETYPE_LEN:
                    blobs.append(decode_blob(lv))
            if name:
                weights[name] = blobs
    return weights


# --------------------------------------------------------------------------- #
# Protobuf writers, Datum, BlobProto files and .caffemodel encoding.
# --------------------------------------------------------------------------- #

def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _emit_tag(out: bytearray, fnum: int, wtype: int) -> None:
    _write_varint(out, (fnum << 3) | wtype)


def emit_varint_field(out: bytearray, fnum: int, value: int) -> None:
    _emit_tag(out, fnum, WIRETYPE_VARINT)
    _write_varint(out, value)


def emit_bytes_field(out: bytearray, fnum: int, value: bytes) -> None:
    _emit_tag(out, fnum, WIRETYPE_LEN)
    _write_varint(out, len(value))
    out.extend(value)


def emit_packed_floats(out: bytearray, fnum: int, values: np.ndarray) -> None:
    emit_bytes_field(out, fnum, np.asarray(values, dtype="<f4").tobytes())


@dataclass
class Datum:
    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int = 0
    float_data: Optional[np.ndarray] = None

    def to_array(self) -> np.ndarray:
        """(C, H, W) float32 array (uint8 bytes NOT mean-subtracted or
        scaled)."""
        if self.float_data is not None and len(self.float_data):
            return np.asarray(self.float_data, np.float32).reshape(
                self.channels, self.height, self.width)
        arr = np.frombuffer(self.data, dtype=np.uint8)
        return arr.reshape(self.channels, self.height,
                           self.width).astype(np.float32)


def decode_datum(buf: bytes) -> Datum:
    d = Datum()
    floats: List[np.ndarray] = []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:
            d.channels = val
        elif fnum == 2:
            d.height = val
        elif fnum == 3:
            d.width = val
        elif fnum == 4:
            d.data = val
        elif fnum == 5:
            d.label = val
        elif fnum == 6:
            floats.append(_floats(wtype, val))
    if floats:
        d.float_data = np.concatenate(floats).astype(np.float32)
    return d


def encode_datum(d: Datum) -> bytes:
    out = bytearray()
    emit_varint_field(out, 1, d.channels)
    emit_varint_field(out, 2, d.height)
    emit_varint_field(out, 3, d.width)
    if d.data:
        emit_bytes_field(out, 4, d.data)
    emit_varint_field(out, 5, d.label)
    if d.float_data is not None and len(d.float_data):
        emit_packed_floats(out, 6, d.float_data)
    return bytes(out)


def encode_blob(arr: np.ndarray) -> bytes:
    """One BlobProto: the shape padded out to 4-D (num, channels, height,
    width) with trailing ones, as Caffe's Blob::Reshape does, and the
    data packed."""
    shape = tuple(arr.shape)
    if len(shape) > 4:
        raise ValueError(f"blob rank > 4: {shape}")
    shape = shape + (1,) * (4 - len(shape))
    out = bytearray()
    for fnum, dim in enumerate(shape, start=1):
        emit_varint_field(out, fnum, dim)
    emit_packed_floats(out, 5, np.asarray(arr, np.float32).ravel())
    return bytes(out)


def read_blob_file(path: str) -> np.ndarray:
    """Read a .binaryproto BlobProto file (e.g. an image-mean file) as a
    (num, channels, height, width) float32 array."""
    with open(path, "rb") as f:
        return decode_blob(f.read())


def encode_caffemodel(net_name: str,
                      layer_weights: Dict[str, List[np.ndarray]]) -> bytes:
    """Serialize {layer: [blob arrays]} as a NetParameter binary that Caffe
    (and ``decode_caffemodel`` of either package) reads."""
    out = bytearray()
    emit_bytes_field(out, 1, net_name.encode())
    for lname, blobs in layer_weights.items():
        layer = bytearray()
        emit_bytes_field(layer, 4, lname.encode())
        for arr in blobs:
            emit_bytes_field(layer, 6, encode_blob(arr))
        emit_bytes_field(out, 2, bytes(layer))
    return bytes(out)
