"""The port's HMAC handshake and the frames of the async-SSP tier, against
the JAX package's (``poseidon_tpu/proto/wire.py``):

- the port's ``server_handshake`` against JAX's ``client_handshake`` and
  the other way round, and each side's bytes equal to JAX's for the same
  nonces;
- a wrong token fails on both sides, and a service of either package
  parses no frame from such a connection (its frame counters and clocks
  untouched);
- the hello, the codec negotiation and a push frame (f32, bf16, f16 and
  int8 leaves) equal byte for byte between the packages, in pickle and in
  the binary codec; a bf16 codec frame from JAX decodes in the port to the
  same f32 values, and the port's to JAX's;
- ``recv_frame_sized`` counts the wire bytes as JAX's does; the codec
  kill-switch and its telemetry.
"""

import os
import socket
import threading
import time

import ml_dtypes
import numpy as np
import pytest

from poseidon_tpu.parallel import async_ssp as JA
from poseidon_tpu.proto import wire as JW
from poseidon_tpu_torch.parallel import async_ssp as TA
from poseidon_tpu_torch.proto import wire as TW

TOKEN = "wire-auth-token"


class _Tap(socket.socket):
    """A socket that records every byte it sends."""

    def __init__(self, sock):
        super().__init__(sock.family, sock.type, sock.proto,
                         fileno=sock.detach())
        self.sent = bytearray()

    def sendall(self, data, *a):
        self.sent += bytes(data)
        return super().sendall(data, *a)

    def sendmsg(self, buffers, *a):
        n = super().sendmsg(buffers, *a)
        left = n
        for b in buffers:
            b = bytes(b)
            self.sent += b[:left]
            left -= min(left, len(b))
            if not left:
                break
        return n


def _handshake(server_mod, client_mod, server_token, client_token):
    """Run one handshake over a socket pair; returns (server result,
    client exception or None, server bytes, client bytes)."""
    a, b = socket.socketpair()
    srv, cli = _Tap(a), _Tap(b)
    result = {}

    def serve():
        result["ok"] = server_mod.server_handshake(srv, server_token)
        srv.close()

    t = threading.Thread(target=serve)
    t.start()
    err = None
    try:
        client_mod.client_handshake(cli, client_token)
    except ConnectionError as e:
        err = e
    finally:
        t.join(timeout=10)
        cli.close()
    return result["ok"], err, bytes(srv.sent), bytes(cli.sent)


@pytest.mark.parametrize("server,client", [(TW, JW), (JW, TW), (TW, TW)])
def test_handshake_across_packages(server, client):
    ok, err, _, _ = _handshake(server, client, TOKEN, TOKEN)
    assert ok is True and err is None


def test_handshake_bytes_equal_jax_for_the_same_nonces(monkeypatch):
    """With os.urandom pinned, the port's challenge, proof and answer are
    JAX's bytes."""
    nonces = iter([b"\x01" * 16, b"\x02" * 16] * 2)
    monkeypatch.setattr(os, "urandom", lambda n: next(nonces))
    _, _, jsrv, jcli = _handshake(JW, JW, TOKEN, TOKEN)
    _, _, tsrv, tcli = _handshake(TW, TW, TOKEN, TOKEN)
    assert tsrv == jsrv and tcli == jcli
    assert tsrv.startswith(TW.AUTH_MAGIC) and len(tcli) == 48


@pytest.mark.parametrize("server,client", [(TW, JW), (JW, TW)])
def test_wrong_token_fails_on_both_sides(server, client):
    ok, err, _, _ = _handshake(server, client, TOKEN, "wrong")
    assert ok is False
    assert isinstance(err, ConnectionError)


@pytest.mark.parametrize("svc_mod,cli_mod", [(TA, JA), (JA, TA)])
def test_wrong_token_parses_no_frame_at_either_service(svc_mod, cli_mod):
    """A client of the other package with the wrong token never gets a
    frame parsed: the service counts an auth failure, no bad frame, no
    clock moved, and the client's rendezvous deadline raises."""
    svc = svc_mod.ParamService({"fc": {"w": np.zeros(3, np.float32)}},
                               n_workers=1, auth_token=TOKEN,
                               liveness_timeout_s=0.0)
    try:
        with pytest.raises((OSError, EOFError, ConnectionError)):
            cli_mod.AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                                   n_workers=1, retry_s=0.5,
                                   auth_token="wrong")
        deadline = time.time() + 5
        while svc.auth_failures == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert svc.auth_failures >= 1
        assert svc.bad_frames == 0 and svc.clocks == {0: -1}
    finally:
        svc.close()


def _frame_bytes(mod, obj, codec):
    a, b = socket.socketpair()
    tap = _Tap(a)
    try:
        n = mod.send_frame(tap, obj, codec=codec)
        got, m = TW.recv_frame_sized(b)
        return bytes(tap.sent), n, m, got
    finally:
        tap.close()
        b.close()


def _push(bf16):
    rs = np.random.RandomState(3)
    f32 = rs.randn(5, 4).astype(np.float32)
    scale = np.float32(0.25)
    return {"kind": "push", "worker": 1, "clock": 2, "seq": 2, "full": True,
            "delta": {"fc": {"w": f32, "b": bf16(rs.randn(7)),
                             "h": rs.randn(3).astype(np.float16),
                             "q": ("q8", scale,
                                   rs.randint(-127, 128, 6).astype(np.int8)),
                             "t": ("topk", np.array([0, 3], np.int32),
                                   bf16(rs.randn(2)))}}}


def _jax_bf16(v):
    return np.asarray(v, np.float32).astype(ml_dtypes.bfloat16)


def _port_bf16(v):
    return TW.bf16_from_f32(np.asarray(v, np.float32))


@pytest.mark.parametrize("obj", [
    {"kind": "hello", "worker": 3},
    {"ok": True, "codec": TW.WIRE_CODEC_VERSION},
    {"kind": "wire", "codec": TW.WIRE_CODEC_VERSION},
    {"kind": "pull"}])
def test_control_frames_equal_jax_byte_for_byte(obj):
    for codec in (False, True):
        jb, jn, _, _ = _frame_bytes(JW, obj, codec)
        tb, tn, tm, got = _frame_bytes(TW, obj, codec)
        assert tb == jb and tn == jn == tm == len(tb)
        assert got == obj


def test_push_frame_with_every_wire_leaf_equals_jax_byte_for_byte():
    """The codec frame of a push holding f32, bf16 (ml_dtypes on the JAX
    side, ``Bf16Array`` here), f16, int8 and sparse leaves: the same bytes,
    and each package decodes the other's to the same f32 values."""
    jb, _, _, _ = _frame_bytes(JW, _push(_jax_bf16), True)
    tb, _, _, got = _frame_bytes(TW, _push(_port_bf16), True)
    assert tb == jb
    # the port decodes the JAX frame: bf16 leaves as Bf16Array bits
    jleaf = got["delta"]["fc"]
    assert isinstance(jleaf["b"], TW.Bf16Array)
    want = _push(_jax_bf16)["delta"]["fc"]
    np.testing.assert_array_equal(TA._dense_f32(jleaf["b"]),
                                  want["b"].astype(np.float32))
    np.testing.assert_array_equal(TA._dense_f32(jleaf["q"]),
                                  JA._dense_f32(want["q"]))
    # JAX decodes the port's frame to ml_dtypes bf16 of the same values
    back = JW.decode_codec_payload(bytearray(tb[8:]))["delta"]["fc"]
    assert back["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["b"].astype(np.float32),
                                  want["b"].astype(np.float32))
    np.testing.assert_array_equal(back["t"][2].astype(np.float32),
                                  want["t"][2].astype(np.float32))


def test_bf16_bits_match_ml_dtypes_rounding():
    """The port's f32 -> bf16 (torch, nearest even) gives ml_dtypes' bits
    on ties, subnormals, infinities and the f32 range's top."""
    rs = np.random.RandomState(0)
    v = np.concatenate([
        rs.randn(4096).astype(np.float32) * 10.0 ** rs.randint(-40, 38,
                                                                4096),
        np.array([0.0, -0.0, np.inf, -np.inf, 3.4e38, -3.4e38, 1e-45,
                  1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8], np.float32)])
    v = v.astype(np.float32)
    got = TW.bf16_from_f32(v).view(np.uint16)
    want = v.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TW.bf16_to_f32(got),
                                  want.view(ml_dtypes.bfloat16)
                                  .astype(np.float32))


def test_codec_kill_switch_and_stats(monkeypatch):
    TW.reset_wire_stats()
    monkeypatch.setenv(TW.WIRE_CODEC_ENV, "off")
    assert not TW.wire_codec_enabled()
    tb, _, _, _ = _frame_bytes(TW, {"x": np.ones(3, np.float32)}, True)
    assert not tb[8:].startswith(TW.CODEC_MAGIC)      # pickled
    monkeypatch.delenv(TW.WIRE_CODEC_ENV)
    TW.set_wire_codec(False)
    try:
        assert not TW.wire_codec_enabled()
    finally:
        TW.set_wire_codec(None)
    assert TW.wire_codec_enabled()
    tb, _, _, _ = _frame_bytes(TW, {"x": np.ones(3, np.float32)}, True)
    assert tb[8:].startswith(TW.CODEC_MAGIC)
    st = TW.wire_stats()
    assert st["pickle_frames_sent"] >= 1 and st["frames_encoded"] >= 1
    assert st["frames_decoded"] >= 1 and st["pickle_frames_recv"] >= 1
