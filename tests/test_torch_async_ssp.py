"""The port's wait-free async-SSP tier (``poseidon_tpu_torch/parallel/
async_ssp.py``): the reference's scenarios of ``tests/test_async_ssp.py``
against the port's service and client (wait-free inside the window, the
SSP bound, every update arriving, read-my-writes, a crashed worker, the
AdaRevision server rule against its float64 replica, the HMAC handshake),
then mixed runs: a JAX client against the port's ``ParamService`` and a
port client against JAX's, with auth on and each wire dtype, the final
anchor BITWISE equal to the all-JAX run on the same deterministic
deltas.
"""

import socket
import threading

import numpy as np
import pytest

from poseidon_tpu_torch.parallel.async_ssp import (ParamService,
                                                   run_async_ssp_worker)


def _zeros_params(shape=(4, 3)):
    return {"fc": {"w": np.zeros(shape, np.float32)}}


def _counting_step(worker):
    """A local_step that just adds worker-tagged ones (inspectable math)."""
    def step(params, it):
        out = {l: {p: v + 1.0 for p, v in ps.items()}
               for l, ps in params.items()}
        return out, 0.0
    return step


def _run_workers(n, staleness, n_clocks, slow_map, service, params,
                 step_fn=_counting_step, **kw):
    results = [None] * n
    errs = []

    def go(w):
        try:
            results[w] = run_async_ssp_worker(
                w, n, params, step_fn(w), n_clocks, staleness,
                service=service, slow_s=slow_map.get(w, 0.0), **kw)
        except Exception as e:  # noqa: BLE001
            errs.append((w, e))

    ts = [threading.Thread(target=go, args=(w,)) for w in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    return results


def test_wait_free_inside_window():
    """Window >= run length: the fast worker must finish all its clocks
    without EVER blocking, while the straggler is still asleep — the exact
    property the compiled reconcile barrier cannot provide."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=2)
    try:
        res = _run_workers(2, staleness=50, n_clocks=12,
                           slow_map={1: 0.05}, service=svc, params=params)
    finally:
        svc.close()
    fast, slow = res
    assert fast["gate_blocks"] == 0
    assert fast["blocked_s"] == 0.0
    # fast finished well before the straggler's sleep budget (12 x 50 ms)
    assert fast["wall_s"] < 0.5 * slow["wall_s"], (fast["wall_s"],
                                                  slow["wall_s"])


def test_ssp_bound_enforced():
    """s = 1: the server must never observe a clock spread beyond s + 1,
    and the fast worker must actually hit the gate (it is 20x faster)."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=2)
    try:
        res = _run_workers(2, staleness=1, n_clocks=10,
                           slow_map={1: 0.04}, service=svc, params=params)
        spread = svc.max_spread
    finally:
        svc.close()
    fast = res[0]
    assert spread <= 2, spread          # s + 1
    assert fast["gate_blocks"] > 0      # the bound did real work


def test_all_updates_arrive():
    """Additive apply: after both workers flush every clock, the anchor
    holds exactly n_workers * n_clocks increments (no lost oplogs)."""
    params = _zeros_params((2, 2))
    svc = ParamService(params, n_workers=2)
    try:
        _run_workers(2, staleness=5, n_clocks=7, slow_map={},
                     service=svc, params=params)
        # each clock each worker pushes +1 over the whole tree
        np.testing.assert_allclose(svc.anchor["fc"]["w"],
                                   np.full((2, 2), 14.0))
    finally:
        svc.close()


def test_read_my_writes_cache():
    """refresh() must rebuild anchor + own pending increments, so a
    worker's own updates are never lost from its view even while the
    server has not applied them (client cache + oplog composition,
    the reference's process storage + oplog pairing)."""
    from poseidon_tpu_torch.parallel.async_ssp import AsyncSSPClient
    params = _zeros_params((2, 2))
    svc = ParamService(params, n_workers=2)
    cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=5)
    try:
        # freeze dispatch: pushes stay in the local oplog, never reach the
        # server — the exact window read-my-writes exists for
        cli._stop.set()
        cli._sender.join(timeout=5)
        one = {"fc": {"w": np.ones((2, 2), np.float32)}}
        cli.push(one)
        cli.push(one)
        cache, clocks = cli.refresh()
        np.testing.assert_allclose(cache["fc"]["w"], 2.0)  # own 2 pending
        assert clocks[0] == -1          # server never applied them
        np.testing.assert_allclose(svc.anchor["fc"]["w"], 0.0)
    finally:
        cli._acked_clock = cli.clock    # close() must not wait on the
        cli.close()                     # deliberately-frozen sender
        svc.close()


def test_worker_crash_does_not_deadlock_survivors():
    """Elasticity beyond the reference's fail-fast (comm_bus.hpp:22-24
    aborts the whole job): a worker that dies abruptly (no bye, no done)
    is detected by the service, excluded from the survivors' gates, and
    its already-applied clocks stay in the anchor. Without detection the
    survivor's s=1 gate would TimeoutError waiting on a dead peer."""
    import time as _time

    from poseidon_tpu_torch.parallel.async_ssp import AsyncSSPClient
    params = _zeros_params((2, 2))
    svc = ParamService(params, n_workers=2)
    one = {"fc": {"w": np.ones((2, 2), np.float32)}}
    try:
        # the doomed worker pushes 2 clocks then crashes (sockets torn
        # down with no bye)
        doomed = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=1,
                                n_workers=2)
        doomed.push(one)
        doomed.push(one)
        doomed._drain()
        doomed._stop.set()
        doomed._sender.join(timeout=5)
        doomed._push_sock.close()
        doomed._pull_sock.close()
        deadline = _time.time() + 10
        while 1 not in svc.failed_workers and _time.time() < deadline:
            _time.sleep(0.02)
        assert 1 in svc.failed_workers

        # the survivor runs 12 clocks at s=1 — far past the dead peer's
        # clock 1 — and must never block on it
        res = run_async_ssp_worker(
            0, 2, params, _counting_step(0), 12, staleness=1, service=svc)
        assert res["final_clock"] == 11
        # anchor = survivor's 12 + dead worker's 2 applied clocks
        np.testing.assert_allclose(svc.anchor["fc"]["w"],
                                   np.full((2, 2), 14.0))
        assert svc.done_workers == {0}
    finally:
        svc.close()



def test_adarevision_matches_reference_formula():
    """server_logic='adarevision' on the ASYNC service must reproduce the
    reference server's rule exactly (adarevision_server_table_logic.cpp:
    52-175) — including the cross-boundary backlog the compiled tier
    cannot express: worker 1 pushes a gradient based on a PULL taken
    before worker 0's second push, so its g_bck covers exactly the
    updates applied since that snapshot. Verified against a float64
    NumPy replica driven through the same (push, pull) interleaving."""
    from poseidon_tpu_torch.parallel.async_ssp import AsyncSSPClient
    eta0 = 0.05
    rs = np.random.RandomState(0)
    params = {"fc": {"w": rs.randn(3, 2).astype(np.float32)}}
    svc = ParamService(params, n_workers=2, server_logic="adarevision",
                       init_step=eta0)
    c0 = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=10,
                        n_workers=2)
    c1 = AsyncSSPClient(1, ("127.0.0.1", svc.port), staleness=10,
                        n_workers=2)
    u = [rs.randn(3, 2).astype(np.float32) for _ in range(4)]

    def push(cli, g):
        cli.push({"fc": {"w": g}})
        cli._drain()

    try:
        c1.refresh()                    # worker 1 bases at G = 0
        push(c0, u[0])                  # applied: u0
        push(c0, u[1])                  # applied: u0+u1
        push(c1, u[2])                  # based at 0 -> g_bck = u0+u1
        c0.refresh()                    # worker 0 re-bases at G = u0+u1+u2
        push(c0, u[3])                  # g_bck = 0 (nothing since its pull)
        got = np.asarray(svc.anchor["fc"]["w"], np.float64)
    finally:
        c0.close()
        c1.close()
        svc.close()

    # float64 replica of the exact server rule
    av = np.asarray(params["fc"]["w"], np.float64)
    z = np.ones_like(av)
    zmax = np.ones_like(av)
    G = np.zeros_like(av)
    base = {0: np.zeros_like(av), 1: np.zeros_like(av)}
    order = [(0, u[0]), (0, u[1]), (1, u[2])]
    for w, ug in order:
        ug = np.asarray(ug, np.float64)
        g_bck = G - base[w]
        eta_old = eta0 / np.sqrt(zmax)
        z = z + ug * (ug + 2.0 * g_bck)
        zmax = np.maximum(zmax, z)
        eta = eta0 / np.sqrt(zmax)
        av = av - eta * ug + (eta_old - eta) * g_bck
        G = G + ug
    base[0] = G.copy()                  # c0.refresh()
    ug = np.asarray(u[3], np.float64)
    g_bck = G - base[0]
    eta_old = eta0 / np.sqrt(zmax)
    z = z + ug * (ug + 2.0 * g_bck)
    zmax = np.maximum(zmax, z)
    eta = eta0 / np.sqrt(zmax)
    av = av - eta * ug + (eta_old - eta) * g_bck
    np.testing.assert_allclose(got, av, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# connection authentication (round 6: pickle frames need a gate)
# --------------------------------------------------------------------------- #

def test_auth_rejects_bad_token_before_any_frame():
    """A connection with the wrong shared secret is closed at the
    handshake: no pickle frame from it is ever parsed (the service's
    frame counters stay untouched), and auth_failures records it."""
    import struct

    params = _zeros_params()
    svc = ParamService(params, n_workers=1, auth_token="s3cret")
    try:
        sk = socket.create_connection(("127.0.0.1", svc.port), timeout=5.0)
        sk.settimeout(5.0)
        # read the challenge, answer garbage of the right length
        from poseidon_tpu_torch.proto.wire import AUTH_MAGIC, AUTH_NONCE_LEN
        head = sk.recv(len(AUTH_MAGIC) + AUTH_NONCE_LEN)
        assert head.startswith(AUTH_MAGIC)
        sk.sendall(b"\x00" * (32 + AUTH_NONCE_LEN))  # bad digest + nonce
        # server must close without ever reading a frame; a subsequent
        # huge "frame" we send goes nowhere
        try:
            sk.sendall(struct.pack("!Q", 1 << 40) + b"boom")
        except OSError:
            pass
        try:
            assert sk.recv(1) == b""  # service closed our connection
        except ConnectionError:
            pass  # RST instead of FIN — equally closed
        sk.close()
        deadline = __import__("time").time() + 5.0
        while svc.auth_failures == 0 and __import__("time").time() < deadline:
            __import__("time").sleep(0.01)
        assert svc.auth_failures == 1
        assert svc.bad_frames == 0       # nothing ever reached the parser
        assert svc.clocks == {0: -1}     # and no state changed
    finally:
        svc.close()


def test_auth_good_token_trains_end_to_end():
    """With matching tokens on both sides the full worker protocol runs
    unchanged (handshake is transparent to the frame layer)."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=2, auth_token="tok123")
    try:
        _run_workers(2, 10, 3, {}, svc, params,
                     client_opts={"auth_token": "tok123"})
        np.testing.assert_allclose(svc.anchor["fc"]["w"], 6.0)
    finally:
        svc.close()


def test_auth_wrong_client_token_fails_rendezvous():
    """A client dialing with the WRONG token never gets a connection: the
    rendezvous deadline surfaces the failure instead of silently feeding
    frames to a service that drops them."""
    from poseidon_tpu_torch.parallel.async_ssp import AsyncSSPClient

    params = _zeros_params()
    svc = ParamService(params, n_workers=1, auth_token="right")
    try:
        with pytest.raises((OSError, EOFError, ConnectionError)):
            AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=0,
                           n_workers=1, retry_s=0.8, auth_token="wrong")
        assert svc.auth_failures >= 1
    finally:
        svc.close()


def test_auth_token_from_launcher_env(monkeypatch):
    """The launcher distributes the secret via POSEIDON_ASYNC_TOKEN; both
    sides pick it up with no explicit plumbing."""
    monkeypatch.setenv("POSEIDON_ASYNC_TOKEN", "envtok")
    params = _zeros_params()
    svc = ParamService(params, n_workers=1)
    assert svc.auth_token == "envtok"
    try:
        _run_workers(1, 5, 2, {}, svc, params)
        np.testing.assert_allclose(svc.anchor["fc"]["w"], 2.0)
    finally:
        svc.close()


def test_default_bind_is_loopback():
    """Unless a host is explicitly passed, the service listens on
    127.0.0.1 only — pickle frames are never reachable from off-host."""
    params = _zeros_params()
    svc = ParamService(params, n_workers=1)
    try:
        assert svc._srv.getsockname()[0] == "127.0.0.1"
    finally:
        svc.close()


def test_auth_client_rejects_spoofed_service():
    """Mutual handshake: a spoofed endpoint that replays the challenge
    magic but cannot prove the token must be rejected by the CLIENT before
    it parses a single frame (pickle loaders on workers are as dangerous
    as on the service)."""
    import threading as _threading

    from poseidon_tpu_torch.proto.wire import (AUTH_DIGEST_LEN, AUTH_MAGIC,
                                               AUTH_NONCE_LEN, AuthError,
                                               client_handshake)

    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def spoof():
        conn, _ = srv.accept()
        conn.sendall(AUTH_MAGIC + b"\x11" * AUTH_NONCE_LEN)
        try:
            conn.recv(AUTH_DIGEST_LEN + AUTH_NONCE_LEN)
            conn.sendall(b"\x00" * AUTH_DIGEST_LEN)  # cannot prove token
        except OSError:
            pass

    t = _threading.Thread(target=spoof, daemon=True)
    t.start()
    sk = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    try:
        with pytest.raises(AuthError, match="prove"):
            client_handshake(sk, "the-real-token")
    finally:
        sk.close()
        srv.close()
        t.join(timeout=5)


# --------------------------------------------------------------------------- #
# mixed runs: either package's client against either package's service
# --------------------------------------------------------------------------- #

from poseidon_tpu.parallel import async_ssp as JA  # noqa: E402
from poseidon_tpu_torch.parallel import async_ssp as TA  # noqa: E402

MIX_TOKEN = "mixed-run-token"
MIX_CLOCKS = 4
# (service, worker 0's client, worker 1's client); the all-JAX run is the
# reference every other run is held to, bitwise
MIXES = {"jax_clients_port_service": (TA, JA, JA),
         "port_clients_jax_service": (JA, TA, TA),
         "one_of_each_on_port_service": (TA, JA, TA),
         "port_clients_port_service": (TA, TA, TA)}


def _mix_tree(rs, scale=1.0):
    return {"conv1": {"w": (scale * rs.randn(4, 3, 3, 3)).astype(np.float32),
                      "b": (scale * rs.randn(4)).astype(np.float32)},
            "fc": {"w": (scale * rs.randn(7, 36)).astype(np.float32)}}


def _mix_run(mods, wire, server_logic):
    """Two workers push seeded deltas (raw gradients under adarevision) in
    a fixed order, each push drained before the next, with a refresh at
    clock 1 (it re-bases adarevision's backlog); returns the final anchor
    (after both workers' done) and each worker's last cache."""
    svc_mod, c0_mod, c1_mod = mods
    rs = np.random.RandomState(11)
    params = _mix_tree(rs)
    deltas = [[_mix_tree(rs, 0.01) for _ in range(MIX_CLOCKS)]
              for _ in range(2)]
    svc = svc_mod.ParamService(params, n_workers=2, auth_token=MIX_TOKEN,
                               server_logic=server_logic, init_step=0.05,
                               liveness_timeout_s=0.0)
    clients = []
    try:
        for w, mod in enumerate((c0_mod, c1_mod)):
            clients.append(mod.AsyncSSPClient(
                w, ("127.0.0.1", svc.port), staleness=10, n_workers=2,
                auth_token=MIX_TOKEN, wire_dtype=wire,
                server_logic=server_logic, init_step=0.05))
        caches = [None, None]
        for c in range(MIX_CLOCKS):
            for w, cli in enumerate(clients):
                cli.push(deltas[w][c])
                cli._drain()
            if c == 1:
                for w, cli in enumerate(clients):
                    caches[w] = cli.refresh()[0]
        for w, cli in enumerate(clients):
            caches[w] = cli.refresh()[0]
            cli.mark_done()
        with svc._lock:
            anchor = {l: {p: np.array(v) for p, v in ps.items()}
                      for l, ps in svc.anchor.items()}
        assert svc.auth_failures == 0 and svc.bad_frames == 0
        return anchor, caches
    finally:
        for cli in clients:
            cli.close()
        svc.close()


def _tree_bitwise(a, b, what):
    assert sorted(a) == sorted(b), what
    for l in a:
        assert sorted(a[l]) == sorted(b[l]), what
        for p in a[l]:
            x, y = np.asarray(a[l][p]), np.asarray(b[l][p])
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                f"{what} {l}/{p}: max_abs {np.abs(x - y).max()}"


@pytest.mark.parametrize("logic,wire", [("inc", ""), ("inc", "bf16"),
                                        ("inc", "f16"), ("inc", "int8"),
                                        ("adarevision", "")])
def test_mixed_clients_and_services_match_the_all_jax_run(logic, wire):
    """Every mix of the two packages' clients and services, with the HMAC
    handshake on and the binary codec negotiated, ends on the anchor (and
    the caches) of the all-JAX run bit for bit: the wire, the server
    rules and the error-feedback quantization are the same functions."""
    want_anchor, want_caches = _mix_run((JA, JA, JA), wire, logic)
    for name, mods in MIXES.items():
        anchor, caches = _mix_run(mods, wire, logic)
        _tree_bitwise(anchor, want_anchor, f"{name} anchor")
        for w in range(2):
            _tree_bitwise(caches[w], want_caches[w], f"{name} cache {w}")

