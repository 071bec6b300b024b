"""The port's managed communication (SSPAggr) on the async-SSP tier: the
reference's scenarios of ``tests/test_managed_comm.py`` against the port's
service and client (the token bucket, ``split_topk``'s exact complement,
boundary states bitwise equal to the dense path, durable-clock gates,
residual flushes, exactly-once partial replay, adaptive cadence, the
counters, a throttled three-worker chaos run), then ``split_topk`` and
``_quantize_leaf`` (f16, bf16, int8) BITWISE against JAX's, the tier's
config resolution, and a managed JAX client against the port's service
(and the other way round) ending on the all-JAX anchor.
"""

import threading
import time

import numpy as np
import pytest

from poseidon_tpu_torch.parallel.async_ssp import (AsyncSSPClient,
                                                   ParamService, TokenBucket,
                                                   run_async_ssp_worker,
                                                   split_topk)
from poseidon_tpu_torch.runtime.faults import FaultProxy, FaultRule

FAST = dict(heartbeat_s=0.1, reconnect_deadline_s=5.0,
            backoff_base_s=0.01, backoff_cap_s=0.1)


def _zeros(shape=(4, 4)):
    return {"fc": {"w": np.zeros(shape, np.float32)}}


def _pow2_delta(worker: int, clock: int, shape=(4, 4)):
    """Deterministic all-power-of-two deltas with DISTINCT magnitudes per
    element (selection is nontrivial) whose running sums are exact in
    float32 — bitwise comparisons then hold under ANY apply order."""
    n = int(np.prod(shape))
    exps = -(np.arange(n) % 6) - clock - 8 * worker
    return {"fc": {"w": (2.0 ** exps).astype(np.float32).reshape(shape)}}


def _drained_client(svc, worker=0, staleness=3, frac=0.25, **kw):
    """Managed client whose bucket is in deep deficit: every non-forced
    push is partial — the deterministic 'budget tight' regime."""
    cli = AsyncSSPClient(worker, ("127.0.0.1", svc.port),
                         staleness=staleness, n_workers=svc.n_workers,
                         budget_mbps=1e-6, priority_frac=frac, **kw)
    cli.budget.consume(1e12)
    return cli


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #

def test_token_bucket_refill_consume_and_cap():
    clk = [0.0]
    b = TokenBucket(rate_bps=100.0, burst_bytes=250.0, clock=lambda: clk[0])
    assert b.available() == 250.0           # starts full
    b.consume(400.0)                        # overdraft is allowed...
    assert b.available() == -150.0          # ...and visible to the policy
    clk[0] = 1.0
    assert b.available() == -50.0           # refills at rate
    clk[0] = 10.0
    assert b.available() == 250.0           # capped at burst
    # default burst floor: tiny configured rates never starve control frames
    assert TokenBucket(rate_bps=1.0).available() >= 65536.0


def test_split_topk_exact_complement_and_budget():
    rs = np.random.RandomState(7)
    tree = {"a": {"w": rs.randn(9, 5).astype(np.float32),
                  "b": rs.randn(7).astype(np.float32)},
            "c": {"w": rs.randn(3, 3).astype(np.float32)}}
    sent, residual, k, n = split_topk(tree, 0.2)
    assert n == 9 * 5 + 7 + 9
    assert k == max(1, int(round(n * 0.2)))
    total_sent = 0
    threshold_sent = np.inf
    threshold_kept = 0.0
    for l, ps in tree.items():
        for p, v in ps.items():
            tag, idx, vals = sent[l][p]
            assert tag == "topk"
            total_sent += idx.size
            dense = np.zeros_like(v)
            dense.flat[idx] += vals
            # THE invariant: sent + residual reassembles the input BITWISE
            assert np.array_equal(dense + residual[l][p], v)
            # selected coordinates leave a zero residual
            assert not np.any(residual[l][p].flat[idx])
            if vals.size:
                threshold_sent = min(threshold_sent, np.abs(vals).min())
            kept = np.abs(residual[l][p])
            if kept.size:
                threshold_kept = max(threshold_kept, kept.max())
    assert total_sent == k
    # magnitude priority is GLOBAL across the tree: nothing kept back
    # outranks anything sent
    assert threshold_kept <= threshold_sent


def test_split_topk_full_fraction_is_dense_copy():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    sent, residual, k, n = split_topk(tree, 1.0)
    assert k == n == 6
    assert np.array_equal(sent["a"]["w"], tree["a"]["w"])
    assert not np.any(residual["a"]["w"])


# --------------------------------------------------------------------------- #
# the acceptance property: bitwise parity at every staleness boundary
# --------------------------------------------------------------------------- #

def test_single_worker_cache_bitwise_equal_to_dense_every_clock():
    """Read-my-writes covers deferred bytes: with one worker, the managed
    cache (anchor + pending + residual) must equal the dense arm's cache
    BITWISE at EVERY clock, not just boundaries — a worker's own view
    never loses what its partial pushes parked."""
    n_clocks, staleness = 8, 3
    dense_svc = ParamService(_zeros(), n_workers=1)
    man_svc = ParamService(_zeros(), n_workers=1)
    dense = AsyncSSPClient(0, ("127.0.0.1", dense_svc.port),
                           staleness=staleness, n_workers=1)
    man = _drained_client(man_svc, staleness=staleness)
    try:
        for c in range(n_clocks):
            d = _pow2_delta(0, c)
            dense.push(d)
            man.push(d)
            dense._drain()
            man._drain()
            cache_d, _ = dense.refresh()
            cache_m, _ = man.refresh()
            assert np.array_equal(cache_d["fc"]["w"], cache_m["fc"]["w"]), c
        assert man.partial_pushes > 0      # deferral actually happened
    finally:
        man.close()
        dense.close()
        man_svc.close()
        dense_svc.close()


def test_boundary_states_bitwise_equal_to_dense_two_workers():
    """THE acceptance test: two workers, managed (finite budget,
    priority_frac < 1) vs dense — at every SSP window boundary the anchor
    AND every worker's applied state at the gate are bitwise identical;
    between boundaries the managed anchor provably lags (deferral is
    real), and the durable clock vector exposes exactly that."""
    n_clocks, staleness = 8, 1          # boundaries at clocks 1, 3, 5, 7
    dense_svc = ParamService(_zeros(), n_workers=2)
    man_svc = ParamService(_zeros(), n_workers=2)
    dense = [AsyncSSPClient(w, ("127.0.0.1", dense_svc.port),
                            staleness=staleness, n_workers=2)
             for w in range(2)]
    man = [_drained_client(man_svc, worker=w, staleness=staleness)
           for w in range(2)]
    deferred_seen = 0
    try:
        for c in range(n_clocks):
            for w in range(2):
                d = _pow2_delta(w, c)
                dense[w].push(d)
                man[w].push(d)
            for w in range(2):
                dense[w]._drain()
                man[w]._drain()
            boundary = (c + 1) % (staleness + 1) == 0
            if boundary:
                # full flush landed: bitwise identical anchors...
                assert np.array_equal(dense_svc.anchor["fc"]["w"],
                                      man_svc.anchor["fc"]["w"]), c
                # ...and durable caught up to the raw clock
                assert man_svc.durable == {0: c, 1: c}
                for w in range(2):
                    # the applied state each worker computes on at its
                    # next gate: refresh()'s read-my-writes cache
                    cache_d, _ = dense[w].refresh()
                    cache_m, _ = man[w].refresh()
                    assert np.array_equal(cache_d["fc"]["w"],
                                          cache_m["fc"]["w"]), (c, w)
                    # the SSP gate itself stays live in both arms
                    assert dense[w].gate(c + 1, timeout_s=10.0) is not None
                    assert man[w].gate(c + 1, timeout_s=10.0) is not None
            else:
                # partial pushes really deferred bytes: the managed anchor
                # lags the dense one mid-window, and durable < raw clock
                if not np.array_equal(dense_svc.anchor["fc"]["w"],
                                      man_svc.anchor["fc"]["w"]):
                    deferred_seen += 1
                assert man_svc.durable[0] < man_svc.clocks[0]
        assert deferred_seen > 0
        assert all(m.partial_pushes > 0 for m in man)
    finally:
        for cli in man + dense:
            cli.close()
        man_svc.close()
        dense_svc.close()


def test_infinite_budget_reduces_exactly_to_dense():
    """budget=None (the default) AND a budget the bucket never exhausts
    must both take the dense path on every push: full flushes only,
    durable == raw clocks, anchors bitwise equal across all three arms
    at EVERY clock."""
    arms = {}
    for name, kw in (("none", {}),
                     ("huge", dict(budget_mbps=1e9, priority_frac=0.1))):
        svc = ParamService(_zeros(), n_workers=1)
        cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=3,
                             n_workers=1, **kw)
        arms[name] = (svc, cli)
    try:
        anchors = {}
        for name, (svc, cli) in arms.items():
            for c in range(5):
                cli.push(_pow2_delta(0, c))
            cli._drain()
            assert cli.partial_pushes == 0
            assert cli.full_pushes == 5
            assert cli.comm_counters()["deferred_fraction"] == 0.0
            assert svc.durable == svc.clocks
            anchors[name] = np.array(svc.anchor["fc"]["w"])
        assert np.array_equal(anchors["none"], anchors["huge"])
    finally:
        for svc, cli in arms.values():
            cli.close()
            svc.close()


# --------------------------------------------------------------------------- #
# durable-clock gating: the staleness bound under partial pushes
# --------------------------------------------------------------------------- #

def test_gate_blocks_on_durable_not_raw_clock():
    """A peer whose raw clock ran ahead on PARTIAL pushes must not admit
    a reader: the gate waits for the durable (fully-flushed) clock, and
    unblocks the moment the boundary full flush lands — the exact point
    the anchor actually holds what the SSP contract promises."""
    staleness = 1                        # boundaries at odd clocks
    svc = ParamService(_zeros(), n_workers=2)
    a = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=staleness,
                       n_workers=2)
    b = _drained_client(svc, worker=1, staleness=staleness)
    try:
        b.push(_pow2_delta(1, 0))        # clock 0: partial (non-boundary)
        b._drain()
        assert svc.clocks[1] == 0 and svc.durable[1] == -1
        a.push(_pow2_delta(0, 0))
        a.push(_pow2_delta(0, 1))
        a._drain()
        # reader at clock 2 needs peer durable >= 0; raw clock 0 is NOT
        # enough — the gate must block on the un-flushed residual
        with pytest.raises(TimeoutError):
            a.gate(2, timeout_s=0.6)
        b.push(_pow2_delta(1, 1))        # clock 1: boundary -> full flush
        b._drain()
        assert svc.durable[1] == 1
        a.gate(2, timeout_s=10.0)        # unblocks
    finally:
        b.close()
        a.close()
        svc.close()


def test_residual_flushes_on_mark_done_and_leave():
    """A completed (or deliberately retiring) worker's anchor contribution
    must be its WHOLE update stream — the parked residual flushes before
    'done'/'retire', so bounded loss stays a FAILURE property only."""
    for finisher in ("mark_done", "leave"):
        svc = ParamService(_zeros(), n_workers=1)
        cli = _drained_client(svc, staleness=7)   # boundary far away
        try:
            total = np.zeros((4, 4), np.float32)
            for c in range(3):                    # all partial
                d = _pow2_delta(0, c)
                total += d["fc"]["w"]
                cli.push(d)
            cli._drain()
            assert not np.array_equal(svc.anchor["fc"]["w"], total)
            getattr(cli, finisher)()
            assert np.array_equal(svc.anchor["fc"]["w"], total), finisher
            assert svc.durable[0] == cli.clock
        finally:
            cli.close()
            svc.close()


def test_partial_push_replay_is_exactly_once():
    """Reconnect replay with sparse payloads: the pending oplog holds the
    payload AS SENT, so a severed link replays byte-identical partial
    pushes and the seq dedup keeps the apply exactly-once — the final
    flushed anchor matches the unfaulted dense sum exactly."""
    svc = ParamService(_zeros(), n_workers=1, liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    cli = AsyncSSPClient(0, proxy.addr, staleness=7, n_workers=1,
                         budget_mbps=1e-6, priority_frac=0.25, **FAST)
    cli.budget.consume(1e12)
    try:
        total = np.zeros((4, 4), np.float32)
        d = _pow2_delta(0, 0)
        total += d["fc"]["w"]
        cli.push(d)                       # partial, lands
        cli._drain()
        proxy.sever_all()                 # cut both channels mid-run
        d = _pow2_delta(0, 1)
        total += d["fc"]["w"]
        cli.push(d)                       # partial, rides the replay
        cli._drain(timeout_s=10.0)
        assert cli.reconnects >= 1
        cli.mark_done()                   # residual flush -> exact total
        assert np.array_equal(svc.anchor["fc"]["w"], total)
    finally:
        cli.close()
        proxy.close()
        svc.close()


# --------------------------------------------------------------------------- #
# adaptive cadence
# --------------------------------------------------------------------------- #

def test_adaptive_cadence_backs_off_and_recovers():
    """Congestion (bucket deficit) escalates the payload backoff —
    intermediate clocks ship as empty ticks, counted in cadence_backoffs —
    and a recovered link decays it back toward 1."""
    clk = [0.0]
    svc = ParamService(_zeros(), n_workers=1)
    cli = AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=15,
                         n_workers=1, budget_mbps=0.001, priority_frac=0.5,
                         adaptive=True, bucket_clock=lambda: clk[0])
    try:
        cli.budget.consume(1e9)           # deep deficit: congested
        for c in range(3):
            cli.push(_pow2_delta(0, c))
            cli._drain()
        assert cli.cadence_backoffs >= 1
        backed_off = cli.cadence_factor
        assert backed_off > 1
        # deferred ticks: later pushes park the payload locally
        assert cli.partial_pushes >= 1
        clk[0] = 1e13                     # link recovers: bucket refills
        assert cli.budget.available() > 0
        for c in range(8):
            cli.push(_pow2_delta(0, 3 + c))
            cli._drain()
        assert cli.cadence_factor < backed_off
        cli.mark_done()                   # residual still lands in full
        assert svc.durable[0] == cli.clock
    finally:
        cli.close()
        svc.close()


# --------------------------------------------------------------------------- #
# telemetry plumbing
# --------------------------------------------------------------------------- #

def test_comm_counters_shape_and_formatting():
    from poseidon_tpu_torch.runtime.comm_stats import (format_comm,
                                                       managed_comm_counters)
    svc = ParamService(_zeros(), n_workers=1)
    cli = _drained_client(svc, staleness=3)
    try:
        for c in range(4):                # 3 partial + 1 boundary full
            cli.push(_pow2_delta(0, c))
        cli._drain()
        cc = managed_comm_counters(cli)
        for key in ("bytes_sent", "bytes_recv", "deferred_fraction",
                    "effective_mbps", "cadence_backoffs",
                    "partial_pushes", "full_pushes"):
            assert key in cc, key
        assert cc["bytes_sent"] > 0 and cc["bytes_recv"] > 0
        assert 0.0 < cc["deferred_fraction"] < 1.0
        assert cc["partial_pushes"] == 3 and cc["full_pushes"] == 1
        line = format_comm(cc)
        assert "deferred_fraction" in line and "bytes_sent" in line
        # no client (sync tiers): empty, and the display line degrades
        assert managed_comm_counters(None) == {}
    finally:
        cli.close()
        svc.close()


def test_managed_comm_config_defaults_resolve_into_tier(monkeypatch):
    """``config.set_managed_comm_config`` is what None-valued tier knobs
    resolve against, and explicit tier knobs win over it."""
    from poseidon_tpu_torch import config
    from poseidon_tpu_torch.runtime.async_tier import AsyncSSPTier
    from test_torch_faults import _free_port, _tier_env, _tier_step

    _tier_env(monkeypatch, 0, 1)
    defaults = config.ManagedCommConfig()
    config.set_managed_comm_config(budget_mbps=5.0, priority_frac=0.2,
                                   adaptive=True)
    try:
        tier = AsyncSSPTier(_tier_step(_zeros()), staleness=2,
                            service_port=_free_port())
        try:
            assert tier.comm_budget_mbps == 5.0
            assert tier.client.budget is not None
            assert tier.client.priority_frac == 0.2
            assert tier.client.adaptive is True
        finally:
            tier.client._stop.set()
            tier.service.close()
        tier2 = AsyncSSPTier(_tier_step(_zeros()), staleness=2,
                             service_port=_free_port(),
                             comm_budget_mbps=0.0)   # explicit: unlimited
        try:
            assert tier2.client.budget is None
        finally:
            tier2.client._stop.set()
            tier2.service.close()
        with pytest.raises(AttributeError):
            config.set_managed_comm_config(no_such_knob=1.0)
    finally:
        config.set_managed_comm_config(
            budget_mbps=defaults.budget_mbps,
            priority_frac=defaults.priority_frac,
            adaptive=defaults.adaptive)


def test_full_fraction_partial_is_labeled_full():
    """priority_frac=1.0 (or a tree tiny enough that the 1-entry floor
    selects everything) ships the whole update — that IS a full flush and
    must be labeled one: durable advances every clock, no all-zero
    residual is carried, no phantom 'partial' telemetry."""
    svc = ParamService(_zeros(), n_workers=1)
    cli = _drained_client(svc, staleness=7, frac=1.0)
    try:
        for c in range(3):                # all non-boundary clocks
            cli.push(_pow2_delta(0, c))
        cli._drain()
        assert cli.partial_pushes == 0
        assert cli.full_pushes == 3
        assert not cli._has_residual()
        assert svc.durable[0] == 2        # durable tracks every clock
    finally:
        cli.close()
        svc.close()


def test_adarevision_refuses_managed_budget():
    svc = ParamService(_zeros(), n_workers=1, server_logic="adarevision")
    try:
        with pytest.raises(ValueError, match="adarevision"):
            AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=1,
                           n_workers=1, server_logic="adarevision",
                           budget_mbps=1.0)
    finally:
        svc.close()


# --------------------------------------------------------------------------- #
# the chaos acceptance: throttled 3-worker run with sever/rejoin
# --------------------------------------------------------------------------- #

def test_throttled_three_worker_chaos_keeps_gates_live():
    """The robustness acceptance: 3 managed workers through a FaultProxy
    shaping every connection to a slow link (throttle), with a full
    mid-run partition (sever_all) forcing reconnect + replay. The run
    must complete — no gate deadlock — with loss continuity (every
    worker reports every clock) and the final anchor holding EXACTLY the
    full update mass (integer-valued deltas: bitwise-checkable)."""
    n_workers, n_clocks, staleness = 3, 5, 2
    # 128x128 f32 = 64 kB dense — bigger than the client bucket's burst
    # floor, so the first dense flush drives the budget into deficit and
    # every non-boundary flush after it is a cheap partial push
    params = {"fc": {"w": np.zeros((128, 128), np.float32)}}
    svc = ParamService(params, n_workers=n_workers,
                       liveness_timeout_s=5.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    # every connection rides a ~80 kB/s link: dense flushes crawl (~0.8 s
    # each), partial pushes stay cheap (~0.1 s)
    proxy.add_rule(FaultRule(action="throttle", rate_bps=80_000,
                             burst_bytes=16_384))

    def step(worker):
        def fn(p, it):
            out = {l: {pn: v + 1.0 for pn, v in ps.items()}
                   for l, ps in p.items()}
            return out, float(out["fc"]["w"].mean())
        return fn

    results = [None] * n_workers
    errs = []

    def go(w):
        try:
            results[w] = run_async_ssp_worker(
                w, n_workers, params, step(w), n_clocks, staleness,
                service_addr=proxy.addr, sync_every=1,
                client_opts=dict(budget_mbps=0.64, priority_frac=0.1,
                                 **FAST))
        except Exception as e:  # noqa: BLE001
            errs.append((w, e))

    ts = [threading.Thread(target=go, args=(w,)) for w in range(n_workers)]
    try:
        for t in ts:
            t.start()
        time.sleep(1.0)                   # mid-run: hard partition
        cut = proxy.sever_all()
        assert cut > 0, "sever fired after the run ended (retune timings)"
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts), "gate deadlock"
        assert not errs, errs
        # loss continuity: every worker reports EVERY clock's loss
        for w, res in enumerate(results):
            assert len(res["losses"]) == n_clocks, (w, res["losses"])
            assert res["final_clock"] >= n_clocks - 1
        # the partition was real: somebody reconnected and replayed
        assert sum(r["reconnects"] for r in results) >= 1
        # partial pushes actually happened (budget in deficit after the
        # first dense flush), yet exactness held: +1-everywhere deltas
        # are integers — the anchor must hold the complete update mass,
        # partials + residual flushes + replays notwithstanding
        assert np.array_equal(
            svc.anchor["fc"]["w"],
            np.full((128, 128), float(n_workers * n_clocks), np.float32))
        # the SSP bound held through the chaos
        assert svc.max_spread <= staleness + 1
    finally:
        proxy.close()
        svc.close()


# --------------------------------------------------------------------------- #
# against the JAX package: split_topk, the wire quantizer, a managed run
# --------------------------------------------------------------------------- #

from poseidon_tpu.parallel import async_ssp as JA  # noqa: E402
from poseidon_tpu_torch.parallel import async_ssp as TA  # noqa: E402


def _random_tree(seed):
    rs = np.random.RandomState(seed)
    return {"conv": {"w": rs.randn(6, 3, 3, 3).astype(np.float32),
                     "b": rs.randn(6).astype(np.float32)},
            "fc": {"w": (rs.randn(10, 20) * 1e-3).astype(np.float32)}}


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_split_topk_bitwise_to_jax(frac):
    tree = _random_tree(1)
    tree["fc"]["w"][0, :4] = 0.5          # ties at the selection's edge
    js, jr, jk, jn = JA.split_topk(tree, frac)
    ts, tr, tk, tn = TA.split_topk(tree, frac)
    assert (tk, tn) == (jk, jn)
    for l in tree:
        for p in tree[l]:
            a, b = ts[l][p], js[l][p]
            if isinstance(b, tuple):
                assert a[0] == b[0] == "topk"
                assert a[1].dtype == b[1].dtype
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[2], b[2])
            else:
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tr[l][p], jr[l][p])


@pytest.mark.parametrize("wire", ["f16", "bf16", "int8"])
def test_quantize_leaf_bitwise_to_jax(wire):
    """The wire leaf (bf16 as its bits), the residual and the byte count
    equal JAX's, with the exact contract dequant + residual == v, on
    normal values, f16's overflow range, zeros and a non-finite entry."""
    rs = np.random.RandomState(2)
    cases = [rs.randn(257).astype(np.float32),
             (rs.randn(64) * 1e5).astype(np.float32),
             np.zeros(9, np.float32),
             np.array([1.0, np.inf, -2.5], np.float32)]
    for v in cases:
        jq, jres, jn = JA._quantize_leaf(v, wire)
        tq, tres, tn = TA._quantize_leaf(v, wire)
        assert tn == jn
        np.testing.assert_array_equal(tres, jres)
        jd, td = JA._dense_f32(jq), TA._dense_f32(tq)
        np.testing.assert_array_equal(td, jd)
        if wire == "bf16" and not isinstance(jq, tuple) \
                and jq.dtype != np.float32:
            np.testing.assert_array_equal(np.asarray(tq).view(np.uint16),
                                          jq.view(np.uint16))
        finite = np.isfinite(v)
        np.testing.assert_array_equal((td + tres)[finite], v[finite])


def _managed_run(svc_mod, cli_mod, wire):
    """One managed worker in deep deficit (every non-boundary push
    partial) over 6 clocks, then done; the service's final anchor."""
    params = _random_tree(3)
    svc = svc_mod.ParamService(params, n_workers=1, liveness_timeout_s=0.0)
    cli = cli_mod.AsyncSSPClient(0, ("127.0.0.1", svc.port), staleness=2,
                                 n_workers=1, budget_mbps=1e-6,
                                 priority_frac=0.2, wire_dtype=wire)
    cli.budget.consume(1e12)
    try:
        for c in range(6):
            cli.push(_random_tree(10 + c))
        cli.mark_done()
        assert cli.partial_pushes > 0
        with svc._lock:
            return {l: {p: np.array(v) for p, v in ps.items()}
                    for l, ps in svc.anchor.items()}
    finally:
        cli.close()
        svc.close()


@pytest.mark.parametrize("wire", ["", "bf16", "int8"])
def test_managed_pushes_across_packages_match_the_all_jax_anchor(wire):
    """Partial pushes (sparse index + value leaves, compressed by the
    wire dtype, the residual force-flushed at boundaries and at done)
    from either package's client to either package's service end on the
    all-JAX anchor bit for bit."""
    want = _managed_run(JA, JA, wire)
    for svc_mod, cli_mod in ((TA, JA), (JA, TA), (TA, TA)):
        got = _managed_run(svc_mod, cli_mod, wire)
        for l in want:
            for p in want[l]:
                np.testing.assert_array_equal(got[l][p], want[l][p])

