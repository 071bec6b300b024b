"""Wait-free asynchronous SSP for the multi-process tier (the port's copy
of ``poseidon_tpu/parallel/async_ssp.py``: the same protocol, wire and
server rules, numpy host trees; it interoperates with the JAX package's
service and client byte for byte).

The one capability the compiled SSP step does not provide is the reference's
actual Bösen execution model: workers that never barrier inside the staleness
window. In the reference, a worker at clock c proceeds as long as its cached
table rows reflect every worker's updates through clock c - s - 1; updates
stream to the server asynchronously, and a too-fresh read BLOCKS just that
worker until the server's clock catches up
(ps/src/petuum_ps/consistency/ssp_consistency_controller.cpp:37-77; the
server buffers early row requests until the required clock arrives,
ps/src/petuum_ps/server/server.cpp:81-118).

The compiled ``build_ssp_train_step`` reconciles on a barrier every (s+1)
steps: a fast process waits for the slowest. This module restores the
wait-free semantics across processes: each process keeps its own local
step on its own device, and the only cross-process exchange is this
host-side parameter service.

Design (the Bösen pieces, re-homed):

- ``ParamService`` (rank 0, the name-node role): holds the anchor parameter
  pytree and a per-worker vector clock. PUSH applies a worker's update
  increment (additive, like the server's oplog apply) and bumps that
  worker's clock; PULL returns the anchor snapshot + clock vector. No
  global barrier exists anywhere in the service.
- ``AsyncSSPClient`` (every worker): a background sender thread streams
  PUSHes from a queue (non-blocking dispatch — the training thread never
  waits on the socket), and ``gate(clock, staleness)`` blocks ONLY when the
  pulled clock vector says some worker is more than ``staleness`` clocks
  behind — the exact SSPConsistencyController read gate.
- Read-my-writes: the client's cached params are
  ``anchor + (own increments the anchor has not yet applied)``, the client
  cache + oplog composition of the reference's process storage.

A "clock" is one flush (``sync_every`` optimizer steps), matching the
reference's per-iteration oplog flush granularity.

Fault tolerance (beyond the reference's fail-fast, comm_bus.hpp:22-24 —
any connection error there aborts the whole job; preemptible workers come
and go, so this tier survives them instead):

- liveness: clients heartbeat on the push channel whenever the flush queue
  is idle; the service EVICTS a worker silent past
  ``liveness_timeout_s`` (and, faster, on an abrupt disconnect of its last
  connection). Evicted workers leave the survivors' read gates — ``gate()``
  on survivors unblocks instead of hanging on a dead peer's clock forever.
  The evicted worker's already-applied clocks stay in the anchor; the
  bounded update loss is exactly its un-flushed oplog (the PS failure
  model).
- reconnect: a client whose channel dies redials with capped exponential
  backoff + full jitter (``runtime/retry.py``) and REPLAYS every un-acked
  flush. Every PUSH carries a per-worker sequence number and the service
  keeps the high-water mark, so a replayed flush whose ack was lost is
  applied exactly once. Any service-side activity from an evicted worker
  un-evicts it (rejoin).
- rejoin: a restarted worker process calls :meth:`AsyncSSPClient.rejoin` —
  pull the anchor, re-seed the local cache from it, resume at the anchor's
  recorded clock for this worker.

Elastic membership (the other half of elasticity — the reference's worker
set is fixed for the life of a job, docs/distributed-guide.md; preemptible
capacity grows and shrinks, so this tier's member set does too):

- admit: a worker id OUTSIDE the original ``n_workers`` joins a live job
  via the ``admit`` RPC (:meth:`AsyncSSPClient.join`). The SERVICE picks
  the join clock — the rendezvous anchor clock, the minimum applied clock
  over live members (the clock every survivor's gate has already seen) —
  and replies with the anchor params + clock table + member list. The
  joiner seeds its cache from the anchor and pushes its first flush at
  ``join_clock + 1``; its exactly-once seq high-water mark is initialized
  at the join clock, so the PUSH dedup extends to the new id with no
  special cases. ``admit`` of an id that is already a member is idempotent
  (it degenerates to the rejoin pull), so one code path serves fresh
  workers, restarts, and true admissions alike.
- shrink: a deliberate departure (``retire`` RPC, :meth:`AsyncSSPClient.
  leave`) RETIRES the slot — it leaves the member set entirely, so
  survivors' gates never wait on it again (eviction merely excludes a
  failed id; retirement removes it, and only a new ``admit`` brings it
  back). The retired worker's applied clocks stay in the anchor.
- every clock-bearing reply (push ack, heartbeat, clocks, pull, admit)
  carries the CURRENT member list; clients gate over that list, never
  over a static ``range(n_workers)`` — the SSP bound follows the fleet.
- permanent failure surfaces: when the reconnect deadline is exhausted the
  sender thread records the error and every subsequent ``push``/``gate``/
  ``refresh`` raises it into the training loop — a run never silently
  drops oplogs behind a dead thread.

Managed communication (SSPAggr/SSPPush — the paper's third signature
mechanism, re-homed onto this tier's wire):

- per-link bandwidth budget: a token bucket (``TokenBucket``) refilled at
  ``budget_mbps`` and charged with the ACTUAL frame bytes of every RPC on
  BOTH channels (push and pull) — the ``client_bandwidth_mbps`` /
  TransTimeEstimate accounting, measured instead of modeled.
- magnitude-prioritized PARTIAL pushes: when the bucket cannot cover a
  dense flush, the client sends only the top ``priority_frac`` of the
  delta by |value| (the server's RelativeMagnitude UpdateSortPolicy),
  encoded as the TOPK index+value wire form (``("topk", idx, vals)``
  leaves — the same logical bytes ``runtime/comm_stats.py`` meters for
  the compiled TOPK tier), and accumulates the EXACT complement locally
  (``residual``: sent + residual == delta + carried-residual, elementwise
  bitwise — nothing lost, only delayed).
- bounded staleness preserved EXACTLY: every ``staleness + 1`` clocks
  (the SSP window boundary) the flush is forced FULL — delta plus the
  whole residual — and the service tracks a per-worker DURABLE clock
  (last fully-flushed clock) next to the raw clock. Read gates run over
  the durable vector: a reader at clock r proceeds only when every peer's
  durable clock >= r - s - 1, i.e. when everything the SSP contract
  promises it is actually IN the anchor. Dense pushes are always full
  (durable == clock), so the dense path's gate behavior is unchanged;
  partial pushes trade gate wait (bounded by one window) for wire bytes —
  graceful degradation, never a widened bound.
- adaptive cadence: the sender measures per-RPC goodput and queue depth;
  under congestion (bucket in deficit, or flushes piling up behind a slow
  link) it backs off the PAYLOAD cadence — intermediate clocks ship as
  empty partial ticks (~100 B, preserving "a clock == sync_every
  iterations" and liveness) and the accumulated delta rides the next
  boundary/recovered flush. Recovery halves the backoff as the link
  drains. ``cadence_backoffs`` counts escalations.

Wire format: length-prefixed pickles of numpy pytrees over TCP on the
launcher's control network. A malformed or truncated frame never kills
the service: the offending connection is logged and dropped
(:class:`FrameError`), everyone else keeps training.

Security: the payloads are PICKLES — arbitrary code execution for anyone
who can complete a connection — so (a) the service binds to 127.0.0.1
unless a host is explicitly passed (the launcher's coordinator address is
such an explicit override), and (b) when a shared secret is configured
(``POSEIDON_ASYNC_TOKEN`` in the launcher env, or the ``auth_token``
argument), every connection must pass an HMAC-SHA256 challenge/response
(``proto/wire.py``) over raw bytes BEFORE the first pickle frame is ever
parsed; a bad token gets the connection closed, never deserialized.
"""

from __future__ import annotations

import os
import queue
import random
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..proto.wire import (WIRE_CODEC_VERSION, AuthError, Bf16Array,
                          FrameError, bf16_from_f32, bf16_to_f32,
                          client_handshake, mark_codec_socket,
                          recv_frame as _recv_msg,
                          recv_frame_sized as _recv_msg_sized,
                          send_frame as _send_msg, server_handshake,
                          wire_codec_enabled)
# span instrumentation for the tier's wait points (push enqueue, anchor
# pulls, SSP gate, elastic admit); a no-op until the engine enables the
# recorder under --trace_out
from ..runtime.spans import recorder as _spans

__all__ = ["ParamService", "AsyncSSPClient", "TokenBucket",
           "run_async_ssp_worker", "split_topk", "FrameError", "AuthError"]

AUTH_TOKEN_ENV = "POSEIDON_ASYNC_TOKEN"


def _env_auth_token(explicit: Optional[str]) -> Optional[str]:
    """Resolve the shared secret: explicit argument wins, else the
    launcher env; empty string means disabled either way."""
    tok = explicit if explicit is not None else os.environ.get(AUTH_TOKEN_ENV)
    return tok or None


def _log(msg: str) -> None:
    # runtime/metrics.log, imported lazily: parallel/ must not pull the
    # whole runtime package (engine, torch state) in at import time
    try:
        from ..runtime.metrics import log as _rlog
    except Exception:  # noqa: BLE001 — logging must never take the tier down
        print(msg, flush=True)
        return
    _rlog(msg)


# framing: proto/wire.py's length-prefixed frames (FrameError, send_frame,
# recv_frame), imported above under this module's historical names.


def _tree_add(a: Dict, b: Dict) -> None:
    """In-place a += b over a two-level {layer: {param: ndarray}} tree."""
    for l, ps in b.items():
        for p, v in ps.items():
            a[l][p] += v


def _tree_sub(a: Dict, b: Dict) -> Dict:
    return {l: {p: a[l][p] - b[l][p] for p in ps} for l, ps in a.items()}


def _tree_copy(a: Dict) -> Dict:
    return {l: {p: np.array(v) for p, v in ps.items()} for l, ps in a.items()}


# --------------------------------------------------------------------------- #
# managed communication: sparse wire form, budget, prioritized selection
# --------------------------------------------------------------------------- #
# A partial push encodes each leaf as ("topk", idx, vals): flat int indices
# + float32 values of the magnitude-selected entries — the same logical
# index+value bytes the compiled TOPK tier's accounting meters
# (runtime/comm_stats.py: k * (4B index + value bytes)). Dense leaves stay
# plain ndarrays, so a full flush is byte-for-byte the pre-managed wire.

def _is_sparse(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and v[0] == "topk"


def _is_q8(v) -> bool:
    """int8 wire leaf: ("q8", per-bucket f32 scale, int8 codes)."""
    return isinstance(v, tuple) and len(v) == 3 and v[0] == "q8"


def _dense_f32(v) -> np.ndarray:
    """Widen one DENSE wire leaf to float32 — the SAME f32 arithmetic on
    every participant (client cache rebuild and server apply must agree
    bitwise): bf16/f16 widen exactly, q8 dequantizes as the deterministic
    f32 product scale * codes."""
    if _is_q8(v):
        _, scale, q = v
        return np.float32(scale) * q.astype(np.float32)
    if isinstance(v, Bf16Array):
        return bf16_to_f32(v)
    if v.dtype != np.float32:
        return v.astype(np.float32)
    return v


def _tree_add_any(a: Dict, b: Dict) -> None:
    """In-place a += b where b's leaves are dense ndarrays (f32 or a
    compressed wire dtype) OR sparse ("topk", idx, vals) tuples (vals
    possibly compressed). Top-k indices are unique by construction,
    and ``.flat`` fancy assignment writes through regardless of layout."""
    for l, ps in b.items():
        for p, v in ps.items():
            if _is_sparse(v):
                _, idx, vals = v
                a[l][p].flat[idx] += _dense_f32(vals)
            else:
                a[l][p] += _dense_f32(v)


def _leaf_copy_any(v):
    if _is_sparse(v):
        return ("topk", np.array(v[1]), _leaf_copy_any(v[2]))
    if _is_q8(v):
        return ("q8", np.float32(v[1]), np.array(v[2]))
    return np.array(v, subok=True)


def _tree_copy_any(a: Dict) -> Dict:
    out: Dict = {}
    for l, ps in a.items():
        out[l] = {}
        for p, v in ps.items():
            out[l][p] = _leaf_copy_any(v)
    return out


def _tree_nbytes(a: Dict) -> int:
    """Payload bytes a DENSE flush of this tree would put on the wire
    (array bytes only — pickle framing overhead is charged at send time
    from the actual frame size)."""
    return sum(v.nbytes for ps in a.values() for v in ps.values())


def _tree_elems(a: Dict) -> int:
    return sum(int(v.size) for ps in a.values() for v in ps.values())


def split_topk(tree: Dict, frac: float):
    """Magnitude-prioritized split of an update tree under a budget.

    Returns ``(sent, residual, n_sent, n_total)``: ``sent`` holds the top
    ``frac`` of entries by |value| across the WHOLE tree (global ranking —
    the bytes the link can carry go to the most important coordinates
    first, the SSPAggr rule), encoded sparse; ``residual`` is the EXACT
    elementwise complement (selected coordinates 0, everything else the
    original value — sent + residual reassembles the input bitwise, so
    nothing is ever lost, only delayed)."""
    leaves = [(l, p, v) for l, ps in tree.items() for p, v in ps.items()]
    n_total = sum(int(v.size) for _, _, v in leaves)
    if n_total == 0:
        return {}, {}, 0, 0
    k = max(1, int(round(n_total * frac)))
    if k >= n_total:
        return _tree_copy(tree), {l: {p: np.zeros_like(v)
                                      for p, v in ps.items()}
                                  for l, ps in tree.items()}, n_total, n_total
    flat = np.concatenate([np.asarray(v, np.float32).ravel()
                           for _, _, v in leaves])
    # top-k by magnitude; tie order among equal magnitudes is whatever
    # argpartition picks — ANY selection preserves the boundary invariant
    # (sent + residual == input exactly), so ties need no canonical order
    top = np.argpartition(np.abs(flat), n_total - k)[n_total - k:]
    mask = np.zeros(n_total, bool)
    mask[top] = True
    sent: Dict = {}
    residual: Dict = {}
    off = 0
    for l, p, v in leaves:
        n = int(v.size)
        m = mask[off:off + n]
        vals = flat[off:off + n]
        idx = np.flatnonzero(m)
        dt = np.int32 if n <= np.iinfo(np.int32).max else np.int64
        sent.setdefault(l, {})[p] = ("topk", idx.astype(dt),
                                     vals[idx].astype(np.float32))
        res = np.where(m, np.float32(0.0), vals).reshape(v.shape)
        residual.setdefault(l, {})[p] = res
        off += n
    return sent, residual, k, n_total


# --------------------------------------------------------------------------- #
# wire-dtype delta compression (error feedback over the codec)
# --------------------------------------------------------------------------- #
# The wire dtype shrinks what a flush puts on the link: bf16/f16 leaves
# travel at half width, int8 at a quarter (per-bucket scale). The
# quantization ERROR is not lost — it joins the managed-communication
# residual so `dequant(sent) + residual == update`
# holds BITWISE: the residual is computed against the exact f32 value
# the receiver reconstructs (widening is exact; v - dequant is exact by
# Sterbenz — the dequantized value is always within a factor of two of
# v, or v rides the residual whole), and it ships with the next flush.
# force_full flushes (mark_done/leave/close) stay EXACT f32 so a
# finished worker's anchor contribution is its whole update stream.

WIRE_DTYPES = ("", "f32", "bf16", "f16", "int8")
# full-flush wire/f32 size ratio, for the budget's dense-vs-partial
# estimate (actual bytes are charged from the real frame at send time)
_WIRE_RATIO = {"": 1.0, "bf16": 0.5, "f16": 0.5, "int8": 0.26}


def resolve_wire_dtype(wd) -> str:
    """Normalize a wire-dtype knob value; '' (and 'f32') mean off."""
    wd = (wd or "").strip().lower()
    if wd in ("f32", "float32", "none", "off"):
        wd = ""
    if wd not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES}, got {wd!r}")
    return wd


def _to_wire_float(v: np.ndarray, wd: str) -> np.ndarray:
    """f32 -> the half-width wire dtype: f16, or bf16 as its bits
    (``Bf16Array``, no ml_dtypes needed), both round to nearest even."""
    if wd == "bf16":
        return bf16_from_f32(v)
    with np.errstate(over="ignore"):   # f16 overflow handled by the caller
        return v.astype(np.float16)


def _quantize_leaf(v: np.ndarray, wd: str):
    """Quantize one dense f32 leaf for the wire. Returns
    ``(wire_leaf, residual_f32, wire_nbytes)`` with the EXACT
    error-feedback contract ``_dense_f32(wire_leaf) + residual == v``
    bitwise. Leaves int8 cannot represent usefully (all-zero or
    non-finite amax) ship as raw f32 with a zero residual."""
    v = np.asarray(v, np.float32)
    if wd == "int8":
        amax = float(np.max(np.abs(v))) if v.size else 0.0
        if not np.isfinite(amax) or amax == 0.0:
            return v, np.zeros_like(v), v.nbytes
        scale = np.float32(amax / 127.0)
        q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
        back = np.float32(scale) * q.astype(np.float32)
        return ("q8", scale, q), v - back, q.nbytes + 4
    q = _to_wire_float(v, wd)
    back = _dense_f32(q)
    # f16 overflow (|v| > 65504 -> inf): those entries ride the residual
    # whole instead — back becomes 0 there, keeping v - back exact
    bad = ~np.isfinite(back) & np.isfinite(v)
    if bad.any():
        q[bad] = 0
        back = _dense_f32(q)
    return q, v - back, q.nbytes


def _quantize_tree(tree: Dict, wd: str):
    """Quantize every dense leaf of a full flush. Returns
    ``(wire_tree, residual_tree_or_None, f32_bytes_saved)`` — residual
    is None when quantization was exact everywhere (e.g. power-of-two
    deltas under bf16), so no spurious force-full tick rides behind."""
    wire: Dict = {}
    residual: Dict = {}
    saved = 0
    any_resid = False
    for l, ps in tree.items():
        wire[l] = {}
        residual[l] = {}
        for p, v in ps.items():
            wl, res, wn = _quantize_leaf(v, wd)
            wire[l][p] = wl
            residual[l][p] = res
            saved += v.nbytes - wn
            any_resid = any_resid or bool(np.any(res))
    return wire, (residual if any_resid else None), saved


class TokenBucket:
    """Byte-budget token bucket for the managed-communication link.

    ``rate_bps`` tokens (bytes) per second refill, capped at ``burst``.
    ``consume`` ACCOUNTS traffic (it may drive the balance negative —
    accounting never blocks the data plane; correctness traffic like
    gates, heartbeats and forced boundary flushes always goes through);
    the SEND policy reads ``available()`` to choose dense vs partial.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, rate_bps: float, burst_bytes: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate_bps)
        # default burst: one second of budget, floor 64 KiB so small
        # control frames never starve at tiny configured rates
        self.burst = float(burst_bytes if burst_bytes is not None
                           else max(self.rate, 65536.0))
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def consume(self, nbytes: float) -> None:
        with self._lock:
            self._refill_locked()
            self._tokens -= float(nbytes)


def _fault_defaults(heartbeat_s, liveness_timeout_s, reconnect_deadline_s,
                    backoff_base_s, backoff_cap_s):
    """Resolve None knobs against the global FaultConfig (config.py)."""
    from .. import config as _config
    fc = _config.fault_config()
    return (
        fc.heartbeat_s if heartbeat_s is None else heartbeat_s,
        fc.liveness_timeout_s if liveness_timeout_s is None
        else liveness_timeout_s,
        fc.reconnect_deadline_s if reconnect_deadline_s is None
        else reconnect_deadline_s,
        fc.backoff_base_s if backoff_base_s is None else backoff_base_s,
        fc.backoff_cap_s if backoff_cap_s is None else backoff_cap_s,
    )


# --------------------------------------------------------------------------- #
# server
# --------------------------------------------------------------------------- #

class ParamService:
    """Asynchronous parameter anchor for the process tier (rank-0 thread).

    Applies PUSH increments the moment they arrive (no epoch, no barrier)
    and serves PULL snapshots at whatever clock vector the moment holds —
    the server side of Bösen's wait-free contract.

    ``server_logic``:
      - ``"inc"`` (default): plain additive oplog apply — the reference's
        SSPPush increment rule; pushes carry pre-scaled parameter deltas.
      - ``"adarevision"``: the delay-corrected AdaGrad server rule
        (adarevision_server_table_logic.cpp:52-175), living HERE in its
        native habitat — the asynchronous tier it was designed for (the
        compiled tier's version is boundary-aligned; this one computes the
        true cross-boundary backlog). Pushes carry RAW accumulated
        gradients u based on the worker's last PULL snapshot; per element:
        ``g_bck = G - G_base[w]``; ``z += u*(u + 2*g_bck)``;
        ``zmax = max(zmax, z)``; ``eta = init_step/sqrt(zmax)``;
        ``anchor += -eta*u + (eta_old - eta)*g_bck``; ``G += u``; a PULL
        re-bases ``G_base[w] = G``.

    ``liveness_timeout_s``: a worker not heard from (any message on any of
    its connections counts) for this long is evicted into
    ``failed_workers`` — survivors' gates exclude it. ``None`` reads the
    global FaultConfig; ``<= 0`` disables the monitor (reference
    semantics: a hung peer wedges every gate forever). Abrupt disconnect
    of a worker's LAST live connection evicts immediately, without waiting
    for the timeout. Any later activity from the worker rejoins it."""

    def __init__(self, params: Dict, n_workers: int,
                 host: str = "127.0.0.1", port: int = 0,
                 server_logic: str = "inc", init_step: float = 0.1,
                 liveness_timeout_s: Optional[float] = None,
                 auth_token: Optional[str] = None,
                 record_events: bool = False):
        if server_logic not in ("inc", "adarevision"):
            raise ValueError(f"unknown server_logic {server_logic!r}")
        # default bind is LOOPBACK-ONLY (host="127.0.0.1"); a wider bind is
        # an explicit caller decision (e.g. the launcher's coordinator
        # host) and should come with an auth token — the frames are pickles
        self.auth_token = _env_auth_token(auth_token)
        self.auth_failures = 0  # rejected handshakes (telemetry)
        self.anchor = _tree_copy(params)
        self.server_logic = server_logic
        self.init_step = init_step
        if server_logic == "adarevision":
            ones = {l: {p: np.ones_like(v) for p, v in ps.items()}
                    for l, ps in self.anchor.items()}
            zeros = {l: {p: np.zeros_like(v) for p, v in ps.items()}
                     for l, ps in self.anchor.items()}
            self.z = _tree_copy(ones)        # AdaRevisionRow ctor: init 1
            self.zmax = _tree_copy(ones)
            self.gsum = _tree_copy(zeros)    # total raw gradient applied
            self.gbase = {w: _tree_copy(zeros) for w in range(n_workers)}
        self.clocks = {w: -1 for w in range(n_workers)}  # applied clocks
        # managed communication: the DURABLE clock — the last clock whose
        # flush was FULL (dense, or partial-mode boundary flush carrying
        # the whole residual). Everything the worker produced through this
        # clock is IN the anchor; read gates run over this vector, so the
        # SSP bound holds exactly even when intermediate pushes defer
        # bytes. Dense pushes are always full: durable == clocks there.
        self.durable = {w: -1 for w in range(n_workers)}
        self.n_workers = n_workers
        # elastic membership: the ACTIVE worker set. Starts as the launch
        # roster; `admit` grows it mid-run (rendezvous at the anchor
        # clock), `retire` shrinks it deliberately (the slot leaves every
        # gate's denominator — eviction only excludes, retirement removes)
        self.members: set = set(range(n_workers))
        self.retired: set = set()
        self.admissions = 0  # mid-run admits of NEW worker ids (telemetry)
        self._lock = threading.Lock()
        self._version = 0
        # telemetry: the widest clock spread ever observed at an apply —
        # the SSP bound holds iff this never exceeds staleness + 1
        self.max_spread = 0
        self.done_workers: set = set()
        # elasticity (beyond the reference's fail-fast, comm_bus.hpp:22-24):
        # a worker whose LAST connection dies WITHOUT a clean bye/done — or
        # that goes silent past the liveness timeout — is evicted into
        # failed_workers; surviving workers' gates then exclude it instead
        # of timing out, and its already-applied clocks stay in the anchor
        # (bounded update loss = its un-flushed oplog, the PS failure model)
        self.failed_workers: set = set()
        # exactly-once PUSH: per-worker applied-sequence high-water mark; a
        # reconnecting client replays un-acked flushes and duplicates
        # (same seq) are acked without a second apply
        self.applied_seq = {w: -1 for w in range(n_workers)}
        if liveness_timeout_s is None:
            from .. import config as _config
            liveness_timeout_s = _config.fault_config().liveness_timeout_s
        self.liveness_timeout_s = liveness_timeout_s or 0.0
        now = time.time()
        # grace window: a worker that never connects still gets evicted,
        # one liveness timeout after service start
        self.last_seen = {w: now for w in range(n_workers)}
        self._conn_counts: Dict[int, int] = {}  # live identified conns
        self.evictions = 0   # liveness-timeout evictions (telemetry)
        self.rejoins = 0     # un-evictions via later activity (telemetry)
        self.bad_frames = 0  # malformed/truncated frames dropped (telemetry)
        # protocol event log for a trace-conformance check of the
        # protocol's state machine: the state-machine-relevant events, in service apply order, appended
        # under self._lock. Off by default — a telemetry list growing one
        # tuple per push is cheap, but recording is a test/debug decision
        self._record_events = record_events
        self.events: List[Tuple] = []
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        # live connections, shut down by close() so no serving thread
        # outlives the service
        self._conns: set = set()
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="ParamService-accept")
        t.start()
        self._threads.append(t)
        if self.liveness_timeout_s > 0:
            m = threading.Thread(target=self._monitor_loop, daemon=True,
                                 name="ParamService-monitor")
            m.start()
            self._threads.append(m)

    # ---- server loop ---------------------------------------------------- #
    def _accept_loop(self) -> None:
        try:
            self._srv.settimeout(0.25)
        except OSError:      # closed before this thread ran
            return
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # per-connection threads are daemonic and never joined; do NOT
            # retain them — reconnect/heartbeat churn over a long run would
            # grow the list without bound on the service host. Their
            # sockets are tracked (and dropped when they close) so close()
            # can end every one.
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="ParamService-conn").start()

    def _monitor_loop(self) -> None:
        """Evict workers silent past the liveness timeout. Detection is
        bounded by timeout + poll period; done workers are exempt (they
        closed cleanly), failed ones already evicted."""
        period = max(0.02, min(0.25, self.liveness_timeout_s / 4.0))
        while not self._stop.wait(period):
            now = time.time()
            with self._lock:
                for w in sorted(self.members):
                    if w in self.failed_workers or w in self.done_workers:
                        continue
                    silent = now - self.last_seen.get(w, now)
                    if silent > self.liveness_timeout_s:
                        self.failed_workers.add(w)
                        self.evictions += 1
                        _log(f"ParamService: evicting worker {w} "
                             f"(silent {silent:.1f}s > liveness "
                             f"{self.liveness_timeout_s:.1f}s); survivors' "
                             f"gates now exclude it")

    def _member_view(self) -> Dict:
        """The membership snapshot every clock-bearing reply carries
        (caller holds the lock). ``members`` is the FULL membership (a
        finished worker is still a member of the job — only `retire`
        removes a slot), so data assignment keyed on it does not churn
        when a peer merely finishes; clients exclude ``done`` and
        ``failed`` from their GATES themselves (a finished worker's
        frozen clock must not wedge a straggler's last gate, and a dead
        one must not deadlock survivors)."""
        return {"clocks": dict(self.clocks),
                "durable": dict(self.durable),
                "members": sorted(self.members),
                "failed": sorted(self.failed_workers),
                "done": sorted(self.done_workers)}

    def _live_clocks(self) -> List[int]:
        """Applied clocks of gate-relevant members (caller holds lock)."""
        return [c for w, c in self.clocks.items()
                if w in self.members and w not in self.failed_workers
                and w not in self.done_workers]

    def _touch(self, worker: int) -> None:
        """Record liveness; any activity from an evicted worker rejoins it
        (its clock resumes where the anchor last applied it)."""
        with self._lock:
            self.last_seen[worker] = time.time()
            if worker in self.failed_workers:
                self.failed_workers.discard(worker)
                self.rejoins += 1
                _log(f"ParamService: worker {worker} rejoined "
                     f"(clock {self.clocks.get(worker, -1)})")

    def _admit_locked(self, w: int) -> int:
        """Admit worker ``w`` at the rendezvous anchor clock (caller holds
        the lock). The join clock is the minimum applied clock over live
        members — the clock every survivor's gate has already seen, so a
        joiner never appears ahead of work it did not do and holds the
        fleet back by at most one gate window. Idempotent for existing
        members (degenerates to the rejoin pull: resume at the applied
        clock). A RE-admitted id (previously retired/evicted) resumes past
        its own historical clock/seq high-water mark, so the exactly-once
        dedup can never swallow its post-readmission flushes."""
        if w in self.members:
            return self.clocks.get(w, -1)
        live = self._live_clocks()
        join = min(live) if live else -1
        # a returning id must resume PAST everything it ever flushed
        join = max(join, self.clocks.get(w, -1), self.applied_seq.get(w, -1))
        self.members.add(w)
        self.retired.discard(w)
        self.failed_workers.discard(w)
        self.done_workers.discard(w)
        self.clocks[w] = join
        # a joiner owes nothing before its join clock: durable starts
        # there too, so peers' gates never wait on pre-join history
        self.durable[w] = max(self.durable.get(w, -1), join)
        self.applied_seq[w] = max(self.applied_seq.get(w, -1), join)
        self.last_seen[w] = time.time()
        if self.server_logic == "adarevision":
            # the admit reply carries the anchor snapshot: the joiner's
            # first gradients build on it, exactly like a PULL re-base
            self.gbase[w] = _tree_copy(self.gsum)
        self.admissions += 1
        self.n_workers = max(self.n_workers, len(self.members))
        self._version += 1
        if self._record_events:
            self.events.append(("admit", w, join))
        _log(f"ParamService: admitted worker {w} at join clock {join} "
             f"({len(self.members)} members)")
        return join

    def _serve(self, conn: socket.socket) -> None:
        if self.auth_token is not None:
            # authenticate BEFORE any frame parse: recv_frame unpickles,
            # and unauthenticated bytes must never reach a pickle loader
            if not server_handshake(conn, self.auth_token):
                with self._lock:
                    self.auth_failures += 1
                _log("ParamService: rejecting unauthenticated connection "
                     "(bad or missing token)")
                conn.close()
                return
        worker: Optional[int] = None
        registered = False
        abnormal = False
        try:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn)
                except FrameError as e:
                    # a corrupt peer must never take the service down: log,
                    # drop THIS connection, keep serving everyone else (the
                    # client's replay-on-reconnect makes the drop lossless)
                    abnormal = True
                    with self._lock:
                        self.bad_frames += 1
                    _log(f"ParamService: dropping connection "
                         f"(worker={worker}): {e}")
                    return
                except (ConnectionError, EOFError, OSError):
                    abnormal = True
                    return
                try:
                    kind = msg["kind"]
                    if "worker" in msg and worker is None:
                        worker = msg["worker"]
                        with self._lock:
                            self._conn_counts[worker] = \
                                self._conn_counts.get(worker, 0) + 1
                        registered = True
                    if worker is not None:
                        self._touch(worker)
                    if kind == "hello":
                        # identification + liveness only; a restarted
                        # worker resumes its clock/seq via rejoin()'s pull.
                        # The reply advertises the binary codec so a new
                        # client knows negotiation is worth attempting —
                        # an old client ignores the extra key, an old
                        # server never advertises, both stay on pickle.
                        ack = {"ok": True}
                        if wire_codec_enabled():
                            ack["codec"] = WIRE_CODEC_VERSION
                        _send_msg(conn, ack)
                    elif kind == "wire":
                        # codec negotiation: affirm iff we speak exactly
                        # the client's version AND the codec is enabled
                        # here. The reply itself is still pickle (sent
                        # before the connection is marked); every later
                        # frame on this connection rides the codec.
                        ok = bool(wire_codec_enabled()
                                  and msg.get("codec") == WIRE_CODEC_VERSION)
                        _send_msg(conn, {"ok": ok,
                                         "codec": WIRE_CODEC_VERSION})
                        if ok:
                            mark_codec_socket(conn)
                    elif kind == "push":
                        w = msg["worker"]
                        seq = msg.get("seq", msg["clock"])
                        with self._lock:
                            dup = seq <= self.applied_seq.get(w, -1)
                            if self._record_events:
                                self.events.append(
                                    ("push", w, msg["clock"],
                                     bool(msg.get("full", True)), dup))
                            if not dup:
                                if self.server_logic == "adarevision":
                                    # partial (sparse) pushes are refused
                                    # client-side for adarevision — the
                                    # backlog re-base needs dense updates
                                    self._apply_adarevision(w, msg["delta"])
                                else:
                                    # residual-aware apply: sparse leaves
                                    # add at their indices, dense leaves
                                    # add whole — composing additively, so
                                    # the exactly-once seq dedup covers
                                    # partial pushes with zero new cases
                                    # (a replayed partial is the SAME
                                    # payload, acked without re-apply)
                                    _tree_add_any(self.anchor, msg["delta"])
                                self.applied_seq[w] = seq
                                self.clocks[w] = max(
                                    self.clocks.get(w, -1), msg["clock"])
                                if msg.get("full", True):
                                    # full flush: everything through this
                                    # clock (delta + carried residual) is
                                    # now in the anchor — gates may admit
                                    # readers against it
                                    self.durable[w] = max(
                                        self.durable.get(w, -1),
                                        msg["clock"])
                                self._version += 1
                                cs = self._live_clocks()
                                if cs and all(c >= 0 for c in cs):
                                    self.max_spread = max(
                                        self.max_spread, max(cs) - min(cs))
                            ack = {"ok": True, "dup": dup,
                                   **self._member_view()}
                        _send_msg(conn, ack)
                    elif kind == "heartbeat":
                        # liveness already recorded by _touch above; the
                        # reply piggybacks the clock vector so idle workers
                        # see evictions/progress without an extra RPC
                        with self._lock:
                            view = self._member_view()
                        _send_msg(conn, {"ok": True, **view})
                    elif kind == "pull":
                        # copy under the lock, serialize/send OUTSIDE it —
                        # a slow client socket must not stall concurrent
                        # pushes (that would be a barrier through the back
                        # door)
                        with self._lock:
                            snap = _tree_copy(self.anchor)
                            view = self._member_view()
                            version = self._version
                            if self.server_logic == "adarevision" and \
                                    worker is not None:
                                # the read re-bases this worker's backlog:
                                # its next gradients build on THIS snapshot
                                self.gbase[worker] = _tree_copy(self.gsum)
                        _send_msg(conn, {"anchor": snap, "version": version,
                                         **view})
                    elif kind == "admit":
                        w = msg["worker"]
                        with self._lock:
                            snap = _tree_copy(self.anchor)
                            join = self._admit_locked(w)
                            view = self._member_view()
                            version = self._version
                        _send_msg(conn, {"anchor": snap, "join_clock": join,
                                         "version": version, **view})
                    elif kind == "retire":
                        # deliberate scale-down: the slot leaves the member
                        # set entirely — survivors' gates never wait on it,
                        # no liveness timeout involved. Applied clocks stay
                        # in the anchor; only `admit` brings the id back.
                        w = msg["worker"]
                        with self._lock:
                            if w in self.members:
                                self.members.discard(w)
                                self.retired.add(w)
                                self.failed_workers.discard(w)
                                if self._record_events:
                                    self.events.append(("retire", w))
                                _log(f"ParamService: worker {w} retired "
                                     f"(clock {self.clocks.get(w, -1)}); "
                                     f"{len(self.members)} members remain")
                            view = self._member_view()
                        _send_msg(conn, {"ok": True, **view})
                    elif kind == "clocks":
                        with self._lock:
                            view = self._member_view()
                        _send_msg(conn, view)
                    elif kind == "done":
                        # a worker finished its run (NOT a barrier:
                        # stragglers keep training; the driver polls
                        # done_count to decide when the anchor is final)
                        with self._lock:
                            self.done_workers.add(msg["worker"])
                            if self._record_events:
                                self.events.append(("done", msg["worker"]))
                        _send_msg(conn, {"ok": True})
                    elif kind == "bye":
                        _send_msg(conn, {"ok": True})
                        abnormal = False   # clean shutdown, never "failed"
                        return
                    else:
                        raise ValueError(f"unknown message kind {kind!r}")
                except (ConnectionError, OSError):
                    abnormal = True
                    return
                except Exception as e:  # noqa: BLE001 — bad request shape
                    # unknown kind / missing field / wrong types: same
                    # containment as a malformed frame — the per-connection
                    # thread must die loudly-logged, the service must not
                    abnormal = True
                    with self._lock:
                        self.bad_frames += 1
                    _log(f"ParamService: bad request (worker={worker}): "
                         f"{type(e).__name__}: {e}")
                    return
        finally:
            # ONLY an abnormal disconnect of the worker's LAST live
            # connection marks failure: a server-side shutdown (_stop)
            # exiting the loop must not condemn a live worker, and a
            # reconnected client's fresh sockets must not be condemned by
            # the old half-dead ones unwinding late
            if registered and worker is not None:
                with self._lock:
                    self._conn_counts[worker] -= 1
                    # only MEMBERS can fail: a retired slot already left
                    # every gate, and a joiner that died before its admit
                    # landed was never gated on in the first place
                    if abnormal and worker in self.members and \
                            worker not in self.done_workers and \
                            self._conn_counts[worker] <= 0 and \
                            worker not in self.failed_workers:
                        self.failed_workers.add(worker)
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _apply_adarevision(self, worker: int, u: Dict) -> None:
        """The reference server rule, per element (caller holds the lock;
        adarevision_server_table_logic.cpp:52-175; held against its
        float64 replica by ``test_adarevision_matches_reference_formula``
        in ``tests/test_torch_async_ssp.py``)."""
        for l, ps in u.items():
            for p, ug in ps.items():
                g_bck = self.gsum[l][p] - self.gbase[worker][l][p]
                eta_old = self.init_step / np.sqrt(self.zmax[l][p])
                self.z[l][p] += ug * (ug + 2.0 * g_bck)
                np.maximum(self.zmax[l][p], self.z[l][p],
                           out=self.zmax[l][p])
                eta = self.init_step / np.sqrt(self.zmax[l][p])
                self.anchor[l][p] += -eta * ug + (eta_old - eta) * g_bck
                self.gsum[l][p] += ug

    def close(self) -> None:
        """Stop accepting, stop the monitor, and shut down every live
        connection (its peer sees the service go away, as on a crash)."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


# --------------------------------------------------------------------------- #
# client
# --------------------------------------------------------------------------- #

class AsyncSSPClient:
    """Worker-side cache + oplog + non-blocking dispatch.

    The training thread calls :meth:`push` (enqueue, returns immediately),
    :meth:`gate` (blocks only on a staleness violation), and
    :meth:`refresh` (pull + rebuild the read-my-writes cache).

    Both channels self-heal: a broken socket is redialed with capped
    exponential backoff + full jitter for up to ``reconnect_deadline_s``;
    the push channel replays every un-acked flush on reconnect (the
    service's per-worker sequence dedup makes the replay exactly-once).
    Only when the deadline is exhausted does the failure surface — as a
    RuntimeError from the next ``push``/``gate``/``refresh`` — so the
    training loop always learns about a permanently dead tier instead of
    silently losing oplogs behind a dead sender thread."""

    def __init__(self, worker: int, addr: Tuple[str, int],
                 staleness: int, n_workers: int = 0,
                 retry_s: float = 10.0, server_logic: str = "inc",
                 init_step: float = 0.1,
                 heartbeat_s: Optional[float] = None,
                 reconnect_deadline_s: Optional[float] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_cap_s: Optional[float] = None,
                 auth_token: Optional[str] = None,
                 budget_mbps: Optional[float] = None,
                 priority_frac: float = 0.1,
                 adaptive: bool = False,
                 wire_dtype: str = "",
                 bucket_clock: Callable[[], float] = time.monotonic,
                 record_events: bool = False):
        self.worker = worker
        self.auth_token = _env_auth_token(auth_token)
        self.n_workers = n_workers if n_workers else worker + 1
        self.staleness = staleness
        self.server_logic = server_logic
        self.init_step = init_step
        self._addr = addr
        # managed communication (SSPAggr): None/<=0 budget = unlimited —
        # every push takes EXACTLY the dense path (no residual machinery,
        # no behavior change). A finite budget enables magnitude-
        # prioritized partial pushes under pressure, with the residual
        # carried locally and force-flushed at every SSP window boundary.
        if budget_mbps is not None and budget_mbps > 0:
            if server_logic == "adarevision":
                raise ValueError(
                    "managed communication (budget_mbps) does not compose "
                    "with server_logic='adarevision': the server's backlog "
                    "re-base needs dense raw-gradient pushes")
            self.budget: Optional[TokenBucket] = TokenBucket(
                budget_mbps * 1e6 / 8.0, clock=bucket_clock)
        else:
            self.budget = None
        self.priority_frac = min(1.0, max(1e-6, priority_frac))
        self.adaptive = adaptive
        # wire-dtype compression ('' = off, today's f32 wire byte for
        # byte). Quantization error joins the residual (error feedback),
        # which adarevision cannot carry — its server rule needs raw
        # dense gradients, same refusal as the bandwidth budget.
        self._wire = resolve_wire_dtype(wire_dtype)
        if self._wire and server_logic == "adarevision":
            raise ValueError(
                "wire_dtype compression does not compose with "
                "server_logic='adarevision': the server's backlog re-base "
                "needs dense raw-gradient pushes, not error-feedback "
                "quantized deltas")
        self.wire_bytes_saved = 0
        self._residual: Optional[Dict] = None  # train-thread only
        # cadence backoff factor (1 = every window ships its delta); the
        # sender thread escalates/decays it, push() reads it — both under
        # _stats_lock (shared with the reconnect counter)
        self._backoff = 1
        self._backoff_cap = 8
        self.cadence_backoffs = 0
        # per-link traffic counters (actual frame bytes, both channels),
        # written by sender AND train threads — _stats_lock discipline
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.partial_pushes = 0
        self.full_pushes = 0
        self.deferred_elems = 0
        self.pushed_elems = 0
        self._goodput_mbps = 0.0  # EWMA of per-RPC goodput (both dirs)
        (self.heartbeat_s, _, self.reconnect_deadline_s,
         self.backoff_base_s, self.backoff_cap_s) = _fault_defaults(
            heartbeat_s, None, reconnect_deadline_s,
            backoff_base_s, backoff_cap_s)
        # deterministic per-worker jitter stream (tests; and distinct
        # workers de-synchronize their retries by construction)
        self._rng = random.Random(0xA5 ^ worker)
        self._stop = threading.Event()
        # reconnect episodes are counted from BOTH channels — the sender
        # thread's push recovery and the training thread's pull recovery —
        # so the increment needs its own lock (THR004; membership
        # telemetry reads it concurrently)
        self._stats_lock = threading.Lock()
        self.reconnects = 0
        # gate-admission event log for the model checker's conformance
        # harness (("gate", worker, clock, min_peer_durable) per PASSED
        # gate — what the real gate actually observed when it admitted
        # the read). Train-thread writes, but appended under _stats_lock
        # so a test can read it concurrently without a torn list.
        self._record_events = record_events
        self.events: List[Tuple] = []
        # initial connect: the service may come up AFTER the workers under
        # a real launcher — retry_s is the rendezvous deadline
        self._push_sock = self._dial(retry_s)
        self._pull_sock = self._dial(retry_s)
        self._push_lock = threading.Lock()
        self._pull_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        # un-applied own updates: (clock, payload-as-sent, full) — the
        # replay oplog holds exactly what went on the wire (sparse or
        # dense) so a reconnect replays byte-identical flushes
        self._pending: List[Tuple[int, Dict, bool]] = []
        self._pending_lock = threading.Lock()
        self.clocks: Dict[int, int] = {}
        self.durable: Dict[int, int] = {}  # peers' fully-flushed clocks
        self.failed: set = set()   # peers the service declared dead
        self.done: set = set()     # peers that finished their run
        # the CURRENT member set, replaced by every clock-bearing reply —
        # gates follow the fleet as it grows/shrinks, never a static
        # range(n_workers). Seeded with the launch roster (a joiner's seed
        # is replaced by the admit reply before its first gate). Done
        # workers STAY members (data assignment keys on membership and
        # must not churn when a peer merely finishes) — gates exclude
        # them via ``done``.
        self.members: set = set(range(self.n_workers))
        self.clock = -1          # last flushed clock
        self._acked_clock = -1   # last clock the server acknowledged
        self.blocked_s = 0.0     # cumulative gate wait (telemetry)
        self.gate_blocks = 0
        self.dead: Optional[BaseException] = None
        self._sender = threading.Thread(target=self._send_loop, daemon=True,
                                        name=f"AsyncSSPClient-{worker}")
        self._sender.start()

    # ---- channel (re)establishment -------------------------------------- #
    def _dial_once(self) -> socket.socket:
        """One connect + identify attempt. Identifying EVERY socket up
        front matters twice over: failure detection attributes an abrupt
        disconnect to this worker even if it never pushed, and any hello
        from an evicted worker is its rejoin signal."""
        sk = socket.create_connection(self._addr, timeout=5.0)
        try:
            if self.auth_token is not None:
                # answer the service's HMAC challenge before the first
                # frame; a wrong token gets the socket closed server-side
                # and surfaces here as a dead channel (dial retries, then
                # the rendezvous deadline raises)
                client_handshake(sk, self.auth_token)
            _send_msg(sk, {"kind": "hello", "worker": self.worker},
                      codec=False)
            hello = _recv_msg(sk)
            # codec negotiation (re-run on every reconnect — marking is
            # per socket): only offered when the hello reply advertised
            # the same version, so an old service never sees the kind.
            # The negotiation frames themselves are always pickle.
            if (wire_codec_enabled() and isinstance(hello, dict)
                    and hello.get("codec") == WIRE_CODEC_VERSION):
                _send_msg(sk, {"kind": "wire",
                               "codec": WIRE_CODEC_VERSION}, codec=False)
                ack = _recv_msg(sk)
                if isinstance(ack, dict) and ack.get("ok") \
                        and ack.get("codec") == WIRE_CODEC_VERSION:
                    mark_codec_socket(sk)
        except BaseException:
            sk.close()
            raise
        # established: the channel must BLOCK from here on — leaving the
        # 5 s dial timeout on the long-lived socket would misread a
        # slow-but-alive service (big anchor copy, lock contention) as a
        # dead channel and churn reconnects (slow != dead)
        sk.settimeout(None)
        return sk

    def _dial(self, deadline: float) -> socket.socket:
        from ..runtime.retry import retry_with_backoff
        return retry_with_backoff(
            self._dial_once, deadline=deadline, base=self.backoff_base_s,
            cap=self.backoff_cap_s, rng=self._rng,
            retry_on=(OSError, EOFError), should_stop=self._stop.is_set)

    def _rpc(self, sock: socket.socket, msg: Dict) -> Dict:
        """One request/reply exchange with bandwidth accounting: the
        ACTUAL frame bytes of both directions are charged to the token
        bucket (push and pull paths alike) and folded into the per-link
        counters + goodput EWMA. Accounting never blocks — the budget
        shapes the SEND POLICY (dense vs partial), not the socket."""
        t0 = time.monotonic()
        sent = _send_msg(sock, msg)
        reply, got = _recv_msg_sized(sock)
        dt = max(1e-9, time.monotonic() - t0)
        if self.budget is not None:
            self.budget.consume(sent + got)
        with self._stats_lock:
            self.bytes_sent += sent
            self.bytes_recv += got
            # goodput of this RPC in Mbit/s, smoothed; tiny control frames
            # measure link round-trip more than bandwidth, so only frames
            # big enough to be payload-dominated move the estimate
            if sent + got >= 4096:
                mbps = 8.0 * (sent + got) / dt / 1e6
                self._goodput_mbps = (0.8 * self._goodput_mbps + 0.2 * mbps
                                      if self._goodput_mbps else mbps)
        return reply

    def _reconnect_channel(self, lock: threading.Lock, sock_attr: str,
                           body: Callable[[socket.socket], Dict]) -> Dict:
        """Shared recovery envelope for both channels: redial with the
        backoff policy, run ``body`` on the fresh socket, and only then
        install it as ``sock_attr`` (closing the dead one) — a socket that
        failed mid-``body`` is discarded, never installed half-used."""
        from ..runtime.retry import retry_with_backoff

        counted = False

        def attempt() -> Dict:
            nonlocal counted
            sk = self._dial_once()
            # count this recovery EPISODE (once, not per dial) the moment
            # a channel is re-established — BEFORE body runs: the replay
            # inside body has externally observable effects (acked clocks,
            # the service's anchor), and a drain() caller observing them
            # must also observe the reconnect counter
            if not counted:
                with self._stats_lock:
                    self.reconnects += 1
                counted = True
            try:
                out = body(sk)
            except BaseException:
                sk.close()
                raise
            with lock:
                old = getattr(self, sock_attr)
                setattr(self, sock_attr, sk)
            try:
                old.close()
            except OSError:
                pass
            return out

        return retry_with_backoff(
            attempt, deadline=self.reconnect_deadline_s,
            base=self.backoff_base_s, cap=self.backoff_cap_s,
            rng=self._rng, retry_on=(OSError, EOFError),
            should_stop=self._stop.is_set)

    def _recover_push(self, msg: Optional[Dict]) -> Dict:
        """Reconnect the push channel and replay every un-acked flush in
        clock order (the service dedups by seq, so a flush whose ack was
        lost in the crash is applied exactly once). ``msg`` is the RPC
        that hit the dead socket: a push is already in the pending oplog
        and rides the replay; anything else is re-sent afterwards."""
        def replay(sk: socket.socket) -> Dict:
            with self._pending_lock:
                backlog = [(c, d, f) for c, d, f in self._pending
                           if c > self._acked_clock]
            ack: Optional[Dict] = None
            for c, d, f in backlog:
                # the pending oplog holds the PAYLOAD AS SENT (sparse or
                # dense) plus its full-flush flag, so a replayed partial
                # is byte-identical to the original and the seq dedup
                # stays exactly-once with no residual special cases
                ack = self._rpc(sk, {"kind": "push", "worker": self.worker,
                                     "clock": c, "seq": c, "delta": d,
                                     "full": f})
                self._acked_clock = max(self._acked_clock, c)
            if msg is not None and msg.get("kind") != "push":
                ack = self._rpc(sk, msg)
            return ack if ack is not None else {"ok": True}

        ack = self._reconnect_channel(self._push_lock, "_push_sock", replay)
        _log(f"async-SSP worker {self.worker}: push channel reconnected "
             f"(replayed through clock {self._acked_clock})")
        return ack

    def _push_rpc(self, msg: Dict) -> Dict:
        """One RPC on the push channel (sender thread only), recovering a
        dead socket by reconnect + replay."""
        try:
            with self._push_lock:
                ack = self._rpc(self._push_sock, msg)
        except (OSError, EOFError) as e:
            if self._stop.is_set():
                raise
            _log(f"async-SSP worker {self.worker}: push channel lost "
                 f"({type(e).__name__}: {e}); reconnecting")
            ack = self._recover_push(msg)
        if isinstance(ack, dict) and "clocks" in ack:
            self._absorb_view(ack)
        return ack

    def _absorb_view(self, resp: Dict) -> None:
        """Adopt a reply's membership snapshot (clock table, member list,
        failed/done sets) — the client's entire view of the fleet."""
        self.clocks = resp["clocks"]
        # durable clocks gate managed-mode reads; a service without the
        # field (never the in-repo one) degenerates to the raw clocks.
        # Both channels absorb views (sender acks, train-thread pulls)
        # and the gate reads concurrently — lock the swap pair
        with self._stats_lock:
            self.durable = resp.get("durable", resp["clocks"])
        self.failed = set(resp.get("failed", ()))
        if "members" in resp:
            self.members = set(resp["members"])
        if "done" in resp:
            self.done = set(resp["done"])

    def _pull_rpc(self, msg: Dict) -> Dict:
        """One RPC on the pull channel (training thread only), recovering a
        dead socket by reconnect + retry. Every pull-channel request is
        idempotent (pull/clocks/done), so a blind retry is safe."""
        try:
            with self._pull_lock:
                return self._rpc(self._pull_sock, msg)
        except (OSError, EOFError) as e:
            if self._stop.is_set():
                raise
            _log(f"async-SSP worker {self.worker}: pull channel lost "
                 f"({type(e).__name__}: {e}); reconnecting")

        def resend(sk: socket.socket) -> Dict:
            return self._rpc(sk, msg)

        return self._reconnect_channel(self._pull_lock, "_pull_sock", resend)

    # ---- non-blocking dispatch ------------------------------------------ #
    def _send_loop(self) -> None:
        last_hb = time.time()
        poll = min(0.25, max(0.02, (self.heartbeat_s or 1.0) / 4.0))
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=poll)
            except queue.Empty:
                item = None
            try:
                if item is not None:
                    clock, delta, full = item
                    if clock > self._acked_clock:
                        # (a recovery replay may already have landed it)
                        self._push_rpc({"kind": "push",
                                        "worker": self.worker,
                                        "clock": clock, "seq": clock,
                                        "delta": delta, "full": full})
                        self._acked_clock = max(self._acked_clock, clock)
                    self._update_cadence()
                    last_hb = time.time()
                elif self.heartbeat_s > 0 and \
                        time.time() - last_hb >= self.heartbeat_s:
                    # idle: heartbeat so the service's liveness monitor
                    # never mistakes a slow-but-alive worker for a dead one
                    self._push_rpc({"kind": "heartbeat",
                                    "worker": self.worker})
                    last_hb = time.time()
            except BaseException as e:  # noqa: BLE001 — surface, never lose
                # reconnect deadline exhausted: FAIL the run, not silently
                # drop oplogs — push()/gate()/drain all re-raise this
                self.dead = e
                return

    def _check_alive(self) -> None:
        if self.dead is not None:
            raise RuntimeError(
                f"worker {self.worker}: update dispatch died after "
                f"reconnect attempts ({type(self.dead).__name__}: "
                f"{self.dead}); oplogs from clock "
                f"{self._acked_clock + 1} on were never applied"
            ) from self.dead

    # ---- managed send policy -------------------------------------------- #
    def _is_boundary(self, clock: int) -> bool:
        """SSP window boundaries — the clocks whose flush MUST be full so
        the residual age never exceeds the staleness bound. Every s+1
        clocks; at s=0 every clock is a boundary (managed degenerates to
        dense, as it must: zero staleness leaves no room to defer)."""
        return (clock + 1) % (self.staleness + 1) == 0

    def _has_residual(self) -> bool:
        # train-thread-only state, like _residual itself (push/refresh/
        # join/leave all run on the training thread; the sender thread
        # ships pre-built payloads and never sees the residual)
        r = self._residual
        return r is not None and any(np.any(v) for ps in r.values()
                                     for v in ps.values())

    def _update_cadence(self) -> None:
        """Sender-thread congestion control (adaptive cadence): escalate
        the payload backoff when the bucket is in deficit or flushes pile
        up behind a slow link; decay it as the link recovers. The factor
        only defers PAYLOAD (intermediate clocks ship as empty partial
        ticks) — clock cadence and liveness are untouched."""
        if not self.adaptive:
            return
        congested = self._q.qsize() >= 2 or (
            self.budget is not None and self.budget.available() < 0)
        with self._stats_lock:
            if congested and self._backoff < self._backoff_cap:
                self._backoff = min(self._backoff * 2, self._backoff_cap)
                self.cadence_backoffs += 1
            elif not congested and self._backoff > 1:
                self._backoff -= 1

    @property
    def cadence_factor(self) -> int:
        with self._stats_lock:
            return self._backoff

    def _managed_payload(self, delta: Dict, clock: int,
                         force_full: bool) -> Tuple[Dict, bool]:
        """Decide what this clock's flush puts on the wire. Returns
        (payload, full): ``full`` means everything through ``clock`` —
        delta plus any carried residual — is in the payload (the durable-
        clock contract). Unlimited budget short-circuits to exactly the
        dense path. Caller is the train thread (push); the residual is
        touched only here and in refresh/join, same thread."""
        if self.budget is None and self._residual is None \
                and not self._wire:
            # today's dense path, byte for byte (counters only)
            if delta:
                with self._stats_lock:
                    self.full_pushes += 1
                    self.pushed_elems += _tree_elems(delta)
            return delta, True
        # fold the carried residual into this clock's update (one
        # elementwise add; sent + new residual reassembles it exactly)
        if self._residual is not None:
            flat = _tree_copy(self._residual)
            if delta:
                _tree_add(flat, delta)
        else:
            flat = delta
        n = _tree_elems(flat)
        if n == 0:
            return {}, True  # pure clock tick, nothing deferred
        full = (force_full or self.budget is None
                or self._is_boundary(clock))
        if not full:
            with self._stats_lock:
                deferring = self._backoff > 1
            if deferring:
                # cadence backoff: park the whole update in the residual,
                # ship a ~100 B clock tick; the next boundary (or a
                # recovered link) carries it
                self._residual = flat
                with self._stats_lock:
                    self.partial_pushes += 1
                    self.deferred_elems += n
                    self.pushed_elems += n
                return {}, False
            est = _tree_nbytes(flat) * _WIRE_RATIO[self._wire]
            if self.budget.available() >= est:
                full = True  # budget comfortable: dense flush
        if full:
            return self._full_flush(flat, n, force_full)
        # budget tight: magnitude-prioritized partial push
        sent, residual, k, n = split_topk(flat, self.priority_frac)
        if k >= n:
            # the fraction selects EVERYTHING (priority_frac=1.0, or a
            # tree so small the 1-entry floor covers it): that is a full
            # flush and must be labeled one — the durable clock advances
            # and no all-zero residual is carried around
            return self._full_flush(flat, n, force_full)
        saved = 0
        if self._wire:
            # TOPK values compress too; the quantization error lands in
            # the residual AT the selected indices (zero there by
            # split_topk's construction), keeping sent + residual == the
            # folded update bitwise
            for l, ps in sent.items():
                for p, t in ps.items():
                    _, idx, vals = t
                    wl, res, wn = _quantize_leaf(vals, self._wire)
                    if np.any(res):
                        residual[l][p].flat[idx] = res
                    ps[p] = ("topk", idx, wl)
                    saved += vals.nbytes - wn
        self._residual = residual
        with self._stats_lock:
            self.partial_pushes += 1
            self.deferred_elems += n - k
            self.pushed_elems += n
            self.wire_bytes_saved += saved
        return sent, False

    def _full_flush(self, flat: Dict, n: int,
                    force_full: bool) -> Tuple[Dict, bool]:
        """One full (durable) flush of the folded update. Compressed to
        the wire dtype EXCEPT under force_full — mark_done/leave/close
        ship exact f32 so a finishing worker leaves no residual behind
        and its anchor contribution is its whole update stream."""
        if self._wire and not force_full:
            payload, self._residual, saved = _quantize_tree(flat,
                                                            self._wire)
            with self._stats_lock:
                self.full_pushes += 1
                self.pushed_elems += n
                self.wire_bytes_saved += saved
            return payload, True
        self._residual = None
        with self._stats_lock:
            self.full_pushes += 1
            self.pushed_elems += n
        return flat, True

    def push(self, delta: Dict, force_full: bool = False) -> int:
        """Flush one clock's accumulated update. Returns the new clock.
        NEVER blocks on the network — the sender thread owns the socket.
        Under a finite budget the payload may be a magnitude-prioritized
        partial push (or an empty tick under cadence backoff); the exact
        complement rides the local residual and is force-flushed at every
        SSP window boundary, ``force_full=True``, leave() and
        mark_done()."""
        self._check_alive()
        with _spans.span("async_push", "async", {"worker": self.worker}):
            self.clock += 1
            payload, full = self._managed_payload(delta, self.clock,
                                                  force_full)
            with self._pending_lock:
                self._pending.append((self.clock, _tree_copy_any(payload),
                                      full))
            self._q.put((self.clock, payload, full))
            return self.clock

    def _drain(self, timeout_s: Optional[float] = None) -> None:
        """Wait until the server ACKED every flushed clock (not merely
        until the queue emptied — the sender may be mid-RPC on the last
        delta, and 'done'/'bye' must not overtake it). The default
        deadline covers a full reconnect-and-replay cycle; expiry RAISES:
        returning quietly here would let mark_done()/close() declare a run
        complete while its final flush is still un-acked — exactly the
        silent update loss this tier exists to rule out."""
        if timeout_s is None:
            timeout_s = self.reconnect_deadline_s + 10.0
        deadline = time.time() + timeout_s
        while self._acked_clock < self.clock:
            self._check_alive()
            if time.time() >= deadline:
                raise RuntimeError(
                    f"worker {self.worker}: drain timed out with clocks "
                    f"{self._acked_clock + 1}..{self.clock} still un-acked "
                    f"after {timeout_s:.1f}s")
            time.sleep(0.005)

    # ---- the SSP read gate ---------------------------------------------- #
    def _min_other_clock(self) -> int:
        """A peer we have not heard from yet counts as clock -1 (nothing
        applied), NOT as caught up — otherwise the gate is unenforced
        until the first ack/refresh arrives. The gate runs over the
        CURRENT member set (admissions join it, retirements leave it);
        FAILED and DONE peers are excluded: a dead or departed worker
        must not deadlock the survivors' gates, and a finished worker's
        frozen clock must not wedge a straggler's last window
        (elasticity; the reference would abort the whole job here).

        The vector gated on is the DURABLE clock (last FULLY-flushed
        clock): under managed communication a peer's raw clock may run
        ahead of the bytes actually in the anchor, and admitting a read
        against it would silently widen the SSP bound by the residual
        age. Dense pushes are always full (durable == raw clock), so the
        dense path gates exactly as before. No deadlock is possible:
        boundaries land every s+1 clocks, so a peer at raw clock c always
        has durable >= c - s — every gate a dense run would pass, a
        managed run passes within the same window."""
        with self._stats_lock:
            durable = self.durable
        others = [durable.get(w, self.clocks.get(w, -1))
                  for w in sorted(self.members)
                  if w != self.worker and w not in self.failed
                  and w not in self.done]
        return min(others) if others else self.clock

    def gate(self, clock: int, poll_s: float = 0.01,
             timeout_s: float = 120.0) -> float:
        """Block until every OTHER worker's applied clock is >= clock - s - 1
        (ssp_consistency_controller.cpp:37-77: a read at clock c must see
        all updates through c - s - 1). Within the window this returns
        immediately — the wait-free property. A peer that dies mid-wait is
        evicted by the service (disconnect detection or liveness timeout)
        and leaves the gate's clock vector, so survivors unblock within
        the liveness timeout instead of hanging to this call's own
        backstop ``timeout_s``."""
        self._check_alive()
        need = clock - self.staleness - 1
        seen = self._min_other_clock()
        if seen >= need:
            self._record_gate(clock, seen)
            return 0.0
        t0 = time.time()
        self.gate_blocks += 1
        with _spans.span("async_gate", "async",
                         {"worker": self.worker, "clock": clock}):
            while (seen := self._min_other_clock()) < need:
                self._check_alive()
                if time.time() - t0 > timeout_s:
                    with self._stats_lock:
                        durable = dict(self.durable)
                    raise TimeoutError(
                        f"worker {self.worker} stuck at gate: need clock "
                        f"{need}, have durable {durable} (raw "
                        f"{self.clocks}; a raw clock ahead of its durable "
                        f"entry = a peer's partial pushes have not "
                        f"boundary-flushed; all stuck = a peer died and "
                        f"eviction is disabled?)")
                resp = self._pull_rpc({"kind": "clocks"})
                self._absorb_view(resp)
                time.sleep(poll_s)
        self._record_gate(clock, seen)
        waited = time.time() - t0
        self.blocked_s += waited
        return waited

    def _record_gate(self, clock: int, seen: int) -> None:
        """Log one PASSED gate for the trace-conformance harness: the
        min peer durable clock the gate actually admitted against.
        ``seen`` is computed by the caller BEFORE taking _stats_lock
        (_min_other_clock acquires it itself — re-entering would
        self-deadlock, THR002's exact shape)."""
        if self._record_events:
            with self._stats_lock:
                self.events.append(("gate", self.worker, clock, seen))

    # ---- cache refresh (read-my-writes) --------------------------------- #
    def refresh(self) -> Tuple[Dict, Dict[int, int]]:
        """Pull the anchor and rebuild the local cache as
        anchor + own-pending-updates-not-yet-applied-by-the-server.

        adarevision mode drains the push queue FIRST: the pull re-bases
        this worker's backlog snapshot at the server (gbase), which is
        only correct once every earlier push has been applied — and the
        pending rebuild scales raw gradients by -init_step (the client-lr
        preview), never adds them raw."""
        self._check_alive()
        with _spans.span("async_pull", "async", {"worker": self.worker}):
            if self.server_logic == "adarevision":
                self._drain()
            snap = self._pull_rpc({"kind": "pull"})
        self._absorb_view(snap)
        applied = self.clocks.get(self.worker, -1)
        cache = snap["anchor"]
        with self._pending_lock:
            self._pending = [(c, d, f) for c, d, f in self._pending
                             if c > applied]
            for _, d, _ in self._pending:
                if self.server_logic == "adarevision":
                    # pending entries are RAW gradients: preview them at
                    # the client-lr estimate, exactly as the worker loop
                    # advanced its cache (normally empty here — the drain
                    # above acked everything, or raised)
                    for l, ps in d.items():
                        for pn, gv in ps.items():
                            cache[l][pn] = cache[l][pn] - \
                                self.init_step * gv
                else:
                    # pending payloads may be sparse partial pushes
                    _tree_add_any(cache, d)
        if self._residual is not None:
            # read-my-writes covers DEFERRED bytes too: the cache is
            # anchor + pending-as-sent + local residual, so this worker's
            # own view never loses the complement a partial push parked
            _tree_add(cache, self._residual)
        return cache, dict(self.clocks)

    def rejoin(self) -> Tuple[Dict, Dict[int, int]]:
        """Rejoin protocol for a RESTARTED worker process: pull the
        anchor, re-seed the local cache from it, and resume at the
        anchor's recorded clock for this worker. Everything the anchor
        applied before the crash is in the snapshot; everything after is
        the bounded update loss of the failure model. The hello this
        client sent at connect already un-evicted the worker server-side.
        Clears the (empty, for a fresh process) local oplog and returns
        (cache, clock_vector); training resumes at ``self.clock + 1``."""
        snap = self._pull_rpc({"kind": "pull"})
        self._absorb_view(snap)
        applied = self.clocks.get(self.worker, -1)
        self.clock = applied
        self._acked_clock = applied
        self._residual = None  # a fresh process has no deferred bytes
        with self._pending_lock:
            self._pending = []
        return snap["anchor"], dict(self.clocks)

    def join(self) -> Tuple[Dict, Dict[int, int]]:
        """Elastic join: rendezvous with a live job via the ``admit`` RPC.
        The service picks the join clock (the anchor clock — min applied
        clock over live members) and hands back the anchor + clock table +
        member list; this client seeds its cache from the anchor and
        resumes flushing at ``join_clock + 1``. For an id that is already
        a member this degenerates to :meth:`rejoin` (resume at the applied
        clock), so the engine tier calls ONE method for fresh workers,
        restarts, and true mid-run admissions alike. Returns
        (cache, clock_vector)."""
        with _spans.span("async_admit", "async", {"worker": self.worker}):
            snap = self._pull_rpc({"kind": "admit", "worker": self.worker})
        self._absorb_view(snap)
        join = int(snap.get("join_clock",
                            self.clocks.get(self.worker, -1)))
        self.clock = join
        self._acked_clock = join
        self._residual = None
        with self._pending_lock:
            self._pending = []
        return snap["anchor"], dict(self.clocks)

    def poll_view(self) -> Dict[int, int]:
        """One ``clocks`` RPC + view absorb (the same exchange the gate
        polls with): returns the service's raw applied-clock table. A
        successor slice leader re-derives its acked floor from this — the
        service, not the dead leader's memory, is the source of truth for
        which clocks landed."""
        resp = self._pull_rpc({"kind": "clocks"})
        self._absorb_view(resp)
        return dict(self.clocks)

    def resume_oplog(self, clock: int,
                     pending: Sequence[Tuple[int, Dict, bool]],
                     residual: Optional[Dict]) -> int:
        """Leader-failover resume (parallel/fabric.py): install a slice's
        replicated ledger into a FRESH client for the same worker id and
        resume its push stream exactly where the dead leader left it.

        The acked floor is re-derived from the SERVICE (pushes are applied
        in clock order, so every ledgered clock at or below the service's
        raw applied clock landed; anything above must replay). The replay
        rides the ordinary sender queue with ``seq == clock``, so a push
        whose ack died with the old leader dedups server-side — the seq
        high-water mark makes failover exactly-once with zero new
        protocol cases. The residual (managed communication's deferred
        complement) is restored verbatim: the bytes a partial push parked
        are slice state, not a single process's, and a failover must not
        drop them. Returns the acked floor.

        Must be called before the first push on this client (a fresh
        client off the constructor — the fabric's failover path)."""
        applied = self.poll_view().get(self.worker, -1)
        self._acked_clock = applied
        self.clock = max(clock, applied)
        self._residual = (_tree_copy(residual)
                          if residual is not None else None)
        backlog = [(c, _tree_copy_any(d), f) for c, d, f in pending
                   if c > applied]
        backlog.sort(key=lambda e: e[0])
        with self._pending_lock:
            self._pending = list(backlog)
        for item in backlog:
            self._q.put(item)
        return applied

    def snapshot_oplog(self) -> Tuple[int, List[Tuple[int, Dict, bool]],
                                      Optional[Dict]]:
        """Replication hook for parallel/fabric.py: a deep copy of the
        state a successor leader needs to resume this push stream —
        (clock, pending payloads AS SENT, residual). Mirrored into the
        slice ledger after every push; in-process it is shared memory.
        Must be called from the train thread (the residual's owner)."""
        with self._pending_lock:
            pending = [(c, _tree_copy_any(d), f)
                       for c, d, f in self._pending]
        resid = (_tree_copy(self._residual)
                 if self._residual is not None else None)
        return self.clock, pending, resid

    def abandon(self) -> None:
        """Kill this client AS IF its process died: stop the sender and
        close the raw sockets with no residual flush, no drain, no bye.
        The failover path in parallel/fabric.py uses this to retire the
        DEAD leader's client object — a clean close() would flush state a
        dead process could never have flushed, quietly shrinking the very
        window the ledger replay exists to cover. The service sees an
        ordinary disconnect; the successor's hello un-evicts the slice."""
        self._stop.set()
        for s in (self._push_sock, self._pull_sock):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self._sender.join(timeout=5.0)

    def leave(self) -> None:
        """Deliberate scale-down: flush any deferred residual (a retiring
        worker's parked bytes must reach the anchor — bounded loss is the
        FAILURE model, not the shutdown model), drain every flushed clock
        (the retire must not overtake a delta still in flight), then
        retire this worker's slot — survivors' gates stop waiting on it
        immediately, with no liveness timeout involved."""
        if self._has_residual():
            self.push({}, force_full=True)
        self._drain()
        resp = self._pull_rpc({"kind": "retire", "worker": self.worker})
        if isinstance(resp, dict) and "clocks" in resp:
            self._absorb_view(resp)

    def mark_done(self) -> None:
        """Tell the service this worker's run is complete (not a barrier)."""
        # any deferred residual flushes first (one forced-full clock tick:
        # a completed run's anchor contribution must be its WHOLE update
        # stream), then every flushed clock must be ACKED: 'done' must not
        # overtake the final delta still in flight on the push socket
        if self._has_residual():
            self.push({}, force_full=True)
        self._drain()
        self._pull_rpc({"kind": "done", "worker": self.worker})

    def wait_all_done(self, n_workers: Optional[int] = None,
                      timeout_s: float = 300.0) -> Tuple[set, set]:
        """Poll until every worker reported done OR was declared failed
        (driver-side, rank 0). ``n_workers=None`` waits on the CURRENT
        member set instead of a fixed count — under elastic membership
        the launch-time roster is stale by construction (admitted workers
        must be waited for, retired slots must not be). Returns
        (done, failed) so the caller can SURFACE a lossy run — elasticity
        keeps the job alive, it must never keep a partial result quiet."""
        t0 = time.time()
        while True:
            snap = self._pull_rpc({"kind": "pull"})
            done = set(snap.get("done", ()))
            failed = set(snap.get("failed", ()))
            if n_workers is None:
                # finished when every member is accounted done or failed
                # (retired slots already left the member list)
                active = set(snap.get("members", ())) - failed - done
                if not active:
                    return done, failed
            elif len(done | failed) >= n_workers:
                return done, failed
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"only {sorted(done)} finished "
                                   f"({sorted(failed)} failed)")
            time.sleep(0.05)

    def comm_counters(self) -> Dict[str, float]:
        """Per-link managed-communication telemetry for the engine's
        display line, stats.yaml and the metrics endpoint
        (runtime/comm_stats.managed_comm_counters)."""
        with self._stats_lock:
            pushed = self.pushed_elems
            out = {
                "bytes_sent": float(self.bytes_sent),
                "bytes_recv": float(self.bytes_recv),
                "deferred_fraction": (self.deferred_elems / pushed
                                      if pushed else 0.0),
                "effective_mbps": round(self._goodput_mbps, 3),
                "cadence_backoffs": float(self.cadence_backoffs),
                "partial_pushes": float(self.partial_pushes),
                "full_pushes": float(self.full_pushes),
                # f32 bytes the wire dtype kept OFF the link (0 with
                # compression off) — the [comm] line and stats.yaml gauge
                "wire_bytes_saved": float(self.wire_bytes_saved),
            }
        return out

    def close(self) -> None:
        # flush any deferred residual, then drain so the last clock's
        # update lands before bye (tolerate a dead sender here — close()
        # runs on failure paths too, where the parked bytes become the
        # failure model's bounded loss)
        try:
            if self._has_residual():
                self.push({}, force_full=True)
            self._drain()
        except RuntimeError:
            pass
        self._stop.set()
        self._sender.join(timeout=5.0)
        for s in (self._push_sock, self._pull_sock):
            try:
                _send_msg(s, {"kind": "bye"})
                _recv_msg(s)
            except (OSError, ConnectionError, EOFError):
                pass
            s.close()


# --------------------------------------------------------------------------- #
# worker driver
# --------------------------------------------------------------------------- #

def run_async_ssp_worker(
    worker: int,
    n_workers: int,
    params: Dict,
    local_step: Callable[[Dict, int], Tuple[Dict, float]],
    n_clocks: int,
    staleness: int,
    service_addr: Optional[Tuple[str, int]] = None,
    service: Optional[ParamService] = None,
    sync_every: int = 1,
    refresh_every: int = 1,
    slow_s: float = 0.0,
    server_logic: str = "inc",
    init_step: float = 0.1,
    rejoin: bool = False,
    join: bool = False,
    retire_at_clock: Optional[int] = None,
    client_opts: Optional[Dict] = None,
) -> Dict:
    """Drive one worker through ``n_clocks`` flush clocks.

    ``server_logic="inc"`` (default): ``local_step(cache, step_index) ->
    (new_params, loss)`` is the process-local compiled step; the flushed
    increment is the parameter delta it produced.

    ``server_logic="adarevision"``: ``local_step(cache, step_index) ->
    (grads, loss)`` returns RAW gradients; the flush carries their sum and
    the SERVER owns the learning rate (the delay-corrected AdaGrad rule).
    The local preview advances by ``-init_step * grads`` — the client-side
    lr estimate the reference's process storage uses between refreshes;
    every refresh replaces it with the server's revised view.

    ``rejoin=True`` is the restart path: seed the cache from the service
    anchor and resume at the anchor's recorded clock for this worker
    (``params`` is then only a shape/typing fallback). ``join=True`` is
    the ELASTIC path: a worker id outside the launch roster rendezvous
    with the live job via the admit RPC and trains from the service's
    join clock. ``retire_at_clock`` scales DOWN: after flushing that
    clock the worker drains, retires its slot (survivors' gates stop
    waiting on it), and returns early. ``client_opts`` forwards
    fault-tolerance knobs (heartbeat_s, reconnect_deadline_s, backoff_*)
    to :class:`AsyncSSPClient`.

    This driver owns only the DCN-tier exchange: gate -> step(s) -> push ->
    refresh. ``slow_s`` injects per-clock straggler delay (test harness).
    Returns the final cache + telemetry."""
    if service is not None:
        addr = ("127.0.0.1", service.port)
    else:
        addr = service_addr
    cli = AsyncSSPClient(worker, addr, staleness, n_workers=n_workers,
                         server_logic=server_logic, init_step=init_step,
                         **(client_opts or {}))
    adarev = server_logic == "adarevision"
    losses = []
    start_clock = 0
    retired = False
    if join:
        cache, _ = cli.join()
        start_clock = cli.clock + 1
    elif rejoin:
        cache, _ = cli.rejoin()
        start_clock = cli.clock + 1
    else:
        cache = _tree_copy(params)
    t_start = time.time()
    try:
        for clock in range(start_clock, n_clocks):
            cli.gate(clock)
            if slow_s:
                time.sleep(slow_s)
            if adarev:
                u = None
                for k in range(sync_every):
                    g, loss = local_step(cache, clock * sync_every + k)
                    if u is None:
                        u = _tree_copy(g)
                    else:
                        _tree_add(u, g)
                    for l, ps in g.items():
                        for p, gv in ps.items():
                            cache[l][p] = cache[l][p] - init_step * gv
                losses.append(float(loss))
                cli.push(u)
            else:
                before = _tree_copy(cache)
                for k in range(sync_every):
                    cache, loss = local_step(cache,
                                             clock * sync_every + k)
                losses.append(float(loss))
                cli.push(_tree_sub(cache, before))
            if retire_at_clock is not None and clock >= retire_at_clock:
                cli.leave()
                retired = True
                break
            if (clock + 1) % refresh_every == 0:
                cache, _ = cli.refresh()
        wall = time.time() - t_start
        if not retired:
            cli.mark_done()
        return {"params": cache, "losses": losses,
                "blocked_s": cli.blocked_s, "gate_blocks": cli.gate_blocks,
                "wall_s": wall, "final_clock": cli.clock,
                "reconnects": cli.reconnects, "start_clock": start_clock,
                "retired": retired,
                # recorded gate admissions (empty unless client_opts set
                # record_events) for the model checker's conformance
                # harness — the client object dies with close() below
                "events": list(cli.events)}
    finally:
        cli.close()
