"""Deterministic fault injection for the host-driven socket tier (the
port's copy of ``poseidon_tpu/runtime/faults.py``).

A loopback TCP proxy that sits between an :class:`AsyncSSPClient` (or any
socket peer) and the upstream service, applying explicit, reproducible
fault rules per accepted connection — the chaos-test substrate for the
tier's liveness/eviction/reconnect protocol. Nothing here is random: rules
match on the accepted-connection index and cut on exact byte counts, so a
chaos test replays identically run after run (the analog of the
deterministic CPU process groups for the parallel strategies).

Rules (:class:`FaultRule`):

- ``drop``     — accept, then close immediately: the peer's connect()
                 succeeds but its first read/write sees EOF/RST. Models a
                 service behind a dead load-balancer slot; exercises the
                 client's backoff-and-redial loop.
- ``delay``    — forward both directions, adding ``delay_s`` at the
                 ``delay_per`` billing granularity: ``"chunk"`` (legacy:
                 once per 64 KB read — a large frame pays it many times),
                 ``"frame"`` (once per length-prefixed wire frame — one
                 rule models the SAME latency for small and large frames;
                 tracks proto/wire.py's 8-byte big-endian framing, so do
                 not combine with the raw-byte auth preamble), or
                 ``"once"`` (once per connection direction — pure
                 connection-setup latency). Models a congested DCN hop;
                 exercises that slow != dead (heartbeats keep the worker
                 un-evicted).
- ``throttle`` — token-bucket bytes/sec shaping PER DIRECTION
                 (``rate_bps`` refill, ``burst_bytes`` capacity): each
                 pump sleeps exactly long enough that its cumulative
                 forwarded bytes never exceed the budget. The
                 deterministic substrate for bandwidth-constrained-link
                 chaos (managed communication's A/B and throttled-fleet
                 scenarios are reproducible run after run).
- ``truncate`` — forward exactly ``after_bytes`` of client->server
                 payload, then hard-close both sides. The upstream sees a
                 mid-message EOF (a torn frame); exercises the service's
                 FrameError containment + the client's replay.
- ``sever``    — same cut mechanics as truncate (``after_bytes`` of
                 client->server traffic, 0 = on first activity), named for
                 intent: a hard mid-run partition.

Any rule can be made ONE-SHOT with ``nth=N``: it fires on exactly the Nth
connection that passes its other filters, then expires — the targeting
mode the elasticity chaos suite uses to kill a specific handshake (e.g.
"sever precisely the admit rendezvous, not the dials before it").

Runtime controls: :meth:`FaultProxy.sever_all` hard-drops every live
connection at once (worker preemption / network partition mid-run);
:meth:`FaultProxy.sever_group` hard-drops every live connection belonging
to a worker-id SET in one atomic event (a whole slice preempted at once —
the two-tier fabric's failure unit); :meth:`FaultProxy.refuse_new`
black-holes reconnect attempts (the partition persists) until lifted.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

__all__ = ["FaultRule", "FaultProxy"]

# worker-id sniffing gives up on any first frame bigger than this (a data
# frame on a connection that skipped the hello — never the in-repo client)
_SNIFF_CAP = 1 << 20


@dataclass
class _Pair:
    """One live proxied connection. ``worker`` is discovered from the
    client's first wire frame (the ``hello`` every AsyncSSPClient sends on
    every socket) so group-targeted faults can address connections by the
    worker they serve, not by accept order. Token-authenticated links put
    a raw-byte HMAC preamble before the first frame, so — like the
    per-frame delay billing — worker tagging assumes token-free links
    (the chaos suites' configuration); an unparsable first frame just
    leaves the pair untagged."""

    client: socket.socket
    upstream: socket.socket
    worker: Optional[int] = None
    sniff: bytes = b""
    sniffed: bool = False


@dataclass
class FaultRule:
    """One deterministic fault. ``conn`` matches the nth accepted
    connection (0-based; None = every connection); ``max_conns`` expires
    the rule after it has matched that many connections (None = never).

    ``nth`` is the ONE-SHOT targeting mode: the rule fires on exactly the
    Nth (0-based) connection that passes its other filters, then expires
    forever — connections before the Nth pass through untouched and do
    not consume the rule. ``conn`` can only address an absolute accepted
    index and ``max_conns`` only a leading prefix, so neither can express
    "kill specifically the 3rd connection from now" — e.g. the rejoin or
    admit handshake of a worker whose earlier dials already consumed
    unpredictable indices. ``nth`` can."""

    action: str = "sever"       # drop | delay | truncate | sever | throttle
    conn: Optional[int] = None
    after_bytes: int = 0           # truncate/sever: client->server budget
    delay_s: float = 0.0           # delay: added latency per billing unit
    delay_per: str = "chunk"       # delay billing: chunk | frame | once
    rate_bps: float = 0.0          # throttle: bytes/sec per direction
    burst_bytes: int = 65536       # throttle: token-bucket capacity
    max_conns: Optional[int] = None
    nth: Optional[int] = None      # one-shot: fire on the Nth match only
    hits: int = field(default=0, repr=False)  # connections matched so far
    seen: int = field(default=0, repr=False)  # candidates examined (nth)
    expired: bool = field(default=False, repr=False)  # nth fired already

    def __post_init__(self):
        if self.action not in ("drop", "delay", "truncate", "sever",
                               "throttle"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.nth is not None and self.nth < 0:
            raise ValueError(f"nth must be >= 0, got {self.nth}")
        if self.delay_per not in ("chunk", "frame", "once"):
            raise ValueError(f"unknown delay_per {self.delay_per!r}")
        if self.action == "throttle" and self.rate_bps <= 0:
            raise ValueError("throttle needs rate_bps > 0")


class FaultProxy:
    """Loopback TCP proxy with per-connection fault rules (port 0 bind —
    no fixed ports, no flakes). ``proxy.addr`` is what the client dials."""

    def __init__(self, upstream: Tuple[str, int], host: str = "127.0.0.1",
                 port: int = 0):
        self.upstream = upstream
        self._rules: List[FaultRule] = []
        self._lock = threading.Lock()
        self._pairs: List[_Pair] = []
        self.accepted = 0      # connections accepted (rule index space)
        self.dropped = 0       # connections refused (drop rule/refuse_new)
        self.bytes_c2s = 0
        self.bytes_s2c = 0
        self._refusing = False
        self._stop = threading.Event()
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self.addr = (host, self.port)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()

    # ---- rule management ------------------------------------------------ #
    def add_rule(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear_rules(self) -> None:
        with self._lock:
            self._rules.clear()

    def refuse_new(self, refusing: bool = True) -> None:
        """Black-hole (accept+close) every NEW connection until lifted —
        the persistent half of a partition; live pairs are untouched."""
        self._refusing = refusing

    def sever_all(self) -> int:
        """Hard-close every live connection pair at once (both sides, both
        directions) — the instantaneous half of a partition. Returns how
        many pairs were cut."""
        with self._lock:
            pairs, self._pairs = self._pairs, []
        return self._cut(pairs)

    def sever_group(self, worker_ids: Iterable[int]) -> int:
        """Hard-close every live connection whose identified worker id is
        in ``worker_ids``, as ONE atomic event: the victim set is chosen
        under the lock, so a chaos test killing a whole slice (every
        member's push + pull channel at once) cannot race per-link
        ``sever_all`` calls against the victims' reconnect loops — the
        deterministic analog of a slice preemption. Connections whose
        hello frame has not yet crossed the proxy carry no worker tag and
        are never matched (sever them by killing the slice AFTER its
        first exchange, the way the fabric chaos suite does). Returns how
        many pairs were cut."""
        ids = frozenset(worker_ids)
        with self._lock:
            cut = [p for p in self._pairs if p.worker in ids]
            self._pairs = [p for p in self._pairs if p.worker not in ids]
        return self._cut(cut)

    @staticmethod
    def _cut(pairs: List[_Pair]) -> int:
        for p in pairs:
            for s in (p.client, p.upstream):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        return len(pairs)

    def _match(self, idx: int) -> Optional[FaultRule]:
        with self._lock:
            for r in self._rules:
                if r.expired:
                    continue
                if r.conn is not None and r.conn != idx:
                    continue
                if r.max_conns is not None and r.hits >= r.max_conns:
                    continue
                if r.nth is not None:
                    # one-shot targeting: count candidates deterministically;
                    # only the Nth consumes (and expires) the rule — earlier
                    # candidates pass through and may match LATER rules
                    k = r.seen
                    r.seen += 1
                    if k != r.nth:
                        continue
                    r.expired = True
                r.hits += 1
                return r
        return None

    # ---- data plane ----------------------------------------------------- #
    def _accept_loop(self) -> None:
        self._srv.settimeout(0.1)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # refusal is handled BEFORE the connection enters the rule
            # index space: a refused connection must consume neither a
            # rule's conn index nor its max_conns budget, or rule firing
            # would depend on how many retries land inside the refusal
            # window — goodbye determinism
            if self._refusing:
                self.dropped += 1
                conn.close()
                continue
            idx = self.accepted
            self.accepted += 1
            rule = self._match(idx)
            if rule is not None and rule.action == "drop":
                self.dropped += 1
                conn.close()
                continue
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                conn.close()
                continue
            pair = _Pair(conn, up)
            with self._lock:
                self._pairs.append(pair)
            for src, dst, c2s in ((conn, up, True), (up, conn, False)):
                threading.Thread(target=self._pump,
                                 args=(src, dst, rule, c2s, pair),
                                 daemon=True).start()

    def _sniff_worker(self, pair: _Pair, data: bytes) -> None:
        """Walk the FIRST client->server wire frame (8-byte big-endian
        length + pickled payload — the client's hello) and tag the pair
        with its worker id. One-shot: success, an oversized frame, or an
        unparsable payload all end sniffing for the connection."""
        with self._lock:
            if pair.sniffed:
                return
            pair.sniff += data
            buf = pair.sniff
            if len(buf) < 8:
                return
            (ln,) = struct.unpack("!Q", buf[:8])
            if ln > _SNIFF_CAP:
                pair.sniffed, pair.sniff = True, b""
                return
            if len(buf) < 8 + ln:
                return
            pair.sniffed = True
            payload, pair.sniff = buf[8:8 + ln], b""
            try:
                msg = pickle.loads(payload)
                if isinstance(msg, dict) and isinstance(
                        msg.get("worker"), int):
                    pair.worker = msg["worker"]
            except Exception:  # noqa: BLE001 — not a hello; stay untagged
                pass

    def _pump(self, src: socket.socket, dst: socket.socket,
              rule: Optional[FaultRule], c2s: bool,
              pair: Optional[_Pair] = None) -> None:
        budget = None
        if rule is not None and rule.action in ("truncate", "sever") and c2s:
            budget = max(0, rule.after_bytes)
        forwarded = 0
        # delay billing state: "frame" walks the length-prefixed framing
        # (8-byte big-endian header + payload) through the byte stream and
        # bills delay_s once per frame STARTED in a chunk; "once" bills a
        # single time per direction; "chunk" is the legacy per-read bill
        delaying = (rule is not None and rule.action == "delay"
                    and rule.delay_s > 0)
        fr_hdr = b""        # partial header bytes accumulated
        fr_left = 0         # payload bytes remaining in the current frame
        delayed_once = False
        # throttle state: one token bucket PER DIRECTION (each pump call
        # is one direction), deficit model — overdraft sleeps exactly the
        # time the budget needs to cover it, so cumulative goodput is
        # deterministically <= burst + rate * elapsed. Reuses the managed-
        # communication TokenBucket (parallel/async_ssp.py) so
        # the shaping arithmetic and the client's accounting arithmetic
        # can never drift apart.
        throttling = rule is not None and rule.action == "throttle"
        if throttling:
            from ..parallel.async_ssp import TokenBucket
            bucket = TokenBucket(rule.rate_bps,
                                 burst_bytes=float(rule.burst_bytes))
        try:
            while not self._stop.is_set():
                data = src.recv(65536)
                if not data:
                    break
                if c2s and pair is not None and not pair.sniffed:
                    self._sniff_worker(pair, data)
                if delaying:
                    if rule.delay_per == "chunk":
                        time.sleep(rule.delay_s)
                    elif rule.delay_per == "once":
                        if not delayed_once:
                            delayed_once = True
                            time.sleep(rule.delay_s)
                    else:  # per frame
                        frames = 0
                        i = 0
                        while i < len(data):
                            if fr_left == 0:
                                take = min(8 - len(fr_hdr), len(data) - i)
                                fr_hdr += data[i:i + take]
                                i += take
                                if len(fr_hdr) == 8:
                                    frames += 1
                                    (fr_left,) = struct.unpack("!Q", fr_hdr)
                                    fr_hdr = b""
                            else:
                                take = min(fr_left, len(data) - i)
                                fr_left -= take
                                i += take
                        if frames:
                            time.sleep(rule.delay_s * frames)
                if throttling:
                    bucket.consume(len(data))
                    deficit = -bucket.available()
                    if deficit > 0:
                        # sleep off the deficit before forwarding: bytes
                        # only ever cross at <= the shaped rate (the
                        # bucket refills during the sleep)
                        time.sleep(deficit / rule.rate_bps)
                if budget is not None and forwarded + len(data) >= budget:
                    cut = data[:budget - forwarded]
                    if cut:
                        dst.sendall(cut)
                        self.bytes_c2s += len(cut)
                    break  # -> finally closes BOTH sides: the torn frame
                dst.sendall(data)
                forwarded += len(data)
                if c2s:
                    self.bytes_c2s += len(data)
                else:
                    self.bytes_s2c += len(data)
        except OSError:
            pass
        finally:
            # closing both sockets finishes the sibling pump too — a cut is
            # always a FULL connection loss, never a half-open zombie
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            with self._lock:
                self._pairs = [p for p in self._pairs
                               if p.client is not src
                               and p.client is not dst]

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self.sever_all()
