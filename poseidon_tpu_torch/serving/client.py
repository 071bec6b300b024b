"""Blocking serving client + load generator (the port of
``poseidon_tpu/serving/client.py``, same wire protocol: infer, generate,
stats, health and reload; closed- and open-loop load).

A connection that dies mid-request is redialed and the request RESENT with
capped exponential backoff and full jitter (``runtime/retry.py``), which is
safe because ``infer`` is read-only (and a resent ``generate`` restarts
its sequence: streamed chunks are cumulative). A shed reply is the
server's explicit backpressure signal and surfaces as
:class:`ServingError` with ``shed=True``; retrying into a full queue is the
caller's decision.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..proto.wire import (WIRE_CODEC_VERSION, mark_codec_socket, recv_frame,
                          send_frame)
from ..runtime.metrics import LatencyWindow
from ..runtime.retry import retry_with_backoff

__all__ = ["ServingClient", "ServingError", "run_load"]


class ServingError(RuntimeError):
    """A structured refusal from the server (shed / deadline / bad
    request). ``shed`` and ``deadline_exceeded`` mirror the reply flags."""

    def __init__(self, message: str, *, shed: bool = False,
                 deadline_exceeded: bool = False):
        super().__init__(message)
        self.shed = shed
        self.deadline_exceeded = deadline_exceeded


class ServingClient:
    """One connection, blocking RPCs, transparent reconnect-and-resend."""

    def __init__(self, addr: Tuple[str, int], connect_deadline_s: float = 10.0,
                 retry_deadline_s: float = 10.0,
                 backoff_base_s: float = 0.02, backoff_cap_s: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.addr = tuple(addr)
        self.retry_deadline_s = retry_deadline_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = rng or random.Random()
        self.reconnects = 0
        self._sock = retry_with_backoff(
            self._dial, deadline=connect_deadline_s, base=backoff_base_s,
            cap=backoff_cap_s, rng=self._rng, retry_on=(OSError, EOFError))

    def _dial(self) -> socket.socket:
        sk = socket.create_connection(self.addr, timeout=5.0)
        # codec negotiation, re-run per dial (marking is per socket); a
        # server without the codec answers {"ok": False} and this client
        # stays on the pickle wire
        try:
            send_frame(sk, {"kind": "wire", "codec": WIRE_CODEC_VERSION},
                       codec=False)
            ack = recv_frame(sk)
            if isinstance(ack, dict) and ack.get("ok") \
                    and ack.get("codec") == WIRE_CODEC_VERSION:
                mark_codec_socket(sk)
        except BaseException:
            sk.close()
            raise
        sk.settimeout(None)   # established: block (slow != dead)
        return sk

    def _rpc(self, msg: Dict, on_tokens: Optional[Callable] = None) -> Dict:
        """Send one request and return its reply. With ``on_tokens``, the
        ``gen_chunk`` frames before the reply feed it; a resend stays safe
        mid-stream because each chunk carries the CUMULATIVE tokens, so a
        restarted generation replays the prefix."""
        def exchange(sock: socket.socket) -> Dict:
            send_frame(sock, msg)
            while True:
                reply = recv_frame(sock)
                if on_tokens is None or not isinstance(reply, dict) \
                        or reply.get("kind") != "gen_chunk":
                    return reply
                try:
                    on_tokens([int(t) for t in reply["tokens"]])
                except Exception:  # noqa: BLE001 — a broken sink must not
                    pass           # kill the stream consumption

        try:
            return exchange(self._sock)
        except (OSError, EOFError) as e:
            first_err = e

        def attempt() -> Dict:
            sk = self._dial()
            try:
                out = exchange(sk)
            except BaseException:
                sk.close()
                raise
            old, self._sock = self._sock, sk
            try:
                old.close()
            except OSError:
                pass
            return out

        try:
            reply = retry_with_backoff(
                attempt, deadline=self.retry_deadline_s,
                base=self.backoff_base_s, cap=self.backoff_cap_s,
                rng=self._rng, retry_on=(OSError, EOFError))
        except (OSError, EOFError) as e:
            raise ConnectionError(
                f"server unreachable after {self.retry_deadline_s}s "
                f"(first error: {type(first_err).__name__}: {first_err})"
            ) from e
        self.reconnects += 1
        return reply

    @staticmethod
    def _outputs(reply: Dict):
        if not reply.get("ok"):
            raise ServingError(
                str(reply.get("error", "request refused")),
                shed=bool(reply.get("shed")),
                deadline_exceeded=bool(reply.get("deadline_exceeded")))
        return reply["outputs"]

    # ---- ops -------------------------------------------------------------- #
    def generate(self, prompt, max_new: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_tokens: Optional[Callable] = None) -> Dict:
        """LLM decode: returns ``{"tokens", "n_new", "prompt_len"}``.
        ``on_tokens`` (optional) turns on streaming: it is called with the
        cumulative generated-token list as decode progresses."""
        inputs: Dict = {"prompt": np.asarray(prompt, np.int32)}
        if max_new is not None:
            inputs["max_new"] = int(max_new)
        if eos_id is not None:
            inputs["eos_id"] = int(eos_id)
        msg: Dict = {"kind": "generate", "inputs": inputs}
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        if on_tokens is not None:
            msg["stream"] = True
        return self._outputs(self._rpc(msg, on_tokens))

    def infer(self, inputs: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None) -> Dict[str, np.ndarray]:
        msg: Dict = {"kind": "infer", "inputs": inputs}
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        return self._outputs(self._rpc(msg))

    def stats(self) -> Dict:
        reply = self._rpc({"kind": "stats"})
        if not reply.get("ok"):
            raise ServingError(str(reply.get("error", "stats refused")))
        return reply["stats"]

    def health(self) -> Dict:
        return self._rpc({"kind": "health"})

    def reload(self) -> Dict:
        """One hot-reload poll on the server now; its reply as it is."""
        return self._rpc({"kind": "reload"})

    def close(self) -> None:
        try:
            send_frame(self._sock, {"kind": "bye"})
        except (OSError, EOFError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def run_load(addr: Tuple[str, int],
             make_inputs: Callable[[int], Dict[str, np.ndarray]],
             n_requests: int = 200, concurrency: int = 4,
             deadline_ms: Optional[float] = None,
             offered_rps: Optional[float] = None,
             op: str = "infer") -> Dict:
    """Drive ``n_requests`` requests through ``concurrency`` persistent
    client connections; returns p50/p99/mean latency, goodput and
    shed/deadline/error counts (sheds are counted, never retried).

    Two load models:

    - **closed loop** (``offered_rps=None``): each connection fires its
      next request when the previous reply lands, so the load throttles
      itself to what the server sustains;
    - **open loop** (``offered_rps=R``): request i has the fixed arrival
      time ``t0 + i/R``, whatever the replies do. A connection sleeps
      until its request's slot; one still waiting on a reply when its next
      slot passes fires late, and is COUNTED (``late_fires``: nonzero
      means the concurrency could not realize the offered rate). The
      summary gains ``offered_rps``, ``achieved_rps`` (requests sent a
      second) and ``late_fires``.

    ``op="generate"`` drives the LLM decode op: ``make_inputs(i)`` then
    returns ``ServingClient.generate`` keyword arguments (prompt, max_new,
    eos_id, on_tokens) and the summary gains ``tokens`` and
    ``goodput_tps`` (generated tokens per second over accepted
    requests)."""
    if op not in ("infer", "generate"):
        raise ValueError(f"op must be infer|generate, got {op!r}")
    if offered_rps is not None and offered_rps <= 0:
        # a zero rate would divide by zero in every worker thread
        raise ValueError(f"offered_rps must be > 0, got {offered_rps}")
    lat = LatencyWindow(maxlen=max(2048, n_requests))
    counters = {"ok": 0, "shed": 0, "deadline": 0, "error": 0}
    tokens = {"v": 0}
    late = {"v": 0}
    counters_lock = threading.Lock()
    next_i = {"v": 0}
    t_start = time.monotonic()

    def worker() -> None:
        cli = ServingClient(addr)
        try:
            while True:
                with counters_lock:
                    i = next_i["v"]
                    if i >= n_requests:
                        return
                    next_i["v"] = i + 1
                if offered_rps is not None:
                    slot = t_start + i / offered_rps
                    lag = time.monotonic() - slot
                    if lag < 0:
                        time.sleep(-lag)
                    elif lag > 0.5 / offered_rps:
                        # past its slot by over half a period: the open
                        # loop is partially closed
                        with counters_lock:
                            late["v"] += 1
                t0 = time.monotonic()
                try:
                    if op == "generate":
                        out = cli.generate(deadline_ms=deadline_ms,
                                           **make_inputs(i))
                        with counters_lock:
                            tokens["v"] += int(out.get("n_new", 0))
                    else:
                        cli.infer(make_inputs(i), deadline_ms=deadline_ms)
                    lat.record(time.monotonic() - t0)
                    key = "ok"
                except ServingError as e:
                    key = ("shed" if e.shed else
                           "deadline" if e.deadline_exceeded else "error")
                except (ConnectionError, OSError):
                    key = "error"
                with counters_lock:
                    counters[key] += 1
        finally:
            cli.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.monotonic() - t_start, 1e-9)
    summary = lat.summary()
    out = {
        **counters,
        "requests": n_requests,
        "concurrency": concurrency,
        "wall_s": wall,
        "throughput_rps": counters["ok"] / wall,
        "goodput_rps": counters["ok"] / wall,
        "p50_ms": summary.get("p50_ms"),
        "p99_ms": summary.get("p99_ms"),
        "mean_ms": summary.get("mean_ms"),
    }
    if op == "generate":
        out.update(tokens=tokens["v"], goodput_tps=tokens["v"] / wall)
    if offered_rps is not None:
        out.update(offered_rps=float(offered_rps),
                   achieved_rps=sum(counters.values()) / wall,
                   late_fires=late["v"])
    return out
