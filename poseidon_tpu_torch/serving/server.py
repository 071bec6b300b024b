"""Threaded socket front-end for the serving tier (the single-executor path
of ``poseidon_tpu/serving/server.py``, same wire protocol).

A corrupt peer (torn frame, garbage header, undecodable payload) gets ITS
connection logged and dropped; everyone else keeps being served. One thread
per connection; request concurrency is what feeds the micro-batcher.

Request protocol (one frame per message):

- ``{"kind": "wire", "codec": 1}`` -> binary tensor codec negotiation;
- ``{"kind": "infer", "inputs": {name: ndarray}, "deadline_ms": float?}``
  -> ``{"ok": True, "outputs": {...}}``; ``{"ok": False, "shed": True}``
  under backpressure; ``{"ok": False, "deadline_exceeded": True}`` when the
  deadline expired in queue; ``{"ok": False, "error": ...}`` on malformed
  inputs;
- ``{"kind": "generate", "inputs": {"prompt": int array, "max_new": int?,
  "eos_id": int?}, "deadline_ms": float?, "stream": bool?}`` -> ``{"ok":
  True, "outputs": {"tokens", "n_new", "prompt_len"}}`` from an executor
  that brings its own scheduler (``GenerateExecutor.make_batcher``); with
  ``stream`` the reply is preceded by ``{"kind": "gen_chunk", "tokens":
  int32 array}`` frames carrying the cumulative tokens so far;
- ``{"kind": "stats"}`` -> latency percentiles, queue depth, batch fill,
  shed count;
- ``{"kind": "health"}`` -> ``{"ok": True, "draining": bool}``;
- ``{"kind": "bye"}`` -> close this connection.

Because the protocol is the JAX package's, either package's client talks
to either package's server. Shutdown drains: ``shutdown()`` stops
accepting, lets the batcher finish every admitted request, and waits for
their replies to hit the wire.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..proto.wire import (WIRE_CODEC_VERSION, FrameError, mark_codec_socket,
                          recv_frame, send_frame)
from ..runtime.metrics import StatsRegistry, log
from .batcher import DeadlineError, DynamicBatcher, ShedError

__all__ = ["InferenceServer"]


class InferenceServer:
    """Serve a :class:`BucketedExecutor` (micro-batched ``infer``) or a
    :class:`GenerateExecutor` (continuously batched ``generate``) over TCP
    (port 0 = ephemeral)."""

    def __init__(self, executor, host: str = "127.0.0.1", port: int = 0,
                 max_delay_s: float = 0.005, max_queue: int = 64,
                 default_deadline_s: Optional[float] = None):
        self.executor = executor
        self.stats = StatsRegistry()
        self.default_deadline_s = default_deadline_s
        # an executor that brings its own scheduler (GenerateExecutor ->
        # ContinuousScheduler) plugs in here
        mk = getattr(executor, "make_batcher", None)
        self.batcher = (mk(max_delay_s=max_delay_s, max_queue=max_queue)
                        if mk is not None else
                        DynamicBatcher(executor, max_delay_s=max_delay_s,
                                       max_queue=max_queue))
        self.bad_frames = 0
        self.server_errors = 0
        self.connections = 0
        self._active_replies = 0   # requests received, reply not yet sent
        self.draining = False
        self._stop = threading.Event()
        self._done = threading.Event()     # fully shut down
        self._shutting_down = False
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.host = host
        self.port = self._srv.getsockname()[1]
        self.addr = (host, self.port)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        self._started = time.time()

    # ---- accept/handle --------------------------------------------------- #
    def _accept_loop(self) -> None:
        self._srv.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self.connections += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._done.is_set():
                try:
                    msg = recv_frame(conn)
                except FrameError as e:
                    with self._lock:
                        self.bad_frames += 1
                    log(f"serving: dropping connection on bad frame: {e}")
                    return
                except (ConnectionError, EOFError, OSError):
                    return
                # a received request is owed a reply: the counter keeps
                # shutdown() from declaring the server down before it
                # hits the wire
                with self._lock:
                    self._active_replies += 1
                try:
                    try:
                        reply = self._dispatch(msg, conn)
                    except (ConnectionError, OSError):
                        return
                    except (KeyError, TypeError, ValueError) as e:
                        with self._lock:
                            self.bad_frames += 1
                        reply = {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"}
                    except Exception as e:  # noqa: BLE001 — OUR failure
                        with self._lock:
                            self.server_errors += 1
                        log(f"serving: internal error: "
                            f"{type(e).__name__}: {e}")
                        reply = {"ok": False, "server_error": True,
                                 "error": f"{type(e).__name__}: {e}"}
                    if reply is None:       # bye
                        return
                    try:
                        send_frame(conn, reply)
                    except (ConnectionError, OSError):
                        return
                finally:
                    with self._lock:
                        self._active_replies -= 1
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, msg: Dict, conn=None) -> Optional[Dict]:
        kind = msg["kind"]
        if kind == "wire":
            ok = msg.get("codec") == WIRE_CODEC_VERSION
            if ok and conn is not None:
                mark_codec_socket(conn)
            return {"ok": ok, "codec": WIRE_CODEC_VERSION}
        if kind == "infer":
            return self._handle_infer(msg)
        if kind == "generate":
            return self._handle_generate(msg, conn)
        if kind == "stats":
            return {"ok": True, "stats": self.stats_snapshot()}
        if kind == "health":
            return {"ok": True, "draining": self.draining,
                    "params_version": self.executor.params_version}
        if kind == "bye":
            return None
        raise ValueError(f"unknown request kind {kind!r}")

    def _handle_infer(self, msg: Dict) -> Dict:
        return self._submit(msg["inputs"], msg)

    def _handle_generate(self, msg: Dict, conn=None) -> Dict:
        """LLM decode over a scheduler of sequences, with ``infer``'s error
        surface. Streaming rides the scheduler's per-token callback: each
        chunk frame carries the cumulative tokens so far, written from the
        scheduler thread while this handler thread blocks in submit; a
        broken chunk send kills the stream, never the sequence."""
        inputs = dict(msg["inputs"])
        if msg.get("stream") and conn is not None:
            def emit(tokens, _conn=conn):
                send_frame(_conn, {"kind": "gen_chunk",
                                   "tokens": np.asarray(tokens, np.int32)})
            inputs["stream"] = emit
        return self._submit(inputs, msg)

    def _submit(self, inputs: Dict, msg: Dict) -> Dict:
        deadline_ms = msg.get("deadline_ms")
        deadline_s = (float(deadline_ms) / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        try:
            outputs = self.batcher.submit(inputs, deadline_s=deadline_s)
            return {"ok": True, "outputs": outputs,
                    "params_version": self.executor.params_version}
        except ShedError as e:
            return {"ok": False, "shed": True, "error": str(e)}
        except DeadlineError as e:
            return {"ok": False, "deadline_exceeded": True, "error": str(e)}
        except (ValueError, TimeoutError) as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # ---- introspection ---------------------------------------------------- #
    def stats_snapshot(self) -> Dict:
        """The `stats` payload, also registered as the StatsRegistry
        "serving" section."""
        b = self.batcher
        fill = b.fill_ratio()
        snap = {
            "latency": b.latency.summary(),
            "queue_depth": b.queue_depth,
            "max_queue": b.max_queue,
            "batches": b.batches,
            "batched_rows": b.batched_rows,
            "batch_fill": None if fill is None else round(fill, 4),
            "shed": b.shed_count,
            "deadline_expired": b.deadline_expired,
            "bad_frames": self.bad_frames,
            "server_errors": self.server_errors,
            "connections": self.connections,
            "rows_served": self.executor.rows_served,
            # CNN-executor-only telemetry; a GenerateExecutor reports its
            # paged/decode counters through the batcher snapshot instead
            "rows_padded": getattr(self.executor, "rows_padded", 0),
            "bucket_calls": dict(getattr(self.executor, "calls", {})),
            "executor_bucket_fill": getattr(self.executor, "bucket_fill",
                                            lambda: None)(),
            "params_version": self.executor.params_version,
            "uptime_s": round(time.time() - self._started, 3),
            "draining": self.draining,
        }
        scheduler = getattr(b, "snapshot", None)
        if scheduler is not None:
            snap["scheduler"] = scheduler()
        self.stats.set_section("serving", snap)
        return snap

    # ---- shutdown --------------------------------------------------------- #
    def request_stop(self) -> None:
        """Async-signal-safe stop request: flip the flags only. The thread
        blocked in ``wait_until_stopped`` then runs ``shutdown``."""
        self.draining = True
        self._stop.set()

    def wait_until_stopped(self, poll_s: float = 0.25) -> None:
        while not self._stop.wait(poll_s):
            pass

    def shutdown(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Graceful stop: refuse new connections, drain the admitted queue
        (every in-flight request gets its reply), then close. Idempotent."""
        with self._lock:
            already = self._shutting_down
            self._shutting_down = True
        if already:
            self._done.wait(timeout=timeout_s)
            return
        self.draining = True
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self.batcher.close(drain=drain, timeout_s=timeout_s)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                if self._active_replies <= 0:
                    break
            time.sleep(0.005)
        self._done.set()
        self._accept_thread.join(timeout=timeout_s)

    def close(self) -> None:
        self.shutdown()
