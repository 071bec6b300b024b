"""Threaded socket front-end for the serving tier (the port of
``poseidon_tpu/serving/server.py``, same wire protocol): one executor, or a
fleet of replicas (``serving/fleet.ReplicaManager``) behind the one door.

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
- ``infer`` and ``generate`` replies carry ``params_version``, and in the
  fleet form ``replica``, the index of the replica that served;
- ``{"kind": "stats"}`` -> latency percentiles, queue depth, batch fill,
  shed count, reload counts; in the fleet form one row per replica
  (state, load, reload generation) and the pooled latency;
- ``{"kind": "reload"}`` -> one hot-reload poll now (when a reloader is
  attached), and what it found;
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
    """Serve a :class:`BucketedExecutor` (micro-batched ``infer``), a
    :class:`GenerateExecutor` (continuously batched ``generate``) or a
    whole :class:`~poseidon_tpu_torch.serving.fleet.ReplicaManager` over
    TCP (port 0 = ephemeral).

    Exactly one of ``executor`` / ``fleet`` must be given. In the fleet
    form every request goes through the manager's least-loaded router; the
    batching and admission knobs live on each replica's batcher (set when
    the fleet was built), so this constructor's ``max_delay_s`` and
    ``max_queue`` are unused there. ``reloader`` answers the ``reload`` op;
    ``stats_refresh_s > 0`` refreshes the registry's "serving" section on
    a timer, so a live metrics endpoint shows health without anyone
    calling the stats op."""

    def __init__(self, executor=None, host: str = "127.0.0.1", port: int = 0,
                 max_delay_s: float = 0.005, max_queue: int = 64,
                 default_deadline_s: Optional[float] = None,
                 reloader=None, stats: Optional[StatsRegistry] = None,
                 fleet=None, stats_refresh_s: float = 0.0):
        if (executor is None) == (fleet is None):
            raise ValueError("pass exactly one of executor= or fleet=")
        self.executor = executor
        self.fleet = fleet
        self.reloader = reloader
        self.stats = stats or StatsRegistry()
        self.default_deadline_s = default_deadline_s
        # an executor that brings its own scheduler (GenerateExecutor ->
        # ContinuousScheduler) plugs in here, as in fleet.Replica
        mk = (getattr(executor, "make_batcher", None)
              if executor is not None else None)
        self.batcher = (None if fleet is not None else
                        mk(max_delay_s=max_delay_s, max_queue=max_queue)
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
        self._refresh_thread = None
        self._stats_refresh_s = float(stats_refresh_s)
        if self._stats_refresh_s > 0:
            self._refresh_thread = threading.Thread(
                target=self._stats_refresh_loop, daemon=True)
            self._refresh_thread.start()

    def _stats_refresh_loop(self) -> None:
        """Keep the registry's "serving" section current for the live
        metrics endpoint."""
        while not self._stop.wait(self._stats_refresh_s):
            try:
                self.stats_snapshot()
            except Exception:  # noqa: BLE001 — telemetry never kills serving
                pass

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
            if self.fleet is not None:
                return {"ok": True, "draining": self.draining,
                        "states": self.fleet.state_counts(),
                        "reload_generation": self.fleet.reload_generation}
            return {"ok": True, "draining": self.draining,
                    "params_version": self.executor.params_version}
        if kind == "reload":
            if self.reloader is None:
                return {"ok": False, "error": "no reloader attached"}
            reloaded = self.reloader.check_now()
            reply = {"ok": True, "reloaded": reloaded,
                     "path": self.reloader.current_path,
                     "last_error": self.reloader.last_error}
            if self.fleet is not None:
                reply["reload_generation"] = self.fleet.reload_generation
            else:
                reply["params_version"] = self.executor.params_version
            return reply
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
            if self.fleet is not None:
                outputs, rep = self.fleet.submit(inputs,
                                                 deadline_s=deadline_s)
                return {"ok": True, "outputs": outputs,
                        "replica": rep.index,
                        "params_version": rep.executor.params_version}
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
    def _reloader_row(self) -> Optional[Dict]:
        r = self.reloader
        return None if r is None else {
            "reloads": r.reloads, "failed_reloads": r.failed_reloads,
            "last_error": r.last_error, "current_path": r.current_path}

    def stats_snapshot(self) -> Dict:
        """The `stats` payload, also registered as the StatsRegistry
        "serving" section. With a fleet: the manager's totals plus one row
        per replica (state, queue depth, batch fill, sheds, reload
        generation)."""
        if self.fleet is not None:
            snap = self.fleet.stats_snapshot()
            snap.update({
                "bad_frames": self.bad_frames,
                "server_errors": self.server_errors,
                "connections": self.connections,
                "uptime_s": round(time.time() - self._started, 3),
                "draining": self.draining,
                "reloads": (0 if self.reloader is None
                            else self.reloader.reloads),
                "reloader": self._reloader_row(),
            })
            self.stats.set_section("serving", snap)
            return snap
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
            "reloads": (0 if self.reloader is None
                        else self.reloader.reloads),
            "reloader": self._reloader_row(),
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
        if self.reloader is not None:
            self.reloader.close()
        if self.fleet is not None:
            self.fleet.shutdown(drain=drain, timeout_s=timeout_s)
        else:
            self.batcher.close(drain=drain, timeout_s=timeout_s)
        # the batcher completing a request only sets its event: wait for
        # every received-but-unreplied request to hit the wire
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                if self._active_replies <= 0:
                    break
            time.sleep(0.005)
        self._done.set()
        self._accept_thread.join(timeout=timeout_s)
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=timeout_s)

    def close(self) -> None:
        self.shutdown()
