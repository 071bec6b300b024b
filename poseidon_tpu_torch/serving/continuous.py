"""Iteration-level continuous batching for LLM decode (the port of
``poseidon_tpu/serving/continuous.py``).

A CNN request is one dispatch; an LLM request is a SEQUENCE of decode
steps of varying length. Continuous batching re-decides membership every
decode step: finished sequences retire at once (their pages return to the
:class:`~poseidon_tpu_torch.serving.kv_pool.PagedKVPool`), waiting
sequences admit into the freed rows.

Two phases per sequence:

- **prefill**: the whole prompt in ONE call at a prompt-length bucket
  (causal self-attention through the CUDA flash kernel on the card),
  producing the first token's logits and the prompt's K/V, which are copied
  into the sequence's pages;
- **decode**: one token per step for the whole active set at a decode-batch
  RUNG (the smallest rung >= the active count), through the page table
  (``models/generate.py paged_decode_step``).

The JAX package compiles every bucket and rung ahead of time; PyTorch runs
eagerly, so ``GenerateExecutor.warm()`` runs each prompt bucket and decode
rung once instead (kernel build, cuBLAS handles and allocator pools are
set up before the first request).

:class:`ContinuousScheduler` duck-types the :class:`DynamicBatcher` surface
(``submit`` raising ``ShedError``/``DeadlineError``, ``load_score``/
``idle``/``wait_idle``/``close``, the telemetry attributes), so the socket
front door serves it unchanged. Per-sequence deadlines: expired in queue ->
``DeadlineError`` before any compute; expired mid-generation -> cut at the
next iteration boundary. Beyond the JAX package it records time to first
token (submit to the first generated token) in ``ttft``.

A tp-sharded replica (``GenerateExecutor(mesh_cfg=MeshConfig(tp=T))``)
is ONE controller over T shards, as the JAX package's tp executor is one
object over a GSPMD mesh: head-major weights cut by ``tp_shard``, a KV pool
sharded on its head axis, prefill and decode through
``models/generate.py``'s ``tp_prefill_cached`` and
``tp_paged_decode_step``. PyTorch issues kernels asynchronously, so one
host thread drives shards on several GPUs at once; the scheduler, the
fleet and ``swap_params``' contract stay as they are.

Thread model: ONE scheduler thread (a daemon) owns the active set, the
pool and every device call. Handler threads only touch the bounded queue
and the telemetry counters, both under ``_lock``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.generate import (MOE_PAGED_REFUSAL, paged_decode_step,
                               prefill_cached, tp_paged_decode_step,
                               tp_prefill_cached)
from ..models.transformer import TP_SPLIT_DIM, to_tp_layout, tp_shard
from ..numeric import apply_policy, resolve_device
from ..runtime.metrics import LatencyWindow, log
from .batcher import DeadlineError, ShedError, ShuttingDownError
from .kv_pool import PagedKVPool, PoolExhausted

__all__ = ["ContinuousScheduler", "GenerateExecutor", "parse_rungs",
           "DEFAULT_PAGE_SIZE", "DEFAULT_DECODE_RUNGS",
           "DEFAULT_PROMPT_BUCKETS"]

# the JAX package's built-in LLM serving knobs (runtime/tuned_plan.py
# BUILTIN_DEFAULTS: llm_page_size, llm_decode_rungs, llm_prompt_buckets),
# kept as the port's own copy
DEFAULT_PAGE_SIZE = 64
DEFAULT_DECODE_RUNGS = (1, 2, 4, 8)
DEFAULT_PROMPT_BUCKETS = (16, 64, 256)


def parse_rungs(spec: str) -> Tuple[int, ...]:
    """'1,2,4,8' -> (1, 2, 4, 8), validated ascending positives."""
    try:
        rungs = tuple(sorted({int(t) for t in spec.split(",") if t}))
    except ValueError as e:
        raise ValueError(f"bad rung spec {spec!r}: {e}") from None
    if not rungs or rungs[0] < 1:
        raise ValueError(f"bad rung spec {spec!r}: need positive sizes")
    return rungs


def _align(n: int, m: int) -> int:
    return -(-int(n) // int(m)) * int(m)


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``float32``, the JAX package's spelling."""
    return str(dtype).replace("torch.", "")


def _as_tensors(tree) -> Dict:
    """A ``{name: {leaf: array or tensor}}`` tree as tensors (no copy)."""
    return {name: {leaf: torch.as_tensor(v) for leaf, v in d.items()}
            for name, d in tree.items()}


def _tp_devices(tp: int, devices) -> Tuple[torch.device, ...]:
    """The device of each of ``tp`` shards: ``devices`` as given (a device
    may repeat), else the first ``tp`` CUDA devices; never the CPU unless
    named, never two shards on one card unless named."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise RuntimeError(
                f"tp={tp} places a shard on each of the first {tp} CUDA "
                f"devices and {have} are available; pass devices= to place "
                f"the shards yourself (a device may repeat)")
        return tuple(torch.device("cuda", i) for i in range(tp))
    devs = tuple(resolve_device(d) for d in devices)
    if len(devs) != tp:
        raise ValueError(f"devices= names {len(devs)} devices for tp={tp} "
                         f"shards")
    return devs


# --------------------------------------------------------------------------- #
# the decode engine
# --------------------------------------------------------------------------- #


class GenerateExecutor:
    """Transformer decode over a paged KV pool, on one device or
    tensor-parallel over shards.

    The LLM sibling of :class:`BucketedExecutor`: prompts pad to a prompt
    bucket, decode steps run at a rung. ``params`` is a standard-layout
    ``{name: {leaf: tensor}}`` tree (``models/transformer.py``); it moves
    to ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    Construction warms every bucket and rung. The KV pool lives here; the
    :class:`ContinuousScheduler` drives it.

    ``mesh_cfg`` with ``tp`` > 1 serves the model tensor-parallel, as the
    JAX package's tp executor: the params go to the head-major layout
    (``to_tp_layout``) and rank t's ``tp_shard`` lands on ``devices[t]``
    (by default the first ``tp`` CUDA devices; a device may repeat), the
    pool shards its heads the same way, and one controller drives every
    shard from the scheduler's thread. JAX replicates such a replica over
    the ``data`` and ``fsdp`` axes; here more copies are more replicas
    (``ReplicaManager``, ``serve --replicas``), so those axes are refused.
    """

    input_names = ("prompt",)

    def __init__(self, cfg, params, *,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 decode_rungs: Sequence[int] = DEFAULT_DECODE_RUNGS,
                 prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                 max_seq_len: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 default_max_new: int = 32, device=None, mesh_cfg=None,
                 devices: Optional[Sequence] = None):
        if getattr(cfg, "base", None) is not None:
            raise NotImplementedError(MOE_PAGED_REFUSAL)
        apply_policy()
        self.mesh_cfg = None
        if mesh_cfg is not None and mesh_cfg.active:
            if device is not None:
                raise ValueError("pass device= or mesh_cfg=, not both")
            if mesh_cfg.tp > 1 and (cfg.n_heads % mesh_cfg.tp
                                    or cfg.d_ff % mesh_cfg.tp):
                raise ValueError(
                    f"n_heads={cfg.n_heads} and d_ff={cfg.d_ff} must both "
                    f"divide tp={mesh_cfg.tp}")
            if mesh_cfg.data > 1 or mesh_cfg.fsdp > 1:
                raise ValueError(
                    f"mesh {mesh_cfg.describe()}: a generate replica shards "
                    f"over tp only; for more copies of it serve more "
                    f"replicas (ReplicaManager, serve --replicas)")
            self.mesh_cfg = mesh_cfg
            self.devices = _tp_devices(mesh_cfg.tp, devices)
        elif devices is not None:
            raise ValueError("devices= places tp shards; pass it with "
                             "mesh_cfg=")
        else:
            self.devices = (resolve_device(device),)
        self.device = self.devices[0]
        self.cfg = cfg
        self.page_size = int(page_size)
        self.decode_rungs = tuple(sorted(set(int(r) for r in decode_rungs)))
        self.prompt_buckets = tuple(sorted(set(int(b)
                                               for b in prompt_buckets)))
        if not self.decode_rungs or self.decode_rungs[0] < 1:
            raise ValueError(f"need positive decode rungs, "
                             f"got {decode_rungs!r}")
        if not self.prompt_buckets or self.prompt_buckets[0] < 1:
            raise ValueError(f"need positive prompt buckets, "
                             f"got {prompt_buckets!r}")
        self.default_max_new = int(default_max_new)
        self.max_seq_len = int(max_seq_len or cfg.max_seq)
        if self.max_seq_len > cfg.max_seq:
            raise ValueError(f"max_seq_len {self.max_seq_len} exceeds the "
                             f"model's learned positions {cfg.max_seq}")
        if max(self.prompt_buckets) >= self.max_seq_len:
            raise ValueError(f"largest prompt bucket "
                             f"{max(self.prompt_buckets)} leaves no room "
                             f"to generate within {self.max_seq_len}")
        params = _as_tensors(params)
        # the standard-layout (global) shapes swap_params validates against
        self._shapes = {name: {leaf: (tuple(v.shape), v.dtype)
                               for leaf, v in d.items()}
                        for name, d in params.items()}
        # a tree on one device, or one tree a tp shard: the whole set is
        # read once a step and replaced in one assignment
        self._params = self._place(params, copy=False)

        pages_per_seq = -(-self.max_seq_len // self.page_size)
        if num_pages is None:
            # every row of the largest rung can hold a max-length sequence
            num_pages = self.decode_rungs[-1] * pages_per_seq + 1
        self.pool = PagedKVPool(cfg, num_pages=num_pages,
                                page_size=self.page_size,
                                max_seq_len=self.max_seq_len,
                                devices=self.devices)

        # make_batcher() reads this: "static" builds the A/B control arm
        self.scheduler_mode = "continuous"
        self._swap_lock = threading.Lock()
        self.params_version = 0       # bumped by every swap_params
        self.rows_served = 0          # tokens delivered to completed rows
        self.prefills = 0
        self.decode_calls: Dict[int, int] = {r: 0 for r in self.decode_rungs}
        self.warm()

    def warm(self) -> None:
        """Run prefill at every prompt bucket and decode at every rung once
        (the eager counterpart of the JAX package's AOT compile); counts
        nothing. The decode rows are inactive: they write the scratch
        page."""
        width = self.pool.max_pages_per_seq
        for b in self.prompt_buckets:
            self._run_prefill(np.zeros((b,), np.int64))
        for r in self.decode_rungs:
            self._run_decode(np.zeros((r,), np.int64),
                             np.zeros((r, width), np.int64),
                             np.zeros((r,), np.int64))
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _place(self, params, copy: bool):
        """A standard-layout tree of tensors on this replica's device, or
        its tp shards (``to_tp_layout``, ``tp_shard``) each on its own
        device. ``copy`` copies even where a tensor already lies on the
        device."""
        def put(tree, dev):
            return {name: {leaf: v.to(dev, copy=copy)
                           for leaf, v in d.items()}
                    for name, d in tree.items()}

        if self.mesh_cfg is None:
            return put(params, self.device)
        full = to_tp_layout(params, self.cfg)
        shards = []
        for t, dev in enumerate(self.devices):
            shard = tp_shard(full, self.cfg, t, self.mesh_cfg.tp)
            if t:   # the controller reads the replicated leaves on shard 0
                shard = {name: {leaf: d[leaf] for leaf in TP_SPLIT_DIM}
                         for name, d in shard.items()
                         if name.startswith("block")}
            shards.append(put(shard, dev))
        return tuple(shards)

    def prompt_bucket_for(self, p: int) -> int:
        for b in self.prompt_buckets:
            if p <= b:
                return b
        raise ValueError(f"prompt of {p} tokens exceeds the largest "
                         f"prompt bucket {self.prompt_buckets[-1]}")

    def rung_for(self, n: int) -> int:
        for r in self.decode_rungs:
            if n <= r:
                return r
        raise ValueError(f"{n} active rows exceed the largest decode "
                         f"rung {self.decode_rungs[-1]}")

    @property
    def max_batch(self) -> int:
        """Largest decode rung: the scheduler's active-set capacity."""
        return self.decode_rungs[-1]

    def reserve_len(self, p: int, max_new: int) -> int:
        """Positions a request reserves pages for: the page-aligned prefill
        region and the last generated position, whichever is larger."""
        return max(_align(self.prompt_bucket_for(p), self.page_size),
                   p + max_new)

    # ---- the two phases --------------------------------------------------- #
    def _run_prefill(self, prompt: np.ndarray):
        p = int(prompt.shape[0])
        bucket = self.prompt_bucket_for(p)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :p] = prompt
        params = self._params           # one read: swap-safe
        prefill = (tp_prefill_cached if self.mesh_cfg is not None
                   else prefill_cached)
        with torch.inference_mode():
            logits, caches = prefill(
                params, self.cfg, torch.from_numpy(toks).to(self.device),
                torch.tensor([p - 1], device=self.device),
                _align(bucket, self.page_size))
            return logits[0].cpu().numpy(), caches

    def _run_decode(self, tok, table, pos) -> np.ndarray:
        params = self._params           # one read: swap-safe
        dev = self.device
        if self.mesh_cfg is not None:
            step, caches = tp_paged_decode_step, self.pool.shard_caches
        else:
            step, caches = paged_decode_step, self.pool.caches
        with torch.inference_mode():
            logits, _ = step(params, self.cfg, torch.as_tensor(tok).to(dev),
                             caches, torch.as_tensor(table).to(dev),
                             torch.as_tensor(pos).to(dev))
            return logits.cpu().numpy()

    def prefill(self, prompt: np.ndarray):
        """Run one prompt (1-D int) through the bucketed prefill; returns
        (logits (V,), dense caches) for the scheduler to hand to
        ``pool.write_prefill``."""
        out = self._run_prefill(np.asarray(prompt, np.int64))
        self.prefills += 1
        return out

    def decode(self, tok: np.ndarray, table: np.ndarray,
               pos: np.ndarray) -> np.ndarray:
        """One decode step for a full rung: tok/pos (R,), table (R,
        max_pages). Returns logits (R, V); the pool updates in place."""
        r = int(tok.shape[0])
        if r not in self.decode_calls:
            raise ValueError(f"no decode rung of size {r} "
                             f"(rungs {self.decode_rungs})")
        logits = self._run_decode(np.asarray(tok, np.int64),
                                  np.asarray(table, np.int64),
                                  np.asarray(pos, np.int64))
        self.decode_calls[r] += 1
        return logits

    # ---- serving hooks ----------------------------------------------------- #
    def make_batcher(self, max_delay_s: float = 0.005,
                     max_queue: int = 64) -> "ContinuousScheduler":
        """The server's executor-provided batcher: an LLM executor
        schedules sequences, not micro-batches. ``max_delay_s`` is accepted
        for signature compatibility and unused."""
        del max_delay_s
        return ContinuousScheduler(self, max_queue=max_queue,
                                   mode=self.scheduler_mode)

    def swap_params(self, new_params: Dict) -> int:
        """Rolling-reload contract (as ``BucketedExecutor``'s): validate
        the incoming standard-layout ``{name: {leaf: array or tensor}}``
        tree against the serving one's global shapes (same leaves, shapes
        and dtypes, with the JAX package's messages), copy it to this
        replica's device, or convert it to the tp layout and copy each
        shard to its device, and swap the whole set in one assignment. A
        prefill or decode step that already read the old set finishes on
        it; none sees old and new shards together. Returns the new params
        version."""
        new_params = _as_tensors(new_params)
        cur_keys = {n: sorted(d) for n, d in self._shapes.items()}
        new_keys = {n: sorted(d) for n, d in new_params.items()}
        if sorted(cur_keys.items()) != sorted(new_keys.items()):
            raise ValueError("params tree structure mismatch: the snapshot "
                             "was taken from a different model")
        for name in sorted(cur_keys):
            for leaf in cur_keys[name]:
                shape, dtype = self._shapes[name][leaf]
                n = new_params[name][leaf]
                if shape != tuple(n.shape) or dtype != n.dtype:
                    raise ValueError(
                        f"params leaf mismatch: {tuple(n.shape)}/"
                        f"{_dtype_name(n.dtype)} vs serving "
                        f"{shape}/{_dtype_name(dtype)}")
        # the copies ride each device's default stream, the one every
        # replica's steps run on, so a step that reads the new set is
        # ordered after them
        new = self._place(new_params, copy=True)
        with self._swap_lock:
            self._params = new
            self.params_version += 1
            return self.params_version

    def snapshot(self) -> Dict:
        return {
            "page_size": self.page_size,
            "decode_rungs": list(self.decode_rungs),
            "prompt_buckets": list(self.prompt_buckets),
            "prefills": self.prefills,
            "decode_calls": dict(self.decode_calls),
            "pool": self.pool.snapshot(),
            "device": str(self.device),
            "devices": [str(d) for d in self.devices],
            "mesh": (self.mesh_cfg.describe()
                     if self.mesh_cfg is not None else None),
        }


# --------------------------------------------------------------------------- #
# the scheduler
# --------------------------------------------------------------------------- #


class _GenSeq:
    """One in-flight generation request (queued or active)."""
    __slots__ = ("prompt", "max_new", "eos_id", "deadline", "enqueued",
                 "event", "result", "error", "cancelled", "stream",
                 "seq_id", "pos", "next_tok", "out_tokens")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos_id: Optional[int], deadline: Optional[float],
                 stream=None):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.deadline = deadline            # absolute monotonic, or None
        self.enqueued = time.monotonic()
        self.event = threading.Event()
        self.result: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self.stream = stream                # optional cumulative-tokens cb
        self.seq_id: Optional[int] = None   # set at admission
        self.pos = 0                        # abs position of next_tok
        self.next_tok = 0                   # last token, not yet fed back
        self.out_tokens: List[int] = []


class ContinuousScheduler:
    """Queue -> admit/retire every decode step -> fan results back out.

    ``mode="static"`` is the A/B control arm: sequences admit only into an
    EMPTY active set, and the batch runs until it drains."""

    def __init__(self, executor: GenerateExecutor, max_queue: int = 64,
                 mode: str = "continuous"):
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode must be continuous|static, got {mode!r}")
        self.executor = executor
        self.max_queue = int(max_queue)
        self.max_batch = executor.max_batch
        self.mode = mode
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closing = False
        self._drain = True
        self._seq_counter = 0
        self._active: List[_GenSeq] = []    # loop-thread-owned
        self._n_active = 0                  # lock-guarded mirror for stats
        # a sequence popped from the queue and not yet in the active set
        # (its prefill runs outside the lock): counted so idle() cannot
        # read "nothing queued, nothing active" mid-prefill
        self._admitting = 0
        self.latency = LatencyWindow()
        self.ttft = LatencyWindow()         # submit -> first token
        self.shed_count = 0
        self.deadline_expired = 0
        self.batches = 0                    # decode iterations dispatched
        self.batched_rows = 0               # active rows across iterations
        self.admitted = 0
        self.retired = 0
        self._fill_sum = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- submission side -------------------------------------------------- #
    def validate_request(self, inputs: Dict) -> int:
        """Reject malformed requests with THEIR error before they hold a
        queue slot. Token ids are range-checked too: an out-of-range index
        would fault the device, not just this request."""
        if "prompt" not in inputs:
            raise ValueError("request missing input 'prompt'")
        prompt = np.asarray(inputs["prompt"])
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(f"prompt must be a non-empty 1-D int array, "
                             f"got shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"prompt must hold integer token ids, got "
                             f"{prompt.dtype}")
        vocab = self.executor.cfg.vocab_size
        if int(prompt.min()) < 0 or int(prompt.max()) >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        p = int(prompt.shape[0])
        max_new = int(inputs.get("max_new", self.executor.default_max_new))
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        ex = self.executor
        total = ex.reserve_len(p, max_new)      # raises on oversized prompt
        if total > ex.pool.max_seq_len:
            raise ValueError(
                f"prompt {p} + max_new {max_new} exceeds the pool's "
                f"max_seq_len {ex.pool.max_seq_len}")
        if ex.pool.pages_for(total) > ex.pool.num_pages - 1:
            raise ValueError(
                f"request needs {ex.pool.pages_for(total)} pages; the "
                f"whole pool holds {ex.pool.num_pages - 1}")
        return 1

    def submit(self, inputs: Dict, deadline_s: Optional[float] = None,
               timeout_s: float = 30.0) -> Dict:
        """Enqueue one generation request and block until it completes.
        Returns ``{"tokens": (n,) int32, "n_new": n, "prompt_len": p}``.
        Raises ShedError on a full queue, DeadlineError on SLO expiry,
        ValueError on malformed inputs."""
        t0 = time.monotonic()
        self.validate_request(inputs)
        # copy: a codec-decoded prompt is a view into its receive buffer
        prompt = np.array(inputs["prompt"], np.int32)
        max_new = int(inputs.get("max_new", self.executor.default_max_new))
        eos_id = inputs.get("eos_id")
        eos_id = None if eos_id is None else int(eos_id)
        deadline = None if deadline_s is None else t0 + float(deadline_s)
        req = _GenSeq(prompt, max_new, eos_id, deadline,
                      stream=inputs.get("stream"))
        with self._lock:
            if self._closing:
                raise ShuttingDownError("scheduler is shutting down")
            if len(self._q) >= self.max_queue:
                self.shed_count += 1
                raise ShedError(
                    f"queue full ({self.max_queue} requests queued)")
            self._q.append(req)
            self._wake.notify()
        if not req.event.wait(timeout_s):
            with self._lock:
                req.cancelled = True
                try:
                    self._q.remove(req)
                except ValueError:
                    pass                # already admitted; loop skips it
            raise TimeoutError(f"no reply within {timeout_s}s "
                               f"(scheduler wedged?)")
        if req.error is not None:
            raise req.error
        self.latency.record(time.monotonic() - t0)
        return req.result

    # ---- DynamicBatcher surface ------------------------------------------- #
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def inflight_rows(self) -> int:
        with self._lock:
            return self._n_active

    def load_score(self) -> float:
        with self._lock:
            return len(self._q) + self._n_active / self.max_batch

    def idle(self) -> bool:
        """Nothing queued, admitting or active: the rolling reload's
        swap-is-safe condition (one lock hold)."""
        with self._lock:
            return not self._q and not self._n_active \
                and not self._admitting

    def wait_idle(self, timeout_s: float = 30.0,
                  poll_s: float = 0.005) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.idle():
                return True
            time.sleep(poll_s)
        return self.idle()

    def fill_ratio(self) -> Optional[float]:
        with self._lock:
            if not self.batches:
                return None
            return self._fill_sum / self.batches

    # ---- loop-thread internals -------------------------------------------- #
    def _complete(self, seq: _GenSeq, *, error: Optional[BaseException]
                  = None) -> None:
        """Retire one sequence: free its pages at once, hand the submitter
        its result or error. Loop-thread only."""
        if seq.seq_id is not None:
            self.executor.pool.free(seq.seq_id)
        with self._lock:
            self.retired += 1
        if error is not None:
            seq.error = error
        else:
            toks = np.asarray(seq.out_tokens, np.int32)
            seq.result = {"tokens": toks, "n_new": int(toks.shape[0]),
                          "prompt_len": int(seq.prompt.shape[0])}
            self.executor.rows_served += int(toks.shape[0])
        seq.event.set()

    def _emit_stream(self, seq: _GenSeq) -> None:
        if seq.stream is None:
            return
        try:
            seq.stream(list(seq.out_tokens))
        except Exception:  # noqa: BLE001 — a broken stream sink must not
            seq.stream = None           # kill the sequence or the loop

    def _try_admit(self) -> bool:
        """Admit queued sequences into free active rows while pages last.
        Returns True if anything was admitted. Loop-thread only."""
        admitted = False
        with self._lock:
            # static mode gang-admits: a batch forms only into an empty
            # active set (filling the rung this round), then drains
            gang_open = not self._active
        while True:
            with self._lock:
                if not self._q:
                    break
                if self.mode == "static" and not gang_open:
                    break
                if len(self._active) >= self.max_batch:
                    break
                req = self._q[0]
                if req.cancelled:
                    self._q.popleft()
                    continue
                now = time.monotonic()
                if req.deadline is not None and now > req.deadline:
                    self._q.popleft()
                    self.deadline_expired += 1
                    req.error = DeadlineError(
                        f"deadline expired after "
                        f"{now - req.enqueued:.3f}s in queue")
                    req.event.set()
                    continue
                total = self.executor.reserve_len(
                    int(req.prompt.shape[0]), req.max_new)
                if not self.executor.pool.can_admit(total):
                    break               # wait for retirements to free pages
                self._q.popleft()
                self._admitting = 1
                self._seq_counter += 1
                req.seq_id = self._seq_counter
            # pool alloc + prefill OUTSIDE the lock (device work)
            try:
                self.executor.pool.alloc(req.seq_id, total)
                logits, caches = self.executor.prefill(req.prompt)
                self.executor.pool.write_prefill(req.seq_id, caches)
            except PoolExhausted as e:
                self.executor.pool.free(req.seq_id)
                with self._lock:
                    self._q.appendleft(req)
                    self._admitting = 0
                log(f"serving: admission raced the pool: {e}")
                break
            except BaseException as e:  # noqa: BLE001 — fan out the error
                self._complete(req, error=e)
                with self._lock:
                    self._admitting = 0
                continue
            tok0 = int(np.argmax(logits))
            req.out_tokens.append(tok0)
            self.ttft.record(time.monotonic() - req.enqueued)
            req.pos = int(req.prompt.shape[0])
            req.next_tok = tok0
            self._emit_stream(req)
            with self._lock:
                self.admitted += 1
            if (req.eos_id is not None and tok0 == req.eos_id) \
                    or req.max_new <= 1:
                self._complete(req)
                with self._lock:
                    self._admitting = 0
            else:
                with self._lock:
                    self._active.append(req)
                    self._n_active = len(self._active)
                    self._admitting = 0
            admitted = True
        return admitted

    def _decode_iteration(self) -> None:
        """One decode step for the whole active set at the smallest rung,
        then per-row retirement. Loop-thread only."""
        act = self._active
        rung = self.executor.rung_for(len(act))
        tok = np.zeros((rung,), np.int32)
        pos = np.zeros((rung,), np.int32)
        seq_ids: List[Optional[int]] = [s.seq_id for s in act]
        seq_ids += [None] * (rung - len(act))
        for i, s in enumerate(act):
            tok[i] = s.next_tok
            pos[i] = s.pos
        table = self.executor.pool.table(seq_ids)
        try:
            logits = self.executor.decode(tok, table, pos)
        except BaseException as e:  # noqa: BLE001 — executor failure: fan
            # the error to every active sequence
            for s in act:
                self._complete(s, error=e)
            with self._lock:
                self._active = []
                self._n_active = 0
            return
        with self._lock:
            self.batches += 1
            self.batched_rows += len(act)
            self._fill_sum += len(act) / rung
        now = time.monotonic()
        still: List[_GenSeq] = []
        for i, s in enumerate(act):
            new_tok = int(np.argmax(logits[i]))
            s.out_tokens.append(new_tok)
            s.pos += 1
            s.next_tok = new_tok
            self._emit_stream(s)
            if s.cancelled:
                self._complete(s, error=RuntimeError("cancelled"))
                continue
            done = (s.eos_id is not None and new_tok == s.eos_id) \
                or len(s.out_tokens) >= s.max_new
            if done:
                self._complete(s)
            elif s.deadline is not None and now > s.deadline:
                with self._lock:
                    self.deadline_expired += 1
                self._complete(s, error=DeadlineError(
                    f"SLO deadline expired mid-generation after "
                    f"{len(s.out_tokens)} tokens"))
            else:
                still.append(s)
        with self._lock:
            self._active = still
            self._n_active = len(still)

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._q and not self._active and not self._closing:
                    self._wake.wait(timeout=0.25)
                closing, drain = self._closing, self._drain
                empty = not self._q and not self._active
            if closing and empty:
                return
            if closing and not drain:
                # complete leftovers (queued AND mid-generation) with the
                # typed shutdown shed and free their pages
                with self._lock:
                    leftovers = list(self._q)
                    self._q.clear()
                    act, self._active = self._active, []
                    self._n_active = 0
                for s in leftovers + act:
                    self._complete(s, error=ShuttingDownError(
                        "server shut down before completion"))
                return
            self._try_admit()
            if self._active:
                self._decode_iteration()

    # ---- shutdown ---------------------------------------------------------- #
    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Refuse new submissions; with ``drain`` finish everything admitted
        AND queued, else complete leftovers with the shutdown shed.
        Idempotent."""
        with self._lock:
            self._closing = True
            self._drain = drain
            self._wake.notify_all()
        self._thread.join(timeout=timeout_s)

    def snapshot(self) -> Dict:
        with self._lock:
            snap = {
                "mode": self.mode,
                "queue_depth": len(self._q),
                "active": self._n_active,
                "admitted": self.admitted,
                "retired": self.retired,
                "batches": self.batches,
                "batched_rows": self.batched_rows,
                "shed": self.shed_count,
                "deadline_expired": self.deadline_expired,
            }
        snap["fill"] = self.fill_ratio()
        snap["latency"] = self.latency.summary()
        snap["ttft"] = self.ttft.summary()
        snap["executor"] = self.executor.snapshot()
        return snap
