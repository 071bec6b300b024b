"""The port's LLM serving tier on the CPU: paged decode against the dense
path, the KV page pool, the continuous scheduler, the ``generate`` op over
the socket (with the port's client and with the JAX package's), and
``serve --generate`` as a subprocess.

The contracts are the JAX package's (tests/test_llm_serving.py), held
inside the port: paged decode is BITWISE equal to the port's dense
``generate`` (per-step logits, not only tokens) when both see the same
cache length; the scheduler returns exactly the dense greedy tokens. Where
a test compares with the JAX package, tokens must be equal (logit parity
is pinned in tests/test_torch_lm.py). Weights cross from the JAX package
through ``params_from_jax``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu_torch.models import generate as port_gen
from poseidon_tpu_torch.models import transformer as port_tf
from poseidon_tpu_torch.serving.batcher import DeadlineError, ShedError
from poseidon_tpu_torch.serving.client import (ServingClient, ServingError,
                                               run_load)
from poseidon_tpu_torch.serving.continuous import (ContinuousScheduler,
                                                   GenerateExecutor,
                                                   parse_rungs)
from poseidon_tpu_torch.serving.kv_pool import PagedKVPool, PoolExhausted
from poseidon_tpu_torch.serving.server import InferenceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 64


@pytest.fixture(scope="module")
def model():
    from poseidon_tpu.models.transformer import TransformerConfig, init_params
    jcfg = TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=4,
                             n_layers=2, d_ff=128, max_seq=32)
    jp = jax.tree_util.tree_map(np.asarray,
                                init_params(jcfg, jax.random.PRNGKey(0)))
    pcfg = port_tf.TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=4,
                                     n_layers=2, d_ff=128, max_seq=32)
    return jcfg, jp, pcfg, port_tf.params_from_jax(jp)


def _prompts(b, p, seed=1):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, p)) \
        .astype(np.int32)


def _dense(params, cfg, prompt, max_new):
    toks, logits = port_gen.generate(params, cfg, torch.from_numpy(prompt),
                                     max_new)
    return toks.numpy(), logits.numpy()


def _executor(cfg, params, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("decode_rungs", (1, 2, 4))
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("max_seq_len", 24)
    kw.setdefault("default_max_new", 6)
    kw.setdefault("device", "cpu")
    return GenerateExecutor(cfg, params, **kw)


# --------------------------------------------------------------------------- #
# paged decode parity
# --------------------------------------------------------------------------- #

def test_paged_decode_bitwise_equals_dense_generate(model):
    """Page-table indirection reconstructs the dense cache EXACTLY: every
    step's logits equal the dense ``generate``'s bit for bit (the pool is
    sized so both see a 12-position cache), and freeing returns every
    page."""
    _, _, cfg, params = model
    B, P, MAX_NEW = 2, 6, 6
    prompt = _prompts(B, P)
    toks_d, logits_d = _dense(params, cfg, prompt, MAX_NEW)

    pool = PagedKVPool(cfg, num_pages=16, page_size=4,
                       max_seq_len=P + MAX_NEW)
    toks_p = np.zeros((B, MAX_NEW), np.int64)
    logits_p = np.zeros_like(logits_d)
    seq_ids = list(range(B))
    with torch.inference_mode():
        for b in seq_ids:
            pool.alloc(b, P + MAX_NEW)
            lg, caches = port_gen.prefill_cached(
                params, cfg, torch.from_numpy(prompt[b:b + 1]),
                torch.tensor([P - 1]), 8)
            pool.write_prefill(b, caches)
            logits_p[b, 0] = lg[0].numpy()
        toks_p[:, 0] = np.argmax(logits_p[:, 0], axis=-1)
        table = torch.from_numpy(pool.table(seq_ids))
        pos = torch.full((B,), P)
        tok = torch.from_numpy(toks_p[:, 0])
        for i in range(1, MAX_NEW):
            lg, _ = port_gen.paged_decode_step(params, cfg, tok, pool.caches,
                                               table, pos)
            logits_p[:, i] = lg.numpy()
            toks_p[:, i] = np.argmax(logits_p[:, i], axis=-1)
            tok = torch.from_numpy(toks_p[:, i])
            pos = pos + 1

    np.testing.assert_array_equal(toks_d, toks_p)
    assert np.array_equal(logits_d, logits_p), (
        "paged decode logits drifted from the dense cache (max abs diff "
        f"{np.abs(logits_d - logits_p).max()})")
    for b in seq_ids:
        pool.free(b)
    assert pool.all_free()


def test_decode_scatter_writes_pages_in_place_and_padding_hits_scratch(
        model):
    """The scatter writes each row's K/V at (page, slot) of the shared pool
    in place; inactive rows (all-scratch table, pos 0) write page 0 slot 0
    only."""
    _, _, cfg, params = model
    pool = PagedKVPool(cfg, num_pages=6, page_size=4, max_seq_len=8)
    pool.alloc(7, 8)
    pages = pool.pages_of(7)
    table = torch.from_numpy(pool.table([7, None]))
    before = [t.clone() for t in pool.caches[0]]
    with torch.inference_mode():
        port_gen.paged_decode_step(params, cfg, torch.tensor([3, 0]),
                                   pool.caches, table, torch.tensor([5, 0]))
    pk = pool.caches[0][0]
    changed = (pk != before[0]).any(dim=(1, 3))          # (pages, slots)
    want = torch.zeros_like(changed)
    want[pages[1], 1] = True                             # pos 5 = page 1 slot 1
    want[0, 0] = True                                    # the padding row
    assert torch.equal(changed, want)


# --------------------------------------------------------------------------- #
# the pool
# --------------------------------------------------------------------------- #

def test_pool_reserve_all_or_nothing_and_exhaustion(model):
    _, _, cfg, _ = model
    pool = PagedKVPool(cfg, num_pages=5, page_size=4, max_seq_len=16)
    pool.alloc(1, 16)                      # all 4 usable pages
    assert not pool.can_admit(4)
    with pytest.raises(PoolExhausted):
        pool.alloc(2, 4)
    assert pool.pages_used == 4 and pool.pages_free == 0
    assert pool.free(1) == 4 and pool.free(1) == 0       # idempotent
    assert pool.all_free()
    pool.alloc(3, 4)
    with pytest.raises(ValueError, match="already holds"):
        pool.alloc(3, 4)
    pool.free(3)
    assert pool.all_free()
    snap = pool.snapshot()
    assert snap["allocs"] == 2 and snap["frees"] == 2
    assert snap["peak_pages_used"] == 4 and snap["num_pages"] == 4
    with pytest.raises(ValueError, match="max_seq_len"):
        pool.can_admit(17)
    with pytest.raises(ValueError, match="scratch"):
        PagedKVPool(cfg, num_pages=1, page_size=4)


def test_pool_write_prefill_and_tables(model):
    _, _, cfg, _ = model
    pool = PagedKVPool(cfg, num_pages=8, page_size=4, max_seq_len=12)
    pool.alloc(5, 12)
    pages = pool.pages_of(5)
    dense = tuple((torch.randn(1, 4, 8, 8), torch.randn(1, 4, 8, 8))
                  for _ in range(cfg.n_layers))
    pool.write_prefill(5, dense)
    for (pk, pv), (ck, cv) in zip(pool.caches, dense):
        for j, page in enumerate(pages[:2]):
            assert torch.equal(pk[page], ck[0, :, 4 * j:4 * j + 4])
            assert torch.equal(pv[page], cv[0, :, 4 * j:4 * j + 4])
    np.testing.assert_array_equal(pool.table([5, None]),
                                  [pages, [0, 0, 0]])
    with pytest.raises(ValueError, match="page-aligned"):
        pool.write_prefill(5, tuple((torch.zeros(1, 4, 6, 8),) * 2
                                    for _ in range(2)))


# --------------------------------------------------------------------------- #
# the executor and the scheduler
# --------------------------------------------------------------------------- #

def test_executor_policy_warm_and_validation(model):
    _, _, cfg, params = model
    saved = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        ex = _executor(cfg, params)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert ex.device == torch.device("cpu")
    assert ex.prefills == 0 and ex.decode_calls == {1: 0, 2: 0, 4: 0}
    assert ex.pool.num_pages == 4 * 6 + 1 and ex.pool.all_free()
    assert ex.reserve_len(5, 6) == 11 and ex.reserve_len(3, 2) == 8
    assert [ex.rung_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    sched = ContinuousScheduler(ex, max_queue=4)
    try:
        assert sched._thread.daemon
        for bad, msg in (({"prompt": np.zeros((2, 3), np.int32)}, "1-D"),
                         ({"prompt": np.array([1, VOCAB])}, "token ids"),
                         ({"prompt": np.arange(9)}, "prompt bucket"),
                         ({"prompt": np.arange(8), "max_new": 17},
                          "max_seq_len"),
                         ({"prompt": np.arange(3), "max_new": 0},
                          "max_new")):
            with pytest.raises(ValueError, match=msg):
                sched.submit(bad)
    finally:
        sched.close()
    with pytest.raises(ValueError, match="learned positions"):
        _executor(cfg, params, max_seq_len=64)
    assert parse_rungs("8,1,4,4") == (1, 4, 8)
    with pytest.raises(ValueError):
        parse_rungs("0,2")


def test_scheduler_matches_dense_eos_and_streaming(model):
    """Concurrent submits through the iteration-level scheduler produce
    exactly the dense path's tokens (and the JAX package's); EOS retires a
    sequence at once; streaming chunks are cumulative."""
    from poseidon_tpu.models.generate import generate as jax_generate
    jcfg, jp, cfg, params = model
    B, P, MAX_NEW = 3, 6, 6
    prompt = _prompts(B, P)
    toks_d, _ = _dense(params, cfg, prompt, MAX_NEW)
    toks_j, _ = jax_generate(jp, jcfg, jnp.asarray(prompt), MAX_NEW)
    np.testing.assert_array_equal(toks_d, np.asarray(toks_j))

    ex = _executor(cfg, params)
    sched = ex.make_batcher(max_queue=16)
    try:
        results = [None] * B
        errs = [None] * B

        def worker(i):
            try:
                results[i] = sched.submit(
                    {"prompt": prompt[i], "max_new": MAX_NEW}, timeout_s=30)
            except BaseException as e:  # noqa: BLE001 — asserted below
                errs[i] = e

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(B)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert errs == [None] * B
        for i in range(B):
            np.testing.assert_array_equal(results[i]["tokens"], toks_d[i])
            assert results[i]["prompt_len"] == P

        eos = int(toks_d[0][0])
        r = sched.submit({"prompt": prompt[0], "max_new": 6, "eos_id": eos})
        assert r["n_new"] == 1 and int(r["tokens"][0]) == eos

        chunks = []
        r = sched.submit({"prompt": prompt[1], "max_new": 4,
                          "stream": lambda t: chunks.append(list(t))})
        assert [len(c) for c in chunks] == [1, 2, 3, 4]
        assert chunks[-1] == [int(t) for t in r["tokens"]]

        assert sched.wait_idle(10.0)
        assert ex.pool.all_free(), "retirement leaked pages"
        snap = sched.snapshot()
        assert snap["admitted"] == snap["retired"] == B + 2
        assert snap["ttft"]["count"] == B + 2
        assert ex.prefills == B + 2 and sum(ex.decode_calls.values()) > 0
    finally:
        sched.close()


def test_scheduler_sheds_and_deadlines_explicitly(model):
    """A full queue sheds with ShedError; a queued request whose deadline
    lapses before admission gets DeadlineError; both are counted."""
    _, _, cfg, params = model
    prompt = _prompts(1, 6)[0]
    ex = _executor(cfg, params)
    gate = threading.Event()
    real_decode = ex.decode

    def slow_decode(tok, table, pos):
        gate.wait(10.0)
        return real_decode(tok, table, pos)

    ex.decode = slow_decode
    sched = ContinuousScheduler(ex, max_queue=1)
    try:
        holder = threading.Thread(
            target=lambda: sched.submit({"prompt": prompt, "max_new": 6},
                                        timeout_s=30), daemon=True)
        holder.start()
        deadline = time.monotonic() + 5.0
        while sched.inflight_rows == 0:
            assert time.monotonic() < deadline, "first submit never admitted"
            time.sleep(0.005)
        doomed_err = []

        def doomed():
            try:
                sched.submit({"prompt": prompt, "max_new": 2},
                             deadline_s=0.01, timeout_s=30)
            except BaseException as e:  # noqa: BLE001 — asserted below
                doomed_err.append(e)

        q_filler = threading.Thread(target=doomed, daemon=True)
        q_filler.start()
        deadline = time.monotonic() + 5.0
        while sched.queue_depth == 0:
            assert time.monotonic() < deadline, "queue never filled"
            time.sleep(0.005)
        with pytest.raises(ShedError):
            sched.submit({"prompt": prompt, "max_new": 2})
        assert sched.shed_count == 1
        time.sleep(0.05)                 # the queued deadline lapses ...
        gate.set()                       # ... before admission resumes
        holder.join(timeout=30)
        q_filler.join(timeout=30)
        assert len(doomed_err) == 1 and isinstance(doomed_err[0],
                                                   DeadlineError)
        assert sched.deadline_expired >= 1
        assert sched.wait_idle(10.0)
        assert ex.pool.all_free()
    finally:
        gate.set()
        sched.close()


def test_static_mode_gang_admits_and_matches(model):
    _, _, cfg, params = model
    B, P, MAX_NEW = 4, 6, 5
    prompt = _prompts(B, P)
    toks_d, _ = _dense(params, cfg, prompt, MAX_NEW)
    ex = _executor(cfg, params)
    ex.scheduler_mode = "static"
    sched = ex.make_batcher(max_queue=16)
    try:
        assert sched.mode == "static"
        results = [None] * B

        def worker(i):
            results[i] = sched.submit(
                {"prompt": prompt[i], "max_new": MAX_NEW}, timeout_s=30)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(B)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        for i in range(B):
            np.testing.assert_array_equal(results[i]["tokens"], toks_d[i])
        assert sched.snapshot()["mode"] == "static"
        assert ex.pool.all_free()
    finally:
        sched.close()
    with pytest.raises(ValueError, match="continuous|static"):
        ContinuousScheduler(ex, mode="eager")


# --------------------------------------------------------------------------- #
# the wire
# --------------------------------------------------------------------------- #

def test_generate_over_socket_with_streaming_and_stats(model):
    _, _, cfg, params = model
    prompt = _prompts(2, 6)
    toks_d, _ = _dense(params, cfg, prompt, 6)
    ex = _executor(cfg, params)
    srv = InferenceServer(ex)
    cli = None
    try:
        cli = ServingClient(srv.addr)
        out = cli.generate(prompt[0], max_new=6)
        np.testing.assert_array_equal(out["tokens"], toks_d[0])
        chunks = []
        out = cli.generate(prompt[1], max_new=6, on_tokens=chunks.append)
        assert [len(c) for c in chunks] == [1, 2, 3, 4, 5, 6]
        np.testing.assert_array_equal(out["tokens"], toks_d[1])
        np.testing.assert_array_equal(chunks[-1], toks_d[1])
        with pytest.raises(ServingError, match="token ids"):
            cli.generate(np.array([VOCAB + 3]), max_new=2)
        r = run_load(srv.addr,
                     lambda i: {"prompt": prompt[i % 2], "max_new": 4},
                     n_requests=12, concurrency=3, op="generate")
        assert r["ok"] == 12 and r["error"] == 0
        assert r["tokens"] == 48 and r["goodput_tps"] > 0
        st = cli.stats()
        assert st["rows_served"] == 60 and st["rows_padded"] == 0
        assert st["scheduler"]["executor"]["prefills"] == 14
        assert cli.health()["ok"]
    finally:
        if cli is not None:
            cli.close()
        srv.shutdown()
    assert ex.pool.all_free()


def test_jax_client_generates_against_port_server(model):
    """Same wire protocol: the JAX package's client (codec negotiation,
    streaming, its load generator) is served by the port's server."""
    from poseidon_tpu.serving.client import ServingClient as JaxClient
    from poseidon_tpu.serving.client import run_load as jax_run_load
    _, _, cfg, params = model
    prompt = _prompts(2, 6, seed=4)
    toks_d, _ = _dense(params, cfg, prompt, 5)
    ex = _executor(cfg, params)
    srv = InferenceServer(ex)
    cli = None
    try:
        cli = JaxClient(srv.addr)
        out = cli.generate(prompt[0], max_new=5)
        np.testing.assert_array_equal(out["tokens"], toks_d[0])
        chunks = []
        out = cli.generate(prompt[1], max_new=5, on_tokens=chunks.append)
        assert [len(c) for c in chunks] == [1, 2, 3, 4, 5]
        np.testing.assert_array_equal(out["tokens"], toks_d[1])
        r = jax_run_load(srv.addr,
                         lambda i: {"prompt": prompt[i % 2], "max_new": 3},
                         n_requests=6, concurrency=2, op="generate")
        assert r["ok"] == 6 and r["tokens"] == 18
    finally:
        if cli is not None:
            cli.close()
        srv.shutdown()
    assert ex.pool.all_free()


def test_serve_generate_cli_subprocess_sigterm_drains():
    """`python -m poseidon_tpu_torch serve --generate --model tiny --device
    cpu` logs its address, generates, and exits 0 on SIGTERM with the final
    stats line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "poseidon_tpu_torch", "serve", "--generate",
         "--model", "tiny", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        port = None
        t_end = time.time() + 120
        while time.time() < t_end:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"listening on [\d.]+:(\d+) \(generate op\)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server never logged its address"
        cli = ServingClient(("127.0.0.1", port))
        chunks = []
        out = cli.generate(np.arange(5) * 7, max_new=4,
                           on_tokens=chunks.append)
        cli.close()
        assert out["n_new"] == 4 and len(chunks) == 4
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, rest
        final = [l for l in rest.splitlines() if "serving_final_stats" in l]
        stats = json.loads(final[-1])["serving_final_stats"]
        assert stats["rows_served"] == 4
        assert stats["scheduler"]["executor"]["pool"]["pages_used"] == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
