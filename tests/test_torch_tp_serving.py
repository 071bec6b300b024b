"""Tensor-parallel generate replicas on the CPU: the port's
``GenerateExecutor(mesh_cfg=MeshConfig(tp=T))`` (one controller over
head-sharded weights and a head-sharded paged KV pool) against the JAX
package's tp executor (GSPMD over the 8 virtual CPU devices of
tests/conftest.py) and its dense ``generate``.

The contracts: the tp-layout blocks (``tp_layout=``) and their shard forms
(``tp_prefill_cached``, ``tp_paged_decode_step``) give JAX's logits and
caches; the tp executor gives JAX's tp executor's tokens and logits at tp2
and tp4; each shard's pool pages hold the one-device pool's heads;
``swap_params`` validates global shapes with JAX's messages and swaps
every shard at once; the refusals; a fleet of tp2 replicas fails over and
rolls. The shards sit on ``("cpu", ...)``: a device may repeat. Tolerances:
logits rtol 1e-4, atol 1e-5 (tp splits the ``wo`` and ``w2`` contractions,
so they sum in another order than one device or XLA); pages rtol 1e-5.
Weights cross from the JAX package through ``params_from_jax``.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu_torch.config import MeshConfig
from poseidon_tpu_torch.models import generate as port_gen
from poseidon_tpu_torch.models import transformer as port_tf
from poseidon_tpu_torch.serving.continuous import GenerateExecutor

VOCAB = 64
RTOL, ATOL = 1e-4, 1e-5
PAGE_RTOL = 1e-5
KW = dict(page_size=4, decode_rungs=(1, 2), prompt_buckets=(8,),
          max_seq_len=24)


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


def _jax_weights(jcfg, seed):
    from poseidon_tpu.models.transformer import init_params
    jp = jax.tree_util.tree_map(np.asarray,
                                init_params(jcfg, jax.random.PRNGKey(seed)))
    return jp, port_tf.params_from_jax(jp)


def _prompts(b, p, seed=1):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, p)) \
        .astype(np.int32)


def _tp_executor(cfg, params, tp, **kw):
    return GenerateExecutor(cfg, params, mesh_cfg=MeshConfig(tp=tp),
                            devices=("cpu",) * tp, **{**KW, **kw})


def _jax_executor(jcfg, jp, tp=None):
    from poseidon_tpu.config import MeshConfig as JaxMeshConfig
    from poseidon_tpu.serving.continuous import \
        GenerateExecutor as JaxGenerateExecutor
    mesh = None if tp is None else JaxMeshConfig(tp=tp)
    return JaxGenerateExecutor(jcfg, jp, mesh_cfg=mesh, **KW)


def _jax_dense(jp, jcfg, prompt, max_new):
    from poseidon_tpu.models.generate import generate
    toks, logits = generate(jp, jcfg, jnp.asarray(prompt), max_new)
    return np.asarray(toks), np.asarray(logits)


def _paged_by_hand(ex, prompt, max_new, sid=1):
    """One request through an executor's paged path by hand (bucketed
    prefill, then rung-1 decode steps, greedy): per-step logits (max_new,
    V). Leaves the sequence's pages allocated."""
    ex.pool.alloc(sid, ex.reserve_len(len(prompt), max_new))
    logits, caches = ex.prefill(prompt)
    ex.pool.write_prefill(sid, caches)
    table = ex.pool.table([sid])
    steps = [np.asarray(logits)]
    for i in range(max_new - 1):
        tok = np.array([int(np.argmax(steps[-1]))], np.int32)
        pos = np.array([len(prompt) + i], np.int32)
        steps.append(np.asarray(ex.decode(tok, table, pos))[0])
    return np.stack(steps)


def _serve(sched, prompts, max_new):
    """Every prompt submitted from its own thread; the replies' tokens."""
    results = [None] * len(prompts)

    def worker(i):
        results[i] = sched.submit({"prompt": prompts[i], "max_new": max_new},
                                  timeout_s=60)

    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "a submit wedged"
    return [r["tokens"] for r in results]


# --------------------------------------------------------------------------- #
# the tp-layout blocks and their shard forms
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_tp_layout_prefill_and_paged_decode_match_jax(model, n_shards):
    """``prefill_cached``/``paged_decode_step(tp_layout=True)`` on the
    head-major tree and the shard forms over ``n_shards`` shards give JAX's
    ``tp_layout=True`` logits, caches and written pages."""
    from poseidon_tpu.models import generate as jax_gen
    from poseidon_tpu.models.transformer import to_tp_layout
    jcfg, jp, cfg, params = model
    jtp = to_tp_layout(jax.tree_util.tree_map(jnp.asarray, jp), jcfg)
    ptp = port_tf.to_tp_layout(params, cfg)
    shards = [port_tf.tp_shard(ptp, cfg, t, n_shards)
              for t in range(n_shards)]
    hl = cfg.n_heads // n_shards
    toks = _prompts(2, 8, seed=3)
    last = np.array([7, 4], np.int32)
    jl, jc = jax_gen.prefill_cached(jtp, jcfg, jnp.asarray(toks),
                                    jnp.asarray(last), 12, tp_layout=True)
    with torch.inference_mode():
        pl, pc = port_gen.prefill_cached(
            ptp, cfg, torch.from_numpy(toks).long(), torch.from_numpy(last),
            12, tp_layout=True)
        sl, sc = port_gen.tp_prefill_cached(
            shards, cfg, torch.from_numpy(toks).long(),
            torch.from_numpy(last), 12)
    for got in (pl, sl):
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    for i, (jk, jv) in enumerate(jc):
        for j, want in enumerate((jk, jv)):
            want = np.asarray(want)
            np.testing.assert_allclose(pc[i][j].numpy(), want, rtol=RTOL,
                                       atol=ATOL)
            for t in range(n_shards):
                np.testing.assert_allclose(
                    sc[t][i][j].numpy(), want[:, t * hl:(t + 1) * hl],
                    rtol=RTOL, atol=ATOL)

    # one decode step over random page pools: rows at positions 9 and 2,
    # a padding row on the scratch page
    rs = np.random.RandomState(5)
    dh = cfg.d_model // cfg.n_heads
    pools = [tuple(rs.randn(6, cfg.n_heads, 4, dh).astype(np.float32)
                   for _ in range(2)) for _ in range(cfg.n_layers)]
    table = np.array([[1, 2, 3], [4, 0, 0], [0, 0, 0]], np.int32)
    pos = np.array([9, 2, 0], np.int32)
    tok = np.array([5, 17, 0], np.int32)
    jl, jpools = jax_gen.paged_decode_step(
        jtp, jcfg, jnp.asarray(tok),
        tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
        jnp.asarray(table), jnp.asarray(pos), tp_layout=True)
    whole = tuple((torch.tensor(k), torch.tensor(v)) for k, v in pools)
    split = [tuple((torch.tensor(k[:, t * hl:(t + 1) * hl]),
                    torch.tensor(v[:, t * hl:(t + 1) * hl]))
                   for k, v in pools) for t in range(n_shards)]
    args = (torch.from_numpy(table), torch.from_numpy(pos))
    with torch.inference_mode():
        pl, _ = port_gen.paged_decode_step(ptp, cfg, torch.from_numpy(tok),
                                           whole, *args, tp_layout=True)
        sl, _ = port_gen.tp_paged_decode_step(shards, cfg,
                                              torch.from_numpy(tok), split,
                                              *args)
    for got in (pl, sl):
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    for i, (jk, jv) in enumerate(jpools):
        for j, want in enumerate((jk, jv)):
            want = np.asarray(want)
            np.testing.assert_allclose(whole[i][j].numpy(), want,
                                       rtol=RTOL, atol=ATOL)
            for t in range(n_shards):
                np.testing.assert_allclose(
                    split[t][i][j].numpy(), want[:, t * hl:(t + 1) * hl],
                    rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# the tp executor
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_sharded_replica_matches_one_device(model, tp):
    """The counterpart of JAX's ``test_tp2_sharded_replica_matches_one_
    device``, at tp2 and tp4: the port's tp executor serves JAX's tp
    executor's tokens and JAX's dense tokens under concurrent submits;
    prefill and decode logits agree with both; every page comes back;
    ``snapshot()["mesh"]`` is JAX's."""
    jcfg, jp, cfg, params = model
    B, P, MAX_NEW = 2, 6, 6
    prompts = _prompts(B, P)
    toks_d, logits_d = _jax_dense(jp, jcfg, prompts, MAX_NEW)
    ex = _tp_executor(cfg, params, tp)
    jex = _jax_executor(jcfg, jp, tp)
    sched, jsched = ex.make_batcher(max_queue=8), jex.make_batcher(
        max_queue=8)
    try:
        got = _serve(sched, list(prompts), MAX_NEW)
        want = _serve(jsched, list(prompts), MAX_NEW)
    finally:
        sched.close()
        jsched.close()
    for i in range(B):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], toks_d[i])
    assert ex.pool.all_free() and jex.pool.all_free()
    assert ex.snapshot()["mesh"] == jex.snapshot()["mesh"] \
        == f"dp1,fsdp1,tp{tp}"
    for i in range(B):
        mine = _paged_by_hand(ex, prompts[i], MAX_NEW, sid=i)
        theirs = _paged_by_hand(jex, prompts[i], MAX_NEW, sid=i)
        np.testing.assert_allclose(mine, theirs, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mine, logits_d[i], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(np.argmax(mine, -1), toks_d[i])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_pool_shards_hold_the_one_device_heads(model, tp):
    """After the same request, shard t's pages hold heads [t*H/tp,
    (t+1)*H/tp) of the one-device executor's pages, every layer, K and V;
    one allocator gave both pools the same page ids."""
    _, _, cfg, params = model
    prompt = _prompts(1, 6, seed=4)[0]
    ex = _tp_executor(cfg, params, tp)
    one = GenerateExecutor(cfg, params, device="cpu", **KW)
    for e in (ex, one):
        _paged_by_hand(e, prompt, 5)
    pages = ex.pool.pages_of(1)
    assert pages == one.pool.pages_of(1)
    assert len(ex.pool.shard_caches) == tp
    hl = cfg.n_heads // tp
    for t, shard in enumerate(ex.pool.shard_caches):
        for (pk, pv), (ok, ov) in zip(shard, one.pool.caches):
            assert pk.shape == (ex.pool.num_pages, hl, 4, 8)
            for got, want in ((pk, ok), (pv, ov)):
                np.testing.assert_allclose(
                    got[pages].numpy(),
                    want[pages][:, t * hl:(t + 1) * hl].numpy(),
                    rtol=PAGE_RTOL, atol=1e-6)
    ex.pool.free(1)
    assert ex.pool.all_free()


def test_tp_swap_params_tokens_and_refusals(model):
    """``swap_params`` on a tp executor: the refusal strings equal JAX's tp
    executor's, with the global shapes; a refused tree leaves the serving
    shards alone; after an accepted swap the tokens are JAX's for the new
    params, and every shard holds its slices of them on its device."""
    jcfg, jp, cfg, params = model
    jp_b, params_b = _jax_weights(jcfg, 9)
    prompt = _prompts(1, 6)
    toks_b, _ = _jax_dense(jp_b, jcfg, prompt, 5)
    toks_a, _ = _jax_dense(jp, jcfg, prompt, 5)
    assert not np.array_equal(toks_a, toks_b), "seeds collide; bad fixture"
    ex = _tp_executor(cfg, params, 2)
    jex = _jax_executor(jcfg, jp, 2)
    missing = {n: dict(d) for n, d in params.items()}
    missing.pop(sorted(missing)[-1])
    jmissing = dict(jp)
    jmissing.pop(sorted(jmissing)[-1])
    cases = [(missing, jmissing)]
    for name, leaf in (("block0", "ln1_b"), ("block1", "w2"),
                       ("head", "w")):
        ours = {n: dict(d) for n, d in params.items()}
        ours[name][leaf] = ours[name][leaf][..., :-1]
        theirs = {n: dict(d) for n, d in jp.items()}
        theirs[name][leaf] = theirs[name][leaf][..., :-1]
        cases.append((ours, theirs))
    before = [sh["block1"]["w2"].clone() for sh in ex._params]
    said = []
    for ours, theirs in cases:
        with pytest.raises(ValueError) as want:
            jex.swap_params(theirs)
        with pytest.raises(ValueError) as got:
            ex.swap_params(ours)
        assert str(got.value) == str(want.value)
        said.append(str(got.value))
    # the global shape of a sharded leaf (w2: (32, 128)), not a shard's
    assert said[2] == ("params leaf mismatch: (32, 127)/float32 vs serving "
                       "(32, 128)/float32")
    assert ex.params_version == 0
    assert all(torch.equal(b, sh["block1"]["w2"])
               for b, sh in zip(before, ex._params))

    assert ex.swap_params(jp_b) == 1
    want_shards = [port_tf.tp_shard(port_tf.to_tp_layout(params_b, cfg), cfg,
                                    t, 2) for t in range(2)]
    for sh, want in zip(ex._params, want_shards):
        for leaf in port_tf.TP_SPLIT_DIM:
            assert torch.equal(sh["block0"][leaf], want["block0"][leaf])
    sched = ex.make_batcher(max_queue=4)
    try:
        out = sched.submit({"prompt": prompt[0], "max_new": 5},
                           timeout_s=60)
    finally:
        sched.close()
    np.testing.assert_array_equal(out["tokens"], toks_b[0])


def test_tp_decode_racing_swaps_sees_one_version_on_every_shard(model):
    """A decode step racing ``swap_params`` reads one params version on
    every shard: under a shortened switch interval, each of many steps on
    the scratch page (a result that depends on the params only) equals
    the step under the old params or under the new, never a mix of old
    shard 0 and new shard 1."""
    jcfg, _, cfg, params = model
    _, params_b = _jax_weights(jcfg, 9)
    ex = _tp_executor(cfg, params, 2)
    args = (np.array([7, 3], np.int64), np.zeros((2, 6), np.int64),
            np.zeros((2,), np.int64))
    ref_a = ex.decode(*args)
    ex.swap_params(params_b)
    ref_b = ex.decode(*args)
    ex.swap_params(params)
    # the mix a torn swap would give: shard 0 of one version, shard 1 of
    # the other, is far from both
    va, vb = ex._params, ex._place(params_b, copy=False)
    ex._params = (va[0], vb[1])
    mixed = ex.decode(*args)
    ex._params = va
    assert not np.allclose(mixed, ref_a, rtol=RTOL, atol=ATOL)
    assert not np.allclose(mixed, ref_b, rtol=RTOL, atol=ATOL)

    seen, errors = [], []
    stop = threading.Event()

    def decoder():
        try:
            while not stop.is_set():
                seen.append(ex.decode(*args))
        except Exception as e:  # noqa: BLE001 — the assertion reads it
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=decoder, daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 30
        for i in range(40):
            ex.swap_params(params_b if i % 2 == 0 else params)
            assert time.monotonic() < deadline, "swaps too slow"
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not t.is_alive() and not errors, errors
    assert ex.params_version == 42 and len(seen) > 0
    for logits in seen:
        assert (np.allclose(logits, ref_a, rtol=RTOL, atol=ATOL)
                or np.allclose(logits, ref_b, rtol=RTOL, atol=ATOL))


def test_tp_executor_refusals(model):
    """The tp executor's refusals: ``device=`` with ``mesh_cfg=`` and
    indivisible heads or d_ff with JAX's messages; an MoE config with JAX's
    paged-decode message; ``data``/``fsdp`` > 1 (more copies are more
    replicas); no CUDA device and no ``devices=`` (no fallback to the CPU,
    no two shards quietly on one card); a ``devices=`` of the wrong length
    or without ``mesh_cfg=``."""
    from poseidon_tpu.config import MeshConfig as JaxMeshConfig
    from poseidon_tpu.models import generate as jax_gen
    from poseidon_tpu.models import moe as jax_moe
    from poseidon_tpu.serving.continuous import \
        GenerateExecutor as JaxGenerateExecutor
    from poseidon_tpu_torch.models import moe as port_moe
    jcfg, jp, cfg, params = model

    def both(jkw, pkw, exc=ValueError):
        with pytest.raises(exc) as want:
            JaxGenerateExecutor(jcfg, jp, **KW, **jkw)
        with pytest.raises(exc) as got:
            GenerateExecutor(cfg, params, **KW, **pkw)
        assert str(got.value) == str(want.value)

    both({"device": jax.devices()[0], "mesh_cfg": JaxMeshConfig(tp=2)},
         {"device": "cpu", "mesh_cfg": MeshConfig(tp=2)})
    both({"mesh_cfg": JaxMeshConfig(tp=3)},
         {"mesh_cfg": MeshConfig(tp=3), "devices": ("cpu",) * 3})
    with pytest.raises(NotImplementedError) as want:
        jax_gen.paged_decode_step(
            jp, jax_moe.MoEConfig(base=jcfg, n_experts=4),
            jnp.zeros(1, jnp.int32), (), jnp.zeros((1, 1), jnp.int32),
            jnp.zeros(1, jnp.int32))
    with pytest.raises(NotImplementedError) as got:
        GenerateExecutor(port_moe.MoEConfig(base=cfg, n_experts=4), params,
                         mesh_cfg=MeshConfig(tp=2), devices=("cpu", "cpu"),
                         **KW)
    assert str(got.value) == str(want.value) and "MoE" in str(got.value)
    for mesh in (MeshConfig(data=2, tp=2), MeshConfig(fsdp=2, tp=2),
                 MeshConfig(fsdp=2)):
        with pytest.raises(ValueError, match="serve more replicas"):
            GenerateExecutor(cfg, params, mesh_cfg=mesh,
                             devices=("cpu",) * mesh.tp, **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass devices="):
            GenerateExecutor(cfg, params, mesh_cfg=MeshConfig(tp=2), **KW)
        with pytest.raises(RuntimeError, match="CUDA device"):
            GenerateExecutor(cfg, params, mesh_cfg=MeshConfig(tp=2),
                             devices=("cuda:0", "cuda:0"), **KW)
    with pytest.raises(ValueError, match="names 3 devices for tp=2"):
        GenerateExecutor(cfg, params, mesh_cfg=MeshConfig(tp=2),
                         devices=("cpu",) * 3, **KW)
    with pytest.raises(ValueError, match="pass it with mesh_cfg="):
        GenerateExecutor(cfg, params, devices=("cpu", "cpu"), **KW)


# --------------------------------------------------------------------------- #
# a fleet of tp replicas
# --------------------------------------------------------------------------- #

def _tp_fleet(cfg, params, poison=False, **mgr_kw):
    """Two tp2 replicas through ``ReplicaManager.build``, each handed the
    device group ("cpu", "cpu") as its opaque device; with ``poison`` each
    executor's decode dies once its ``die`` event is set."""
    from poseidon_tpu_torch.serving.fleet import ReplicaManager
    exs = []

    def factory(group):
        ex = GenerateExecutor(cfg, params, mesh_cfg=MeshConfig(tp=2),
                              devices=group, default_max_new=4, **KW)
        if poison:
            ex.die = threading.Event()
            real = ex.decode

            def decode(tok, table, pos, ex=ex, real=real):
                if ex.die.is_set():
                    raise RuntimeError("device lost")
                return real(tok, table, pos)
            ex.decode = decode
        exs.append(ex)
        return ex

    group = ("cpu", "cpu")
    mgr = ReplicaManager.build(factory, 2, devices=[group, group], **mgr_kw)
    assert [r.device_label for r in mgr.replicas] == [str(group)] * 2
    return mgr, exs


def test_fleet_of_tp_replicas_loses_no_request_to_a_death(model):
    """Two tp2 replicas under 6 submitting threads; one dies mid-
    generation. No accepted request is lost (the survivor prefills them
    again), every reply holds JAX's greedy tokens, and every page of every
    replica (each shard's, one allocator) is back on its free list."""
    from poseidon_tpu_torch.serving.fleet import DEAD
    jcfg, jp, cfg, params = model
    prompts = _prompts(4, 6)
    want, _ = _jax_dense(jp, jcfg, prompts, 4)
    mgr, exs = _tp_fleet(cfg, params, poison=True)
    results, errors = [], []
    lock = threading.Lock()

    def client(c):
        for i in range(c, 60, 6):
            try:
                out, _ = mgr.submit({"prompt": prompts[i % 4],
                                     "max_new": 4}, timeout_s=60)
                with lock:
                    results.append((i % 4, out["tokens"]))
            except Exception as e:  # noqa: BLE001 — the assertion reads it
                with lock:
                    errors.append(e)

    try:
        ts = [threading.Thread(target=client, args=(c,), daemon=True)
              for c in range(6)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 60
        while sum(ex.rows_served for ex in exs) < 20:
            assert time.monotonic() < deadline, "load never started"
            time.sleep(0.002)
        exs[0].die.set()                 # decode dies mid-generation
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts), "a client wedged"
        assert not errors, errors
        assert len(results) == 60
        assert all(np.array_equal(toks, want[k]) for k, toks in results)
        assert mgr.state_counts()[DEAD] == 1 and mgr.deaths == 1
        assert mgr.failovers >= 1
    finally:
        mgr.shutdown()
    for i, ex in enumerate(exs):
        assert ex.pool.all_free(), f"replica {i} leaked pages"


def test_fleet_of_tp_replicas_rolls_one_at_a_time(model):
    """A rolling reload over two tp2 replicas under load: at most one
    replica draining at any instant (from the transition log), no request
    fails, and afterwards every replica serves JAX's tokens for the new
    params."""
    from poseidon_tpu_torch.serving.fleet import DRAINING
    jcfg, jp, cfg, params = model
    jp_b, params_b = _jax_weights(jcfg, 9)
    prompt = _prompts(1, 6)
    toks_a, _ = _jax_dense(jp, jcfg, prompt, 4)
    toks_b, _ = _jax_dense(jp_b, jcfg, prompt, 4)
    transitions, tr_lock = [], threading.Lock()

    def observer(index, old, new, reason):
        with tr_lock:
            transitions.append((index, old, new))

    mgr, exs = _tp_fleet(cfg, params, on_transition=observer)
    stop, errors, seen = threading.Event(), [], []

    def hammer():
        while not stop.is_set():
            try:
                out, _ = mgr.submit({"prompt": prompt[0], "max_new": 4},
                                    timeout_s=60)
                seen.append(out["tokens"])
            except Exception as e:  # noqa: BLE001 — the assertion reads it
                errors.append(e)
                return

    ts = [threading.Thread(target=hammer, daemon=True) for _ in range(3)]
    try:
        for t in ts:
            t.start()
        time.sleep(0.1)
        assert mgr.rolling_reload(params_b) == 2
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts) and not errors, errors
        assert mgr.max_concurrent_draining == 1
        draining, most = set(), 0
        for index, old, new in transitions:
            if new == DRAINING:
                draining.add(index)
            elif old == DRAINING:
                draining.discard(index)
            most = max(most, len(draining))
        assert most == 1
        assert all(np.array_equal(s, toks_a[0]) or np.array_equal(
            s, toks_b[0]) for s in seen)
        for rep in mgr.replicas:
            out = rep.batcher.submit({"prompt": prompt[0], "max_new": 4})
            np.testing.assert_array_equal(out["tokens"], toks_b[0])
        assert all(ex.params_version == 1 for ex in exs)
    finally:
        stop.set()
        mgr.shutdown()
    assert all(ex.pool.all_free() for ex in exs)
