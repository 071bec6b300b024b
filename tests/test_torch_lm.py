"""The port's transformer LM on the CPU against the JAX package: config and
parameters, the forward pass, the serving prefill, greedy decoding, and the
numeric traps of the LM path (tanh GELU, the two attention scales, the two
masks, the qkv split). Weights cross through ``params_from_jax``; inputs
are numpy seeds.

Tolerance: rtol 1e-4, atol 1e-5 on logits and caches (float32 on both
sides; XLA and torch's CPU GEMMs sum in different orders, and the error
grows through the layers); greedy tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.models import generate as jax_gen
from poseidon_tpu.models import transformer as jax_tf
from poseidon_tpu_torch.models import generate as port_gen
from poseidon_tpu_torch.models import transformer as port_tf

RTOL, ATOL = 1e-4, 1e-5
VOCAB = 64


@pytest.fixture(scope="module")
def model():
    """The tiny config (d_head 8, where a multiply by dh**-0.5 and a divide
    by sqrt(dh) round differently) with JAX-initialized weights on both
    sides."""
    jcfg = jax_tf.TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=4,
                                    n_layers=2, d_ff=128, max_seq=32)
    pcfg = port_tf.TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=4,
                                     n_layers=2, d_ff=128, max_seq=32)
    jp = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, pcfg, jp, port_tf.params_from_jax(jp)


def _tokens(b, s, seed=1):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s)) \
        .astype(np.int32)


def test_configs_and_param_counts_match_jax():
    j = jax_tf.gpt_small_config(max_seq=512, remat=False)
    p = port_tf.gpt_small_config(max_seq=512)
    for f in dataclasses.fields(p):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.n_params() == j.n_params() == 135_697_920
    tiny = port_tf.TransformerConfig(vocab_size=256, d_model=32, n_heads=4,
                                     n_layers=2, d_ff=128, max_seq=128)
    assert tiny.n_params() == jax_tf.TransformerConfig(
        vocab_size=256, d_model=32, n_heads=4, n_layers=2, d_ff=128,
        max_seq=128).n_params()


def test_init_params_tree_matches_jax(model):
    jcfg, pcfg, jp, _ = model
    tp = port_tf.init_params(pcfg, torch.Generator().manual_seed(0))
    assert set(tp) == set(jp)
    for name in jp:
        assert set(tp[name]) == set(jp[name]), name
        for leaf, v in jp[name].items():
            assert tuple(tp[name][leaf].shape) == v.shape, (name, leaf)
            assert tp[name][leaf].dtype == torch.float32
    # the JAX package's scales: unit-variance / sqrt(fan_in), 0.02 embeds
    big = port_tf.init_params(port_tf.TransformerConfig(
        vocab_size=512, d_model=64, n_heads=4, n_layers=1, d_ff=256,
        max_seq=64), torch.Generator().manual_seed(1))
    assert abs(float(big["embed"]["w"].std()) - 0.02) < 1e-3
    assert abs(float(big["block0"]["w2"].std()) - 256 ** -0.5) < 3e-3
    assert torch.equal(big["block0"]["ln1_g"], torch.ones(64))
    again = port_tf.init_params(pcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(tp[n][l], again[n][l]) for n in tp for l in tp[n])


def test_params_from_jax_copies_every_leaf(model):
    _, _, jp, tp = model
    for name in jp:
        for leaf, v in jp[name].items():
            assert np.array_equal(tp[name][leaf].numpy(), v), (name, leaf)


@pytest.mark.parametrize("seq", [16, 7])
def test_forward_matches_jax(model, seq):
    """seq 16 routes attention through the flash path, 7 through dense."""
    jcfg, pcfg, jp, tp = model
    toks = _tokens(2, seq)
    want = np.asarray(jax_tf.forward(jp, jcfg, jnp.asarray(toks)))
    with torch.inference_mode():
        got = port_tf.forward(tp, pcfg, torch.from_numpy(toks)).numpy()
    assert got.shape == (2, seq, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lm_loss_matches_jax(model):
    jcfg, pcfg, jp, tp = model
    toks = _tokens(2, 16, seed=2)
    logits = np.array(jax_tf.forward(jp, jcfg, jnp.asarray(toks[:, :-1])))
    want = float(jax_tf.lm_loss(jnp.asarray(logits),
                                jnp.asarray(toks[:, 1:])))
    got = float(port_tf.lm_loss(torch.from_numpy(logits),
                                torch.from_numpy(toks[:, 1:])))
    assert got == pytest.approx(want, rel=1e-6)


def test_gelu_is_the_tanh_form(model):
    """jax.nn.gelu defaults to the tanh approximation; F.gelu to erf. The
    FFN sublayer must use the tanh form."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    # the two tanh forms cancel differently in the far negative tail
    # (1e-7 absolute at gelu(x) ~ -1e-3); the erf form is 1e-4 away
    np.testing.assert_allclose(tanh.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(erf.numpy() - np.asarray(jax.nn.gelu(x))).max() > 1e-4
    _, _, jp, tp = model
    h = np.random.RandomState(3).randn(2, 5, 32).astype(np.float32) * 2
    want = np.asarray(jax_tf.ffn_sublayer(jnp.asarray(h), jp["block0"]))
    got = port_tf.ffn_sublayer(torch.from_numpy(h), tp["block0"]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cached_and_paged_attends_match_jax_scale_and_mask():
    """The cached/paged attends divide by sqrt(dh) and mask with -inf
    (models/generate.py:36, 169); a row at position 0 sees key 0 only."""
    rs = np.random.RandomState(4)
    q = rs.randn(2, 4, 3, 8).astype(np.float32)
    ck = rs.randn(2, 4, 10, 8).astype(np.float32)
    cv = rs.randn(2, 4, 10, 8).astype(np.float32)
    want = np.asarray(jax_gen._attend_cached(jnp.asarray(q), jnp.asarray(ck),
                                             jnp.asarray(cv), 4))
    got = port_gen._attend_cached(torch.from_numpy(q), torch.from_numpy(ck),
                                  torch.from_numpy(cv), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pos = np.array([0, 6], np.int32)
    want = np.asarray(jax_gen._attend_paged(
        jnp.asarray(q[:, :, :1]), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos)))
    got = port_gen._attend_paged(torch.from_numpy(q[:, :, :1]),
                                 torch.from_numpy(ck), torch.from_numpy(cv),
                                 torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0, :, 0], cv[0, :, 0])


def test_block_cached_matches_jax_qkv_split_and_cache_writes(model):
    """The qkv rows split as reshape(b, s, 3, H, dh): q, k, v and the cache
    writes at pos0 agree with the JAX block (prefill and one decode
    step)."""
    jcfg, pcfg, jp, tp = model
    rs = np.random.RandomState(5)
    x = rs.randn(1, 8, 32).astype(np.float32)
    jk = jnp.zeros((1, 4, 12, 8))
    jv = jnp.zeros((1, 4, 12, 8))
    pk, pv = torch.zeros(1, 4, 12, 8), torch.zeros(1, 4, 12, 8)
    jx, jk, jv = jax_gen._block_cached(jcfg, jnp.asarray(x), jp["block0"],
                                       jk, jv, 0, prefill=True)
    with torch.inference_mode():
        px, pk, pv = port_gen._block_cached(pcfg, torch.from_numpy(x),
                                            tp["block0"], pk, pv, 0,
                                            prefill=True)
    for a, b in ((px, jx), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    x1 = rs.randn(1, 1, 32).astype(np.float32)
    jx, jk, _ = jax_gen._block_cached(jcfg, jnp.asarray(x1), jp["block0"],
                                      jk, jv, 8)
    with torch.inference_mode():
        px, pk, _ = port_gen._block_cached(pcfg, torch.from_numpy(x1),
                                           tp["block0"], pk, pv, 8)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=RTOL,
                               atol=ATOL)


def test_prefill_cached_matches_jax(model):
    """Right-padded prompts at a bucket of 8, logits gathered at last_idx,
    caches of the page-aligned total 12."""
    jcfg, pcfg, jp, tp = model
    toks = _tokens(2, 8, seed=6)
    last = np.array([5, 7], np.int32)
    jl, jc = jax_gen.prefill_cached(jp, jcfg, jnp.asarray(toks),
                                    jnp.asarray(last), 12)
    with torch.inference_mode():
        pl, pc = port_gen.prefill_cached(tp, pcfg, torch.from_numpy(toks),
                                         torch.from_numpy(last), 12)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    assert len(pc) == len(jc) == 2
    for (pk, pv), (jk, jv) in zip(pc, jc):
        assert tuple(pk.shape) == jk.shape == (2, 4, 12, 8)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("prompt_len", [6, 16])
def test_greedy_generate_matches_jax(model, prompt_len):
    jcfg, pcfg, jp, tp = model
    prompt = _tokens(2, prompt_len, seed=7)
    jt, jl = jax_gen.generate(jp, jcfg, jnp.asarray(prompt), 8)
    pt, pl = port_gen.generate(tp, pcfg, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_sampling_draws_from_the_generator(model):
    _, pcfg, _, tp = model
    prompt = torch.from_numpy(_tokens(2, 6, seed=8))
    a, _ = port_gen.generate(tp, pcfg, prompt, 6, temperature=1.0,
                             generator=torch.Generator().manual_seed(3))
    b, _ = port_gen.generate(tp, pcfg, prompt, 6, temperature=1.0,
                             generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    greedy, _ = port_gen.generate(tp, pcfg, prompt, 6)
    draws = {tuple(port_gen.generate(
        tp, pcfg, prompt, 6, temperature=5.0,
        generator=torch.Generator().manual_seed(s))[0].flatten().tolist())
        for s in range(4)}
    assert len(draws) > 1 and greedy.shape == a.shape
    with pytest.raises(ValueError, match="Generator"):
        port_gen.generate(tp, pcfg, prompt, 6, temperature=1.0)
    with pytest.raises(ValueError, match="max_seq"):
        port_gen.generate(tp, pcfg, prompt, 27)


def test_unported_branches_raise(model):
    _, pcfg, _, tp = model

    class MoELike:
        base = pcfg

    x = torch.zeros(1, 4, 32)
    with pytest.raises(NotImplementedError, match="ring attention"):
        port_tf.attention_sublayer(pcfg, x, tp["block0"], seq_axis="seq")
    with pytest.raises(NotImplementedError, match="MoE"):
        port_gen.prefill_cached(tp, MoELike(), torch.zeros(1, 4,
                                                          dtype=torch.long),
                                torch.tensor([3]), 4)
    with pytest.raises(NotImplementedError, match="MoE"):
        port_gen.paged_decode_step(tp, MoELike(), torch.zeros(1), (),
                                   torch.zeros(1, 1), torch.zeros(1))
