"""The port's LM training slice on the CPU against the JAX package: the remat
policy names and their resolution, the per-leaf update rule over a tree,
the one-device ``build_dp_sp_train_step`` against JAX's on a 1x1
(data, seq) mesh, LM snapshots crossing both ways, and the
``models.train_lm`` script.

Tolerances: the train step's loss and params after each of 3 steps at
rtol 1e-4, atol 1e-5 (JAX's CPU step runs the dense ring formulation and
XLA's GEMMs, the port the plain flash versions and torch's; f32 on both
sides); the update rule at rtol 1e-6, atol 1e-7 (the same f32 formula,
which XLA may contract into FMAs); snapshots and policy names exactly; the
loss across remat policies exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from poseidon_tpu.core import remat as jax_remat
from poseidon_tpu.models import transformer as jax_tf
from poseidon_tpu.proto.messages import SolverParameter as JaxSP
from poseidon_tpu.runtime import lm_checkpoint as jax_ckpt
from poseidon_tpu.solvers import updates as jax_upd
from poseidon_tpu_torch.core import remat as port_remat
from poseidon_tpu_torch.models import train_lm as port_train_lm
from poseidon_tpu_torch.models import transformer as port_tf
from poseidon_tpu_torch.proto.messages import SolverParameter as PortSP
from poseidon_tpu_torch.runtime import lm_checkpoint as port_ckpt
from poseidon_tpu_torch.solvers import updates as port_upd

STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
UPD_RTOL, UPD_ATOL = 1e-6, 1e-7
VOCAB = 64
SOLVER = dict(base_lr=0.1, lr_policy="fixed", momentum=0.9,
              weight_decay=5e-4)


def _cfgs(remat):
    kw = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, d_ff=128,
              max_seq=16, remat=remat)
    return jax_tf.TransformerConfig(**kw), port_tf.TransformerConfig(**kw)


def _jax_params(jcfg):
    return jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(seed=1, b=2, s=16):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (b, s)).astype(np.int32),
            rs.randint(0, VOCAB, (b, s)).astype(np.int32))


_POLICY_CASES = [None, False, True, "", "none", "dots_saveable",
                 "nothing_saveable", "auto", "AUTO", "Nothing_Saveable"]


@pytest.mark.parametrize("value", _POLICY_CASES + ["bogus"])
def test_normalize_policy_matches_jax(value):
    try:
        want = jax_remat.normalize_policy(value)
    except ValueError:
        with pytest.raises(ValueError, match="unknown remat policy"):
            port_remat.normalize_policy(value)
        return
    assert port_remat.normalize_policy(value) == want
    assert port_remat.REMAT_POLICIES == jax_remat.REMAT_POLICIES


def test_resolve_lm_policy_matches_jax_on_every_case():
    """Every (config flag, plan row) pair: the same policy, or the same
    conflict refusal."""
    plans = [None, "none", "dots_saveable", "nothing_saveable", "auto"]
    conflicts = 0
    for cfg_remat in _POLICY_CASES:
        for plan in plans:
            try:
                want = jax_remat.resolve_lm_policy(cfg_remat, plan)
            except ValueError:
                conflicts += 1
                with pytest.raises(ValueError, match="conflict"):
                    port_remat.resolve_lm_policy(cfg_remat, plan)
                continue
            got = port_remat.resolve_lm_policy(cfg_remat, plan)
            assert got == want, (cfg_remat, plan)
    assert conflicts > 0


def test_checkpoint_policy_and_unported_planner():
    assert port_remat.checkpoint_policy("nothing_saveable") is None
    assert callable(port_remat.checkpoint_policy("dots_saveable"))
    for name in ("none", "auto"):
        with pytest.raises(ValueError, match="resolve it first"):
            port_remat.checkpoint_policy(name)
    fn = lambda x: x * 2  # noqa: E731
    assert port_remat.wrap_checkpoint(fn, "none") is fn
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        port_remat.RematPlan()
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        port_remat.plan_remat({}, 0, 0)


@pytest.mark.parametrize("solver_type", ["SGD", "NESTEROV", "ADAGRAD"])
def test_make_update_fn_matches_jax_per_leaf_rule(solver_type):
    """Two updates over a small tree with the transformer's multipliers
    (weights decay, gains and biases do not)."""
    rs = np.random.RandomState(60)
    tree = {"embed": {"w": rs.randn(6, 4)},
            "block0": {"wqkv": rs.randn(12, 4), "ln1_g": rs.randn(4),
                       "ln1_b": rs.randn(4)}}
    tree = {n: {l: v.astype(np.float32) for l, v in d.items()}
            for n, d in tree.items()}
    grads = [{n: {l: rs.randn(*v.shape).astype(np.float32)
                  for l, v in d.items()} for n, d in tree.items()}
             for _ in range(2)]
    kw = dict(SOLVER, solver_type=solver_type, delta=1e-8)
    mults = port_tf.transformer_mults(tree)
    assert mults == jax_tf.transformer_mults(tree)
    jupd = jax_upd.make_update_fn(JaxSP(**kw), mults)
    pupd = port_upd.make_update_fn(PortSP(**kw), mults)
    jp, js = tree, jax_upd.init_state(tree)
    pp = port_tf.params_from_jax(tree)
    ps = port_upd.init_state(pp)
    for g in grads:
        jp, js = jupd(jp, g, js)
        pp, ps = pupd(pp, port_tf.params_from_jax(g), ps)
    assert ps.it == int(js.it) == 2
    for n in tree:
        for l in tree[n]:
            np.testing.assert_allclose(pp[n][l].numpy(), np.asarray(jp[n][l]),
                                       rtol=UPD_RTOL, atol=UPD_ATOL)
            np.testing.assert_allclose(ps.history[n][l].numpy(),
                                       np.asarray(js.history[n][l]),
                                       rtol=UPD_RTOL, atol=UPD_ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax_dp_sp_on_one_device(remat):
    """Three steps of the port's step against JAX's build_dp_sp_train_step
    on a 1x1 (data, seq) mesh, from the same weights, on the same batches:
    the loss and every param after each step."""
    jcfg, pcfg = _cfgs(remat)
    jp = _jax_params(jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    jstep = jax_tf.build_dp_sp_train_step(jcfg, JaxSP(**SOLVER), mesh,
                                          donate=False)
    pstep = port_tf.build_dp_sp_train_step(pcfg, PortSP(**SOLVER), "cpu")
    jstate = jax_upd.init_state(jp)
    pp = port_tf.params_from_jax(jp)
    pstate = port_upd.init_state(pp)
    for i in range(3):
        toks, tgts = _batch(seed=10 + i)
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(toks),
                               jnp.asarray(tgts), jax.random.PRNGKey(i))
        pp, pstate, pm = pstep(pp, pstate, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=STEP_RTOL)
        for n in jp:
            for l in jp[n]:
                np.testing.assert_allclose(
                    pp[n][l].numpy(), np.asarray(jp[n][l]), rtol=STEP_RTOL,
                    atol=STEP_ATOL, err_msg=f"step {i} {n}/{l}")
    assert pstate.it == int(jstate.it) == 3


def test_loss_equal_across_remat_policies():
    """Remat changes when activations are computed, not what: the loss is
    bitwise equal under none, dots_saveable and nothing_saveable, and the
    gradients agree."""
    jcfg, _ = _cfgs(False)
    params = port_tf.params_from_jax(_jax_params(jcfg))
    toks, tgts = (torch.from_numpy(a) for a in _batch(seed=3))
    results = {}
    for policy in ("none", "dots_saveable", "nothing_saveable"):
        _, pcfg = _cfgs(policy)
        results[policy] = port_tf.loss_and_grads(params, pcfg, toks, tgts)
    loss0, grads0 = results["none"]
    for policy, (loss, grads) in results.items():
        assert torch.equal(loss, loss0), policy
        for n in grads0:
            for l in grads0[n]:
                torch.testing.assert_close(grads[n][l], grads0[n][l],
                                           rtol=1e-5, atol=1e-7)


def test_lm_snapshots_cross_load_both_ways(tmp_path):
    jcfg, _ = _cfgs(True)
    jp = _jax_params(jcfg)
    rs = np.random.RandomState(70)
    hist = {n: {l: rs.randn(*v.shape).astype(np.float32)
                for l, v in d.items()} for n, d in jp.items()}
    # the port writes, the JAX package reads
    path = port_ckpt.save_lm(str(tmp_path / "port" / "lm"),
                             port_tf.params_from_jax(jp),
                             port_upd.SolverState(7, port_tf.params_from_jax(
                                 hist)))
    assert path.endswith("lm_iter_7.lmstate.npz")
    assert port_ckpt.latest_lm_snapshot(str(tmp_path / "port" / "lm")) \
        == path
    jparams, jstate = jax_ckpt.restore_lm(path, jcfg)
    assert int(jstate.it) == 7
    for n in jp:
        for l in jp[n]:
            assert np.array_equal(np.asarray(jparams[n][l]), jp[n][l])
            assert np.array_equal(np.asarray(jstate.history[n][l]),
                                  hist[n][l])
    # the JAX package writes, the port reads
    jpath = jax_ckpt.save_lm(str(tmp_path / "jax" / "lm"), jp,
                             jax_upd.SolverState(
                                 it=jnp.asarray(3, jnp.int32),
                                 history=hist), jcfg)
    pparams, pstate = port_ckpt.restore_lm(jpath)
    assert pstate.it == 3
    for n in jp:
        for l in jp[n]:
            assert np.array_equal(pparams[n][l].numpy(), jp[n][l])
            assert np.array_equal(pstate.history[n][l].numpy(), hist[n][l])


def test_train_lm_script_loss_falls_on_cpu(capsys):
    """A short CPU run of ``python -m poseidon_tpu_torch.models.train_lm``
    at a small width: the displayed loss falls from ~ln 256."""
    port_train_lm.main(["--device", "cpu", "--steps", "40", "--seq", "64",
                        "--d_model", "64", "--display", "10",
                        "--generate", "8"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[0] > 5.0 and losses[-1] < losses[0] - 1.0, losses
    assert "tok/s" in out and "generated: " in out and out.endswith("done\n")


@pytest.mark.parametrize("flags,match", [
    (["--mode", "tp"], "tensor parallelism"),
    (["--mode", "pp"], "pipeline"),
    (["--mode", "ep"], "MoE"),
    # --bf16 is ported (tests/test_torch_bf16.py runs it); the ids of the
    # cases after it are kept
    pytest.param(["--par_axis", "2"], "queue A item 10",
                 id="flags4-queue A item 10"),
    pytest.param(["--data_axis", "2"], "queue A item 10",
                 id="flags5-queue A item 10"),
])
def test_train_lm_script_refuses_unported_modes(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        port_train_lm.main(["--device", "cpu", *flags])


def test_train_lm_corpus_is_the_jax_scripts_bytes():
    corpus = port_train_lm.load_corpus(256)
    with open(port_train_lm.CORPUS, "rb") as f:
        want = np.frombuffer(f.read(), np.uint8)
    assert port_train_lm.CORPUS.name == "train_lm.py"
    assert port_train_lm.CORPUS.parent.name == "lm"
    assert np.array_equal(corpus, want) and len(corpus) > 257
