"""The port's LM pipeline parallelism (``models/transformer.py``'s
``to_pp_layout``, ``pp_shard`` and ``build_dp_pp_train_step``, alone and
with tp; ``runtime/lm_checkpoint.py``'s pp layouts; ``models/train_lm.py
--mode pp``) on the CPU against the JAX package's.

The config is ``tests/test_transformer.py``'s with 4 layers: vocab 32,
d_model 64, 4 heads, d_ff 128, max_seq 64; a global batch of 4 x 32 from
``pattern_batch`` a step; SGD with momentum 0.9; 2 microbatches.

One module-scoped fixture runs ONE job: four gloo processes (this file
run as a script, once a rank, a ``file://`` store under tmp,
``OMP_NUM_THREADS=1``) and beside them one pair of ``python -m
poseidon_tpu_torch.models.train_lm --mode pp --par_axis 2`` ranks, while
the fixture computes JAX's references. Each case builds its named groups
(``cluster.build_named_groups``) over its ranks, starts from JAX's
``init_params`` (``params_from_jax``; each rank takes its ``pp_shard`` of
``to_pp_layout``, of ``to_tp_layout`` first under tp) and takes 2 steps
on its rows of the global batches:

- dp2 x pp2 (remat off and on) against ``build_dp_pp_train_step`` on a
  (data 2, stage 2) mesh of the virtual devices;
- dp1 x pp4 (one layer a stage, so two stages neither first nor last);
- dp1 x pp2 x tp2 (the 3-D step) against the same with ``tp_axis``.

Held after each step, on every rank: the loss within 1e-5 relative, every
param and momentum leaf (the ranks' trees gathered with ``pp_unshard``
and brought back to the canonical layout) at PARAM_TOL (rtol 1e-4, atol
1e-6), against JAX's step and against the port's one-device step on the
whole batch. JAX runs the pipe as one SPMD scan of m + n - 1 masked
ticks, the port GPipe's live work a stage; both sum the same microbatch
losses and differ only in summation order.

Also: every rank's canonical trees bitwise alike (the stage ranks'
non-block leaves included: summed over stage with zeros elsewhere); the
3-D snapshot (``save_lm(layout=("tp", "pp"), tp_group=..., pp_group=...)``
on every rank, the same bytes) resumed on one device for a third step
equals three one-device steps and loads in JAX's ``restore_lm``, and
JAX's 3-D snapshot loads in the port's in every layout; ``to_pp_layout``
/ ``pp_shard`` against JAX's layout and ``pp_param_specs``; the refusals
of ``build_dp_pp_train_step``, ``pp_shard`` and the script, message for
message against JAX's; the CLI pair (rank 0's mesh and display lines,
the losses falling and equal to a one-process ``--mode sp`` run of the
same config: the same math).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # run as a script: the rank workers
    sys.path.insert(0, REPO)

from poseidon_tpu_torch.models import transformer as port_tf  # noqa: E402
from poseidon_tpu_torch.proto.messages import SolverParameter  # noqa: E402
from poseidon_tpu_torch.runtime import cluster  # noqa: E402
from poseidon_tpu_torch.runtime import lm_checkpoint as port_ckpt  # noqa: E402,E501
from poseidon_tpu_torch.solvers.updates import init_state  # noqa: E402

WORLD = 4
B, S = 4, 32
STEPS = 2
MICRO = 2
CFG = dict(vocab_size=32, d_model=64, n_heads=4, n_layers=4, d_ff=128,
           max_seq=64)
SOLVER = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
WORKER_TIMEOUT_S = 150

# name -> (axes, shape, tp, remat)
CASES = {
    "dp2_pp2": (("data", "stage"), (2, 2), False, False),
    "dp2_pp2_remat": (("data", "stage"), (2, 2), False, True),
    "dp1_pp4": (("data", "stage"), (1, 4), False, False),
    "dp1_pp2_tp2": (("data", "stage", "model"), (1, 2, 2), True, False),
}
SNAP_CASE = "dp1_pp2_tp2"
SNAP_LAYOUT = ("tp", "pp")
CLI_ARGS = ("--device", "cpu", "--steps", "4", "--display", "2", "--seq",
            "64", "--d_model", "64", "--n_layers", "4")


def _flat(tree):
    return {f"{n}/{l}": (v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v))
            for n, d in tree.items() for l, v in d.items()}


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        n, l = key.split("/")
        tree.setdefault(n, {})[l] = v
    return tree


def _port_cfg(remat=False):
    return port_tf.TransformerConfig(**CFG, remat=remat)


def _canonical(tree, groups, tp, cfg):
    """A rank's pp (and tp) shards gathered into the canonical tree."""
    tree = port_tf.from_pp_layout(port_tf.pp_unshard(
        tree, groups["stage"], groups["model"] if tp else None), cfg)
    return port_tf.from_tp_layout(tree, cfg) if tp else tree


def _run_case(rank, case, d):
    axes, shape, tp, remat = CASES[case]
    groups = cluster.build_named_groups(axes, shape, rank,
                                        torch.device("cpu"), "gloo",
                                        ranks=range(int(np.prod(shape))))
    if groups is None:
        return
    cfg = _port_cfg(remat)
    with np.load(os.path.join(d, "in.npz")) as z:
        params = port_tf.params_from_jax(
            _unflat({k[len("params/"):]: z[k] for k in z.files
                     if k.startswith("params/")}))
        batches = [(z[f"tokens{k}"], z[f"targets{k}"])
                   for k in range(STEPS)]
    if tp:
        params = port_tf.to_tp_layout(params, cfg)
    params = port_tf.pp_shard(port_tf.to_pp_layout(params, cfg), cfg,
                              groups.index("stage"), groups.size("stage"),
                              groups.index("model"), groups.size("model"))
    step = port_tf.build_dp_pp_train_step(cfg, SolverParameter(**SOLVER),
                                          groups, MICRO)
    b_local = B // groups.size("data")
    rows = slice(groups.index("data") * b_local,
                 (groups.index("data") + 1) * b_local)
    state = init_state(params)
    out = {}
    for k, (toks, tgts) in enumerate(batches):
        params, state, m = step(params, state,
                                torch.from_numpy(toks[rows]).long(),
                                torch.from_numpy(tgts[rows]).long())
        out[f"loss{k}"] = float(m["loss"])
        for tag, tree in (("params", params), ("history", state.history)):
            out.update({f"step{k}/{tag}/{key}": v for key, v in
                        _flat(_canonical(tree, groups, tp, cfg)).items()})
    if case == SNAP_CASE:
        port_ckpt.save_lm(os.path.join(d, "snap", f"rank{rank}", "lm"),
                          params, state, cfg, layout=SNAP_LAYOUT,
                          tp_group=groups["model"],
                          pp_group=groups["stage"])
    np.savez(os.path.join(d, f"{case}.rank{rank}.npz"), **out)


def _worker(rank: int, world: int, store: str, d: str) -> int:
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        for case in CASES:
            _run_case(rank, case, d)
    finally:
        group.close()
    return 0


if __name__ == "__main__":
    # a rank worker: it stops here, before the reference side's imports
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4]))


# --------------------------------------------------------------------- #
# the reference side

import importlib.util  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from poseidon_tpu.models import transformer as jax_tf  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402
from poseidon_tpu.proto.messages import SolverParameter as JaxSP  # noqa: E402,E501
from poseidon_tpu.runtime import lm_checkpoint as jax_ckpt  # noqa: E402
from poseidon_tpu.solvers import updates as jax_upd  # noqa: E402

from conftest import pattern_batch  # noqa: E402


def _jax_cfg(remat=False):
    return jax_tf.TransformerConfig(**CFG, remat=remat)


def _inputs():
    params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(_jax_cfg(), jax.random.PRNGKey(0)))
    batches = [tuple(np.asarray(a).astype(np.int32) for a in pattern_batch(
        np.random.RandomState(k + 1), B, S, CFG["vocab_size"]))
        for k in range(STEPS + 1)]
    return params, batches


def _jax_reference(case, params, batches):
    """JAX's {step: (loss, canonical params, canonical history)} on the
    case's mesh of the virtual devices."""
    axes, shape, tp, remat = CASES[case]
    cfg = _jax_cfg(remat)
    mesh = make_mesh(axes=axes, shape=shape,
                     devices=jax.devices()[:int(np.prod(shape))])
    p = jax_tf.to_tp_layout(params, cfg) if tp else params
    p = jax_tf.to_pp_layout(p, cfg)
    step = jax_tf.build_dp_pp_train_step(
        cfg, JaxSP(**SOLVER), mesh, p, MICRO,
        tp_axis="model" if tp else None, donate=False)
    st = jax_upd.init_state(p)
    out = {}
    for k in range(STEPS):
        toks, tgts = batches[k]
        p, st, m = step(p, st, jnp.asarray(toks), jnp.asarray(tgts),
                        jax.random.PRNGKey(k))
        trees = []
        for tree in (p, st.history):
            tree = jax_tf.from_pp_layout(tree, cfg)
            trees.append(_flat(jax_tf.from_tp_layout(tree, cfg) if tp
                               else tree))
        out[k] = (float(m["loss"]), *trees)
    return out


def _one_device_steps(params, state, batches, cfg=None):
    step = port_tf.build_dp_sp_train_step(cfg or _port_cfg(),
                                          SolverParameter(**SOLVER), "cpu")
    losses = []
    for toks, tgts in batches:
        params, state, m = step(params, state, torch.from_numpy(toks).long(),
                                torch.from_numpy(tgts).long())
        losses.append(float(m["loss"]))
    return params, state, losses


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_pp")
    params, batches = _inputs()
    arrays = {f"params/{k}": v for k, v in _flat(params).items()}
    for k, (toks, tgts) in enumerate(batches):
        arrays.update({f"tokens{k}": toks, f"targets{k}": tgts})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(d / "store"), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    procs += [subprocess.Popen(
        [sys.executable, "-m", "poseidon_tpu_torch.models.train_lm",
         "--mode", "pp", "--par_axis", "2", *CLI_ARGS], cwd=REPO,
        env=dict(os.environ, POSEIDON_PROC_ID=str(r),
                 POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="1",
                 POSEIDON_COORDINATOR=f"file://{d / 'cli.store'}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        # JAX's references and the port's one-device steps while the
        # ranks run
        refs = {case: _jax_reference(case, params, batches)
                for case in CASES}
        p0 = port_tf.params_from_jax(params)
        one, st = p0, init_state(p0)
        one_dev = {}
        for k in range(STEPS):
            one, st, losses = _one_device_steps(one, st, batches[k:k + 1])
            one_dev[k] = (losses[0], _flat(one), _flat(st.history))
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i}:\n{logs[i]}"
    results = {}
    for case, (_, shape, _, _) in CASES.items():
        results[case] = []
        for r in range(int(np.prod(shape))):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return {"results": results, "refs": refs, "one_device": one_dev,
            "cli": logs[WORLD:], "dir": d, "params": params,
            "batches": batches}


def _hold(res, want, r):
    for k, (loss, params, history) in want.items():
        assert float(res[f"loss{k}"]) == pytest.approx(
            loss, rel=LOSS_RTOL), (r, k)
        for tag, tree in (("params", params), ("history", history)):
            for key, v in tree.items():
                np.testing.assert_allclose(
                    res[f"step{k}/{tag}/{key}"], v, **PARAM_TOL,
                    err_msg=f"rank {r} step {k + 1} {tag} {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_pp_steps_match_jax(pp_run, case):
    for r, res in enumerate(pp_run["results"][case]):
        _hold(res, pp_run["refs"][case], r)


@pytest.mark.parametrize("case", list(CASES))
def test_pp_steps_match_the_one_device_step(pp_run, case):
    """The pipeline reschedules the one-device step's math: the same
    losses and updates from the whole batch on one device."""
    for r, res in enumerate(pp_run["results"][case]):
        _hold(res, pp_run["one_device"], r)


@pytest.mark.parametrize("case", list(CASES))
def test_pp_ranks_agree_bitwise(pp_run, case):
    """Every rank ends with the same canonical trees, bit for bit: the
    stage ranks' non-block leaves (each summed over stage with zeros on
    the stages that do not reach it), the tp ranks' replicated leaves (the
    f/g pair) and the data ranks' averages."""
    ranks = pp_run["results"][case]
    for res in ranks[1:]:
        for key, v in ranks[0].items():
            np.testing.assert_array_equal(res[key], v, err_msg=key)


def test_3d_snapshot_resumes_one_device(pp_run):
    """Two dp1 x pp2 x tp2 steps, ``save_lm(layout=("tp", "pp"),
    tp_group=..., pp_group=...)`` on every rank (the same bytes), restored
    canonical and one-device for a third step: equal to three one-device
    steps at PARAM_TOL (``tests/test_lm_checkpoint.py``'s claim); the file
    loads in JAX's ``restore_lm`` exactly, canonical and in the 3-D
    layout."""
    d = pp_run["dir"]
    paths = [port_ckpt.latest_lm_snapshot(str(d / "snap" / f"rank{r}" /
                                              "lm")) for r in range(WORLD)]
    assert all(p is not None and p.endswith("lm_iter_2.lmstate.npz")
               for p in paths)
    blobs = [open(p, "rb").read() for p in paths]
    assert all(b == blobs[0] for b in blobs[1:])
    p, st = port_ckpt.restore_lm(paths[0], _port_cfg())
    assert st.it == 2
    p, st, _ = _one_device_steps(p, st, pp_run["batches"][2:3])
    p0 = port_tf.params_from_jax(pp_run["params"])
    want, want_st, _ = _one_device_steps(p0, init_state(p0),
                                         pp_run["batches"][:3])
    for got, ref in ((p, want), (st.history, want_st.history)):
        for key, v in _flat(ref).items():
            np.testing.assert_allclose(_flat(got)[key], v, **PARAM_TOL,
                                       err_msg=key)
    ours, _ = port_ckpt.restore_lm(paths[0])
    jcfg = _jax_cfg()
    for layout in ((), SNAP_LAYOUT):
        jp, jst = jax_ckpt.restore_lm(paths[0], jcfg, layout=layout)
        assert int(jst.it) == 2
        pl, _ = port_ckpt.restore_lm(paths[0], _port_cfg(), layout=layout)
        for key, v in _flat(jp).items():
            assert np.array_equal(_flat(pl)[key], v), (layout, key)
    for key, v in _flat(jax_ckpt.restore_lm(paths[0], jcfg)[0]).items():
        assert np.array_equal(_flat(ours)[key], v), key


@pytest.mark.parametrize("layout", [("pp",), ("tp", "pp")])
def test_jax_pp_snapshot_loads_in_the_port(tmp_path, pp_run, layout):
    """JAX writes from a pp (or 3-D) layout; the port restores it
    canonical and in the same layout, both exactly as JAX's own
    ``restore_lm`` does; the port's save of that layout (no groups: the
    whole tree) writes the same arrays."""
    jcfg, cfg = _jax_cfg(), _port_cfg()
    params = pp_run["params"]
    rs = np.random.RandomState(5)
    hist = {n: {l: rs.randn(*v.shape).astype(np.float32)
                for l, v in lv.items()} for n, lv in params.items()}
    jp, jh = params, hist
    for name in layout:
        redo = {"tp": jax_tf.to_tp_layout, "pp": jax_tf.to_pp_layout}[name]
        jp, jh = redo(jp, jcfg), redo(jh, jcfg)
    path = jax_ckpt.save_lm(
        str(tmp_path / "jax" / "lm"), jp,
        jax_upd.SolverState(it=jnp.asarray(4, jnp.int32), history=jh),
        jcfg, layout=layout)
    p, st = port_ckpt.restore_lm(path, cfg)
    assert st.it == 4
    for got, want in ((p, params), (st.history, hist)):
        for key, v in _flat(want).items():
            assert np.array_equal(_flat(got)[key], v), key
    p_l, st_l = port_ckpt.restore_lm(path, cfg, layout=layout)
    for got, want in ((p_l, jp), (st_l.history, jh)):
        for key, v in _flat(want).items():
            assert np.array_equal(_flat(got)[key], np.asarray(v)), key
    mine = port_ckpt.save_lm(str(tmp_path / "port" / "lm"), p_l, st_l, cfg,
                             layout=layout)
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key


def test_pp_layout_and_shards_match_jax(pp_run):
    """``to_pp_layout`` equals JAX's element for element and
    ``from_pp_layout`` inverts it; ``pp_shard`` of every stage of 2 and 4
    (and, after ``to_tp_layout``, of every tp rank of 2) equals slicing
    JAX's layout by ``pp_param_specs``."""
    jcfg, cfg = _jax_cfg(), _port_cfg()
    params = pp_run["params"]
    ptree = port_tf.params_from_jax(params)
    jpp = jax_tf.to_pp_layout(params, jcfg)
    ppp = port_tf.to_pp_layout(ptree, cfg)
    for key, v in _flat(jpp).items():
        assert np.array_equal(_flat(ppp)[key], np.asarray(v)), key
    back = port_tf.from_pp_layout(ppp, cfg)
    for key, v in _flat(params).items():
        assert np.array_equal(_flat(back)[key], v), key
    cases = [(n_st, 1, False) for n_st in (2, 4)] + [(2, 2, True)]
    for n_st, n_tp, tp in cases:
        jtree = jax_tf.to_pp_layout(jax_tf.to_tp_layout(params, jcfg)
                                    if tp else params, jcfg)
        ptree3 = port_tf.to_pp_layout(port_tf.to_tp_layout(ptree, cfg)
                                      if tp else ptree, cfg)
        specs = jax_tf.pp_param_specs(jtree, tp_axis="model" if tp
                                      else None)
        sizes = {"stage": n_st, "model": n_tp}
        for s in range(n_st):
            for t in range(n_tp):
                index = {"stage": s, "model": t}
                shard = _flat(port_tf.pp_shard(ptree3, cfg, s, n_st, t,
                                               n_tp))
                for n, lv in jtree.items():
                    for l, v in lv.items():
                        want = np.asarray(v)
                        for dim, axis in enumerate(tuple(specs[n][l])):
                            if axis is None:
                                continue
                            size = want.shape[dim] // sizes[axis]
                            lo = index[axis] * size
                            want = np.take(want, range(lo, lo + size), dim)
                        assert np.array_equal(shard[f"{n}/{l}"], want), (
                            n_st, n_tp, s, t, n, l)


def test_shards_own_their_storage():
    """A rank keeps only its shard in memory: ``pp_shard``'s, ``tp_shard``'s
    and ``ep_shard``'s sharded leaves hold storage of their own, never a
    view that keeps the whole stacked (or full) tensor alive."""
    from poseidon_tpu_torch.models import moe as port_moe
    cfg = _port_cfg()
    params = port_tf.init_params(cfg, torch.Generator().manual_seed(0))

    def own(v):
        return v.untyped_storage().nbytes() == v.numel() * v.element_size()

    tree = port_tf.pp_shard(port_tf.to_pp_layout(port_tf.to_tp_layout(
        params, cfg), cfg), cfg, 1, 2, 1, 2)
    assert all(own(v) for v in tree["blocks"].values())
    tree = port_tf.tp_shard(port_tf.to_tp_layout(params, cfg), cfg, 1, 2)
    assert all(own(tree["block0"][leaf]) for leaf in port_tf.TP_SPLIT_DIM)
    mcfg = port_moe.MoEConfig(base=cfg, n_experts=4)
    tree = port_moe.ep_shard(port_moe.init_moe_params(
        mcfg, torch.Generator().manual_seed(0)), mcfg, 1, 2)
    assert all(own(tree["block0"][leaf]) for leaf in port_moe.EXPERT_LEAVES)


def test_pp_refusals_match_jax():
    """n_layers % stages at build time; local batch % microbatches at
    the first call (JAX's trace): the same ``ValueError`` messages."""
    cfg3 = dict(CFG, n_layers=3)
    jparams = jax_tf.to_pp_layout(jax_tf.init_params(
        jax_tf.TransformerConfig(**cfg3), jax.random.PRNGKey(0)),
        jax_tf.TransformerConfig(**cfg3))
    mesh = make_mesh(axes=("data", "stage"), shape=(1, 2),
                     devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jax_tf.build_dp_pp_train_step(jax_tf.TransformerConfig(**cfg3),
                                      JaxSP(**SOLVER), mesh, jparams, 2)
    # a stage group of two that never exchanges: the refusal comes first
    from poseidon_tpu_torch.parallel.mesh import DataGroup, NamedGroups
    one = DataGroup.single("cpu")
    two = DataGroup(rank=0, world=2, device=torch.device("cpu"))
    groups = NamedGroups(axes=("data", "stage"), shape=(1, 2),
                         groups={"data": one, "stage": two}, joint=one,
                         joint_axes=("data",))
    pcfg3 = port_tf.TransformerConfig(**cfg3)
    with pytest.raises(ValueError) as got:
        port_tf.build_dp_pp_train_step(pcfg3, SolverParameter(**SOLVER),
                                       groups, 2)
    assert str(got.value) == str(want.value) and str(want.value)
    with pytest.raises(ValueError) as got:
        port_tf.pp_shard(port_tf.to_pp_layout(port_tf.init_params(
            pcfg3, torch.Generator().manual_seed(0)), pcfg3), pcfg3, 0, 2)
    assert str(got.value) == str(want.value)

    jcfg = _jax_cfg()
    jp = jax_tf.to_pp_layout(jax_tf.init_params(jcfg,
                                                jax.random.PRNGKey(0)), jcfg)
    jstep = jax_tf.build_dp_pp_train_step(jcfg, JaxSP(**SOLVER), make_mesh(
        axes=("data", "stage"), shape=(1, 1), devices=jax.devices()[:1]),
        jp, 3, donate=False)
    toks = jnp.zeros((4, 8), jnp.int32)
    with pytest.raises(ValueError) as want:
        jstep(jp, jax_upd.init_state(jp), toks, toks, jax.random.PRNGKey(0))
    groups = cluster.build_named_groups(("data", "stage"), (1, 1), 0,
                                        torch.device("cpu"), None)
    pp = port_tf.to_pp_layout(port_tf.init_params(
        _port_cfg(), torch.Generator().manual_seed(0)), _port_cfg())
    step = port_tf.build_dp_pp_train_step(_port_cfg(),
                                          SolverParameter(**SOLVER), groups, 3)
    ptoks = torch.zeros((4, 8), dtype=torch.long)
    with pytest.raises(ValueError) as got:
        step(pp, init_state(pp), ptoks, ptoks)
    assert str(got.value) == str(want.value) and str(want.value)


def test_embedding_gradient_is_bitwise_across_threads():
    """Ranks that hold a replicated embedding (tp ranks, pipeline stages)
    must compute its gradient bit for bit alike. ``x[tokens]``'s backward
    summed repeated tokens' rows in a thread-dependent order on the CPU
    (measured: 5 of 6 runs at 4 threads apart, by up to 4.66e-9);
    ``embed_tokens``' ``F.embedding`` lookups do not."""
    cfg = port_tf.TransformerConfig(vocab_size=512, d_model=64, n_heads=2,
                                    n_layers=2, d_ff=128, max_seq=1024)
    p = port_tf.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks, tgts = (torch.randint(0, 512, (4, 1024), generator=g)
                  for _ in range(2))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        grads = [port_tf.loss_and_grads(p, cfg, toks, tgts)[1]
                 for _ in range(4)]
    finally:
        torch.set_num_threads(threads)
    for other in grads[1:]:
        for n in ("embed", "pos"):
            assert torch.equal(other[n]["w"], grads[0][n]["w"]), n


def test_stage_is_not_data_like():
    """The pipeline never averages over ``stage``: the joint group of a
    ``(data, stage)`` or ``(data, stage, model)`` mesh is ``data`` alone;
    the sp and tp meshes keep theirs."""
    from poseidon_tpu_torch.parallel.mesh import data_like_axes
    assert data_like_axes(("data", "stage")) == ("data",)
    assert data_like_axes(("data", "stage", "model")) == ("data",)
    assert data_like_axes(("data", "seq", "model")) == ("data", "seq")
    assert data_like_axes(("data", "expert")) == ("data", "expert")


def test_train_lm_pp_cli_two_ranks(pp_run):
    """``train_lm --mode pp --par_axis 2`` as two launched processes:
    rank 0 prints the mesh and the display lines with tok/s, rank 1 none
    of them; the loss falls, and each displayed loss equals a one-process
    ``--mode sp`` run's (the pipeline reschedules the same math)."""
    from poseidon_tpu_torch.models import train_lm
    rank0, rank1 = pp_run["cli"]
    assert "mesh: data=1 x stage=2 (2 devices)" in rank0, rank0
    steps = [line.split() for line in rank0.splitlines()
             if line.startswith("step ")]
    assert [s[1] for s in steps] == ["1", "2", "4"], rank0
    assert all("tok/s" in " ".join(s) for s in steps[1:])
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert rank0.rstrip().endswith("done")
    assert "step " not in rank1 and "mesh:" not in rank1, rank1
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_lm.main(["--mode", "sp", *CLI_ARGS])
    one = [line.split()[3] for line in buf.getvalue().splitlines()
           if line.startswith("step ")]
    assert [float(x) for x in one] == pytest.approx(losses, abs=1.5e-4)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", os.path.join(REPO, "examples", "lm", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--mode", "pp", "--par_axis", "3"],
    ["--mode", "pp", "--par_axis", "4", "--n_layers", "6"],
    ["--mode", "pp", "--par_axis", "2", "--n_layers", "4",
     "--microbatches", "3"],
    ["--mode", "pp", "--par_axis", "2", "--batch", "6"],
])
def test_train_lm_pp_refusals_match_jax(monkeypatch, flags):
    """On 8 devices (JAX's virtual ones; the port's world from the launch
    env, no coordinator needed to refuse): the same ``SystemExit``
    message."""
    assert len(jax.devices()) == 8
    for var in ("POSEIDON_COORDINATOR", "POSEIDON_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *flags])
    with pytest.raises(SystemExit) as want:
        _jax_script().main()
    monkeypatch.setenv("POSEIDON_NUM_PROCS", "8")
    from poseidon_tpu_torch.models import train_lm
    with pytest.raises(SystemExit) as got:
        train_lm.main(["--device", "cpu", *flags])
    assert str(got.value) == str(want.value) and str(want.value)
