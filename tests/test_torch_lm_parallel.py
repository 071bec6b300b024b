"""The port's LM sequence and tensor parallelism (``models/transformer.py``'s
``build_dp_sp_train_step`` on a mesh and ``build_dp_tp_train_step``,
``runtime/lm_checkpoint.py``'s tp layout, ``models/train_lm.py --mode
sp|tp``) on the CPU against the JAX package's.

JAX's test config: vocab 32, d_model 64, 4 heads, 2 layers, d_ff 128,
max_seq 64; a global batch of 4 x 32 from ``pattern_batch`` a step; SGD
with momentum 0.9.

One module-scoped fixture runs ONE job: four gloo processes (this file
run as a script, once a rank, a ``file://`` store under tmp,
``OMP_NUM_THREADS=1``) and beside them two pairs of ``python -m
poseidon_tpu_torch.models.train_lm`` ranks (``--mode sp --par_axis 2`` and
``--mode tp --par_axis 2``, ``--device cpu --steps 4 --display 2``), while
the fixture computes JAX's references. Each case builds its named groups
(``cluster.build_named_groups``) over the four ranks, starts from JAX's
``init_params`` (``params_from_jax``; tp ranks take ``tp_shard`` of
``to_tp_layout``) and takes 2 steps on each rank's block of the global
batches:

- dp2 x sp2 against ``build_dp_sp_train_step`` on a (data 2, seq 2) mesh
  of the virtual devices, with remat off and on;
- dp2 x tp2 against ``build_dp_tp_train_step`` on (data 2, model 2);
- dp1 x sp2 x tp2 against the same with ``seq_axis`` on (data 1, seq 2,
  model 2).

Held after each step, on every rank: the loss within 1e-5 relative, every
param and momentum leaf (tp ranks' trees all-gathered and brought back to
the canonical layout) at PARAM_TOL (rtol 1e-4, atol 1e-6). The two
packages' steps differ in how they sum, not in what: JAX's CPU step runs
the lax ring formulation (and dense attention under tp) with XLA's GEMMs,
the port its ring Function over the plain flash versions with torch's;
JAX averages over data then seq, the port over both at once.

Also: the tp snapshot (the dp2 x tp2 ranks' ``save_lm(...,
layout=("tp",), tp_group=...)`` after 2 steps: every rank the same bytes)
restored one-device for a third step equals three one-device steps, and
loads in JAX's ``restore_lm(path, cfg)``; a JAX snapshot written from a
tp layout loads in the port's, canonical and tp; ``to_tp_layout`` /
``from_tp_layout`` and ``tp_shard`` against JAX's layout and
``tp_param_specs``; ``named_axis_ranks`` against JAX's device order; the
CLI pairs (rank 0's mesh and display lines, losses falling and equal
between sp and tp, as JAX's script lands them); the script's refusals
message for message against JAX's script on 8 virtual devices.
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
CFG = dict(vocab_size=32, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=64)
SOLVER = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
WORKER_TIMEOUT_S = 150

# name -> (axes, shape, step kind, remat)
CASES = {
    "dp2_sp2": (("data", "seq"), (2, 2), "sp", False),
    "dp2_sp2_remat": (("data", "seq"), (2, 2), "sp", True),
    "dp2_tp2": (("data", "model"), (2, 2), "tp", False),
    "dp1_sp2_tp2": (("data", "seq", "model"), (1, 2, 2), "tp", False),
}
SNAP_CASE = "dp2_tp2"
CLI_MODES = ("sp", "tp")
CLI_ARGS = ("--par_axis", "2", "--device", "cpu", "--steps", "4",
            "--display", "2")


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


def _port_cfg(remat):
    return port_tf.TransformerConfig(**CFG, remat=remat)


def _run_case(rank, case, d):
    axes, shape, kind, remat = CASES[case]
    groups = cluster.build_named_groups(axes, shape, rank,
                                        torch.device("cpu"), "gloo")
    cfg = _port_cfg(remat)
    sp = SolverParameter(**SOLVER)
    with np.load(os.path.join(d, "in.npz")) as z:
        params = port_tf.params_from_jax(
            _unflat({k[len("params/"):]: z[k] for k in z.files
                     if k.startswith("params/")}))
        batches = [(z[f"tokens{k}"], z[f"targets{k}"])
                   for k in range(STEPS)]
    b_local = B // groups.size("data")
    s_local = S // groups.size("seq")
    rows = slice(groups.index("data") * b_local,
                 (groups.index("data") + 1) * b_local)
    cols = slice(groups.index("seq") * s_local,
                 (groups.index("seq") + 1) * s_local)
    if kind == "sp":
        step = port_tf.build_dp_sp_train_step(cfg, sp, groups=groups)
    else:
        params = port_tf.tp_shard(port_tf.to_tp_layout(params, cfg), cfg,
                                  groups.index("model"),
                                  groups.size("model"))
        step = port_tf.build_dp_tp_train_step(
            cfg, sp, groups, seq_axis="seq" if "seq" in axes else None)
    state = init_state(params)
    out = {}
    for k, (toks, tgts) in enumerate(batches):
        params, state, m = step(params, state,
                                torch.from_numpy(toks[rows, cols]).long(),
                                torch.from_numpy(tgts[rows, cols]).long())
        p, h = params, state.history
        if kind == "tp":
            p, h = (port_tf.from_tp_layout(
                port_tf.tp_unshard(t, groups["model"]), cfg) for t in (p, h))
        out[f"loss{k}"] = float(m["loss"])
        out.update({f"step{k}/params/{key}": v
                    for key, v in _flat(p).items()})
        out.update({f"step{k}/history/{key}": v
                    for key, v in _flat(h).items()})
    if case == SNAP_CASE:
        port_ckpt.save_lm(os.path.join(d, "snap", f"rank{rank}", "lm"),
                          params, state, cfg, layout=("tp",),
                          tp_group=groups["model"])
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
    axes, shape, kind, remat = CASES[case]
    cfg = _jax_cfg(remat)
    mesh = make_mesh(axes=axes, shape=shape,
                     devices=jax.devices()[:int(np.prod(shape))])
    sp = JaxSP(**SOLVER)
    p = params
    if kind == "sp":
        step = jax_tf.build_dp_sp_train_step(cfg, sp, mesh, donate=False)
    else:
        p = jax_tf.to_tp_layout(params, cfg)
        step = jax_tf.build_dp_tp_train_step(
            cfg, sp, mesh, p, seq_axis="seq" if "seq" in axes else None,
            donate=False)
    st = jax_upd.init_state(p)
    out = {}
    for k in range(STEPS):
        toks, tgts = batches[k]
        p, st, m = step(p, st, jnp.asarray(toks), jnp.asarray(tgts),
                        jax.random.PRNGKey(k))
        cp, ch = p, st.history
        if kind == "tp":
            cp, ch = jax_tf.from_tp_layout(cp, cfg), jax_tf.from_tp_layout(
                ch, cfg)
        out[k] = (float(m["loss"]), _flat(cp), _flat(ch))
    return out


def _cli_env(mode, rank, d):
    return dict(os.environ, POSEIDON_PROC_ID=str(rank),
                POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="1",
                POSEIDON_COORDINATOR=f"file://{d / mode}.store")


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_par")
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
         "--mode", mode, *CLI_ARGS], cwd=REPO, env=_cli_env(mode, r, d),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for mode in CLI_MODES for r in range(2)]
    logs = []
    try:
        # JAX's references while the ranks run
        refs = {case: _jax_reference(case, params, batches)
                for case in CASES}
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
    for case in CASES:
        results[case] = []
        for r in range(WORLD):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    cli = {mode: logs[WORLD + 2 * i: WORLD + 2 * i + 2]
           for i, mode in enumerate(CLI_MODES)}
    return {"results": results, "refs": refs, "cli": cli, "dir": d,
            "params": params, "batches": batches}


@pytest.mark.parametrize("case", list(CASES))
def test_lm_parallel_steps_match_jax(lm_run, case):
    for r, res in enumerate(lm_run["results"][case]):
        for k, (loss, params, history) in lm_run["refs"][case].items():
            assert float(res[f"loss{k}"]) == pytest.approx(
                loss, rel=LOSS_RTOL), (r, k)
            for tag, want in (("params", params), ("history", history)):
                for key, v in want.items():
                    np.testing.assert_allclose(
                        res[f"step{k}/{tag}/{key}"], v, **PARAM_TOL,
                        err_msg=f"rank {r} step {k + 1} {tag} {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_lm_parallel_ranks_agree(lm_run, case):
    """Every rank ends with the same canonical params and momentum (the
    replicated leaves alike over tp through the f/g pair, everything
    averaged alike over the data-like axes)."""
    ranks = lm_run["results"][case]
    for res in ranks[1:]:
        for key, v in ranks[0].items():
            np.testing.assert_array_equal(res[key], v, err_msg=key)


def _one_device_steps(params, state, batches, cfg):
    step = port_tf.build_dp_sp_train_step(cfg, SolverParameter(**SOLVER),
                                          "cpu")
    for toks, tgts in batches:
        params, state, _ = step(params, state, torch.from_numpy(toks).long(),
                                torch.from_numpy(tgts).long())
    return params, state


def test_tp_snapshot_resumes_one_device(lm_run):
    """Two dp2 x tp2 steps, ``save_lm(layout=("tp",), tp_group=...)`` on
    every rank (the same bytes), restored canonical and one-device for a
    third step: equal to three one-device steps at PARAM_TOL; the file
    loads in JAX's ``restore_lm``."""
    d = lm_run["dir"]
    paths = [port_ckpt.latest_lm_snapshot(str(d / "snap" / f"rank{r}" /
                                              "lm")) for r in range(WORLD)]
    assert all(p is not None and p.endswith("lm_iter_2.lmstate.npz")
               for p in paths)
    blobs = [open(p, "rb").read() for p in paths]
    assert all(b == blobs[0] for b in blobs[1:])
    cfg = _port_cfg(False)
    p, st = port_ckpt.restore_lm(paths[0], cfg)
    assert st.it == 2
    p, st = _one_device_steps(p, st, lm_run["batches"][2:3], cfg)
    p0 = port_tf.params_from_jax(lm_run["params"])
    want, want_st = _one_device_steps(p0, init_state(p0),
                                      lm_run["batches"][:3], cfg)
    for key, v in _flat(want).items():
        np.testing.assert_allclose(_flat(p)[key], v, **PARAM_TOL,
                                   err_msg=key)
    for key, v in _flat(want_st.history).items():
        np.testing.assert_allclose(_flat(st.history)[key], v, **PARAM_TOL,
                                   err_msg=key)
    jp, jst = jax_ckpt.restore_lm(paths[0], _jax_cfg())
    assert int(jst.it) == 2
    ours, _ = port_ckpt.restore_lm(paths[0])
    for key, v in _flat(jp).items():
        assert np.array_equal(_flat(ours)[key], v), key


def test_jax_tp_snapshot_loads_in_the_port(tmp_path, lm_run):
    """JAX writes from a tp layout; the port restores it canonical and,
    with ``layout=("tp",)`` or ``("pp",)``, in the tp or pp layout, all
    exact."""
    jcfg, cfg = _jax_cfg(), _port_cfg(False)
    params = lm_run["params"]
    rs = np.random.RandomState(5)
    hist = {n: {l: rs.randn(*v.shape).astype(np.float32)
                for l, v in lv.items()} for n, lv in params.items()}
    path = jax_ckpt.save_lm(
        str(tmp_path / "lm"), jax_tf.to_tp_layout(params, jcfg),
        jax_upd.SolverState(it=jnp.asarray(4, jnp.int32),
                            history=jax_tf.to_tp_layout(hist, jcfg)),
        jcfg, layout=("tp",))
    p, st = port_ckpt.restore_lm(path, cfg)
    assert st.it == 4
    for key, v in _flat(params).items():
        assert np.array_equal(_flat(p)[key], v), key
    for key, v in _flat(hist).items():
        assert np.array_equal(_flat(st.history)[key], v), key
    p_tp, st_tp = port_ckpt.restore_lm(path, cfg, layout=("tp",))
    want = jax_tf.to_tp_layout(params, jcfg)
    for key, v in _flat(want).items():
        assert np.array_equal(_flat(p_tp)[key], np.asarray(v)), key
    # and in the pp layout, as JAX's to_pp_layout of the same snapshot
    p_pp, st_pp = port_ckpt.restore_lm(path, cfg, layout=("pp",))
    for got, want in ((p_pp, params), (st_pp.history, hist)):
        for key, v in _flat(jax_tf.to_pp_layout(want, jcfg)).items():
            assert np.array_equal(_flat(got)[key], np.asarray(v)), key


def test_tp_layout_and_shards_match_jax(lm_run):
    """``to_tp_layout`` equals JAX's element for element and
    ``from_tp_layout`` inverts it; ``tp_shard`` of every rank of 2 and 4
    equals slicing JAX's tp layout by ``tp_param_specs``."""
    jcfg, cfg = _jax_cfg(), _port_cfg(False)
    params = lm_run["params"]
    jtp = jax_tf.to_tp_layout(params, jcfg)
    ptp = port_tf.to_tp_layout(port_tf.params_from_jax(params), cfg)
    for key, v in _flat(jtp).items():
        assert np.array_equal(_flat(ptp)[key], np.asarray(v)), key
    back = port_tf.from_tp_layout(ptp, cfg)
    for key, v in _flat(params).items():
        assert np.array_equal(_flat(back)[key], v), key
    specs = jax_tf.tp_param_specs(jtp)
    for n_tp in (2, 4):
        for t in range(n_tp):
            shard = _flat(port_tf.tp_shard(ptp, cfg, t, n_tp))
            for n, lv in jtp.items():
                for l, v in lv.items():
                    want = np.asarray(v)
                    spec = tuple(specs[n][l])
                    if "model" in spec:
                        dim = spec.index("model")
                        size = want.shape[dim] // n_tp
                        want = np.take(want, range(t * size,
                                                   (t + 1) * size), dim)
                    assert np.array_equal(shard[f"{n}/{l}"], want), (n, l)


def test_tp_divisibility_refusal_matches_jax():
    jcfg = jax_tf.TransformerConfig(**{**CFG, "n_heads": 4, "d_ff": 128})
    mesh = make_mesh(num_devices=3, axes=("model",))
    with pytest.raises(ValueError) as want:
        jax_tf._check_tp_divisibility(jcfg, mesh, "model")
    with pytest.raises(ValueError) as got:
        port_tf._check_tp_divisibility(_port_cfg(False), 3, "model")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axes,shape", [
    (("data", "seq"), (2, 2)), (("data", "model"), (4, 2)),
    (("data", "seq", "model"), (2, 2, 2)), (("data", "seq", "model"),
                                            (1, 2, 4))])
def test_named_axis_ranks_follow_jax_device_order(axes, shape):
    from poseidon_tpu_torch.parallel.mesh import (named_axis_ranks,
                                                  named_coords)
    n = int(np.prod(shape))
    mesh = make_mesh(axes=axes, shape=shape, devices=jax.devices()[:n])
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    table = named_axis_ranks(axes, shape, joint=axes[:-1])
    for r in range(n):
        assert ids[named_coords(r, shape)] == r
    for i, axis in enumerate(axes):
        want = np.moveaxis(ids, i, -1).reshape(-1, shape[i]).tolist()
        assert table[axis] == want, axis
    assert table["joint"] == np.moveaxis(ids, -1, 0).reshape(
        shape[-1], -1).tolist()


@pytest.mark.parametrize("mode", CLI_MODES)
def test_train_lm_cli_two_ranks(lm_run, mode):
    """``train_lm --mode sp|tp --par_axis 2`` as two launched processes:
    rank 0 prints the mesh and the display lines with tok/s, rank 1 none
    of them; the loss falls; sp and tp print the same losses (the same
    math in another layout, as JAX's script lands them)."""
    rank0, rank1 = lm_run["cli"][mode]
    axis = {"sp": "seq", "tp": "model"}[mode]
    assert f"mesh: data=1 x {axis}=2 (2 devices)" in rank0, rank0
    steps = [line.split() for line in rank0.splitlines()
             if line.startswith("step ")]
    assert [s[1] for s in steps] == ["1", "2", "4"], rank0
    assert all("tok/s" in " ".join(s) for s in steps[1:])
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert rank0.rstrip().endswith("done")
    assert "step " not in rank1 and "mesh:" not in rank1, rank1
    other = lm_run["cli"]["tp" if mode == "sp" else "sp"][0]
    assert [s[3] for s in steps] == [
        line.split()[3] for line in other.splitlines()
        if line.startswith("step ")]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", os.path.join(REPO, "examples", "lm", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--par_axis", "3"],
    ["--data_axis", "3", "--par_axis", "2"],
    ["--batch", "6", "--par_axis", "2"],
    ["--seq", "255", "--par_axis", "2"],
    ["--mode", "tp", "--batch", "6", "--par_axis", "2"],
    ["--mode", "tp", "--n_heads", "3", "--par_axis", "2"],
    ["--mode", "tp", "--n_heads", "6"],
    ["--mode", "tp", "--n_heads", "8", "--d_model", "65", "--par_axis",
     "8"],
])
def test_train_lm_refusals_match_jax(monkeypatch, flags):
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


@pytest.mark.parametrize("mode,flags", [
    pytest.param("pp", ["--par_axis", "2", "--n_layers", "3"],
                 id="pp-pipeline"),
    pytest.param("ep", ["--par_axis", "4", "--experts", "6"], id="ep-MoE"),
])
def test_train_lm_pp_ep_name_the_next_slice(monkeypatch, mode, flags):
    """pp and ep train now (``tests/test_torch_pp.py``,
    ``test_torch_moe.py``); a pipeline whose layers the stage axis does
    not divide, or experts the expert axis does not divide, is refused
    with the JAX script's ``SystemExit`` message on 8 devices."""
    for var in ("POSEIDON_COORDINATOR", "POSEIDON_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--mode", mode, *flags])
    with pytest.raises(SystemExit) as want:
        _jax_script().main()
    monkeypatch.setenv("POSEIDON_NUM_PROCS", "8")
    from poseidon_tpu_torch.models import train_lm
    with pytest.raises(SystemExit) as got:
        train_lm.main(["--device", "cpu", "--mode", mode, *flags])
    assert str(got.value) == str(want.value)
    assert str(want.value).endswith(
        {"pp": "(try --n_layers 2)", "ep": "the expert axis 4"}[mode])


def test_lm_checkpoint_refuses_a_pipeline_layout(tmp_path):
    """The 3-D layout is saved now (the name is kept): a tree in
    ``to_pp_layout(to_tp_layout(...))`` writes the canonical tree, and
    JAX's ``restore_lm`` reads it back as the tree it started from."""
    cfg = _port_cfg(False)
    p0 = port_tf.init_params(cfg, torch.Generator().manual_seed(0))
    h0 = {n: {l: v * 0.5 for l, v in d.items()} for n, d in p0.items()}
    path = port_ckpt.save_lm(
        str(tmp_path / "lm"),
        port_tf.to_pp_layout(port_tf.to_tp_layout(p0, cfg), cfg),
        init_state(p0)._replace(history=port_tf.to_pp_layout(
            port_tf.to_tp_layout(h0, cfg), cfg)),
        cfg, layout=("tp", "pp"))
    jp, jst = jax_ckpt.restore_lm(path, _jax_cfg())
    for got, want in ((jp, p0), (jst.history, h0)):
        for key, v in _flat(want).items():
            assert np.array_equal(np.asarray(_flat(got)[key]), v), key
    with pytest.raises(ValueError, match="unknown LM layout"):
        port_ckpt.save_lm(str(tmp_path / "lm"), p0, init_state(p0), cfg,
                          layout=("fsdp",))
