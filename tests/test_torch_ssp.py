"""The port's compiled SSP step (``parallel/trainer.SSPTrainStep``), its
snapshots and the ``train --staleness`` / ``--async_ssp`` CLI, against the
JAX package on the CPU.

- A four-process gloo job a seed of JOB_SEEDS (this file run as a
  script, once a rank, a ``file://`` store): ranks 0 and 1 run the flat cases over a two-rank
  group (DENSE, TOPK at 0.25, LOCAL on ip2, AdaRevision)
  against JAX's ``build_ssp_train_step`` on ``make_mesh(2)``; all four run
  the two-tier cases (2 slices of 2: DENSE, SFB on the FC layers, TOPK)
  against JAX's ``("dcn", "data")`` 2x2 mesh. Staleness 2, 2 (s+1) + 1 = 7
  steps (two boundaries and a local step past them), LeNet at 4 rows a
  rank: the anchor, this rank's local params, momentum, TOPK residual,
  AdaRevision sums and accumulators, and the losses at PARAM_TOL; the
  gathered (snapshot) rows in group order; the ranks of a group bitwise
  equal, the groups' local copies different.
- One process: the step against JAX's one-device mesh; SFB refused on a
  flat group with JAX's message; AdaRevision with TOPK refused.
- SSP snapshots cross-load with JAX both ways; ``coerce_state`` dense ->
  SSP and SSP -> dense and a new group count, against JAX's.
- The CLI on the CPU: two ``train --staleness 2`` ranks and two ``train
  --async_ssp --staleness 1`` ranks of the digits solver learn (test
  accuracy over 0.75 after 120 iterations; the async order of arrival is
  not deterministic, so these hold convergence, not bitwise equality);
  the SSP ranks' snapshots are bitwise equal and of kind "ssp";
  ``--slice`` still raises naming its item, and ``--mesh`` (ported) parses
  and raises only where JAX's does, with ``--dcn_slices``.
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

from poseidon_tpu_torch.core.net import Net, params_from_jax  # noqa: E402
from poseidon_tpu_torch.parallel import strategies as S  # noqa: E402
from poseidon_tpu_torch.parallel import trainer as T  # noqa: E402
from poseidon_tpu_torch.parallel.mesh import DataGroup  # noqa: E402
from poseidon_tpu_torch.proto.messages import (  # noqa: E402
    SolverParameter, load_net_from_string)
from poseidon_tpu_torch.runtime import checkpoint as CK  # noqa: E402
from poseidon_tpu_torch.runtime import cluster  # noqa: E402

LENET = "examples/mnist/lenet_train_test.prototxt"
DIGITS = "examples/digits/digits_train_test.prototxt"
B = 4                        # rows a rank
WORLD, SLICES = 4, 2
STALENESS = 2
STEPS = 2 * (STALENESS + 1) + 1
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)
WORKER_TIMEOUT_S = 180
# CommConfig fields both packages share; flat cases on 2 ranks, two-tier
# cases on 2 slices of 2
FLAT_CASES = {
    "dense": {},
    "topk": {"default_strategy": "topk", "topk_fraction": 0.25},
    "local": {"layer_strategies": {"ip2": "local"}},
    "adarevision": {"server_logic": "adarevision",
                    "adarev_init_step": 0.01},
}
TIER_CASES = {
    "two_tier_dense": {},
    "two_tier_sfb": {"layer_strategies": {"ip1": "sfb", "ip2": "sfb"}},
    "two_tier_topk": {"default_strategy": "topk", "topk_fraction": 0.25},
}


def _lenet_text():
    with open(os.path.join(REPO, LENET)) as f:
        return f.read()


def _port_lenet(rows=B):
    return Net(load_net_from_string(_lenet_text()), "TRAIN", device="cpu",
               source_shapes={"data": (rows, 1, 28, 28), "label": (rows,)})


def _np(t):
    return t.detach().cpu().numpy().copy()


def _flat_out(prefix, tree, out):
    for l, lv in tree.items():
        for p, v in lv.items():
            if isinstance(v, dict):
                for k, x in v.items():
                    out[f"{prefix}/{l}/{p}/{k}"] = _np(x)
            else:
                out[f"{prefix}/{l}/{p}"] = _np(v)


# --------------------------------------------------------------------- #
# the rank workers (this file run as a script)

def _run_case(group, case, fields, two_tier, d):
    net = _port_lenet()
    comm = S.CommConfig(dcn_axis="dcn" if two_tier else None, **fields)
    with np.load(os.path.join(d, "in.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key, v in flat.items():
        if key.startswith("params/"):
            layer, p = key[len("params/"):].split("/")
            params.setdefault(layer, {})[p] = v
    params = params_from_jax(net, params)
    step = T.build_ssp_train_step(net, SolverParameter(**SOLVER), STALENESS,
                                  group, comm)
    anchor, state = step.load(params, T.init_ssp_state(
        params, step.n_groups, comm))
    r = group.rank
    out = {"losses": [], "row": step.row}
    for k in range(STEPS):
        batch = {key[len(f"batch{k}/"):]: torch.from_numpy(
            v[r * B:(r + 1) * B]) for key, v in flat.items()
            if key.startswith(f"batch{k}/")}
        anchor, state, m = step.step(anchor, state, batch)
        out["losses"].append(float(m["loss"]))
    _flat_out("anchor", anchor, out)
    _flat_out("local", state.local_params, out)
    _flat_out("history", state.local_history, out)
    _flat_out("err", {l: {p: v[0] for p, v in lv.items()}
                      for l, lv in state.comm_error.items()}, out)
    _flat_out("gsum", state.adarev_gsum, out)
    _flat_out("server", state.adarev_server, out)
    gathered = step.gather_state(state)
    for kind in ("local_params", "local_history", "comm_error",
                 "adarev_gsum"):
        _flat_out(f"gathered_{kind}", getattr(gathered, kind), out)
    if r == 0:
        CK.snapshot(os.path.join(d, case), net, anchor, gathered)
    np.savez(os.path.join(d, f"{case}.rank{r}.npz"), **out)


def _worker(rank: int, world: int, store: str, d: str) -> int:
    import torch.distributed as dist
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world, slices=SLICES,
                                     coordinator=f"file://{store}")
    try:
        pair = dist.new_group([0, 1])
        if rank < 2:
            flat = DataGroup(rank=rank, world=2, device=torch.device("cpu"),
                             backend="gloo", pg=pair)
            for case, fields in FLAT_CASES.items():
                _run_case(flat, case, fields, False, d)
        for case, fields in TIER_CASES.items():
            _run_case(group, case, fields, True, d)
    finally:
        group.close()
    return 0


if __name__ == "__main__":
    # a rank worker: it stops here, before the reference side's imports
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4]))


# --------------------------------------------------------------------- #
# the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from poseidon_tpu.core.net import Net as JaxNet  # noqa: E402
from poseidon_tpu.parallel import strategies as JS  # noqa: E402
from poseidon_tpu.parallel import trainer as JT  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver  # noqa: E402,E501
from poseidon_tpu.proto.messages import load_net_from_string as jax_str  # noqa: E402,E501
from poseidon_tpu.runtime import checkpoint as JCK  # noqa: E402


def _jax_lenet(rows=B):
    return JaxNet(jax_str(_lenet_text()), "TRAIN", conv_layout="NCHW",
                  source_shapes={"data": (rows, 1, 28, 28),
                                 "label": (rows,)})


def _inputs(seed, rows):
    params = jax.tree_util.tree_map(
        np.asarray, _jax_lenet().init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 100)
    batches = [{"data": rs.randn(rows, 1, 28, 28).astype(np.float32),
                "label": rs.randint(0, 10, size=(rows,)).astype(np.float32)}
               for _ in range(STEPS)]
    return params, batches


_JAX_STEPS = {}


def _jax_ssp(fields, mesh, params, batches, n_groups, dcn=False):
    """JAX's SSP run: (final state as numpy, losses). The compiled step is
    kept for the next seed of the same case."""
    comm = JS.CommConfig(dcn_axis="dcn" if dcn else None, **fields)
    key = (repr(fields), tuple(mesh.shape.items()), dcn)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = JT.build_ssp_train_step(
            _jax_lenet(), JaxSolver(**SOLVER), mesh, STALENESS, comm)
    ts = _JAX_STEPS[key]
    state = JT.init_ssp_state(jax.tree_util.tree_map(jnp.asarray, params),
                              n_groups, comm)
    losses = []
    for b in batches:
        state, m = ts.step(state, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return jax.tree_util.tree_map(np.asarray, state), losses


# The job's seeds. XLA and torch sum a conv or an inner product in other
# orders on the CPU, so JAX's run and the port's differ by a few ulps from
# the first step. A sweep of seeds 1-12 and 41 (the job with every step's
# state saved, held against JAX's trajectory step by step) kept them
# under 0.06 of PARAM_TOL's allowance in the params, momentum and
# residuals at every step, and under 0.4 in AdaRevision's gradient sums,
# until a discrete decision lay within that reach. Past one the two runs
# part for good: a max-pool window whose top two values are a few ulps
# apart, a ReLU input within ~1e-6 of zero, or a TOPK candidate equal to
# the k-th magnitude to an ulp. Each failing seed of the sweep parts at
# one such decision, read from both packages on the same state:
#   3: two_tier_topk, step 3: ip1/w's k-th and (k+1)-th |delta| are one
#      f32 value, 3.80956e-4 (sent and kept swap);
#   4: two_tier_dense and _sfb, step 5: a relu1 input of 8.7e-7 (rank 0,
#      unit 378); two_tier_topk, step 6: an ip1/w tie at 6.16007e-4;
#   5: topk, step 6: ip1/w candidates 9.18832e-4 and 9.18835e-4;
#   7: two_tier_topk, step 7: a relu1 input of 6.6e-8 changes sign;
#   10: dense, step 5: a pool2 window's top two 1.9e-6 apart;
#   11: topk, step 3: ip1/w candidates 5.12490e-4 and 5.12488e-4; the
#       two-tier cases, step 3: a pool2 window's top two 3.4e-7 apart;
#   41: the two-tier cases, step 3: a pool2 window's top two 4.4e-7
#       apart.
# Seeds 1, 2, 6, 8, 9 and 12 meet none; the job runs three of them.
JOB_SEEDS = (1, 2, 6)


def _run_job(tmp_path_factory, seed):
    d = tmp_path_factory.mktemp(f"ssp_seed{seed}")
    params, batches = _inputs(seed=seed, rows=WORLD * B)
    arrays = {f"params/{l}/{p}": v for l, lv in params.items()
              for p, v in lv.items()}
    for k, b in enumerate(batches):
        arrays.update({f"batch{k}/{t}": v for t, v in b.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(d / "store"), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    results = {}
    for case in (*FLAT_CASES, *TIER_CASES):
        ranks = 2 if case in FLAT_CASES else WORLD
        results[case] = []
        for r in range(ranks):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return d, params, batches, results


@pytest.fixture(scope="module")
def ssp_job(tmp_path_factory):
    return _run_job(tmp_path_factory, JOB_SEEDS[0])


@pytest.fixture(scope="module", params=JOB_SEEDS[1:],
                ids=lambda seed: f"seed{seed}")
def ssp_job_more_seeds(request, tmp_path_factory):
    return _run_job(tmp_path_factory, request.param)


def _held(res, prefix, tree, row, what):
    """Each leaf of ``tree`` (row ``row`` of a stacked tree when row is
    not None) against the rank's ``prefix/...`` arrays."""
    keys = set()
    for l, lv in tree.items():
        for p, v in lv.items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for k, x in leaves:
                key = f"{prefix}/{l}/{p}" + (f"/{k}" if k else "")
                keys.add(key)
                want = x if row is None else x[row]
                np.testing.assert_allclose(res[key], want, **PARAM_TOL,
                                           err_msg=f"{what} {key}")
    assert keys == {k for k in res if k.startswith(prefix + "/")}, what


def _check_case(case, results, ref, row_of):
    state, losses = ref
    for r, res in enumerate(results[case]):
        what = f"{case} rank {r}"
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=what)
        row = row_of(r)
        assert int(res["row"]) == row
        _held(res, "anchor", state.anchor_params, None, what)
        _held(res, "local", state.local_params, row, what)
        _held(res, "history", state.local_history, row, what)
        _held(res, "err", state.comm_error, row, what)
        _held(res, "gsum", state.adarev_gsum, row, what)
        _held(res, "server", state.adarev_server, None, what)
        # every rank gathers every group's rows, in group order
        for kind, tree in (("local_params", state.local_params),
                           ("local_history", state.local_history),
                           ("comm_error", state.comm_error),
                           ("adarev_gsum", state.adarev_gsum)):
            for l, lv in tree.items():
                for p, v in lv.items():
                    got = res[f"gathered_{kind}/{l}/{p}"]
                    assert got.shape == v.shape, f"{what} {kind}"
                    np.testing.assert_allclose(got, v, **PARAM_TOL,
                                               err_msg=f"{what} {kind}")


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_ssp_step_matches_jax_two_device_mesh(ssp_job, case):
    _flat_case(ssp_job, case)


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_ssp_step_matches_jax_on_more_seeds(ssp_job_more_seeds, case):
    _flat_case(ssp_job_more_seeds, case)


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_two_tier_ssp_step_matches_jax_2x2_mesh(ssp_job, case):
    _two_tier_case(ssp_job, case)


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_two_tier_ssp_step_matches_jax_on_more_seeds(ssp_job_more_seeds,
                                                     case):
    _two_tier_case(ssp_job_more_seeds, case)


def _flat_case(job, case):
    _, params, batches, results = job
    ref = _jax_ssp(FLAT_CASES[case], make_mesh(2), params,
                   [{k: v[:2 * B] for k, v in b.items()} for b in batches], 2)
    _check_case(case, results, ref, lambda r: r)
    # the two groups diverge between boundaries: their local copies differ
    a, b = results[case]
    assert not all(np.array_equal(a[k], b[k]) for k in a
                   if k.startswith("local/"))


def _two_tier_case(job, case):
    _, params, batches, results = job
    mesh = make_mesh(WORLD, axes=("dcn", "data"), shape=(SLICES, 2))
    ref = _jax_ssp(TIER_CASES[case], mesh, params, batches, SLICES,
                   dcn=True)
    _check_case(case, results, ref, lambda r: r // 2)
    ranks = results[case]
    for a, b in ((0, 1), (2, 3)):      # a slice's ranks hold one copy
        assert all(np.array_equal(ranks[a][k], ranks[b][k])
                   for k in ranks[a] if k.startswith(("local/", "err/")))


def test_ssp_snapshots_of_the_job_restore_in_jax(ssp_job):
    """Rank 0's SSP snapshots (the gathered rows) restore in JAX as the
    SSPState of JAX's own run, at PARAM_TOL, and its .caffemodel holds the
    anchor."""
    d, params, batches, results = ssp_job
    for case in ("adarevision", "two_tier_topk"):
        path = str(d / f"{case}_iter_{STEPS}.solverstate.npz")
        with np.load(path) as z:
            assert str(z["kind"]) == "ssp" and int(z["iter"]) == STEPS
        jparams, jstate = JCK.restore(path)
        assert isinstance(jstate, JT.SSPState)
        res = results[case][0]
        for l, lv in jstate.local_params.items():
            for p, v in lv.items():
                np.testing.assert_array_equal(
                    np.asarray(v), res[f"gathered_local_params/{l}/{p}"])
        for l, lv in jparams.items():
            for p, v in lv.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              res[f"anchor/{l}/{p}"])
        net = _jax_lenet()
        from poseidon_tpu.runtime.checkpoint import load_caffemodel
        w = load_caffemodel(str(d / f"{case}_iter_{STEPS}.caffemodel"), net,
                            jparams)
        for l, lv in w.items():
            for p, v in lv.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              res[f"anchor/{l}/{p}"])


# --------------------------------------------------------------------- #
# one process

def test_one_process_ssp_step_matches_jax_one_device_mesh():
    params, batches = _inputs(seed=3, rows=B)
    fields = {"layer_strategies": {"ip1": "topk"}, "topk_fraction": 0.1}
    state, losses = _jax_ssp(fields, Mesh(np.array(jax.devices()[:1]),
                                          ("data",)), params, batches, 1)
    net = _port_lenet()
    comm = S.CommConfig(**fields)
    step = T.build_ssp_train_step(net, SolverParameter(**SOLVER), STALENESS,
                                  None, comm)
    p = params_from_jax(net, params)
    anchor, st = step.load(p, T.init_ssp_state(p, 1, comm))
    got = []
    for b in batches:
        anchor, st, m = step.step(anchor, st, {k: torch.from_numpy(v)
                                               for k, v in b.items()})
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    for l, lv in state.anchor_params.items():
        for k, v in lv.items():
            np.testing.assert_allclose(_np(anchor[l][k]), v, **PARAM_TOL)
            np.testing.assert_allclose(_np(st.local_params[l][k]),
                                       state.local_params[l][k][0],
                                       **PARAM_TOL)
    for l, lv in state.comm_error.items():
        for k, v in lv.items():
            np.testing.assert_allclose(_np(st.comm_error[l][k]), v,
                                       **PARAM_TOL)
    assert st.it == STEPS == int(state.it)


def test_sfb_on_a_flat_group_and_adarevision_with_topk_refused():
    net = _port_lenet()
    sp = SolverParameter(**SOLVER)
    for comm in (S.CommConfig(layer_strategies={"ip1": "sfb"}),
                 S.CommConfig(default_strategy="sfb")):
        with pytest.raises(ValueError) as port_err:
            T.build_ssp_train_step(net, sp, STALENESS, None, comm)
        jcomm = JS.CommConfig(layer_strategies=dict(comm.layer_strategies),
                              default_strategy=comm.default_strategy)
        with pytest.raises(ValueError) as jax_err:
            JT.build_ssp_train_step(_jax_lenet(), JaxSolver(**SOLVER),
                                    make_mesh(1), STALENESS, jcomm)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="does not compose with TOPK"):
        T.build_ssp_train_step(net, sp, STALENESS, None, S.CommConfig(
            server_logic="adarevision", default_strategy="topk"))
    with pytest.raises(ValueError, match="staleness"):
        T.build_ssp_train_step(net, sp, 0, None, S.CommConfig())


# --------------------------------------------------------------------- #
# snapshots and coerce_state against JAX

def _jax_state(fields, n_groups, seed=5):
    """A stacked JAX SSPState with distinct rows (two local steps' worth
    of noise on the fresh state) and its params."""
    params, _ = _inputs(seed=seed, rows=B)
    comm = JS.CommConfig(**fields)
    st = JT.init_ssp_state(jax.tree_util.tree_map(jnp.asarray, params),
                           n_groups, comm)
    rs = np.random.RandomState(seed)
    noisy = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(np.asarray(x) + rs.randn(*x.shape).astype(
            np.float32) * 1e-3), t)
    st = st._replace(local_params=noisy(st.local_params),
                     local_history=noisy(st.local_history),
                     comm_error=noisy(st.comm_error),
                     adarev_gsum=noisy(st.adarev_gsum),
                     it=jnp.asarray(5, jnp.int32))
    return params, st, comm


def _same_tree(port_tree, jax_tree, what):
    flat_p = CK._flatten(port_tree)
    flat_j = JCK._flatten(jax_tree)
    assert sorted(flat_p) == sorted(flat_j), what
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_p[k], v, err_msg=f"{what} {k}")


@pytest.mark.parametrize("fields", [
    {"layer_strategies": {"ip1": "topk"}},
    {"server_logic": "adarevision"}], ids=["topk", "adarevision"])
def test_ssp_snapshots_cross_load_with_jax_both_ways(tmp_path, fields):
    params, jstate, _ = _jax_state(fields, 2)
    jnet = _jax_lenet()
    JCK.snapshot(str(tmp_path / "j"), jnet, params, jstate)
    p, st = CK.restore(str(tmp_path / "j_iter_5.solverstate.npz"))
    assert isinstance(st, T.SSPState) and st.it == 5
    for f in ("local_params", "local_history", "anchor_params",
              "comm_error", "adarev_server", "adarev_gsum"):
        _same_tree(getattr(st, f), getattr(jstate, f), f)
    # and back: the port's snapshot of that state restores in JAX
    CK.snapshot(str(tmp_path / "t"), _port_lenet(), p, st)
    jp, back = JCK.restore(str(tmp_path / "t_iter_5.solverstate.npz"))
    assert isinstance(back, JT.SSPState) and int(back.it) == 5
    for f in ("local_params", "local_history", "anchor_params",
              "comm_error", "adarev_server", "adarev_gsum"):
        _same_tree(getattr(st, f), getattr(back, f), f)
    with open(tmp_path / "j_iter_5.caffemodel", "rb") as a, \
            open(tmp_path / "t_iter_5.caffemodel", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("staleness,n_dev,fields", [
    (2, 2, {"layer_strategies": {"ip1": "topk"}}),   # SSP -> SSP
    (0, 2, {"layer_strategies": {"ip1": "topk"}}),   # SSP -> dense
    (2, 3, {}),                                      # another group count
    (2, 2, {"server_logic": "adarevision"}),         # accumulators kept
    (2, 2, {"adarev_init_step": 0.3}),               # adarevision -> inc
])
def test_coerce_ssp_state_is_jax_coerce_state(staleness, n_dev, fields):
    saved = {"server_logic": "adarevision"} \
        if "adarev_init_step" in fields else fields
    params, jstate, _ = _jax_state(saved, 2)
    jcomm = JS.CommConfig(**fields)
    jp, jst = JCK.coerce_state(params, jstate, staleness=staleness,
                               n_dev=n_dev, comm=jcomm)
    tp = {l: {k: torch.from_numpy(np.array(v)) for k, v in lv.items()}
          for l, lv in params.items()}
    tstate = T.SSPState(**{
        f: CK._unflatten(JCK._flatten(getattr(jstate, f)))
        for f in ("local_params", "local_history", "anchor_params",
                  "comm_error", "adarev_server", "adarev_gsum")},
        it=int(jstate.it))
    gp, gst = CK.coerce_state(tp, tstate, staleness=staleness, n_dev=n_dev,
                              comm=S.CommConfig(**fields))
    _same_tree(gp, jp, "params")
    assert type(gst).__name__ == type(jst).__name__
    if isinstance(jst, JT.SSPState):
        assert gst.it == int(jst.it)
        for f in ("local_params", "local_history", "anchor_params",
                  "comm_error", "adarev_server", "adarev_gsum"):
            _same_tree(getattr(gst, f), getattr(jst, f), f)
    else:
        assert gst.solver.it == int(jst.solver.it)
        _same_tree(gst.solver.history, jst.solver.history, "history")
        _same_tree(gst.comm_error, jst.comm_error, "comm_error")


def test_coerce_dense_state_to_ssp_is_jax_coerce_state():
    params, _ = _inputs(seed=9, rows=B)
    jcomm = JS.CommConfig(layer_strategies={"ip2": "topk"})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jdense = JT.init_train_state(jparams, jcomm, 2)
    jdense = jdense._replace(solver=jdense.solver._replace(
        it=jnp.asarray(4, jnp.int32)))
    _, jst = JCK.coerce_state(jparams, jdense, staleness=2, n_dev=2,
                              comm=jcomm)
    tp = {l: {k: torch.from_numpy(np.array(v)) for k, v in lv.items()}
          for l, lv in params.items()}
    comm = S.CommConfig(layer_strategies={"ip2": "topk"})
    dense = T.init_train_state(tp, comm, 2)
    dense = dense._replace(solver=dense.solver._replace(it=4))
    _, gst = CK.coerce_state(tp, dense, staleness=2, n_dev=2, comm=comm)
    assert isinstance(gst, T.SSPState) and gst.it == 4
    for f in ("local_params", "local_history", "anchor_params",
              "comm_error", "adarev_server", "adarev_gsum"):
        _same_tree(getattr(gst, f), getattr(jst, f), f)


# --------------------------------------------------------------------- #
# the CLI

def _digits_solver(tmp_path, max_iter=120):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, DIGITS)}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 40\n'
        f'max_iter: {max_iter}\ntest_iter: 6\ntest_interval: {max_iter}\n'
        'test_initialization: false\nsnapshot_prefix: "digits"\n')
    return solver


def _cli_ranks(tmp_path, flags, env_extra):
    solver = _digits_solver(tmp_path)
    procs = []
    for r in range(2):
        env = dict(os.environ, POSEIDON_PROC_ID=str(r),
                   POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="2", **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "poseidon_tpu_torch", "train",
             f"--solver={solver}", "--output_dir", str(tmp_path / f"p{r}"),
             "--device", "cpu", *flags], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    return logs


def _test_accuracy(log):
    lines = [ln for ln in log.splitlines() if "Test net #0" in ln]
    assert lines, log[-2000:]
    return float(lines[-1].split("accuracy = ")[1].split(",")[0])


def test_cli_train_staleness_two_ranks_learn_digits(tmp_path):
    logs = _cli_ranks(tmp_path, ("--staleness", "2"), {
        "POSEIDON_COORDINATOR": f"file://{tmp_path / 'store'}"})
    assert "SSP: staleness 2 (sync every 3 iters) over 2 group(s)" in logs[0]
    assert _test_accuracy(logs[0]) > 0.75
    a, b = (tmp_path / f"p{r}" / "digits_iter_120.solverstate.npz"
            for r in range(2))
    with np.load(a) as za, np.load(b) as zb:
        assert str(za["kind"]) == "ssp"
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), k
        rows = [za[k].shape[0] for k in za.files
                if k.startswith("local_params/")]
        assert rows and set(rows) == {2}
    # the SSP snapshot resumes, in the port, in either mode
    from poseidon_tpu_torch.runtime.cli import main
    solver = _digits_solver(tmp_path / "p0", max_iter=123)
    for flags in (["--staleness", "2"], []):
        assert main(["train", f"--solver={solver}", "--output_dir",
                     str(tmp_path / "resume"), "--device", "cpu",
                     "--snapshot", str(a), *flags]) == 0


def test_cli_train_async_ssp_two_ranks_learn_digits(tmp_path):
    # the budget's bucket (one second of it, at least 64 KiB) holds less
    # than one flush of the digits net (~112 KB of f32), so every flush
    # between boundaries is partial however fast or loaded the host is
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = _cli_ranks(
        tmp_path, ("--async_ssp", "--staleness", "1",
                   "--async_sync_every", "2", "--comm_budget_mbps", "0.5"),
        {"POSEIDON_COORDINATOR": f"file://{tmp_path / 'store'}",
         "POSEIDON_ASYNC_SERVICE": f"127.0.0.1:{port}",
         "POSEIDON_ASYNC_TOKEN": "cli-token"})
    assert "async-SSP tier: 2 members, staleness 1" in logs[0]
    assert "distributed:" not in logs[0]          # no process group
    assert _test_accuracy(logs[0]) > 0.75
    for r, log in enumerate(logs):
        line = next(ln for ln in log.splitlines()
                    if ln.startswith(f"async-SSP tier (rank {r}):"))
        assert "async_final_clock=59.0" in line
        assert "async_comm_partial_pushes=0.0" not in line


@pytest.mark.parametrize("flags,item", [(["--mesh", "dp2,fsdp1,tp1"], "5"),
                                        (["--slice"], "6")])
def test_cli_mesh_and_slice_raise_naming_their_item(flags, item):
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.runtime.cli import (async_from_args,
                                                build_parser, comm_from_args,
                                                mesh_from_args)
    args = build_parser().parse_args(["train", "--solver=x", *flags])
    if item == "5":
        # the mesh planner is ported: the flag parses, and only the
        # composition JAX refuses raises
        assert mesh_from_args(args) == MeshConfig(data=2)
        comm_from_args(args)
        async_from_args(args)
        both = build_parser().parse_args(
            ["train", "--solver=x", *flags, "--dcn_slices", "2"])
        with pytest.raises(SystemExit, match="do not compose"):
            comm_from_args(both)
        return
    # the fabric is ported: --slice parses, and without --async_ssp it is
    # refused with the JAX CLI's message
    comm_from_args(args)
    with pytest.raises(SystemExit, match="it requires --async_ssp"):
        async_from_args(args)
