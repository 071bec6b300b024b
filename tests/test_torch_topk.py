"""TOPK compressed sync with error feedback and the two-tier group of the
port, against the JAX package on the CPU.

- ``topk_compress`` against JAX's on the same numpy inputs, BITWISE for
  what it sends and for the residual, over chained steps: magnitude
  (global; blocked with the block dividing the size or not; the fallback
  to the global selection when k is below the block count or the size
  within one block), fixed_order over a full rotation, bf16 and f16
  wires, fraction 1, integer-valued inputs full of ties (the lower index
  wins, as ``lax.top_k`` does), and the random policy's selection given
  JAX's own scores. The port's random draw (a ``torch.Generator``, not
  JAX's threefry) is held to its invariants instead.
- ``budget_topk_fraction`` and ``comm_salt`` equal to JAX's.
- One process, no data group: the TOPK step against JAX's one-device mesh
  step, params, momentum and the residual, after 1 and 3 steps at the
  train-step tolerance (rtol 1e-4, atol 1e-6).
- Residual rows: ``reconcile_comm_error`` against JAX's ``coerce_state``
  across strategy and topology changes, and ``TrainStep.load`` taking
  each rank's row (a flat world-2 snapshot on 2 slices keeps both rows; a
  world-4 one zero-fills).
- Snapshots with residuals cross-load with JAX both ways.
- ONE four-process gloo job (this file run as a script, once per rank, a
  ``file://`` store) on the two-tier group of 2 slices x 2, against JAX's
  ``make_mesh(4, axes=("dcn", "data"), shape=(2, 2))`` over 4 of the 8
  virtual devices: DENSE, SFB and TOPK at 0.25, after 1 and 3 steps at
  the train-step tolerance, each slice's residual against JAX's row; the
  four ranks end bitwise equal, each slice's two ranks with bitwise-equal
  residuals.
- The CLI: the TOPK and two-tier flags build JAX's config; a
  ``--dcn_slices`` that does not divide the world exits; ``--mesh``
  refuses; two ``train --strategy topk`` ranks (flat, and on 2 slices
  with the async snapshot writer) write bitwise-equal snapshots holding
  both residual rows, which JAX restores.
"""

import os
import subprocess
import sys
import zlib

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
B = 4                    # rows a rank
WORLD4, SLICES = 4, 2    # the two-tier job: 2 slices of 2 ranks
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)
WORKER_TIMEOUT_S = 120
# the two-tier cases: CommConfig fields both packages share
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


def _tree_np(tree):
    return {l: {p: v.detach().cpu().numpy().copy() for p, v in lv.items()}
            for l, lv in tree.items()}


# --------------------------------------------------------------------- #
# the rank workers of the two-tier job (this file run as a script)

def _run_tier_case(group, case, d):
    net = _port_lenet()
    comm = S.CommConfig(dcn_axis="dcn", **TIER_CASES[case])
    with np.load(os.path.join(d, f"{case}.in.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key, v in flat.items():
        if key.startswith("params/"):
            layer, p = key[len("params/"):].split("/")
            params.setdefault(layer, {})[p] = v
    params = params_from_jax(net, params)
    step = T.build_train_step(net, SolverParameter(**SOLVER), group, comm)
    params, state = step.load(params, T.init_train_state(
        params, comm, step.n_err_groups))
    r = group.rank
    out = {"losses": [], "n_err_groups": step.n_err_groups,
           "err_row": step.err_row}
    for k in range(STEPS):
        batch = {key[len(f"batch{k}/"):]: torch.from_numpy(
            v[r * B:(r + 1) * B]) for key, v in flat.items()
            if key.startswith(f"batch{k}/")}
        params, state, m = step.step(params, state, batch)
        out["losses"].append(float(m["loss"]))
        if k in (0, STEPS - 1):
            for kind, tree in (("params", params),
                               ("history", state.solver.history)):
                for layer, leaves in _tree_np(tree).items():
                    for p, v in leaves.items():
                        out[f"step{k + 1}/{kind}/{layer}/{p}"] = v
            for layer, leaves in _tree_np(state.comm_error).items():
                for p, v in leaves.items():
                    out[f"err{k + 1}/{layer}/{p}"] = v[0]
    stacked = step.gather_comm_error(state.comm_error)
    for layer, leaves in _tree_np(stacked).items():
        for p, v in leaves.items():
            out[f"gathered/{layer}/{p}"] = v
    np.savez(os.path.join(d, f"{case}.rank{r}.npz"), **out)


def _worker(rank: int, world: int, store: str, d: str) -> int:
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world, slices=SLICES,
                                     coordinator=f"file://{store}")
    try:
        assert group.backend == "gloo" and group.slices == SLICES
        assert group.slice_index == rank // 2
        assert group.index_in_slice == rank % 2
        for case in TIER_CASES:
            _run_tier_case(group, case, d)
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
    """(params as numpy, STEPS batches of ``rows`` rows)."""
    params = jax.tree_util.tree_map(
        np.asarray, _jax_lenet().init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 100)
    batches = [{"data": rs.randn(rows, 1, 28, 28).astype(np.float32),
                "label": rs.randint(0, 10, size=(rows,)).astype(np.float32)}
               for _ in range(STEPS)]
    return params, batches


def _jax_run(comm, mesh, params, batches):
    """{step: (params, history, loss, comm_error)} after steps 1 and
    STEPS, numpy."""
    ts = JT.build_train_step(_jax_lenet(), JaxSolver(**SOLVER), mesh, comm,
                             donate=False)
    state = JT.init_train_state(params, comm,
                                JT.comm_error_groups(comm, mesh))
    out = {}
    for k, b in enumerate(batches):
        params, state, m = ts.step(params, state, b, jax.random.PRNGKey(0))
        if k + 1 in (1, STEPS):
            out[k + 1] = tuple(jax.tree_util.tree_map(np.asarray, t) for t in
                               (params, state.solver.history)) + (
                float(m["loss"]),
                jax.tree_util.tree_map(np.asarray, state.comm_error))
    return out


def _assert_tree_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for l, lv in want.items():
        assert sorted(got[l]) == sorted(lv), f"{what} {l}"
        for p, v in lv.items():
            np.testing.assert_allclose(got[l][p], v, **PARAM_TOL,
                                       err_msg=f"{what} {l}/{p}")


# --------------------------------------------------------------------- #
# topk_compress against JAX's

# name: (shape, fraction, policy, block, wire, steps)
COMPRESS_CASES = {
    "magnitude": ((40, 50), 0.1, "magnitude", None, None, 3),
    "magnitude_blocked": ((64, 32), 0.1, "magnitude", 128, None, 3),
    "magnitude_blocked_ragged": ((1000,), 0.05, "magnitude", 96, None, 3),
    # k = 5 < 16 blocks: the global selection
    "magnitude_blocked_fallback": ((1000,), 0.005, "magnitude", 64, None, 3),
    # the whole tensor within one block: the global selection
    "magnitude_block_over_size": ((100,), 0.1, "magnitude", 256, None, 3),
    "magnitude_fraction_1": ((37,), 1.0, "magnitude", None, None, 2),
    "wire_bf16": ((40, 50), 0.1, "magnitude", None, "bf16", 3),
    "wire_f16": ((40, 50), 0.1, "magnitude", None, "f16", 3),
    "blocked_wire_bf16": ((333,), 0.2, "magnitude", 50, "bf16", 3),
    # ceil(333 / 49) = 7 slabs: a full rotation and a step past it
    "fixed_order": ((333,), 0.15, "fixed_order", None, None, 8),
    "fixed_order_wire_f16": ((7, 9), 0.3, "fixed_order", None, "f16", 5),
}


def _chain(name, g_of, e0, salt=0):
    """Both packages' (sent, residual) over the case's steps, the
    residual fed back, each step's gradient from ``g_of(step)``."""
    shape, fraction, policy, block, wire, steps = COMPRESS_CASES[name]
    je, te = jnp.asarray(e0), torch.from_numpy(e0.copy())
    out = []
    for it in range(steps):
        g = g_of(it)
        js, je = JS.topk_compress(jnp.asarray(g), fraction, je, policy, it,
                                  salt=salt, block=block, wire=wire)
        ts, te = S.topk_compress(torch.from_numpy(g), fraction, te, policy,
                                 it, salt=salt, block=block, wire=wire)
        out.append((np.asarray(js), np.asarray(je), ts.numpy(), te.numpy()))
    return out


@pytest.mark.parametrize("name", list(COMPRESS_CASES))
def test_topk_compress_bitwise_to_jax(name):
    shape = COMPRESS_CASES[name][0]
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    grads = [rs.randn(*shape).astype(np.float32) for _ in range(8)]
    e0 = (0.1 * rs.randn(*shape)).astype(np.float32)
    for it, (js, je, ts, te) in enumerate(_chain(name, grads.__getitem__,
                                                 e0)):
        assert ts.dtype == np.float32 and ts.shape == shape
        assert np.array_equal(ts, js), f"{name}: sent at step {it}"
        assert np.array_equal(te, je), f"{name}: residual at step {it}"


@pytest.mark.parametrize("name", ["magnitude", "magnitude_blocked",
                                  "magnitude_blocked_ragged", "wire_bf16"])
def test_topk_ties_go_to_the_lower_index_as_in_jax(name):
    """Integer-valued gradients, |x| in {0..3}: the k-th magnitude is
    shared by many entries, and both packages pick the same ones."""
    shape = COMPRESS_CASES[name][0]
    rs = np.random.RandomState(5)
    grads = [rs.randint(-3, 4, size=shape).astype(np.float32)
             for _ in range(3)]
    for it, (js, je, ts, te) in enumerate(_chain(
            name, grads.__getitem__, np.zeros(shape, np.float32))):
        assert np.array_equal(ts, js), f"{name}: sent at step {it}"
        assert np.array_equal(te, je), f"{name}: residual at step {it}"


def test_top_mask_breaks_ties_by_the_lower_index():
    m = S._top_mask(torch.tensor([1.0, 2.0, 2.0, 2.0, 1.0, 3.0]), 3)
    assert m.tolist() == [False, True, True, False, False, True]
    rows = S._top_mask(torch.ones(2, 5), 2)
    assert rows.tolist() == [[True, True, False, False, False]] * 2


@pytest.mark.parametrize("block", [None, 64, 96])
def test_random_selection_given_jax_scores_is_jax(block):
    """The random policy's selection (global and blocked) fed JAX's own
    threefry scores equals JAX's ``topk_compress(policy="random")``."""
    n, fraction, salt, it = 1000, 0.1, S.comm_salt("ip1", "w"), 4
    rs = np.random.RandomState(3)
    g = rs.randn(n).astype(np.float32)
    e = (0.1 * rs.randn(n)).astype(np.float32)
    js, je = JS.topk_compress(jnp.asarray(g), fraction, jnp.asarray(e),
                              "random", it, salt=salt, block=block)
    key = jax.random.fold_in(jax.random.PRNGKey(17 + salt), it)
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    flat = torch.from_numpy(g) + torch.from_numpy(e)
    k = max(1, int(n * fraction))
    sent = (S._blocked_select(flat, scores, k, block) if block
            else S._global_select(flat, scores, k))
    assert np.array_equal(sent.numpy(), np.asarray(js))
    assert np.array_equal((flat - sent).numpy(), np.asarray(je))


def test_random_draw_invariants():
    """The port's own draw: exactly k entries a step, sent + residual =
    g + residual before bitwise, the same subset for the same (salt,
    step), a new one each step, unrelated across layers, every entry sent
    within the run and about fraction x steps times, and the global RNG
    untouched."""
    n, fraction, steps = 2000, 0.05, 400
    k = int(n * fraction)
    g = torch.ones(n)
    err = torch.zeros(n)
    salt = S.comm_salt("conv1", "w")
    rng_before = torch.random.get_rng_state()
    sends = np.zeros(n, np.int64)
    last = np.full(n, -1)
    gaps = []
    for it in range(steps):
        sent, new_err = S.topk_compress(g, fraction, err, "random", it,
                                        salt=salt)
        assert torch.equal(sent + new_err, g + err)
        idx = np.flatnonzero(sent.numpy())
        assert idx.size == k
        gaps.extend(it - last[idx])
        last[idx] = it
        sends[idx] += 1
        err = new_err
    assert torch.equal(torch.random.get_rng_state(), rng_before)
    assert (sends > 0).all()
    assert abs(sends.mean() - steps * fraction) < 1e-9     # k a step
    # a sent entry waited about 1 / fraction steps since its last send
    assert 0.8 / fraction < np.mean(gaps) < 1.2 / fraction
    a, _ = S.topk_compress(g, fraction, torch.zeros(n), "random", 3,
                           salt=salt)
    b, _ = S.topk_compress(g, fraction, torch.zeros(n), "random", 3,
                           salt=salt)
    c, _ = S.topk_compress(g, fraction, torch.zeros(n), "random", 4,
                           salt=salt)
    other, _ = S.topk_compress(g, fraction, torch.zeros(n), "random", 3,
                               salt=S.comm_salt("conv2", "w"))
    nz = [set(np.flatnonzero(t.numpy())) for t in (a, b, c, other)]
    assert nz[0] == nz[1] and nz[0] != nz[2]
    # two independent k-subsets of n share about k * fraction entries
    assert len(nz[0] & nz[3]) < 0.3 * k
    with pytest.raises(ValueError, match="step counter"):
        S.topk_compress(g, fraction, err, "random")
    with pytest.raises(ValueError, match="step counter"):
        S.topk_compress(g, fraction, err, "fixed_order")


def test_comm_salt_and_budget_fraction_equal_jax():
    for layer, p in (("conv1", "w"), ("ip2", "b"), ("a/b", "w")):
        assert S.comm_salt(layer, p) == JS.comm_salt(layer, p)
    net, jnet = _port_lenet(), _jax_lenet()
    for fields in ({}, {"bandwidth_budget_mb": 0.05},
                   {"bandwidth_budget_mb": 0.05, "default_strategy": "topk"},
                   {"bandwidth_budget_mb": 1e-9, "default_strategy": "topk"},
                   {"bandwidth_budget_mb": 100.0,
                    "layer_strategies": {"ip1": "topk"}}):
        assert S.budget_topk_fraction(net, S.CommConfig(**fields)) == \
            JS.budget_topk_fraction(jnet, JS.CommConfig(**fields)), fields


def test_comm_config_defaults_and_validation_follow_jax():
    port, jaxc = S.CommConfig(), JS.CommConfig()
    for f in ("topk_fraction", "topk_policy", "bandwidth_budget_mb",
              "topk_block", "dcn_axis", "default_strategy", "reduce",
              "wire_dtype"):
        assert getattr(port, f) == getattr(jaxc, f), f
    S.CommConfig(default_strategy=S.TOPK, dcn_axis="dcn",
                 layer_strategies={"ip1": S.SFB})
    with pytest.raises(ValueError, match="topk_policy"):
        S.CommConfig(topk_policy="largest")
    with pytest.raises(ValueError, match="unknown topk_policy"):
        JS.topk_compress(jnp.ones(4), 0.5, jnp.zeros(4), "largest", 0)


# --------------------------------------------------------------------- #
# one process: the step still compresses, as JAX's one-device mesh does

@pytest.mark.parametrize("fields", [
    {"default_strategy": "topk", "topk_fraction": 0.1},
    {"layer_strategies": {"ip1": "topk", "conv2": "topk"},
     "topk_fraction": 0.05, "topk_block": 512},
], ids=["all_layers", "two_layers_blocked"])
def test_one_process_topk_step_matches_jax_one_device_mesh(fields):
    params, batches = _inputs(seed=21, rows=B)
    ref = _jax_run(JS.CommConfig(**fields),
                   Mesh(np.array(jax.devices()[:1]), ("data",)),
                   params, batches)
    net = _port_lenet()
    comm = S.CommConfig(**fields)
    step = T.build_train_step(net, SolverParameter(**SOLVER), None, comm)
    assert step.sync is None and step.n_err_groups == 1
    p = params_from_jax(net, params)
    p, state = step.load(p, T.init_train_state(p, comm, 1))
    for k, b in enumerate(batches):
        p, state, m = step.step(p, state, {t: torch.from_numpy(v)
                                           for t, v in b.items()})
        if k + 1 in ref:
            jp, jh, jloss, jerr = ref[k + 1]
            np.testing.assert_allclose(float(m["loss"]), jloss,
                                       rtol=LOSS_RTOL)
            _assert_tree_close(_tree_np(p), jp, f"params, step {k + 1}")
            _assert_tree_close(_tree_np(state.solver.history), jh,
                               f"history, step {k + 1}")
            _assert_tree_close(_tree_np(state.comm_error), jerr,
                               f"residual, step {k + 1}")
    assert all(np.abs(v).max() > 0 for lv in _tree_np(state.comm_error)
               .values() for v in lv.values())


# --------------------------------------------------------------------- #
# residual rows across strategy and topology changes

def _stacked(params, rows, value):
    return {l: {p: torch.full((rows,) + tuple(v.shape), float(value))
                for p, v in lv.items()} for l, lv in params.items()}


@pytest.mark.parametrize("rows,groups,keeps", [(2, 2, True), (4, 2, False),
                                               (1, 1, True), (1, 2, False)])
def test_reconcile_comm_error_is_jax_coerce_state(rows, groups, keeps):
    """A snapshot's rows resumed on ``groups`` residual groups: kept when
    the stacked shape matches (a flat world-2 snapshot on 2 slices), else
    zero; layers no longer TOPK dropped, layers newly TOPK at zero."""
    net = _port_lenet()
    params = net.init(torch.Generator().manual_seed(0))
    old = _stacked({"ip1": params["ip1"], "conv1": params["conv1"]}, rows,
                   0.5)
    comm = S.CommConfig(layer_strategies={"ip1": "topk", "ip2": "topk"})
    got = T.reconcile_comm_error(params, old, comm, groups)
    jparams = _tree_np(params)
    jstate = JT.TrainState(
        solver=JT.init_state(jparams),
        comm_error=jax.tree_util.tree_map(jnp.asarray, _tree_np(old)))
    jcomm = JS.CommConfig(layer_strategies={"ip1": "topk", "ip2": "topk"})
    _, want = JCK.coerce_state(jparams, jstate, staleness=0, n_dev=groups,
                               comm=jcomm)
    want = jax.tree_util.tree_map(np.asarray, want.comm_error)
    assert sorted(got) == sorted(want) == ["ip1", "ip2"]
    for l in want:
        for p in want[l]:
            assert np.array_equal(got[l][p].numpy(), want[l][p]), (l, p)
    assert bool((got["ip1"]["w"] == 0.5).all()) == keeps
    assert not got["ip2"]["w"].any()


@pytest.mark.parametrize("rows,slices,rank,want_row", [
    (2, 2, 3, 1), (2, 2, 0, 0), (4, 2, 1, None), (4, 1, 2, 2)])
def test_load_takes_this_ranks_row(rows, slices, rank, want_row):
    """``TrainStep.load`` on a world of 4 (``slices`` > 1: two tiers) keeps
    this rank's row of the stacked residuals, or zero when they do not
    fit."""
    net = _port_lenet()
    params = net.init(torch.Generator().manual_seed(0))
    comm = S.CommConfig(layer_strategies={"ip2": "topk"},
                        dcn_axis="dcn" if slices > 1 else None)
    group = DataGroup(rank=rank, world=4, device=torch.device("cpu"),
                      slices=slices)       # no process group: no traffic
    step = T.build_train_step(net, SolverParameter(**SOLVER), group, comm)
    err = {"ip2": {p: torch.arange(rows, dtype=torch.float32).view(
        (rows,) + (1,) * v.dim()).expand((rows,) + tuple(v.shape)).clone()
        for p, v in params["ip2"].items()}}
    _, state = step.load(params, T.TrainState(
        solver=T.init_state(params), comm_error=err))
    for p, v in state.comm_error["ip2"].items():
        assert v.shape == (1,) + tuple(params["ip2"][p].shape)
        want = 0.0 if want_row is None else float(want_row)
        assert bool((v == want).all()), (p, v.unique())


# --------------------------------------------------------------------- #
# snapshots with residuals, both ways

def test_topk_snapshots_cross_load_with_jax(tmp_path):
    """JAX's 2-device TOPK state, snapshotted by JAX, restores in the
    port (each rank's row); the port's snapshot of it restores in JAX
    with the same arrays."""
    params, batches = _inputs(seed=31, rows=2 * B)
    jcomm = JS.CommConfig(default_strategy="topk", topk_fraction=0.2)
    jnet = _jax_lenet()
    ts = JT.build_train_step(jnet, JaxSolver(**SOLVER), make_mesh(2), jcomm,
                             donate=False)
    jparams, jstate = params, JT.init_train_state(params, jcomm, 2)
    jparams, jstate, _ = ts.step(jparams, jstate, batches[0],
                                 jax.random.PRNGKey(0))
    _, jpath = JCK.snapshot(str(tmp_path / "jax"), jnet, jparams, jstate)
    want = jax.tree_util.tree_map(np.asarray, jstate.comm_error)
    assert want["ip1"]["w"].shape == (2, 500, 800)

    net = _port_lenet()
    comm = S.CommConfig(default_strategy="topk", topk_fraction=0.2)
    p, st = CK.restore(jpath)
    for rank in (0, 1):
        group = DataGroup(rank=rank, world=2, device=torch.device("cpu"))
        step = T.build_train_step(net, SolverParameter(**SOLVER), group,
                                  comm)
        _, loaded = step.load(p, st)
        for l, lv in want.items():
            for k, v in lv.items():
                assert np.array_equal(loaded.comm_error[l][k][0].numpy(),
                                      v[rank]), (rank, l, k)
    _, ppath = CK.snapshot(str(tmp_path / "port"), net, p, st)
    _, back = JCK.restore(ppath)
    got = jax.tree_util.tree_map(np.asarray, back.comm_error)
    assert sorted(got) == sorted(want)
    for l, lv in want.items():
        for k, v in lv.items():
            assert np.array_equal(got[l][k], v), (l, k)


# --------------------------------------------------------------------- #
# the four-process two-tier job

@pytest.fixture(scope="module")
def tier_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tier")
    inputs = {}
    # one set of inputs: the cases differ in their comm path alone
    params, batches = _inputs(seed=41, rows=WORLD4 * B)
    for case in TIER_CASES:
        inputs[case] = (params, batches)
        arrays = {f"params/{l}/{p}": v for l, lv in params.items()
                  for p, v in lv.items()}
        for k, b in enumerate(batches):
            arrays.update({f"batch{k}/{t}": v for t, v in b.items()})
        np.savez(d / f"{case}.in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD4),
         str(d / "store"), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD4)]
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
    assert "two tiers, 2 slice(s) of 2 rank(s)" in logs[0]
    results = {}
    for case in TIER_CASES:
        results[case] = []
        for r in range(WORLD4):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return inputs, results


def test_max_pool_near_tie_flips_between_xla_and_torch():
    """The trap the parity tests' inputs meet now and then (pinned here,
    not dodged): XLA and torch sum a conv in other orders, so two entries
    of a MAX window ~1e-7 apart can rank the other way round. At seed 42
    and 16 rows, LeNet's one-device step has exactly one pool2 window
    whose argmax differs, a near tie in both packages, and the only
    parameters that then leave PARAM_TOL after one step are conv2
    weights of that window's channel. The two-tier job's cases share one
    set of inputs (seed 41) and compare their comm paths."""
    params, batches = _inputs(seed=42, rows=16)
    ref = _jax_run(JS.CommConfig(),
                   Mesh(np.array(jax.devices()[:1]), ("data",)),
                   params, batches[:1])
    net = _port_lenet(16)
    p = params_from_jax(net, params)
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    out = net.apply(p, batch, train=True, keep_blobs=True)
    jout = _jax_lenet(16).apply(params, batches[0], train=True,
                                keep_blobs=True)
    got, want = out.blobs["conv2"].detach().numpy(), np.asarray(
        jout.blobs["conv2"])
    n, c, h, w = got.shape
    win = lambda x: x.reshape(n, c, h // 2, 2, w // 2, 2).transpose(  # noqa
        0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)
    gw, ww = win(got), win(want)
    flips = np.argwhere(gw.argmax(-1) != ww.argmax(-1))
    assert len(flips) == 1
    for x in (gw, ww):
        top2 = np.sort(x[tuple(flips[0])])[-2:]
        assert top2[1] - top2[0] <= 1e-6 * abs(top2[1])
    step = T.build_train_step(net, SolverParameter(**SOLVER), None,
                              S.CommConfig())
    p, state = step.load(p, T.init_train_state(p))
    p, state, _ = step.step(p, state, batch)
    outside = {}
    for l, lv in ref[1][0].items():
        for q, v in lv.items():
            bad = ~np.isclose(p[l][q].numpy(), v, **PARAM_TOL)
            if bad.any():
                outside[f"{l}/{q}"] = np.argwhere(bad)
    assert list(outside) == ["conv2/w"]
    assert set(outside["conv2/w"][:, 0]) == {flips[0][1]}


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_two_tier_step_matches_jax_2x2_mesh(tier_run, case):
    inputs, results = tier_run
    mesh = make_mesh(WORLD4, axes=("dcn", "data"), shape=(SLICES, 2))
    ref = _jax_run(JS.CommConfig(dcn_axis="dcn", **TIER_CASES[case]), mesh,
                   *inputs[case])
    for r, res in enumerate(results[case]):
        np.testing.assert_allclose(res["losses"][0], ref[1][2],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["losses"][-1], ref[STEPS][2],
                                   rtol=LOSS_RTOL)
        for step in (1, STEPS):
            jp, jh, _, jerr = ref[step]
            for kind, tree in (("params", jp), ("history", jh)):
                for l, lv in tree.items():
                    for p, v in lv.items():
                        np.testing.assert_allclose(
                            res[f"step{step}/{kind}/{l}/{p}"], v,
                            **PARAM_TOL, err_msg=f"{case} rank {r}: {kind} "
                            f"{l}/{p} after step {step}")
            # one residual a slice: rank r holds JAX's row r // 2
            assert set(k for k in res if k.startswith(f"err{step}/")) == {
                f"err{step}/{l}/{p}" for l, lv in jerr.items() for p in lv}
            for l, lv in jerr.items():
                for p, v in lv.items():
                    assert v.shape[0] == SLICES
                    np.testing.assert_allclose(
                        res[f"err{step}/{l}/{p}"], v[r // 2], **PARAM_TOL,
                        err_msg=f"{case} rank {r}: residual {l}/{p} after "
                        f"step {step}")
    assert results[case][0]["losses"][-1] != results[case][0]["losses"][0]
    want_groups = SLICES
    assert [int(res["n_err_groups"]) for res in results[case]] == \
        [want_groups] * WORLD4
    assert [int(res["err_row"]) for res in results[case]] == [0, 0, 1, 1]


@pytest.mark.parametrize("case", list(TIER_CASES))
def test_two_tier_ranks_end_bitwise_equal(tier_run, case):
    ranks = tier_run[1][case]
    keys = [k for k in ranks[0] if k.startswith("step")]
    for res in ranks[1:]:
        assert all(np.array_equal(ranks[0][k], res[k]) for k in keys)
        assert list(res["losses"]) == list(ranks[0]["losses"])
    errs = [k for k in ranks[0] if k.startswith(("err1/", f"err{STEPS}/"))]
    assert bool(errs) == (case == "two_tier_topk")
    for a, b in ((0, 1), (2, 3)):       # each slice's ranks share a row
        assert all(np.array_equal(ranks[a][k], ranks[b][k]) for k in errs)
    if errs:                            # the slices' rows differ
        assert not all(np.array_equal(ranks[0][k], ranks[2][k])
                       for k in errs)
        # every rank gathers the same two rows, slice order
        for res in ranks:
            for k in [k for k in res if k.startswith("gathered/")]:
                rest = k[len("gathered/"):]
                assert res[k].shape[0] == SLICES
                assert np.array_equal(res[k][0], ranks[0][f"err{STEPS}/"
                                                           f"{rest}"])
                assert np.array_equal(res[k][1], ranks[2][f"err{STEPS}/"
                                                           f"{rest}"])


# --------------------------------------------------------------------- #
# the CLI

def _args(*flags):
    from poseidon_tpu_torch.runtime.cli import build_parser
    return build_parser().parse_args(["train", "--solver=x", *flags])


@pytest.mark.parametrize("flags,want", [
    ((), {}),
    (("--strategy", "topk"), {"default_strategy": "topk"}),
    (("--strategy", "topk", "--topk_policy", "random", "--topk_block",
      "4096"), {"default_strategy": "topk", "topk_policy": "random",
                "topk_block": 4096}),
    (("--strategy", "topk", "--topk_policy", "fixed_order",
      "--dcn_slices", "2", "--wire_dtype", "bf16", "--grad-reduce", "sum"),
     {"default_strategy": "topk", "topk_policy": "fixed_order",
      "dcn_axis": "dcn", "wire_dtype": "bf16", "reduce": "sum"}),
    (("--dcn_slices", "1",), {}),
])
def test_cli_topk_and_two_tier_flags_build_the_jax_config(flags, want):
    """The fields JAX's ``_engine_from_args`` sets from the same flags
    (its CommConfig defaults for the rest: fraction 0.01, no budget)."""
    from poseidon_tpu_torch.runtime.cli import comm_from_args
    got = comm_from_args(_args(*flags))
    jax_cfg = JS.CommConfig(**want)
    for f in ("default_strategy", "topk_fraction", "topk_policy",
              "bandwidth_budget_mb", "topk_block", "dcn_axis", "wire_dtype",
              "reduce", "layer_strategies"):
        assert getattr(got, f) == getattr(jax_cfg, f), f
    assert _args().topk_policy == "magnitude"


def test_cli_dcn_slices_must_divide_the_world_and_mesh_refuses():
    from poseidon_tpu_torch.runtime.cli import comm_from_args
    with pytest.raises(SystemExit, match="--dcn_slices 2 does not divide 3 "
                                         "devices"):
        cluster.init_distributed(torch.device("cpu"), rank=0, world=3,
                                 coordinator="file:///nonexistent/store",
                                 slices=2)
    with pytest.raises(SystemExit, match="do not compose"):
        comm_from_args(_args("--mesh", "dp2,fsdp2,tp1", "--dcn_slices",
                             "2"))
    # the mesh alone is ported: its arena rides --arena_bucket_mb
    comm = comm_from_args(_args("--mesh", "dp2,fsdp2,tp1",
                                "--arena_bucket_mb", "2"))
    assert comm.bucket_mb == 2.0 and comm.param_arena
    assert comm.dcn_axis is None


@pytest.mark.parametrize("slices", [0, 2])
def test_cli_two_rank_topk_training_on_cpu(tmp_path, slices):
    """Two ``train --strategy topk`` ranks (flat with the synchronous
    snapshot writer, or 2 slices of one rank with ``--async_snapshot``)
    under the env contract: both exit 0 and write bitwise-equal snapshots
    with both residual rows, which differ; JAX restores them."""
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, LENET)}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 2\n'
        'max_iter: 4\nsnapshot: 2\nsnapshot_prefix: "lenet"\n')
    procs = []
    for r in range(2):
        env = dict(os.environ, POSEIDON_PROC_ID=str(r),
                   POSEIDON_NUM_PROCS="2",
                   POSEIDON_COORDINATOR=f"file://{tmp_path / 'store'}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "poseidon_tpu_torch", "train",
             f"--solver={solver}", "--output_dir", str(tmp_path / f"p{r}"),
             "--device", "cpu", "--strategy", "topk", "--dcn_slices",
             str(slices), *(["--async_snapshot"] if slices else [])],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
    assert "Iteration 4" in logs[0] and "TOPK on" in logs[0]
    assert "comm: ip1 topk" in logs[0] and "comm: {" in logs[0]
    assert ("two tiers" in logs[0]) == (slices == 2)
    for it in (2, 4):
        a, b = (tmp_path / f"p{r}" / f"lenet_iter_{it}.solverstate.npz"
                for r in range(2))
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert np.array_equal(za[k], zb[k]), k
            errs = [k for k in za.files if k.startswith("comm_error/")]
            assert len(errs) == 8
            for k in errs:
                assert za[k].shape[0] == 2
                assert not np.array_equal(za[k][0], za[k][1]), k
        _, jstate = JCK.restore(str(a))
        with np.load(a) as za:
            for l, lv in jstate.comm_error.items():
                for p, v in lv.items():
                    assert np.array_equal(
                        np.asarray(v), za[f"comm_error/{l}\x1f{p}"])

