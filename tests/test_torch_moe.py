"""The port's mixture of experts (``models/moe.py``: ``moe_ffn``,
``moe_forward``, ``ep_shard`` and ``build_dp_ep_train_step``; MoE decode
in ``models/generate.py``; MoE snapshots in ``runtime/lm_checkpoint.py``;
``models/train_lm.py --mode ep``) on the CPU against the JAX package's.

The config is ``tests/test_moe.py``'s ``BASE`` with 8 experts: vocab 32,
d_model 32, 2 heads, 2 layers, d_ff 64, max_seq 32; a global batch of 8 x
16 from ``pattern_batch`` a step; SGD with momentum 0.9.

One module-scoped fixture runs ONE job: four gloo processes (this file
run as a script, once a rank, a ``file://`` store under tmp,
``OMP_NUM_THREADS=1``) and beside them one pair of ``python -m
poseidon_tpu_torch.models.train_lm --mode ep --par_axis 2`` ranks, while
the fixture computes the references. Each case builds its named groups
over its ranks, starts from JAX's ``init_moe_params``
(``params_from_jax``; each rank takes its ``ep_shard``) and trains on its
row block ``data * E + expert`` of the global batches:

- ``dp2_ep2``: data 2 x expert 2, the default capacity factor 1.25 (5
  slots an expert for a rank's 32 tokens: tokens drop) and aux_weight
  0.01, 2 steps, against JAX's ``build_dp_ep_train_step`` on the same
  mesh of the virtual devices and against a one-device control that
  routes each rank's row block as its own source (``_per_source_steps``:
  the blocks' losses summed at the global normalizer, drops included);
- ``dp1_ep4_dropless``: data 1 x expert 4, capacity 64 (nothing drops)
  and no aux loss, 1 step without momentum, against the all-experts-local
  reference of ``tests/test_moe.py`` (``moe_forward`` over the whole batch
  with capacity B x S, ``lm_loss`` + aux) computed by JAX and by the port;
- ``dp2_ep2_bf16``: ``dp2_ep2`` for 1 step under a bfloat16 compute
  dtype against JAX's bf16 step at ``tests/test_torch_bf16.py``'s LM
  tolerance (loss 1e-3, every leaf within 0.05 of JAX's largest update
  of it).

Held after each step, on every rank: the loss within 1e-5 relative, every
param and momentum leaf (the ranks' experts all-gathered) at PARAM_TOL
(rtol 1e-4, atol 1e-6), unless named above.

Also: the ranks alike bitwise; each rank's dropped tokens a layer
(counted from the routing by ``_layer_drops``) above zero and equal to
the control's; the ep snapshot
(``save_lm(..., ep_group=...)`` on every rank, the same bytes) equal to
the gathered trees and to JAX's ``restore_lm`` of it, and JAX's MoE
snapshot in the port's; ``moe_ffn`` alone (drops, queue positions, the
gate-weighted outputs, aux, and every gradient) and ``moe_forward`` with
remat on against JAX's; ``ep_shard`` against ``ep_param_specs``; MoE
cached decode against JAX's ``generate`` (a prefill of two 256-token
chunks and a decode); the refusals; the CLI pair.
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

from poseidon_tpu_torch.models import moe as port_moe  # noqa: E402
from poseidon_tpu_torch.models import transformer as port_tf  # noqa: E402
from poseidon_tpu_torch.numeric import policy_scope  # noqa: E402
from poseidon_tpu_torch.proto.messages import SolverParameter  # noqa: E402
from poseidon_tpu_torch.runtime import cluster  # noqa: E402
from poseidon_tpu_torch.runtime import lm_checkpoint as port_ckpt  # noqa: E402,E501
from poseidon_tpu_torch.solvers.updates import (init_state,  # noqa: E402
                                                 make_update_fn)

WORLD = 4
B, S = 8, 16
BASE = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=32)
N_EXPERTS = 8
SOLVER = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# tests/test_torch_bf16.py's LM tolerance
BF16_LOSS_RTOL, BF16_UPDATE_SHARE = 1e-3, 0.05
WORKER_TIMEOUT_S = 150

# name -> (shape (data, expert), MoEConfig fields, steps, solver, bf16)
CASES = {
    "dp2_ep2": ((2, 2), dict(aux_weight=0.01), 2, SOLVER, False),
    "dp1_ep4_dropless": ((1, 4), dict(capacity=64, aux_weight=0.0), 1,
                         dict(base_lr=0.05, lr_policy="fixed"), False),
    "dp2_ep2_bf16": ((2, 2), dict(aux_weight=0.01), 1, SOLVER, True),
}
SNAP_CASE = "dp2_ep2"
CLI_ARGS = ("--device", "cpu", "--steps", "4", "--display", "2", "--seq",
            "64", "--d_model", "64", "--experts", "4")


def _flat(tree):
    return {f"{n}/{l}": (v.detach().float().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v))
            for n, d in tree.items() for l, v in d.items()}


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        n, l = key.split("/")
        tree.setdefault(n, {})[l] = v
    return tree


def _port_cfg(**kw):
    return port_moe.MoEConfig(base=port_tf.TransformerConfig(**BASE),
                              n_experts=N_EXPERTS, **kw)


def _rows(block, n_blocks):
    b_local = B // n_blocks
    return slice(block * b_local, (block + 1) * b_local)


def _layer_drops(params, cfg, tokens, expert_group=None):
    """Each MoE layer's dropped tokens in one forward of ``tokens`` (over
    ``expert_group`` when given), counted from the routing itself: the
    layer input's top-1 expert (the first of ties), then each expert's
    tokens past the capacity."""
    b_sz, s = tokens.shape
    bcfg = cfg.base
    cap = port_moe.resolved_capacity(cfg, b_sz * s)
    drops = []
    with torch.no_grad():
        x = port_tf.embed_tokens(params, tokens)
        for i in range(bcfg.n_layers):
            blk = params[f"block{i}"]
            x = port_tf.attention_sublayer(bcfg, x, blk)
            h = port_tf._layer_norm(x, blk["ln2_g"], blk["ln2_b"]).reshape(
                b_sz * s, bcfg.d_model)
            top = torch.softmax((h @ blk["wg"].T).float(), -1).argmax(-1)
            load = torch.bincount(top, minlength=cfg.n_experts)
            drops.append(int((load - cap).clamp(min=0).sum()))
            y, _ = port_moe.moe_ffn(h, blk["wg"], blk["w1e"], blk["w2e"],
                                    cfg, expert_group=expert_group)
            x = x + y.reshape(x.shape).to(x.dtype)
    return drops


def _run_case(rank, case, d):
    shape, fields, steps, solver, bf16 = CASES[case]
    n = int(np.prod(shape))
    groups = cluster.build_named_groups(("data", "expert"), shape, rank,
                                        torch.device("cpu"), "gloo",
                                        ranks=range(n))
    if groups is None:
        return
    cfg = _port_cfg(**fields)
    with np.load(os.path.join(d, "in.npz")) as z:
        params = port_tf.params_from_jax(
            _unflat({k[len("params/"):]: z[k] for k in z.files
                     if k.startswith("params/")}))
        batches = [(z[f"tokens{k}"], z[f"targets{k}"]) for k in range(steps)]
    expert = groups["expert"]
    params = port_moe.ep_shard(params, cfg, expert.rank, expert.world)
    rows = _rows(groups.batch_index, n)
    out = {}
    with policy_scope(**({"compute_dtype": torch.bfloat16} if bf16
                         else {})):
        step = port_moe.build_dp_ep_train_step(
            cfg, SolverParameter(**solver), groups)
        state = init_state(params)
        for k, (toks, tgts) in enumerate(batches):
            if k == 0:
                # the first step's routing: each layer's dropped tokens
                out["drops"] = np.array(_layer_drops(
                    params, cfg, torch.from_numpy(toks[rows]).long(),
                    expert))
            params, state, m = step(params, state,
                                    torch.from_numpy(toks[rows]).long(),
                                    torch.from_numpy(tgts[rows]).long())
            out[f"loss{k}"] = float(m["loss"])
            for tag, tree in (("params", params), ("history",
                                                   state.history)):
                out.update({f"step{k}/{tag}/{key}": v for key, v in
                            _flat(port_moe.ep_unshard(tree, expert))
                            .items()})
    if case == SNAP_CASE:
        port_ckpt.save_lm(os.path.join(d, "snap", f"rank{rank}", "lm"),
                          params, state, cfg, ep_group=expert)
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

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from poseidon_tpu import config as jconfig  # noqa: E402
from poseidon_tpu.models import generate as jax_gen  # noqa: E402
from poseidon_tpu.models import moe as jax_moe  # noqa: E402
from poseidon_tpu.models import transformer as jax_tf  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402
from poseidon_tpu.proto.messages import SolverParameter as JaxSP  # noqa: E402,E501
from poseidon_tpu.runtime import lm_checkpoint as jax_ckpt  # noqa: E402
from poseidon_tpu.solvers import updates as jax_upd  # noqa: E402

from conftest import pattern_batch  # noqa: E402
from poseidon_tpu_torch.models import generate as port_gen  # noqa: E402


def _jax_cfg(**kw):
    return jax_moe.MoEConfig(base=jax_tf.TransformerConfig(**BASE),
                             n_experts=N_EXPERTS, **kw)


def _inputs():
    params = jax.tree_util.tree_map(
        np.asarray, jax_moe.init_moe_params(_jax_cfg(),
                                            jax.random.PRNGKey(1)))
    batches = [tuple(np.asarray(a).astype(np.int32) for a in pattern_batch(
        np.random.RandomState(k + 2), B, S, BASE["vocab_size"]))
        for k in range(2)]
    return params, batches


def _jax_ep(case, params, batches):
    """JAX's {step: (loss, params, history)} on the case's (data, expert)
    mesh of the virtual devices."""
    shape, fields, steps, solver, bf16 = CASES[case]
    mesh = make_mesh(axes=("data", "expert"), shape=shape,
                     devices=jax.devices()[:int(np.prod(shape))])
    cfg = _jax_cfg(**fields)
    out = {}
    with jconfig.policy_scope(**({"compute_dtype": jnp.bfloat16} if bf16
                                 else {})):
        step = jax_moe.build_dp_ep_train_step(cfg, JaxSP(**solver), mesh,
                                              params, donate=False)
        p, st = params, jax_upd.init_state(params)
        for k in range(steps):
            toks, tgts = batches[k]
            p, st, m = step(p, st, jnp.asarray(toks), jnp.asarray(tgts),
                            jax.random.PRNGKey(k))
            out[k] = (float(m["loss"]), _flat(p), _flat(st.history))
    return out


def _jax_dropless_reference(params, batches):
    """``tests/test_moe.py``'s all-experts-local reference: the whole
    batch through ``moe_forward`` with capacity B x S, one update."""
    _, fields, _, solver, _ = CASES["dp1_ep4_dropless"]
    cfg_ref = _jax_cfg(**dict(fields, capacity=B * S))
    toks, tgts = (jnp.asarray(a) for a in batches[0])

    def loss_fn(p):
        logits, aux = jax_moe.moe_forward(p, cfg_ref, toks)
        return jax_tf.lm_loss(logits, tgts) + aux

    loss, grads = jax.value_and_grad(loss_fn)(params)
    upd = jax_upd.make_update_fn(JaxSP(**solver),
                                 jax_tf.transformer_mults(params))
    p, st = upd(params, grads, jax_upd.init_state(params))
    return {0: (float(loss), _flat(p), _flat(st.history))}


def _port_dropless_reference(params, batches):
    """The same reference through the port's ``moe_forward``."""
    _, fields, _, solver, _ = CASES["dp1_ep4_dropless"]
    cfg_ref = _port_cfg(**dict(fields, capacity=B * S))
    toks, tgts = (torch.from_numpy(a).long() for a in batches[0])
    p = port_tf.params_from_jax(params)

    def loss_fn(q):
        logits, aux = port_moe.moe_forward(q, cfg_ref, toks)
        return port_tf.lm_loss(logits, tgts) + aux

    loss, grads = port_tf._grads(p, loss_fn)
    upd = make_update_fn(SolverParameter(**solver),
                                  port_tf.transformer_mults(p))
    p, st = upd(p, grads, init_state(p))
    return {0: (float(loss), _flat(p), _flat(st.history))}


def _per_source_steps(params, batches, case):
    """The one-device control of an ep step: every rank's row block routed
    as its own source (all experts local, the block's capacity), its
    token-loss sum over the GLOBAL token count plus aux / n_dev, the
    blocks' losses and gradients summed: the function the ep step
    computes, drops included. Returns ({step: (loss, params, history)},
    {block: dropped tokens a layer at the first step})."""
    shape, fields, steps, solver, _ = CASES[case]
    n = int(np.prod(shape))
    cfg = _port_cfg(**fields)
    p = port_tf.params_from_jax(params)
    st = init_state(p)
    update = make_update_fn(SolverParameter(**solver),
                                     port_tf.transformer_mults(p))
    out, drops = {}, {}
    for k in range(steps):
        toks, tgts = (torch.from_numpy(a).long() for a in batches[k])
        inv_total = 1.0 / float(B * S)

        def loss_fn(q):
            total = 0.0
            for blk in range(n):
                rows = _rows(blk, n)
                logits, aux = port_moe.moe_forward(q, cfg, toks[rows])
                logp = torch.log_softmax(logits, dim=-1)
                picked = torch.gather(logp, -1, tgts[rows][..., None])
                total = total - picked.sum() * inv_total + aux / float(n)
            return total

        if k == 0:
            for blk in range(n):
                drops[blk] = _layer_drops(p, cfg, toks[_rows(blk, n)])
        loss, grads = port_tf._grads(p, loss_fn)
        p, st = update(p, grads, st)
        out[k] = (float(loss), _flat(p), _flat(st.history))
    return out, drops


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_ep")
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
         "--mode", "ep", "--par_axis", "2", *CLI_ARGS], cwd=REPO,
        env=dict(os.environ, POSEIDON_PROC_ID=str(r),
                 POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="1",
                 POSEIDON_COORDINATOR=f"file://{d / 'cli.store'}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        # the references while the ranks run
        refs = {case: _jax_ep(case, params, batches) for case in CASES}
        control, control_drops = _per_source_steps(params, batches,
                                                    "dp2_ep2")
        dropless = {"jax": _jax_dropless_reference(params, batches),
                    "port": _port_dropless_reference(params, batches)}
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
    for case, (shape, *_rest) in CASES.items():
        results[case] = []
        for r in range(int(np.prod(shape))):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return {"results": results, "refs": refs, "control": control,
            "control_drops": control_drops, "dropless": dropless,
            "cli": logs[WORLD:], "dir": d, "params": params,
            "batches": batches}


def _hold(res, want, r, tol=PARAM_TOL):
    for k, (loss, params, history) in want.items():
        assert float(res[f"loss{k}"]) == pytest.approx(
            loss, rel=LOSS_RTOL), (r, k)
        for tag, tree in (("params", params), ("history", history)):
            for key, v in tree.items():
                np.testing.assert_allclose(
                    res[f"step{k}/{tag}/{key}"], v, **tol,
                    err_msg=f"rank {r} step {k + 1} {tag} {key}")


def test_ep_step_matches_jax_with_drops(ep_run):
    for r, res in enumerate(ep_run["results"]["dp2_ep2"]):
        _hold(res, ep_run["refs"]["dp2_ep2"], r)


def test_ep_step_matches_the_per_source_control(ep_run):
    """The control routes each rank's rows as its own source on one
    device: the ep step's function, drops included, to PARAM_TOL; every
    rank drops tokens (the default capacity factor) and drops as many a
    layer as the control's block of its rows."""
    for r, res in enumerate(ep_run["results"]["dp2_ep2"]):
        _hold(res, ep_run["control"], r)
        assert list(res["drops"]) == ep_run["control_drops"][r], r
    assert sum(sum(v) for v in ep_run["control_drops"].values()) > 0


def test_ep_dropless_matches_the_all_local_reference(ep_run):
    """Nothing drops: expert parallelism is a relayout of the same
    token -> expert assignment, equal to ``moe_forward`` over the whole
    batch with all experts local (JAX's and the port's)."""
    for r, res in enumerate(ep_run["results"]["dp1_ep4_dropless"]):
        assert list(res["drops"]) == [0] * BASE["n_layers"]
        _hold(res, ep_run["dropless"]["jax"], r)
        _hold(res, ep_run["dropless"]["port"], r)
        _hold(res, ep_run["refs"]["dp1_ep4_dropless"], r)


def test_ep_bf16_step_matches_jax(ep_run):
    """One bf16 step against JAX's bf16 step at the LM bf16 tolerance."""
    params = ep_run["params"]
    init = _flat(params)
    loss, jp, _ = ep_run["refs"]["dp2_ep2_bf16"][0]
    for r, res in enumerate(ep_run["results"]["dp2_ep2_bf16"]):
        assert float(res["loss0"]) == pytest.approx(loss, rel=BF16_LOSS_RTOL)
        for key, want in jp.items():
            upd = np.abs(want.astype(np.float64) - init[key]).max()
            diff = np.abs(res[f"step0/params/{key}"].astype(np.float64)
                          - want).max()
            assert diff <= BF16_UPDATE_SHARE * upd + 1e-7, (
                f"rank {r} {key}: {diff} apart, the largest update {upd}")


@pytest.mark.parametrize("case", list(CASES))
def test_ep_ranks_agree_bitwise(ep_run, case):
    """Every rank ends with the same gathered trees and loss, bit for bit
    (each replicated leaf's gradient is summed over the whole mesh; each
    expert leaf's over data, after its all-to-all sum)."""
    ranks = ep_run["results"][case]
    for res in ranks[1:]:
        for key, v in ranks[0].items():
            if key != "drops":
                np.testing.assert_array_equal(res[key], v, err_msg=key)


def test_ep_snapshot_round_trips(tmp_path, ep_run):
    """``save_lm(..., ep_group=...)`` on every rank of dp2 x ep2 writes the
    same bytes: the gathered params and momentum after 2 steps; the port's
    and JAX's ``restore_lm`` read them back exactly; JAX's MoE snapshot of
    the same trees is the same arrays, and loads in the port."""
    d = ep_run["dir"]
    paths = [port_ckpt.latest_lm_snapshot(str(d / "snap" / f"rank{r}" /
                                              "lm")) for r in range(WORLD)]
    assert all(p is not None and p.endswith("lm_iter_2.lmstate.npz")
               for p in paths)
    blobs = [open(p, "rb").read() for p in paths]
    assert all(b == blobs[0] for b in blobs[1:])
    res = ep_run["results"]["dp2_ep2"][0]
    p, st = port_ckpt.restore_lm(paths[0])
    assert st.it == 2
    for tag, tree in (("params", p), ("history", st.history)):
        for key, v in _flat(tree).items():
            assert np.array_equal(v, res[f"step1/{tag}/{key}"]), key
    jp, jst = jax_ckpt.restore_lm(paths[0], _jax_cfg())
    assert int(jst.it) == 2
    for key, v in _flat(jp).items():
        assert np.array_equal(_flat(p)[key], v), key
    jpath = jax_ckpt.save_lm(str(tmp_path / "lm"), jp, jst, _jax_cfg())
    with np.load(jpath) as a, np.load(paths[0]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    back, _ = port_ckpt.restore_lm(jpath)
    for key, v in _flat(p).items():
        assert np.array_equal(_flat(back)[key], v), key


def test_ep_shard_matches_jax_specs(ep_run):
    params = ep_run["params"]
    specs = jax_moe.ep_param_specs(params)
    ptree = port_tf.params_from_jax(params)
    for n_e in (2, 4, 8):
        for e in range(n_e):
            shard = _flat(port_moe.ep_shard(ptree, _port_cfg(), e, n_e))
            for n, lv in params.items():
                for l, v in lv.items():
                    want = v
                    if tuple(specs[n][l]) == ("expert",):
                        size = v.shape[0] // n_e
                        want = v[e * size:(e + 1) * size]
                    assert np.array_equal(shard[f"{n}/{l}"], want), (n, l)


def test_ep_refusal_matches_jax():
    mesh = make_mesh(axes=("data", "expert"), shape=(1, 3),
                     devices=jax.devices()[:3])
    params = jax_moe.init_moe_params(_jax_cfg(), jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as want:
        jax_moe.build_dp_ep_train_step(_jax_cfg(), JaxSP(**SOLVER), mesh,
                                       params)
    with pytest.raises(ValueError) as got:
        port_moe.ep_shard(port_tf.params_from_jax(params), _port_cfg(), 0, 3)
    assert str(got.value) == str(want.value) and str(want.value)


def _ffn_inputs(seed, t=24, d=8, e=4, f=16):
    rs = np.random.RandomState(seed)
    return (rs.randn(t, d).astype(np.float32),
            rs.randn(e, d).astype(np.float32),
            rs.randn(e, f, d).astype(np.float32) / np.sqrt(d),
            rs.randn(e, d, f).astype(np.float32) / np.sqrt(f))


@pytest.mark.parametrize("capacity,skew", [(3, 0.0), (3, 4.0), (0, 0.0),
                                           (24, 4.0)])
def test_moe_ffn_matches_jax(capacity, skew):
    """``moe_ffn`` alone: the same routing (ties to the lowest expert),
    queue positions by running count, drops past capacity (a dropped
    token's output is exactly zero), the gate-weighted outputs, the aux
    loss, and the gradients of x, the router and both expert stacks
    (through the gate, the kept tokens, and the aux loss)."""
    x, wg, w1e, w2e = _ffn_inputs(3)
    wg[0] += skew          # crowd expert 0 past its capacity
    cfgj = jax_moe.MoEConfig(base=jax_tf.TransformerConfig(**BASE),
                             n_experts=4, capacity=capacity, aux_weight=0.1)
    cfgp = port_moe.MoEConfig(base=port_tf.TransformerConfig(**BASE),
                              n_experts=4, capacity=capacity, aux_weight=0.1)
    cot = np.random.RandomState(4).randn(*x.shape).astype(np.float32)

    def jf(*a):
        y, aux = jax_moe.moe_ffn(*a, cfgj)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                             has_aux=True)(x, wg, w1e, w2e)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, wg, w1e, w2e)]
    py, paux = port_moe.moe_ffn(*leaves, cfgp)
    pg = torch.autograd.grad((py * torch.from_numpy(cot)).sum() + paux,
                             leaves)
    np.testing.assert_allclose(py.detach().numpy(), jy, rtol=1e-5,
                               atol=1e-6)
    assert float(paux.detach()) == pytest.approx(float(jaux), rel=1e-6)
    for got, want in zip(pg, jg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the drops: each expert keeps its first `cap` tokens in order
    cap = jax_moe.resolved_capacity(cfgj, x.shape[0])
    e_star = np.argmax(x @ wg.T, axis=-1)
    seen = np.zeros(4, int)
    dropped = []
    for t, e in enumerate(e_star):
        dropped.append(seen[e] >= cap)
        seen[e] += 1
    assert np.all(np.asarray(jy)[dropped] == 0)
    assert np.all(py.detach().numpy()[dropped] == 0)
    # and only those: every kept token's output row is nonzero
    kept = ~np.asarray(dropped)
    assert np.all(py.detach().numpy()[kept].any(-1))
    if capacity == x.shape[0]:
        assert sum(dropped) == 0           # room for every token
    elif skew:
        assert sum(dropped) > 0


def test_moe_ffn_breaks_ties_to_the_lowest_expert():
    """A router of zeros ties every expert: all tokens go to expert 0 (as
    ``jnp.argmax``), so with capacity 2 all but two tokens drop, and the
    aux loss is exactly aux_weight (JAX's ``test_aux_loss_value``)."""
    x, _, w1e, w2e = _ffn_inputs(5, t=6)
    wg = np.zeros((4, x.shape[1]), np.float32)
    cfgp = port_moe.MoEConfig(base=port_tf.TransformerConfig(**BASE),
                              n_experts=4, capacity=2, aux_weight=0.01)
    cfgj = jax_moe.MoEConfig(base=jax_tf.TransformerConfig(**BASE),
                             n_experts=4, capacity=2, aux_weight=0.01)
    py, paux = port_moe.moe_ffn(*(torch.from_numpy(a) for a in
                                  (x, wg, w1e, w2e)), cfgp)
    jy, jaux = jax_moe.moe_ffn(x, wg, w1e, w2e, cfgj)
    # expert 0 keeps the first two tokens; the other four drop (zero rows)
    assert np.all(py.numpy()[2:] == 0) and np.all(py.numpy()[:2].any(-1))
    assert float(paux) == pytest.approx(0.01)
    np.testing.assert_allclose(py.numpy(), jy, rtol=1e-5, atol=1e-6)
    assert float(jaux) == pytest.approx(float(paux), rel=1e-7)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_forward_and_grads_match_jax(ep_run, remat):
    """``moe_forward`` (logits, aux) and the gradient of every leaf of
    ``lm_loss + aux`` against JAX's at the default capacity factor (tokens
    drop), with the block checkpoint on and off."""
    params = ep_run["params"]
    toks, tgts = ep_run["batches"][0]
    jcfg = _jax_cfg(aux_weight=0.01)
    jcfg = dataclasses.replace(jcfg, base=dataclasses.replace(
        jcfg.base, remat=remat))
    pcfg = _port_cfg(aux_weight=0.01)
    pcfg = dataclasses.replace(pcfg, base=dataclasses.replace(
        pcfg.base, remat=remat))

    def jloss(p):
        logits, aux = jax_moe.moe_forward(p, jcfg, jnp.asarray(toks))
        return jax_tf.lm_loss(logits, jnp.asarray(tgts)) + aux

    jl, jg = jax.value_and_grad(jloss)(params)
    ptoks, ptgts = (torch.from_numpy(a).long() for a in (toks, tgts))

    def ploss(q):
        logits, aux = port_moe.moe_forward(q, pcfg, ptoks)
        return port_tf.lm_loss(logits, ptgts) + aux

    pl, pg = port_tf._grads(port_tf.params_from_jax(params), ploss)
    assert float(pl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for key, v in _flat(jg).items():
        np.testing.assert_allclose(_flat(pg)[key], v, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_moe_decode_matches_jax_generate(ep_run):
    """MoE cached decode: a prompt of 2 x 150 tokens (a prefill routed in
    two chunks, 256 and 44 tokens, each dropless) and 6 greedy tokens:
    the same tokens as JAX's ``generate`` with the ``MoEConfig``, every
    step's logits at the LM tolerance (rtol 1e-4, atol 1e-5); and the
    port's tokens are ``moe_forward``'s argmax on the grown sequence."""
    base = dict(BASE, max_seq=160)
    jcfg = jax_moe.MoEConfig(base=jax_tf.TransformerConfig(**base),
                             n_experts=N_EXPERTS, aux_weight=0.0)
    pcfg = port_moe.MoEConfig(base=port_tf.TransformerConfig(**base),
                              n_experts=N_EXPERTS, aux_weight=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jax_moe.init_moe_params(jcfg, jax.random.PRNGKey(8)))
    prompt = np.random.RandomState(9).randint(
        0, base["vocab_size"], (2, 150)).astype(np.int32)
    jt, jlog = jax_gen.generate(params, jcfg, jnp.asarray(prompt), 6)
    pp = port_tf.params_from_jax(params)
    pt, plog = port_gen.generate(pp, pcfg, torch.from_numpy(prompt).long(),
                                 6)
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-5)
    seq = torch.from_numpy(prompt).long()
    full = dataclasses.replace(pcfg, capacity=int(seq.numel()) + 12)
    for t in range(6):
        logits, _ = port_moe.moe_forward(pp, full, seq)
        assert torch.equal(logits[:, -1].argmax(-1), pt[:, t]), t
        seq = torch.cat([seq, pt[:, t:t + 1]], dim=1)


def test_train_lm_ep_cli_two_ranks(ep_run):
    """``train_lm --mode ep --par_axis 2 --experts 4`` as two launched
    processes: rank 0 prints the mesh and the display lines with tok/s,
    rank 1 none of them; the loss falls."""
    rank0, rank1 = ep_run["cli"]
    assert "mesh: data=1 x expert=2 (2 devices)" in rank0, rank0
    steps = [line.split() for line in rank0.splitlines()
             if line.startswith("step ")]
    assert [s[1] for s in steps] == ["1", "2", "4"], rank0
    assert all("tok/s" in " ".join(s) for s in steps[1:])
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert rank0.rstrip().endswith("done")
    assert "step " not in rank1 and "mesh:" not in rank1, rank1


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", os.path.join(REPO, "examples", "lm", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--mode", "ep", "--par_axis", "4", "--experts", "6"],
    ["--mode", "ep", "--par_axis", "4", "--batch", "4"],
    ["--mode", "ep", "--par_axis", "2", "--batch", "12"],
])
def test_train_lm_ep_refusals_match_jax(monkeypatch, flags):
    """On 8 devices (JAX's virtual ones; the port's world from the launch
    env): the same ``SystemExit`` message."""
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
