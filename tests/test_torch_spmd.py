"""The port's SPMD mesh planner (``parallel/spmd.py``, ``train --mesh``)
against the JAX package's, on the CPU.

Planner pieces, equal to JAX's exactly: ``MeshConfig.parse`` (its errors
too), ``ShardingPlan.build`` (tp decisions, sharded blobs, arena layers,
every leaf's placement, the SFB/TOPK opt-outs) on LeNet and AlexNet, the
fsdp-aligned ``bucket_ranges``/``padded_total``/multiplier vectors for
align 1, 2 and 4, ``to_``/``from_shard_major``, ``fsdp_shard_ranges``,
and ``collective_schedule`` for the six spec and comm cases of
``tests/test_mesh_spmd.py::test_collective_census_matches_plan``.

One module-scoped fixture runs ONE four-process gloo job (this file run as
a script, once a rank, a ``file://`` store under tmp, a timeout a
process). Each case builds its mesh's groups (``cluster.
build_mesh_groups``) over ranks 0..n-1 of the job (all four ranks create
every group; two-rank cases run on ranks 0-1), the same weights (from
JAX, through ``params_from_jax``) and the same numpy global batches of
``GLOBAL_B`` rows (batch shard i takes rows [i*b, (i+1)*b), as JAX's
``P(("data", "fsdp"))`` shards them), three steps. Held:

- against JAX's ``build_spmd_train_step`` on the named mesh of the 8
  virtual devices, params and momentum after steps 1 and 3 at PARAM_TOL
  (rtol 1e-4, atol 1e-6: XLA's and torch's CPU convs and GEMMs sum in
  other orders), losses at rtol 1e-5, TOPK residual rows at PARAM_TOL:
  fsdp2, dp2,fsdp2, dp2,tp2, dp1,fsdp2,tp2, TOPK on a tp mesh (ip1 then
  COL with a gather), SFB on an fsdp mesh, the arena off; JAX's own
  bitwise claims (sharded == replicated, sharded_state == canonical) do
  not hold on this jax build (``tests/test_mesh_spmd.py`` fails them),
  so the port is held to JAX at PARAM_TOL only;
- the port's own bitwise claims, at two ranks an axis (every element's
  sum a + b in either order): the sharded arm against the replicated
  control arm, and ``sharded_state`` against the canonical layout, for
  fsdp2 and dp2,fsdp2;
- every rank's collective census (``spmd.CENSUS``) equal to the plan's
  ``collective_schedule`` (names, kinds, axes, sizes, counts);
- the SSP step on dp2,fsdp2 (staleness 1: the fsdp delta exchange) against
  JAX's ``build_ssp_train_step(plan=...)`` at PARAM_TOL;
- a narrow AlexNet with dropout on dp1,fsdp2,tp2 (port only: the two
  packages' random streams differ): the tp replicas draw the same masks,
  the batch shards other ones, and every rank ends bitwise equal;
- the ``record_function`` labels in a CPU ``torch.profiler`` trace;
- a dp2,fsdp2 snapshot restored into the port's one-device step and into
  JAX's flat replicated step.

In process: a size mismatch with no tp plan raises; SSP refuses tp and
adarevision on a mesh. The CLI: two ``train --mesh fsdp2`` ranks and two
``--mesh fsdp2,replicated`` ranks of the digits solver write bitwise
equal snapshots.
"""

import json
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # run as a script: the rank workers
    sys.path.insert(0, REPO)

from poseidon_tpu_torch.config import MeshConfig  # noqa: E402
from poseidon_tpu_torch.core.net import Net, params_from_jax  # noqa: E402
from poseidon_tpu_torch.parallel import spmd  # noqa: E402
from poseidon_tpu_torch.parallel import strategies as S  # noqa: E402
from poseidon_tpu_torch.parallel.mesh import DataGroup, rank_seed  # noqa: E402,E501
from poseidon_tpu_torch.parallel.trainer import (  # noqa: E402
    build_ssp_train_step, build_train_step, init_ssp_state,
    init_train_state)
from poseidon_tpu_torch.proto.messages import (  # noqa: E402
    SolverParameter, load_net_from_string)
from poseidon_tpu_torch.runtime import cluster  # noqa: E402

LENET = "examples/mnist/lenet_train_test.prototxt"
ALEXNET_TRAIN = "examples/imagenet/alexnet_train_val.prototxt"
DIGITS = "examples/digits/digits_train_test.prototxt"
GLOBAL_B = 8     # rows a step, over every batch shard
WORLD = 4
STEPS = 3
SSP_STEPS = 4    # staleness 1: boundaries after steps 2 and 4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)
BUCKET_MB = 0.3      # LeNet's 431,080 f32 in six buckets
WORKER_TIMEOUT_S = 150

# AlexNet-shaped and narrow, with AlexNet's fc6 -> relu6 -> drop6 -> fc7
# chain: the dropout breaks the Megatron pairing, so every FC layer plans
# COL with a gather
_P = "blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0"
NARROW_ALEXNET_DROP = """
name: "NarrowAlexNetDrop"
input: "data" input_dim: 4 input_dim: 3 input_dim: 35 input_dim: 35
input: "label" input_dim: 4 input_dim: 1 input_dim: 1 input_dim: 1
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1" %(p)s
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "norm1" type: LRN bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 } }
layers { name: "pool1" type: POOLING bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool1" top: "fc6" %(p)s
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "drop6" type: DROPOUT bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
layers { name: "fc7" type: INNER_PRODUCT bottom: "fc6" top: "fc7" %(p)s
  inner_product_param { num_output: 16
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu7" type: RELU bottom: "fc7" top: "fc7" }
layers { name: "drop7" type: DROPOUT bottom: "fc7" top: "fc7"
  dropout_param { dropout_ratio: 0.5 } }
layers { name: "fc8" type: INNER_PRODUCT bottom: "fc7" top: "fc8" %(p)s
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "loss" }
""" % {"p": _P}


class Case(NamedTuple):
    spec: str               # --mesh
    fields: dict = {}       # CommConfig fields both packages share
    net: str = "lenet"
    mode: str = "train"     # train | sharded_state | ssp | dropout
    ref: str = ""           # the case it is held BITWISE against (its inputs)


CASES = {
    "fsdp2": Case("fsdp2"),
    "fsdp2_replicated": Case("fsdp2,replicated", ref="fsdp2"),
    "fsdp2_sharded_state": Case("fsdp2", mode="sharded_state",
                                ref="fsdp2"),
    "dp2_fsdp2": Case("dp2,fsdp2"),
    "dp2_fsdp2_replicated": Case("dp2,fsdp2,replicated", ref="dp2_fsdp2"),
    "dp2_fsdp2_sharded_state": Case("dp2,fsdp2", mode="sharded_state",
                                    ref="dp2_fsdp2"),
    "dp2_tp2": Case("dp2,tp2"),
    "dp1_fsdp2_tp2": Case("dp1,fsdp2,tp2"),
    # ip2 compressed opts out of tp, so ip1 stays COL with its gather
    "dp2_tp2_topk": Case("dp2,tp2", dict(layer_strategies={"ip2": S.TOPK},
                                         topk_fraction=0.1)),
    "dp2_fsdp2_sfb": Case("dp2,fsdp2", dict(layer_strategies={"ip1": S.SFB})),
    "dp2_tp2_no_arena": Case("dp2,tp2", dict(param_arena=False)),
    "ssp_dp2_fsdp2": Case("dp2,fsdp2", mode="ssp"),
    "dropout_fsdp2_tp2": Case("dp1,fsdp2,tp2", net="narrow_alexnet_drop",
                              mode="dropout"),
}
JAX_CASES = [c for c, spec in CASES.items()
             if not spec.ref and spec.mode in ("train", "ssp")]
BITWISE_CASES = [c for c, spec in CASES.items() if spec.ref]


def _of(case):
    """The case whose inputs a case takes."""
    return CASES[case].ref or case


def _net_text(name):
    if name == "lenet":
        with open(os.path.join(REPO, LENET)) as f:
            return f.read()
    return NARROW_ALEXNET_DROP


def _shapes(name, rows):
    if name == "lenet":
        return {"data": (rows, 1, 28, 28), "label": (rows,)}
    return {"data": (rows, 3, 35, 35), "label": (rows, 1, 1, 1)}


def _rows(spec):
    cfg = MeshConfig.parse(spec)
    return GLOBAL_B // (cfg.data * cfg.fsdp)


def _port_net(name, rows):
    src = _shapes(name, rows) if name == "lenet" else None
    net = Net(load_net_from_string(_net_text(name)), "TRAIN", device="cpu",
              source_shapes=src)
    if src is None:
        # the narrow AlexNet's inputs are fixed at 4 rows
        assert net.blob_shapes["data"][0] == rows
    return net


# --------------------------------------------------------------------- #
# the rank workers (this file run as a script)

def _tree_np(tree):
    return {f"{l}/{p}": v.detach().clone().numpy() for l, lv in tree.items()
            for p, v in lv.items()}


def _run_case(world, case, d):
    """One case on this rank (every rank calls it: the groups are made
    collectively; ranks past the mesh's size return)."""
    import torch.distributed as dist
    spec = CASES[case]
    cfg = MeshConfig.parse(spec.spec)
    n = cfg.n_devices
    rank = world.rank
    case_pg = dist.new_group(list(range(n))) if n < world.world else world.pg
    mesh = cluster.build_mesh_groups(cfg, rank, world.device, world.backend)
    if mesh is None:
        return
    group = DataGroup(rank=rank, world=n, device=world.device,
                      backend=world.backend, pg=case_pg, mesh=mesh)
    rows = _rows(spec.spec)
    net = _port_net(spec.net, rows)
    with np.load(os.path.join(d, f"{_of(case)}.in.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key, v in flat.items():
        if key.startswith("params/"):
            layer, p = key[len("params/"):].split("/")
            params.setdefault(layer, {})[p] = v
    params = params_from_jax(net, params)
    comm = S.CommConfig(bucket_mb=BUCKET_MB, **spec.fields)
    plan = spmd.ShardingPlan.build(net, cfg, comm, shard_params=cfg.shard,
                                   enable_tp=cfg.shard)
    sp = SolverParameter(**SOLVER)
    bi = mesh.batch_index
    out = {"losses": [], "describe": plan.describe(),
           "coords": list(mesh.coords)}

    def batch_of(k):
        return {key[len(f"batch{k}/"):]: torch.from_numpy(
            v[bi * rows:(bi + 1) * rows]) for key, v in flat.items()
            if key.startswith(f"batch{k}/")}

    if spec.mode == "ssp":
        step = build_ssp_train_step(net, sp, 1, group, comm, plan=plan)
        p, s = step.load(params, init_ssp_state(params, step.n_groups,
                                                comm))
        for k in range(SSP_STEPS):
            p, s, m = step.step(p, s, batch_of(k))
            out["losses"].append(float(m["loss"]))
        anchor, st = step.export(p, s)
        out.update({f"anchor/{k}": v for k, v in _tree_np(anchor).items()})
        out.update({f"local/{k}": v
                    for k, v in _tree_np(st.local_params).items()})
        out["census"] = json.dumps(spmd.CENSUS.last)
        np.savez(os.path.join(d, f"{case}.rank{rank}.npz"), **out)
        return
    if spec.net != "lenet":
        # what an Engine does: the dropout stream of the batch shard
        net.generator.manual_seed(rank_seed(7, bi))
        masks = []
        for layer in net.layers:
            if layer.TYPE == "DROPOUT":
                layer.register_forward_hook(
                    lambda _m, _i, o: masks.append(o[0].detach() != 0)
                    if isinstance(o, list) else None)
    sharded = spec.mode == "sharded_state"
    step = build_train_step(net, sp, group, comm, plan=plan,
                            sharded_state=sharded)
    state0 = init_train_state(params, comm, plan.n_dp)
    if sharded:
        st = spmd.shard_train_state(params, state0, step)
    else:
        p, s = step.load(params, state0)
    trace = case in ("dp2_fsdp2", "dp2_tp2") and rank == 0
    for k in range(STEPS):
        batch = batch_of(k)
        if trace and k == STEPS - 1:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                p, s, m = step.step(p, s, batch)
            out["trace_names"] = json.dumps(sorted(
                {e.name for e in prof.events()}))
        elif sharded:
            st, m = step.step(st, batch)
        else:
            p, s, m = step.step(p, s, batch)
        out["losses"].append(float(m["loss"]))
        # the step's own collectives (the export's gathers come after)
        out["census"] = json.dumps(spmd.CENSUS.scheduled())
        if k + 1 in (1, STEPS):
            cp, cs = (spmd.unshard_train_state(st, step) if sharded
                      else step.export(p, s))
            out.update({f"step{k + 1}/params/{key}": v
                        for key, v in _tree_np(cp).items()})
            out.update({f"step{k + 1}/history/{key}": v
                        for key, v in _tree_np(
                            cs.solver.history).items()})
            out.update({f"step{k + 1}/err/{key}": v
                        for key, v in _tree_np(cs.comm_error).items()})
    out["schedule"] = json.dumps(plan.collective_schedule(
        step.arena, net, comm, sharded_state=sharded))
    out["shard_len"] = (step.w_sh.numel() if step.w_sh is not None else 0)
    out["padded_total"] = (step.arena.padded_total if step.arena else 0)
    if spec.mode == "dropout":
        out.update({f"mask{i}": m.numpy() for i, m in enumerate(masks)})
    if case == "dp2_fsdp2" and rank == 0:
        from poseidon_tpu_torch.runtime.checkpoint import snapshot
        snapshot(os.path.join(d, "snap", "lenet"), net, cp, cs)
    np.savez(os.path.join(d, f"{case}.rank{rank}.npz"), **out)


def _worker(rank: int, world: int, store: str, d: str) -> int:
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        assert group.backend == "gloo" and group.world == world
        for case in CASES:
            _run_case(group, case, d)
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

from poseidon_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from poseidon_tpu.core.net import Net as JaxNet  # noqa: E402
from poseidon_tpu.parallel import spmd as jspmd  # noqa: E402
from poseidon_tpu.parallel import strategies as JS  # noqa: E402
from poseidon_tpu.parallel.trainer import (  # noqa: E402
    build_ssp_train_step as jax_ssp_step, init_ssp_state as jax_ssp_state,
    init_train_state as jax_state)
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver  # noqa: E402,E501
from poseidon_tpu.proto.messages import load_net_from_string as jax_str  # noqa: E402,E501


def _jax_net(name, rows):
    src = _shapes(name, rows) if name == "lenet" else None
    return JaxNet(jax_str(_net_text(name)), "TRAIN", conv_layout="NCHW",
                  source_shapes=src)


def _jax_comm(fields):
    kw = {k: (dict(v) if isinstance(v, dict) else v)
          for k, v in fields.items()}
    return JS.CommConfig(arena_bucket_mb=BUCKET_MB, **kw)


def _inputs(case, seed):
    spec = CASES[case]
    jnet = _jax_net(spec.net, _rows(spec.spec))
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 100)
    shapes = _shapes(spec.net, GLOBAL_B)
    n = max(STEPS, SSP_STEPS)
    batches = [{"data": rs.randn(*shapes["data"]).astype(np.float32),
                "label": rs.randint(0, 10, size=shapes["label"])
                .astype(np.float32)} for _ in range(n)]
    return params, batches


@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    inputs = {}
    for i, case in enumerate(CASES):
        if CASES[case].ref:
            continue
        params, batches = _inputs(case, seed=21 + i)
        inputs[case] = (params, batches)
        arrays = {f"params/{l}/{p}": v for l, lv in params.items()
                  for p, v in lv.items()}
        for k, b in enumerate(batches):
            arrays.update({f"batch{k}/{t}": v for t, v in b.items()})
        np.savez(d / f"{case}.in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
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
    for case, spec in CASES.items():
        n = MeshConfig.parse(spec.spec).n_devices
        results[case] = []
        for r in range(n):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return inputs, results, d


_JAX_REFS = {}


def _jax_reference(case, inputs):
    """JAX's {step: (params, history, loss, comm_error)} after steps 1 and
    STEPS on the named mesh; for an SSP case (anchor, local rows,
    losses)."""
    if case in _JAX_REFS:
        return _JAX_REFS[case]
    spec = CASES[case]
    params, batches = inputs[case]
    cfg = JaxMeshConfig.parse(spec.spec)
    mesh = jspmd.named_mesh(cfg)
    jnet = _jax_net(spec.net, _rows(spec.spec))
    comm = _jax_comm(spec.fields)
    plan = jspmd.ShardingPlan.build(jnet, cfg, comm)
    sp = JaxSolver(**SOLVER)
    if spec.mode == "ssp":
        ts = jax_ssp_step(jnet, sp, mesh, 1, comm, plan=plan)
        st = jax_ssp_state(params, plan.n_dp, comm)
        losses = []
        for k in range(SSP_STEPS):
            st, m = ts.step(st, batches[k], jax.random.PRNGKey(k))
            losses.append(float(m["loss"]))
        out = (jax.tree_util.tree_map(np.asarray, st.anchor_params),
               jax.tree_util.tree_map(np.asarray, st.local_params), losses)
    else:
        ts = jspmd.build_spmd_train_step(jnet, sp, mesh, plan, comm,
                                         donate=False)
        p, s = params, jax_state(params, comm, plan.n_dp)
        out = {}
        for k in range(STEPS):
            p, s, m = ts.step(p, s, batches[k], jax.random.PRNGKey(k))
            if k + 1 in (1, STEPS):
                out[k + 1] = (jax.tree_util.tree_map(np.asarray, p),
                              jax.tree_util.tree_map(np.asarray,
                                                     s.solver.history),
                              float(m["loss"]),
                              jax.tree_util.tree_map(np.asarray,
                                                     s.comm_error))
    _JAX_REFS[case] = out
    return out


def _flat(tree):
    return {f"{l}/{p}": np.asarray(v) for l, lv in tree.items()
            for p, v in lv.items()}


# --------------------------------------------------------------------- #
# the planner, equal to JAX's

def test_mesh_config_parse_matches_jax():
    for spec in ("dp2,fsdp2,tp1", "dp4", "fsdp2", "tp2,dp2",
                 "dp2,fsdp2,replicated", "data3,tp2", ""):
        a, b = MeshConfig.parse(spec), JaxMeshConfig.parse(spec)
        assert (a.data, a.fsdp, a.tp, a.shard) == (b.data, b.fsdp, b.tp,
                                                   b.shard)
        assert (a.n_devices, a.active, a.describe()) == (
            b.n_devices, b.active, b.describe())
    for bad in ("dp2,zz3", "dp2,dp4", "fsdp0", "tpx"):
        with pytest.raises(ValueError) as ours:
            MeshConfig.parse(bad)
        with pytest.raises(ValueError) as theirs:
            JaxMeshConfig.parse(bad)
        assert str(ours.value) == str(theirs.value)


def _plan_pair(net_name, spec, fields, rows):
    if net_name == "alexnet":
        from poseidon_tpu.proto.messages import load_net as jax_load
        from poseidon_tpu_torch.proto.messages import load_net
        path = os.path.join(REPO, ALEXNET_TRAIN)
        shapes = {"data": (rows, 3, 227, 227), "label": (rows,)}
        net = Net(load_net(path), "TRAIN", device="cpu",
                  source_shapes=shapes)
        jnet = JaxNet(jax_load(path), "TRAIN", conv_layout="NCHW",
                      source_shapes=shapes)
    else:
        net, jnet = _port_net(net_name, rows), _jax_net(net_name, rows)
    cfg = MeshConfig.parse(spec)
    plan = spmd.ShardingPlan.build(net, cfg, S.CommConfig(
        bucket_mb=BUCKET_MB, **fields))
    jplan = jspmd.ShardingPlan.build(jnet, JaxMeshConfig.parse(spec),
                                     _jax_comm(fields))
    return net, jnet, plan, jplan


@pytest.mark.parametrize("net_name,spec,fields", [
    ("lenet", "dp2,fsdp2", {}),
    ("lenet", "dp2,tp2", {}),
    ("lenet", "dp2,fsdp2,tp2", {}),
    ("lenet", "dp2,tp2", {"layer_strategies": {"ip1": S.SFB,
                                               "ip2": S.TOPK}}),
    ("lenet", "dp2,tp2", {"layer_strategies": {"ip2": S.TOPK}}),
    ("lenet", "fsdp4,replicated", {}),
    ("narrow_alexnet_drop", "fsdp2,tp2", {}),
    ("alexnet", "tp2", {}),
    ("alexnet", "dp2,fsdp2,tp2", {"layer_strategies": {"fc6": S.SFB}}),
    ("alexnet", "tp4", {"layer_strategies": {"fc8": S.TOPK}}),
])
def test_sharding_plan_matches_jax(net_name, spec, fields):
    net, jnet, plan, jplan = _plan_pair(net_name, spec, fields, 4)
    assert plan.tp_layers.keys() == jplan.tp_layers.keys()
    for l, dec in plan.tp_layers.items():
        j = jplan.tp_layers[l]
        assert (dec.mode, dec.gather, dec.shard_dim) == (
            j.mode, j.gather, j.shard_dim), l
    assert plan.sharded_blobs == jplan.sharded_blobs
    assert plan.arena_layers == jplan.arena_layers
    assert plan.leaf_plan.keys() == jplan.leaf_plan.keys()
    for key, lp in plan.leaf_plan.items():
        jl = jplan.leaf_plan[key]
        assert lp.placement == jl.placement, key
        assert lp.spec == tuple(jl.spec), key
    assert plan.describe() == jplan.describe()
    assert (plan.n_dp, plan.active) == (jplan.n_dp, jplan.active)


def test_alexnet_tp2_plans_every_fc_layer_column_with_gather():
    """AlexNet's dropouts break every pairing: fc6, fc7 and fc8 are COL
    with a gather, as JAX plans them."""
    _, _, plan, _ = _plan_pair("alexnet", "tp2", {}, 4)
    assert {l: (d.mode, d.gather) for l, d in plan.tp_layers.items()} == {
        "fc6": (spmd.COL, True), "fc7": (spmd.COL, True),
        "fc8": (spmd.COL, True)}
    assert "fc6" not in plan.arena_layers


def test_sfb_topk_opt_out_of_tp_and_arena():
    net, _, plan, _ = _plan_pair("lenet", "dp2,tp2", {
        "layer_strategies": {"ip1": S.SFB, "ip2": S.TOPK}}, 4)
    assert plan.tp_layers == {}
    for lname in ("ip1", "ip2"):
        assert lname not in plan.arena_layers
        for pdef in net.param_defs[lname]:
            assert plan.leaf_plan[(lname, pdef.name)] == spmd.LeafPlan(
                "replicated", ())
    with pytest.raises(ValueError, match="rides the flat parameter arena"):
        spmd.ShardingPlan.build(net, MeshConfig(data=2, fsdp=2),
                                S.CommConfig(param_arena=False))


@pytest.mark.parametrize("align", [1, 2, 4])
@pytest.mark.parametrize("bucket_mb", [0.05, 0.3, 4.0])
def test_aligned_arena_matches_jax(align, bucket_mb):
    net, jnet = _port_net("lenet", 4), _jax_net("lenet", 4)
    lay = net.arena_layout(bucket_mb, align=align)
    jlay = jnet.arena_layout(bucket_mb=bucket_mb, align=align)
    assert (lay.total, lay.padded_total, lay.n_buckets) == (
        jlay.total, jlay.padded_total, jlay.n_buckets)
    assert lay.bucket_ranges == [tuple(r) for r in jlay.bucket_ranges]
    assert [(s.layer, s.pname, s.offset, s.size) for s in lay.slots] == [
        (s.layer, s.pname, s.offset, s.size) for s in jlay.slots]
    for ours, theirs in zip(lay.mult_vectors(5e-4),
                            jlay.mult_vectors(5e-4)):
        np.testing.assert_array_equal(ours, theirs)
    ranges = spmd.fsdp_shard_ranges(lay, align)
    assert ranges == jspmd.fsdp_shard_ranges(jlay, align)
    seen = np.zeros(lay.padded_total, np.int32)
    for dev in ranges:
        for lo, hi in dev:
            seen[lo:hi] += 1
    assert (seen == 1).all()
    flat = np.arange(lay.padded_total, dtype=np.float32)
    sm = spmd.to_shard_major(flat, lay, align)
    np.testing.assert_array_equal(sm, jspmd.to_shard_major(flat, jlay,
                                                           align))
    np.testing.assert_array_equal(spmd.from_shard_major(sm, lay, align),
                                  flat)
    sp, jsp = SolverParameter(weight_decay=5e-4), JaxSolver(weight_decay=5e-4)
    for ours, theirs in zip(spmd.shard_mult_vectors(lay, sp, align),
                            jspmd._shard_mult_vectors(jlay, jsp, align)):
        np.testing.assert_array_equal(ours, theirs)


def test_align_one_leaves_the_layout_as_it_was():
    net = _port_net("lenet", 4)
    lay = net.arena_layout(0.3)
    assert lay is net.arena_layout(0.3, align=1)
    assert lay.padded_total == lay.total
    with pytest.raises(ValueError, match="cannot align"):
        net.arena_layout(0.0, align=2)


# the six spec and comm cases of test_collective_census_matches_plan
CENSUS_CASES = [
    ("dp2,fsdp2", {}),
    ("dp2,tp2", {}),
    ("dp2,fsdp2,tp2", {}),
    ("dp2,tp2", {"layer_strategies": {"ip2": S.TOPK}}),
    ("dp2,fsdp2", {"layer_strategies": {"ip1": S.SFB}}),
    ("dp2,tp2", {"param_arena": False}),
]


@pytest.mark.parametrize("sharded_state", [False, True])
@pytest.mark.parametrize("spec,fields", CENSUS_CASES)
def test_collective_schedule_matches_jax(spec, fields, sharded_state):
    cfg = MeshConfig.parse(spec)
    rows = 16 // (cfg.data * cfg.fsdp)
    net, jnet, plan, jplan = _plan_pair("lenet", spec, fields, rows)
    comm = S.CommConfig(bucket_mb=4.0, **fields)
    jcomm = JS.CommConfig(**fields)
    f = cfg.fsdp if plan.fsdp_on else 1
    lay = (net.arena_layout(4.0, align=f, layers=plan.arena_layers)
           if plan.arena_layers else None)
    jlay = (jnet.arena_layout(plan.arena_layers, 4.0, align=f)
            if jplan.arena_layers else None)
    ours = plan.collective_schedule(lay, net, comm,
                                    sharded_state=sharded_state)
    theirs = jplan.collective_schedule(jlay, jnet, comm=jcomm,
                                       sharded_state=sharded_state)
    assert ours == theirs


# --------------------------------------------------------------------- #
# the gloo job, against JAX and against itself

@pytest.mark.parametrize("case", JAX_CASES)
def test_spmd_steps_match_jax(spmd_run, case):
    inputs, results, _ = spmd_run
    ranks = results[case]
    if CASES[case].mode == "ssp":
        anchor, local, losses = _jax_reference(case, inputs)
        np.testing.assert_allclose(ranks[0]["losses"], losses,
                                   rtol=LOSS_RTOL)
        for key, v in _flat(anchor).items():
            np.testing.assert_allclose(ranks[0][f"anchor/{key}"], v,
                                       **PARAM_TOL, err_msg=f"anchor {key}")
        for key, v in _flat(local).items():
            np.testing.assert_allclose(ranks[0][f"local/{key}"], v,
                                       **PARAM_TOL, err_msg=f"local {key}")
        return
    ref = _jax_reference(case, inputs)
    for step in (1, STEPS):
        params, history, loss, err = ref[step]
        np.testing.assert_allclose(ranks[0]["losses"][step - 1], loss,
                                   rtol=LOSS_RTOL)
        for kind, tree in (("params", params), ("history", history),
                           ("err", err)):
            for key, v in _flat(tree).items():
                np.testing.assert_allclose(
                    ranks[0][f"step{step}/{kind}/{key}"], v, **PARAM_TOL,
                    err_msg=f"{case}: {kind} {key} after step {step}")
        if CASES[case].fields.get("layer_strategies", {}).get("ip2") == \
                S.TOPK:
            assert _flat(err), "JAX kept no residual"


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_end_bitwise_equal(spmd_run, case):
    """Every rank exports the same canonical params (tp shards gathered,
    residual rows stacked): no rank drifted."""
    _, results, _ = spmd_run
    first = results[case][0]
    keys = [k for k in first
            if k.startswith(("step", "anchor/", "local/"))]
    assert keys
    for r, res in enumerate(results[case][1:], 1):
        for k in keys:
            np.testing.assert_array_equal(res[k], first[k],
                                          err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("case", BITWISE_CASES)
def test_port_bitwise_claims_at_two_ranks_an_axis(spmd_run, case):
    """The sharded arm equals the replicated control arm, and the
    sharded-state layout the canonical one, bit for bit (losses, params,
    momentum): hierarchical sums of two terms an axis."""
    _, results, _ = spmd_run
    ours, ref = results[case][0], results[CASES[case].ref][0]
    np.testing.assert_array_equal(ours["losses"], ref["losses"])
    keys = [k for k in ref if k.startswith("step")]
    for k in keys:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("case", [c for c, s in CASES.items()
                                  if s.mode != "ssp"])
def test_collective_census_matches_plan(spmd_run, case):
    """Each rank's issued collectives of its last step (names, kinds,
    axes, sizes at or above the threshold) equal the plan's schedule."""
    _, results, _ = spmd_run
    for r, res in enumerate(results[case]):
        census = json.loads(str(res["census"]))
        sched = json.loads(str(res["schedule"]))
        assert census["counts"] == sched["counts"], (r, census, sched)
        # the plan lists by bucket, the step issues by phase
        assert sorted(census["collectives"], key=json.dumps) == sorted(
            sched["collectives"], key=json.dumps), r


def test_sharded_layouts_hold_their_shard(spmd_run):
    """A fsdp rank's shard buffers hold padded_total / fsdp elements."""
    _, results, _ = spmd_run
    for case, f in (("fsdp2", 2), ("dp2_fsdp2_sharded_state", 2),
                    ("dp1_fsdp2_tp2", 2)):
        for res in results[case]:
            assert int(res["shard_len"]) * f == int(res["padded_total"])
    for res in results["fsdp2_replicated"]:
        assert int(res["shard_len"]) == 0


def test_ssp_fsdp_delta_exchange_reshards(spmd_run):
    """The SSP boundary's DENSE deltas reduce-scatter over fsdp, all-reduce
    over data and all-gather back, bucket by bucket."""
    _, results, _ = spmd_run
    census = json.loads(str(results["ssp_dp2_fsdp2"][0]["census"]))
    kinds = {}
    for r in census:
        kinds.setdefault(r["name"][:9], set()).add((r["kind"], r["axis"]))
    assert kinds["delta_rs_"] == {("reduce_scatter", "fsdp")}
    assert kinds["delta_ar_"] == {("all_reduce", "data")}
    assert kinds["delta_ag_"] == {("all_gather", "fsdp")}


def test_dropout_masks_equal_across_tp_replicas(spmd_run):
    """dp1,fsdp2,tp2: ranks (0, 1) and (2, 3) are the tp replicas of batch
    shards 0 and 1. Each pair draws the same dropout masks; the shards
    draw other ones."""
    _, results, _ = spmd_run
    ranks = results["dropout_fsdp2_tp2"]
    assert [list(r["coords"]) for r in ranks] == [[0, 0, 0], [0, 0, 1],
                                                  [0, 1, 0], [0, 1, 1]]
    n = len([k for k in ranks[0] if k.startswith("mask")])
    assert n == 2 * STEPS
    for i in range(n):
        m = [r[f"mask{i}"] for r in ranks]
        np.testing.assert_array_equal(m[0], m[1])
        np.testing.assert_array_equal(m[2], m[3])
        assert not np.array_equal(m[0], m[2])
    assert "fc6': 'column'" in str(ranks[0]["describe"])


def test_collectives_carry_their_labels_in_a_profiler_trace(spmd_run):
    _, results, _ = spmd_run
    names = set(json.loads(str(results["dp2_fsdp2"][0]["trace_names"])))
    for i in range(6):
        for label in (f"grad_rs_bucket{i}", f"grad_ar_bucket{i}",
                      f"param_ag_bucket{i}", f"hist_ag_bucket{i}"):
            assert label in names, label
    # dp2,tp2: ip1 COL with its output kept sharded, ip2 ROW
    names = set(json.loads(str(results["dp2_tp2"][0]["trace_names"])))
    for label in ("tp_dx_ip1", "tp_fwd_ip2", "grad_tp_ip1_w_data",
                  "grad_tp_ip2_b_data", "grad_ar_bucket0"):
        assert label in names, label
    assert "tp_fwd_ip1" not in names


def test_mesh_snapshot_loads_into_one_device_and_jax(spmd_run):
    """The dp2,fsdp2 snapshot is canonical: it restores bitwise, drives
    the port's one-device step and JAX's flat replicated step."""
    from poseidon_tpu.parallel import build_train_step as jax_train_step
    from poseidon_tpu.parallel.mesh import make_mesh
    from poseidon_tpu.runtime.checkpoint import restore as jax_restore
    from poseidon_tpu_torch.runtime.checkpoint import restore
    _, results, d = spmd_run
    statef = str(d / "snap" / f"lenet_iter_{STEPS}.solverstate.npz")
    params, state = restore(statef)
    res = results["dp2_fsdp2"][0]
    for l, lv in params.items():
        for p, v in lv.items():
            np.testing.assert_array_equal(
                v.numpy(), res[f"step{STEPS}/params/{l}/{p}"])
            np.testing.assert_array_equal(
                state.solver.history[l][p].numpy(),
                res[f"step{STEPS}/history/{l}/{p}"])
    assert int(state.solver.it) == STEPS
    net = _port_net("lenet", 4)
    step = build_train_step(net, SolverParameter(**SOLVER))
    p, s = step.load(net.to_device_params(params), state)
    rs = np.random.RandomState(0)
    batch = {"data": torch.from_numpy(
        rs.randn(4, 1, 28, 28).astype(np.float32)),
        "label": torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))}
    _, _, m = step.step(p, s, batch)
    assert np.isfinite(float(m["loss"]))
    jparams, jstate = jax_restore(statef)
    jnet = _jax_net("lenet", 2)
    ts = jax_train_step(jnet, JaxSolver(**SOLVER), make_mesh(), donate=False)
    jb = {"data": np.repeat(batch["data"].numpy(), 4, axis=0),
          "label": np.repeat(batch["label"].numpy(), 4, axis=0)}
    _, _, jm = ts.step(jparams, jstate, jb, jax.random.PRNGKey(0))
    assert np.isfinite(float(jm["loss"]))


# --------------------------------------------------------------------- #
# in process

def test_size_mismatch_without_tp_plan_is_loud():
    net = _port_net("lenet", 2)
    params = net.init(torch.Generator().manual_seed(0))
    params["ip1"]["b"] = torch.zeros(1)
    x = {"data": torch.zeros(2, 1, 28, 28), "label": torch.zeros(2)}
    with pytest.raises(ValueError, match="no tensor-parallel plan"):
        net.apply(params, x, train=False)
    # a leaf of the same count is reshaped, as JAX's permissive share
    params = net.init(torch.Generator().manual_seed(0))
    params["ip1"]["b"] = params["ip1"]["b"].reshape(1, -1)
    assert torch.isfinite(net.apply(params, x, train=False).loss)


def test_ssp_on_a_mesh_refuses_tp_and_adarevision():
    net = _port_net("lenet", 2)
    sp = SolverParameter(**SOLVER)
    plan = spmd.ShardingPlan.build(net, MeshConfig(data=2, tp=2))
    with pytest.raises(ValueError, match="tensor parallelism"):
        build_ssp_train_step(net, sp, 1, None, S.CommConfig(), plan=plan)
    comm = S.CommConfig(server_logic="adarevision")
    plan = spmd.ShardingPlan.build(net, MeshConfig(data=2, fsdp=2), comm)
    with pytest.raises(ValueError, match="adarevision"):
        build_ssp_train_step(net, sp, 1, None, comm, plan=plan)
    with pytest.raises(ValueError, match="do not compose"):
        build_ssp_train_step(net, sp, 1, None,
                             S.CommConfig(dcn_axis="dcn"), plan=plan)


def test_spmd_step_refuses_local_and_a_missing_mesh():
    net = _port_net("lenet", 2)
    sp = SolverParameter(**SOLVER)
    plan = spmd.ShardingPlan.build(net, MeshConfig(fsdp=2))
    with pytest.raises(ValueError, match="named mesh's groups"):
        build_train_step(net, sp, None, plan=plan)
    with pytest.raises(ValueError, match="sharded_state needs an fsdp"):
        build_train_step(net, sp, None, sharded_state=True)


def test_mesh_world_must_match(monkeypatch):
    monkeypatch.delenv("POSEIDON_COORDINATOR", raising=False)
    with pytest.raises(SystemExit, match="needs 4 devices; 1 available"):
        cluster.init_distributed(torch.device("cpu"), rank=0, world=1,
                                 mesh_cfg=MeshConfig(data=2, fsdp=2))


def test_balanced_shape_matches_jax():
    from poseidon_tpu.parallel.mesh import balanced_shape as jax_balanced
    from poseidon_tpu_torch.parallel.mesh import balanced_shape
    for n in (1, 2, 4, 7, 8, 12, 16, 30, 64):
        for k in (1, 2, 3):
            assert balanced_shape(n, k) == jax_balanced(n, k), (n, k)


@pytest.mark.parametrize("spec", ["dp2,fsdp2", "fsdp4", "fsdp2,tp2"])
def test_sharded_state_bytes_match_jax_avals(spec):
    """The bytes a rank of the sharded state equal what JAX's
    ``sharded_state_avals`` place on one device."""
    cfg = MeshConfig.parse(spec)
    rows = 16 // (cfg.data * cfg.fsdp)
    net, jnet, plan, jplan = _plan_pair("lenet", spec, {}, rows)
    jcfg = JaxMeshConfig.parse(spec)
    jlay = jnet.arena_layout(jplan.arena_layers, BUCKET_MB, align=jcfg.fsdp)
    avals = jspmd.sharded_state_avals(jnet, jlay, jplan,
                                      jspmd.named_mesh(jcfg))
    dev = jax.devices()[0]
    per_device = 0
    for leaf in jax.tree_util.tree_leaves(avals):
        if leaf.shape == ():
            continue
        shard = leaf.sharding.shard_shape(leaf.shape)
        if dev in leaf.sharding.device_set:
            per_device += int(np.prod(shard)) * 4
    ours = spmd.sharded_state_bytes(net, plan, bucket_mb=BUCKET_MB)
    assert ours["total"] == per_device
    assert ours["arena"] == 2 * 4 * (jlay.padded_total // jcfg.fsdp)


@pytest.mark.parametrize("net_name,spec", [
    ("alexnet", "tp2"), ("alexnet", "dp1,fsdp2,tp2"), ("lenet", "fsdp2"),
    ("lenet", "fsdp2,replicated")])
def test_step_layouts_cover_every_leaf_once(net_name, spec):
    """``step_layouts``, the two flat buffers a step's K7 updates: the
    arena holds the plan's arena layers (fsdp-aligned when fsdp shards),
    the rest holds every other leaf once, at a rank's tp shape; the two
    lengths of a tp2 rank's K7 calls sum to the arena plus 1/tp of the
    tp leaves."""
    cfg = MeshConfig.parse(spec)
    net = _port_net(net_name, 4)
    plan = spmd.ShardingPlan.build(net, cfg, shard_params=cfg.shard,
                                   enable_tp=cfg.shard)
    arena, full, local = spmd.step_layouts(net, plan, BUCKET_MB)
    leaves = [(l, p.name) for l, p in net._arena_order]
    in_arena = [(s.layer, s.pname) for s in arena.slots]
    outside = [(s.layer, s.pname) for s in full.slots] if full else []
    assert sorted(in_arena + outside) == sorted(leaves)
    assert {l for l, _ in in_arena} == set(plan.arena_layers)
    assert arena.align == (cfg.fsdp if plan.fsdp_on else 1)
    assert arena.padded_total % arena.align == 0
    t = cfg.tp
    tp_count = sum(s.size for s in full.slots
                   if s.layer in plan.tp_layers) if full else 0
    if local is not None:
        assert [(s.layer, s.pname) for s in local.slots] == outside
        assert local.total == full.total - tp_count + tp_count // t
        for sf, sl in zip(full.slots, local.slots):
            dec = plan.tp_layers.get(sf.layer)
            want = sf.size if dec is None or (
                sf.pname == "b" and dec.mode == spmd.ROW) else sf.size // t
            assert sl.size == want, (sf.layer, sf.pname)
    if net_name == "alexnet" and cfg.fsdp == 1:
        assert set(plan.tp_layers) == {"fc6", "fc7", "fc8"}
        assert local is not None and arena.padded_total == arena.total


def test_mesh_groups_follow_jax_device_order():
    """rank r sits at data r // (F*T), fsdp (r // T) % F, tp r % T — the
    row-major reshape of JAX's named mesh — and the joint group orders
    the batch shards d*F + f."""
    from poseidon_tpu_torch.parallel.mesh import mesh_axis_ranks, mesh_coords
    cfg = MeshConfig(data=2, fsdp=2, tp=2)
    jmesh = jspmd.named_mesh(JaxMeshConfig(data=2, fsdp=2, tp=2))
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices)
    for r in range(8):
        assert ids[mesh_coords(r, cfg)] == r
    groups = mesh_axis_ranks(cfg)
    assert groups["fsdp"][0] == [0, 2] and groups["tp"][0] == [0, 1]
    assert groups["data"][0] == [0, 4] and groups["joint"][1] == [1, 3, 5, 7]


# --------------------------------------------------------------------- #
# the CLI

def _digits_solver(tmp_path, max_iter):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, DIGITS)}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 10\n'
        f'max_iter: {max_iter}\ntest_iter: 2\ntest_interval: {max_iter}\n'
        'test_initialization: false\nsnapshot_prefix: "digits"\n')
    return solver


def _cli_pairs(tmp_path, arms, iters):
    """Two ranks of ``train --mesh <spec>`` a (name, spec) arm, every arm
    at once; returns each process's log, in arm then rank order."""
    solver = _digits_solver(tmp_path, iters)
    procs = []
    for arm, spec in arms:
        for r in range(2):
            env = dict(os.environ, POSEIDON_PROC_ID=str(r),
                       POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="1",
                       POSEIDON_COORDINATOR=f"file://{tmp_path / arm}.store")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "poseidon_tpu_torch", "train",
                 f"--solver={solver}", "--output_dir",
                 str(tmp_path / f"{arm}{r}"), "--device", "cpu",
                 "--mesh", spec, "--arena_bucket_mb", "0.1"], cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, logs[i]
    return logs


def test_cli_mesh_tp2_writes_canonical_snapshots(tmp_path):
    """Two ``train --mesh tp2`` ranks: rank 0 logs the plan (ip1 and ip2
    COL with a gather: the digits net's dropout sits between them), both
    write the same snapshot at the net's full shapes, which a run without
    ``--mesh`` restores."""
    iters = 6
    logs = _cli_pairs(tmp_path, (("tp", "tp2"),), iters)
    assert ("tp {'ip1': 'column', 'ip2': 'column'}" in logs[0]), logs[0]
    snaps = [tmp_path / d / f"digits_iter_{iters}.solverstate.npz"
             for d in ("tp0", "tp1")]
    with np.load(snaps[0]) as a, np.load(snaps[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["params/ip1\x1fw"].shape == (128, 256)
    from poseidon_tpu_torch.runtime.cli import main
    solver = _digits_solver(tmp_path / "tp0", iters + 2)
    assert main(["train", f"--solver={solver}", "--output_dir",
                 str(tmp_path / "one"), "--device", "cpu", "--snapshot",
                 str(snaps[0])]) == 0


def test_cli_mesh_fsdp2_bitwise_vs_replicated(tmp_path):
    """Two ``train --mesh fsdp2`` ranks and two ``--mesh
    fsdp2,replicated`` ranks: the four snapshots are bitwise equal."""
    iters = 12
    logs = _cli_pairs(tmp_path, (("sh", "fsdp2"),
                                 ("rep", "fsdp2,replicated")), iters)
    assert "sharding plan: mesh dp1,fsdp2,tp1: 4 arena layer(s)" in logs[0]
    assert "(replicated control)" in logs[2]
    assert "Test net #0" in logs[0]
    snaps = [tmp_path / d / f"digits_iter_{iters}.solverstate.npz"
             for d in ("sh0", "sh1", "rep0", "rep1")]
    with np.load(snaps[0]) as z0:
        ref = {k: z0[k] for k in z0.files}
    for path in snaps[1:]:
        with np.load(path) as z:
            assert sorted(z.files) == sorted(ref)
            for k in z.files:
                np.testing.assert_array_equal(z[k], ref[k], err_msg=k)
