"""The port's data-parallel training against the JAX package's, on the CPU.

One module-scoped fixture runs ONE two-process gloo job: this file run as
a script, once per rank, each in its own subprocess with a timeout, both
meeting in a ``file://`` store under the test's tmp dir. Every case of
``CASES`` runs in that job: the same weights (from JAX, through
``params_from_jax``), the same numpy global batches (rank r takes rows
[r*B, (r+1)*B), as the JAX step shards a global batch over a 2-device
virtual mesh), three steps, an npz per case and rank.

Each case is held against JAX ``build_train_step(net, sp, make_mesh(2),
CommConfig(...))`` (LOCAL, which that step refuses, against a one-device
JAX step on the rank's own rows): parameters and momentum after one step
and after three at rtol 1e-4, atol 1e-6 (the train-step tolerance of
``tests/test_torch_train.py``; XLA's and PyTorch's CPU convolutions and
GEMMs sum in different orders), losses at rtol 1e-5. bf16-wire cases hold
the same tolerance with a counted allowance (``BF16_FLIP_SHARE``), and a
control run of each without the cast must break it. The two ranks end bitwise
equal (but under LOCAL), and the DWBP buckets are issued in order, all but
the first layer's before the first layer's backward starts. TOPK cases
also hold each rank's error-feedback residual against its row of JAX's
``comm_error`` (one row a device on the flat mesh). Nets without
dropout: the two packages' random streams differ.
"""

import functools
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

from poseidon_tpu_torch.core.net import Net, params_from_jax  # noqa: E402
from poseidon_tpu_torch.parallel import strategies as S  # noqa: E402
from poseidon_tpu_torch.parallel.mesh import DataGroup, rank_seed  # noqa: E402,E501
from poseidon_tpu_torch.parallel import trainer as T  # noqa: E402
from poseidon_tpu_torch.parallel.trainer import (  # noqa: E402
    build_train_step, init_train_state, param_mults)
from poseidon_tpu_torch.proto.messages import (  # noqa: E402
    SolverParameter, load_net, load_net_from_string)
from poseidon_tpu_torch.runtime import cluster  # noqa: E402
from poseidon_tpu_torch.solvers.updates import learning_rate  # noqa: E402

LENET = "examples/mnist/lenet_train_test.prototxt"
ALEXNET_TRAIN = "examples/imagenet/alexnet_train_val.prototxt"
B = 4            # rows a rank
WORLD = 2
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# A bf16 wire rounds each rank's gradient to 8 significant bits. Where
# XLA's and torch's f32 gradients differ in the last bit across a bf16
# rounding boundary, the synced gradient differs by one bf16 step of the
# rank's gradient, and the parameter and momentum by lr times that; the
# parameters that moved apart then move later gradients apart too. So a
# bf16-wire case holds PARAM_TOL but for at most BF16_FLIP_SHARE of the
# net's parameters (value or momentum; 43 of LeNet's 431,080), each
# within PARAM_TOL plus the bf16 steps it can have taken
# (``_bf16_step_bound``). The same case with an f32 wire puts tens of
# thousands outside (``test_bf16_wire_check_sees_a_dropped_cast``). f16's
# steps are 8x finer: its case holds PARAM_TOL outright. A TOPK case
# with a bf16 wire rounds what each rank sends, g + residual at the
# selected entries, the same way: its bound is built from that (captured
# in the worker). PERF.md's parity table has the readings.
BF16_FLIP_SHARE = 1e-4
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=1e-4, power=0.75)
WORKER_TIMEOUT_S = 120

_P = "blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0"
# AlexNet-shaped and narrow (test_torch_train.py's net): LRN, MAX and AVE
# pools, group convs, lr_mult 1/2 and decay_mult 1/0, no dropout
NARROW_ALEXNET = """
name: "NarrowAlexNetTrain"
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
layers { name: "conv2" type: CONVOLUTION bottom: "pool1" top: "conv2" %(p)s
  convolution_param { num_output: 16 pad: 2 kernel_size: 5 group: 2
    weight_filler { type: "gaussian" std: 0.2 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu2" type: RELU bottom: "conv2" top: "conv2" }
layers { name: "pool2" type: POOLING bottom: "conv2" top: "pool2"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layers { name: "fc6" type: INNER_PRODUCT bottom: "pool2" top: "fc6" %(p)s
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "relu6" type: RELU bottom: "fc6" top: "fc6" }
layers { name: "fc8" type: INNER_PRODUCT bottom: "fc6" top: "fc8" %(p)s
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label"
  top: "loss" }
""" % {"p": _P}

SFB_LENET = {"ip1": S.SFB, "ip2": S.SFB}


class Case(NamedTuple):
    net: str
    fields: dict            # CommConfig fields both packages share
    bucket_mb: float = 4.0  # the port's one bucket knob ...
    jax_bucket: dict = {}   # ... and the JAX knobs it stands for
    auto: bool = False      # auto_strategies fills the SFB layers in


# LeNet is 431,080 f32 (1.72 MB): 0.4 MB buckets cut it into five
CASES = {
    "dense_buckets": Case("lenet", {}, 0.4, dict(arena_bucket_mb=0.4)),
    "dense_per_leaf": Case("lenet", {}, 0.0, dict(arena_bucket_mb=0.0)),
    "dense_dwbp_mb": Case("lenet", {}, 0.25, dict(dwbp_bucket_mb=0.25)),
    "dense_no_arena": Case("lenet", {}, 0.0, dict(param_arena=False)),
    "reduce_sum": Case("lenet", dict(reduce="sum"), 0.4,
                       dict(arena_bucket_mb=0.4)),
    "dense_fused": Case("lenet", dict(default_strategy=S.DENSE_FUSED), 0.4,
                        dict(arena_bucket_mb=0.4)),
    "sfb": Case("lenet", dict(layer_strategies=SFB_LENET)),
    "sfb_default": Case("lenet", dict(default_strategy=S.SFB)),
    "sfb_auto": Case("narrow_alexnet", {}, 0.01, dict(arena_bucket_mb=0.01),
                     auto=True),
    "wire_bf16": Case("lenet", dict(wire_dtype="bf16"), 0.4,
                      dict(arena_bucket_mb=0.4)),
    "wire_f16": Case("lenet", dict(wire_dtype="f16"), 0.4,
                     dict(arena_bucket_mb=0.4)),
    "sfb_wire_bf16": Case("lenet", dict(layer_strategies=SFB_LENET,
                                        wire_dtype="bf16")),
    "narrow_alexnet_dense": Case("narrow_alexnet", {}, 0.01,
                                 dict(arena_bucket_mb=0.01)),
    "local": Case("lenet", dict(default_strategy=S.LOCAL)),
    # TOPK with its error-feedback residual, one residual a rank
    "topk": Case("lenet", dict(default_strategy=S.TOPK, topk_fraction=0.1)),
    # a mixed net: ip1 compressed, the rest on the DENSE buckets
    "topk_layer": Case("lenet", dict(layer_strategies={"ip1": S.TOPK},
                                     topk_fraction=0.1), 0.4,
                       dict(arena_bucket_mb=0.4)),
    "topk_blocked": Case("lenet", dict(default_strategy=S.TOPK,
                                       topk_fraction=0.1, topk_block=256)),
    "topk_fixed_order": Case("lenet", dict(default_strategy=S.TOPK,
                                           topk_fraction=0.1,
                                           topk_policy="fixed_order")),
    "topk_reduce_sum": Case("lenet", dict(default_strategy=S.TOPK,
                                          topk_fraction=0.1, reduce="sum")),
    "topk_wire_bf16": Case("lenet", dict(default_strategy=S.TOPK,
                                         topk_fraction=0.1,
                                         wire_dtype="bf16")),
}
TOPK_CASES = [c for c, spec in CASES.items()
              if S.TOPK in (spec.fields.get("default_strategy"),
                            *spec.fields.get("layer_strategies", {}).values())]
BF16_CASES = [c for c, spec in CASES.items()
              if spec.fields.get("wire_dtype") == "bf16"]
# the negative controls: each bf16-wire case on its own inputs with the
# cast dropped (an f32 wire), held against the bf16 reference
CONTROLS = {f"{c}_f32_wire": c for c in BF16_CASES}
# the negative control of the TOPK selection: the topk case sending one
# entry more a leaf (k + 1), which the parity check must tell apart
K_CONTROLS = {"topk_k_plus_one": "topk"}
RUNS = [*CASES, *CONTROLS, *K_CONTROLS]


def _of(case):
    """The case a run (a case or a control) takes its inputs from."""
    return CONTROLS.get(case) or K_CONTROLS.get(case) or case


def _net_text(name):
    if name == "lenet":
        with open(os.path.join(REPO, LENET)) as f:
            return f.read()
    return NARROW_ALEXNET


def _shapes(name, rows):
    if name == "lenet":
        return {"data": (rows, 1, 28, 28), "label": (rows,)}
    return {"data": (rows, 3, 35, 35), "label": (rows, 1, 1, 1)}


def _port_net(name, rows=B):
    src = _shapes(name, rows) if name == "lenet" else None
    return Net(load_net_from_string(_net_text(name)), "TRAIN", device="cpu",
               source_shapes=src)


def _fields(case):
    """(the Case, its CommConfig fields: a control's without the wire
    cast)."""
    spec = CASES[_of(case)]
    fields = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in spec.fields.items()}
    if case in CONTROLS:
        del fields["wire_dtype"]
    return spec, fields


def _comm(case, net):
    spec, fields = _fields(case)
    comm = S.CommConfig(bucket_mb=spec.bucket_mb, **fields)
    if spec.auto:
        comm.layer_strategies.update(S.auto_strategies(net))
    return comm


# --------------------------------------------------------------------- #
# the rank workers (this file run as a script)

def _run_case(group, case, d):
    net = _port_net(_fields(case)[0].net)
    comm = _comm(case, net)
    with np.load(os.path.join(d, f"{_of(case)}.in.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key, v in flat.items():
        if key.startswith("params/"):
            layer, p = key[len("params/"):].split("/")
            params.setdefault(layer, {})[p] = v
    params = params_from_jax(net, params)
    step = build_train_step(net, SolverParameter(**SOLVER), group, comm)
    params, state = step.load(params, init_train_state(
        params, comm, step.n_err_groups))
    local, factors = None, {}
    if comm.wire_dtype == "bf16":
        # what this rank puts on the wire, before the cast: its gradient of
        # the DENSE buckets as they go out, g + residual of the TOPK
        # leaves, and the SFB layers' factors
        local = torch.full_like(step.flat_g, float("nan"))
        issue = step.sync._issue

        def capture(bucket):
            local[bucket.lo:bucket.hi] = step.flat_g[bucket.lo:bucket.hi]
            issue(bucket)

        step.sync._issue = capture
        compress = T.topk_compress

        def capture_topk(g, fraction, error, *a, salt, **kw):
            s = next(s for s in step.topk_slots
                     if S.comm_salt(s.layer, s.pname) == salt)
            local[s.offset:s.offset + s.size] = (g + error).reshape(-1)
            return compress(g, fraction, error, *a, salt=salt, **kw)

        T.topk_compress = capture_topk
        ctx = step._ctx
        sfb_of = {id(step._leaf_tree[l]["w"]): l for l in ctx.sfb_layers}
        product = ctx.inner_product

        def capture_factors(x, w, b):
            layer = sfb_of[id(w)]
            y = product(x, w, b)
            factors[f"{layer}/x"] = x.detach().reshape(x.shape[0], -1) \
                .numpy().copy()
            y.register_hook(lambda g: factors.__setitem__(
                f"{layer}/g", g.numpy().copy()))
            return y

        ctx.inner_product = capture_factors
    if case in K_CONTROLS:
        compress = T.topk_compress

        def one_more(g, fraction, *a, **kw):
            k = max(1, int(g.numel() * fraction))
            return compress(g, (k + 1.5) / g.numel(), *a, **kw)

        T.topk_compress = one_more
    # the first layer's backward starts when its output's gradient exists:
    # count the buckets issued by then
    first = next(l for l in net.layers if l.params)
    before_first = []

    def on_output(_mod, _inp, outs):
        outs[0].register_hook(
            lambda g: before_first.append(len(step.sync.issued)))

    handle = first.register_forward_hook(on_output)
    first_slots = {i for i, s in enumerate(step.arena.slots)
                   if s.layer == first.name}
    out = {"losses": [], "issued": [], "mid": [],
           "n_hooked": len(step.sync.hooked),
           "first_buckets": [b for b, bk in enumerate(step.sync.hooked)
                             if first_slots & set(bk.leaves)],
           "bucket_layers": json.dumps(
               [sorted({step.arena.slots[i].layer for i in bk.leaves})
                for bk in step.sync.hooked])}
    r = group.rank
    for k in range(STEPS):
        batch = {key[len(f"batch{k}/"):]: torch.from_numpy(
            v[r * B:(r + 1) * B]) for key, v in flat.items()
            if key.startswith(f"batch{k}/")}
        if local is not None:
            local.fill_(float("nan"))
        params, state, m = step.step(params, state, batch)
        if local is not None:
            for layer, leaves in step.arena.unpack(local).items():
                for p, v in leaves.items():
                    out[f"grad{k + 1}/{layer}/{p}"] = v.numpy().copy()
            out.update({f"factors{k + 1}/{key}": v
                        for key, v in factors.items()})
        out["losses"].append(float(m["loss"]))
        out["issued"].append(list(step.sync.issued))
        out["mid"].append(step.sync.issued_mid_backward)
        if k in (0, STEPS - 1):
            for layer, leaves in params.items():
                for p, v in leaves.items():
                    out[f"step{k + 1}/params/{layer}/{p}"] = v.numpy().copy()
                    out[f"step{k + 1}/history/{layer}/{p}"] = \
                        state.solver.history[layer][p].numpy().copy()
            for layer, leaves in state.comm_error.items():
                for p, v in leaves.items():
                    assert v.shape[0] == 1      # this rank's row alone
                    out[f"err{k + 1}/{layer}/{p}"] = v[0].numpy().copy()
    handle.remove()
    if local is not None or case in K_CONTROLS:
        T.topk_compress = compress
    out["before_first"] = before_first
    out["kinds"] = json.dumps(step.kinds)
    np.savez(os.path.join(d, f"{case}.rank{r}.npz"), **out)


def _worker(rank: int, world: int, store: str, d: str) -> int:
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        assert group.backend == "gloo" and group.world == world
        for case in RUNS:
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
from jax.sharding import Mesh  # noqa: E402

from poseidon_tpu.core.net import Net as JaxNet  # noqa: E402
from poseidon_tpu.parallel import strategies as JS  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402
from poseidon_tpu.parallel.trainer import build_train_step as jax_step  # noqa: E402,E501
from poseidon_tpu.parallel.trainer import init_train_state as jax_state  # noqa: E402,E501
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver  # noqa: E402,E501
from poseidon_tpu.proto.messages import load_net as jax_load_net  # noqa: E402
from poseidon_tpu.proto.messages import load_net_from_string as jax_str  # noqa: E402,E501


def _jax_net(name, rows=B):
    src = _shapes(name, rows) if name == "lenet" else None
    return JaxNet(jax_str(_net_text(name)), "TRAIN", conv_layout="NCHW",
                  source_shapes=src)


def _inputs(name, seed):
    """(params as numpy, global batches of WORLD*B rows)."""
    jnet = _jax_net(name)
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 100)
    shapes = _shapes(name, WORLD * B)
    batches = [{"data": rs.randn(*shapes["data"]).astype(np.float32),
                "label": rs.randint(0, 10, size=shapes["label"])
                .astype(np.float32)} for _ in range(STEPS)]
    return params, batches


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    inputs = {}
    for i, (case, spec) in enumerate(CASES.items()):
        params, batches = _inputs(spec.net, seed=11 + i)
        inputs[case] = (params, batches)
        arrays = {f"params/{l}/{p}": v for l, lv in params.items()
                  for p, v in lv.items()}
        for k, b in enumerate(batches):
            arrays.update({f"batch{k}/{t}": v for t, v in b.items()})
        np.savez(d / f"{case}.in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO)
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
    for case in RUNS:
        results[case] = []
        for r in range(WORLD):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return inputs, results


def _jax_comm(spec, jnet):
    kw = {k: (dict(v) if isinstance(v, dict) else v)
          for k, v in spec.fields.items()}
    comm = JS.CommConfig(**kw, **spec.jax_bucket)
    if spec.auto:
        comm.layer_strategies.update(JS.auto_strategies(jnet))
    return comm


def _jax_reference(case, params, batches, rank=None):
    """{step: (params, history, loss, comm_error)} after steps 1 and
    STEPS (comm_error stacked one row a device)."""
    spec = CASES[case]
    jnet = _jax_net(spec.net)
    sp = JaxSolver(**SOLVER)
    comm = _jax_comm(spec, jnet)
    if rank is None:
        ts = jax_step(jnet, sp, make_mesh(WORLD), comm, donate=False)
        state = jax_state(params, comm, WORLD)
    else:       # LOCAL: one replica on its own rows
        ts = jax_step(jnet, sp, Mesh(np.array(jax.devices()[:1]), ("data",)),
                      donate=False)
        state = jax_state(params)
    out = {}
    for k, b in enumerate(batches):
        if rank is not None:
            b = {t: v[rank * B:(rank + 1) * B] for t, v in b.items()}
        params, state, m = ts.step(params, state, b, jax.random.PRNGKey(0))
        if k + 1 in (1, STEPS):
            out[k + 1] = (jax.tree_util.tree_map(np.asarray, params),
                          jax.tree_util.tree_map(np.asarray,
                                                 state.solver.history),
                          float(m["loss"]),
                          jax.tree_util.tree_map(np.asarray,
                                                 state.comm_error))
    return out


def _assert_close(res, ref, step, what):
    params, history = ref[step][:2]
    for tree, kind in ((params, "params"), (history, "history")):
        for l, lv in tree.items():
            for p, v in lv.items():
                np.testing.assert_allclose(
                    res[f"step{step}/{kind}/{l}/{p}"], v, **PARAM_TOL,
                    err_msg=f"{what}: {kind} {l}/{p} after step {step}")


def _assert_residuals_close(res, ref, step, row, what):
    """This rank's residual against its row of JAX's stacked
    ``comm_error``."""
    err = ref[step][3]
    assert err, f"{what}: JAX kept no residual"
    for l, lv in err.items():
        for p, v in lv.items():
            np.testing.assert_allclose(
                res[f"err{step}/{l}/{p}"], v[row], **PARAM_TOL,
                err_msg=f"{what}: residual {l}/{p} after step {step}")


def _bf16_step(x):
    """One bf16 step (the spacing of its 8 significant bits) at |x|."""
    x = np.abs(x.astype(np.float64))
    return np.where(x > 0, np.ldexp(1.0, np.frexp(x)[1] - 8), 0.0)


@functools.lru_cache(maxsize=None)
def _lr_mults(name):
    return {l: {p: m[0] for p, m in lm.items()}
            for l, lm in param_mults(_port_net(name)).items()}


def _summed_flip(g):
    """One bf16 step of each rank's g_r and one of their sum (both
    packages sum the bf16 values in bf16), over the world: how far one
    rounding off by a step on each rank moves the all-reduced mean."""
    return (sum(_bf16_step(x) for x in g)
            + _bf16_step(sum(np.abs(x) for x in g))) / WORLD


def _bf16_flip(ranks, l, p, j):
    """How far bf16 roundings one step apart, anywhere on the wire, can
    move the synced mean gradient of leaf l/p at step j. A DENSE leaf
    crosses as each rank's gradient g_r (``_summed_flip``). An SFB
    weight is rebuilt as G^T X / world from the gathered factors: every
    factor element one step off moves it by at most
    (step(G)^T |X| + |G|^T step(X)) / world; its bias crosses as each
    rank's sum of g."""
    g = [r[f"grad{j}/{l}/{p}"] for r in ranks]
    if np.isfinite(g[0]).all():
        return _summed_flip(g)
    if p == "b":
        return _summed_flip([r[f"factors{j}/{l}/g"].sum(axis=0)
                             for r in ranks])
    big_g = np.concatenate([r[f"factors{j}/{l}/g"] for r in ranks]) \
        .astype(np.float64)
    big_x = np.concatenate([r[f"factors{j}/{l}/x"] for r in ranks]) \
        .astype(np.float64)
    return (_bf16_step(big_g).T @ np.abs(big_x)
            + np.abs(big_g).T @ _bf16_step(big_x)) / WORLD


def _bf16_step_bound(ranks, name, l, p, step):
    """How far those roundings, at each step up to ``step``, can move a
    parameter or its momentum: step j's moves the update by lr_j *
    lr_mult * the flip (``_bf16_flip``), and the momentum carries it into
    each later update (momentum 0.9 < 1: at most step - j + 1 times)."""
    sp = SolverParameter(**SOLVER)
    lr_mult = _lr_mults(name)[l][p]
    return sum((step - j + 1) * learning_rate(sp, j - 1) * lr_mult
               * _bf16_flip(ranks, l, p, j) for j in range(1, step + 1))


def _bf16_residual_bound(rank, l, p, step):
    """How far those roundings can move a rank's TOPK residual: each
    step's rounding of what the rank sends stays in its residual, so
    roundings one step apart move it by one bf16 step of g + residual at
    most, a step (``rank``: the bf16 run's captures of that rank)."""
    return sum(_bf16_step(rank[f"grad{j}/{l}/{p}"])
               for j in range(1, step + 1))


def _bf16_wire_flips(res, ranks, ref, step, name, row):
    """The parameters whose value, momentum or (TOPK) residual is outside
    PARAM_TOL, the residual held against JAX's row ``row``: (how many,
    how many are allowed, the largest of |difference| - PARAM_TOL over
    the bound, where in the worst case)."""
    params, history, _, err = ref[step]
    n, worst, where = 0, 0.0, None
    n_params = sum(v.size for lv in params.values() for v in lv.values())
    for l, lv in params.items():
        for p in lv:
            outside = None
            kinds = [("params", params[l][p]), ("history", history[l][p])]
            if l in err:
                kinds.append(("err", err[l][p][row]))
            for kind, want in kinds:
                got = res[f"err{step}/{l}/{p}" if kind == "err"
                          else f"step{step}/{kind}/{l}/{p}"]
                diff = np.abs(got.astype(np.float64) - want)
                slack = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
                out = diff > slack
                outside = out if outside is None else outside | out
                if not out.any():
                    continue
                bound = (_bf16_residual_bound(ranks[row], l, p, step)
                         if kind == "err"
                         else _bf16_step_bound(ranks, name, l, p, step))
                ratio = (diff - slack)[out] / np.broadcast_to(
                    bound, diff.shape)[out]
                ratio = np.where(np.isfinite(ratio), ratio, np.inf)
                if ratio.max() > worst:
                    worst, where = float(ratio.max()), f"{kind} {l}/{p}"
            n += int(outside.sum())
    return n, int(BF16_FLIP_SHARE * n_params), worst, where


def _bf16_wire_within_allowance(res, ranks, ref, step, name, row, what):
    """(whether ``res`` holds PARAM_TOL but for at most BF16_FLIP_SHARE of
    the parameters, each within its bound, the reading as text)."""
    n, allowed, worst, where = _bf16_wire_flips(res, ranks, ref, step, name,
                                                row)
    ok = n <= allowed and worst <= 1.0
    return ok, (f"{what} after step {step}: {n} parameters outside "
                f"PARAM_TOL (allowed {allowed}), the worst excess "
                f"{worst:.3g} of its bf16 bound ({where})")


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_jax_two_device_mesh(dp_run, case):
    inputs, results = dp_run
    params, batches = inputs[case]
    if CASES[case].fields.get("default_strategy") == S.LOCAL:
        refs = [_jax_reference(case, params, batches, rank=r)
                for r in range(WORLD)]
    else:
        refs = [_jax_reference(case, params, batches)] * WORLD
    for r in range(WORLD):
        res, ref = results[case][r], refs[r]
        if refs[0] is refs[-1]:
            np.testing.assert_allclose(res["losses"][0], ref[1][2],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(res["losses"][-1], ref[STEPS][2],
                                       rtol=LOSS_RTOL)
        for step in (1, STEPS):
            if case in BF16_CASES:
                ok, reading = _bf16_wire_within_allowance(
                    res, results[case], ref, step, CASES[case].net, r,
                    f"{case} rank {r}")
                print(reading)
                assert ok, reading
            else:
                _assert_close(res, ref, step, f"{case} rank {r}")
            if case in TOPK_CASES and case not in BF16_CASES:
                _assert_residuals_close(res, ref, step, r, f"{case} rank {r}")
    assert results[case][0]["losses"][-1] != results[case][0]["losses"][0]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_wire_check_sees_a_dropped_cast(dp_run, case):
    """The same case with an f32 wire must fail the bf16-wire check."""
    inputs, results = dp_run
    ref = _jax_reference(case, *inputs[case])
    control = next(c for c, of in CONTROLS.items() if of == case)
    for r in range(WORLD):
        for step in (1, STEPS):
            ok, reading = _bf16_wire_within_allowance(
                results[control][r], results[case], ref, step,
                CASES[case].net, r, f"{control} rank {r}")
            print(reading)
            assert not ok, reading


def test_topk_check_sees_one_entry_more_sent(dp_run):
    """The topk case sending one entry more a leaf (k + 1) must miss JAX's
    at PARAM_TOL, in the params or their residual, after 1 and 3 steps:
    the parity check sees a single changed selection."""
    inputs, results = dp_run
    ref = _jax_reference("topk", *inputs["topk"])
    for r in range(WORLD):
        for step in (1, STEPS):
            res = results["topk_k_plus_one"][r]
            with pytest.raises(AssertionError):
                _assert_close(res, ref, step, "k + 1")
            with pytest.raises(AssertionError):
                _assert_residuals_close(res, ref, step, r, "k + 1")


@pytest.mark.parametrize("case", list(CASES))
def test_dp_ranks_end_bitwise_equal(dp_run, case):
    r0, r1 = dp_run[1][case]
    keys = [k for k in r0 if k.startswith("step")]
    same = all(np.array_equal(r0[k], r1[k]) for k in keys)
    if CASES[case].fields.get("default_strategy") == S.LOCAL:
        assert not same      # LOCAL replicas train on their own rows only
    else:
        assert same
        assert list(r0["losses"]) == list(r1["losses"])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c].fields.get("default_strategy")
                                  not in (S.LOCAL, S.DENSE_FUSED, S.TOPK)])
def test_dwbp_buckets_issued_in_order_during_backward(dp_run, case):
    for res in dp_run[1][case]:
        if case == "topk_layer":
            # the compressed layer rides no DENSE bucket: none waits on
            # its leaves, none covers the range TOPK writes afterwards
            layers = json.loads(str(res["bucket_layers"]))
            assert all("ip1" not in b for b in layers) and layers
        n = int(res["n_hooked"])
        first = [int(b) for b in res["first_buckets"]]
        assert n >= 1 and first == list(range(n - len(first), n))
        for k in range(STEPS):
            # DWBP order, every bucket once
            assert list(res["issued"][k]) == list(range(n))
            # every bucket without the first layer's leaves went out
            # before the first layer's backward started
            assert int(res["before_first"][k]) == n - len(first)
            assert int(res["mid"][k]) >= n - len(first)
    if case == "dense_per_leaf":
        assert n == 8 and len(first) == 2


def test_dense_fused_issues_nothing_during_backward(dp_run):
    for res in dp_run[1]["dense_fused"]:
        assert int(res["n_hooked"]) == 0
        assert all(list(i) == [] for i in res["issued"])


def test_sync_kinds_of_each_case(dp_run):
    kinds = {c: json.loads(str(dp_run[1][c][0]["kinds"])) for c in CASES}
    assert kinds["sfb"] == {"conv1": "dense", "conv2": "dense",
                            "ip1": "sfb", "ip2": "sfb"}
    # an SFB default puts the conv layers on the dense buckets, as JAX
    # taps them with a dense psum
    assert kinds["sfb_default"] == kinds["sfb"]
    assert kinds["sfb_auto"] == {"conv1": "dense", "conv2": "dense",
                                 "fc6": "sfb", "fc8": "dense"}
    assert set(kinds["local"].values()) == {"local"}
    assert kinds["topk_layer"] == {"conv1": "dense", "conv2": "dense",
                                   "ip1": "topk", "ip2": "dense"}
    assert set(kinds["topk"].values()) == {"topk"}


@pytest.mark.parametrize("name,rows", [("lenet", 4), ("lenet", 64),
                                       ("alexnet", 256), ("alexnet", 32)])
def test_auto_strategies_agree_with_jax(name, rows):
    if name == "alexnet":
        shapes = {"data": (rows, 3, 227, 227), "label": (rows,)}
        jnet = JaxNet(jax_load_net(ALEXNET_TRAIN), "TRAIN",
                      conv_layout="NCHW", source_shapes=shapes)
        net = Net(load_net(ALEXNET_TRAIN), "TRAIN", device="cpu",
                  source_shapes=shapes)
    else:
        jnet, net = _jax_net(name, rows), _port_net(name, rows)
    got = S.auto_strategies(net)
    assert got == JS.auto_strategies(jnet)
    if name == "alexnet" and rows == 256:
        assert got == {"fc6": "sfb", "fc7": "sfb", "fc8": "sfb"}


# --------------------------------------------------------------------- #
# pieces that need no second process

def test_plan_buckets_cover_each_synced_element_once():
    net = _port_net("narrow_alexnet")
    slots = net.arena_layout().slots
    kinds = {"fc8": S.DENSE, "fc6": S.SFB, "conv2": S.DENSE,
             "conv1": S.DENSE_FUSED}
    for mb in (0.0, 0.001, 0.004, 4.0):
        dense = S.plan_buckets(slots, kinds, S.DENSE, mb)
        covered = np.zeros(slots[-1].offset + slots[-1].size, np.int32)
        for b in dense:
            covered[b.lo:b.hi] += 1
            assert all(kinds[slots[i].layer] == S.DENSE for i in b.leaves)
        for i, s in enumerate(slots):
            want = 1 if kinds[s.layer] == S.DENSE else 0
            assert (covered[s.offset:s.offset + s.size] == want).all(), (mb, s)
        # DWBP order: ranges ascend through the arena (last layers first)
        assert [b.lo for b in dense] == sorted(b.lo for b in dense)
        if mb == 0.0:
            assert [(b.lo, b.hi) for b in dense] == [
                (s.offset, s.offset + s.size) for s in slots
                if kinds[s.layer] == S.DENSE]
    # fc8 and conv2 are not adjacent (fc6 sits between): two runs
    assert len(S.plan_buckets(slots, kinds, S.DENSE, 4.0)) == 2


def test_sync_bucket_size_follows_jax_flags():
    from poseidon_tpu_torch.runtime.cli import build_parser, comm_from_args

    def bucket_mb(*flags):
        return comm_from_args(build_parser().parse_args(
            ["train", "--solver=x", *flags])).bucket_mb

    assert S.CommConfig().bucket_mb == bucket_mb() == 4.0
    assert bucket_mb("--arena_bucket_mb", "-1") == -1
    assert bucket_mb("--arena_bucket_mb", "0.5") == 0.5
    assert bucket_mb("--param_arena", "false") == 0.0
    assert bucket_mb("--param_arena", "false", "--arena_bucket_mb", "2") == 0
    assert bucket_mb("--dwbp_bucket_mb", "2", "--param_arena", "false") == 2
    assert bucket_mb("--dwbp_bucket_mb", "0", "--arena_bucket_mb", "2") == 0


def test_wire_all_reduce_alone_is_the_jax_cast_chain():
    g = torch.tensor([1.0 + 2 ** -12, -3.0, 1e-3], dtype=torch.float32)
    solo = DataGroup.single("cpu")
    got = S.wire_all_reduce(g, solo, "mean", "bf16")
    assert torch.equal(got, g.to(torch.bfloat16).float())
    assert torch.equal(S.wire_all_reduce(g, solo, "sum", None), g)
    assert S.wire_all_reduce(g, solo, "sum", None) is not g


def test_sfb_matmul_alone_matches_autograd_of_linear():
    torch.manual_seed(0)
    x = torch.randn(5, 7, requires_grad=True)
    w = torch.randn(3, 7, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    cfg = S.CommConfig(layer_strategies={"ip": S.SFB})
    ctx = S.CommContext(cfg, DataGroup.single("cpu"),
                        {"ip": S.SFB, "other": S.DENSE})
    assert ctx.sfb_layers == {"ip"}
    y = ctx.inner_product(x, w, b)
    g = torch.randn(5, 3)
    got = torch.autograd.grad(y, (x, w, b), g)
    want = torch.autograd.grad(torch.nn.functional.linear(x, w, b),
                               (x, w, b), g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("what", ["int8", "server_logic"])
def test_unported_comm_raises_naming_its_roadmap_item(what):
    # both came with the async tier (ROADMAP queue A item 9): the int8 wire
    # is its delta format, refused by the compiled collectives as the JAX
    # CLI refuses it; the SSP server logics are accepted, others refused
    if what == "int8":
        with pytest.raises(ValueError, match="async tier's delta format"):
            S.CommConfig(wire_dtype="int8")
    else:
        c = S.CommConfig(server_logic="adarevision", adarev_init_step=0.2)
        assert (c.server_logic, c.adarev_init_step) == ("adarevision", 0.2)
        with pytest.raises(ValueError, match="unknown server_logic"):
            S.CommConfig(server_logic="nonesuch")


@pytest.mark.parametrize("flags", [["--comm_budget_mbps", "4"],
                                   ["--wire_dtype", "int8"],
                                   ["--server_logic", "adarevision"]])
def test_cli_unported_comm_flags_raise(flags):
    # the async tier's flags (ROADMAP queue A item 9), ported: each builds
    # what the JAX CLI builds, and int8 without --async_ssp exits as there
    from poseidon_tpu_torch.runtime.cli import (async_from_args,
                                                build_parser, comm_from_args)
    args = build_parser().parse_args(["train", "--solver=x"] + flags)
    if flags[0] == "--wire_dtype":
        with pytest.raises(SystemExit, match="managed-tier"):
            comm_from_args(args)
        args = build_parser().parse_args(
            ["train", "--solver=x", "--async_ssp"] + flags)
        assert comm_from_args(args).wire_dtype is None
        assert async_from_args(args)[1]["comm_wire_dtype"] == "int8"
        return
    c = comm_from_args(args)
    assert c.server_logic == ("adarevision" if "adarevision" in flags
                              else "inc")
    assert async_from_args(args) == (0, None)
    args = build_parser().parse_args(
        ["train", "--solver=x", "--async_ssp", "--staleness", "2"] + flags)
    staleness, cfg = async_from_args(args)
    assert staleness == 0 and cfg["staleness"] == 2
    assert cfg.get("comm_budget_mbps") == (4.0 if "4" in flags else None)


def test_cli_comm_flags_build_the_jax_config():
    from poseidon_tpu_torch.runtime.cli import build_parser, comm_from_args
    args = build_parser().parse_args(
        ["train", "--solver=x", "--strategy", "sfb", "--grad-reduce", "sum",
         "--wire_dtype", "bf16", "--dwbp_bucket_mb", "0",
         "--param_arena", "false", "--arena_bucket_mb", "2"])
    c = comm_from_args(args)
    assert (c.default_strategy, c.reduce, c.wire_dtype, c.bucket_mb) == (
        "sfb", "sum", "bf16", 0.0)
    auto = comm_from_args(build_parser().parse_args(
        ["train", "--solver=x", "--strategy", "sfb", "--sfb-auto"]))
    assert auto.default_strategy == "dense" and auto.wire_dtype is None
    assert auto.bucket_mb == 4.0


def test_backend_rule(monkeypatch):
    cpu = torch.device("cpu")
    assert cluster.choose_backend(cpu, 1, 2)[:2] == ("gloo", cpu)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    assert cluster.choose_backend(cuda, 0, 1)[:2] == (
        "nccl", torch.device("cuda", 0))
    # two ranks share the one card: gloo, both on cuda:0
    assert cluster.choose_backend(cuda, 1, 2)[:2] == (
        "gloo", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cluster.choose_backend(cuda, 3, 4)[:2] == (
        "nccl", torch.device("cuda", 3))
    assert cluster.init_method_of("10.0.0.1:1234") == "tcp://10.0.0.1:1234"
    assert cluster.init_method_of("file:///x/y") == "file:///x/y"


def test_env_world_and_single_process(monkeypatch):
    for k in ("POSEIDON_PROC_ID", "POSEIDON_NUM_PROCS",
              "POSEIDON_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert cluster.env_world() == (0, 1, None)
    solo = cluster.init_distributed(torch.device("cpu"))
    assert (solo.rank, solo.world, solo.distributed) == (0, 1, False)
    monkeypatch.setenv("POSEIDON_NUM_PROCS", "2")
    monkeypatch.setenv("POSEIDON_PROC_ID", "1")
    assert cluster.env_world() == (1, 2, None)
    with pytest.raises(ValueError, match="POSEIDON_COORDINATOR"):
        cluster.init_distributed(torch.device("cpu"))
    with pytest.raises(ValueError, match="outside"):
        cluster.init_distributed(torch.device("cpu"), rank=2)


def test_single_process_group_collectives_are_identities():
    solo = DataGroup.single("cpu")
    t = torch.arange(6.0).reshape(3, 2)
    assert solo.all_reduce_(t, async_op=True) is None
    assert torch.equal(t, torch.arange(6.0).reshape(3, 2))
    assert solo.all_gather(t) is t
    solo.broadcast_(t)
    solo.close()
    assert not solo.distributed and solo.world == 1


def test_rank_seeds_differ_and_rank_0_keeps_the_solver_seed():
    assert rank_seed(7, 0) == 7
    assert len({rank_seed(7, r) for r in range(8)}) == 8


def test_parse_hostfile(tmp_path):
    f = tmp_path / "hosts"
    f.write_text("# cluster\n0 10.0.0.1 9999\n1 10.0.0.2 9999\n")
    hosts = cluster.parse_hostfile(str(f))
    assert [(h.id, h.ip, h.port) for h in hosts] == [
        (0, "10.0.0.1", 9999), (1, "10.0.0.2", 9999)]
    f.write_text("1 10.0.0.1 9999\n")
    with pytest.raises(ValueError, match="0..N-1"):
        cluster.parse_hostfile(str(f))


# --------------------------------------------------------------------- #
# the CLI: two `train` processes under the launcher env contract

def test_cli_two_rank_sfb_training_on_cpu(tmp_path):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, LENET)}"\n'
        'test_iter: 1\ntest_interval: 4\nbase_lr: 0.01\nmomentum: 0.9\n'
        'weight_decay: 0.0005\nlr_policy: "inv"\ngamma: 0.0001\n'
        'power: 0.75\ndisplay: 2\nmax_iter: 4\nsnapshot: 2\n'
        'snapshot_prefix: "lenet"\n')
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, POSEIDON_PROC_ID=str(r),
                   POSEIDON_NUM_PROCS=str(WORLD),
                   POSEIDON_COORDINATOR=f"file://{tmp_path / 'store'}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "poseidon_tpu_torch", "train",
             f"--solver={solver}", "--output_dir", str(tmp_path / f"p{r}"),
             "--device", "cpu", "--strategy", "sfb"], cwd=REPO, env=env,
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
    assert "backend gloo" in logs[0] and "Iteration 4" in logs[0]
    assert "'ip1': 'sfb'" in logs[0] and "'conv1': 'dense'" in logs[0]
    # only rank 0 logs and writes the CSVs; every rank snapshots, as the
    # JAX engine does, and the replicas' snapshots are identical
    assert "Iteration" not in logs[1]
    assert (tmp_path / "p0" / "LeNet_train_outputs.csv").exists()
    assert not (tmp_path / "p1" / "LeNet_train_outputs.csv").exists()
    for it in (2, 4):
        a, b = (tmp_path / f"p{r}" / f"lenet_iter_{it}.solverstate.npz"
                for r in range(WORLD))
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert np.array_equal(za[k], zb[k]), k
        ma, mb = (tmp_path / f"p{r}" / f"lenet_iter_{it}.caffemodel"
                  for r in range(WORLD))
        assert ma.read_bytes() == mb.read_bytes()

