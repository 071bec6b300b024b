"""The bf16 training path of the port (``numeric.set_perf_policy``, ``train
--bf16``, ``train_lm --bf16``) against its own f32 path and against the
JAX package's bf16 path, on the CPU.

Tolerances, and why:

- LeNet, 30 steps on a fixed 4-batch cycle (JAX's
  ``tests/test_kernels.py`` guardrail): the mean of the last 5 bf16 losses
  within ``BF16_SMOKE_RTOL * |f32| + BF16_SMOKE_ATOL`` of the port's f32
  run, and within the same band of JAX's bf16 run from the same weights.
- A narrow AlexNet, 3 bf16 steps against JAX's under its bf16 policy, NCHW
  and NHWC: the losses within one bf16 rounding step (rtol 2^-7; measured
  equal); each parameter within 0.25 of its leaf's largest JAX update
  (measured <= 0.19, conv1's weight): the two frameworks round bf16
  activations, convolution sums and the bias add at other places, and the
  gradients' differences move with the updates.
- ``SFBMatmul`` under bf16 against JAX's ``_sfb_matmul`` on a one-device
  mesh: y and the input gradient one bf16 step (rtol 2^-7, atol 2^-9 of
  their scale); the weight gradient, exact products of bf16 operands
  summed in f32 by both, at rtol 1e-5, atol 1e-6.
- ``comm_stats`` bytes under bf16: equal to JAX's.
- A tiny transformer (d_head 8), 3 bf16 steps against JAX's
  ``build_dp_sp_train_step`` on a 1x1 mesh: losses rtol 1e-3, parameters
  within 0.05 of their leaf's largest update (measured 0.015): JAX's
  one-device step runs the ring formulation, whose score product rounds to
  bf16 before the f32 softmax; the port's flash path keeps the scores f32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from poseidon_tpu import config as jconfig
from poseidon_tpu.compat import shard_map
from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.models import transformer as jax_tf
from poseidon_tpu.parallel import strategies as JS
from poseidon_tpu.parallel.trainer import build_train_step as jax_step
from poseidon_tpu.parallel.trainer import init_train_state as jax_state
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu.runtime import comm_stats as JCS
from poseidon_tpu.solvers import updates as jax_upd
from poseidon_tpu_torch import numeric as tnum
from poseidon_tpu_torch.core.net import Net, params_from_jax
from poseidon_tpu_torch.models import train_lm as port_train_lm
from poseidon_tpu_torch.models import transformer as port_tf
from poseidon_tpu_torch.ops import flash
from poseidon_tpu_torch.parallel import strategies as S
from poseidon_tpu_torch.parallel.mesh import DataGroup
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto.messages import (SolverParameter, load_net,
                                               load_net_from_string)
from poseidon_tpu_torch.runtime import cli
from poseidon_tpu_torch.runtime import comm_stats as CS
from poseidon_tpu_torch.solvers import updates as port_upd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET = os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")
BF16_STEP = 2 ** -7
CNN_UPDATE_SHARE = 0.25
LM_LOSS_RTOL, LM_UPDATE_SHARE = 1e-3, 0.05


def _np(tree):
    return {l: {p: np.array(v) for p, v in d.items()} for l, d in
            tree.items()}


def _one_device_mesh(*axes):
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)), axes)


def _within_update_share(got, want, init, share, what):
    """Each leaf of ``got`` within ``share`` of the largest change JAX's
    steps made to that leaf."""
    for l in want:
        for p in want[l]:
            ref = np.asarray(want[l][p], np.float64)
            upd = np.abs(ref - np.asarray(init[l][p], np.float64)).max()
            diff = np.abs(np.asarray(got[l][p], np.float64) - ref).max()
            assert diff <= share * upd + 1e-7, (
                f"{what} {l}/{p}: {diff} apart, {diff / upd:.3f} of the "
                f"largest update {upd}")


# --------------------------------------------------------------------------- #
# LeNet: the BF16_SMOKE band
# --------------------------------------------------------------------------- #

_LENET_SHAPES = {"data": (16, 1, 28, 28), "label": (16,)}
_LENET_SOLVER = dict(base_lr=0.005, lr_policy="fixed", momentum=0.9,
                     weight_decay=0.0005)


def _lenet_data():
    rs = np.random.RandomState(7)
    return (rs.randn(4, 16, 1, 28, 28).astype(np.float32),
            rs.randint(0, 10, size=(4, 16)).astype(np.float32))


def _port_lenet_losses(init, iters, **policy):
    data, labels = _lenet_data()
    with tnum.policy_scope(**policy):
        net = Net(load_net(LENET), "TRAIN", device="cpu",
                  source_shapes=_LENET_SHAPES)
        step = build_train_step(net, SolverParameter(**_LENET_SOLVER))
        params = params_from_jax(net, init)
        params, state = step.load(params, init_train_state(params))
        losses = []
        for i in range(iters):
            batch = {"data": torch.from_numpy(data[i % 4]),
                     "label": torch.from_numpy(labels[i % 4])}
            params, state, m = step.step(params, state, batch)
            losses.append(float(m["loss"]))
    return losses


def _jax_lenet_losses(init, iters):
    data, labels = _lenet_data()
    with jconfig.policy_scope(compute_dtype=jnp.bfloat16, conv_s2d=True):
        jnet = JaxNet(jax_load_net(LENET), "TRAIN", conv_layout="NCHW",
                      source_shapes=_LENET_SHAPES)
        ts = jax_step(jnet, JaxSolver(**_LENET_SOLVER),
                      _one_device_mesh("data"), donate=False)
        params, state = init, jax_state(init)
        losses = []
        for i in range(iters):
            batch = {"data": jnp.asarray(data[i % 4]),
                     "label": jnp.asarray(labels[i % 4])}
            params, state, m = ts.step(params, state, batch,
                                       jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
    return losses


def test_bf16_lenet_smoke_within_documented_band():
    jnet = JaxNet(jax_load_net(LENET), "TRAIN", conv_layout="NCHW",
                  source_shapes=_LENET_SHAPES)
    init = _np(jnet.init(jax.random.PRNGKey(0)))
    iters = tnum.BF16_SMOKE_ITERS
    f32 = _port_lenet_losses(init, iters)
    bf16 = _port_lenet_losses(init, iters, compute_dtype=torch.bfloat16,
                              conv_s2d=True)
    jbf16 = _jax_lenet_losses(init, iters)
    assert all(np.isfinite(bf16)), "bf16 run diverged"
    tails = {k: float(np.mean(v[-5:])) for k, v in
             (("f32", f32), ("bf16", bf16), ("jax", jbf16))}
    band = lambda ref: tnum.BF16_SMOKE_RTOL * abs(ref) + \
        tnum.BF16_SMOKE_ATOL  # noqa: E731
    assert abs(tails["bf16"] - tails["f32"]) <= band(tails["f32"]), tails
    assert abs(tails["bf16"] - tails["jax"]) <= band(tails["jax"]), tails
    assert tails["f32"] < float(np.mean(f32[:3]))
    assert tails["bf16"] < float(np.mean(bf16[:3]))
    # the two runs did differ: bf16 was on
    assert f32 != bf16


# --------------------------------------------------------------------------- #
# a 3-step bf16 CNN step against JAX's
# --------------------------------------------------------------------------- #

from test_torch_layout import (NARROW_ALEXNET, _run_jax,  # noqa: E402
                               _run_port, _torch_batches)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_bf16_cnn_three_steps_match_jax(layout):
    jnet = JaxNet(jax_load_str(NARROW_ALEXNET), "TRAIN", conv_layout=layout)
    init = _np(jnet.init(jax.random.PRNGKey(3)))
    batches = _torch_batches(3, seed=4)
    with jconfig.policy_scope(compute_dtype=jnp.bfloat16):
        jp, js, jl = _run_jax(jnet, _np(init), batches)
    with tnum.policy_scope(compute_dtype=torch.bfloat16):
        net = Net(load_net_from_string(NARROW_ALEXNET), "TRAIN",
                  device="cpu", conv_layout=layout)
        pp, ps, pl, step = _run_port(net, params_from_jax(net, init),
                                     batches)
        out = net.apply(pp, {k: torch.from_numpy(v)
                             for k, v in batches[0].items()},
                        train=True, keep_blobs=True)
    np.testing.assert_allclose(pl, jl, rtol=BF16_STEP)
    # the loss comes from bf16 logits, as JAX's
    assert all(float(torch.tensor(v).bfloat16()) == v for v in pl)
    _within_update_share(pp, jp, init, CNN_UPDATE_SHARE, "param")
    # activations bf16; parameters, momentum and the arena f32, canonical
    for name in ("conv1", "norm1", "pool1", "conv3", "fc6", "fc8"):
        assert out.blobs[name].dtype == torch.bfloat16, name
    assert step.flat_w.dtype == step.flat_g.dtype == torch.float32
    assert step.flat_h.dtype == torch.float32
    for l in pp:
        for p in pp[l]:
            assert pp[l][p].dtype == torch.float32
            assert ps.solver.history[l][p].dtype == torch.float32
            assert pp[l][p].is_contiguous()


# --------------------------------------------------------------------------- #
# SFB under bf16
# --------------------------------------------------------------------------- #

def test_sfb_matmul_bf16_matches_jax():
    rs = np.random.RandomState(12)
    x2 = rs.randn(6, 20).astype(np.float32)
    w = (rs.randn(9, 20) / 4).astype(np.float32)
    b = rs.randn(9).astype(np.float32)
    g = rs.randn(6, 9).astype(np.float32)
    with jconfig.policy_scope(compute_dtype=jnp.bfloat16):
        fn = JS._sfb_matmul(("data",), "mean", True, None)

        def run(x_, w_, b_, g_):
            y, vjp = jax.vjp(fn, x_, w_, b_)
            return (y, *vjp(g_))

        jy, jgx, jgw, jgb = shard_map(
            run, _one_device_mesh("data"), in_specs=(P(),) * 4,
            out_specs=(P(),) * 4)(jnp.asarray(x2, jnp.bfloat16),
                                  jnp.asarray(w), jnp.asarray(b),
                                  jnp.asarray(g, jnp.bfloat16))
    with tnum.policy_scope(compute_dtype=torch.bfloat16):
        ctx = S.CommContext(S.CommConfig(), DataGroup.single("cpu"),
                            {"fc": S.SFB})
        xt = torch.from_numpy(x2).bfloat16().requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        y = ctx.inner_product(xt, wt, bt)
        y.backward(torch.from_numpy(g).bfloat16())
    assert y.dtype == xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == bt.grad.dtype == torch.float32

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    for got, want, what in ((y, jy, "y"), (xt.grad, jgx, "gx")):
        want = f32(want)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=BF16_STEP,
                                   atol=2 ** -9 * np.abs(want).max(),
                                   err_msg=what)
    np.testing.assert_allclose(wt.grad.numpy(), f32(jgw), rtol=1e-5,
                               atol=1e-6, err_msg="gw")
    np.testing.assert_allclose(bt.grad.numpy(), f32(jgb), rtol=BF16_STEP,
                               atol=1e-6, err_msg="gb")


# --------------------------------------------------------------------------- #
# comm_stats under bf16
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("strategy", ["dense", "sfb", "topk"])
@pytest.mark.parametrize("shape", [{"data": 8}, {"dcn": 2, "data": 4}])
def test_comm_stats_bytes_under_bf16_equal_jax(strategy, shape):
    text = NARROW_ALEXNET
    net = Net(load_net_from_string(text), "TRAIN", device="cpu")
    jnet = JaxNet(jax_load_str(text), "TRAIN", conv_layout="NCHW")
    dcn = "dcn" if "dcn" in shape else None
    comm = S.CommConfig(default_strategy=strategy, dcn_axis=dcn)
    jcomm = JS.CommConfig(default_strategy=strategy, dcn_axis=dcn)
    with tnum.policy_scope(compute_dtype=torch.bfloat16):
        got = CS.layer_comm_table(net, comm, shape)
    with jconfig.policy_scope(compute_dtype=jnp.bfloat16):
        want = JCS.layer_comm_table(jnet, jcomm, shape)
    f32 = CS.layer_comm_table(net, comm, shape)
    for layer, row in want.items():
        assert {k: v for k, v in got[layer].items() if k != "est_comm_ms"} \
            == {k: v for k, v in row.items() if k != "est_comm_ms"}, layer
    # gradients are counted at 2 bytes, not f32's 4
    assert got["fc6"]["dense_alternative_bytes"] * 2 == \
        f32["fc6"]["dense_alternative_bytes"]


# --------------------------------------------------------------------------- #
# the LM: a tiny transformer's bf16 step against JAX's
# --------------------------------------------------------------------------- #

VOCAB = 64
LM_SOLVER = dict(base_lr=0.1, lr_policy="fixed", momentum=0.9,
                 weight_decay=5e-4)


def _lm_batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (2, 16)).astype(np.int32),
            rs.randint(0, VOCAB, (2, 16)).astype(np.int32))


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_lm_three_steps_match_jax(remat, monkeypatch):
    kw = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, d_ff=128,
              max_seq=16, remat=remat)
    jcfg, pcfg = jax_tf.TransformerConfig(**kw), port_tf.TransformerConfig(**kw)
    init = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = init
    with jconfig.policy_scope(compute_dtype=jnp.bfloat16):
        jstep = jax_tf.build_dp_sp_train_step(
            jcfg, JaxSolver(**LM_SOLVER), _one_device_mesh("data", "seq"),
            donate=False)
        jstate = jax_upd.init_state(jp)
        jl = []
        for i in range(3):
            t, g = _lm_batch(10 + i)
            jp, jstate, m = jstep(jp, jstate, jnp.asarray(t), jnp.asarray(g),
                                  jax.random.PRNGKey(i))
            jl.append(float(m["loss"]))
    seen = []
    plain = flash.flash_attention_fwd_plain

    def spy(q, k, v, *a, **kw_):
        seen.append(q.dtype)
        return plain(q, k, v, *a, **kw_)

    monkeypatch.setattr(flash, "flash_attention_fwd_plain", spy)
    pp = port_tf.params_from_jax(init)
    pstate = port_upd.init_state(pp)
    pl = []
    with tnum.policy_scope(compute_dtype=torch.bfloat16):
        pstep = port_tf.build_dp_sp_train_step(pcfg, SolverParameter(
            **LM_SOLVER), "cpu")
        for i in range(3):
            t, g = _lm_batch(10 + i)
            pp, pstate, m = pstep(pp, pstate, torch.from_numpy(t),
                                  torch.from_numpy(g))
            pl.append(float(m["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=LM_LOSS_RTOL)
    _within_update_share({n: {l: v.numpy() for l, v in d.items()}
                          for n, d in pp.items()}, jp, init,
                         LM_UPDATE_SHARE, "lm param")
    # q, k and v reached the flash Function as bf16; params stayed f32
    assert seen and set(seen) == {torch.bfloat16}
    assert all(v.dtype == torch.float32 for d in pp.values()
               for v in d.values())


# --------------------------------------------------------------------------- #
# the command lines at toy size
# --------------------------------------------------------------------------- #

def test_train_lm_bf16_runs_on_cpu(capsys):
    before = dataclasses.replace(tnum.policy())
    port_train_lm.main(["--device", "cpu", "--bf16", "--steps", "4",
                        "--seq", "32", "--batch", "2", "--d_model", "32",
                        "--display", "2", "--generate", "4"])
    out = capsys.readouterr().out
    assert "bf16 compute" in out and out.endswith("done\n")
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert losses and all(np.isfinite(losses))
    assert tnum.policy() == before


def test_train_cli_bf16_nhwc_runs_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{LENET}"\n'
        'test_iter: 1\ntest_interval: 3\nbase_lr: 0.01\nmomentum: 0.9\n'
        'weight_decay: 0.0005\nlr_policy: "inv"\ngamma: 0.0001\n'
        'power: 0.75\ndisplay: 3\nmax_iter: 3\n'
        f'snapshot_prefix: "{tmp_path / "lenet"}"\n')
    before = dataclasses.replace(tnum.policy())
    rc = cli.main(["train", f"--solver={solver}", "--output_dir",
                   str(tmp_path), "--device", "cpu", "--bf16",
                   "--conv_layout", "nhwc", "--conv_strategy", "direct"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "numeric policy: compute bfloat16" in out
    assert "conv_layout NHWC" in out and "conv_strategy direct" in out
    assert "Iteration 3" in out
    assert (tmp_path / "lenet_iter_3.caffemodel").exists()
    # the policy held for the command only
    assert tnum.policy() == before


def test_train_flags_parse_to_the_policy():
    parse = cli.build_parser().parse_args
    args = parse(["train", "--solver=s"])
    assert cli.train_policy(args) == {"conv_layout": "AUTO"}
    args = parse(["train", "--solver=s", "--bf16", "--conv_layout", "NCHW",
                  "--conv_strategy", "s2d"])
    assert cli.train_policy(args) == {
        "conv_layout": "NCHW", "compute_dtype": torch.bfloat16,
        "conv_s2d": True, "conv_strategy": "s2d"}
    for bad in (["--conv_layout", "nwhc"], ["--conv_strategy", "auto"],
                ["--conv_strategy", "im2col"]):
        with pytest.raises(SystemExit):
            parse(["train", "--solver=s", *bad])
