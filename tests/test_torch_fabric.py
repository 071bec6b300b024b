"""The port's two-tier fabric (``poseidon_tpu_torch/parallel/fabric.py``,
``train --async_ssp --slice --mesh``) against the JAX package's, on the
CPU. A counterpart of each test of ``tests/test_fabric.py``:

- the slice env contract (``runtime/cluster.slice_env``/``slice_world``)
  run through the JAX function and the port's on the same env: the same
  results, the same refusals; the port's backend rule (gloo ranks may
  share a device, NCCL ranks may not) and its per-slice rendezvous rule;
- ``two_tier_shard`` and ``slice_device_block`` equal to JAX's over a
  sweep; the arena-delta hooks bitwise, the packed LeNet arena equal to
  JAX's pack of the same params;
- ``resume_oplog``'s floor; shrink and retire below ``min_members``;
  leader failover exactly once through a severed ``FaultProxy`` link
  (power-of-two deltas: the anchor is the exact sum iff every (slice,
  clock) applied once); a slice-granularity run conformed by the model
  checker (``conform_service_events``);
- the two-slice chaos run (kill slice 1 at clock 2, re-admit it at 3):
  each slice's local step the port's one-device LeNet step in this
  process, the apply order pinned (each push applied before its
  refresh, slices dispatched in order), so the chaos anchor and losses
  are BITWISE the fixed-membership replay's; against JAX's chaos arm
  (dp2,fsdp2 sub-mesh steps, the same init and batches) every dispatch
  of either arm within PARAM_TOL (rtol 1e-4, atol 1e-6: XLA's and
  torch's CPU convs sum in other orders) of the other package's step
  from the same inputs, and the losses within 1e-5 (the free-running
  anchors part at a near-tie: the test's docstring);
- ``FabricTier``'s identity (the slice id, the roster in slices, the
  ledger mirrored after a push) and its two refusals.

And three more: a JAX slice leader and a port slice leader on one service
(either package's), bitwise with power-of-two deltas through a port
failover; ``train --async_ssp --slice --mesh fsdp2`` as 2 slices x 2 gloo
ranks of LeNet on the CPU (the apply order and each leader's refresh
pinned, so that every slice reads every slice's previous clock: the
in-process reference then takes the same path), whose members are
bitwise equal to their leader after every refresh, whose service events
conform to the model checker and whose anchor is bitwise that of two
in-process ``run_slice_worker`` slices fed the same two-tier shards in
the ranks' own arithmetic; and the CLI's refusals. Every socket is
loopback on an ephemeral port.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

from poseidon_tpu_torch.analysis import model_check as M  # noqa: E402
from poseidon_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from poseidon_tpu.core.net import Net as JaxNet  # noqa: E402
from poseidon_tpu.parallel import CommConfig as JaxCommConfig  # noqa: E402
from poseidon_tpu.parallel import async_ssp as JA  # noqa: E402
from poseidon_tpu.parallel import fabric as JF  # noqa: E402
from poseidon_tpu.parallel import init_train_state as jax_init_state  # noqa: E402,E501
from poseidon_tpu.parallel.spmd import (ShardingPlan as JaxPlan,  # noqa: E402
                                        build_spmd_train_step)
from poseidon_tpu.proto.messages import SolverParameter as JaxSolver  # noqa: E402,E501
from poseidon_tpu.proto.messages import load_net_from_string as jax_str  # noqa: E402,E501
from poseidon_tpu.runtime import cluster as JC  # noqa: E402

from poseidon_tpu_torch.config import (fabric_config,  # noqa: E402
                                       set_fabric_config)
from poseidon_tpu_torch.core.net import Net, params_from_jax  # noqa: E402
from poseidon_tpu_torch.data.pipeline import build_phase_pipelines  # noqa: E402,E501
from poseidon_tpu_torch.data.workload import Shard  # noqa: E402
from poseidon_tpu_torch.parallel import fabric as F  # noqa: E402
from poseidon_tpu_torch.parallel import trainer as T  # noqa: E402
from poseidon_tpu_torch.parallel.async_ssp import (  # noqa: E402
    AsyncSSPClient, ParamService, _tree_copy, _tree_sub)
from poseidon_tpu_torch.proto.messages import (  # noqa: E402
    SolverParameter, load_net, load_net_from_string)
from poseidon_tpu_torch.runtime import cluster as C  # noqa: E402
from poseidon_tpu_torch.runtime.faults import FaultProxy  # noqa: E402

pytestmark = pytest.mark.fabric

FAST = dict(heartbeat_s=0.1, reconnect_deadline_s=5.0,
            backoff_base_s=0.01, backoff_cap_s=0.1)
SLICE_VARS = ("POSEIDON_SLICE_ID", "POSEIDON_SLICE_SIZE",
              "POSEIDON_PROC_ID", "POSEIDON_NUM_PROCS")
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
LENET = "examples/mnist/lenet_train_test.prototxt"
WORKER_TIMEOUT_S = 60


def _clean_env(monkeypatch):
    for v in SLICE_VARS:
        monkeypatch.delenv(v, raising=False)


def _set_env(monkeypatch, **env):
    _clean_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(f"POSEIDON_{k}", str(v))


def _zeros(shape=(2, 2)):
    return {"fc": {"w": np.zeros(shape, np.float32)}}


def _delta(v, shape=(2, 2)):
    return {"fc": {"w": np.full(shape, v, np.float32)}}


def _wait_for(pred, timeout_s=15.0, what="condition"):
    deadline = time.time() + timeout_s
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _tree_equal(a, b, what=""):
    assert set(a) == set(b)
    for l in a:
        assert set(a[l]) == set(b[l])
        for k in a[l]:
            np.testing.assert_array_equal(
                np.asarray(a[l][k]), np.asarray(b[l][k]),
                err_msg=f"{what} {l}/{k}")


def _tree_close(a, b, what=""):
    assert set(a) == set(b)
    for l in a:
        for k in a[l]:
            np.testing.assert_allclose(
                np.asarray(a[l][k]), np.asarray(b[l][k]), **PARAM_TOL,
                err_msg=f"{what} {l}/{k}")


def _np_tree(tree):
    return {l: {p: (v.detach().cpu().numpy().copy()
                    if isinstance(v, torch.Tensor) else np.array(v))
                for p, v in lv.items()} for l, lv in tree.items()}


def _torch_tree(tree):
    return {l: {p: torch.from_numpy(np.array(v, np.float32))
                for p, v in lv.items()} for l, lv in tree.items()}


def _outcome(fn, **kw):
    """("ok", value) or ("refused", message): what a function gives."""
    try:
        return "ok", fn(**kw)
    except ValueError as e:
        return "refused", str(e)


def _assignment(sw):
    return None if sw is None else (dataclasses.astuple(sw), sw.is_leader,
                                    sw.is_joiner_slice)


def _both(name, **kw):
    """JAX's ``cluster.<name>`` and the port's on the current env: the
    same result (or the same refusal); returns it."""
    got = [_outcome(getattr(mod, name), **kw) for mod in (JC, C)]
    if name == "slice_world":
        got = [(k, _assignment(v) if k == "ok" else v) for k, v in got]
    assert got[0] == got[1], got
    return got[1]


# --------------------------------------------------------------------------- #
# the slice env contract (runtime/cluster.py), JAX's and the port's
# --------------------------------------------------------------------------- #

def test_slice_env_unset_is_plain_mode(monkeypatch):
    _clean_env(monkeypatch)
    assert _both("slice_env") == ("ok", None)
    assert _both("slice_world") == ("ok", None)


def test_slice_env_half_set_is_refused(monkeypatch):
    for var in ("SLICE_ID", "SLICE_SIZE"):
        _set_env(monkeypatch, **{var: 1})
        kind, msg = _both("slice_env")
        assert kind == "refused" and "all-or-nothing" in msg


@pytest.mark.parametrize("sid,size,visible,match", [
    (-1, 2, None, "must be >= 0"),
    (0, 0, None, "must be >= 1"),
    (0, 4, 2, "cannot share a device"),
    (0, 2, 2, None),
    (3, 1, None, None),
])
def test_slice_env_impossible_values_are_refused(monkeypatch, sid, size,
                                                 visible, match):
    _set_env(monkeypatch, SLICE_ID=sid, SLICE_SIZE=size)
    kind, res = _both("slice_env", n_visible_devices=visible)
    if match is None:
        assert (kind, res) == ("ok", (sid, size))
    else:
        assert kind == "refused" and match in res


def test_slice_devices_are_counted_by_the_backend_rule(monkeypatch):
    """gloo ranks (and CPU tensors) may share a device: no limit; NCCL
    ranks may not: the visible card count, and JAX's refusal past it."""
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert C.slice_device_limit(cpu) is None
    assert C.slice_device_limit(cpu, "nccl") is None
    assert C.slice_device_limit(card, "gloo") is None
    assert C.slice_device_limit(card) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert C.slice_device_limit(card, "nccl") == 1
    _set_env(monkeypatch, SLICE_ID=0, SLICE_SIZE=2, PROC_ID=0, NUM_PROCS=4)
    sw = C.slice_world(C.slice_device_limit(card, "gloo"))
    assert (sw.slice_size, sw.n_slices) == (2, 2)
    with pytest.raises(ValueError, match="cannot share a device"):
        C.slice_world(C.slice_device_limit(card, "nccl"))


def test_slice_world_contiguous_block_contract(monkeypatch):
    """slice k owns ranks [k*size, (k+1)*size); rank 0 of the block is
    the leader; a slice id past the roster is a joiner."""
    _set_env(monkeypatch, NUM_PROCS=4, SLICE_SIZE=2, SLICE_ID=1, PROC_ID=2)
    kind, (fields, leader, joiner) = _both("slice_world")
    assert fields == (1, 2, 0, 2) and leader and not joiner
    monkeypatch.setenv("POSEIDON_PROC_ID", "3")
    kind, (fields, leader, joiner) = _both("slice_world")
    assert fields[2] == 1 and not leader
    monkeypatch.setenv("POSEIDON_SLICE_ID", "2")
    monkeypatch.setenv("POSEIDON_PROC_ID", "4")
    kind, (fields, leader, joiner) = _both("slice_world")
    assert joiner and leader


def test_slice_world_refuses_overlap_and_orphan_ranks(monkeypatch):
    _set_env(monkeypatch, NUM_PROCS=4, SLICE_SIZE=2, SLICE_ID=1, PROC_ID=0)
    kind, msg = _both("slice_world")
    assert kind == "refused" and "overlapping slice assignment" in msg
    monkeypatch.setenv("POSEIDON_PROC_ID", "2")
    monkeypatch.setenv("POSEIDON_NUM_PROCS", "5")
    kind, msg = _both("slice_world")
    assert kind == "refused" and "whole number" in msg


def test_slice_rendezvous_rule():
    """Each slice rendezvouses at a store of its own: the coordinator's
    port + 2 + the slice id (port + 1 is the async service), or the
    file:// coordinator's path + .slice<k>."""
    assert C.slice_init_method("10.0.0.1:4000", 0) == "tcp://10.0.0.1:4002"
    assert C.slice_init_method("tcp://h:4000", 3) == "tcp://h:4005"
    assert C.slice_init_method("file:///tmp/s", 1) == "file:///tmp/s.slice1"
    with pytest.raises(ValueError, match="POSEIDON_COORDINATOR"):
        C.slice_init_method(None, 0)


# --------------------------------------------------------------------------- #
# two-tier sharding + the arena exchange hooks
# --------------------------------------------------------------------------- #

def test_two_tier_shard_composes_outer_and_inner_cuts():
    got = {F.two_tier_shard([0, 1], s, [0, 1], r)
           for s in (0, 1) for r in (0, 1)}
    assert got == {Shard(i, 4) for i in range(4)}
    assert F.two_tier_shard([0], 0, [0, 1], 1) == Shard(1, 2)
    assert F.two_tier_shard([0, 1], 0, [1], 1) == Shard(0, 2)
    with pytest.raises(ValueError):
        F.two_tier_shard([0, 1], 0, [0, 1], 7)
    # equal to JAX's over a sweep of memberships
    for slices in ([0], [0, 1], [1, 2, 5], [0, 3, 4, 7]):
        for members in ([0], [0, 1], [2, 3, 6], [0, 1, 2, 3]):
            for s in slices:
                for r in members:
                    a = F.two_tier_shard(slices, s, members, r)
                    b = JF.two_tier_shard(slices, s, members, r)
                    assert (a.index, a.count) == (b.index, b.count)


def test_slice_device_block_is_contiguous_and_bounded():
    devs = list(range(8))
    assert F.slice_device_block(devs, 0, 4) == [0, 1, 2, 3]
    assert F.slice_device_block(devs, 1, 4) == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="contiguous"):
        F.slice_device_block(devs, 2, 4)
    for n in range(1, 9):
        for sid in range(9):
            got = _outcome(F.slice_device_block, devices=devs,
                           slice_id=sid, n_devices=n)
            assert got == _outcome(JF.slice_device_block, devices=devs,
                                   slice_id=sid, n_devices=n)


class _TinyLayout:
    """A duck-typed layout: the hooks only need pack/unpack to be exact
    inverses."""

    def pack(self, tree):
        return np.concatenate([tree["a"]["w"].ravel(),
                               tree["b"]["w"].ravel()]).astype(np.float32)

    def unpack(self, flat):
        flat = np.asarray(flat, np.float32)
        return {"a": {"w": flat[:4].reshape(2, 2).copy()},
                "b": {"w": flat[4:6].copy()}}


def _lenet_text():
    with open(os.path.join(REPO, LENET)) as f:
        return f.read()


def _port_lenet(rows):
    return Net(load_net_from_string(_lenet_text()), "TRAIN", device="cpu",
               source_shapes={"data": (rows, 1, 28, 28), "label": (rows,)})


def _jax_lenet(rows):
    return JaxNet(jax_str(_lenet_text()), "TRAIN", conv_layout="NCHW",
                  source_shapes={"data": (rows, 1, 28, 28),
                                 "label": (rows,)})


def test_arena_delta_hooks_roundtrip_bitwise():
    layout = _TinyLayout()
    rng = np.random.RandomState(3)
    params = {"a": {"w": rng.randn(2, 2).astype(np.float32)},
              "b": {"w": rng.randn(2).astype(np.float32)}}
    prev = np.zeros(6, np.float32)
    delta, flat = F.pack_arena_delta(layout, params, prev)
    assert set(delta) == {"arena"} and F.arena_flat(delta).shape == (6,)
    np.testing.assert_array_equal(F.arena_flat(delta), flat - prev)
    np.testing.assert_array_equal(F.arena_flat(F.arena_tree(flat)), flat)
    _tree_equal(F.unpack_arena_cache(layout, F.arena_tree(flat)), params,
                "arena roundtrip")
    delta2, flat2 = F.pack_arena_delta(layout, params, flat)
    np.testing.assert_array_equal(F.arena_flat(delta2),
                                  np.zeros(6, np.float32))
    np.testing.assert_array_equal(flat2, flat)
    # the port's LeNet arena: its pack equals JAX's pack of the same
    # params, and the round trip through the port's layout is exact
    jnet, pnet = _jax_lenet(4), _port_lenet(4)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jnet.init(jax.random.PRNGKey(5)))
    pparams = params_from_jax(pnet, jparams)
    jlay, play = jnet.arena_layout(), pnet.arena_layout()
    prev = np.random.RandomState(1).randn(play.total).astype(np.float32)
    pd, pflat = F.pack_arena_delta(play, pparams, prev)
    jd, jflat = JF.pack_arena_delta(jlay, jparams, prev)
    np.testing.assert_array_equal(pflat, jflat)
    np.testing.assert_array_equal(F.arena_flat(pd), JF.arena_flat(jd))
    _tree_equal(_np_tree(F.unpack_arena_cache(play, F.arena_tree(pflat))),
                jparams, "port arena roundtrip")


# --------------------------------------------------------------------------- #
# resume_oplog: the failover primitive
# --------------------------------------------------------------------------- #

def test_resume_oplog_rederives_floor_and_replays_only_above_it():
    svc = ParamService(_zeros(), n_workers=1, liveness_timeout_s=0.0)
    addr = ("127.0.0.1", svc.port)
    d0, d1 = _delta(1.0), _delta(2.0)
    a = AsyncSSPClient(0, addr, 1, n_workers=1, **FAST)
    a.push(_tree_copy(d0))
    _wait_for(lambda: svc.clocks[0] >= 0, what="clock 0 applied")
    a.abandon()
    pending = [(0, _tree_copy(d0), True), (1, _tree_copy(d1), True)]
    b = AsyncSSPClient(0, addr, 1, n_workers=1, **FAST)
    try:
        floor = b.resume_oplog(1, pending, _tree_copy(d1))
        assert floor == 0 and b.clock == 1
        np.testing.assert_array_equal(b._residual["fc"]["w"],
                                      d1["fc"]["w"])
        _wait_for(lambda: svc.clocks[0] >= 1, what="replayed clock 1")
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"], np.full((2, 2), 3.0, np.float32))
        assert b.push(_delta(4.0)) == 2
        _wait_for(lambda: svc.clocks[0] >= 2, what="post-resume push")
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"], np.full((2, 2), 9.0, np.float32))
        b.mark_done()
    finally:
        b.close()
        svc.close()


# --------------------------------------------------------------------------- #
# slice membership events through run_slice_worker
# --------------------------------------------------------------------------- #

def _plus_one(cache, i):
    return ({l: {p: v + 1.0 for p, v in ps.items()}
             for l, ps in cache.items()}, 0.0)


def test_slice_shrink_recuts_inner_shard_and_keeps_training():
    svc = ParamService(_zeros(), n_workers=1, liveness_timeout_s=0.0)
    w = F.SliceWorker(0, [0, 1, 2], ("127.0.0.1", svc.port), 1,
                      n_slices=1, client_opts=FAST)
    try:
        assert w.data_shard([0], rank=2) == Shard(2, 3)
        out = F.run_slice_worker(w, _zeros(), _plus_one, n_clocks=3,
                                 fail_at={1: [1]})
        assert out["events"] == [(1, "shrunk:1")]
        assert out["failovers"] == 0 and not out["retired"]
        assert w.data_shard([0], rank=2) == Shard(1, 2)
        _wait_for(lambda: svc.clocks[0] >= 2, what="3 clocks applied")
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"], np.full((2, 2), 3.0, np.float32))
    finally:
        w.close()
        svc.close()


def test_slice_below_min_members_retires_cleanly():
    old_min = fabric_config().min_members
    set_fabric_config(min_members=2)
    svc = ParamService(_zeros(), n_workers=1, liveness_timeout_s=0.0)
    w = None
    try:
        w = F.SliceWorker(0, [0, 1], ("127.0.0.1", svc.port), 1,
                          n_slices=1, client_opts=FAST)
        out = F.run_slice_worker(w, _zeros(), _plus_one, n_clocks=4,
                                 fail_at={2: [0]})
        assert out["events"] == [(2, "retired:0")]
        assert out["retired"] and out["failovers"] == 1
        assert 0 in svc.retired
        _wait_for(lambda: svc.clocks[0] >= 1, what="pre-retire clocks")
        np.testing.assert_array_equal(
            svc.anchor["fc"]["w"], np.full((2, 2), 2.0, np.float32))
    finally:
        set_fabric_config(min_members=old_min)
        if w is not None:
            w.close()
        svc.close()


# --------------------------------------------------------------------------- #
# leader failover: exactly once across leader death
# --------------------------------------------------------------------------- #

def _failover_run(svc, workers, proxy, n_clocks, fail_slice):
    """Every slice pushes 2**(16 sid + clock) each clock; before clock 2
    ``fail_slice``'s leader links are severed and it fails over. Returns
    the applied (worker, clock) pairs."""
    for s in workers:
        s.join()
    for clock in range(n_clocks):
        if clock == 2:
            assert proxy.sever_group({fail_slice}) >= 1
            w = workers[fail_slice]
            assert w.fail_member(0) == "failover"
            assert w.leader == 1 and w.failovers == 1
        for sid, s in enumerate(workers):
            s.gate(clock, timeout_s=60)
            s.push(_delta(2.0 ** (sid * 16 + clock), shape=(1,)))
    _wait_for(lambda: svc.clocks == {0: n_clocks - 1, 1: n_clocks - 1},
              what="all slice clocks applied")
    expected = np.float32(sum(2.0 ** (sid * 16 + c)
                              for sid in (0, 1) for c in range(n_clocks)))
    got = svc.anchor["fc"]["w"][0]
    assert got == expected, (f"anchor {got!r} != {expected!r}: a delta "
                             f"was lost or applied twice")
    applied = [(e[1], e[2]) for e in svc.events
               if e[0] == "push" and not e[4]]
    assert len(applied) == len(set(applied)) == 2 * n_clocks
    assert workers[fail_slice].ledger.mirrors >= n_clocks + 1


def test_leader_failover_exactly_once_through_severed_links():
    svc = ParamService(_zeros((1,)), n_workers=2, record_events=True,
                       liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    slices = [F.SliceWorker(sid, [0, 1], proxy.addr, 1, n_slices=2,
                            client_opts=FAST) for sid in (0, 1)]
    try:
        _failover_run(svc, slices, proxy, 4, fail_slice=0)
    finally:
        for s in slices:
            s.close()
        proxy.close()
        svc.close()


@pytest.mark.parametrize("service", ["port", "jax"])
def test_jax_and_port_slice_leaders_share_one_service(service):
    """Slice 0 led by JAX's SliceWorker, slice 1 by the port's, on one
    service of either package: the port slice fails over through a
    severed link; the anchor is bitwise the exact power-of-two sum."""
    svc_cls = ParamService if service == "port" else JA.ParamService
    svc = svc_cls(_zeros((1,)), n_workers=2, record_events=True,
                  liveness_timeout_s=0.0)
    proxy = FaultProxy(("127.0.0.1", svc.port))
    slices = [JF.SliceWorker(0, [0, 1], proxy.addr, 1, n_slices=2,
                             client_opts=FAST),
              F.SliceWorker(1, [0, 1], proxy.addr, 1, n_slices=2,
                            client_opts=FAST)]
    try:
        _failover_run(svc, slices, proxy, 4, fail_slice=1)
    finally:
        for s in slices:
            s.close()
        proxy.close()
        svc.close()


# --------------------------------------------------------------------------- #
# protocol conformance at slice granularity
# --------------------------------------------------------------------------- #

def test_slice_granularity_run_conforms_to_protocol_model():
    svc = ParamService(_zeros(), n_workers=2, record_events=True)
    addr = ("127.0.0.1", svc.port)
    w0 = F.SliceWorker(0, [0, 1], addr, 0, n_slices=2, client_opts=FAST)
    w1 = F.SliceWorker(1, [0, 1], addr, 0, n_slices=2, client_opts=FAST)
    w2 = None
    try:
        for clock in range(2):
            for s in (w0, w1):
                s.gate(clock, timeout_s=60)
                s.push(_delta(1.0))
        w1.retire()
        _wait_for(lambda: svc.clocks[0] >= 1, what="roster clocks applied")
        w2 = F.SliceWorker(2, [0], addr, 0, n_slices=2, client_opts=FAST)
        cache, clocks = w2.join()
        assert w2.client.clock >= 1
        _tree_equal(cache, svc.anchor, "join anchor")
        for clock in range(2, 4):
            for s in (w0, w2):
                s.gate(clock, timeout_s=60)
                s.push(_delta(1.0))
        w0.mark_done()
        w2.mark_done()
        _wait_for(lambda: svc.clocks[0] >= 3, what="final clocks")
        counts = M.conform_service_events(list(svc.events), staleness=0,
                                          n_workers=2)
        assert counts["push"] >= 7
        assert counts["retire"] == 1
        assert counts["admit"] >= 1
    finally:
        for s in (w0, w1, w2):
            if s is not None:
                s.close()
        svc.close()


# --------------------------------------------------------------------------- #
# the chaos run: 2 slices, kill + re-admit, bitwise to the replay
# --------------------------------------------------------------------------- #

SP = dict(base_lr=0.01, lr_policy="fixed", momentum=0.9,
          weight_decay=0.0005)
BATCH = 16
N_CLOCKS = 5
KILL, REJOIN = 2, 3
STALE = 1


def _fabric_batch(slice_id, clock):
    rng = np.random.RandomState(123 + 17 * slice_id + clock)
    return {"data": rng.randn(BATCH, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, size=(BATCH,)).astype(np.float32)}


def _chaos_drive(pkg, dispatch_step, state0, init_np, chaos):
    """JAX's chaos/replay driver (``tests/test_fabric.py``) over either
    package's service and slice workers (``pkg``: (ParamService,
    SliceWorker, tree_copy, tree_sub)); ``dispatch_step(sid, cache,
    state, clock) -> (numpy params, state, loss)``."""
    service, worker, copy, sub = pkg
    svc = service(copy(init_np), n_workers=2, record_events=True,
                  liveness_timeout_s=0.0)
    addr = ("127.0.0.1", svc.port)
    sw = [worker(sid, [0, 1], addr, STALE, n_slices=2, client_opts=FAST)
          for sid in (0, 1)]
    caches = [c for c, _ in (sw[0].join(), sw[1].join())]
    states = [state0, state0]
    losses = {0: [], 1: []}

    def dispatch(sid, clock):
        w = sw[sid]
        w.gate(clock, timeout_s=60)
        prev = copy(caches[sid])
        caches[sid], states[sid], loss = dispatch_step(
            sid, caches[sid], states[sid], clock)
        losses[sid].append((clock, loss))
        pushed = w.push(sub(caches[sid], prev))
        # the apply order, pinned: this update is in the anchor before
        # the refresh, in both arms
        _wait_for(lambda: w.client.poll_view().get(sid, -1) >= pushed,
                  what=f"slice {sid} clock {pushed} applied")
        caches[sid], _ = w.refresh()

    try:
        for clock in range(N_CLOCKS):
            if chaos and clock == KILL:
                assert sw[1].fail_member(1) == "shrunk"
                assert sw[1].fail_member(0) == "dead"
                sw[1].client.abandon()
                _wait_for(lambda: 1 in svc.failed_workers,
                          what="slice 1 evicted")
            if clock == REJOIN:
                if chaos:
                    sw[1] = worker(1, [10, 11], addr, STALE, n_slices=2,
                                   client_opts=FAST)
                    caches[1], _ = sw[1].join()
                    assert sw[1].client.clock == KILL - 1
                else:
                    caches[1], _ = sw[1].refresh()
                states[1] = state0
            dispatch(0, clock)
            if not (KILL <= clock < REJOIN):
                dispatch(1, clock)
        sw[0].mark_done()
        sw[1].mark_done()
        _wait_for(lambda: svc.clocks[0] >= N_CLOCKS - 1,
                  what="final survivor clock")
        applied = [(e[1], e[2]) for e in svc.events
                   if e[0] == "push" and not e[4]]
        return {"anchor": copy(svc.anchor), "losses": losses,
                "applied": applied, "rejoins": svc.rejoins}
    finally:
        for s in sw:
            s.close()
        svc.close()


def _decisions_apart(pnet, japply, params, batch):
    """The forward decisions of LeNet (pool1 and pool2 argmaxes, relu1's
    signs) on which the port's net (16 rows) and JAX's (the sub-mesh's
    4-row shards) part, from the same params and batch."""
    import torch.nn.functional as TF
    pb = pnet.apply(_torch_tree(params),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    train=True, keep_blobs=True).blobs
    jb = {}
    for i in range(0, BATCH, BATCH // 4):
        rows = {"data": batch["data"][i:i + BATCH // 4],
                "label": batch["label"][i:i + BATCH // 4].astype(np.int32)}
        for k, v in japply(params, rows).items():
            jb.setdefault(k, []).append(np.asarray(v))
    apart = {}
    for conv, pool in (("conv1", "pool1"), ("conv2", "pool2")):
        idx = [TF.max_pool2d(x, 2, 2, return_indices=True)[1]
               for x in (pb[conv].detach(),
                         torch.from_numpy(np.concatenate(jb[conv])))]
        apart[pool] = int((idx[0] != idx[1]).sum())
    apart["relu1"] = int(((pb["ip1"].detach() > 0).numpy()
                          != (np.concatenate(jb["ip1"]) > 0)).sum())
    return {k: v for k, v in apart.items() if v}


def test_two_slice_chaos_bitwise_replay():
    """The port's chaos arm is bitwise its fixed-membership replay, every
    (slice, clock) applied once. Against JAX's chaos arm (its dp2,fsdp2
    sub-mesh steps, the same init and batches): every dispatch of either
    arm, re-run by the other package's step from the same params,
    momentum and batch, lands within PARAM_TOL unless the two packages'
    forwards part a decision on that input (a max-pool argmax or a ReLU
    sign: the ulps of XLA's and torch's convs decide a near-tie); the
    losses of the two arms within 1e-5. Measured: every dispatch within
    3e-8 but one, JAX's slice-0 clock-3 input, where one pool2 window's
    top two lie within conv2's ulps (3.8e-6 apart between the packages)
    and the outputs part by 2.6e-6; from there the free-running arms'
    inputs differ, so their anchors are not held at PARAM_TOL (they end
    2.3e-5 apart in conv2/w)."""
    jnet = _jax_lenet(BATCH // 4)
    params0 = jnet.init(jax.random.PRNGKey(0))
    init_np = _np_tree(jax.tree_util.tree_map(np.asarray, params0))
    sp = SolverParameter(**SP)
    # each slice's one-device LeNet step, and a probe step for the other
    # arm's inputs (a step's momentum lives in its own buffers)
    pnet = _port_lenet(BATCH)
    psteps = [T.build_train_step(_port_lenet(BATCH), sp) for _ in range(3)]
    pstate0 = T.init_train_state(_torch_tree(init_np))
    cfg = JaxMeshConfig.parse("dp2,fsdp2")
    comm = JaxCommConfig()
    plan = JaxPlan.build(jnet, cfg, comm)
    jsteps = [build_spmd_train_step(jnet, JaxSolver(**SP),
                                    JF.slice_submesh(cfg, sid), plan, comm,
                                    donate=False) for sid in (0, 1)]
    jstate0 = jax_init_state(params0, comm, plan.n_dp)
    japply = jax.jit(lambda p, b: jnet.apply(p, b, train=True,
                                             keep_blobs=True).blobs)

    def run_port(step, sid, cache, state, clock):
        b = _fabric_batch(sid, clock)
        p, s, m = step.step(_torch_tree(cache), state,
                            {k: torch.from_numpy(v) for k, v in b.items()})
        return _np_tree(p), s, float(m["loss"])

    def run_jax(sid, cache, state, clock):
        b = _fabric_batch(sid, clock)
        b["label"] = b["label"].astype(np.int32)
        p, s, m = jsteps[sid].step(
            cache, state, b,
            jax.random.fold_in(jax.random.PRNGKey(42), 100 * sid + clock))
        return _np_tree(jax.tree_util.tree_map(np.asarray, p)), s, \
            float(m["loss"])

    def history(state):
        return _np_tree(state.solver.history), int(state.solver.it)

    dispatches = []

    def port_step(sid, cache, state, clock):
        hist, it = history(state)
        out = run_port(psteps[sid], sid, cache, state, clock)
        js = jstate0._replace(solver=jstate0.solver._replace(
            it=it, history=jax.tree_util.tree_map(jax.numpy.asarray, hist)))
        dispatches.append((("port", sid, clock), _np_tree(cache), out[0],
                           run_jax(sid, cache, js, clock)[0]))
        return out

    def jax_step(sid, cache, state, clock):
        hist, it = history(state)
        out = run_jax(sid, cache, state, clock)
        ps = T.TrainState(solver=T.SolverState(
            it=it, history=_torch_tree(hist)), comm_error={})
        dispatches.append((("jax", sid, clock), _np_tree(cache),
                           run_port(psteps[2], sid, cache, ps, clock)[0],
                           out[0]))
        return out

    pkg = (ParamService, F.SliceWorker, _tree_copy, _tree_sub)
    chaos = _chaos_drive(pkg, port_step, pstate0, init_np, chaos=True)
    replay = _chaos_drive(pkg, lambda *a: run_port(psteps[a[0]], *a),
                          pstate0, init_np, chaos=False)
    assert len(chaos["applied"]) == len(set(chaos["applied"]))
    assert chaos["rejoins"] >= 1
    _tree_equal(chaos["anchor"], replay["anchor"], "chaos vs replay")
    assert all(np.isfinite(v) for ls in chaos["losses"].values()
               for _, v in ls)
    assert chaos["losses"] == replay["losses"]
    assert [c for c, _ in chaos["losses"][1]] == \
        [c for c in range(N_CLOCKS) if not (KILL <= c < REJOIN)]

    jpkg = (JA.ParamService, JF.SliceWorker, JA._tree_copy, JA._tree_sub)
    jchaos = _chaos_drive(jpkg, jax_step, jstate0, init_np, chaos=True)
    assert len(dispatches) == 2 * 9
    parted = {}
    for what, params, got, want in dispatches:
        apart = _decisions_apart(pnet, japply, params,
                                 _fabric_batch(*what[1:]))
        if apart:
            parted[what] = apart
            continue
        _tree_close(got, want, f"dispatch {what}, port vs JAX step")
    # the port's own arm parts no decision from JAX's
    assert not [w for w in parted if w[0] == "port"], parted
    for sid in (0, 1):
        got, want = chaos["losses"][sid], jchaos["losses"][sid]
        assert [c for c, _ in got] == [c for c, _ in want]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=LOSS_RTOL)


# --------------------------------------------------------------------------- #
# FabricTier: the engine hook (train --async_ssp --slice)
# --------------------------------------------------------------------------- #

def _tiny_step():
    net = _port_lenet(2)
    step = T.build_train_step(net, SolverParameter(**SP))
    step.load_weights(net.init(torch.Generator().manual_seed(1)))
    return step


def test_fabric_tier_leader_speaks_as_slice_id(monkeypatch):
    from poseidon_tpu_torch.runtime.async_tier import FabricTier
    _set_env(monkeypatch, NUM_PROCS=4, SLICE_SIZE=2, SLICE_ID=0, PROC_ID=0)
    monkeypatch.delenv("POSEIDON_ASYNC_SERVICE", raising=False)
    monkeypatch.delenv("POSEIDON_COORDINATOR", raising=False)
    step = _tiny_step()
    tier = FabricTier(step, staleness=1, service_port=0,
                      liveness_timeout_s=0.0)
    try:
        assert (tier.rank, tier.n_procs) == (0, 2)
        assert tier.slice_assignment.is_leader
        assert tier.service is not None and tier.service.n_workers == 2
        # the exchange is the one-leaf arena: the service's anchor is the
        # step's canonical arena
        total = step.arena.total
        np.testing.assert_array_equal(
            F.arena_flat(tier.service.anchor),
            step.flat_w.detach().numpy())
        assert tier.data_shard() == Shard(0, 2)
        tier.client.push(F.arena_tree(np.ones(total, np.float32)))
        tier._mirror()
        assert tier.ledger.mirrors == 1
        clock, pending, _ = tier.ledger.snapshot()
        assert clock == 0
        tier.client.mark_done()
    finally:
        tier.client.close()
        tier.service.close()


def test_fabric_tier_refuses_non_leader_and_missing_env(monkeypatch):
    from poseidon_tpu_torch.runtime.async_tier import FabricTier
    _clean_env(monkeypatch)
    step = _tiny_step()
    with pytest.raises(ValueError, match="requires the slice env"):
        FabricTier(step, staleness=1)
    _set_env(monkeypatch, NUM_PROCS=4, SLICE_SIZE=2, SLICE_ID=0, PROC_ID=1)
    with pytest.raises(ValueError, match="not the leader"):
        FabricTier(step, staleness=1)


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("flags,match", [
    (["--slice"], "it requires --async_ssp"),
    (["--async_ssp", "--mesh", "fsdp2"], "--slice"),
    (["--async_ssp", "--mesh", "dp2"], "--slice"),
])
def test_cli_refuses_slice_without_async_and_mesh_without_slice(flags,
                                                                 match):
    from poseidon_tpu_torch.runtime.cli import async_from_args, build_parser
    args = build_parser().parse_args(["train", "--solver=x", *flags])
    with pytest.raises(SystemExit, match=match):
        async_from_args(args)


def test_engine_refuses_a_mesh_under_async_without_slice():
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.runtime.engine import Engine
    with pytest.raises(ValueError, match="--slice"):
        Engine(SolverParameter(**SP), device="cpu",
               async_ssp={"staleness": 0}, mesh_cfg=MeshConfig(fsdp=2))


# the child `train` of the CLI run: every service records its events
# (dumped when main returns); each leader's join waits until every slice
# has joined (else a slice that starts late under load would join at an
# anchor that already holds another slice's first clock); slice w pushes
# clock c once every lower slice's clock c is applied (the apply order,
# pinned), and each leader's refresh after clock c waits until every
# slice's clock c is applied and, after it, until every slice has
# refreshed clock c: every slice then reads every slice's previous clock,
# the path the in-process reference takes
FABRIC_CHILD = """
import json, os, sys, time
from poseidon_tpu_torch.parallel import async_ssp as A
out, n = os.environ["FABRIC_TEST_DIR"], int(os.environ["FABRIC_TEST_SLICES"])
services = []
init = A.ParamService.__init__
def recording(self, *a, **kw):
    init(self, *a, **{**kw, "record_events": True})
    services.append(self)
A.ParamService.__init__ = recording
refresh = A.AsyncSSPClient.refresh
def wait(pred, what):
    deadline = time.time() + 60
    while not pred():
        if time.time() > deadline:
            raise TimeoutError(what)
        time.sleep(0.005)
def lockstep(self):
    c = self.clock
    wait(lambda: all(self.poll_view().get(w, -1) >= c for w in range(n)),
         f"clock {c} applied")
    res = refresh(self)
    open(os.path.join(out, f"refreshed.{self.worker}.{c}"), "w").close()
    wait(lambda: all(os.path.exists(os.path.join(out, f"refreshed.{w}.{c}"))
                     for w in range(n)), f"clock {c} refreshed")
    return res
A.AsyncSSPClient.refresh = lockstep
join = A.AsyncSSPClient.join
def joined(self, *a, **kw):
    res = join(self, *a, **kw)
    open(os.path.join(out, f"joined.{self.worker}"), "w").close()
    wait(lambda: all(os.path.exists(os.path.join(out, f"joined.{w}"))
                     for w in range(n)), "every slice joined")
    return res
A.AsyncSSPClient.join = joined
push = A.AsyncSSPClient.push
def ordered(self, delta, force_full=False):
    c = self.clock + 1
    wait(lambda: all(self.poll_view().get(w, -1) >= c
                     for w in range(self.worker)), f"clock {c} before")
    return push(self, delta, force_full)
A.AsyncSSPClient.push = ordered
from poseidon_tpu_torch.runtime.cli import main
rc = main(sys.argv[1:])
if services:
    with open(os.path.join(out, "events.json"), "w") as f:
        json.dump([list(e) for e in services[0].events], f,
                  default=lambda o: o.item())
sys.exit(rc)
"""
CLI_ITERS, CLI_SYNC = 6, 2


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_slices_of_two_fsdp_ranks(tmp_path, monkeypatch):
    """``train --async_ssp --slice --mesh fsdp2`` as 2 slices x 2 gloo
    ranks of LeNet: every rank exits 0; each leader speaks as its slice;
    every member's parameters are bitwise its leader's after every
    refresh; the service's events conform to the model checker; the final
    anchor (rank 0's snapshot) is bitwise that of two in-process
    ``run_slice_worker`` slices fed the same two-tier shards (within
    PARAM_TOL is the claim; bitwise holds because each in-process slice
    step takes the ranks' own arithmetic, one thread as the ranks, and
    the apply order is pinned in both)."""
    monkeypatch.chdir(REPO)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, LENET)}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 2\n'
        f'max_iter: {CLI_ITERS}\nsnapshot_prefix: "lenet"\n')
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, POSEIDON_PROC_ID=str(r),
                   POSEIDON_NUM_PROCS="4", POSEIDON_SLICE_SIZE="2",
                   POSEIDON_SLICE_ID=str(r // 2), OMP_NUM_THREADS="1",
                   POSEIDON_COORDINATOR=f"file://{tmp_path / 'store'}",
                   POSEIDON_ASYNC_SERVICE=f"127.0.0.1:{port}",
                   POSEIDON_FABRIC_DIGEST="1",
                   FABRIC_TEST_DIR=str(tmp_path), FABRIC_TEST_SLICES="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", FABRIC_CHILD, "train",
             f"--solver={solver}", "--output_dir", str(tmp_path / f"p{r}"),
             "--device", "cpu", "--async_ssp", "--slice", "--mesh",
             "fsdp2", "--staleness", "0", "--async_sync_every",
             str(CLI_SYNC), "--arena_bucket_mb", "0.1"], cwd=REPO, env=env,
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
    for s in (0, 1):
        assert (f"fabric tier: slice {s} of 2 (2 process(es)/slice"
                in logs[2 * s]), logs[2 * s]
        assert "backend gloo" in logs[2 * s]
    assert "sharding plan: mesh dp1,fsdp2,tp1" in logs[0]
    # members bitwise to their leader after every refresh (the join's,
    # one a clock, and slice 0's final anchor)
    for s in (0, 1):
        digests = [[ln.split()[-1] for ln in logs[2 * s + r].splitlines()
                    if ln.startswith(f"fabric digest: slice {s} ")]
                   for r in (0, 1)]
        assert digests[0] == digests[1], (s, digests)
        assert len(digests[0]) == 1 + CLI_ITERS // CLI_SYNC + (s == 0)
    events = [tuple(e) for e in json.loads(
        (tmp_path / "events.json").read_text())]
    counts = M.conform_service_events(events, staleness=0, n_workers=2)
    assert counts["push"] == 2 * CLI_ITERS // CLI_SYNC
    # roster slices: no admission; both slices done
    assert counts.get("admit", 0) == 0 and counts["done"] == 2, counts
    with np.load(tmp_path / "p0" / f"lenet_iter_{CLI_ITERS}"
                 ".solverstate.npz") as z:
        cli_anchor = {}
        for k in z.files:
            if k.startswith("params/"):
                layer, p = k[len("params/"):].split("\x1f")
                cli_anchor.setdefault(layer, {})[p] = z[k]
    _tree_equal(cli_anchor, _in_process_slices(), "CLI vs in-process")


class _FsdpSliceStep:
    """A 2-rank fsdp slice's step in one process, in the ranks' own
    arithmetic: each member's gradient of its own rows (the net a rank
    builds), the two summed and halved (the reduce-scatter, then the
    mean), one update over the arena with the one-device step's rule
    (elementwise, as the rank's update of its shard)."""

    def __init__(self, net_param, sp, rows):
        self.step = T.build_train_step(
            Net(net_param, "TRAIN", device="cpu",
                source_shapes={"data": (rows, 1, 28, 28),
                               "label": (rows,)}), sp)

    def __call__(self, params, state, member_batches):
        st = self.step
        with torch.no_grad():
            st.arena.pack(params, st.flat_w)
            st.arena.pack(state.solver.history, st.flat_h)
        grads = []
        for b in member_batches:
            with torch.no_grad():
                st.flat_g.zero_()
            st.net.apply(st._leaf_tree, b, train=True).loss.backward()
            grads.append(st.flat_g.clone())
        with torch.no_grad():
            torch.add(grads[0], grads[1], out=st.flat_g)
            st.flat_g.div_(len(grads))
            st._update(st.flat_w, st.flat_g, st.flat_h, state.solver.it)
        return st.params(), T.TrainState(
            solver=T.SolverState(it=state.solver.it + 1,
                                 history=st.arena.unpack(st.flat_h)),
            comm_error={})


def _in_process_slices():
    """Two in-process slices over a loopback service, each driven by
    ``run_slice_worker`` in a thread: the local step is
    ``_FsdpSliceStep`` on the slice's two members' shards of the LMDB
    (Shard(2s + i, 4)), 2 steps a clock; as in the CLI run, slice 1
    pushes clock c after slice 0's is applied, and each refresh waits for
    every slice's clock and then for every slice's refresh. Returns the
    final anchor."""
    net_param = load_net(os.path.join(REPO, LENET))
    batches = []
    for g in range(4):
        pipes, _ = build_phase_pipelines(net_param, "TRAIN",
                                         shard=Shard(g, 4))
        try:
            batches.append([{k: torch.from_numpy(v)
                             for k, v in next(pipes[0]).items()}
                            for _ in range(CLI_ITERS)])
        finally:
            for p in pipes:
                p.close()
    rows = batches[0][0]["data"].shape[0]
    sp = SolverParameter(base_lr=0.01, momentum=0.9, weight_decay=0.0005,
                         lr_policy="inv", gamma=0.0001, power=0.75)
    steps = [_FsdpSliceStep(net_param, sp, rows) for _ in (0, 1)]
    init = _np_tree(steps[0].step.net.init(torch.Generator().manual_seed(1)))
    svc = ParamService(_tree_copy(init), n_workers=2,
                       liveness_timeout_s=0.0)
    addr = ("127.0.0.1", svc.port)
    barrier = threading.Barrier(2, timeout=60)

    class Lockstep(F.SliceWorker):
        def push(self, delta, force_full=False):
            c = self.client.clock + 1
            _wait_for(lambda: all(self.client.poll_view().get(w, -1) >= c
                                  for w in range(self.slice_id)), 60,
                      f"clock {c} before slice {self.slice_id}")
            return super().push(delta, force_full)

        def refresh(self):
            c = self.client.clock
            _wait_for(lambda: all(self.client.poll_view().get(w, -1) >= c
                                  for w in (0, 1)), 60, f"clock {c}")
            out = super().refresh()
            barrier.wait()
            return out

    def drive(sid, results):
        state = [T.init_train_state(_torch_tree(init))]

        def local_step(cache, i):
            p, state[0] = steps[sid](_torch_tree(cache), state[0],
                                     [batches[2 * sid + m][i]
                                      for m in (0, 1)])
            return _np_tree(p), 0.0

        w = Lockstep(sid, [0, 1], addr, 0, n_slices=2, client_opts=FAST)
        try:
            results[sid] = F.run_slice_worker(
                w, init, local_step, n_clocks=CLI_ITERS // CLI_SYNC,
                sync_every=CLI_SYNC, join=True)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results[sid] = e
            barrier.abort()
        finally:
            w.close()

    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)     # the ranks' OMP_NUM_THREADS
    results = {}
    threads = [threading.Thread(target=drive, args=(sid, results))
               for sid in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for sid in (0, 1):
            assert not isinstance(results.get(sid), BaseException), \
                results.get(sid)
            assert len(results[sid]["losses"]) == CLI_ITERS
        _wait_for(lambda: svc.clocks == {0: 2, 1: 2}, what="final clocks")
        return _tree_copy(svc.anchor)
    finally:
        torch.set_num_threads(threads_before)
        svc.close()
