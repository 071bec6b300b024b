"""The port's measured collectives (``runtime/hlo_comm.py``) on the CPU.

One process acts as rank 0 of an n-rank world on PyTorch's fake backend
(``op_census.fake_world``): the step's collectives pass through the
dispatcher, where ``op_census`` records them, and move no data.

- the pure functions against the JAX package's on the same collectives;
- AlexNet's DWBP all-reduces at JAX's contract config (image 67, batch 8,
  4 MB buckets, 8 ranks) against JAX's golden (21), bucket by bucket
  against the port's plan, recorded while backward still runs;
- DENSE and SFB steps against the static table (``comm_stats``), exactly;
  the DENSE_FUSED and TOPK differences, op by op (ROADMAP queue C);
- SPMD steps: recorded against planned against ``spmd.CENSUS``, and a
  call site that forgets to count its collective shows up.

Tolerances: exact counts and bytes.
"""

import json
import os

import pytest

from poseidon_tpu.runtime import hlo_comm as JC

from poseidon_tpu_torch.analysis import contracts as C
from poseidon_tpu_torch.parallel import spmd
from poseidon_tpu_torch.parallel import strategies as S
from poseidon_tpu_torch.runtime import hlo_comm as HC
from poseidon_tpu_torch.runtime.comm_stats import (comm_summary,
                                                   layer_comm_table)
from poseidon_tpu_torch.runtime.op_census import fake_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COLLS = [
    ("all-reduce", "f32", (1000,), 4000, 8),
    ("all-reduce", "bf16", (1000,), 2000, 4),
    ("all-reduce", "f32", (), 4, 8),               # a metric scalar
    ("all-gather", "f32", (8, 500), 16000, 8),
    ("reduce-scatter", "f32", (4096,), 16384, 2),
    ("all-to-all", "s32", (8, 64), 2048, 8),
    ("collective-permute", "f32", (256,), 1024, 4),
    ("all-reduce", "f32", (1,), 4, 1),             # a trivial group
]


def _pair():
    ours = [HC.Collective(kind=k, dtype=d, shape=s, payload_bytes=b,
                          group_size=n, n_groups=1)
            for k, d, s, b, n in _COLLS]
    theirs = [JC.Collective(kind=k, dtype=d, shape=s, payload_bytes=b,
                            group_size=n, n_groups=1)
              for k, d, s, b, n in _COLLS]
    return ours, theirs


def test_pure_functions_are_jaxs():
    ours, theirs = _pair()
    assert [c.wire_bytes_per_device() for c in ours] == \
        [c.wire_bytes_per_device() for c in theirs]
    assert HC.measured_comm_summary(ours) == JC.measured_comm_summary(theirs)
    static = {"total_bytes_per_step": 12345}
    assert HC.compare_static_vs_measured(
        static, HC.measured_comm_summary(ours)) == \
        JC.compare_static_vs_measured(static,
                                      JC.measured_comm_summary(theirs))
    # JAX counts on program text: a module of the same all-reduces
    text = "\n".join(
        f"  %ar.{i} = {d}[{','.join(map(str, s))}]{{0}} all-reduce(%p), "
        f"replica_groups={{{{{','.join(map(str, range(n)))}}}}}"
        for i, (k, d, s, b, n) in enumerate(_COLLS) if k == "all-reduce")
    assert HC.count_gradient_all_reduces(ours, 1024) == \
        JC.count_gradient_all_reduces(text, 1024) == 2


@pytest.fixture(scope="module")
def alexnet_dp():
    with fake_world(8):
        records, facts = C.dp_step_records("alexnet")
    return records, facts


def test_alexnet_dwbp_buckets_equal_jaxs_golden(alexnet_dp):
    records, facts = alexnet_dp
    colls = HC.collectives(records)
    with open(os.path.join(REPO, "evidence", "hlo_contracts",
                           "alexnet.json")) as f:
        golden = json.load(f)
    assert golden["config"]["batch"] == 8 and \
        golden["config"]["arena_bucket_mb"] == 4.0
    assert HC.count_gradient_all_reduces(colls) == \
        golden["stablehlo"]["gradient_all_reduces"] == 21
    # bucket by bucket: the plan's hooked buckets, in order, each an
    # async all-reduce of its f32 range over all 8 ranks
    grads = [c for c in colls if c.kind == "all-reduce"
             and c.payload_bytes >= 1024]
    plan = facts["step"].sync.hooked
    assert [c.shape for c in grads] == [(b.hi - b.lo,) for b in plan]
    assert all(c.async_op and c.dtype == "f32" and c.group_size == 8
               and c.ranks == tuple(range(8)) for c in grads)


def test_buckets_are_recorded_while_backward_runs(alexnet_dp):
    """The buckets go out from the leaves' accumulation hooks, on
    autograd's thread: the census sees the first of them before the last
    layer's backward has run."""
    records, _ = alexnet_dp
    ops = [r.op for r in records]
    first_bucket = ops.index("c10d.allreduce_.default")
    last_conv_bwd = max(i for i, o in enumerate(ops)
                        if o == "aten.convolution_backward.default")
    assert first_bucket < last_conv_bwd


def _dp(comm, model="lenet"):
    with fake_world(8):
        records, facts = C.dp_step_records(model, comm=comm)
        static = comm_summary(layer_comm_table(facts["net"], comm,
                                               facts["step"].group))
    return HC.collectives(records), static, facts


@pytest.mark.parametrize("strategies", [{}, {"ip1": S.SFB}],
                         ids=["dense", "sfb"])
def test_dense_and_sfb_steps_send_what_the_static_table_bills(strategies):
    comm = S.CommConfig(bucket_mb=4.0, layer_strategies=dict(strategies))
    colls, static, _ = _dp(comm)
    row = HC.compare_static_vs_measured(static,
                                        HC.measured_comm_summary(colls))
    assert row["measured_over_static"] == 1.0, row


def test_dense_fused_layer_is_billed_nothing_but_sends_its_gradient():
    """The static table (the JAX package's rule) bills a DENSE_FUSED
    layer 0 bytes; the step all-reduces its gradient after backward, in
    f32, over 8 ranks."""
    comm = S.CommConfig(bucket_mb=4.0,
                        layer_strategies={"ip1": S.DENSE_FUSED})
    colls, static, facts = _dp(comm)
    measured = HC.measured_comm_summary(colls)
    fused = [c for c in colls if c.shape == (400500,)]
    assert len(fused) == 1 and fused[0].async_op
    ip1 = 500 * 800 + 500
    assert measured["measured_bytes_per_step"] - \
        static["total_bytes_per_step"] == int(2 * 7 / 8 * ip1 * 4)


def test_topk_sends_the_dense_masked_gradient_not_the_billed_entries():
    """TOPK: the table bills k (index, value) entries; the step
    all-reduces the whole masked gradient of each leaf, dense."""
    comm = S.CommConfig(bucket_mb=4.0, layer_strategies={"ip1": S.TOPK})
    colls, static, facts = _dp(comm)
    topk = [c for c in colls if not c.async_op and c.payload_bytes >= 1024]
    # one all-reduce a TOPK leaf (ip1's weight and bias), whole shape
    assert [c.shape for c in topk] == [(500, 800), (500,)]
    per_layer = layer_comm_table(facts["net"], comm, facts["step"].group)
    others = sum(r["ici_bytes_per_step"] for l, r in per_layer.items()
                 if l != "ip1")
    measured = HC.measured_comm_summary(colls)
    ip1_sent = measured["measured_bytes_per_step"] - others
    dense_ip1 = int(2 * 7 / 8 * (500 * 800 + 500) * 4)
    assert ip1_sent == dense_ip1
    assert per_layer["ip1"]["ici_bytes_per_step"] < dense_ip1 / 10


CENSUS_CASES = [
    ("dp2,fsdp2,tp2", {}),
    ("dp2,tp2", {"layer_strategies": {"ip2": S.TOPK}}),
    ("dp2,fsdp2", {"layer_strategies": {"ip1": S.SFB}}),
    ("dp2,tp2", {"param_arena": False}),
]


@pytest.mark.parametrize("spec,fields", CENSUS_CASES,
                         ids=[f"{s}-{i}" for i, (s, _) in
                              enumerate(CENSUS_CASES)])
def test_spmd_step_records_what_it_plans_and_counts(spec, fields):
    from poseidon_tpu_torch.config import MeshConfig
    comm = S.CommConfig(bucket_mb=4.0, **fields)
    with fake_world(MeshConfig.parse(spec).n_devices):
        m = C.mesh_step_records("lenet", spec, comm=comm)
    recorded = HC.collective_census(HC.collectives(m["records"]))
    assert recorded == m["schedule"]["counts"] == m["census"]["counts"], \
        (recorded, m["schedule"]["counts"], m["census"]["counts"])


def test_a_call_site_that_forgets_to_count_shows_up(monkeypatch):
    """A collective issued outside ``CENSUS.collective`` (here: the fsdp
    gradient reduce-scatter's count dropped) leaves CENSUS short of what
    the step really sent."""
    real = spmd.Census.collective

    def forgetful(self, name, kind, axis, elems):
        if kind == "reduce_scatter":
            import contextlib
            return contextlib.nullcontext()
        return real(self, name, kind, axis, elems)

    monkeypatch.setattr(spmd.Census, "collective", forgetful)
    with fake_world(8):
        m = C.mesh_step_records("lenet")
    recorded = HC.collective_census(HC.collectives(m["records"]))
    census = m["census"]["counts"]
    assert recorded["reduce_scatter"] == m["schedule"]["counts"][
        "reduce_scatter"] > 0
    assert census["reduce_scatter"] == 0
    assert {k: recorded[k] - census[k] for k in recorded} == {
        "all_reduce": 0, "reduce_scatter": recorded["reduce_scatter"],
        "all_gather": 0}


def test_collective_sequence_names_kind_group_shape_dtype():
    c = HC.Collective(kind="all-gather", dtype="bf16", shape=(4, 8),
                      payload_bytes=64, group_size=2, ranks=(0, 2))
    assert HC.collective_sequence([c]) == ["all-gather|0,2|4x8|bf16"]


def _digits_solver(tmp_path):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, "examples/digits/digits_train_test.prototxt")}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\ndisplay: 1\n'
        'max_iter: 2\ntest_iter: 1\ntest_interval: 2\n'
        'test_initialization: false\nsnapshot_prefix: "digits"\n')
    return solver


def test_train_census_writes_what_the_first_step_ran(tmp_path, capsys):
    from poseidon_tpu_torch.runtime import cli
    out = tmp_path / "out"
    assert cli.main(["train", "--solver", str(_digits_solver(tmp_path)),
                     "--output_dir", str(out), "--device", "cpu",
                     "--census"]) == 0
    doc = json.loads((out / "census.json").read_text())
    assert doc["iteration"] == 0 and doc["ops"] > 0
    # one process: no collective, the NCHW digits net converts nothing
    assert doc["collectives"] == [] and doc["dwbp_buckets"] == []
    assert doc["gradient_all_reduces"] == doc["layout_transposes"] == \
        doc["f64_tensors"] == 0
    assert "census: iteration 0:" in capsys.readouterr().out


def test_train_census_refuses_a_k_step_dispatch(tmp_path):
    from poseidon_tpu_torch.runtime import cli
    with pytest.raises(ValueError, match="--steps_per_dispatch 1"):
        cli.main(["train", "--solver", str(_digits_solver(tmp_path)),
                  "--output_dir", str(tmp_path / "o"), "--device", "cpu",
                  "--census", "--steps_per_dispatch", "2"])
