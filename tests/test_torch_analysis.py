"""The port's static guardrails (``python -m poseidon_tpu_torch.analysis``):
the lints, the step contracts and the CLI's exit codes, on the CPU.

- the shipped tree exits 0 (every finding is baselined with a reason);
  a seeded race exits 1, a seeded contract diff 2, a usage error 3, a
  gate that fails to run 4;
- the step contracts, measured fresh, equal the port's goldens, and the
  counts JAX's goldens pin equal the JAX package's: the DWBP all-reduces
  (LeNet 1, AlexNet 21, GoogLeNet 11), the dp2,fsdp2,tp2 schedule, and
  the channels-last AlexNet's fc6 pair (beside the port's five filter
  copies, ROADMAP queue C);
- every JIT and THR rule fires on a fixture, mapped to what the port
  runs; the checkpointed layer body opens its layer's range (the JIT106
  repair), seen in a profiler trace.

Tolerances: exact counts.
"""

import json
import os
import textwrap
from types import SimpleNamespace

import pytest
import torch

from poseidon_tpu_torch.analysis import stale_baseline
from poseidon_tpu_torch.analysis import contracts as C
from poseidon_tpu_torch.analysis import jit_hygiene as J
from poseidon_tpu_torch.analysis import threads as T
from poseidon_tpu_torch.analysis.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_golden(model):
    with open(os.path.join(REPO, "evidence", "hlo_contracts",
                           f"{model}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fresh():
    return {m: C.build_contract(m) for m in C.MODELS}


# --------------------------------------------------------------------- #
# the shipped tree and the CLI's exit codes

@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    """One run of the CLI over the shipped tree: (exit code, its JSON
    report of every finding, new or baselined)."""
    report = tmp_path_factory.mktemp("lint") / "report.json"
    rc = main(["--report", str(report)])
    return rc, json.loads(report.read_text())


@pytest.fixture
def clean_file(tmp_path):
    """A file with nothing to lint: the CLI calls that test the contract
    gates lint only it."""
    f = tmp_path / "clean.py"
    f.write_text("X = 1\n")
    return str(f)


def test_shipped_tree_lints_clean_against_the_baseline(shipped):
    rc, report = shipped
    assert rc == 0 and report["new"] == 0
    assert all(f["baselined"] for f in report["findings"])


def test_every_baseline_entry_has_a_reason_and_still_fires(shipped):
    fired = [SimpleNamespace(fingerprint=f["fingerprint"])
             for f in shipped[1]["findings"]]
    assert stale_baseline(fired) == []


RACY = '''
import threading

class Pump:
    def __init__(self):
        self.n = 0
        self._t = threading.Thread(target=self._loop)
        self._t.start()

    def _loop(self):
        while True:
            self.n += 1

    def count(self):
        return self.n
'''


def test_a_seeded_race_exits_1(tmp_path, capsys):
    f = tmp_path / "racy.py"
    f.write_text(textwrap.dedent(RACY))
    assert main([str(f)]) == 1
    assert "THR004" in capsys.readouterr().out


def test_a_seeded_contract_diff_exits_2(fresh, monkeypatch, capsys,
                                       clean_file):
    bad = json.loads(json.dumps(fresh["lenet"]))
    bad["step"]["gradient_all_reduces"] += 1
    monkeypatch.setattr(C, "build_contract", lambda m: bad)
    assert main(["--contracts", "lenet", clean_file]) == 2
    assert "step.gradient_all_reduces" in capsys.readouterr().out


def test_a_usage_error_exits_3(clean_file):
    for argv in (["--contracts", "resnet", clean_file],
                 ["--contracts", ",", clean_file], ["/no/such/file.py"],
                 ["--write-baseline", "--rules", "THR001", clean_file]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 3, argv


def test_a_gate_that_fails_to_run_exits_4(monkeypatch, tmp_path,
                                          clean_file):
    def broken(model):
        raise RuntimeError("no fake backend")
    monkeypatch.setattr(C, "build_contract", broken)
    report = tmp_path / "report.json"
    assert main(["--contracts", "lenet", "--report", str(report),
                 clean_file]) == 4
    assert "no fake backend" in json.loads(report.read_text())[
        "contracts_error"]


# --------------------------------------------------------------------- #
# the step contracts

@pytest.mark.parametrize("model", C.MODELS)
def test_fresh_contract_equals_the_golden(fresh, model):
    ok, diffs = C.check_model(model, fresh[model])
    assert ok, diffs


@pytest.mark.parametrize("model", C.MODELS)
def test_dwbp_all_reduces_and_f64_equal_jaxs_goldens(fresh, model):
    ours, theirs = fresh[model], _jax_golden(model)
    assert ours["config"]["batch"] == theirs["config"]["batch"] == 8
    assert ours["step"]["gradient_all_reduces"] == \
        theirs["stablehlo"]["gradient_all_reduces"]
    assert ours["step"]["f64_tensors"] == \
        theirs["stablehlo"]["f64_tensors"] == 0
    # the counterpart of donation: params and momentum updated in place
    assert ours["step"]["in_place"] == {"params": True, "momentum": True}
    assert ours["step"]["layout_transposes"] == \
        theirs["stablehlo"]["layout_transposes"] == 0


@pytest.mark.parametrize("model", ["lenet", "alexnet"])
def test_mesh_schedule_equals_jaxs_golden(fresh, model):
    ours = fresh[model]["collective_schedule"]
    theirs = _jax_golden(model)["collective_schedule"]
    for key in ("mesh", "arena_buckets", "tp_modes", "planned_counts"):
        assert ours[key] == theirs[key], key
    assert ours["recorded_counts"] == ours["planned_counts"] == \
        ours["census_counts"]
    assert ours["planned_matches_recorded"]


def test_channels_last_alexnet_is_jaxs_pair_plus_five_filter_copies(fresh):
    nhwc = fresh["alexnet"]["nhwc"]
    theirs = _jax_golden("alexnet")["nhwc"]["layout_transposes"]
    shapes = [s["shape"] for s in nhwc["layout_transpose_shapes"]]
    filters = [s for s in shapes if s[0] != 2]
    assert len(filters) == 5
    assert shapes[-2:] == [[2, 256, 6, 6], [2, 6, 6, 256]]
    assert nhwc["layout_transposes"] == theirs + len(filters) == 7


def test_diff_keeps_the_robust_subset_under_another_torch(fresh):
    golden = fresh["lenet"]
    other = json.loads(json.dumps(golden))
    other["generated_with"]["torch"] = "0.0"
    other["step"]["dtype_census"] = {"float32": 1}
    assert C.diff_contracts(golden, other) == []
    other["step"]["gradient_all_reduces"] = 2
    diffs = C.diff_contracts(golden, other)
    assert diffs[0].startswith("step.gradient_all_reduces")
    assert "only the robust subset" in diffs[-1]


def test_collective_consistency_across_two_participants():
    ok, rep = C.collective_consistency(["lenet", "googlenet"])
    assert ok, rep
    assert rep["lenet"]["participants"] == 2
    assert rep["lenet"]["sequence_len"] > 0
    assert rep["googlenet"]["skipped"]


def test_a_process_group_already_up_refuses_the_contract():
    from poseidon_tpu_torch.runtime.op_census import fake_world
    with fake_world(2):
        with pytest.raises(C.ContractEnvironmentError):
            C.build_contract("lenet")


# --------------------------------------------------------------------- #
# the JIT rules, mapped to what the port runs

def _lint(tmp_path, src, name="mod.py", rel=None, monkeypatch=None):
    f = tmp_path / name
    f.write_text(textwrap.dedent(src))
    return J.lint_file(str(f))


def _keys(findings, rule):
    return sorted(f.key for f in findings if f.rule == rule)


def test_jit101_syncs_in_captured_or_replayed_code(tmp_path):
    fs = _lint(tmp_path, '''
        import torch
        from torch.utils.checkpoint import checkpoint

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x.sum().item()

            @staticmethod
            def backward(ctx, g):
                torch.cuda.synchronize()
                return g

        def step(g, x):
            with torch.cuda.graph(g):
                y = x.cpu()

            def body(t):
                return t.tolist()
            return checkpoint(body, x)

        def host(x):
            return x.item()
        ''')
    jit101 = [f for f in fs if f.rule == "JIT101"]
    assert sorted((f.symbol, f.key) for f in jit101) == [
        ("Fn.backward", "torch.cuda.synchronize"),
        ("Fn.forward", ".item()"),
        ("step", "graph:.cpu()"),
        ("step.body", ".tolist()")]


def test_jit102_window_syncs_and_a_stale_window(tmp_path, monkeypatch):
    src = '''
        class Engine:
            def _absorb(self, rows, last):
                return self._helper(rows)

            def _helper(self, rows):
                return float(rows[0]) + rows[1].item()

            def _gone_but_configured(self):
                pass
        '''
    f = tmp_path / "eng.py"
    f.write_text(textwrap.dedent(src))
    from poseidon_tpu_torch.analysis import relpath
    monkeypatch.setitem(J.WINDOW_METHODS, relpath(str(f)),
                        {"Engine._absorb", "Engine._vanished"})
    fs = J.lint_file(str(f))
    assert _keys(fs, "JIT102") == [".item()", "float()",
                                   "missing:Engine._vanished"]


def test_jit103_capture_or_load_in_a_loop(tmp_path):
    fs = _lint(tmp_path, '''
        import torch
        from poseidon_tpu_torch.ops import _build

        def warm(names):
            _build.build_all(names)
            for name in names:
                _build.load(name)
            while True:
                g = torch.cuda.CUDAGraph()
        ''')
    assert _keys(fs, "JIT103") == ["capture-in-loop", "load-in-loop"]


def test_jit104_f64(tmp_path):
    fs = _lint(tmp_path, '''
        import numpy as np
        import torch
        a = torch.zeros(3, dtype=torch.float64)
        b = a.double()
        c = np.zeros(3).astype("float64")
        d = np.zeros(3, dtype=float)
        ''')
    assert _keys(fs, "JIT104") == ["astype-f64", "double", "dtype-float",
                                   "float64"]


def test_jit105_required_ranges(tmp_path, monkeypatch):
    # the shipped modules hold every required range
    for rel in J.required_scope_files():
        assert not [x for x in J.lint_file(os.path.join(REPO, rel))
                    if x.rule == "JIT105"], rel
    f = tmp_path / "trainer.py"
    f.write_text("from x import scope\nwith scope('arena_pack'):\n"
                 "    pass\n")
    from poseidon_tpu_torch.analysis import relpath
    monkeypatch.setitem(J.REQUIRED_SCOPES, relpath(str(f)),
                        ("arena_pack", "optimizer_update"))
    assert _keys(J.lint_file(str(f)), "JIT105") == ["optimizer_update"]


def test_jit106_checkpointed_body_without_its_range(tmp_path, monkeypatch):
    src = '''
        def layer_forward(layer, x):
            def body(t):
                return layer(t)
            return checkpoint_layer(body, [x])

        def with_range(layer, x):
            def body(t):
                with scope(layer.name):
                    return layer(t)
            return checkpoint_layer(body, [x])
        '''
    f = tmp_path / "net.py"
    f.write_text(textwrap.dedent(src))
    from poseidon_tpu_torch.analysis import relpath
    monkeypatch.setattr(J, "REMAT_SCOPE_FILES", {relpath(str(f))})
    fs = [x for x in J.lint_file(str(f)) if x.rule == "JIT106"]
    assert [x.symbol for x in fs] == ["layer_forward.body"]


def test_remat_layer_recompute_runs_inside_its_range():
    """The JIT106 repair: a checkpointed layer's backward recomputation
    opens the layer's range, so a profiler sees it twice a step."""
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.models import zoo
    net = Net(zoo.lenet(with_accuracy=False), "TRAIN", device="cpu",
              source_shapes=zoo.lenet_shapes(2))
    params = net.init(torch.Generator().manual_seed(0))
    for leaves in params.values():
        for v in leaves.values():
            v.requires_grad_()
    batch = {"data": torch.randn(2, 1, 28, 28),
             "label": torch.zeros(2, dtype=torch.int64)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net.apply(params, batch, train=True, remat=["conv1"]).loss.backward()
    names = [e.name for e in prof.events()]
    assert names.count("conv1") == 2 and names.count("conv2") == 1


# --------------------------------------------------------------------- #
# THR005: CUDA off the main thread

THREADED_CUDA = '''
import threading
import torch

class Stager:
    def __init__(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        s = torch.cuda.Stream()
        self.x = torch.zeros(3).cuda()
'''


def test_thr005_cuda_from_a_thread_outside_the_sanctioned_modules(
        tmp_path):
    f = tmp_path / "stager.py"
    f.write_text(textwrap.dedent(THREADED_CUDA))
    fs = [x for x in T.lint_file(str(f)) if x.rule == "THR005"]
    assert [(x.symbol, x.key) for x in fs] == [("Stager._run", "cuda")]
    # the sanctioned modules, each with its reason in the code
    assert T.SANCTIONED_CUDA_THREAD_MODULES == {
        "poseidon_tpu_torch/data/pipeline.py",
        "poseidon_tpu_torch/runtime/metrics.py"}
