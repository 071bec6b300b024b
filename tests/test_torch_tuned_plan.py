"""The port's tuned store and TunedPlan (``runtime/compile_cache.py``,
``runtime/tuned_plan.py``, the ``tune`` command, ``--tuned_plan``)
against the JAX package's, mirroring JAX's ``tests/test_tuned_plan.py``:

- the store: ``step_key`` equal to JAX's; documents either package saved
  read by the other; atomic saves with no tmp litter; a torn entry is a
  loud miss; JAX's and the port's plans in one store, each package loading
  only its own;
- resolution: ``resolve`` and ``provenance`` equal to JAX's on the same
  doc and flags (values, sources, ``overridden``; the version fields
  differ by design: ``torch_version`` for ``jax_version``); device kind
  and torch version mismatches refuse loudly, and so does a JAX-written
  plan; the estimator is not fooled by a first call's cost;
  ``resolve_conv_layout("auto")`` reads the active plan;
- the end to end: ``tune --model lenet --smoke`` persists, then memo-hits;
  its knobs, trials and search space equal JAX's smoke plan's; a ``train``
  that loads the plan is bitwise to the explicit flags (LeNet, 3 steps)
  and writes stats.yaml's ``tuned_plan`` section with "(plan)" and
  "(flag)"; ``serve``/``bench_serve`` take the plan's ladder, ``--buckets``
  wins, ``--tuned_plan off`` skips the store; the commands refuse without
  a GPU unless the CPU is asked for.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from poseidon_tpu.runtime import compile_cache as jcc
from poseidon_tpu.runtime import tuned_plan as jtp
from poseidon_tpu_torch.runtime import cli
from poseidon_tpu_torch.runtime import compile_cache as tcc
from poseidon_tpu_torch.runtime import tuned_plan as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET = os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")
LENET_DEPLOY = os.path.join(REPO, "examples/mnist/lenet_deploy.prototxt")

SMALLNET = """
name: "PlanNet"
layers {
  name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 8 channels: 1 height: 12 width: 12 }
}
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers {
  name: "ip1" type: INNER_PRODUCT bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } }
}
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""


@pytest.fixture
def policy_guard():
    """Save and restore every piece of process-global state the plan
    resolution touches, so no test leaks policy into the suite."""
    from poseidon_tpu_torch import config, numeric

    pol = numeric.policy()
    saved_policy = {"conv_layout": pol.conv_layout,
                    "conv_strategy": pol.conv_strategy}
    saved_pipe = dataclasses.asdict(config.pipeline_config())
    saved_cc = config.compile_cache_config().cache_dir
    saved_wire = config.managed_comm_config().wire_dtype
    saved_active = tp.active_resolution()
    yield
    numeric.set_policy(**saved_policy)
    config.set_pipeline_config(**saved_pipe)
    config.set_compile_cache_config(cache_dir=saved_cc)
    config.set_managed_comm_config(wire_dtype=saved_wire)
    tp.set_active_resolution(saved_active)


def _plan_doc(model, knobs, **overrides):
    """A store-shaped plan doc whose provenance matches this process on
    the CPU."""
    prov = tp.device_provenance("cpu")
    doc = {"version": tp.PLAN_VERSION, "model": model,
           "framework": tp.FRAMEWORK, "backend": prov["backend"],
           "device_kind": prov["device_kind"],
           "torch_version": prov["torch_version"],
           "cuda_version": prov["cuda_version"],
           "n_devices": prov["n_devices"],
           "key": tp.plan_key(model, prov["backend"], prov["n_devices"]),
           "knobs": knobs, "trials": {},
           "measured_at": "2026-01-01T00:00:00Z", "search_cost_s": 1.0}
    doc.update(overrides)
    return doc


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("parts", [
    {"kind": "plan", "model": "lenet", "backend": "cpu", "n_devices": 1},
    {"kind": "conv_strategy", "c": 3, "h": 227, "kh": 11, "sh": 4,
     "layout": "NHWC", "compute_dtype": "float32"},
    {"nested": {"b": (1, 2), "a": [3.5, None, True]}, "z": "x"}])
def test_step_key_equals_jax(parts):
    assert tcc.step_key(**parts) == jcc.step_key(**parts)
    assert tcc._canon(parts) == jcc._canon(parts)


def test_save_tuned_atomic_no_tmp_litter_and_cross_reads(tmp_path):
    store = str(tmp_path)
    path = tcc.save_tuned(store, "ns", "k1", {"winner": "x", "t": [1.5]})
    assert path == tcc.tuned_path(store, "ns", "k1") == \
        jcc.tuned_path(store, "ns", "k1")
    assert [n for n in os.listdir(os.path.dirname(path))
            if ".tmp" in n] == []
    assert tcc.load_tuned(store, "ns", "k1") == {"winner": "x", "t": [1.5]}
    # what either package saved, the other reads
    assert jcc.load_tuned(store, "ns", "k1") == {"winner": "x", "t": [1.5]}
    jcc.save_tuned(store, "ns", "k2", {"winner": "im2col"})
    assert tcc.load_tuned(store, "ns", "k2") == {"winner": "im2col"}
    # no store configured: nothing saved, nothing loaded
    assert tcc.save_tuned("", "ns", "k1", {}) is None
    assert tcc.load_tuned("", "ns", "k1") is None


def test_load_tuned_torn_entry_is_loud_miss(tmp_path, capsys):
    tcc.save_tuned(str(tmp_path), "ns", "k2", {"winner": "x"})
    with open(tcc.tuned_path(str(tmp_path), "ns", "k2"), "w") as f:
        f.write('{"winner": "x"')          # torn mid-write
    assert tcc.load_tuned(str(tmp_path), "ns", "k2") is None
    assert "torn/unreadable" in capsys.readouterr().out
    # a clean miss (no file at all) stays silent
    assert tcc.load_tuned(str(tmp_path), "ns", "nope") is None
    assert "torn" not in capsys.readouterr().out


def test_jax_and_port_plans_share_a_store_without_colliding(tmp_path,
                                                            capsys):
    import jax
    store = str(tmp_path)
    knobs = {"conv_layout": "NHWC"}
    jdoc = {"model": "lenet", "backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "jax_version": jax.__version__,
            "n_devices": jax.device_count(),
            "key": jtp.plan_key("lenet", jax.default_backend(),
                                jax.device_count()),
            "knobs": {"conv_layout": "NCHW"}}
    jtp.save_plan(jdoc, cache_dir=store)
    tdoc = _plan_doc("lenet", knobs)
    tp.save_plan(tdoc, cache_dir=store)
    assert tdoc["key"] != jdoc["key"]
    # the same parts JAX keys by (cpu, one device) still differ: the port
    # keys its framework
    assert tp.plan_key("lenet", "cpu", 1) != jtp.plan_key("lenet", "cpu", 1)
    assert jtp.load_plan("lenet", cache_dir=store)["knobs"] == \
        jdoc["knobs"]
    assert tp.load_plan("lenet", cache_dir=store, device="cpu")["knobs"] \
        == knobs
    # a JAX document under the port's key refuses, loudly
    tcc.save_tuned(store, tp.PLAN_NAMESPACE, tdoc["key"], jdoc)
    capsys.readouterr()
    assert tp.load_plan("lenet", cache_dir=store, device="cpu") is None
    assert "REFUSING" in capsys.readouterr().out
    # the default stores differ too
    assert tp.store_dir() != jtp.store_dir() or \
        os.environ.get("POSEIDON_TUNED_DIR") or \
        os.environ.get("POSEIDON_COMPILE_CACHE_DIR")


# --------------------------------------------------------------------------- #
# resolution and provenance
# --------------------------------------------------------------------------- #

def _comparable(prov):
    return {k: v for k, v in prov.items()
            if k not in ("plan_jax_version", "plan_torch_version",
                         "plan_cuda_version")}


@pytest.mark.parametrize("flags", [
    {"conv_layout": "NCHW"},
    {"max_in_flight": 1, "arena_bucket_mb": 1.0},
    {"steps_per_dispatch": 4, "remat": "auto", "wire_dtype": "bf16",
     "device_prefetch": None}, {}])
def test_resolution_precedence_equals_jax(flags):
    doc = {"knobs": {"conv_layout": "NHWC", "arena_bucket_mb": 1.0,
                     "steps_per_dispatch": 4, "remat": ""},
           "key": "k" * 32, "model": "m", "measured_at": "t",
           "device_kind": "cpu"}
    res = tp.resolve(doc, flags)
    jres = jtp.resolve(doc, flags)
    assert res.values == jres.values
    assert res.sources == jres.sources
    assert res.overridden == jres.overridden
    assert _comparable(res.provenance()) == _comparable(jres.provenance())
    assert tp.BUILTIN_DEFAULTS == jtp.BUILTIN_DEFAULTS
    assert tp.TRAIN_KNOBS == jtp.TRAIN_KNOBS
    assert res.describe().split(": ", 1)[1] == \
        jres.describe().split(": ", 1)[1]
    if flags == {"conv_layout": "NCHW"}:
        assert res.values["conv_layout"] == "NCHW"
        assert res.sources["arena_bucket_mb"] == "plan"
        assert res.sources["device_prefetch"] == "default"
        assert res.overridden == ["conv_layout"]
        assert res.provenance()["overridden_by_flags"] == "conv_layout"


def test_resolution_without_plan_is_all_defaults(policy_guard):
    res = tp.resolve(None, {}, store="/somewhere/we/looked")
    assert set(res.values) == set(tp.TRAIN_KNOBS)
    assert all(src == "default" for src in res.sources.values())
    assert res.overridden == [] and "plan_key" not in res.provenance()
    # a defaults-only resolution publishes no store for conv_tune
    tp.set_active_resolution(res)
    assert tp.active_store_dir() == ""
    tp.set_active_resolution(tp.resolve({"knobs": {}, "key": "k" * 32}, {},
                                        store="/plan/store"))
    assert tp.active_store_dir() == "/plan/store"


@pytest.mark.parametrize("field,value", [("device_kind", "NVIDIA H100"),
                                         ("torch_version", "0.0.1"),
                                         ("torch_version", None)])
def test_plan_refuses_mismatched_provenance(tmp_path, capsys, field, value):
    doc = _plan_doc("mismatch", {"conv_layout": "NHWC"}, **{field: value})
    tp.save_plan(doc, cache_dir=str(tmp_path))
    assert tp.load_plan("mismatch", cache_dir=str(tmp_path),
                        device="cpu") is None
    out = capsys.readouterr().out
    assert "REFUSING" in out and field in out
    good = _plan_doc("mismatch", {"conv_layout": "NHWC"})
    tp.save_plan(good, cache_dir=str(tmp_path))
    loaded = tp.load_plan("mismatch", cache_dir=str(tmp_path), device="cpu")
    assert loaded is not None and loaded["knobs"]["conv_layout"] == "NHWC"


def test_different_backend_or_devices_is_a_clean_miss(tmp_path):
    tp.save_plan(_plan_doc("missy", {"conv_layout": "NHWC"}),
                 cache_dir=str(tmp_path))
    assert tp.load_plan("missy", n_devices=2 ** 14, cache_dir=str(tmp_path),
                        device="cpu") is None
    assert tp.load_plan("missy", backend="cuda", cache_dir=str(tmp_path),
                        device="cpu") is None
    assert tp.load_plan("other", cache_dir=str(tmp_path),
                        device="cpu") is None


def test_interleaved_estimator_not_fooled_by_first_call_cost():
    calls = {"compiley": 0, "steady": 0}

    def compiley():
        calls["compiley"] += 1
        time.sleep(0.05 if calls["compiley"] <= 2 else 0.001)

    def steady():
        calls["steady"] += 1
        time.sleep(0.005)

    ms = tp.interleaved_min_ms({"compiley": compiley, "steady": steady},
                               windows=3, iters=2, warmup=2)
    assert ms["compiley"] < ms["steady"]
    assert calls["compiley"] >= 2 + 3 * 2


def test_conv_layout_auto_consults_active_plan(policy_guard):
    from poseidon_tpu.numeric import resolve_conv_layout as jrcl
    from poseidon_tpu_torch.numeric import resolve_conv_layout

    assert resolve_conv_layout("auto", backend="cpu") == "NCHW"
    assert resolve_conv_layout("auto", backend="cuda") == "NHWC"
    doc = {"knobs": {"conv_layout": "NHWC"}, "key": "k" * 32}
    tp.set_active_resolution(tp.resolve(doc, {}))
    assert resolve_conv_layout("auto", backend="cpu") == "NHWC"
    assert resolve_conv_layout("auto", backend="cpu",
                               consult_plan=False) == "NCHW"
    assert resolve_conv_layout("NCHW", backend="cpu") == "NCHW"
    # a flag-sourced resolution is not a measured row
    tp.set_active_resolution(tp.resolve(doc, {"conv_layout": "NCHW"}))
    assert tp.active_plan_value("conv_layout") is None
    tp.set_active_resolution(None)
    assert resolve_conv_layout("auto", backend="cpu") == \
        jrcl("auto", backend="cpu", consult_plan=False)


# --------------------------------------------------------------------------- #
# the search and the command
# --------------------------------------------------------------------------- #

def test_run_tune_restricted_knobs_persists_then_memo_hits(tmp_path,
                                                           policy_guard):
    from poseidon_tpu_torch.proto.messages import load_net_from_string

    net_param = load_net_from_string(SMALLNET)
    shapes = {"data": (8, 1, 12, 12), "label": (8,)}
    r = tp.run_tune("plannet", smoke=True, cache_dir=str(tmp_path),
                    net_param=net_param, source_shapes=shapes,
                    knobs=["conv_layout"], windows=1, iters=1, device="cpu")
    assert r["source"] == "measured"
    doc = r["doc"]
    assert set(doc["knobs"]) == set(tp.BUILTIN_DEFAULTS)
    assert doc["trials"]["conv_layout"]["source"] == "measured"
    assert set(doc["trials"]["conv_layout"]["timings_ms"]) == \
        {"NCHW", "NHWC"}
    assert doc["ab"]["speedup"] >= 1.0
    assert "pipeline" in doc["skipped"]
    assert doc["device_kind"] == "cpu" and doc["torch_version"]
    assert doc["framework"] == "torch" and "jax_version" not in doc
    with open(r["path"]) as f:
        assert json.load(f)["key"] == doc["key"]
    t0 = time.perf_counter()
    r2 = tp.run_tune("plannet", smoke=True, cache_dir=str(tmp_path),
                     device="cpu")
    assert r2["source"] == "persisted" and r2["doc"]["key"] == doc["key"]
    assert time.perf_counter() - t0 < 5.0
    r3 = tp.run_tune("plannet", smoke=True, cache_dir=str(tmp_path),
                     net_param=net_param, source_shapes=shapes,
                     knobs=["conv_layout"], windows=1, iters=1, force=True,
                     device="cpu")
    assert r3["source"] == "measured"


def test_tune_lenet_smoke_cli_persists_memo_hits_and_has_jax_keys(
        tmp_path, capsys, policy_guard):
    store = str(tmp_path / "store")
    rc = cli.main(["tune", "--model", "lenet", "--smoke", "--device", "cpu",
                   "--compile_cache_dir", store,
                   "--out", str(tmp_path / "plan.json")])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "tune" and line["source"] == "measured"
    assert line["backend"] == "cpu" and line["device_kind"] == "cpu"
    assert line["tuned_vs_default_speedup"] >= 1.0
    with open(line["path"]) as f:
        doc = json.load(f)
    assert doc == json.loads((tmp_path / "plan.json").read_text())
    # the JAX package's smoke plan's knobs, trials and search space (on
    # one device)
    jspace = jtp.search_space(True, 1)
    assert set(doc["knobs"]) == set(jtp.BUILTIN_DEFAULTS)
    assert set(doc["trials"]) == set(jspace)
    assert doc["search_space"] == {k: [str(c) for c in v]
                                   for k, v in jspace.items()}
    assert doc["skipped"] == {}
    assert doc["trials"]["mesh"]["source"] == "only-candidate"
    assert doc["trials"]["remat_batch"]["note"].startswith(
        "the allocator reported no peak")
    per_layer = doc["trials"]["conv_strategy"]["per_layer"]
    assert set(per_layer) == {"conv1", "conv2"}
    # the composite A/B ships the winners, or reverts the step knobs to
    # the defaults when the tuned arm measured slower
    assert doc["knobs"]["conv_strategy"] == (
        "" if doc["ab"].get("reverted") else "auto")
    # the per-layer winners sit in the same store
    names = os.listdir(os.path.join(store, "tuned"))
    assert sum(n.startswith("conv_strategy-") for n in names) == 2
    # the second tune memo-hits
    t0 = time.perf_counter()
    assert cli.main(["tune", "--model", "lenet", "--smoke", "--device",
                     "cpu", "--compile_cache_dir", store]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["source"] == "persisted" and again["path"] == line["path"]
    assert time.perf_counter() - t0 < 5.0


LENET_SOLVER = os.path.join(REPO, "examples/mnist/lenet_solver.prototxt")


@pytest.mark.parametrize("argv", [
    ["tune", "--model", "lenet", "--smoke"],
    ["train", "--solver", LENET_SOLVER],
    ["train", "--solver", LENET_SOLVER, "--profile", "2"],
    ["bench_serve", "--model", LENET_DEPLOY, "--requests", "1"]])
def test_commands_refuse_without_a_gpu(argv, monkeypatch, policy_guard):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


# --------------------------------------------------------------------------- #
# the anchor: a loaded plan trains bitwise to the explicit flags
# --------------------------------------------------------------------------- #

PLAN_KNOBS = {"conv_layout": "NHWC", "conv_strategy": "im2col",
              "arena_bucket_mb": 1.0, "mesh": "", "device_prefetch": 0,
              "max_in_flight": 1, "steps_per_dispatch": 2, "wire_dtype": "",
              "remat": "", "hbm_budget_gb": 0.0,
              "serve_buckets": "1,2,4"}


def _lenet_solver(tmp_path, sub):
    out = tmp_path / sub
    out.mkdir()
    solver = out / "solver.prototxt"
    solver.write_text(
        f'net: "{LENET}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 2\n'
        'max_iter: 3\nsnapshot_after_train: true\n'
        f'snapshot_prefix: "{out / "lenet"}"\n')
    return str(solver), out


def _final_state(out):
    path = next(p for p in os.listdir(out) if p.endswith(".solverstate.npz"))
    with np.load(os.path.join(out, path)) as z:
        return {k: z[k].copy() for k in z.files}


def test_loaded_plan_trains_bitwise_to_explicit_flags(tmp_path, capsys,
                                                      monkeypatch,
                                                      policy_guard):
    monkeypatch.chdir(REPO)
    store = str(tmp_path / "store")
    tp.save_plan(_plan_doc("lenet", PLAN_KNOBS), cache_dir=store)
    solver, plan_out = _lenet_solver(tmp_path, "via_plan")
    assert cli.main(["train", f"--solver={solver}", "--output_dir",
                     str(plan_out), "--device", "cpu", "--compile_cache_dir",
                     store, "--max_in_flight", "1"]) == 0
    log = capsys.readouterr().out
    assert "[tuned_plan] plan " in log
    assert "conv_layout=NHWC[p]" in log and "max_in_flight=1[f]" in log
    assert "conv_layout NHWC" in log and "conv_strategy im2col" in log
    solver2, flag_out = _lenet_solver(tmp_path, "via_flags")
    assert cli.main(["train", f"--solver={solver2}", "--output_dir",
                     str(flag_out), "--device", "cpu", "--tuned_plan", "off",
                     "--compile_cache_dir", store,
                     "--conv_layout", "nhwc", "--conv_strategy", "im2col",
                     "--arena_bucket_mb", "1", "--device_prefetch", "0",
                     "--max_in_flight", "1", "--steps_per_dispatch",
                     "2"]) == 0
    log2 = capsys.readouterr().out
    assert "no plan (defaults)" in log2 and "[tuned_plan] no plan for" \
        not in log2
    a, b = _final_state(plan_out), _final_state(flag_out)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    stats = (plan_out / "stats.yaml").read_text()
    assert "tuned_plan:" in stats
    assert "conv_layout: NHWC (plan)" in stats
    assert "conv_strategy: im2col (plan)" in stats
    assert "max_in_flight: 1 (flag)" in stats
    assert "plan_key: " + tp.plan_key("lenet", "cpu", 1) in stats
    flags_stats = (flag_out / "stats.yaml").read_text()
    assert "arena_bucket_mb: 1.0 (flag)" in flags_stats
    assert "plan_key" not in flags_stats


def test_engine_writes_plan_provenance_section(tmp_path, policy_guard):
    from poseidon_tpu_torch.parallel.strategies import CommConfig
    from poseidon_tpu_torch.proto.messages import (SolverParameter,
                                                   load_net_from_string)
    from poseidon_tpu_torch.runtime.engine import Engine

    knobs = dict(PLAN_KNOBS, conv_layout="NCHW", conv_strategy="")
    doc = _plan_doc("plannet", knobs)
    res = tp.resolve(doc, {"max_in_flight": 2}, store=str(tmp_path))
    kw = tp.apply_training_resolution(res)
    assert tp.active_resolution() is res
    rs = np.random.RandomState(0)
    md = {"data": rs.randn(64, 1, 12, 12).astype(np.float32),
          "label": rs.randint(0, 5, 64)}
    sp = SolverParameter(train_net_param=load_net_from_string(SMALLNET),
                         base_lr=0.05, lr_policy="fixed", momentum=0.9,
                         display=0, max_iter=2, random_seed=3)
    eng = Engine(sp, comm=CommConfig(bucket_mb=kw["arena_bucket_mb"]),
                 memory_data=md, output_dir=str(tmp_path), device="cpu",
                 steps_per_dispatch=kw["steps_per_dispatch"])
    try:
        # the pipeline knobs came through config.pipeline_config()
        assert (eng.device_prefetch, eng.max_in_flight) == (0, 2)
        eng.train()
    finally:
        eng.close()
    stats = (tmp_path / "stats.yaml").read_text()
    assert "tuned_plan:" in stats
    assert "conv_layout: NCHW (plan)" in stats
    assert "max_in_flight: 2 (flag)" in stats
    assert "overridden_by_flags: max_in_flight" in stats
    assert f"plan_key: {doc['key']}" in stats


# --------------------------------------------------------------------------- #
# serving: the plan's ladder, --buckets wins, --tuned_plan off
# --------------------------------------------------------------------------- #

def test_serve_takes_the_plans_ladder(tmp_path, capsys, policy_guard):
    store = str(tmp_path)
    tp.save_plan(_plan_doc("lenet", PLAN_KNOBS), cache_dir=store)
    parse = cli.build_parser().parse_args
    base = ["--model", LENET_DEPLOY, "--device", "cpu",
            "--compile_cache_dir", store]
    with cli._store_scope(parse(["serve"] + base)):
        assert cli._resolve_serve_buckets(parse(["serve"] + base)) == \
            "1,2,4"
        assert cli._resolve_serve_buckets(
            parse(["serve"] + base + ["--buckets", "1,8"])) == "1,8"
        assert cli._resolve_serve_buckets(
            parse(["serve"] + base + ["--tuned_plan", "off"])) == \
            tp.BUILTIN_DEFAULTS["serve_buckets"]
    assert "[tuned_plan] serve_buckets=1,2,4" in capsys.readouterr().out
    # the command end to end: bench_serve warms and serves the plan's
    # ladder
    assert cli.main(["bench_serve"] + base + ["--requests", "6",
                                              "--concurrency", "2",
                                              "--batch", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(int(b) for b in line["bucket_calls"]) == [1, 2, 4]
    assert cli.main(["bench_serve"] + base + ["--requests", "4",
                                              "--concurrency", "1",
                                              "--batch", "2",
                                              "--tuned_plan", "off"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(int(b) for b in line["bucket_calls"]) == [1, 4, 16, 64]


def test_generate_knobs_come_from_the_plan(tmp_path, capsys, policy_guard):
    store = str(tmp_path)
    knobs = {"llm_page_size": 16, "llm_decode_rungs": "1,4",
             "llm_prompt_buckets": "16,64"}
    tp.save_plan(_plan_doc("tiny", knobs), cache_dir=store)
    args = cli.build_parser().parse_args(
        ["serve", "--generate", "--model", "tiny", "--device", "cpu",
         "--compile_cache_dir", store])
    with cli._store_scope(args):
        got = cli._resolve_llm_knobs(args)
    assert got == {"llm_page_size": 16, "llm_decode_rungs": "1,4",
                   "llm_prompt_buckets": "16,64"}
    ex = cli.build_generate_executor("tiny", device="cpu", knobs=got)
    assert (ex.page_size, tuple(ex.decode_rungs),
            tuple(ex.prompt_buckets)) == (16, (1, 4), (16, 64))
    args.tuned_plan = "off"
    assert cli._resolve_llm_knobs(args) == {
        k: tp.BUILTIN_DEFAULTS[k] for k in knobs}
