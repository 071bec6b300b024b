"""The port's fast-restart layer (``runtime/compile_cache.py``): the kernel
store, the step key, the AOT store's counterpart and the restart's
numbers, on the CPU.

Tolerances: everything here is exact (keys, counts, bytes of snapshots);
the restart's second run must reproduce the first's snapshot byte for
byte.
"""

import os
import subprocess
import sys

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGITS = "examples/digits/digits_train_test.prototxt"

from poseidon_tpu.runtime import compile_cache as jcc  # noqa: E402

from poseidon_tpu_torch import config  # noqa: E402
from poseidon_tpu_torch.data import native  # noqa: E402
from poseidon_tpu_torch.ops import _build  # noqa: E402
from poseidon_tpu_torch.runtime import cli  # noqa: E402
from poseidon_tpu_torch.runtime import compile_cache as cc  # noqa: E402


def _solver(tmp_path, max_iter=2, extra=""):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, DIGITS)}"\n'
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 1\n'
        f'max_iter: {max_iter}\ntest_iter: 1\ntest_interval: {max_iter}\n'
        'test_initialization: false\nsnapshot_prefix: "digits"\n' + extra)
    return solver


def test_enable_points_both_builds_at_the_store_and_disable_restores(
        tmp_path):
    d = cc.enable_compile_cache(str(tmp_path / "store"))
    try:
        assert d == str(tmp_path / "store")
        assert _build.BUILD_DIR == tmp_path / "store" / "kernels"
        assert native.BUILD_DIR == tmp_path / "store" / "kernels"
        assert _build._lib_path("lrn_fwd").parent == _build.BUILD_DIR
        assert native.lib_path().parent == native.BUILD_DIR
    finally:
        cc.disable_compile_cache()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert native.BUILD_DIR == native.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR == \
        __import__("pathlib").Path(REPO) / "build" / "poseidon_tpu_torch"


def test_entry_counts(tmp_path):
    store = tmp_path / "store"
    assert cc.cache_entries(str(store)) == 0
    assert cc.describe(str(store)) == {"kernel_entries": 0,
                                       "aot_step_entries": 0}
    (store / "kernels").mkdir(parents=True)
    for name in ("liba-1.so", "libb-2.so", "libc-3.so.tmp.77"):
        (store / "kernels" / name).write_bytes(b"x")
    (store / "aot").mkdir()
    (store / "aot" / "step_k.aotexec").write_bytes(b"x")
    assert cc.describe(str(store)) == {"kernel_entries": 2,
                                       "aot_step_entries": 1}
    assert jcc.aot_entries(str(store)) == cc.aot_entries(str(store))


@pytest.mark.parametrize("parts", [
    {"kind": "train_step", "model": "AlexNet", "batch": {"data": [256, 3]}},
    {"a": (1, 2), "b": {"z": 1, "y": [None, True, 1.5]}},
])
def test_step_key_is_the_jax_packages(parts):
    assert cc.step_key(**parts) == jcc.step_key(**parts)


def test_library_name_keys_the_toolchain(monkeypatch):
    """Source, headers, compiler version and flags name a library: a
    drifted toolchain is a clean miss (another name), never a stale
    load."""
    before = _build._lib_path("sgd_update")
    monkeypatch.setattr(_build, "_toolchain", "nvcc: release 99.9\n-O0")
    after = _build._lib_path("sgd_update")
    assert after != before and after.parent == before.parent
    monkeypatch.setattr(native, "_toolchain", "g++ 99 -O0")
    assert native.lib_path().name != before.name


def test_a_library_that_does_not_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    path = _build._lib_path("lrn_bwd")
    path.write_bytes(b"not a shared object")
    with pytest.raises(RuntimeError, match="does not load"):
        _build.load("lrn_bwd")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    native.lib_path().write_bytes(b"not a shared object")
    with pytest.raises(RuntimeError, match="does not load"):
        native.library()


_RUN = r"""
import sys
from poseidon_tpu_torch.data import native
from poseidon_tpu_torch.ops import _build
from poseidon_tpu_torch.runtime import cli
rc = cli.main(["train", "--solver", sys.argv[1], "--output_dir", sys.argv[2],
               "--device", "cpu", "--compile_cache_dir", sys.argv[3]])
print("BUILT", len(_build.BUILT) + native.BUILT, _build.BUILD_DIR)
sys.exit(rc)
"""


def test_restart_builds_once_and_repeats_the_first_steps_bitwise(tmp_path):
    """Two fresh ``train --compile_cache_dir D`` processes on one empty D:
    the first builds the data plane into D/kernels, the second builds
    nothing; both key the step alike, log why no step executable is
    kept, and write the same snapshot byte for byte."""
    solver = _solver(tmp_path)
    store = tmp_path / "D"
    outs = []
    for run in ("cold", "warm"):
        out = subprocess.run(
            [sys.executable, "-c", _RUN, str(solver), str(tmp_path / run),
             str(store)], cwd=REPO, capture_output=True, text=True,
            timeout=240)
        assert out.returncode == 0, out.stdout + out.stderr
        outs.append(out.stdout)
    assert "BUILT 1" in outs[0] and "BUILT 0" in outs[1]
    assert os.listdir(store / "kernels") == [native.lib_path().name]
    docs = [yaml.safe_load((tmp_path / run / "stats.yaml").read_text())
            for run in ("cold", "warm")]
    cold, warm = (d["restart"] for d in docs)
    assert cold["key"] == warm["key"]
    assert (cold["libraries_built"], warm["libraries_built"]) == (1, 0)
    assert cold["aot_step_entries"] == warm["aot_step_entries"] == 0
    assert warm["kernel_entries"] == 1
    assert warm["builds_s"] == 0.0 and cold["builds_s"] > 0
    assert cold["first_dispatch_steps"] == 1 and not cold["graph"]
    for out in outs:
        assert "aot warm start: no step executable is stored" in out
        assert f"train step key {cold['key'][:12]}" in out
    snap = "digits_iter_2.caffemodel"
    assert (tmp_path / "cold" / snap).read_bytes() == \
        (tmp_path / "warm" / snap).read_bytes()


@pytest.mark.parametrize("extra,flags,keyed", [
    ("", [], True),
    ("", ["--aot_steps", "false"], False),
    ("iter_size: 2\n", [], False),
    ("", ["--staleness", "1"], False),
])
def test_the_engine_keys_the_step_only_where_jax_does(tmp_path, capsys,
                                                      extra, flags, keyed):
    """JAX's eligibility rule: staleness 0, no HDF5_OUTPUT in the TRAIN
    net, iter_size 1, no mesh plan, and --aot_steps true."""
    solver = _solver(tmp_path, max_iter=1, extra=extra)
    assert cli.main(["train", "--solver", str(solver), "--output_dir",
                     str(tmp_path / "out"), "--device", "cpu",
                     "--compile_cache_dir", str(tmp_path / "D")]
                    + flags) == 0
    logged = capsys.readouterr().out
    assert ("aot warm start: train step key" in logged) == keyed
    # the command's scope is over: both stores point back
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert config.compile_cache_config().cache_dir == ""
    assert config.compile_cache_config().aot_steps is True


def test_tune_takes_a_suppressed_aot_steps_and_the_helps_name_both_stores():
    parser = cli.build_parser()
    args = parser.parse_args(["tune", "--aot_steps", "false"])
    assert args.aot_steps == "false"
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    for cmd in ("train", "serve", "bench_serve", "tune"):
        helps = {a.dest: a.help or "" for a in sub.choices[cmd]._actions}
        assert "kernel store" in helps["compile_cache_dir"], cmd
        assert "tuned store" in helps["compile_cache_dir"], cmd
    tune_help = {a.dest: a.help for a in sub.choices["tune"]._actions}
    assert tune_help["aot_steps"] == "==SUPPRESS=="
