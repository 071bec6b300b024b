"""Boundaries of the port: it imports neither jax nor any module of
poseidon_tpu (nor ``ml_dtypes``, which the card machine lacks: the async
tier's bf16 wire round-trips without it), and its entry points refuse to
fall back to the CPU when no GPU is present and the caller did not ask for
the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALEXNET = "examples/imagenet/alexnet_deploy.prototxt"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import poseidon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(poseidon_tpu_torch.__path__,
                                                "poseidon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the mesh planner among them (its Functions, context and step build at
# import; nothing of JAX's comes with them)
assert "poseidon_tpu_torch.parallel.spmd" in names
from poseidon_tpu_torch.parallel import spmd
assert spmd.SpmdTrainStep and spmd.TPColMatmul and spmd.ShardingPlan
# the sequence-parallel exchanges (ring flash attention, Ulysses)
assert "poseidon_tpu_torch.parallel.sequence" in names
# the mixture of experts and its expert-parallel step
assert "poseidon_tpu_torch.models.moe" in names
# the data sources, the disk streamer and the dataset tools; the tuned
# store, the tuned plan, the conv tuner and the trace attribution
for mod in ("data.window", "data.stream", "data.libsvm", "runtime.tools",
            "runtime.compile_cache", "runtime.tuned_plan", "ops.conv_tune",
            "runtime.attribution"):
    assert "poseidon_tpu_torch." + mod in names, mod
# a bf16-wire round trip of the async tier: quantize, encode, decode, widen
import numpy as np
from poseidon_tpu_torch.parallel import async_ssp
from poseidon_tpu_torch.proto import wire
v = np.linspace(-3, 3, 17, dtype=np.float32)
q, resid, _ = async_ssp._quantize_leaf(v, "bf16")
parts, _ = wire.encode_codec_payload({"d": q})
back = wire.decode_codec_payload(bytearray(b"".join(bytes(p) for p in parts)))
assert np.array_equal(async_ssp._dense_f32(back["d"]) + resid, v)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "poseidon_tpu"
             or m.startswith("poseidon_tpu.") or m == "ml_dtypes"
             or m.startswith("ml_dtypes."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_poseidon_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


_IMPORT_SEQUENCE = r"""
import sys
from poseidon_tpu_torch.parallel import sequence
from poseidon_tpu_torch.models import transformer
assert sequence.RingFlashAttention and sequence.ulysses_attention
assert transformer.build_dp_tp_train_step and transformer.tp_shard
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "poseidon_tpu"))
assert not bad, bad
"""


def test_sequence_module_imports_no_jax():
    """``parallel/sequence.py`` and the LM's sp/tp steps on their own:
    neither ``jax`` nor ``poseidon_tpu`` comes with them."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_SEQUENCE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT_MOE = r"""
import sys
from poseidon_tpu_torch.models import generate, moe, train_lm, transformer
from poseidon_tpu_torch.parallel import mesh
assert moe.build_dp_ep_train_step and moe.moe_ffn and mesh.AllToAll
assert transformer.build_dp_pp_train_step and transformer.pp_shard
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "poseidon_tpu"))
assert not bad, bad
"""


def test_moe_module_imports_no_jax():
    """``models/moe.py`` and the pipeline step on their own: neither
    ``jax`` nor ``poseidon_tpu`` comes with them."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_MOE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _need_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal; a GPU is present")


def test_net_without_device_refuses_cpu_fallback():
    _need_no_gpu()
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Net(load_net(os.path.join(REPO, ALEXNET)))


def test_executor_from_files_without_device_refuses():
    _need_no_gpu()
    from poseidon_tpu_torch.serving.executor import BucketedExecutor
    with pytest.raises(RuntimeError, match="CUDA device"):
        BucketedExecutor.from_files(os.path.join(REPO, ALEXNET),
                                    buckets=(1,))


def test_serve_cli_without_device_refuses():
    _need_no_gpu()
    from poseidon_tpu_torch.runtime.cli import main
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["serve", f"--model={os.path.join(REPO, ALEXNET)}",
              "--buckets", "1"])


def test_serve_generate_cli_without_device_refuses():
    _need_no_gpu()
    from poseidon_tpu_torch.runtime.cli import main
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["serve", "--generate", "--model", "tiny"])


def test_generate_executor_without_device_refuses():
    _need_no_gpu()
    from poseidon_tpu_torch.models.transformer import (TransformerConfig,
                                                       init_params)
    from poseidon_tpu_torch.serving.continuous import GenerateExecutor
    cfg = TransformerConfig(vocab_size=16, d_model=8, n_heads=2, n_layers=1,
                            d_ff=16, max_seq=32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA device"):
        GenerateExecutor(cfg, params, page_size=4, decode_rungs=(1,),
                         prompt_buckets=(8,))


def test_engine_without_device_refuses():
    _need_no_gpu()
    from poseidon_tpu_torch.proto.messages import load_solver
    from poseidon_tpu_torch.runtime.engine import Engine
    sp = load_solver(os.path.join(REPO, "examples/mnist/lenet_solver.prototxt"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        Engine(sp)


def test_train_and_test_cli_without_device_refuse(monkeypatch):
    _need_no_gpu()
    from poseidon_tpu_torch.runtime.cli import main
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["train", "--solver=examples/mnist/lenet_solver.prototxt"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["test", "--model=examples/mnist/lenet_train_test.prototxt",
              "--iterations", "1"])


def test_training_modules_import_neither_jax_nor_poseidon_tpu():
    """The slice's new modules, each imported alone in a fresh process."""
    mods = ["poseidon_tpu_torch.runtime.engine",
            "poseidon_tpu_torch.parallel.trainer",
            "poseidon_tpu_torch.solvers.updates",
            "poseidon_tpu_torch.core.arena",
            "poseidon_tpu_torch.data.pipeline",
            "poseidon_tpu_torch.ops.pool", "poseidon_tpu_torch.ops.sgd"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'poseidon_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_lm_modules_import_neither_jax_nor_poseidon_tpu():
    """The LM serving slice's modules, each imported alone in a fresh
    process."""
    mods = ["poseidon_tpu_torch.ops.attention", "poseidon_tpu_torch.ops.flash",
            "poseidon_tpu_torch.models.transformer",
            "poseidon_tpu_torch.models.generate",
            "poseidon_tpu_torch.serving.kv_pool",
            "poseidon_tpu_torch.serving.continuous"]
    for mod in mods:
        code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'poseidon_tpu')]\n"
                "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, mod + out.stdout + out.stderr


@pytest.mark.parametrize("mod", ["poseidon_tpu_torch.serving.fleet",
                                 "poseidon_tpu_torch.serving.reloader"])
def test_fleet_modules_import_neither_jax_nor_poseidon_tpu(mod):
    """The serving fleet's modules, each imported alone in a fresh
    process."""
    code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'poseidon_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, mod + out.stdout + out.stderr


def test_serve_fleet_cli_without_device_refuses():
    """`serve --replicas 2` with no GPU and no --device cpu refuses before
    any replica is built; with --device cpu, --devices is refused."""
    _need_no_gpu()
    from poseidon_tpu_torch.runtime.cli import main
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["serve", f"--model={os.path.join(REPO, ALEXNET)}",
              "--buckets", "1", "--replicas", "2"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["serve", "--generate", "--model", "tiny", "--replicas", "2"])
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["bench_serve", "--devices", "0,0", "--device", "cpu"])


def test_resolve_device_is_pure():
    from poseidon_tpu_torch.numeric import resolve_device
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_net_applies_f32_policy():
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        Net(load_net(os.path.join(REPO, ALEXNET)), device="cpu")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_kernel_sources_and_build_dir():
    from poseidon_tpu_torch.ops import _build
    assert _build.sources() == ["flash_bwd", "flash_fwd", "lrn_bwd",
                                "lrn_fwd", "pool_bwd", "sgd_update"]
    assert _build.BUILD_DIR == \
        __import__("pathlib").Path(REPO) / "build" / "poseidon_tpu_torch"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    lib = _build._lib_path("lrn_fwd")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith(
        "liblrn_fwd-")


def test_lm_training_modules_import_neither_jax_nor_poseidon_tpu():
    """The LM training slice's new modules, imported together in a fresh
    process."""
    mods = ["poseidon_tpu_torch.core.remat",
            "poseidon_tpu_torch.runtime.lm_checkpoint",
            "poseidon_tpu_torch.models.train_lm"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'poseidon_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_lm_train_step_and_script_without_device_refuse():
    _need_no_gpu()
    from poseidon_tpu_torch.models import train_lm
    from poseidon_tpu_torch.models.transformer import (
        TransformerConfig, build_dp_sp_train_step)
    from poseidon_tpu_torch.proto.messages import SolverParameter
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_dp_sp_train_step(TransformerConfig(), SolverParameter())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])


def test_pipeline_modules_import_neither_jax_nor_poseidon_tpu():
    """The pipelined loop's and the data sources' modules, each imported
    alone in a fresh process."""
    mods = ["poseidon_tpu_torch.config", "poseidon_tpu_torch.data.native",
            "poseidon_tpu_torch.data.snappy",
            "poseidon_tpu_torch.data.varint",
            "poseidon_tpu_torch.data.leveldb_reader",
            "poseidon_tpu_torch.data.sources",
            "poseidon_tpu_torch.runtime.spans",
            "poseidon_tpu_torch.runtime.metrics",
            "poseidon_tpu_torch.runtime.checkpoint"]
    for mod in mods:
        code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'poseidon_tpu')]\n"
                "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, mod + out.stdout + out.stderr


def test_comm_modules_import_neither_jax_nor_poseidon_tpu():
    """The managed-communication slice's modules (the static comm
    accounting is new), each imported alone in a fresh process."""
    mods = ["poseidon_tpu_torch.runtime.comm_stats",
            "poseidon_tpu_torch.parallel.strategies",
            "poseidon_tpu_torch.parallel.trainer",
            "poseidon_tpu_torch.runtime.cluster"]
    for mod in mods:
        code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'poseidon_tpu')]\n"
                "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, mod + out.stdout + out.stderr


def test_restart_census_and_analysis_modules_import_neither_jax_nor_poseidon_tpu():
    """The fast-restart layer, the step census and the static guardrails,
    imported together in a fresh process; the protocol extraction runs
    there too (it imports nothing it reads)."""
    mods = ["poseidon_tpu_torch.runtime.compile_cache",
            "poseidon_tpu_torch.runtime.op_census",
            "poseidon_tpu_torch.runtime.hlo_layout",
            "poseidon_tpu_torch.runtime.hlo_comm",
            "poseidon_tpu_torch.analysis",
            "poseidon_tpu_torch.analysis.__main__",
            "poseidon_tpu_torch.analysis.contracts",
            "poseidon_tpu_torch.analysis.jit_hygiene",
            "poseidon_tpu_torch.analysis.threads",
            "poseidon_tpu_torch.analysis.protocol",
            "poseidon_tpu_torch.analysis.model_check"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from poseidon_tpu_torch.analysis import protocol\n"
            "protocol.extract_schema()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'poseidon_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_native_library_builds_from_the_checkout_alone():
    """The data plane's C++ source is in the checkout and builds into the
    port's build directory, not the JAX binding's ``native/build``."""
    from poseidon_tpu_torch.data import native
    assert native.SOURCE == __import__("pathlib").Path(REPO) / "native" / \
        "poseidon_dataplane.cc"
    assert native.SOURCE.exists()
    assert native.lib_path().parent == \
        __import__("pathlib").Path(REPO) / "build" / "poseidon_tpu_torch"
