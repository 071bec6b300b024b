"""HDF5_OUTPUT in the TRAIN and TEST nets: the port's engine against the
JAX package's, on the CPU (the TEST net's dump: every test batch's
bottoms, ``test_test_net_dump_matches_jax``).

Both engines train the same MEMORY_DATA net (constant fillers, so the two
start from the same weights without crossing a seed) for 2 iterations on
the same rows: JAX's engine multiplies the prototxt batch by conftest's 8
virtual devices, so its net says batch 1 and the port's batch 8, and each
iteration reads the same 8 rows. After the run each file holds the last
iteration's bottoms: the labels equal (the same rows), the features at
rtol 1e-5, atol 1e-6 (the f32 inner product of one updated weight,
summed in other orders). Under SSP staleness and with ``iter_size`` > 1
the port's engine logs JAX's warnings: no dump under staleness, and
``iter_size`` forced to 1 with the dump. The port imports ``h5py`` only
for a net that has the layer.
"""

import numpy as np
import pytest

NET = """
name: "H5Train"
layers {
  name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: %(batch)d channels: 1 height: 6 width: 6 }
}
layers { name: "ip" type: INNER_PRODUCT bottom: "data" top: "feat"
  inner_product_param { num_output: 3
    weight_filler { type: "constant" value: 0.05 }
    bias_filler { type: "constant" value: 0.1 } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "feat" bottom: "label"
  top: "loss" }
layers { name: "dump" type: HDF5_OUTPUT bottom: "feat" bottom: "label"
  include { phase: TRAIN }
  hdf5_output_param { file_name: "dumps/train_feats.h5" } }
"""
SOLVER = """
net: "%(net)s"
base_lr: 0.1
momentum: 0.9
lr_policy: "fixed"
max_iter: 2
%(extra)s
"""
N_DEV = 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _memory_data():
    rs = np.random.RandomState(0)
    return {"data": rs.rand(64, 1, 6, 6).astype(np.float32),
            "label": (np.arange(64) % 3).astype(np.float32)}


def _solver_text(tmp_path, tag, batch, extra=""):
    net = tmp_path / f"{tag}_net.prototxt"
    net.write_text(NET % {"batch": batch})
    return SOLVER % {"net": net, "extra": extra}


def _run_jax(tmp_path, extra="", staleness=0):
    from poseidon_tpu.proto.messages import load_solver_from_string
    from poseidon_tpu.runtime.engine import Engine
    out = tmp_path / "jax"
    out.mkdir(exist_ok=True)
    sp = load_solver_from_string(_solver_text(tmp_path, "jax", 1, extra))
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(out),
                 staleness=staleness)
    try:
        eng.train()
    finally:
        eng.close()
    return out


def _run_port(tmp_path, extra="", staleness=0):
    from poseidon_tpu_torch.proto.messages import load_solver_from_string
    from poseidon_tpu_torch.runtime.engine import Engine
    out = tmp_path / "port"
    out.mkdir(exist_ok=True)
    sp = load_solver_from_string(_solver_text(tmp_path, "port", N_DEV,
                                              extra))
    eng = Engine(sp, memory_data=_memory_data(), output_dir=str(out),
                 device="cpu", staleness=staleness)
    try:
        eng.train()
    finally:
        eng.close()
    return out


def _read(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def test_train_dump_matches_jax_after_two_iterations(tmp_path):
    want = _read(_run_jax(tmp_path) / "dumps/train_feats.h5")
    got = _read(_run_port(tmp_path) / "dumps/train_feats.h5")
    assert set(got) == set(want) == {"feat", "label"}
    assert got["feat"].shape == want["feat"].shape == (N_DEV, 3)
    # the second iteration's rows, under the weights after step 1
    np.testing.assert_array_equal(got["label"], want["label"])
    assert got["label"].dtype == want["label"].dtype
    np.testing.assert_allclose(got["feat"], want["feat"], **TOL)
    # step 1 moved the weights: the rows of feat differ by class
    assert not np.allclose(got["feat"][0], got["feat"][1])


TEST_NET = NET.replace("include { phase: TRAIN }", "include { phase: TEST }")


def test_test_net_dump_matches_jax(tmp_path):
    """HDF5_OUTPUT in the TEST net: after 2 training iterations one test
    pass of 3 batches writes every batch's bottoms (24 rows), the labels
    equal and the features at TOL against JAX's engine, and the pass's
    metrics (the net's scalar outputs) equal JAX's."""
    from poseidon_tpu.proto.messages import load_solver_from_string as jload
    from poseidon_tpu.runtime.engine import Engine as JaxEngine
    from poseidon_tpu_torch.proto.messages import load_solver_from_string
    from poseidon_tpu_torch.runtime.engine import Engine

    extra = "test_iter: 3\ntest_interval: 2\ntest_initialization: false"
    outs, metrics = {}, {}
    for side, batch, load, cls, kw in (
            ("jax", 1, jload, JaxEngine, {}),
            ("port", N_DEV, load_solver_from_string, Engine,
             {"device": "cpu"})):
        net = tmp_path / f"{side}_test_net.prototxt"
        net.write_text(TEST_NET % {"batch": batch})
        out = tmp_path / side
        out.mkdir()
        eng = cls(load(SOLVER % {"net": net, "extra": extra}),
                  memory_data=_memory_data(), output_dir=str(out), **kw)
        try:
            eng.train()
            metrics[side] = eng.test(0)
        finally:
            eng.close()
        outs[side] = _read(out / "dumps/train_feats.h5")
    got, want = outs["port"], outs["jax"]
    assert got["feat"].shape == want["feat"].shape == (3 * N_DEV, 3)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["feat"], want["feat"], **TOL)
    assert set(metrics["port"]) == set(metrics["jax"])
    for k in metrics["jax"]:
        np.testing.assert_allclose(metrics["port"][k], metrics["jax"][k],
                                   **TOL)


def _warnings(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("WARNING") and "HDF5_OUTPUT" in ln]


@pytest.mark.parametrize("case", ["staleness", "iter_size"])
def test_warnings_match_jax(tmp_path, capsys, case):
    kw = ({"staleness": 1} if case == "staleness"
          else {"extra": "iter_size: 2"})
    capsys.readouterr()
    jout = _run_jax(tmp_path, **kw)
    want = _warnings(capsys)
    pout = _run_port(tmp_path, **kw)
    got = _warnings(capsys)
    assert got == want and len(got) == 1
    if case == "staleness":
        assert not (jout / "dumps").exists()
        assert not (pout / "dumps").exists()
    else:
        # the dump ran at iter_size 1: the batch of one iteration
        feats = _read(pout / "dumps/train_feats.h5")["feat"]
        assert feats.shape == (N_DEV, 3)


def test_h5py_is_imported_only_for_a_net_with_the_layer():
    """The port imports ``h5py`` lazily: the engine and a net of every
    other layer type leave it out of ``sys.modules`` (the card machine
    may not have it)."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from poseidon_tpu_torch.runtime import engine\n"
        "from poseidon_tpu_torch.core.net import Net\n"
        "from poseidon_tpu_torch.models import zoo\n"
        "from poseidon_tpu_torch.proto.messages import load_net\n"
        "Net(zoo.googlenet(), 'TRAIN', device='cpu',\n"
        "    source_shapes=zoo.googlenet_shapes(1))\n"
        "Net(load_net('examples/catalog/layer_catalog.prototxt'), 'TRAIN',\n"
        "    device='cpu')\n"
        "assert 'h5py' not in sys.modules\n")
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
