"""The port's native data plane (``poseidon_tpu_torch/data/native.py`` over
``native/poseidon_dataplane.cc``) against the JAX package's, on the CPU.

Batches must match bit for bit: the port's ``NativeLMDBBatcher`` and
``BatchPipeline(use_native=True)`` against JAX's, f32 and uint8, over
several batches and an epoch wrap, TRAIN crop and mirror and TEST center
crop, ``mean_file`` and ``mean_value``; the uint8 probe over float_data
records and the mixed-DB re-quantization; and the card's half of the uint8
split (``runtime/engine.device_input_transform``) bitwise against the f32
batch. Tolerance: none anywhere in this file (bitwise).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from poseidon_tpu.data import native as jnative
from poseidon_tpu.data import snappy as jsnappy
from poseidon_tpu.data.pipeline import BatchPipeline as JaxPipeline
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.data import native, snappy
from poseidon_tpu_torch.data.lmdb_reader import LMDBWriter
from poseidon_tpu_torch.data.pipeline import BatchPipeline
from poseidon_tpu_torch.proto import wire
from poseidon_tpu_torch.proto.messages import load_net_from_string
from poseidon_tpu_torch.runtime.engine import device_input_transform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RECORDS, SHAPE = 64, (3, 12, 12)
# 6 batches of 24 over 64 records: two epoch wraps
N_BATCHES, BATCH = 6, 24

LAYER = """
layers { name: "d" type: DATA top: "data" top: "label"
  include { phase: %(phase)s }
  data_param { source: "%(src)s" batch_size: %(batch)d backend: %(backend)s }
  transform_param { %(tp)s } }
"""


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """(LMDB path, mean binaryproto path, per-record arrays)."""
    root = tmp_path_factory.mktemp("native")
    path = str(root / "lmdb")
    rs = np.random.RandomState(0)
    w = LMDBWriter(path)
    arrays = []
    for i in range(N_RECORDS):
        arr = rs.randint(0, 256, size=SHAPE).astype(np.uint8)
        arrays.append(arr)
        w.put(f"{i:08d}".encode(), wire.encode_datum(wire.Datum(
            *SHAPE, data=arr.tobytes(), label=int(rs.randint(10)))))
    w.close()
    mean = str(root / "mean.binaryproto")
    with open(mean, "wb") as f:
        f.write(wire.encode_blob(
            (rs.rand(1, *SHAPE) * 200).astype(np.float32)))
    return path, mean, arrays


def _layers(src, phase, tp, backend="LMDB", batch=BATCH):
    text = LAYER % dict(phase=phase, src=src, tp=tp, backend=backend,
                        batch=batch)
    return (load_net_from_string(text).layers[0],
            jax_load_str(text).layers[0])


def _take(pipe, n):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def _assert_same(port, ref):
    for b, (a, r) in enumerate(zip(port, ref)):
        assert set(a) == set(r)
        for k in a:
            assert a[k].dtype == r[k].dtype, (b, k)
            np.testing.assert_array_equal(a[k], r[k], err_msg=f"{b}/{k}")


TRANSFORMS = {
    "crop_mirror_mean_file": ("TRAIN", 'crop_size: 8 mirror: true '
                                       'mean_file: "%(mean)s" scale: 0.5'),
    "crop_mirror_mean_value": ("TRAIN", "crop_size: 9 mirror: true "
                                        "mean_value: 104 mean_value: 117 "
                                        "mean_value: 123 "
                                        "scale: 0.00390625"),
    "one_mean_value_scale": ("TRAIN", "crop_size: 10 mean_value: 33 "
                                      "scale: 0.017"),
    "test_center_crop_mean_value": ("TEST", "crop_size: 8 mean_value: 3 "
                                            "mean_value: 4 mean_value: 5"),
    "test_center_crop_mean_file": ("TEST", 'crop_size: 6 '
                                           'mean_file: "%(mean)s"'),
    "no_crop_scale": ("TRAIN", "scale: 0.25"),
    "plain": ("TRAIN", ""),
}


@pytest.mark.parametrize("device_transform", [False, True])
@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_native_pipeline_matches_jax_bitwise(db, case, device_transform):
    path, mean, _ = db
    phase, tp = TRANSFORMS[case]
    lp, jlp = _layers(path, phase, tp % {"mean": mean})
    port = BatchPipeline(lp, phase, BATCH, seed=7,
                         device_transform=device_transform)
    ref = JaxPipeline(jlp, phase, BATCH, seed=7, use_native=True,
                      device_transform=device_transform)
    assert ref.native is not None
    spec, jspec = port.device_transform_spec, ref.device_transform_spec
    assert (spec is None) == (jspec is None)
    # a mean_file stays on the host; everything else ships uint8 when asked
    u8 = device_transform and "mean_file" not in case
    assert port.route == ("native-u8" if u8 else "native")
    assert (spec is not None) == u8
    if spec is not None:
        assert spec["scale"] == jspec["scale"]
        if jspec["mean_values"] is None:
            assert spec["mean_values"] is None
        else:
            np.testing.assert_array_equal(spec["mean_values"],
                                          jspec["mean_values"])
    got, want = _take(port, N_BATCHES), _take(ref, N_BATCHES)
    _assert_same(got, want)
    assert got[0]["data"].dtype == (np.uint8 if u8 else np.float32)


@pytest.mark.parametrize("train,crop,mirror", [
    (True, 8, True), (True, 0, False), (False, 10, True), (False, 0, False)])
def test_native_batcher_matches_jax(db, train, crop, mirror):
    path, mean, _ = db
    mean_arr = wire.read_blob_file(mean)[0]
    kw = dict(crop_size=crop, mirror=mirror, train=train, scale=0.75)
    for extra in ({}, {"mean": mean_arr},
                  {"mean_values": np.asarray([1.5, 2.0, 3.25], np.float32)}):
        b = native.NativeLMDBBatcher(path, **kw, **extra)
        j = jnative.NativeLMDBBatcher(path, **kw, **extra)
        try:
            assert len(b) == len(j) == N_RECORDS
            assert b.record_shape == j.record_shape == SHAPE
            assert b.out_shape == j.out_shape
            idx = np.random.RandomState(3).randint(0, N_RECORDS, size=20)
            for seed in (0, 11, 2 ** 40 + 5):
                for name in ("batch", "batch_u8"):
                    got = getattr(b, name)(idx, seed=seed)
                    want = getattr(j, name)(idx, seed=seed)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype
                        np.testing.assert_array_equal(g, w)
        finally:
            b.close()
            j.close()


def test_native_reads_the_records(db):
    path, _, arrays = db
    b = native.NativeLMDBBatcher(path, train=False)
    try:
        data, _ = b.batch(np.arange(N_RECORDS))
        for i in range(N_RECORDS):
            np.testing.assert_array_equal(data[i],
                                          arrays[i].astype(np.float32))
    finally:
        b.close()


@pytest.mark.parametrize("case", ["crop_mirror_mean_value",
                                  "one_mean_value_scale", "no_crop_scale",
                                  "plain"])
def test_device_transform_is_the_host_f32_batch_bitwise(db, case):
    """The card's half of the uint8 split, run here on CPU tensors: uint8
    to f32, minus the per-channel mean, times the scale, in the order of
    the native batcher's transform_one."""
    path, _, _ = db
    phase, tp = TRANSFORMS[case]
    lp, _ = _layers(path, phase, tp)
    u8 = BatchPipeline(lp, phase, BATCH, seed=2, device_transform=True)
    f32 = BatchPipeline(lp, phase, BATCH, seed=2)
    transform = device_input_transform([u8], "cpu")
    assert transform is not None
    for b_u8, b_f32 in zip(_take(u8, 3), _take(f32, 3)):
        out = transform({k: torch.from_numpy(v) for k, v in b_u8.items()})
        assert out["data"].dtype == torch.float32
        np.testing.assert_array_equal(out["data"].numpy(), b_f32["data"])
        np.testing.assert_array_equal(out["label"].numpy(), b_f32["label"])
    assert device_input_transform([f32], "cpu") is None


def _float_db(path, n, float_at, seed=3):
    """An LMDB of 2x6x6 records: float_data Datums at ``float_at``, byte
    Datums elsewhere (float values integral in [0, 255])."""
    rs = np.random.RandomState(seed)
    w = LMDBWriter(path)
    for i in range(n):
        arr = rs.randint(0, 256, size=(2, 6, 6))
        if i in float_at:
            d = wire.Datum(2, 6, 6, b"", label=i % 3,
                           float_data=arr.astype(np.float32).ravel())
        else:
            d = wire.Datum(2, 6, 6, arr.astype(np.uint8).tobytes(),
                           label=i % 3)
        w.put(f"{i:08d}".encode(), wire.encode_datum(d))
    w.close()


def test_float_data_probe_keeps_the_host_path(tmp_path):
    """float_data Datums cannot ship as uint8: the probe turns the uint8
    path off and the batches are f32, as JAX's."""
    path = str(tmp_path / "float_lmdb")
    _float_db(path, 8, float_at=set(range(8)))
    lp, jlp = _layers(path, "TRAIN", "scale: 0.5", batch=4)
    port = BatchPipeline(lp, "TRAIN", 4, device_transform=True)
    ref = JaxPipeline(jlp, "TRAIN", 4, device_transform=True)
    assert port.device_transform_spec is None and port.route == "native"
    got, want = _take(port, 4), _take(ref, 4)
    _assert_same(got, want)
    assert got[0]["data"].dtype == np.float32


def test_mixed_db_requantizes_with_one_warning(tmp_path, capfd):
    """Byte records at every probed position, float_data elsewhere: the
    uint8 contract holds by re-quantizing the batches that meet a float
    record, bit for bit as JAX's, and warns once."""
    path = str(tmp_path / "mixed_lmdb")
    n = 40
    probe = set(np.unique(np.linspace(0, n - 1, num=8, dtype=np.int64))
                .tolist())
    _float_db(path, n, float_at={i for i in range(n)
                                 if i not in probe and i % 3 == 0})
    tp = "mean_value: 10 mean_value: 20 scale: 0.5 mirror: true"
    lp, jlp = _layers(path, "TRAIN", tp, batch=8)
    port = BatchPipeline(lp, "TRAIN", 8, seed=1, device_transform=True)
    assert port.route == "native-u8"
    got = _take(port, 10)
    port_err = capfd.readouterr().err
    ref = JaxPipeline(jlp, "TRAIN", 8, seed=1, device_transform=True)
    want = _take(ref, 10)
    _assert_same(got, want)
    assert port_err.count("re-quantized to uint8") == 1


def test_native_snappy_matches_python():
    """The C++ decoder against the Python codec (and the JAX package's) on
    literals, hand-made copy elements and malformed streams."""
    lib = native.library()
    rs = np.random.RandomState(1)
    for n in [0, 1, 60, 300, 70000]:
        comp = snappy.compress(rs.bytes(n))
        assert native.snappy_uncompress(comp, lib) == \
            snappy._uncompress_py(comp) == jsnappy._uncompress_py(comp)
    for blob, want in (
            (bytes([8, 3 << 2]) + b"abcd" + bytes([1, 4]), b"abcdabcd"),
            (bytes([8, 1 << 2]) + b"ab" + bytes([(2 << 2) | 1, 2]),
             b"abababab"),
            (bytes([5, 1 << 2]) + b"xy" + bytes([((3 - 1) << 2) | 2, 2, 0]),
             b"xyxyx")):
        assert native.snappy_uncompress(blob, lib) == want
        assert snappy.uncompress(blob) == want      # the library is built
    with pytest.raises(ValueError):
        native.snappy_uncompress(bytes([200, 1, 3 << 2]) + b"abcd", lib)
    with pytest.raises(snappy.SnappyError):
        snappy.uncompress(bytes([200, 1, 3 << 2]) + b"abcd")


def test_library_builds_into_the_port_build_dir():
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == \
        __import__("pathlib").Path(REPO) / "build" / "poseidon_tpu_torch"
    assert path.name.startswith("libposeidon_dataplane-")
    native.library()
    assert path.exists()
    # never the JAX binding's output path
    assert path != __import__("pathlib").Path(jnative._LIB)


_BUILD_ONE = r"""
import sys
from pathlib import Path
from poseidon_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
native.library()
print(native.lib_path().name)
"""


def test_concurrent_builds_land_one_whole_library(tmp_path):
    """Several processes building at once (the tier-1 sweep runs workers in
    parallel): each writes a temporary file and renames it into place, so
    every one loads a whole library and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    names = set()
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        names.add(out.strip())
    assert len(names) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(names)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    for _ in range(2):      # and again, with the same output
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
            native.library()
        assert "broken.cc" in str(err.value)
    lp, _ = _layers(str(tmp_path / "db"), "TRAIN", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        BatchPipeline(lp, "TRAIN", 2)
    assert native.built_library() is None
    assert list((tmp_path / "build").iterdir()) == []


def test_failed_open_raises_instead_of_the_python_path(tmp_path):
    lp, _ = _layers(str(tmp_path / "missing_lmdb"), "TRAIN", "")
    with pytest.raises(IOError, match="cannot open"):
        BatchPipeline(lp, "TRAIN", 2)
    with pytest.raises(IOError, match="cannot open"):
        native.NativeLMDBBatcher(str(tmp_path / "missing_lmdb"))


def test_crop_larger_than_the_record_raises(db):
    path, _, _ = db
    with pytest.raises(ValueError, match="crop_size 13"):
        native.NativeLMDBBatcher(path, crop_size=13)


def test_routes(db, tmp_path):
    """Native for DATA over LMDB (also a LEVELDB layer over a converted
    LMDB, as JAX's batcher opens it); Python when asked, and for the
    sources the reference routes there by design."""
    path, _, _ = db
    lp, _ = _layers(path, "TRAIN", "")
    lp_level, _ = _layers(path, "TRAIN", "", backend="LEVELDB")
    pipes = [BatchPipeline(lp, "TRAIN", 4),
             BatchPipeline(lp, "TRAIN", 4, use_native=False),
             BatchPipeline(lp_level, "TRAIN", 4)]
    try:
        assert [p.route for p in pipes] == ["native", "python", "native"]
        assert pipes[1].native is None and pipes[1].source is not None
    finally:
        for p in pipes:
            p.close()
    mem = load_net_from_string(
        'layers { name: "m" type: MEMORY_DATA top: "data" top: "label" '
        'memory_data_param { batch_size: 4 channels: 3 height: 12 '
        'width: 12 } }').layers[0]
    data = np.zeros((8, *SHAPE), np.float32)
    pipe = BatchPipeline(mem, "TRAIN", 4,
                         memory_data={"data": data, "label": np.arange(8)})
    try:
        assert pipe.route == "python"
    finally:
        pipe.close()


def test_shared_file_system_reads_the_shard_suffix(db, tmp_path):
    """``shared_file_system``: shard k reads ``<source>_k``, in both
    packages, through the native batcher."""
    path, _, _ = db
    base = str(tmp_path / "part")
    for k in range(2):
        os.symlink(path, f"{base}_{k}")
    text = (LAYER % dict(phase="TRAIN", src=base, tp="crop_size: 8",
                         backend="LMDB", batch=8)).replace(
        "backend: LMDB", "backend: LMDB shared_file_system: true")
    from poseidon_tpu.data.workload import Shard as JShard
    from poseidon_tpu_torch.data.workload import Shard
    for k in range(2):
        port = BatchPipeline(load_net_from_string(text).layers[0], "TRAIN",
                             8, shard=Shard(k, 2))
        ref = JaxPipeline(jax_load_str(text).layers[0], "TRAIN", 8,
                          shard=JShard(k, 2))
        assert port.route == "native"
        _assert_same(_take(port, 3), _take(ref, 3))
