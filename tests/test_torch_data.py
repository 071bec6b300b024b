"""The port's data plane against the JAX package's: LMDB reader and
writer, Datum/BlobProto codecs, the transformer and the batch pipeline.

Batches must match bit for bit: the same epoch permutation, the same
transformer draws from the same seed, the same f32 arithmetic (crop,
mean subtraction at the source crop position, mirror, scale).
"""

import os

import numpy as np
import pytest

from poseidon_tpu.data.lmdb_reader import LMDBReader as JaxReader
from poseidon_tpu.data.lmdb_reader import LMDBWriter as JaxWriter
from poseidon_tpu.data.pipeline import BatchPipeline as JaxPipeline
from poseidon_tpu.proto import wire as jwire
from poseidon_tpu.proto.messages import load_net as jax_load_net
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.data import workload
from poseidon_tpu_torch.data.lmdb_reader import LMDBReader, LMDBWriter
from poseidon_tpu_torch.data.pipeline import (BatchPipeline,
                                              build_phase_pipelines)
from poseidon_tpu_torch.proto import wire
from poseidon_tpu_torch.proto.messages import load_net, load_net_from_string

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BATCHES = 5


def _data_layer(net_param, phase):
    return next(lp for lp in net_param.layers
                if lp.canonical_type() == "DATA"
                and any(r.phase == phase for r in lp.include))


def _batches(pipe, n):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def _assert_same_batches(port, ref):
    for b, (a, r) in enumerate(zip(port, ref)):
        assert set(a) == set(r)
        for k in a:
            assert a[k].dtype == r[k].dtype, (b, k)
            np.testing.assert_array_equal(a[k], r[k], err_msg=f"{b}/{k}")


@pytest.mark.parametrize("prototxt,phase,batch", [
    ("examples/digits/digits_train_test.prototxt", "TRAIN", 16),   # mean file
    ("examples/mnist/lenet_train_test.prototxt", "TRAIN", 16),     # scale
    ("examples/mnist/lenet_train_test.prototxt", "TEST", 20),      # no shuffle
])
def test_pipeline_matches_jax_python_path(prototxt, phase, batch,
                                          monkeypatch):
    monkeypatch.chdir(REPO)
    lp = _data_layer(load_net(prototxt), phase)
    jlp = _data_layer(jax_load_net(prototxt), phase)
    port = _batches(BatchPipeline(lp, phase, batch, seed=0, use_native=False),
                    N_BATCHES)
    ref = _batches(JaxPipeline(jlp, phase, batch, seed=0, use_native=False),
                   N_BATCHES)
    _assert_same_batches(port, ref)


def _write_db(path, n, shape, seed, writer=LMDBWriter):
    rs = np.random.RandomState(seed)
    w = writer(path)
    for i in range(n):
        img = rs.randint(0, 256, size=shape).astype(np.uint8)
        d = wire.Datum(channels=shape[0], height=shape[1], width=shape[2],
                       data=img.tobytes(), label=int(rs.randint(10)))
        w.put(f"{i:08d}".encode(), wire.encode_datum(d))
    w.close()


CROP_NET = """
name: "crop"
layers { name: "d" type: DATA top: "data" top: "label"
  include { phase: TRAIN }
  data_param { source: "%s" batch_size: 6 backend: LMDB }
  transform_param { crop_size: 9 mirror: true mean_file: "%s"
                    scale: 0.5 } }
layers { name: "d" type: DATA top: "data" top: "label"
  include { phase: TEST }
  data_param { source: "%s" batch_size: 4 backend: LMDB }
  transform_param { crop_size: 9 mean_value: 3 mean_value: 4
                    mean_value: 5 } }
"""


def test_crop_mirror_mean_match_jax_on_port_written_lmdb(tmp_path):
    db = str(tmp_path / "db")
    _write_db(db, 23, (3, 12, 13), seed=1)
    mean = str(tmp_path / "mean.binaryproto")
    with open(mean, "wb") as f:
        f.write(wire.encode_blob(np.random.RandomState(2).rand(1, 3, 12, 13)
                                 .astype(np.float32) * 50))
    text = CROP_NET % (db, mean, db)
    for phase, batch in (("TRAIN", 6), ("TEST", 4)):
        lp = _data_layer(load_net_from_string(text), phase)
        jlp = _data_layer(jax_load_str(text), phase)
        port = _batches(BatchPipeline(lp, phase, batch, seed=3,
                                      use_native=False), N_BATCHES)
        ref = _batches(JaxPipeline(jlp, phase, batch, seed=3,
                                   use_native=False), N_BATCHES)
        _assert_same_batches(port, ref)
        assert port[0]["data"].shape == (batch, 3, 9, 9)


def test_lmdb_written_by_either_package_reads_in_both(tmp_path):
    for i, writer in enumerate((LMDBWriter, JaxWriter)):
        path = str(tmp_path / f"db{i}")
        _write_db(path, 300, (1, 28, 28), seed=4 + i, writer=writer)
        port, ref = LMDBReader(path), JaxReader(path)
        try:
            assert len(port) == len(ref) == 300
            for j in (0, 1, 150, 299):
                assert port.key_at(j) == ref.key_at(j)
                assert port.value_at(j) == ref.value_at(j)
        finally:
            port.close()
            ref.close()


def test_datum_blob_and_caffemodel_codecs_match_jax():
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, size=(3, 4, 5)).astype(np.uint8)
    d = wire.Datum(channels=3, height=4, width=5, data=img.tobytes(),
                   label=7)
    jd = jwire.Datum(channels=3, height=4, width=5, data=img.tobytes(),
                     label=7)
    assert wire.encode_datum(d) == jwire.encode_datum(jd)
    back = wire.decode_datum(jwire.encode_datum(jd))
    np.testing.assert_array_equal(back.to_array(), img.astype(np.float32))
    assert back.label == 7
    floats = wire.Datum(channels=1, height=2, width=2, label=1,
                        float_data=np.arange(4, dtype=np.float32))
    jf = jwire.decode_datum(wire.encode_datum(floats))
    np.testing.assert_array_equal(jf.to_array(), floats.to_array())
    arr = rs.randn(2, 3).astype(np.float32)
    assert wire.encode_blob(arr) == jwire.encode_blob(arr)
    weights = {"conv1": [rs.randn(4, 3, 2, 2).astype(np.float32),
                         rs.randn(4).astype(np.float32)]}
    model = wire.encode_caffemodel("n", weights)
    assert model == jwire.encode_caffemodel("n", weights)
    for a, b in zip(jwire.decode_caffemodel(model)["conv1"],
                    weights["conv1"]):
        np.testing.assert_array_equal(a.reshape(b.shape), b)


def test_shard_indices_and_phase_pipelines(monkeypatch):
    from poseidon_tpu.data import workload as jworkload
    for n, count in ((10, 3), (7, 1)):
        for i in range(count):
            a = workload.shard_indices(n, workload.Shard(i, count), epoch=2)
            b = jworkload.shard_indices(n, jworkload.Shard(i, count), epoch=2)
            np.testing.assert_array_equal(a, b)
    monkeypatch.chdir(REPO)
    pipes, shapes = build_phase_pipelines(
        load_net("examples/digits/digits_train_test.prototxt"), "TEST")
    for p in pipes:
        p.close()
    assert shapes == {"data": (60, 1, 8, 8), "label": (60,)}


def test_unported_sources_raise_naming_them(tmp_path):
    """LEVELDB and MEMORY_DATA are in the port now (tests/test_torch_
    leveldb.py, test_torch_pipeline_overlap.py); the sources still to port
    raise naming themselves."""
    for kind, param in (("IMAGE_DATA", "image_data_param"),
                        ("HDF5_DATA", "hdf5_data_param"),
                        ("WINDOW_DATA", "window_data_param")):
        text = (f'layers {{ name: "d" type: {kind} top: "data" '
                f'top: "label" {param} {{ source: "x" batch_size: 2 }} }}')
        lp = load_net_from_string(text).layers[0]
        with pytest.raises(NotImplementedError, match=kind):
            BatchPipeline(lp, "TRAIN", 2)
