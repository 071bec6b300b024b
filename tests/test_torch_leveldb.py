"""The port's LevelDB reader, snappy codec and LEVELDB data layer against
the JAX package's, on the CPU.

Reads must be bitwise equal to JAX's ``LevelDBReader``: the same keys in
the same order and the same value bytes, on databases written by either
package (raw and snappy blocks), a WAL-only database and a compacted
multi-level one (tables at three levels, a table the manifest deleted, a
log below the manifest's log number and a live log with overwrites and
deletions). Batches of a LEVELDB DATA layer match JAX's Python path bit
for bit. Tolerance: none (bitwise).
"""

import os
import struct

import numpy as np
import pytest

from poseidon_tpu.data import leveldb_reader as jldb
from poseidon_tpu.data import snappy as jsnappy
from poseidon_tpu.data.pipeline import BatchPipeline as JaxPipeline
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.data import leveldb_reader as ldb
from poseidon_tpu_torch.data import snappy
from poseidon_tpu_torch.data.pipeline import BatchPipeline
from poseidon_tpu_torch.proto import wire
from poseidon_tpu_torch.proto.messages import load_net_from_string


def _assert_same_db(path):
    port, ref = ldb.LevelDBReader(path), jldb.LevelDBReader(path)
    assert len(port) == len(ref)
    assert list(iter(port)) == list(iter(ref))
    for i in (0, len(ref) // 2, len(ref) - 1):
        if len(ref):
            assert port.key_at(i) == ref.key_at(i)
            assert port.value_at(i) == ref.value_at(i)
    return dict(iter(port))


def test_crc32c_known_vectors():
    assert ldb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert ldb.crc32c(b"123456789") == 0xE3069283
    data = np.random.RandomState(0).bytes(1000)
    assert ldb.crc32c_masked(data) == jldb.crc32c_masked(data)


@pytest.mark.parametrize("n", [0, 1, 59, 60, 61, 300, 70000])
def test_snappy_roundtrip_matches_jax(n):
    data = np.random.RandomState(n).bytes(n)
    comp = snappy.compress(data)
    assert comp == jsnappy.compress(data)
    assert snappy._uncompress_py(comp) == data
    assert snappy.uncompress(comp) == jsnappy.uncompress(comp) == data


def test_snappy_copy_elements():
    blob = bytes([8, 3 << 2]) + b"abcd" + bytes([1, 4])
    assert snappy._uncompress_py(blob) == b"abcdabcd"
    blob2 = bytes([8, 1 << 2]) + b"ab" + bytes([(2 << 2) | 1, 2])
    assert snappy._uncompress_py(blob2) == b"abababab"
    with pytest.raises(snappy.SnappyError):
        snappy._uncompress_py(bytes([200, 1, 3 << 2]) + b"abcd")


def test_snappy_uses_python_until_the_library_is_built(monkeypatch):
    from poseidon_tpu_torch.data import native
    monkeypatch.setattr(native, "built_library", lambda: None)
    monkeypatch.setattr(native, "snappy_uncompress", None)  # never called
    comp = snappy.compress(b"hello " * 50)
    assert snappy.uncompress(comp) == b"hello " * 50


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_leveldb_written_by_either_package_reads_bitwise(tmp_path, compress,
                                                         writer):
    path = str(tmp_path / "db")
    cls = ldb.LevelDBWriter if writer == "port" else jldb.LevelDBWriter
    w = cls(path, compress=compress)
    rs = np.random.RandomState(0)
    values = {}
    for i in range(500):  # several blocks
        key = f"{i:08d}".encode()
        values[key] = rs.bytes(rs.randint(20, 400))
        w.put(key, values[key])
    w.close()
    assert _assert_same_db(path) == values


def _batch_record(ops, seq):
    """A WriteBatch: ops of (type, key, value-or-None)."""
    out = bytearray(struct.pack("<Q", seq) + struct.pack("<I", len(ops)))
    for op, key, val in ops:
        out.append(op)
        ldb._write_varint(out, len(key))
        out += key
        if val is not None:
            ldb._write_varint(out, len(val))
            out += val
    return bytes(out)


def _log_file(path, records):
    with open(path, "wb") as f:
        for payload in records:
            f.write(struct.pack("<IHB", ldb.crc32c_masked(
                bytes([ldb.LOG_FULL]) + payload), len(payload),
                ldb.LOG_FULL) + payload)


def test_log_only_db_replays_with_deletions(tmp_path):
    path = tmp_path / "db"
    path.mkdir()
    _log_file(path / "000003.log", [_batch_record(
        [(ldb.TYPE_VALUE, b"a", b"1"), (ldb.TYPE_VALUE, b"b", b"2"),
         (ldb.TYPE_DELETION, b"a", None)], 1)])
    assert _assert_same_db(str(path)) == {b"b": b"2"}


def _table(path, entries, compress):
    """One SSTable of (key, seq, type, value) entries, sorted by key;
    returns (size, smallest, largest) internal keys."""
    w = ldb.LevelDBWriter(str(os.path.dirname(path)), compress=compress)
    w.BLOCK_SIZE = 256       # several blocks a table
    index, block, nbytes = [], [], 0
    ikeys = [k + struct.pack("<Q", (s << 8) | t) for k, s, t, _ in entries]
    with open(path, "wb") as f:
        for ikey, (_, _, _, v) in zip(ikeys, entries):
            block.append((ikey, v))
            nbytes += len(ikey) + len(v) + 8
            if nbytes >= w.BLOCK_SIZE:
                index.append((block[-1][0],
                              w._emit_block(f, w._build_block(block))))
                block, nbytes = [], 0
        if block:
            index.append((block[-1][0],
                          w._emit_block(f, w._build_block(block))))
        meta = w._emit_block(f, w._build_block([]))
        idx = w._emit_block(f, w._build_block(index))
        footer = bytearray(meta + idx)
        footer += b"\0" * (40 - len(footer))
        f.write(bytes(footer) + struct.pack("<Q", ldb.TABLE_MAGIC))
        return f.tell(), ikeys[0], ikeys[-1]


def _edit(log_number=None, new=(), deleted=()):
    out = bytearray()
    if log_number is not None:
        ldb._write_varint(out, 1)
        name = b"leveldb.BytewiseComparator"
        ldb._write_varint(out, len(name))
        out += name
        for tag, v in ((2, log_number), (3, log_number + 1), (4, 10 ** 6)):
            ldb._write_varint(out, tag)
            ldb._write_varint(out, v)
    for level, num, (size, small, large) in new:
        for v in (7, level, num, size, len(small)):
            ldb._write_varint(out, v)
        out += small
        ldb._write_varint(out, len(large))
        out += large
    for level, num in deleted:
        for v in (6, level, num):
            ldb._write_varint(out, v)
    return bytes(out)


@pytest.mark.parametrize("compress", [False, True])
def test_compacted_multi_level_db_reads_bitwise(tmp_path, compress):
    """Tables at levels 2, 1 and 0 with newer sequences overwriting and
    deleting older keys, a table the manifest deleted after a compaction,
    a log the manifest's log number retires, and a live log on top."""
    path = tmp_path / "db"
    path.mkdir()
    rs = np.random.RandomState(1)
    val = lambda: rs.bytes(rs.randint(5, 120))  # noqa: E731
    lvl2 = [(f"k{i:04d}".encode(), 10 + i, ldb.TYPE_VALUE, val())
            for i in range(0, 120)]
    lvl1 = [(f"k{i:04d}".encode(), 500 + i,
             ldb.TYPE_DELETION if i % 7 == 0 else ldb.TYPE_VALUE,
             b"" if i % 7 == 0 else val()) for i in range(40, 160, 2)]
    lvl0 = [(f"k{i:04d}".encode(), 900 + i, ldb.TYPE_VALUE, val())
            for i in range(100, 200, 5)]
    gone = [(f"k{i:04d}".encode(), 2000 + i, ldb.TYPE_VALUE, b"stale")
            for i in range(0, 50)]
    meta = {n: _table(str(path / f"{n:06d}.ldb"), e, compress)
            for n, e in ((4, lvl2), (5, lvl1), (6, lvl0), (7, gone))}
    _log_file(path / "MANIFEST-000002", [
        _edit(log_number=8, new=[(2, 4, meta[4]), (1, 7, meta[7])]),
        _edit(new=[(1, 5, meta[5]), (0, 6, meta[6])], deleted=[(1, 7)])])
    (path / "CURRENT").write_text("MANIFEST-000002\n")
    # retired by the manifest's log number 8: must not be replayed
    _log_file(path / "000003.log", [_batch_record(
        [(ldb.TYPE_VALUE, b"k0001", b"retired")], 3000)])
    _log_file(path / "000008.log", [
        _batch_record([(ldb.TYPE_VALUE, b"k0002", b"from-the-log"),
                       (ldb.TYPE_DELETION, b"k0110", None),
                       (ldb.TYPE_VALUE, b"z-new", b"appended")], 5000)])
    got = _assert_same_db(str(path))
    assert got[b"k0002"] == b"from-the-log" and b"k0110" not in got
    assert got[b"k0001"] == lvl2[1][3] and b"stale" not in got.values()
    assert b"k0042" not in got and got[b"z-new"] == b"appended"
    assert got[b"k0105"] == dict((k, v) for k, _, _, v in lvl0)[b"k0105"]


def _datum_db(path, n, shape, seed, writer=ldb.LevelDBWriter):
    rs = np.random.RandomState(seed)
    w = writer(path)
    for i in range(n):
        arr = rs.randint(0, 256, size=shape).astype(np.uint8)
        w.put(f"{i:08d}".encode(), wire.encode_datum(wire.Datum(
            *shape, data=arr.tobytes(), label=int(rs.randint(10)))))
    w.close()


LAYER = """
layers { name: "d" type: DATA top: "data" top: "label"
  data_param { source: "%s" batch_size: 5 %s }
  transform_param { crop_size: 5 mirror: true mean_value: 7 scale: 0.5 } }
"""


@pytest.mark.parametrize("backend", ["", "backend: LEVELDB"])
def test_leveldb_data_layer_matches_jax(tmp_path, backend):
    """A DATA layer on the default backend (LEVELDB) takes the Python path
    in both packages; its batches match JAX's bit for bit."""
    path = str(tmp_path / "db")
    _datum_db(path, 23, (3, 6, 7), seed=2)
    text = LAYER % (path, backend)
    port = BatchPipeline(load_net_from_string(text).layers[0], "TRAIN", 5,
                         seed=4)
    ref = JaxPipeline(jax_load_str(text).layers[0], "TRAIN", 5, seed=4)
    try:
        assert port.route == "python" and ref.native is None
        for _ in range(7):       # past an epoch wrap
            a, b = next(port), next(ref)
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        port.close()
        ref.close()


def test_leveldb_source_reads_datums(tmp_path):
    from poseidon_tpu_torch.data.sources import LevelDBSource
    path = str(tmp_path / "db")
    _datum_db(path, 12, (3, 5, 5), seed=1, writer=jldb.LevelDBWriter)
    src = LevelDBSource(path)
    assert len(src) == 12 and src.record_shape == (3, 5, 5)
    ref = jldb.LevelDBReader(path)
    for i in (0, 7, 11):
        arr, label = src.read(i)
        d = wire.decode_datum(ref.value_at(i))
        np.testing.assert_array_equal(arr, d.to_array())
        assert label == d.label


def test_not_a_leveldb_raises(tmp_path):
    with pytest.raises(ldb.LevelDBError, match="not a LevelDB"):
        ldb.LevelDBReader(str(tmp_path / "missing"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ldb.LevelDBError, match="no LevelDB files"):
        ldb.LevelDBReader(str(tmp_path / "empty"))
