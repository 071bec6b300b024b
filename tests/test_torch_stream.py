"""The port's ``data/stream.py`` and ``data/libsvm.py`` against the JAX
package's, on the same files: ``tests/test_stream.py``'s cases, each run
through both streamers, the results held equal (labels, indices and values
exactly; the dense batches bitwise). Every streamer is shut down and its IO
thread joined."""

import time

import numpy as np
import pytest

from poseidon_tpu.data import libsvm as jlibsvm
from poseidon_tpu.data import stream as jstream
from poseidon_tpu.data.snappy import compress
from poseidon_tpu_torch.data import libsvm, stream


def _write_libsvm_files(tmp_path, n_files=4, rows_per_file=25, dim=12):
    rs = np.random.RandomState(0)
    rows = []
    for fi in range(n_files):
        lines = []
        for _ in range(rows_per_file):
            label = int(rs.randint(0, 2))
            nnz = rs.randint(1, 5)
            idxs = sorted(rs.choice(dim, size=nnz, replace=False))
            toks = " ".join(f"{i + 1}:{(i + 1) * 0.5}" for i in idxs)
            lines.append(f"{label} {toks}")
            rows.append((float(label), idxs))
        (tmp_path / f"part_{fi}").write_text("\n".join(lines) + "\n")
    return rows


def _drain(streamer, n):
    got = []
    while True:
        chunk = streamer.get_next_data(n)
        if not chunk:
            return got
        got.extend(chunk)


def _both(cfg_kw, fn):
    """fn(streamer) on the port's and on JAX's streamer; both shut down,
    the port's IO thread joined."""
    out = []
    for mod in (stream, jstream):
        s = mod.DiskStreamer(mod.DiskStreamConfig(**cfg_kw),
                             mod.LibSVMParser())
        try:
            out.append(fn(s))
        finally:
            s.shutdown()
        if mod is stream:
            assert not s._io.is_alive()
    return out


def _rows_equal(a, b):
    assert len(a) == len(b)
    for (al, ai, av), (bl, bi, bv) in zip(a, b):
        assert al == bl
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(av, bv)
        assert ai.dtype == bi.dtype and av.dtype == bv.dtype


def test_streamer_yields_all_records_in_order(tmp_path):
    want = _write_libsvm_files(tmp_path)

    def run(s):
        got = _drain(s, 7)
        assert s.get_next_data(1) == []     # and again after the end
        return got

    got, ref = _both(dict(file_seq_prefix=str(tmp_path / "part"),
                          num_files=4, num_buffers=2), run)
    _rows_equal(got, ref)
    assert len(got) == len(want)
    for (gl, gi, _), (wl, wi) in zip(got, want):
        assert gl == wl and list(gi) == list(wi)


def test_streamer_multi_pass_and_dir_mode(tmp_path):
    want = _write_libsvm_files(tmp_path, n_files=2, rows_per_file=5)
    got, ref = _both(dict(dir_path=str(tmp_path), num_passes=3),
                     lambda s: _drain(s, 64))
    _rows_equal(got, ref)
    assert len(got) == 3 * len(want)


def test_streamer_memory_is_bounded(tmp_path):
    _write_libsvm_files(tmp_path, n_files=6, rows_per_file=10)

    def run(s):
        time.sleep(0.3)     # let the IO thread run as far ahead as it can
        assert s._q.qsize() <= 2
        return _drain(s, 16)

    got, ref = _both(dict(dir_path=str(tmp_path), num_buffers=2), run)
    _rows_equal(got, ref)
    assert len(got) == 60


def test_streamer_snappy_mode(tmp_path):
    (tmp_path / "c_0").write_bytes(compress(b"1 1:0.5 3:1.5\n0 2:2.0\n"))
    got, ref = _both(dict(file_seq_prefix=str(tmp_path / "c"), num_files=1,
                          snappy_compressed=True),
                     lambda s: s.get_next_data(10))
    _rows_equal(got, ref)
    assert got[0][0] == 1.0 and list(got[0][1]) == [0, 2]


def test_streamer_surfaces_io_errors(tmp_path):
    """A missing file raises on the consumer in both packages, with the
    same message, and the IO thread ends."""
    _write_libsvm_files(tmp_path, n_files=1, rows_per_file=3)
    msgs = []

    def run(s):
        with pytest.raises(RuntimeError, match="IO thread failed") as e:
            while s.get_next_data(64):
                pass
        msgs.append(str(e.value))

    _both(dict(file_list=[str(tmp_path / "part_0"),
                          str(tmp_path / "MISSING")]), run)
    assert msgs[0] == msgs[1]


def test_streamer_shutdown_mid_stream_joins_the_io_thread(tmp_path):
    """shutdown while the IO thread is blocked on a full queue (endless
    passes) stops and joins it."""
    _write_libsvm_files(tmp_path, n_files=3, rows_per_file=4)
    s = stream.DiskStreamer(stream.DiskStreamConfig(
        dir_path=str(tmp_path), num_passes=0, num_buffers=1),
        stream.LibSVMParser())
    assert len(s.get_next_data(5)) == 5
    s.shutdown()
    assert not s._io.is_alive()


def test_stream_dense_batches_matches_bulk_reader_and_jax(tmp_path):
    _write_libsvm_files(tmp_path, n_files=2, rows_per_file=8, dim=10)
    feats0, labels0 = libsvm.read_libsvm(str(tmp_path / "part_0"),
                                         feature_dim=10)
    got, ref = _both(dict(file_seq_prefix=str(tmp_path / "part"),
                          num_files=2),
                     lambda s: list(stream.stream_dense_batches(s, 8, 10)
                                    if isinstance(s, stream.DiskStreamer)
                                    else jstream.stream_dense_batches(
                                        s, 8, 10)))
    assert len(got) == len(ref) == 2
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
    np.testing.assert_array_equal(got[0][0], feats0.to_dense())
    np.testing.assert_array_equal(got[0][1], labels0)


@pytest.mark.parametrize("one_based,feature_dim", [(True, 0), (True, 16),
                                                   (False, 0)])
def test_read_libsvm_matches_jax(tmp_path, one_based, feature_dim):
    path = tmp_path / "f.svm"
    path.write_text("1 1:0.5 4:2.25 # comment\n\n0 2:1e-3\n-1 3:7 5:-1.5\n")
    got, gl = libsvm.read_libsvm(str(path), feature_dim, one_based)
    ref, rl = jlibsvm.read_libsvm(str(path), feature_dim, one_based)
    for f in ("indices", "values", "offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert getattr(got, f).dtype == getattr(ref, f).dtype
    assert got.dim == ref.dim
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_equal(got.to_dense(), ref.to_dense())


def test_read_libsvm_refuses_a_bad_index(tmp_path):
    path = tmp_path / "bad.svm"
    path.write_text("1 0:0.5\n")
    for mod in (libsvm, jlibsvm):
        with pytest.raises(ValueError, match="bad feature index 0"):
            mod.read_libsvm(str(path))
