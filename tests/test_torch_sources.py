"""The port's IMAGE_DATA, HDF5_DATA and WINDOW_DATA sources and pipelines
against the JAX package's, on the CPU: the same files (8x8 PNGs written by
PIL, .h5 files written by h5py, a window file), the same prototxt, seed
and shard; the first batches of each ``BatchPipeline`` must be equal bit
for bit, shuffled and not, across an epoch boundary. ``SyntheticSource``
is held bitwise too."""

import os

import numpy as np
import pytest

from poseidon_tpu.data import sources as jsources
from poseidon_tpu.data.pipeline import BatchPipeline as JaxPipeline
from poseidon_tpu.data.pipeline import build_source as jax_build_source
from poseidon_tpu.data.window import WindowDataSource as JaxWindow
from poseidon_tpu.data.window import parse_window_file as jax_parse_window
from poseidon_tpu.data.workload import Shard as JaxShard
from poseidon_tpu.proto.messages import load_net_from_string as jax_load_str
from poseidon_tpu_torch.data import sources
from poseidon_tpu_torch.data.pipeline import BatchPipeline, build_source
from poseidon_tpu_torch.data.window import WindowDataSource, parse_window_file
from poseidon_tpu_torch.data.workload import Shard
from poseidon_tpu_torch.proto.messages import load_net_from_string

Image = pytest.importorskip("PIL.Image")
N_IMAGES = 10
BATCH = 4
N_BATCHES = 4          # 16 records a shard of 10 or 5: past an epoch


def _write_images(root, n=N_IMAGES, size=(8, 8), seed=0):
    rs = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        w, h = size if i % 3 else (size[0] + 3, size[1] + 1)
        mode = "L" if i == 4 else "RGB"
        shape = (h, w) if mode == "L" else (h, w, 3)
        img = Image.fromarray(rs.randint(0, 256, size=shape).astype(np.uint8),
                              mode)
        name = f"img_{i}.png"
        img.save(os.path.join(root, name))
        lines.append(f"{name} {i % 3}")
    return lines


def _layers(text):
    return load_net_from_string(text).layers[0], jax_load_str(text).layers[0]


def _assert_batches_equal(port_pipe, jax_pipe, n=N_BATCHES):
    try:
        for _ in range(n):
            got, want = next(port_pipe), next(jax_pipe)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        port_pipe.close()
        jax_pipe.close()


def _image_text(list_file, root, shuffle_list=False, shared=False,
                mirror=True, crop=6):
    return (f'layers {{ name: "d" type: IMAGE_DATA top: "data" top: "label" '
            f'image_data_param {{ source: "{list_file}" batch_size: {BATCH} '
            f'root_folder: "{root}/" new_height: 8 new_width: 8 '
            f'shuffle: {"true" if shuffle_list else "false"} '
            f'shared_file_system: {"true" if shared else "false"} }} '
            f'transform_param {{ crop_size: {crop} '
            f'mirror: {"true" if mirror else "false"} scale: 0.5 '
            f'mean_value: 100 mean_value: 110 mean_value: 120 }} }}')


@pytest.mark.parametrize("shuffle,shuffle_list,shard", [
    (True, False, (0, 1)), (False, False, (0, 1)), (True, True, (1, 2)),
    (False, True, (0, 2))])
def test_image_data_pipeline_bitwise(tmp_path, shuffle, shuffle_list, shard):
    lines = _write_images(str(tmp_path))
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    lp, jlp = _layers(_image_text(tmp_path / "list.txt", tmp_path,
                                  shuffle_list))
    port = BatchPipeline(lp, "TRAIN", BATCH, shard=Shard(*shard), seed=3,
                         shuffle=shuffle)
    assert port.route == "python"
    assert port.data_shape == (BATCH, 3, 6, 6)
    _assert_batches_equal(port, JaxPipeline(
        jlp, "TRAIN", BATCH, shard=JaxShard(*shard), seed=3,
        shuffle=shuffle))


def test_image_data_test_phase_and_resize_off(tmp_path):
    """TEST phase (center crop, no mirror) with the images' own sizes
    (no new_height/new_width): one size in the list, as Caffe needs."""
    lines = _write_images(str(tmp_path), n=6, size=(9, 9))
    keep = [l for i, l in enumerate(lines) if i % 3]
    (tmp_path / "list.txt").write_text("\n".join(keep) + "\n")
    text = (f'layers {{ name: "d" type: IMAGE_DATA top: "data" '
            f'top: "label" image_data_param {{ source: "{tmp_path}/list.txt" '
            f'batch_size: 3 root_folder: "{tmp_path}/" }} transform_param '
            f'{{ crop_size: 7 mirror: true }} }}')
    lp, jlp = _layers(text)
    _assert_batches_equal(BatchPipeline(lp, "TEST", 3, seed=1),
                          JaxPipeline(jlp, "TEST", 3, seed=1), n=3)


def test_image_data_build_source_honours_sharded_source_path(tmp_path):
    """shared_file_system: shard k reads '<source>_k', in both packages."""
    lines = _write_images(str(tmp_path))
    for k in range(2):
        (tmp_path / f"list.txt_{k}").write_text(
            "\n".join(lines[k::2]) + "\n")
    lp, jlp = _layers(_image_text(tmp_path / "list.txt", tmp_path,
                                  shared=True))
    for k in range(2):
        src = build_source(lp, Shard(k, 2))
        ref = jax_build_source(jlp, JaxShard(k, 2))
        assert isinstance(src, sources.ImageListSource)
        assert src.entries == ref.entries
        assert [os.path.basename(p) for p, _ in src.entries] == [
            l.split()[0] for l in lines[k::2]]
        for i in range(len(src)):
            a, la = src.read(i)
            b, lb = ref.read(i)
            np.testing.assert_array_equal(a, b)
            assert la == lb
    with pytest.raises(FileNotFoundError):
        build_source(lp, Shard(2, 3))


def _write_h5(tmp_path, h5py):
    rs = np.random.RandomState(1)
    names = []
    for f, n in enumerate((5, 4)):
        path = tmp_path / f"part{f}.h5"
        with h5py.File(path, "w") as h:
            h["data"] = rs.randn(n, 2, 5, 5).astype(np.float32)
            h["label"] = rs.randint(0, 4, size=(n, 1)).astype(np.float32)
        names.append(str(path))
    (tmp_path / "h5list.txt").write_text("\n".join(names) + "\n")
    return tmp_path / "h5list.txt"


@pytest.mark.parametrize("shuffle,shard", [(True, (0, 1)), (False, (0, 1)),
                                           (True, (1, 2))])
def test_hdf5_data_pipeline_bitwise(tmp_path, shuffle, shard):
    h5py = pytest.importorskip("h5py")
    listf = _write_h5(tmp_path, h5py)
    text = (f'layers {{ name: "d" type: HDF5_DATA top: "data" top: "label" '
            f'hdf5_data_param {{ source: "{listf}" batch_size: 3 }} }}')
    lp, jlp = _layers(text)
    port = BatchPipeline(lp, "TRAIN", 3, shard=Shard(*shard), seed=5,
                         shuffle=shuffle)
    assert port.data_shape == (3, 2, 5, 5)
    _assert_batches_equal(port, JaxPipeline(
        jlp, "TRAIN", 3, shard=JaxShard(*shard), seed=5, shuffle=shuffle),
        n=5)
    src, ref = sources.HDF5Source(str(listf)), jsources.HDF5Source(str(listf))
    assert len(src) == len(ref) == 9
    np.testing.assert_array_equal(src.data_cat, ref.data_cat)
    np.testing.assert_array_equal(src.labels_cat, ref.labels_cat)


def test_hdf5_vector_records_gain_unit_spatial_dims(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "vec.h5"
    with h5py.File(path, "w") as h:
        h["data"] = np.arange(12, dtype=np.float32).reshape(4, 3)
        h["label"] = np.arange(4, dtype=np.float32)
    (tmp_path / "l.txt").write_text(f"{path}\n")
    a, la = sources.HDF5Source(str(tmp_path / "l.txt")).read(2)
    b, lb = jsources.HDF5Source(str(tmp_path / "l.txt")).read(2)
    assert a.shape == b.shape == (3, 1, 1) and la == lb == 2
    np.testing.assert_array_equal(a, b)


def _write_windows(tmp_path, n_images=3):
    rs = np.random.RandomState(2)
    out = []
    for i in range(n_images):
        h, w = 20 + 3 * i, 24 - 2 * i
        c = 1 if i == 2 else 3
        shape = (h, w) if c == 1 else (h, w, 3)
        path = tmp_path / f"win_{i}.png"
        Image.fromarray(rs.randint(0, 256, size=shape).astype(np.uint8),
                        "L" if c == 1 else "RGB").save(path)
        wins = [(1 + i % 2, 0.9, 2, 3, 12, 15), (0, 0.1, 0, 0, w - 1, h - 1),
                (2, 0.7, 5, 1, 9, 18), (3, 0.3, 4, 4, 8, 8),   # dropped
                (1, 0.05, 10, 10, 30, 30)]
        out.append(f"# {i}\n{path}\n{c}\n{h}\n{w}\n{len(wins)}\n"
                   + "".join(" ".join(str(v) for v in win) + "\n"
                             for win in wins))
    (tmp_path / "windows.txt").write_text("".join(out))
    return tmp_path / "windows.txt"


def _window_text(path, crop_mode, mirror=True, pad=2, mean="values"):
    m = ("mean_value: 10 mean_value: 20 mean_value: 30"
         if mean == "values" else "")
    return (f'layers {{ name: "w" type: WINDOW_DATA top: "data" top: "label" '
            f'window_data_param {{ source: "{path}" batch_size: 5 '
            f'fg_threshold: 0.5 bg_threshold: 0.2 fg_fraction: 0.4 '
            f'context_pad: {pad} crop_mode: "{crop_mode}" }} '
            f'transform_param {{ crop_size: 7 scale: 0.25 '
            f'mirror: {"true" if mirror else "false"} {m} }} }}')


def test_parse_window_file_matches_jax(tmp_path):
    path = _write_windows(tmp_path)
    got = parse_window_file(str(path), 0.5, 0.2)
    want = jax_parse_window(str(path), 0.5, 0.2)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert [vars(w) for w in a] == [vars(w) for w in b]
    assert len(got[1]) == 6 and len(got[2]) == 6
    assert all(w.label == 0 and w.overlap == 0.0 for w in got[2])


@pytest.mark.parametrize("crop_mode,mirror,shard", [
    ("warp", True, (0, 1)), ("square", False, (1, 2)),
    ("warp", False, (1, 3))])
def test_window_data_pipeline_bitwise(tmp_path, crop_mode, mirror, shard):
    path = _write_windows(tmp_path)
    lp, jlp = _layers(_window_text(path, crop_mode, mirror))
    port = BatchPipeline(lp, "TRAIN", 5, shard=Shard(*shard), seed=4)
    assert port.route == "window"
    assert port.data_shape == (5, 3, 7, 7)
    _assert_batches_equal(port, JaxPipeline(
        jlp, "TRAIN", 5, shard=JaxShard(*shard), seed=4), n=5)


def test_window_source_mean_file_and_cache(tmp_path):
    """A mean file indexed at its centre crop, and an LRU cache smaller
    than the image count: batches still equal JAX's."""
    from poseidon_tpu_torch.proto.wire import encode_blob
    path = _write_windows(tmp_path, n_images=4)
    mean = np.random.RandomState(3).rand(1, 3, 11, 11).astype(np.float32)
    (tmp_path / "mean.binaryproto").write_bytes(encode_blob(mean))
    text = _window_text(path, "warp", mean="none").replace(
        "scale: 0.25", f'scale: 0.25 mean_file: "{tmp_path}/mean.'
                       f'binaryproto"')
    lp, jlp = _layers(text)
    a, b = WindowDataSource(lp, "TRAIN", seed=9), JaxWindow(jlp, "TRAIN",
                                                            seed=9)
    a.MAX_CACHED_IMAGES = b.MAX_CACHED_IMAGES = 2
    for _ in range(4):
        (da, la), (db, lb) = a.batch(6), b.batch(6)
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
    assert len(a._img_cache) <= 2


def test_window_source_refusals(tmp_path):
    path = _write_windows(tmp_path)
    lp, _ = _layers(_window_text(path, "warp").replace("crop_size: 7 ", ""))
    with pytest.raises(ValueError, match="needs crop_size"):
        WindowDataSource(lp, "TRAIN")
    lp, _ = _layers(_window_text(path, "warp").replace(
        "bg_threshold: 0.2", "bg_threshold: 0.01"))
    with pytest.raises(ValueError, match="need both fg and bg"):
        WindowDataSource(lp, "TRAIN")


@pytest.mark.parametrize("index", [0, 1, 7, 1023])
def test_synthetic_source_bitwise(index):
    a = sources.SyntheticSource((3, 5, 4), num_classes=7, size=2048, seed=2)
    b = jsources.SyntheticSource((3, 5, 4), num_classes=7, size=2048, seed=2)
    assert len(a) == len(b) == 2048
    (x, lx), (y, ly) = a.read(index), b.read(index)
    assert x.dtype == y.dtype == np.float32 and lx == ly
    np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.templates, b.templates)
    assert a.record_shape == (3, 5, 4)


def test_sources_import_without_pil_or_h5py():
    """The source modules import neither PIL nor h5py until a source that
    needs them is built (checked in a fresh interpreter)."""
    import subprocess
    import sys
    code = ("import sys; import poseidon_tpu_torch.data.sources, "
            "poseidon_tpu_torch.data.window, "
            "poseidon_tpu_torch.data.pipeline; "
            "print(sorted(m for m in ('PIL', 'h5py') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
