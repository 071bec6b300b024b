"""The port's dataset tools, feature extractor and tool commands against
the JAX package's, on the CPU.

- ``convert_imageset`` -> LMDB, then ``compute_image_mean``,
  ``partition_data`` and ``convert_db``: every record (key and value)
  and the mean binaryproto byte for byte what JAX's ``runtime/tools.py``
  writes from the same inputs.
- ``extract_features``: the features within 1e-5 (rtol and atol) of
  JAX's on the same weights (through ``params_from_jax``) and rows, as a
  function and through both CLIs.
- ``time --device cpu``: JAX's layer names in JAX's order, and the byte
  columns of its ``--per_layer --comm_devices 8 --dcn_slices 2
  --strategy topk`` comm table equal JAX's.
- ``device_query``: runs with ``--device cpu``; without a GPU and without
  it, exits non-zero.
- ``train --metrics_port 0`` serves ``/`` while it trains; ``stats.yaml``
  has the iteration, lr and train-scalar gauges, the counters and the
  ``comm`` section.
- A 2-process gloo ``train --hostfile --node_id`` pair on 127.0.0.1 ends
  with snapshots bitwise equal to the env-launched pair's.
"""

import os
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from poseidon_tpu.data.leveldb_reader import LevelDBWriter as JaxLevelDBWriter
from poseidon_tpu.data.lmdb_reader import LMDBReader as JaxReader
from poseidon_tpu.runtime import tools as jtools
from poseidon_tpu_torch.data.leveldb_reader import LevelDBReader
from poseidon_tpu_torch.data.lmdb_reader import LMDBReader
from poseidon_tpu_torch.runtime import cli, tools

Image = pytest.importorskip("PIL.Image")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = dict(rtol=1e-5, atol=1e-5)
PAIR_TIMEOUT_S = 60


def _records(path):
    r = LMDBReader(path)
    try:
        return [(r.key_at(i), r.value_at(i)) for i in range(len(r))]
    finally:
        r.close()


def _jax_records(path):
    r = JaxReader(path)
    return [(r.key_at(i), r.value_at(i)) for i in range(len(r))]


def _image_list(tmp_path, n=6, gray_at=3):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        shape = (9, 9) if i == gray_at else (9, 9, 3)
        img = Image.fromarray(rs.randint(0, 255, shape).astype(np.uint8))
        p = tmp_path / f"i{i}.png"
        img.save(p)
        lines.append(f"i{i}.png {i % 2}")
    listfile = tmp_path / "list.txt"
    listfile.write_text("\n".join(lines))
    return listfile


@pytest.mark.parametrize("shuffle,gray", [(False, False), (True, False),
                                          (False, True)])
def test_dataset_tools_bitwise_with_jax(tmp_path, shuffle, gray):
    listfile = _image_list(tmp_path)
    db, jdb = str(tmp_path / "db"), str(tmp_path / "jdb")
    args = ["convert_imageset", str(listfile), db, "--root_folder",
            f"{tmp_path}/", "--resize_height", "8", "--resize_width", "8"]
    args += ["--shuffle"] * shuffle + ["--gray"] * gray
    assert cli.main(args) == 0
    assert jtools.convert_imageset(str(listfile), jdb,
                                   root_folder=f"{tmp_path}/",
                                   resize_height=8, resize_width=8,
                                   shuffle=shuffle, gray=gray) == 6
    recs = _records(db)
    assert recs == _jax_records(jdb) and len(recs) == 6
    # the mean, through the CLI and the function, against JAX's bytes
    mean_file, jmean = tmp_path / "mean.binaryproto", tmp_path / "jm"
    assert cli.main(["compute_image_mean", db, str(mean_file)]) == 0
    jtools.compute_image_mean(jdb, str(jmean))
    assert mean_file.read_bytes() == jmean.read_bytes()
    from poseidon_tpu_torch.proto.wire import decode_datum, read_blob_file
    mean = read_blob_file(str(mean_file))
    want = np.mean([decode_datum(v).to_array() for _, v in recs], axis=0,
                   dtype=np.float64)
    assert mean.shape == (1, 1 if gray else 3, 8, 8)
    np.testing.assert_allclose(mean[0], want, rtol=1e-6)
    # shards of 6 records: 3 -> 2/2/2, 4 -> 2/2/1/1
    for k in (3, 4):
        paths = tools.partition_data(db, k)
        jpaths = jtools.partition_data(jdb, k)
        got = [_records(p) for p in paths]
        assert got == [_jax_records(p) for p in jpaths]
        assert [len(g) for g in got] == ([2, 2, 2] if k == 3
                                         else [2, 2, 1, 1])
        assert sum(got, []) == recs


def test_convert_db_leveldb_to_lmdb_and_back(tmp_path):
    listfile = _image_list(tmp_path)
    lmdb_src = str(tmp_path / "src")
    tools.convert_imageset(str(listfile), lmdb_src,
                           root_folder=f"{tmp_path}/")
    recs = _records(lmdb_src)
    ldb = str(tmp_path / "ldb")
    w = JaxLevelDBWriter(ldb)
    for k, v in recs:
        w.put(k, v)
    w.close()
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    assert cli.main(["convert_db", ldb, out]) == 0
    assert jtools.convert_db(ldb, jout) == 6
    assert _records(out) == _jax_records(jout) == recs
    # and LMDB -> LEVELDB, read back by the port's reader
    back = str(tmp_path / "back")
    assert tools.convert_db(out, back, "LEVELDB") == 6
    assert list(LevelDBReader(back)) == recs


_FEAT_NET = """
name: "feat"
layers { name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 4 channels: 1 height: 6 width: 6 } }
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 3 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "ip" type: INNER_PRODUCT bottom: "conv" top: "feat"
  inner_product_param { num_output: 7 weight_filler { type: "xavier" } } }
layers { name: "s" type: SILENCE bottom: "feat" }
layers { name: "s2" type: SILENCE bottom: "label" }
"""


def _float_rows(path):
    from poseidon_tpu_torch.proto.wire import decode_datum
    rows = []
    for k, v in _records(path):
        d = decode_datum(v)
        rows.append((k, d.channels, np.asarray(d.float_data, np.float32)))
    return rows


def _assert_features_close(path, jpath, n, channels):
    got, want = _float_rows(path), _float_rows(jpath)
    assert len(got) == len(want) == n
    for (k, c, v), (jk, jc, jv) in zip(got, want):
        assert k == jk and c == jc == channels
        np.testing.assert_allclose(v, jv, **FEAT_TOL)


def test_extract_features_matches_jax(tmp_path):
    import jax
    from poseidon_tpu.core.net import Net as JaxNet
    from poseidon_tpu.data.pipeline import BatchPipeline as JaxPipeline
    from poseidon_tpu.proto.messages import load_net_from_string as jload
    from poseidon_tpu_torch.core.net import Net, params_from_jax
    from poseidon_tpu_torch.data.pipeline import BatchPipeline
    from poseidon_tpu_torch.proto.messages import load_net_from_string

    md = {"data": np.random.RandomState(0).rand(16, 1, 6, 6)
          .astype(np.float32), "label": np.arange(16) % 2}
    shapes = {"data": (4, 1, 6, 6), "label": (4,)}
    jparam, param = jload(_FEAT_NET), load_net_from_string(_FEAT_NET)
    jnet = JaxNet(jparam, "TEST", source_shapes=shapes, conv_layout="NCHW")
    jparams = jnet.init(jax.random.PRNGKey(0))
    net = Net(param, "TEST", device="cpu", source_shapes=shapes)
    params = params_from_jax(net, jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    jpipe = JaxPipeline(jparam.layers[0], "TEST", 4, memory_data=md)
    pipe = BatchPipeline(param.layers[0], "TEST", 4, memory_data=md)
    try:
        jout = jtools.extract_features(jnet, jparams, ["feat", "conv"],
                                       jpipe, 3, str(tmp_path / "j"))
        out = tools.extract_features(net, params, ["feat", "conv"], pipe,
                                     3, str(tmp_path / "p"))
    finally:
        pipe.close()
        jpipe.close()
    assert [os.path.basename(p) for p in out] == ["p_feat", "p_conv"]
    _assert_features_close(out[0], jout[0], 12, 7)
    _assert_features_close(out[1], jout[1], 12, 3 * 4 * 4)


def test_extract_features_cli_matches_jax_cli(tmp_path):
    """Both CLIs over an LMDB from convert_imageset, with weights from one
    .caffemodel (JAX's init, written by the port's snapshot)."""
    import jax
    from poseidon_tpu.core.net import Net as JaxNet
    from poseidon_tpu.proto.messages import load_net as jload
    from poseidon_tpu.runtime.cli import main as jax_main
    from poseidon_tpu_torch.core.net import Net, params_from_jax
    from poseidon_tpu_torch.parallel.trainer import init_train_state
    from poseidon_tpu_torch.proto.messages import load_net
    from poseidon_tpu_torch.runtime import checkpoint

    db = str(tmp_path / "db")
    tools.convert_imageset(str(_image_list(tmp_path, n=8, gray_at=-1)), db,
                           root_folder=f"{tmp_path}/", resize_height=8,
                           resize_width=8)
    model = tmp_path / "net.prototxt"
    model.write_text(f"""
name: "featcli"
layers {{ name: "d" type: DATA top: "data" top: "label"
  data_param {{ source: "{db}" batch_size: 4 backend: LMDB }}
  transform_param {{ scale: 0.01 crop_size: 6 }} }}
layers {{ name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param {{ num_output: 4 kernel_size: 3
    weight_filler {{ type: "xavier" }} }} }}
layers {{ name: "fc" type: INNER_PRODUCT bottom: "conv" top: "fc"
  inner_product_param {{ num_output: 5 weight_filler {{ type: "xavier" }} }} }}
layers {{ name: "s" type: SILENCE bottom: "fc" }}
layers {{ name: "s2" type: SILENCE bottom: "label" }}
""")
    shapes = {"data": (4, 3, 6, 6), "label": (4,)}
    jnet = JaxNet(jload(str(model)), "TEST", source_shapes=shapes,
                  conv_layout="NCHW")
    net = Net(load_net(str(model)), "TEST", device="cpu",
              source_shapes=shapes)
    params = params_from_jax(net, jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(4))))
    weights, _ = checkpoint.snapshot(str(tmp_path / "w"), net, params,
                                     init_train_state(params))
    common = ["extract_features", "--model", str(model), "--weights",
              weights, "--blobs", "fc,conv", "--num_batches", "2"]
    assert cli.main(common + ["--out_prefix", str(tmp_path / "p"),
                              "--device", "cpu"]) == 0
    assert jax_main(common + ["--out_prefix", str(tmp_path / "j")]) == 0
    _assert_features_close(str(tmp_path / "p_fc"), str(tmp_path / "j_fc"),
                           8, 5)
    _assert_features_close(str(tmp_path / "p_conv"),
                           str(tmp_path / "j_conv"), 8, 4 * 4 * 4)


def _time_lines(out):
    lines = out.splitlines()
    head = lines.index(next(l for l in lines if l.startswith("layer ")))
    names = []
    for line in lines[head + 1:]:
        if not line.strip():
            break
        names.append(tuple(line.split()[:2]))
    comm = lines.index(next(l for l in lines if l.startswith("Comm bytes")))
    rows = []
    for line in lines[comm + 2:]:
        if line.startswith("total:"):
            break
        rows.append(tuple(line.split()[:5]))      # name .. vs dense
    return names, rows, lines[comm]


def test_time_cpu_matches_jax_layer_names_and_comm_bytes(capsys):
    from poseidon_tpu.runtime import cli as jcli
    model = os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")
    flags = ["--model", model, "--iterations", "1", "--per_layer",
             "--comm_devices", "8", "--dcn_slices", "2", "--strategy",
             "topk"]
    capsys.readouterr()
    assert cli.main(["time", *flags, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.cmd_time(jcli.build_parser().parse_args(["time", *flags])) \
        == 0
    want = capsys.readouterr().out
    g_names, g_rows, g_head = _time_lines(got)
    w_names, w_rows, w_head = _time_lines(want)
    assert g_names == w_names and len(g_names) == 8
    assert g_rows == w_rows and len(g_rows) == 4
    assert g_head == w_head
    for out in (got, want):
        assert "Average Forward pass" in out
        assert "Average Forward-Backward" in out
    assert "(batch 64)" in got


def test_time_input_net_and_refused_slices(tmp_path, capsys):
    """A net with explicit inputs times without a data layer; a slice
    count that does not divide --comm_devices exits."""
    model = tmp_path / "m.prototxt"
    model.write_text("""
name: "t"
input: "data"
input_dim: 4 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "fc" type: INNER_PRODUCT bottom: "conv" top: "fc"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layers { name: "silence" type: SILENCE bottom: "fc" }
""")
    assert cli.main(["time", "--model", str(model), "--iterations", "2",
                     "--device", "cpu"]) == 0
    assert "(batch 4)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not divide"):
        cli.main(["time", "--model", str(model), "--iterations", "1",
                  "--device", "cpu", "--per_layer", "--comm_devices", "6",
                  "--dcn_slices", "4"])


def test_device_query(capsys):
    assert cli.main(["device_query", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device cpu: platform=cpu" in out
    assert "process rank=0 world=1" in out
    if not torch.cuda.is_available():
        assert cli.main(["device_query"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


_SMALL_NET = """
name: "SmallNet"
layers { name: "src" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 16 channels: 1 height: 12 width: 12 } }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layers { name: "ip1" type: INNER_PRODUCT bottom: "conv1" top: "ip1"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } bias_filler { type: "constant" } } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""


def test_train_metrics_port_serves_while_training(tmp_path):
    from poseidon_tpu_torch.proto.messages import load_solver_from_string
    from poseidon_tpu_torch.runtime.engine import Engine
    net = tmp_path / "net.prototxt"
    net.write_text(_SMALL_NET)
    sp = load_solver_from_string(
        f'net: "{net}"\nbase_lr: 0.05\nlr_policy: "fixed"\nmomentum: 0.9\n'
        'display: 2\nmax_iter: 6\nsnapshot_after_train: false\n')
    rs = np.random.RandomState(0)
    md = {"data": rs.rand(64, 1, 12, 12).astype(np.float32),
          "label": np.arange(64) % 5}
    eng = Engine(sp, memory_data=md, output_dir=str(tmp_path), device="cpu",
                 metrics_port=0)
    bodies = []
    orig = eng.train_step.step

    def step(p, s, b):
        # after the displays at 2 and 4
        if eng.stats.counters["train_iters"] == 4:
            url = f"http://127.0.0.1:{eng.metrics_port}/"
            with urllib.request.urlopen(url, timeout=10) as r:
                bodies.append(r.read().decode())
        return orig(p, s, b)

    eng.train_step.step = step
    try:
        assert eng.metrics_port > 0
        eng.train()
    finally:
        eng.close()
    assert len(bodies) == 1
    live = dict(line.split("=", 1) for line in bodies[0].splitlines())
    # lr is the f32 schedule's value, as JAX's engine gauges it
    assert live["iteration"] == "4"
    assert float(live["lr"]) == pytest.approx(0.05, rel=1e-7)
    assert "train_loss" in live and float(live["train_iters"]) == 4
    yaml = (tmp_path / "stats.yaml").read_text()
    for key in ("counters:", "  train_iters: 6", "  steps_in_flight:",
                "timers_sec:", "  input_stall:", "  train_step:",
                "  train_total:", "gauges:", "  iteration: 6", "  lr: 0.0500000",
                "  train_loss:", "comm:", "  summary:", "  per_layer:",
                "    conv1:", "    ip1:"):
        assert key in yaml, key
    with pytest.raises(OSError):      # closed with the engine
        urllib.request.urlopen(f"http://127.0.0.1:{eng.metrics_port}/",
                               timeout=2)


def test_train_cli_metrics_port_flag(tmp_path, capsys):
    net = tmp_path / "net.prototxt"
    net.write_text(_SMALL_NET.replace("num_output: 5", "num_output: 10")
                   .replace("MEMORY_DATA", "DATA").replace(
        "memory_data_param { batch_size: 16 channels: 1 height: 12 "
        "width: 12 }",
        f'data_param {{ source: "{REPO}/examples/mnist/mnist_test_lmdb" '
        'batch_size: 8 backend: LMDB }'))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "fixed"\n'
                      'display: 1\nmax_iter: 2\nsnapshot_after_train: false\n')
    assert cli.main(["train", f"--solver={solver}", "--output_dir",
                     str(tmp_path), "--device", "cpu", "--metrics_port",
                     "0"]) == 0
    out = capsys.readouterr().out
    assert "metrics endpoint (rank 0): http://127.0.0.1:" in out
    assert "  iteration: 2" in (tmp_path / "stats.yaml").read_text()


def test_hostfile_world_rules(tmp_path):
    from poseidon_tpu_torch.runtime import cluster
    one = tmp_path / "one"
    one.write_text("0 127.0.0.1 9999\n")
    assert cluster.hostfile_world(str(one), None) == (0, 1, None)
    group = cluster.init_distributed(torch.device("cpu"),
                                     hostfile=str(one))
    assert not group.distributed and group.world == 1
    two = tmp_path / "two"
    two.write_text("# a cluster\n0 10.0.0.1 7000\n1 10.0.0.2 7001\n")
    assert cluster.hostfile_world(str(two), 1) == (1, 2, "10.0.0.1:7000")
    with pytest.raises(ValueError, match="node_id is required"):
        cluster.hostfile_world(str(two), None)
    with pytest.raises(ValueError, match="not a host"):
        cluster.hostfile_world(str(two), 2)


def test_async_ssp_refuses_a_hostfile_without_the_env(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("POSEIDON_PROC_ID", raising=False)
    hosts = tmp_path / "hosts"
    hosts.write_text("0 127.0.0.1 9999\n1 127.0.0.1 9998\n")
    with pytest.raises(SystemExit, match="launch_local env contract"):
        cli.main(["train", "--solver", "x.prototxt", "--device", "cpu",
                  "--async_ssp", "--hostfile", str(hosts), "--node_id",
                  "0"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_pair(tmp_path, tag, solver, env_of, extra_of):
    procs = []
    for r in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "poseidon_tpu_torch", "train",
             f"--solver={solver}", "--output_dir",
             str(tmp_path / tag / f"r{r}"), "--device", "cpu",
             *extra_of(r)], cwd=REPO,
            env=env_of(r), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PAIR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{tag} rank {r}:\n{logs[r]}"
    return logs


def test_hostfile_pair_matches_the_env_pair_bitwise(tmp_path):
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{os.path.join(REPO, "examples/mnist/lenet_train_test.prototxt")}"'
        '\nbase_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\ndisplay: 1\n'
        'max_iter: 2\nsnapshot_prefix: "lenet"\n')
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("POSEIDON_")}
    base["PYTHONPATH"] = REPO
    env_port = _free_port()
    env_logs = _train_pair(
        tmp_path, "env", solver,
        lambda r: dict(base, POSEIDON_PROC_ID=str(r), POSEIDON_NUM_PROCS="2",
                       POSEIDON_COORDINATOR=f"127.0.0.1:{env_port}"),
        lambda r: [])
    hosts = tmp_path / "hosts"
    hosts.write_text(f"0 127.0.0.1 {_free_port()}\n"
                     f"1 127.0.0.1 {_free_port()}\n")
    host_logs = _train_pair(
        tmp_path, "host", solver, lambda r: dict(base),
        lambda r: ["--hostfile", str(hosts), "--node_id", str(r)])
    for logs in (env_logs, host_logs):
        assert "distributed: 2 rank(s), backend gloo" in logs[0]
        assert "Iteration 2" in logs[0] and "Iteration" not in logs[1]
    for r in range(2):
        env, host = tmp_path / "env" / f"r{r}", tmp_path / "host" / f"r{r}"
        model = "lenet_iter_2.caffemodel"
        assert (env / model).read_bytes() == (host / model).read_bytes()
        assert (env / model).read_bytes() == (
            tmp_path / "env" / "r0" / model).read_bytes()
        state = "lenet_iter_2.solverstate.npz"
        with np.load(env / state) as a, np.load(host / state) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
