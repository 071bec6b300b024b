"""The port's serving tier on the CPU: executor padding and admission,
server/client round trips, and JAX-written snapshots served by the port.

Tolerance against the JAX Net and against a direct forward: rtol 1e-4,
atol 1e-5 (float32 on both sides; conv and GEMM sum in different orders
across frameworks and across batch sizes).
"""

import jax
import numpy as np
import pytest
import torch

from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.proto.messages import load_net_from_string
from poseidon_tpu_torch.serving.client import ServingClient, ServingError
from poseidon_tpu_torch.serving.executor import (BucketedExecutor,
                                                 parse_buckets)
from poseidon_tpu_torch.serving.server import InferenceServer

RTOL, ATOL = 1e-4, 1e-5
LENET = "examples/mnist/lenet_deploy.prototxt"

DEPLOY_NET = """
name: "ServeNet"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "xavier" } } }
layers { name: "relu" type: RELU bottom: "conv" top: "conv" }
layers { name: "norm" type: LRN bottom: "conv" top: "norm"
  lrn_param { local_size: 3 alpha: 0.3 } }
layers { name: "fc" type: INNER_PRODUCT bottom: "norm" top: "fc"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
"""


def _executor(buckets=(1, 2, 4)):
    net = Net(load_net_from_string(DEPLOY_NET), "TEST", device="cpu")
    net.init(torch.Generator().manual_seed(7))
    return BucketedExecutor(net, buckets=buckets)


def _rows(n, seed=0, shape=(3, 8, 8)):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def _direct(net, x, params=None):
    with torch.inference_mode():
        return net({"data": torch.from_numpy(x)}, params)["prob"].numpy()


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_bucketed_executor_matches_direct_forward(n):
    ex = _executor()
    x = _rows(n, seed=n)
    got = ex.infer({"data": x})["prob"]
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, _direct(ex.net, x), rtol=RTOL, atol=ATOL)


def test_bucket_selection_padding_and_limits():
    ex = _executor()
    assert ex.forwards == 3                       # one warm forward a bucket
    assert [ex.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    ex.infer({"data": _rows(3)})
    assert ex.calls[4] == 1 and ex.rows_padded == 1 and ex.rows_served == 3
    assert ex.bucket_fill()[4] == 0.75
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        ex.infer({"data": _rows(5)})
    with pytest.raises(ValueError, match="row shape"):
        ex.infer({"data": np.zeros((1, 3, 4, 4), np.float32)})
    with pytest.raises(ValueError, match="missing inputs"):
        ex.infer({"image": _rows(1)})


def test_parse_buckets():
    assert parse_buckets("16,1,4,4") == (1, 4, 16)
    with pytest.raises(ValueError):
        parse_buckets("0,2")


def test_swap_params_validates_and_applies():
    ex = _executor()
    x = _rows(2, seed=3)
    before = ex.infer({"data": x})["prob"]
    new = {l: {p: v * 0.5 for p, v in d.items()}
           for l, d in ex._params.items()}
    assert ex.swap_params(new) == 1
    after = ex.infer({"data": x})["prob"]
    np.testing.assert_allclose(after, _direct(ex.net, x, ex._params),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(after - before).max() > 1e-4
    bad = {l: dict(d) for l, d in new.items()}
    bad["fc"]["w"] = bad["fc"]["w"][:, :-1]
    with pytest.raises(ValueError, match="fc/w"):
        ex.swap_params(bad)
    assert ex.params_version == 1


def test_server_client_roundtrip_on_port_zero():
    ex = _executor()
    server = InferenceServer(ex, port=0, max_delay_s=0.002)
    cli = ServingClient(server.addr)
    try:
        for n in (1, 3, 4):
            x = _rows(n, seed=10 + n)
            out = cli.infer({"data": x})
            np.testing.assert_allclose(out["prob"], _direct(ex.net, x),
                                       rtol=RTOL, atol=ATOL)
        with pytest.raises(ServingError, match="row shape"):
            cli.infer({"data": np.zeros((1, 3, 5, 5), np.float32)})
        with pytest.raises(ServingError, match="exceeds max batch"):
            cli.infer({"data": _rows(5)})
        stats = cli.stats()
        assert stats["rows_served"] == 8 and stats["latency"]["count"] == 3
        assert cli.health()["ok"]
    finally:
        cli.close()
        server.shutdown()


def test_jax_client_talks_to_port_server():
    """Same wire protocol: the JAX package's ServingClient (codec
    negotiation included) is served by the port's server."""
    from poseidon_tpu.serving.client import ServingClient as JaxClient
    ex = _executor()
    server = InferenceServer(ex, port=0, max_delay_s=0.002)
    cli = JaxClient(server.addr)
    try:
        x = _rows(2, seed=21)
        out = cli.infer({"data": x})
        np.testing.assert_allclose(out["prob"], _direct(ex.net, x),
                                   rtol=RTOL, atol=ATOL)
    finally:
        cli.close()
        server.shutdown()


def _jax_lenet():
    from poseidon_tpu.core.net import Net as JaxNet
    from poseidon_tpu.proto.messages import load_net as jax_load_net
    jnet = JaxNet(jax_load_net(LENET), "TEST", conv_layout="NCHW")
    return jnet, jnet.init(jax.random.PRNGKey(5))


def _jax_prob(jnet, params, x):
    return np.asarray(jnet.apply(params, {"data": x},
                                 train=False).outputs["prob"])


def test_port_serves_jax_solverstate(tmp_path):
    from poseidon_tpu.parallel.trainer import init_train_state
    from poseidon_tpu.runtime.checkpoint import snapshot
    jnet, params = _jax_lenet()
    _, state_path = snapshot(str(tmp_path / "lenet"), jnet, params,
                             init_train_state(params))
    ex = BucketedExecutor.from_files(LENET, state_path, buckets=(1, 4),
                                     device="cpu")
    x = _rows(3, seed=31, shape=(1, 28, 28))
    np.testing.assert_allclose(ex.infer({"data": x})["prob"],
                               _jax_prob(jnet, params, x),
                               rtol=RTOL, atol=ATOL)


def test_port_serves_jax_caffemodel(tmp_path):
    from poseidon_tpu.proto.wire import encode_caffemodel
    jnet, params = _jax_lenet()
    path = tmp_path / "lenet.caffemodel"
    path.write_bytes(encode_caffemodel(jnet.name,
                                       jnet.export_weights(params)))
    ex = BucketedExecutor.from_files(LENET, str(path), buckets=(1, 4),
                                     device="cpu")
    x = _rows(4, seed=32, shape=(1, 28, 28))
    np.testing.assert_allclose(ex.infer({"data": x})["prob"],
                               _jax_prob(jnet, params, x),
                               rtol=RTOL, atol=ATOL)


def test_snapshot_missing_layer_is_refused(tmp_path):
    from poseidon_tpu.proto.wire import encode_caffemodel
    jnet, params = _jax_lenet()
    weights = jnet.export_weights(params)
    path = tmp_path / "partial.solverstate.npz"
    np.savez(path, **{"params/conv1\x1fw": weights["conv1"][0]})
    with pytest.raises(ValueError, match="snapshot is missing param"):
        BucketedExecutor.from_files(LENET, str(path), buckets=(1,),
                                    device="cpu")
    bad = tmp_path / "bad.caffemodel"
    weights["ip2"] = [weights["ip2"][0]]
    bad.write_bytes(encode_caffemodel(jnet.name, weights))
    with pytest.raises(ValueError, match="ip2"):
        BucketedExecutor.from_files(LENET, str(bad), buckets=(1,),
                                    device="cpu")


def test_cli_serve_subprocess_sigterm_drains(tmp_path):
    """`python -m poseidon_tpu_torch serve --device cpu` logs its address,
    answers a request, and exits 0 on SIGTERM with the final stats line."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import time
    proc = subprocess.Popen(
        [sys.executable, "-m", "poseidon_tpu_torch", "serve",
         f"--model={LENET}", "--buckets", "1,2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        port = None
        t_end = time.time() + 120
        while time.time() < t_end:
            line = proc.stdout.readline()
            if not line:
                break
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "server never logged its address"
        cli = ServingClient(("127.0.0.1", port))
        out = cli.infer({"data": _rows(2, seed=41, shape=(1, 28, 28))})
        cli.close()
        assert out["prob"].shape == (2, 10)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        final = [l for l in rest.splitlines() if "serving_final_stats" in l]
        assert json.loads(final[-1])["serving_final_stats"]["rows_served"] \
            == 2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
