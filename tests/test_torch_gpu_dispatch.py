"""The K-step CUDA graph and the device-rate K7 entry on the card.

Marked ``gpu``: each test decides at run time whether a CUDA device is
present and skips without one (the CPU suite counts them as skipped; the
CPU half of these paths is ``tests/test_torch_steps_per_dispatch.py`` and
``tests/test_torch_remat_plan.py``). Imports nothing of JAX, so it runs
wherever torch sees a GPU.
"""

import contextlib

import pytest
import torch

from poseidon_tpu_torch.core import remat as R
from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.models import zoo
from poseidon_tpu_torch.ops import sgd as port_sgd
from poseidon_tpu_torch.parallel import strategies as S
from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                 init_train_state)
from poseidon_tpu_torch.proto.messages import SolverParameter
from poseidon_tpu_torch.runtime.attribution import layer_cost_table

K = 4
B = 8
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="inv",
              gamma=0.01, power=0.75)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@contextlib.contextmanager
def _deterministic():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _net():
    np_ = zoo.lenet(with_accuracy=False)
    at = [lp.name for lp in np_.layers].index("relu1") + 1
    np_.layers.insert(at, zoo.dropout("drop1", "ip1"))
    return Net(np_, "TRAIN", device="cuda", source_shapes=zoo.lenet_shapes(B))


def _batches(n):
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [{"data": torch.randn(B, 1, 28, 28, generator=gen, device="cuda"),
             "label": torch.randint(0, 10, (B,), generator=gen,
                                    device="cuda").float()}
            for _ in range(n)]


def _arm(step, net, params, batches):
    net.manual_seed(9)
    p, s = step.load(params, init_train_state(params))
    k = step.steps_per_dispatch
    losses = []
    for i in range(0, len(batches), k):
        if k == 1:
            p, s, m = step.step(p, s, batches[i])
            losses.append(float(m["loss"]))
        else:
            stack = {t: torch.stack([b[t] for b in batches[i:i + k]])
                     for t in batches[0]}
            p, s, m = step.multi_step(p, s, stack)
            losses += m["loss"].tolist()
    return losses, {l: {n: v.clone() for n, v in d.items()}
                    for l, d in p.items()}


def _same(a, b):
    return all(torch.equal(a[l][n], b[l][n]) for l in a for n in a[l])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4099, 60965224 + 7])
def test_sgd_devrate_kernel_matches_plain_on_card(n):
    """K7's device-rate entry against the plain rule, bitwise, and the
    rate read when the kernel runs: a captured launch replays at the rate
    written after the capture."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    h = torch.randn(n, generator=gen, device="cuda") * 1e-3
    seg = (torch.arange(n, device="cuda") // 97) % 2 == 1
    lr = torch.where(seg, 2.0, 1.0).float()
    dec = torch.where(seg, 0.0, 5e-4).float()
    rate = torch.tensor(0.01, device="cuda")
    wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
    before = dict(port_sgd.LAUNCHES)
    port_sgd.sgd_update_(wk, g, hk, rate, lr, dec, 0.9)
    torch.cuda.synchronize()
    assert port_sgd.LAUNCHES["sgd_update_devrate"] == \
        before["sgd_update_devrate"] + 1
    assert port_sgd.LAUNCHES["sgd_update"] == before["sgd_update"]
    port_sgd.sgd_update_plain_(wp, g, hp, 0.01, lr, dec, 0.9)
    assert torch.equal(wk, wp) and torch.equal(hk, hp)
    # captured once, replayed at another rate
    wk, hk = w.clone(), h.clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        port_sgd.sgd_update_devrate_cuda_(wk, g, hk, rate, lr, dec, 0.9)
    rate.fill_(0.25)
    graph.replay()
    torch.cuda.synchronize()
    wp, hp = w.clone(), h.clone()
    port_sgd.sgd_update_plain_(wp, g, hp, 0.25, lr, dec, 0.9)
    assert torch.equal(wk, wp) and torch.equal(hk, hp)


@pytest.mark.gpu
def test_k_step_graph_bitwise_to_eager_steps_on_card():
    """LeNet with a DROPOUT (its generator registered with the graph) at
    an inv rate: two K=4 dispatches (a warm-up and capture, a replay)
    against 8 eager steps, bitwise; a replay launches what the capture
    recorded."""
    _need_gpu()
    with _deterministic():
        net = _net()
        params = net.init(torch.Generator().manual_seed(0))
        batches = _batches(2 * K)
        sp = SolverParameter(**SOLVER)
        le, pe = _arm(build_train_step(net, sp), net, params, batches)
        graph = build_train_step(net, sp, steps_per_dispatch=K)
        lg, pg = _arm(graph, net, params, batches)
    assert graph.replays == 1
    assert graph.graph_launches == {"pool_bwd": 2 * K,
                                    "sgd_update_devrate": K}
    assert le == lg and len(set(le)) == 2 * K
    assert _same(pe, pg)


@pytest.mark.gpu
def test_remat_in_the_graph_bitwise_to_stored_on_card():
    """Max remat, the DROPOUT among the checkpointed layers, in a K=2
    graph (its recomputed mask from a registered generator slot) against
    stored eager steps, bitwise."""
    _need_gpu()
    with _deterministic():
        net = _net()
        plan = R.plan_remat(layer_cost_table(net), 0, 0,
                            candidates=R.remat_candidates(net))
        assert "drop1" in plan.layers
        params = net.init(torch.Generator().manual_seed(0))
        batches = _batches(6)
        sp = SolverParameter(**SOLVER)
        ls, ps = _arm(build_train_step(net, sp), net, params, batches)
        lr, pr = _arm(build_train_step(net, sp, remat_plan=plan), net, params,
                      batches)
        graph = build_train_step(net, sp, steps_per_dispatch=2,
                                 remat_plan=plan)
        lg, pg = _arm(graph, net, params, batches)
    assert graph.replays == 2
    assert ls == lr == lg
    assert _same(ps, pr) and _same(ps, pg)


@pytest.mark.gpu
def test_graph_refuses_host_counter_topk_on_card():
    _need_gpu()
    net = _net()
    comm = S.CommConfig(layer_strategies={"ip2": S.TOPK},
                        topk_policy="random")
    with pytest.raises(ValueError, match="host's step counter"):
        build_train_step(net, SolverParameter(**SOLVER), None, comm,
                         steps_per_dispatch=K)
    build_train_step(net, SolverParameter(**SOLVER), None, comm)
