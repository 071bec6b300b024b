"""The port's layout census (``runtime/hlo_layout.py``) against the JAX
package's ``net_transpose_report`` on the CPU.

The JAX count is read off the lowered program (StableHLO); the port's off
what its eager step dispatches. Tolerances: exact counts and exact shapes
and permutations. The port's channels-last AlexNet step makes JAX's two
fc6 boundary transposes, with the same shapes and permutations, and five
more: one copy of each conv filter into channels-last a step
(``ops/nn.conv2d``), which JAX's conv takes in OIHW without a transpose.
That difference is a recorded divergence (ROADMAP queue C), listed op by
op below.
"""

import pytest
import torch

from poseidon_tpu.core.net import Net as JaxNet
from poseidon_tpu.models import zoo as jzoo
from poseidon_tpu.runtime import hlo_layout as JL

from poseidon_tpu_torch.core.net import Net
from poseidon_tpu_torch.models import zoo
from poseidon_tpu_torch.runtime import hlo_layout as L
from poseidon_tpu_torch.runtime.op_census import (OpRecord, TensorMeta,
                                                  record)

IMAGE, ROWS = 227, 2

# the conv filters the port copies into channels-last once a step
# (out_shape, perm): conv1..conv5 of the zoo's AlexNet (groups 1,2,1,2,2)
FILTER_COPIES = [
    ([96, 11, 11, 3], [0, 2, 3, 1]),
    ([256, 5, 5, 48], [0, 2, 3, 1]),
    ([384, 3, 3, 256], [0, 2, 3, 1]),
    ([384, 3, 3, 192], [0, 2, 3, 1]),
    ([256, 3, 3, 192], [0, 2, 3, 1]),
]


def _nets(layout):
    shapes = {"data": (ROWS, 3, IMAGE, IMAGE), "label": (ROWS,)}
    ours = Net(zoo.alexnet(num_classes=10, with_accuracy=False), "TRAIN",
               device="cpu", source_shapes=shapes, conv_layout=layout)
    theirs = JaxNet(jzoo.alexnet(num_classes=10, with_accuracy=False),
                    "TRAIN", shapes, conv_layout=layout)
    return ours, theirs


@pytest.fixture(scope="module")
def reports():
    ours, theirs = _nets("NHWC")
    return {"NHWC": (L.net_transpose_report(ours, per_dev_batch=ROWS,
                                            image=IMAGE),
                     JL.net_transpose_report(theirs, per_dev_batch=ROWS,
                                             image=IMAGE))}


@pytest.mark.parametrize("out_shape,perm", [
    ((4, 6, 6, 256), (0, 2, 3, 1)),
    ((4, 256, 6, 6), (0, 3, 1, 2)),
    ((4, 1, 1, 256), (0, 2, 3, 1)),      # degenerate: folds to a bitcast
    ((1, 256, 1, 1), (0, 3, 1, 2)),
    ((2, 3, 4), (0, 2, 1)),              # rank 3: never a layout change
    ((5, 6, 7, 8, 9), (0, 1, 3, 2, 4)),
])
def test_transpose_op_semantics_are_jaxs(out_shape, perm):
    ours = L.TransposeOp(out_shape=out_shape, perm=perm)
    theirs = JL.TransposeOp(out_shape=out_shape, perm=perm)
    assert (ours.rank, ours.nontrivial, ours.is_layout) == \
        (theirs.rank, theirs.nontrivial, theirs.is_layout)


def _meta(t):
    return TensorMeta.of(t)


def test_a_copy_between_memory_orders_is_one_transpose():
    x = torch.zeros(2, 8, 5, 5)
    cl = x.contiguous(memory_format=torch.channels_last)
    recs = [
        OpRecord("aten.clone.default", (_meta(x),), (_meta(cl),), "t"),
        # the same order: a copy, no transpose
        OpRecord("aten.clone.default", (_meta(x),), (_meta(x.clone()),),
                 "t"),
        # copy_(dst, src): channels-last into NCHW
        OpRecord("aten.copy_.default", (_meta(x), _meta(cl)), (_meta(x),),
                 "t"),
        # a degenerate (N, C, 1, 1) conversion moves nothing
        OpRecord("aten.clone.default", (_meta(torch.zeros(2, 8, 1, 1)),),
                 (_meta(torch.zeros(2, 8, 1, 1).contiguous(
                     memory_format=torch.channels_last)),), "t"),
        # not a copy op at all
        OpRecord("aten.add.Tensor", (_meta(x), _meta(cl)), (_meta(x),),
                 "t"),
    ]
    rep = L.layout_report(recs)
    assert rep["transposes_total"] == 2
    assert rep["layout_transposes"] == 2
    assert [(s["shape"], s["perm"]) for s in
            rep["layout_transpose_shapes"]] == [
        ([2, 5, 5, 8], [0, 2, 3, 1]), ([2, 8, 5, 5], [0, 3, 1, 2])]


def test_a_materialized_permute_counts_and_a_view_does_not():
    x = torch.randn(2, 8, 5, 5)

    def view_only():
        return x.permute(0, 2, 3, 1)

    def materialized():
        return x.permute(0, 2, 3, 1).contiguous()

    assert L.count_layout_transposes(record(view_only)[1]) == 0
    _, recs = record(materialized)
    assert L.count_layout_transposes(recs) == 1


def test_channels_last_alexnet_holds_jaxs_fc6_pair_plus_the_filter_copies(
        reports):
    ours, theirs = reports["NHWC"]
    assert theirs["layout_transposes"] == 2           # JAX's golden
    jax_pair = [(s["shape"], s["perm"])
                for s in theirs["layout_transpose_shapes"]]
    got = [(s["shape"], s["perm"]) for s in ours["layout_transpose_shapes"]]
    # op by op: the five filter copies (forward, conv1..conv5), then the
    # fc6 boundary pair exactly as JAX lowers it (forward NHWC->NCHW,
    # backward NCHW->NHWC)
    assert got == FILTER_COPIES + jax_pair, got
    assert all(s["op"] == "aten.clone.default"
               for s in ours["layout_transpose_shapes"])
    assert ours["layout_transposes"] == theirs["layout_transposes"] + \
        len(FILTER_COPIES)
    assert (ours["level"], ours["conv_layout"]) == ("aten", "NHWC")


def test_nchw_alexnet_converts_nothing_in_either_package():
    """The NCHW step at JAX's contract size (67 px) against the count
    JAX's golden pins for it."""
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "evidence", "hlo_contracts",
            "alexnet.json")) as f:
        golden = json.load(f)["stablehlo"]["layout_transposes"]
    net = Net(zoo.alexnet(num_classes=10, with_accuracy=False), "TRAIN",
              device="cpu", source_shapes={"data": (1, 3, 67, 67),
                                           "label": (1,)})
    ours = L.net_transpose_report(net, per_dev_batch=1, image=67)
    assert ours["layout_transposes"] == golden == 0


def test_plain_pool_backward_converts_nothing_on_a_channels_last_step():
    """The plain MAX/AVE pooling backward computes in its input's memory
    format (as the kernels write it): a channels-last pool's backward
    makes no copy between memory orders on the CPU, as on the card."""
    from poseidon_tpu_torch.ops.pool import ave_pool, max_pool
    x = torch.randn(2, 16, 13, 13).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    for pool in (max_pool, ave_pool):
        y = pool(x, (3, 3), (2, 2), (0, 0))
        g = torch.randn(y.shape).contiguous(memory_format=torch.channels_last)
        _, recs = record(lambda: y.backward(g))
        assert L.count_layout_transposes(recs) == 0, pool
        assert x.grad.is_contiguous(memory_format=torch.channels_last)
        x.grad = None


def test_step_avals_and_inputs_follow_the_layout():
    ours, _ = _nets("NHWC")
    av = L.step_avals(ours, ROWS, IMAGE)
    assert av["batch"]["data"] == ((ROWS, 3, IMAGE, IMAGE), "float32",
                                   "channels_last")
    assert av["params"]["conv1"]["w"] == ((96, 3, 11, 11), "float32")
    with pytest.raises(ValueError, match="conv_layout"):
        L.build_plain_step(ours, None, input_layout="NCHW")
