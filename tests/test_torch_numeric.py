"""The port's numeric policy (``poseidon_tpu_torch/numeric.py``) against the
JAX package's (``poseidon_tpu/numeric.py``): the Policy's fields and
defaults, the perf policy, the scope, the conv-layout table, the bf16 smoke
band, and the TF32 flags the active policy sets. Exact comparisons: these
are constants and tables, no arithmetic."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from poseidon_tpu import numeric as jnum
from poseidon_tpu_torch import config as tconfig
from poseidon_tpu_torch import numeric as tnum


def _dtype_name(d) -> str:
    return str(jnp.dtype(d)) if not isinstance(d, torch.dtype) \
        else str(d).replace("torch.", "")


def test_policy_fields_and_defaults_match_jax():
    jf = [f.name for f in dataclasses.fields(jnum.Policy)]
    tf = [f.name for f in dataclasses.fields(tnum.Policy)]
    assert tf == jf
    jp, tp = jnum.Policy(), tnum.Policy()
    for name in ("param_dtype", "compute_dtype", "accum_dtype"):
        assert _dtype_name(getattr(tp, name)) == \
            _dtype_name(getattr(jp, name)), name
    for name in ("conv_layout", "conv_s2d", "conv_strategy"):
        assert getattr(tp, name) == getattr(jp, name), name


def test_set_perf_policy_is_bf16_with_s2d():
    saved = dataclasses.replace(tnum.policy())
    try:
        tnum.set_perf_policy()
        assert tnum.policy().compute_dtype == torch.bfloat16
        assert tnum.policy().conv_s2d is True
        assert tnum.policy().param_dtype == torch.float32
        assert tnum.policy().accum_dtype == torch.float32
        tnum.set_perf_policy(conv_s2d=False)
        assert tnum.policy().conv_s2d is False
    finally:
        tnum.set_policy(**dataclasses.asdict(saved))
    assert tnum.policy() == saved


def test_policy_scope_restores_even_on_error():
    before = dataclasses.replace(tnum.policy())
    with pytest.raises(RuntimeError):
        with tnum.policy_scope(compute_dtype=torch.bfloat16,
                               conv_layout="NHWC"):
            assert tnum.policy().compute_dtype == torch.bfloat16
            assert tnum.policy().conv_layout == "NHWC"
            raise RuntimeError("inside the scope")
    assert tnum.policy() == before
    with pytest.raises(AttributeError):
        tnum.set_policy(no_such_field=1)


@pytest.mark.parametrize("layout", ["nchw", "NHWC", "auto", "AUTO", ""])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_resolve_conv_layout_matches_jax_table(layout, backend):
    want = jnum.resolve_conv_layout(layout, backend, consult_plan=False)
    assert tnum.resolve_conv_layout(layout, backend) == want
    if backend == "gpu":
        # the port's device type for the same backend
        assert tnum.resolve_conv_layout(layout, "cuda") == want


def test_bf16_smoke_band_equals_jax():
    for name in ("BF16_SMOKE_ITERS", "BF16_SMOKE_RTOL", "BF16_SMOKE_ATOL"):
        assert getattr(tnum, name) == getattr(jnum, name), name


def test_conv_strategy_values():
    for ok in ("", "direct", "s2d"):
        assert tnum.check_conv_strategy(ok) == ok
    for later in ("auto", "im2col"):
        with pytest.raises(NotImplementedError, match="conv_tune"):
            tnum.check_conv_strategy(later)
        with pytest.raises(NotImplementedError, match="conv_tune"):
            tnum.set_policy(conv_strategy=later)
    with pytest.raises(ValueError):
        tnum.check_conv_strategy("winograd")


def test_config_reexports_the_policy():
    for name in ("Policy", "policy", "set_policy", "set_perf_policy",
                 "policy_scope", "resolve_conv_layout"):
        assert getattr(tconfig, name) is getattr(tnum, name), name


def test_applied_tf32_flags_follow_the_policy():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        with tnum.policy_scope(compute_dtype=torch.bfloat16):
            tnum.apply_policy()
            assert torch.backends.cudnn.allow_tf32 is True
            assert torch.backends.cuda.matmul.allow_tf32 is True
        tnum.apply_policy()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
