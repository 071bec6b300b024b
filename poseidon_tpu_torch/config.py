"""Configuration of the port (the port's copy of ``poseidon_tpu/config.py``
for what it covers): the step-pipeline policy of the training loop
(``PipelineConfig``) and the numeric policy, whose names are re-exported
from ``numeric.py`` as the JAX package's ``config`` re-exports them. The
fault-tolerance and mesh configs are later work."""

from __future__ import annotations

from dataclasses import dataclass

from .numeric import (Policy, policy, policy_scope,  # noqa: F401
                      resolve_conv_layout, set_perf_policy, set_policy)


@dataclass
class PipelineConfig:
    """How the training loop (``runtime/engine.py``) runs the host<->device
    boundary as a pipeline: input prefetch onto the card, a bounded
    in-flight dispatch window, and background snapshot serialization. All
    three are numerics-neutral: the dispatched step sequence is identical,
    only where the host blocks moves (``tests/test_torch_pipeline_overlap.
    py`` pins bitwise parity). ``Engine`` arguments left at ``None`` take
    these defaults."""

    # host batches staged on the card AHEAD of the step that consumes them
    # (data.pipeline.DevicePrefetcher depth); 0 disables the stage and the
    # train thread copies each batch inline
    device_prefetch: int = 2
    # dispatches in flight before the loop blocks on the oldest one's
    # metrics (runtime/metrics.AsyncScalarFetcher window); 1 = the serial
    # loop. NaN detection lags by at most this many steps.
    max_in_flight: int = 2
    # serialize mid-train snapshots on a background thread, from a host
    # copy taken at the sync point (runtime/checkpoint.AsyncSnapshotWriter)
    async_snapshot: bool = False
