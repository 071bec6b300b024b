"""Configuration of the port (the port's copy of ``poseidon_tpu/config.py``
for what it covers): the step-pipeline policy of the training loop
(``PipelineConfig``), the async-SSP tier's fault-tolerance policy
(``FaultConfig``) and managed-communication policy
(``ManagedCommConfig``), each with the JAX package's defaults, and the
numeric policy, whose names are re-exported from ``numeric.py`` as the JAX
package's ``config`` re-exports them. The mesh configs are later work."""

from __future__ import annotations

from dataclasses import dataclass

# the numeric policy's names, resolved on first use: the async tier reads
# this module's fault and managed-comm configs without importing torch
_NUMERIC = ("Policy", "policy", "policy_scope", "resolve_conv_layout",
            "set_perf_policy", "set_policy")


def __getattr__(name: str):
    if name in _NUMERIC:
        from . import numeric
        return getattr(numeric, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


@dataclass
class FaultConfig:
    """Fault-tolerance policy of the async-SSP process tier
    (``parallel/async_ssp.py``): clients heartbeat on the push channel, the
    service evicts a worker silent past the liveness timeout (survivors'
    gates unblock), and clients reconnect with capped exponential backoff
    and full jitter, replaying un-acked flushes (applied exactly once by
    sequence number)."""

    # client -> service heartbeat cadence (sent when the push queue is idle)
    heartbeat_s: float = 1.0
    # the service evicts a worker not heard from for this long; <= 0
    # disables eviction (a hung peer then wedges every gate)
    liveness_timeout_s: float = 30.0
    # the client gives up reconnecting (and raises into the training loop)
    # after this long without a successful attempt
    reconnect_deadline_s: float = 30.0
    # backoff envelope: sleep ~ U(0, min(cap, base * 2**attempt))
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0


_fault = FaultConfig()


def fault_config() -> FaultConfig:
    return _fault


def set_fault_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_fault, k):
            raise AttributeError(k)
        setattr(_fault, k, v)


@dataclass
class ManagedCommConfig:
    """Managed communication of the async-SSP tier (SSPAggr): with a
    finite budget the client meters the actual frame bytes of both
    channels through a token bucket; when a dense flush would overdraw it,
    only the top ``priority_frac`` of the delta by |value| ships and the
    exact complement rides a local residual, force-flushed at every
    staleness+1 clock boundary (durable-clock gating keeps the SSP bound
    exact). Budget <= 0: unlimited, the dense path byte for byte."""

    # per-link bandwidth budget in Mbit/s (<= 0 disables managed mode)
    budget_mbps: float = 0.0
    # fraction of delta entries a budget-tight push ships, by |value|
    priority_frac: float = 0.1
    # adaptive cadence: back off payload frequency under congestion
    adaptive: bool = False
    # wire dtype of the delta payloads ('' = f32; 'bf16'/'f16'/'int8'
    # compress with exact error feedback through the residual)
    wire_dtype: str = ""


_managed_comm = ManagedCommConfig()


def managed_comm_config() -> ManagedCommConfig:
    return _managed_comm


def set_managed_comm_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_managed_comm, k):
            raise AttributeError(k)
        setattr(_managed_comm, k, v)
