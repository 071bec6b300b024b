"""Configuration of the port (the port's copy of ``poseidon_tpu/config.py``
for what it covers): the step-pipeline policy of the training loop
(``PipelineConfig``), the async-SSP tier's fault-tolerance policy
(``FaultConfig``) and managed-communication policy
(``ManagedCommConfig``), each with the JAX package's defaults, and the
numeric policy, whose names are re-exported from ``numeric.py`` as the JAX
package's ``config`` re-exports them, the named SPMD mesh request
(``MeshConfig``, ``train --mesh``), the two-tier fabric's policy
(``FabricConfig``, ``train --async_ssp --slice``) and the serving fleet's
(``FleetConfig``, ``serve --replicas``), and where the tuned store lives
(``CompileCacheConfig``, ``--compile_cache_dir``)."""

from __future__ import annotations

import os
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


@dataclass(frozen=True)
class MeshConfig:
    """Named-axis SPMD mesh request (``--mesh dp2,fsdp2,tp1``), the JAX
    package's ``MeshConfig``:

      ``data`` — classic data parallelism (replicated params, batch shards);
      ``fsdp`` — batch shards PLUS parameter-arena sharding: arena buckets
                 live 1/fsdp per rank, gradients reduce-scatter, params
                 all-gather (the ZeRO trade);
      ``tp``   — tensor parallelism: FC layers take column/row weight
                 shards, activations reshard at planner-chosen points.

    Sizes of 1 deactivate an axis; one rank a device, so the world is
    ``n_devices``. ``parallel/spmd.py`` plans a net on it."""

    data: int = 1
    fsdp: int = 1
    tp: int = 1
    # False = the replicated CONTROL arm on the same mesh (same batch
    # shards, same hierarchical reduction order, sharding mechanism off),
    # spelled ``--mesh dp2,fsdp2,replicated``
    shard: bool = True

    _KEYS = (("dp", "data"), ("data", "data"), ("fsdp", "fsdp"),
             ("tp", "tp"))

    @classmethod
    def parse(cls, spec: str) -> "MeshConfig":
        """``"dp2,fsdp2,tp1"`` (any subset, any order) -> MeshConfig.
        Unknown axis names and repeated axes fail loudly; a
        ``replicated`` token selects the control arm."""
        sizes = {}
        shard = True
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if part == "replicated":
                shard = False
                continue
            for key, axis in cls._KEYS:
                if part.startswith(key) and part[len(key):].isdigit():
                    if axis in sizes:
                        raise ValueError(
                            f"--mesh {spec!r}: axis {axis!r} given twice")
                    sizes[axis] = int(part[len(key):])
                    break
            else:
                raise ValueError(
                    f"--mesh {spec!r}: cannot parse {part!r} (expected "
                    f"dpN / fsdpN / tpN or 'replicated', e.g. "
                    f"'dp2,fsdp2,tp1')")
        cfg = cls(shard=shard, **sizes)
        for name, size in (("data", cfg.data), ("fsdp", cfg.fsdp),
                           ("tp", cfg.tp)):
            if size < 1:
                raise ValueError(f"--mesh {spec!r}: {name} size must be "
                                 f">= 1, got {size}")
        return cfg

    @property
    def n_devices(self) -> int:
        return self.data * self.fsdp * self.tp

    @property
    def active(self) -> bool:
        """True when the request needs the SPMD planner (any sharding
        beyond plain data parallelism)."""
        return self.fsdp > 1 or self.tp > 1

    def describe(self) -> str:
        return (f"dp{self.data},fsdp{self.fsdp},tp{self.tp}"
                + ("" if self.shard else ",replicated"))


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


_pipeline = PipelineConfig()


def pipeline_config() -> PipelineConfig:
    """The process's pipeline defaults (a tuned plan's ``device_prefetch``
    and ``max_in_flight`` land here, ``runtime/tuned_plan.py``)."""
    return _pipeline


def set_pipeline_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_pipeline, k):
            raise AttributeError(k)
        setattr(_pipeline, k, v)


@dataclass
class CompileCacheConfig:
    """Where the tuned store lives (``runtime/compile_cache.py``):
    ``<cache_dir>/tuned/``. Empty means no store configured: the conv
    tuner then persists nothing unless a loaded plan names its own store,
    and plans use ``tuned_plan.store_dir``'s default."""

    cache_dir: str = ""


_compile_cache = CompileCacheConfig(
    cache_dir=os.environ.get("POSEIDON_COMPILE_CACHE_DIR", ""))


def compile_cache_config() -> CompileCacheConfig:
    return _compile_cache


def set_compile_cache_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_compile_cache, k):
            raise AttributeError(k)
        setattr(_compile_cache, k, v)


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


@dataclass
class FabricConfig:
    """Two-tier fabric policy (``parallel/fabric.py``): an SPMD slice as one
    elastic SSP worker. Inside a slice the named dp/fsdp/tp mesh runs the
    step synchronously over the slice's own process group; between slices
    ONE leader process a slice speaks the async-SSP protocol. These knobs
    govern the slice-granular robustness machinery only; the per-process
    async tier ignores them. The JAX package's names and defaults."""

    # mirror the leader's oplog (clock, pending-as-sent, residual) into
    # the slice ledger after every push; False trades failover coverage
    # (a successor resumes from the service anchor only) for zero copies
    ledger_mirroring: bool = True
    # a slice that shrinks below this many live members retires instead
    # of re-cutting its inner data shard (1 = never auto-retire)
    min_members: int = 1
    # seconds a successor leader waits for the service to register the
    # dead leader's disconnect before re-dialing (0 = dial immediately;
    # the hello/admit path is idempotent either way)
    failover_grace_s: float = 0.0


_fabric = FabricConfig()


def fabric_config() -> FabricConfig:
    return _fabric


def set_fabric_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_fabric, k):
            raise AttributeError(k)
        setattr(_fabric, k, v)


@dataclass
class FleetConfig:
    """Serving-fleet policy (``serving/fleet.py``): how many replicas the
    front door fans out to, where they pin, and the health and reload
    knobs, with the JAX package's defaults. replicas=1 with no device
    pinning is the single-engine path."""

    # engines behind the front door, each its own executor + micro-batcher
    replicas: int = 1
    # comma-separated CUDA device indices to pin replicas to ("" =
    # round-robin over every visible GPU when replicas > 1)
    devices: str = ""
    # consecutive dispatch failures (or wedged-submit timeouts) before a
    # replica is marked DEAD and its queue reroutes
    failure_threshold: int = 1
    # rolling reload: how long one replica may take to drain before its
    # swap is skipped this pass
    drain_timeout_s: float = 30.0
    # how often the server refreshes the stats-registry "serving" section
    # for the metrics endpoint (<= 0 = only on stats-op reads)
    stats_refresh_s: float = 2.0


_fleet = FleetConfig()


def fleet_config() -> FleetConfig:
    return _fleet


def set_fleet_config(**kwargs) -> None:
    for k, v in kwargs.items():
        if not hasattr(_fleet, k):
            raise AttributeError(k)
        setattr(_fleet, k, v)
