"""Engine: solver-driven training on one GPU or data-parallel over ranks
(the port of ``poseidon_tpu/runtime/engine.py``'s synchronous engine,
Caffe's ``Solver::Solve``).

- resolve the train and test nets from a SolverParameter (file or inline,
  the shared-net pattern filtered by phase);
- a data pipeline per data layer (``data/pipeline.py``: the native C++
  batcher for LMDB, the Python sources otherwise; each pipeline's route is
  logged), and ``DevicePrefetcher`` staging the train batches on the card
  ahead of the step;
- the loop as a pipeline: step k+1 is dispatched before step k's metrics
  are read (``AsyncScalarFetcher``'s window of ``max_in_flight``
  dispatches); hard syncs only at the display, test and snapshot
  boundaries and at the end, so a NaN is never snapshotted, and
  ``TrainingDivergedError`` names the step that produced it; snapshots
  written in the background under ``async_snapshot``;
- with ``device_transform`` the train pipelines ship uint8 crops and the
  train step applies ``(x - mean) * scale`` on the card;
- host spans (``runtime/spans.py``) dumped as a Chrome trace under
  ``trace_out``; metrics rows written as the JAX engine's CSVs;
- HDF5_OUTPUT (hdf5_output_layer.cpp), its file under ``output_dir``,
  one dataset a bottom named with '/' as '_', gathered over the ranks
  (rank 0 writes): in the TRAIN net rewritten after every iteration with
  the step's bottoms (as in the JAX engine, not dumped under SSP
  staleness or ``--mesh``, with a warning, and ``iter_size`` forced to
  1); in a TEST net written after each test pass with every batch's
  bottoms. ``h5py`` is imported only for a net that has the layer.

``iter_size`` K > 1 (gradient accumulation): each step takes K
consecutive batches of every train pipeline, the micro-batches, through
the same ``DevicePrefetcher`` (which stages batches one at a time and so
passes them through unchanged), and the step accumulates, syncs once and
updates once (``parallel/trainer.py``). As in the JAX engine the engine
warns and runs ``iter_size`` 1 under SSP staleness, under an active
``--mesh`` and with HDF5_OUTPUT in the TRAIN net; the SSP and SPMD steps
refuse K > 1.

Telemetry, as the JAX engine's: a ``StatsRegistry`` (``stats``) with the
counters ``train_iters`` and ``steps_in_flight``, the timers
``input_stall``, ``train_step`` and ``train_total``, the gauges
``iteration``, ``lr`` and ``train_<scalar>``, and at exit the ``comm``
section (``comm_stats``' summary, with the measured step, and per-layer
table); rank 0 writes it as ``stats.yaml`` under ``output_dir`` at every
display boundary and at exit. ``metrics_port`` (>= 0) serves it read-only
over HTTP (``metrics.MetricsServer``: ``/`` key=value lines, ``/yaml``),
bound by rank 0 alone unless the port is 0 (ephemeral, every rank).

``steps_per_dispatch`` K > 1 (JAX's rule): a chunk of K steps runs as one
dispatch (``TrainStep.multi_step``: a CUDA graph of the K steps on the
card) whenever no display, test or snapshot boundary falls inside it, and
single steps run up to each boundary. A chunk's K batches (K x iter_size
under ``iter_size``) come through the ``DevicePrefetcher`` where it runs
and are stacked on the card in one copy (``_next_batch_stack``), in the
order single steps take them, so a chunked run is the single-step run bit
for bit. As in the JAX engine it warns and runs 1 under SSP staleness,
under an active ``--mesh`` and with HDF5_OUTPUT in the TRAIN net, and
(the card's own rule) over gloo ranks on the card, whose collectives a
CUDA graph cannot capture.

``remat`` and ``hbm_budget_gb`` (JAX's ``_plan_remat``): a comma-separated
layer list checkpoints those layers (source ``flag``); ``auto`` and/or a
budget in GiB run the measured planner (``core/remat.py``): one no-remat
forward and backward on a batch of the train shapes gives the card's peak
(on the CPU the analytic activation total), every rank takes the largest,
and the knapsack picks the layers; a budget < 0 is the card's own limit
(on the CPU: a warning, no plan); ``none`` is off. The plan's
``describe()`` is logged and its ``to_doc()`` is stats.yaml's ``remat``
section; a plan that fits (identity) is dropped. Under SSP staleness the
flags warn and are ignored, as in JAX.

``profile_steps`` N > 0 (``train --profile N``, JAX's window): a
``torch.profiler`` session (the CPU and, on the card, the device) traces
N steps from the third step after ``train()`` starts, after one warm-up
step of its own whose events it drops, and closes after them, or in the
``finally`` block; the loop dispatches single steps from the start until
the window closes (no CUDA graph replays inside it: a replayed graph's
kernels carry no layer) and chunks after it. The trace
goes to ``output_dir/profile/`` ("Wrote profiler trace to ..."); rank 0
prints the per-layer attribution table (``runtime/attribution.py``) and
stats.yaml gains a ``profile`` section: the trace, each kernel's
launches over the window (the counters' rise), coverage and the top
sinks. When the CLI resolved a tuned plan (``runtime/tuned_plan.py``),
stats.yaml carries its ``tuned_plan`` section: every knob's value and
source (flag, plan, default) and the flags that overrode a measured
winner.

``device_prefetch``, ``max_in_flight`` and ``async_snapshot`` left at
``None`` take the process's ``config.pipeline_config()`` (a tuned plan's
values after ``tuned_plan.apply_training_resolution``). The pipeline moves
only where the host blocks: the steps and their batches are the serial
loop's (``device_prefetch=0, max_in_flight=1``), bit for bit.

The prototxt batch_size is the batch of one rank's device (the JAX engine
multiplies it by its local device count; here the multiplier is 1): the
global batch is batch_size x world. Rank and world come from the launcher
env contract (``runtime/cluster.py``), or from a cluster ``hostfile`` and
``node_id`` (host 0 the coordinator): each rank reads its own
``Shard(rank, world)`` of the records, the step all-reduces as its
``CommConfig`` says (``parallel/strategies.py``), parameters and momentum
are broadcast from rank 0 after init and restore, metrics are averaged over
the ranks, only rank 0 logs (the static comm table once) and writes the
CSVs, and every rank writes the (identical) snapshots, as in the JAX
engine, with every residual group's TOPK residual gathered into them.
``dcn_slices`` > 1 splits the world into that many slices (the two-tier
group, ``parallel/mesh.py``) and sets ``CommConfig.dcn_axis``.

``staleness`` > 0 trains by SSP (``parallel/trainer.SSPTrainStep``):
each group runs local steps and every staleness+1 iterations the deltas
fold into the anchor, which is the engine's ``params`` (and the
.caffemodel); the SSP snapshot stacks every group's local copy, gathered
to every rank. ``async_ssp`` (a dict of ``runtime/async_tier.
AsyncSSPTier`` arguments, ``staleness`` among them) trains by the
wait-free async tier instead: no process group is made, rank and world
come from the launcher env, each process runs the local synchronous step
on its own device, and the tier's ``after_iters`` runs after every step
(a clock boundary hard-syncs the in-flight window first, span
``hard_sync`` with boundary ``async_clock``), ``finish`` at the end; a
change of membership reshards the train data (``reshard_data``). With
``async_ssp["slice"]`` (``--slice``) the processes form slices
(``parallel/fabric.py``): each slice's ranks make the slice's own process
group and named mesh (``mesh_cfg``) and read the two-tier shard, the
slice's leader runs ``FabricTier`` and the other members ``SliceMember``.
Parameters are filled from ``sp.random_seed`` (1 when unset) with a CPU
``torch.Generator``; the
dropout generator is seeded from it with the rank folded in
(``parallel/mesh.rank_seed``), so a seed gives the same run on any device;
the random streams are torch's, not JAX's. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import pipeline_config
from ..core.net import Net
from ..data.pipeline import (BatchPipeline, DevicePrefetcher,
                             build_phase_pipelines, place_batch)
from ..data.workload import Shard
from ..numeric import policy, resolve_device
from ..ops import _build
from ..parallel.mesh import DCN_AXIS, DataGroup, rank_seed
from ..parallel.strategies import TOPK, CommConfig, auto_strategies
from ..parallel.trainer import (build_eval_step, build_ssp_train_step,
                                build_train_step, graph_refusal,
                                init_ssp_state, init_train_state)
from ..proto.messages import NetParameter, SolverParameter, load_net
from ..solvers.updates import learning_rate
from .checkpoint import (AsyncSnapshotWriter, coerce_state, latest_snapshot,
                         load_caffemodel, restore, snapshot, sweep_stale_tmp)
from .cluster import env_world, init_distributed, local_device
from .comm_stats import comm_summary, layer_comm_table
from .metrics import (AsyncScalarFetcher, MetricsServer, MetricsTable,
                      StatsRegistry, log)
from .spans import recorder as span_recorder


class TrainingDivergedError(RuntimeError):
    """Raised when the training loss goes non-finite; ``iteration`` is the
    step that produced the value (the loop may have dispatched up to
    ``max_in_flight`` steps past it)."""

    def __init__(self, iteration: int, key: str, value: float):
        self.iteration = iteration
        self.key = key
        self.value = value
        super().__init__(f"training diverged: {key} = {value} at iteration "
                         f"{iteration}")


def resolve_nets(sp: SolverParameter):
    """Train NetParameter + list of test NetParameters, per the reference's
    precedence: train_net_param, train_net, net_param, net (solver.cpp)."""
    train: Optional[NetParameter] = None
    tests: List[NetParameter] = []
    if sp.train_net_param is not None:
        train = sp.train_net_param
    elif sp.train_net:
        train = load_net(sp.train_net)
    elif sp.net_param is not None:
        train = sp.net_param
    elif sp.net:
        train = load_net(sp.net)
    else:
        raise ValueError("solver specifies no train net")
    tests.extend(sp.test_net_param)
    for path in sp.test_net:
        tests.append(load_net(path))
    if not tests and sp.test_iter:
        # shared-net pattern: the same NetParameter filtered by TEST phase
        tests.append(train)
    return train, tests


def device_input_transform(pipes: List[BatchPipeline], device
                           ) -> Optional[Callable]:
    """The card's half of the uint8 split: for each train pipeline with a
    ``device_transform_spec``, its top as f32, minus the per-channel mean,
    times the scale — the order of the native batcher's ``transform_one``,
    so the result is the host f32 batch bit for bit. None when no pipeline
    ships uint8."""
    specs = {p.tops[0]: p.device_transform_spec for p in pipes
             if p.device_transform_spec is not None}
    if not specs:
        return None
    frozen = {top: (None if s["mean_values"] is None
                    else torch.as_tensor(np.asarray(s["mean_values"]),
                                         dtype=torch.float32,
                                         device=device).view(1, -1, 1, 1),
                    float(s["scale"]))
              for top, s in specs.items()}

    def transform(batch: Dict[str, torch.Tensor]):
        out = dict(batch)
        for top, (mean, scale) in frozen.items():
            if top not in out:
                continue
            x = out[top].float()
            if mean is not None:
                x = x - mean
            if scale != 1.0:
                x = x * scale
            out[top] = x
        return out

    return transform


def mesh_async_refusal(mesh_cfg) -> str:
    """The refusal of a multi-device mesh under the async tier without the
    fabric: one process a device, so an N-device mesh is N processes, and
    in the port that is a slice."""
    return (f"--mesh {mesh_cfg.describe()} spans {mesh_cfg.n_devices} "
            f"devices, which the async tier's one-process workers cannot "
            f"hold: run the mesh as a slice (--async_ssp --slice with "
            f"POSEIDON_SLICE_ID/POSEIDON_SLICE_SIZE, parallel/fabric.py)")


class Engine:
    def __init__(self, sp: SolverParameter, output_dir: str = ".",
                 device=None, comm: Optional[CommConfig] = None,
                 sfb_auto: bool = False,
                 device_prefetch: Optional[int] = None,
                 max_in_flight: Optional[int] = None,
                 async_snapshot: Optional[bool] = None,
                 device_transform: bool = False, use_native: bool = True,
                 memory_data: Optional[Dict[str, np.ndarray]] = None,
                 trace_out: Optional[str] = None, dcn_slices: int = 0,
                 staleness: int = 0, async_ssp: Optional[Dict] = None,
                 mesh_cfg=None, metrics_port: Optional[int] = None,
                 hostfile: Optional[str] = None,
                 node_id: Optional[int] = None,
                 steps_per_dispatch: int = 1, remat: Optional[str] = None,
                 hbm_budget_gb: Optional[float] = None,
                 profile_steps: int = 0):
        self.sp = sp
        self.profile_steps = max(0, int(profile_steps))
        # the launch counters where the profile window's traced steps
        # began
        self._profile_launches: Dict[str, int] = {}
        self._want_spd = max(1, int(steps_per_dispatch))
        self._remat_flag = remat
        self.hbm_budget_gb = hbm_budget_gb
        # the named SPMD mesh (``--mesh dp2,fsdp2,tp1``,
        # ``config.MeshConfig``): the planner (``parallel/spmd.py``) plans
        # the train net below; an inactive one (``--mesh dp2``) is plain
        # data parallelism over exactly that many ranks
        self.mesh_cfg = mesh_cfg
        self.plan = None
        if mesh_cfg is not None and mesh_cfg.active:
            if dcn_slices > 1 or (comm is not None
                                  and comm.dcn_axis is not None):
                raise ValueError("--mesh and --dcn_slices do not compose")
        self._slice = None
        if async_ssp is not None and async_ssp.get("slice"):
            from .async_tier import require_slice
            self._slice = require_slice()
        elif async_ssp is not None and mesh_cfg is not None \
                and mesh_cfg.n_devices > 1:
            raise ValueError(mesh_async_refusal(mesh_cfg))
        self.staleness = max(0, int(staleness))
        self._async_cfg = async_ssp
        self._async_tier = None
        self.output_dir = output_dir
        self.comm = comm or CommConfig()
        if dcn_slices > 1 and self.comm.dcn_axis is None:
            self.comm.dcn_axis = DCN_AXIS
        self.sfb_auto = sfb_auto
        pc = pipeline_config()
        self.device_prefetch = max(0, int(
            pc.device_prefetch if device_prefetch is None
            else device_prefetch))
        self.max_in_flight = max(1, int(
            pc.max_in_flight if max_in_flight is None else max_in_flight))
        self.async_snapshot = bool(
            pc.async_snapshot if async_snapshot is None else async_snapshot)
        self.device_transform = device_transform
        self.use_native = use_native
        self.memory_data = memory_data
        self.train_pipelines: List[BatchPipeline] = []
        self.test_pipelines: List[List[BatchPipeline]] = []
        self._device_feed: Optional[DevicePrefetcher] = None
        self._snap_writer = (AsyncSnapshotWriter() if self.async_snapshot
                             else None)
        if self._slice is not None:
            # the fabric: the slice's own process group and mesh; between
            # slices the tier's service is the only exchange
            from ..parallel.fabric import slice_submesh
            from .cluster import init_slice_group
            self.rank, self.world, _ = env_world()
            self.group = slice_submesh(mesh_cfg, init_slice_group(
                resolve_device(device), self._slice))
        elif async_ssp is not None:
            # independent processes: no process group; the tier's service
            # is the only exchange
            rank, world, _ = env_world()
            self.group = DataGroup.single(local_device(
                resolve_device(device), rank))
            self.rank, self.world = rank, world
        else:
            self.group = init_distributed(resolve_device(device),
                                          slices=max(1, dcn_slices),
                                          mesh_cfg=mesh_cfg,
                                          hostfile=hostfile, node_id=node_id)
            self.rank, self.world = self.group.rank, self.group.world
        self.device = self.group.device
        # an elastic joiner (rank outside the launch world) builds with the
        # whole range; the tier reshards it at join. On a named mesh the tp
        # replicas of a batch shard read the same records; a slice's ranks
        # read the two-tier shard of the launch roster
        self._data_shard = (Shard(self.group.batch_index,
                                  self.group.batch_shards)
                            if self.rank < self.world else Shard(0, 1))
        if self._slice is not None and not self._slice.is_joiner_slice:
            from ..parallel.fabric import two_tier_shard
            self._data_shard = two_tier_shard(
                range(self._slice.n_slices), self._slice.slice_id,
                range(self.group.batch_shards), self.group.batch_index)
        # --trace_out: the process-wide span recorder, owned (cleared,
        # enabled, dumped and disabled) by this engine
        self._trace_out: Optional[str] = None
        self._trace_warned = False
        self._owns_span_recorder = False
        if trace_out:
            self._trace_out = (trace_out if os.path.isabs(trace_out)
                               else os.path.join(output_dir, trace_out))
            self._owns_span_recorder = not span_recorder.enabled
            if self._owns_span_recorder:
                span_recorder.clear()
            span_recorder.enable()
        # the timers input_stall and train_step: seconds spent waiting for
        # the data pipeline / dispatching steps (the host's time up to the
        # window's backpressure), and the counter train_iters, over this
        # engine's train() calls; the counter steps_in_flight is the last
        # train()'s mean window occupancy at dispatch
        self.stats = StatsRegistry()
        # the tuned plan's provenance (runtime/tuned_plan.py): when the CLI
        # resolved a plan for this run, stats.yaml says every knob's value
        # and source and which measured winners a flag overrode
        from .tuned_plan import active_resolution
        plan = active_resolution()
        if plan is not None:
            self.stats.set_section("tuned_plan", plan.provenance())
        self._metrics_server: Optional[MetricsServer] = None
        self.metrics_port: Optional[int] = None
        self._telemetry_warned = False
        try:
            self._start_metrics_server(metrics_port)
            self._build()
        except BaseException:
            self.close()
            raise

    def _start_metrics_server(self, port: Optional[int]) -> None:
        """``--metrics_port``: a fixed port is bound by rank 0 alone (every
        rank gets the same flags); 0 binds an ephemeral port on every
        rank. A port that cannot be bound warns and training goes on."""
        if port is None or port < 0 or (port > 0 and self.rank != 0):
            return
        try:
            self._metrics_server = MetricsServer(self.stats, port=port)
        except OSError as e:
            log(f"WARNING: --metrics_port {port} unavailable ({e}); "
                f"training continues without the endpoint", rank=self.rank)
            return
        self.metrics_port = self._metrics_server.port
        log(f"metrics endpoint (rank {self.rank}): "
            f"http://127.0.0.1:{self.metrics_port}/ (text key=value)",
            rank=self.rank)

    def _resolve_iter_size(self, dump: bool) -> int:
        """The JAX engine's rules: iter_size runs as the solver says,
        except under SSP staleness, an active --mesh and HDF5_OUTPUT in
        the TRAIN net, where it warns and runs 1."""
        k = max(1, int(self.sp.iter_size))
        if k == 1:
            return 1
        if self.staleness > 0:
            log("WARNING: iter_size > 1 ignored under SSP staleness "
                "(increase batch_size instead)", rank=self.rank)
            return 1
        if self.plan is not None:
            log("WARNING: iter_size > 1 does not compose with --mesh "
                "sharding yet; running iter_size=1", rank=self.rank)
            return 1
        if dump:
            log("WARNING: iter_size > 1 ignored with HDF5_OUTPUT in "
                "the TRAIN net (per-iteration dump semantics)",
                rank=self.rank)
            return 1
        return k

    def _resolve_steps_per_dispatch(self, dump: bool) -> int:
        """The JAX engine's rules: K runs as asked, except under SSP
        staleness, an active --mesh and HDF5_OUTPUT in the TRAIN net, and
        (the card's rule) over gloo ranks on the card, where it warns and
        runs 1."""
        k = self._want_spd
        if k == 1:
            return 1
        if self.staleness > 0:
            log("WARNING: steps_per_dispatch ignored under SSP staleness "
                "(the SSP step already batches local steps)",
                rank=self.rank)
            return 1
        if self.plan is not None:
            log("WARNING: steps_per_dispatch ignored under --mesh "
                "sharding", rank=self.rank)
            return 1
        if dump:
            log("WARNING: steps_per_dispatch ignored with HDF5_OUTPUT "
                "in the TRAIN net (per-iteration dump semantics)",
                rank=self.rank)
            return 1
        reason = graph_refusal(self.group, self.device)
        if reason is not None:
            log(f"WARNING: steps_per_dispatch ignored: {reason}; running "
                f"single steps", rank=self.rank)
            return 1
        return k

    def _probe_batch(self) -> Dict[str, torch.Tensor]:
        """Zeros of the train shapes on the device (label 0 is a class):
        the measuring run's batch."""
        return {t: torch.zeros(s, dtype=torch.float32, device=self.device)
                for t, s in self._train_shapes.items()}

    def _plan_remat(self, params):
        """The remat decision of this job (JAX's ``_plan_remat``): a layer
        list is trusted and priced (source ``flag``); ``auto`` and/or a
        budget measure the no-remat step and run the knapsack; a negative
        budget is the card's own limit, refused with a warning where there
        is none (the CPU)."""
        from ..core import remat as remat_mod
        from .attribution import layer_cost_table
        net = self.train_net
        table = layer_cost_table(net)
        remat, budget_gb = self._remat_flag, self.hbm_budget_gb
        names = [s.strip() for s in str(remat or "").split(",")
                 if s.strip() and s.strip().lower() not in ("none", "auto")]
        if names:
            unknown = sorted(set(names) - {l.name for l in net.layers})
            if unknown:
                raise ValueError(f"--remat names unknown layers: {unknown}")
            return remat_mod.RematPlan(
                budget_bytes=0, layers=tuple(names),
                saved_bytes=sum(int(table.get(n, {}).get("act_bytes", 0))
                                for n in names),
                recompute_flops=sum(
                    float(table.get(n, {}).get("flops", 0.0)) / 3.0
                    for n in names),
                source="flag")
        if budget_gb is not None and budget_gb < 0:
            budget = remat_mod.default_budget_bytes(self.device)
            if budget <= 0:
                log("WARNING: --hbm_budget_gb auto needs device memory "
                    "stats (none on this backend); pass an explicit "
                    "budget — skipping remat planning", rank=self.rank)
                return None
        else:
            budget = int(float(budget_gb or 0) * 2**30)
        return remat_mod.plan_for_net_step(
            net, params, self._probe_batch(), budget,
            input_transform=self._input_transform, agree=self._largest)

    def _largest(self, value: int) -> int:
        """The largest of every rank's ``value`` (a tp layer's
        recomputation is a collective: every rank must plan the same
        layers)."""
        if not self.group.distributed:
            return value
        row = torch.zeros(self.group.world, dtype=torch.float64,
                          device=self.device)
        row[self.group.rank] = float(value)
        self.group.all_reduce_(row)
        return int(row.max())

    def _resolve_remat(self, params):
        """The plan the step is built with (None: off, or fits)."""
        want = ((self._remat_flag or "").strip().lower() not in ("", "none")
                or (self.hbm_budget_gb is not None
                    and self.hbm_budget_gb != 0))
        if not want:
            return None
        if self.staleness > 0:
            log("WARNING: --hbm_budget_gb/--remat are ignored under SSP "
                "staleness (the local-step path has no remat wiring yet)",
                rank=self.rank)
            return None
        plan = self._plan_remat(params)
        if plan is None or not plan.active:
            return None
        log(plan.describe(), rank=self.rank)
        self.stats.set_section("remat", plan.to_doc())
        return plan

    def _build(self) -> None:
        sp = self.sp
        train_param, test_params = resolve_nets(sp)
        self._train_param = train_param
        shard = self._data_shard
        self.train_pipelines, train_shapes = self._build_train_pipelines(
            shard)
        self._train_shapes = train_shapes
        self.train_net = Net(train_param, "TRAIN", device=self.device,
                             source_shapes=train_shapes)
        self._h5_train = [
            (l.lp.hdf5_output_param.file_name, list(l.lp.bottom))
            for l in self.train_net.layers if l.TYPE == "HDF5_OUTPUT"]
        if self._h5_train and self.staleness > 0:
            log("WARNING: HDF5_OUTPUT in the TRAIN net is not dumped "
                "under SSP staleness", rank=self.rank)
            self._h5_train = []
        pol = policy()
        log(f"numeric policy: compute {str(pol.compute_dtype)[6:]}, params "
            f"{str(pol.param_dtype)[6:]}, accumulation "
            f"{str(pol.accum_dtype)[6:]}; conv_layout "
            f"{self.train_net.conv_layout} (policy {pol.conv_layout}), "
            f"conv_s2d {pol.conv_s2d}, conv_strategy "
            f"{self.train_net.conv_strategy or '(policy)'}", rank=self.rank)
        self.test_nets: List[Net] = []
        for tp in test_params:
            pipes, shapes = build_phase_pipelines(
                tp, "TEST", shard=shard, memory_data=self.memory_data,
                use_native=self.use_native)
            self.test_pipelines.append(pipes)
            self.test_nets.append(Net(tp, "TEST", device=self.device,
                                      source_shapes=shapes))
        for phase, pipes in (("TRAIN", self.train_pipelines),
                             *(("TEST", p) for p in self.test_pipelines)):
            for p in pipes:
                log(f"data: {phase} layer {p.lp.name!r} batch "
                    f"{p.data_shape} via the {p.route} path", rank=self.rank)
        self._input_transform = device_input_transform(self.train_pipelines,
                                                       self.device)
        if self.device_transform and self._input_transform is None:
            log("WARNING: --device_transform requested but no train data "
                "layer is eligible (needs the native LMDB batcher, "
                "byte-backed records, and mean_value-style mean — a "
                "mean_file must stay host-side); using the host transform",
                rank=self.rank)
        if self.comm.server_logic != "inc" and self.staleness == 0:
            log(f"WARNING: --server_logic {self.comm.server_logic} requires "
                f"--staleness > 0 (there is no server in the synchronous "
                f"step); training plain sync SGD", rank=self.rank)
        if self.sfb_auto:
            if self.staleness > 0 and self.comm.dcn_axis is None:
                log("sfb_auto: SFB does not compose with flat-mesh SSP "
                    "staleness; keeping DENSE delta sync for all layers "
                    "(on a two-tier mesh SFB rides the intra-slice tier)",
                    rank=self.rank)
            else:
                # the cost model's picks land before the step is built
                self.comm.layer_strategies.update(
                    auto_strategies(self.train_net))
        group = self.group if self.group.distributed else None
        if self.mesh_cfg is not None and self.mesh_cfg.active:
            from ..parallel.spmd import ShardingPlan
            self.plan = ShardingPlan.build(
                self.train_net, self.mesh_cfg, self.comm,
                shard_params=self.mesh_cfg.shard,
                enable_tp=self.mesh_cfg.shard)
            log(f"sharding plan: {self.plan.describe()}", rank=self.rank)
        dump = sorted({b for _, bs in self._h5_train for b in bs})
        self.iter_size = self._resolve_iter_size(bool(dump))
        sp = dataclasses.replace(sp, iter_size=self.iter_size)
        if dump and self.plan is not None and self.staleness == 0:
            log("WARNING: HDF5_OUTPUT in the TRAIN net is not dumped "
                "under --mesh sharding", rank=self.rank)
            dump = []
            self._h5_train = []
        self.steps_per_dispatch = self._resolve_steps_per_dispatch(
            bool(dump))
        seed = sp.random_seed if sp.random_seed >= 0 else 1
        # tp replicas draw the same dropout masks (the batch-shard index;
        # a slice's, offset by its slice id)
        self.train_net.manual_seed(rank_seed(
            seed, self.group.batch_index + (
                self._slice.slice_id * self.group.batch_shards
                if self._slice is not None else 0)))
        params = self.train_net.init(torch.Generator().manual_seed(seed))
        # the measured planner runs before the step is built, as JAX's
        self.remat_plan = self._resolve_remat(params)
        if self.staleness > 0:
            self.train_step = build_ssp_train_step(
                self.train_net, sp, self.staleness, group, self.comm,
                self._input_transform, plan=self.plan)
        else:
            self.train_step = build_train_step(
                self.train_net, sp, group, self.comm, self._input_transform,
                plan=self.plan, steps_per_dispatch=self.steps_per_dispatch,
                remat_plan=self.remat_plan)
            if dump:
                self.train_step.dump_blobs = tuple(dump)
        self.eval_steps = [build_eval_step(n, group, plan=self.plan)
                           for n in self.test_nets]
        step = self.train_step
        if self.staleness > 0:
            log(f"SSP: staleness {self.staleness} (sync every "
                f"{self.staleness + 1} iters) over {step.n_groups} "
                f"group(s), server logic {self.comm.server_logic}, "
                f"{len(step.delta_buckets)} delta bucket(s)"
                + (f", the DENSE deltas in {step.fsdp_layout.n_buckets} "
                   f"fsdp-aligned bucket(s) (reduce-scatter, all-reduce, "
                   f"all-gather)" if step.fsdp_layout is not None else ""),
                rank=self.rank)
        elif self.plan is not None:
            arena = step.arena
            log(f"spmd: {self.group.world} ranks x batch "
                f"{next(iter(train_shapes.values()))[0]}, "
                f"{self.plan.n_dp} batch shard(s), sync {step.kinds}, "
                f"reduce {self.comm.reduce}, wire "
                f"{self.comm.wire_dtype or 'f32'}, "
                + (f"{arena.n_buckets} arena bucket(s) of "
                   f"{self.comm.bucket_mb:g} MB over {arena.padded_total} "
                   f"f32 (align {arena.align}), the update over "
                   + (f"a {step.w_sh.numel()}-f32 shard a rank"
                      if step.w_sh is not None else "the whole arena")
                   if arena is not None else "no arena"), rank=self.rank)
        elif group is not None:
            batch = next(iter(train_shapes.values()))[0]
            log(f"data parallel: {self.group.world} ranks x batch {batch}, "
                f"sync {step.kinds}, reduce {self.comm.reduce}, wire "
                f"{self.comm.wire_dtype or 'f32'}, {len(step.sync.hooked)} "
                f"DWBP bucket(s) of {self.comm.bucket_mb:g} MB, "
                f"{len(step.sync.fused)} after backward", rank=self.rank)
        if step.topk_slots:
            layers = [l for l, k in step.kinds.items() if k == TOPK]
            log(f"TOPK on {layers}: fraction {step.topk_fraction:g}, policy "
                f"{self.comm.topk_policy}, block {self.comm.topk_block}, "
                f"{step.n_err_groups} residual group(s)"
                + (f" (two tiers: {self.group.slices} slice(s) of "
                   f"{self.group.slice_size})" if self.comm.dcn_axis
                   else ""), rank=self.rank)
        if (group is not None or step.topk_slots) and self.staleness == 0 \
                and self.plan is None:
            # the per-step table; an SSP step exchanges at its boundary
            self._log_comm_table()
        if self.steps_per_dispatch > 1:
            log(f"steps_per_dispatch {self.steps_per_dispatch}: a chunk of "
                f"steps runs as one dispatch"
                + (" (a CUDA graph)" if self.device.type == "cuda" else "")
                + " between the display, test and snapshot boundaries",
                rank=self.rank)
        self.params, self.state = step.load(params, self._fresh_state(
            params))
        self.metrics = MetricsTable("train")
        self.test_metrics = [MetricsTable(f"test_{i}")
                             for i in range(len(self.test_nets))]

    def _fresh_state(self, params):
        """The stacked start state of the step's mode."""
        step = self.train_step
        if self.staleness > 0:
            return init_ssp_state(params, step.n_groups, self.comm)
        return init_train_state(params, self.comm, step.n_err_groups)

    def _build_train_pipelines(self, shard: Shard):
        return build_phase_pipelines(
            self._train_param, "TRAIN", shard=shard,
            memory_data=self.memory_data,
            device_transform=self.device_transform,
            use_native=self.use_native)

    def reshard_data(self, shard: Shard) -> bool:
        """Re-key the TRAIN data (elastic membership: the async tier calls
        this when the member list changes, with ``data/workload.
        member_shard``'s shard): the train pipelines, and the prefetcher
        reading them, are rebuilt on the new range; the test pipelines
        keep theirs. No-op for the same shard."""
        if shard == self._data_shard:
            return False
        old = self._data_shard
        feed = self._device_feed is not None
        if feed:
            self._device_feed.close()
            self._device_feed = None
        for p in self.train_pipelines:
            p.close()
        self.train_pipelines, _ = self._build_train_pipelines(shard)
        self._data_shard = shard
        if feed:
            self._device_feed = DevicePrefetcher(
                self.train_pipelines, self.device, depth=self.device_prefetch)
        log(f"resharded data assignment: shard {old.index}/{old.count} -> "
            f"{shard.index}/{shard.count}", rank=self.rank)
        return True

    def _log_comm_table(self) -> None:
        """The static comm accounting of the step (``comm_stats``), once,
        on rank 0."""
        if self.rank != 0:
            return
        table = layer_comm_table(self.train_net, self.comm, self.group)
        for layer, row in table.items():
            log(f"comm: {layer} {row['strategy']}: ici "
                f"{row['ici_bytes_per_step']} B, dcn "
                f"{row['dcn_bytes_per_step']} B a step a device (dense "
                f"{row['dense_alternative_bytes']} B)")
        log(f"comm: {comm_summary(table)} (est_comm_ms at the H100 SXM's "
            f"published link rates)")

    # ---------------------------------------------------------------- #
    def _next_batch(self, pipes: List[BatchPipeline]
                    ) -> Dict[str, torch.Tensor]:
        """The pipelines' next host batches, merged and copied to the
        device on this thread (the inline feed)."""
        host = {}
        for pipe in pipes:
            host.update(next(pipe))
        return place_batch(host, self.device)

    def _next_batch_stack(self, k: int, lead_shape=None
                          ) -> Dict[str, torch.Tensor]:
        """The next k train batches stacked to [k, ...] (the feeding side
        of steps_per_dispatch), in the order single steps take them:
        through the prefetcher when one runs (stacked on the card in one
        copy), else each pipeline's k host batches stacked and placed in
        one transfer. ``lead_shape`` reshapes the leading axis, (chunk,
        iter_size) when the chunk's steps accumulate."""
        if self._device_feed is not None:
            rows = [next(self._device_feed) for _ in range(k)]
            out = {t: torch.stack([r[t] for r in rows]) for t in rows[0]}
        else:
            host: List[Dict[str, np.ndarray]] = [{} for _ in range(k)]
            for pipe in self.train_pipelines:
                for i in range(k):
                    host[i].update(next(pipe))
            out = place_batch({t: np.stack([r[t] for r in host])
                               for t in host[0]}, self.device)
        if lead_shape is not None:
            out = {t: v.reshape(tuple(lead_shape) + tuple(v.shape[1:]))
                   for t, v in out.items()}
        return out

    def _chunk(self, it: int, max_iter: int,
               profile_start: Optional[int] = None) -> int:
        """How many steps the next dispatch runs: steps_per_dispatch when
        no display, test or snapshot boundary falls inside the chunk (JAX's
        rule), else 1; 1 until the profile window closes."""
        k = self.steps_per_dispatch
        if k == 1 or (profile_start is not None
                       and it < profile_start + self.profile_steps):
            return 1
        sp = self.sp
        room = max_iter - it
        if sp.display:
            room = min(room, sp.display - it % sp.display)
        if sp.test_interval and self.test_nets:
            room = min(room, sp.test_interval - it % sp.test_interval)
        if sp.snapshot:
            room = min(room, sp.snapshot - it % sp.snapshot)
        return k if room >= k else 1

    def _start_profile(self):
        """Open the profile window's ``torch.profiler`` session (its
        warm-up step comes first)."""
        from .attribution import start_trace
        return start_trace(os.path.join(self.output_dir, "profile"),
                           steps=self.profile_steps,
                           name=f"rank{self.rank}",
                           cuda=self.device.type == "cuda")

    def _stop_profile(self, prof) -> None:
        """Close the window: write the trace ("Wrote profiler trace to
        ..."), then (rank 0) the attribution table and stats.yaml's
        ``profile`` section."""
        from . import attribution as A
        trace_dir = os.path.join(self.output_dir, "profile")
        path = A.stop_trace(prof)
        if not os.path.exists(path):
            log("WARNING: the profile window closed before its first "
                "traced step; no trace written", rank=self.rank)
            return
        after = _build.launch_counts()
        launches = {k: after[k] - self._profile_launches.get(k, 0)
                    for k in after
                    if after[k] != self._profile_launches.get(k, 0)}
        log(f"Wrote profiler trace to {trace_dir}", rank=self.rank)
        if self.rank != 0:
            return
        events = A.load_trace_events(path)
        smap = A.trace_scope_map(events,
                                 {l.name for l in self.train_net.layers})
        result = A.attribute(events, smap,
                             cost_table=A.layer_cost_table(self.train_net),
                             steps=self.profile_steps)
        log(A.format_table(result, title=f"[profile] per-layer attribution "
                                         f"over {self.profile_steps} "
                                         f"steps (ms a step)"))
        self.stats.set_section("profile", {
            "trace": path, "steps": self.profile_steps,
            "launches": launches, "coverage": result["coverage"],
            "total_ms": result["total_ms"],
            "top_sinks": result["top_sinks"],
            "residual_top_ops": result["residual"]["top_ops"]})

    def _next_train_batch(self):
        """The train step's input: one batch, or under iter_size K the K
        next batches (micro-batches), through the prefetcher when one
        runs."""
        def one():
            return (next(self._device_feed) if self._device_feed is not None
                    else self._next_batch(self.train_pipelines))
        if self.iter_size == 1:
            return one()
        return [one() for _ in range(self.iter_size)]

    def iteration(self) -> int:
        return int(self.state.it if self.staleness > 0
                   else self.state.solver.it)

    def restore_from(self, path: str) -> None:
        """Weights from a .caffemodel, or params + solver state from a
        .solverstate.npz of either package and either kind, converted to
        this run's mode (``coerce_state``). Under SSP a .caffemodel
        restarts the SSP state from its weights, as in JAX."""
        if path.endswith(".caffemodel"):
            params = load_caffemodel(
                path, self.train_net,
                self.train_step.canonical_params(self.params))
            if self.staleness > 0:
                self.params, self.state = self.train_step.load(
                    params, self._fresh_state(params))
            else:
                self.params = self.train_step.load_weights(params)
            log(f"Loaded weights from {path}", rank=self.rank)
            return
        params, state = coerce_state(
            *restore(path), staleness=self.staleness,
            n_dev=self.train_step.n_err_groups, comm=self.comm)
        self.params, self.state = self.train_step.load(params, state)
        log(f"Restored solver state from {path} (iter {self.iteration()})",
            rank=self.rank)

    def auto_resume(self) -> Optional[str]:
        """Restore the newest ``<prefix>_iter_N.solverstate.npz`` under the
        solver's snapshot prefix; None (a fresh start) when there is none."""
        if not self.sp.snapshot_prefix:
            return None
        prefix = os.path.join(self.output_dir, self.sp.snapshot_prefix)
        removed = sweep_stale_tmp(prefix)
        if removed:
            log(f"auto-resume: swept {len(removed)} stale snapshot tmp "
                f"file(s): {', '.join(os.path.basename(r) for r in removed)}",
                rank=self.rank)
        path = latest_snapshot(prefix)
        if path is None:
            log(f"auto-resume: no snapshot under {prefix!r}; starting fresh",
                rank=self.rank)
            return None
        self.restore_from(path)
        return path

    def snapshot_now(self) -> Optional[str]:
        if not self.sp.snapshot_prefix:
            return None
        prefix = os.path.join(self.output_dir, self.sp.snapshot_prefix)
        # canonical trees with every group's rows (a collective), as JAX's
        # gather
        params, state = self.train_step.export(self.params, self.state)
        if self._snap_writer is not None:
            model, statef = self._snap_writer.submit(
                prefix, self.train_net, params, state)
            log(f"Snapshotting (async) to {model} / {statef}",
                rank=self.rank)
            return statef
        model, statef = snapshot(prefix, self.train_net, params, state)
        log(f"Snapshotting to {model} / {statef}", rank=self.rank)
        return statef

    # ---------------------------------------------------------------- #
    def test(self, test_id: int = 0) -> Dict[str, float]:
        """Average metrics over test_iter batches (Solver::Test). A test
        net with HDF5_OUTPUT layers runs one forward a batch for both its
        metrics (its scalar outputs, as JAX's engine takes them) and its
        dumped bottoms; each layer's file gets every batch's bottoms,
        gathered over the ranks, concatenated (rank 0 writes)."""
        ev = self.eval_steps[test_id]
        net = self.test_nets[test_id]
        iters = (self.sp.test_iter[test_id]
                 if test_id < len(self.sp.test_iter) else 50)
        specs = [(l.lp.hdf5_output_param.file_name, list(l.lp.bottom))
                 for l in net.layers if l.TYPE == "HDF5_OUTPUT"]
        acc: Dict[str, float] = {}
        h5_acc: Dict[tuple, list] = {}
        params = self.train_step.canonical_params(self.params)
        for _ in range(iters):
            batch = self._next_batch(self.test_pipelines[test_id])
            if specs:
                with torch.no_grad():
                    blobs = net.apply(params, batch, train=False,
                                      keep_blobs=True).blobs
                m = {k: v for k, v in blobs.items()
                     if k in net.output_names and v.dim() == 0}
                for fname, bottoms in specs:
                    for b in bottoms:
                        arr = blobs[b]
                        if self.group.distributed and arr.dim() > 0:
                            arr = self.group.all_gather(arr)
                        h5_acc.setdefault((fname, b), []).append(
                            arr.detach().cpu().numpy())
            else:
                m = ev(params, batch)
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v)
        if specs and self.rank == 0:
            self._write_h5_outputs(h5_acc)
        out = {k: v / iters for k, v in sorted(acc.items())}
        msg = ", ".join(f"{k} = {v:.4f}" for k, v in out.items())
        log(f"    Test net #{test_id}: {msg}", rank=self.rank)
        self.test_metrics[test_id].accumulate(out)
        return out

    def _test_all(self, it: int) -> None:
        for i in range(len(self.test_nets)):
            self.test(i)
            self.test_metrics[i].flush_row(it)

    def _check_divergence(self, fetcher: AsyncScalarFetcher) -> None:
        """Abort on the first non-finite watched metric the drain has seen,
        naming the step that produced it."""
        if fetcher.divergence is not None:
            it, key, value = fetcher.divergence
            raise TrainingDivergedError(it, key, value)

    def _absorb(self, rows, last: Dict[str, float]) -> Dict[str, float]:
        """Feed drained (iter, row) pairs into the metrics window."""
        for _, row in rows:
            self.metrics.accumulate(row)
            last = row
        return last

    def _hard_sync(self, fetcher: AsyncScalarFetcher, boundary: str,
                   last: Dict[str, float]) -> Dict[str, float]:
        """Wait for every dispatched step's metrics, then abort if one
        diverged."""
        with span_recorder.span("hard_sync", "sync", {"boundary": boundary}):
            last = self._absorb(fetcher.sync(), last)
        self._check_divergence(fetcher)
        return last

    def train(self, max_iter: Optional[int] = None) -> Dict[str, float]:
        sp = self.sp
        max_iter = max_iter or sp.max_iter
        it = self.iteration()
        last: Dict[str, float] = {}
        if self.device_prefetch > 0 and self._device_feed is None:
            self._device_feed = DevicePrefetcher(
                self.train_pipelines, self.device, depth=self.device_prefetch)
        if self._async_cfg is not None and self._async_tier is None:
            from .async_tier import AsyncSSPTier, FabricTier, SliceMember
            # every worker starts from the service's anchor, written into
            # the arena in place; the data follows the member list. Under
            # --slice the leader speaks for the slice and the other
            # members follow its gathers and broadcasts
            cfg = dict(self._async_cfg)
            tier_cls = AsyncSSPTier
            if cfg.pop("slice", False):
                tier_cls = (FabricTier if self._slice.is_leader
                            else SliceMember)
                cfg["slice_assignment"] = self._slice
            self._async_tier = tier_cls(self.train_step, **cfg)
            self.params = self.train_step.params()
            self.reshard_data(self._async_tier.data_shard())
        if sp.test_interval and sp.test_initialization and self.test_nets:
            self._test_all(it)
        # the dispatch window: metrics drain to host floats on the
        # fetcher's thread; put() blocks only when max_in_flight dispatches
        # are unread
        fetcher = AsyncScalarFetcher(self.max_in_flight)
        t_start = time.perf_counter()
        # the profile window: skip a couple of warm-up steps (JAX's); the
        # session opens a step earlier for its own warm-up step
        profile_start = it + 2 if self.profile_steps else None
        prof = None
        try:
            while it < max_iter:
                if sp.snapshot and it > 0 and it % sp.snapshot == 0:
                    # every step in flight is checked BEFORE the params are
                    # persisted: a NaN is never snapshotted
                    last = self._hard_sync(fetcher, "snapshot", last)
                    with span_recorder.span("snapshot", "ckpt",
                                            {"iter": it}):
                        self.snapshot_now()
                if profile_start is not None and it == profile_start - 1:
                    prof = self._start_profile()
                chunk = self._chunk(it, max_iter, profile_start)
                span = {"iter": it, "chunk": chunk} if chunk > 1 \
                    else {"iter": it}
                t_in = time.perf_counter()
                with span_recorder.span("prefetch_wait", "input", span):
                    batch = (self._next_train_batch() if chunk == 1 else
                             self._next_batch_stack(
                                 chunk * self.iter_size,
                                 (chunk, self.iter_size)
                                 if self.iter_size > 1 else None))
                t0 = time.perf_counter()
                with span_recorder.span("dispatch", "step", span):
                    run = (self.train_step.step if chunk == 1
                           else self.train_step.multi_step)
                    self.params, self.state, m = run(self.params,
                                                     self.state, batch)
                with span_recorder.span("dispatch_window", "step",
                                        {"iter": it}):
                    fetcher.put(it, m)
                if self._h5_train:
                    self._write_train_h5(self.train_step.dumped)
                it += chunk
                if prof is not None:
                    # the step's device work ends inside its own window
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    prof.step()
                    if it == profile_start:
                        # the traced steps' launches count from here
                        self._profile_launches = _build.launch_counts()
                    elif it >= profile_start + self.profile_steps:
                        self._stop_profile(prof)
                        prof = None
                self.stats.add_time("input_stall", t0 - t_in)
                self.stats.add_time("train_step", time.perf_counter() - t0)
                self.stats.add("train_iters", chunk)
                self._check_divergence(fetcher)
                tier = self._async_tier
                if tier is not None:
                    if tier.due(chunk):
                        # a clock moves the whole arena through the host:
                        # the window drains first, so no NaN is pushed
                        last = self._hard_sync(fetcher, "async_clock", last)
                    tier.after_iters(self, chunk)
                last = self._absorb(fetcher.take_drained(), last)
                if sp.display and it % sp.display == 0:
                    last = self._hard_sync(fetcher, "display", last)
                    flushed = self.metrics.flush_row(it)
                    lr = learning_rate(sp, it - 1)
                    extras = ", ".join(f"{k} = {v:.4f}"
                                       for k, v in flushed.items()
                                       if k not in ("iter", "time"))
                    log(f"Iteration {it}, lr = {lr:.6g}, {extras}",
                        rank=self.rank)
                    # the live telemetry rides the display cadence
                    self.stats.set_gauge("iteration", it)
                    self.stats.set_gauge("lr", lr)
                    for k, v in flushed.items():
                        if k not in ("iter", "time"):
                            self.stats.set_gauge(f"train_{k}",
                                                    round(v, 6))
                    self._dump_stats()
                    if tier is not None:
                        from .comm_stats import format_comm, format_membership
                        log("    [membership] " + format_membership(
                            tier.membership_counters()), rank=self.rank)
                        cc = tier.comm_counters()
                        if cc:
                            log("    [comm] " + format_comm(cc),
                                rank=self.rank)
                    self._dump_trace()
                if sp.test_interval and it % sp.test_interval == 0 and \
                        self.test_nets:
                    last = self._hard_sync(fetcher, "test", last)
                    self._test_all(it)
            last = self._hard_sync(fetcher, "final", last)
        finally:
            self.stats.counters["steps_in_flight"] = round(
                fetcher.mean_in_flight(), 3)
            self.stats.add_time("train_total",
                                   time.perf_counter() - t_start)
            fetcher.close()
            if prof is not None:
                self._stop_profile(prof)
        if self._async_tier is not None:
            # the last clock flushed and (rank 0) the final anchor in the
            # arena BEFORE the after-train snapshot
            for k, v in self._async_tier.finish(self).items():
                self.stats.add(k, v)
            self._async_tier = None
        if sp.snapshot_after_train:
            with span_recorder.span("snapshot", "ckpt",
                                    {"boundary": "after_train"}):
                self.snapshot_now()
        if self._snap_writer is not None:
            # train() returning means the snapshots exist
            self._snap_writer.wait()
        self._write_artifacts()
        self._dump_trace()
        return last

    def _write_train_h5(self, dumps: Dict[str, torch.Tensor]) -> None:
        """Rewrite each TRAIN-net HDF5_OUTPUT file with the latest batch
        (hdf5_output_layer.cpp overwrites its datasets every Forward): the
        bottoms gathered over the ranks, written by rank 0."""
        import h5py
        host = {}
        for k, v in dumps.items():
            if self.group.distributed and v.dim() > 0:
                v = self.group.all_gather(v)
            host[k] = v.detach().cpu().numpy()
        if self.rank != 0:
            return
        for fname, bottoms in self._h5_train:
            path = os.path.join(self.output_dir, fname)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with h5py.File(path, "w") as f:
                for b in bottoms:
                    f.create_dataset(b.replace("/", "_"), data=host[b])

    def _write_h5_outputs(self, h5_acc: Dict[tuple, list]) -> None:
        """Each TEST-net HDF5_OUTPUT file: its bottoms over the test pass,
        one dataset a bottom ('/' as '_')."""
        import h5py
        by_file: Dict[str, Dict[str, np.ndarray]] = {}
        for (fname, blob), chunks in h5_acc.items():
            by_file.setdefault(fname, {})[blob.replace("/", "_")] = \
                np.concatenate(chunks)
        for fname, datasets in by_file.items():
            path = os.path.join(self.output_dir, fname)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with h5py.File(path, "w") as f:
                for name, arr in datasets.items():
                    f.create_dataset(name, data=arr)
            log(f"HDF5 output -> {path}", rank=self.rank)

    def _dump_trace(self) -> None:
        """The span timeline to ``trace_out`` (display boundaries and the
        end); a failed write warns once and training goes on."""
        if self._trace_out is None:
            return
        try:
            span_recorder.dump(self._trace_out)
        except OSError as e:
            if not self._trace_warned:
                self._trace_warned = True
                log(f"WARNING: span timeline write failed ({e}); training "
                    f"continues", rank=self.rank)

    def _dump_stats(self) -> None:
        """stats.yaml (rank 0; atomic) at a display boundary: a failed
        write warns once and training goes on."""
        if self.rank != 0:
            return
        try:
            self.stats.dump_yaml(os.path.join(self.output_dir,
                                                 "stats.yaml"))
        except OSError as e:
            if not self._telemetry_warned:
                self._telemetry_warned = True
                log(f"WARNING: stats.yaml write failed ({e}); training "
                    f"continues, will retry at the next boundary",
                    rank=self.rank)

    def _write_artifacts(self) -> None:
        if self.rank != 0:
            return
        # the static per-layer comm accounting, its summary against the
        # measured step
        table = layer_comm_table(self.train_net, self.comm, self.group)
        iters = self.stats.counters.get("train_iters", 0)
        step_ms = (self.stats.timers.get("train_step", 0.0) / iters * 1e3
                   if iters else None)
        self.stats.set_section("comm", {
            "summary": comm_summary(table, step_ms), "per_layer": table})
        self.stats.dump_yaml(os.path.join(self.output_dir, "stats.yaml"))
        name = self.train_net.name or "net"
        self.metrics.to_csv(os.path.join(self.output_dir,
                                         f"{name}_train_outputs.csv"))
        for i, tm in enumerate(self.test_metrics):
            if tm.rows:
                tm.to_csv(os.path.join(self.output_dir,
                                       f"{name}_test{i}_outputs.csv"))

    def close(self) -> None:
        """Join the snapshot write in flight, stop and join the prefetcher
        and every pipeline thread, write the span timeline and destroy the
        process group this engine started (idempotent). A failed snapshot
        write re-raises after everything is closed."""
        err: Optional[BaseException] = None
        if self._snap_writer is not None:
            try:
                self._snap_writer.close()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = e
        if self._async_tier is not None:
            # an aborted run: finish() was not reached
            self._async_tier.close()
            self._async_tier = None
        if self._device_feed is not None:
            # before the pipelines: its thread consumes them
            self._device_feed.close()
            self._device_feed = None
        for pipe in self.train_pipelines:
            pipe.close()
        for pipes in self.test_pipelines:
            for pipe in pipes:
                pipe.close()
        self.train_pipelines = []
        self.test_pipelines = []
        if self._owns_span_recorder:
            self._dump_trace()
            span_recorder.disable()
            self._owns_span_recorder = False
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        self.group.close()
        if err is not None:
            raise err
