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
  ``trace_out``; metrics rows written as the JAX engine's CSVs.

``device_prefetch``, ``max_in_flight`` and ``async_snapshot`` left at
``None`` take ``config.PipelineConfig``'s defaults. The pipeline moves
only where the host blocks: the steps and their batches are the serial
loop's (``device_prefetch=0, max_in_flight=1``), bit for bit.

The prototxt batch_size is the batch of one rank's device (the JAX engine
multiplies it by its local device count; here the multiplier is 1): the
global batch is batch_size x world. Rank and world come from the launcher
env contract (``runtime/cluster.py``): each rank reads its own
``Shard(rank, world)`` of the records, the step all-reduces as its
``CommConfig`` says (``parallel/strategies.py``), parameters and momentum
are broadcast from rank 0 after init and restore, metrics are averaged over
the ranks, only rank 0 logs (the static comm table once) and writes the
CSVs, and every rank writes the (identical) snapshots, as in the JAX
engine, with every residual group's TOPK residual gathered into them.
``dcn_slices`` > 1 splits the world into that many slices (the two-tier
group, ``parallel/mesh.py``) and sets ``CommConfig.dcn_axis``.
Parameters are filled from ``sp.random_seed`` (1 when unset) with a CPU
``torch.Generator``; the
dropout generator is seeded from it with the rank folded in
(``parallel/mesh.rank_seed``), so a seed gives the same run on any device;
the random streams are torch's, not JAX's. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..core.net import Net
from ..data.pipeline import (BatchPipeline, DevicePrefetcher,
                             build_phase_pipelines, place_batch)
from ..data.workload import Shard
from ..numeric import policy, resolve_device
from ..parallel.mesh import DCN_AXIS, DataGroup, rank_seed
from ..parallel.strategies import TOPK, CommConfig, auto_strategies
from ..parallel.trainer import (build_eval_step, build_train_step,
                                init_train_state)
from ..proto.messages import NetParameter, SolverParameter, load_net
from ..solvers.updates import learning_rate
from .checkpoint import (AsyncSnapshotWriter, latest_snapshot,
                         load_caffemodel, restore, snapshot)
from .cluster import init_distributed
from .comm_stats import comm_summary, layer_comm_table
from .metrics import AsyncScalarFetcher, MetricsTable, log
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


class Engine:
    def __init__(self, sp: SolverParameter, output_dir: str = ".",
                 device=None, comm: Optional[CommConfig] = None,
                 sfb_auto: bool = False,
                 device_prefetch: Optional[int] = None,
                 max_in_flight: Optional[int] = None,
                 async_snapshot: Optional[bool] = None,
                 device_transform: bool = False, use_native: bool = True,
                 memory_data: Optional[Dict[str, np.ndarray]] = None,
                 trace_out: Optional[str] = None, dcn_slices: int = 0):
        self.sp = sp
        self.output_dir = output_dir
        self.comm = comm or CommConfig()
        if dcn_slices > 1 and self.comm.dcn_axis is None:
            self.comm.dcn_axis = DCN_AXIS
        self.sfb_auto = sfb_auto
        pc = PipelineConfig()
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
        self.group: DataGroup = init_distributed(
            resolve_device(device), slices=max(1, dcn_slices))
        self.device = self.group.device
        self.rank, self.world = self.group.rank, self.group.world
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
        # seconds spent waiting for the data pipeline / dispatching steps
        # (the host's time up to the window's backpressure), the steps
        # taken, over this engine's train() calls; steps_in_flight is the
        # last train()'s mean window occupancy at dispatch
        self.stats = {"input_stall_s": 0.0, "train_step_s": 0.0,
                      "train_iters": 0, "steps_in_flight": 0.0}
        try:
            self._build()
        except BaseException:
            self.close()
            raise

    def _build(self) -> None:
        sp = self.sp
        train_param, test_params = resolve_nets(sp)
        shard = Shard(self.rank, self.world)
        self.train_pipelines, train_shapes = build_phase_pipelines(
            train_param, "TRAIN", shard=shard, memory_data=self.memory_data,
            device_transform=self.device_transform,
            use_native=self.use_native)
        self.train_net = Net(train_param, "TRAIN", device=self.device,
                             source_shapes=train_shapes)
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
        if self.sfb_auto:
            # the cost model's picks land before the step is built
            self.comm.layer_strategies.update(
                auto_strategies(self.train_net))
        group = self.group if self.group.distributed else None
        self.train_step = build_train_step(self.train_net, sp, group,
                                           self.comm, self._input_transform)
        self.eval_steps = [build_eval_step(n, group) for n in self.test_nets]
        step = self.train_step
        if group is not None:
            batch = next(iter(train_shapes.values()))[0]
            log(f"data parallel: {self.world} ranks x batch {batch}, sync "
                f"{step.kinds}, reduce {self.comm.reduce}, wire "
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
        if group is not None or step.topk_slots:
            self._log_comm_table()
        seed = sp.random_seed if sp.random_seed >= 0 else 1
        self.train_net.generator.manual_seed(rank_seed(seed, self.rank))
        params = self.train_net.init(torch.Generator().manual_seed(seed))
        self.params, self.state = step.load(params, init_train_state(
            params, self.comm, step.n_err_groups))
        self.metrics = MetricsTable("train")
        self.test_metrics = [MetricsTable(f"test_{i}")
                             for i in range(len(self.test_nets))]

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

    def iteration(self) -> int:
        return int(self.state.solver.it)

    def restore_from(self, path: str) -> None:
        """Weights from a .caffemodel, or params + solver state from a
        .solverstate.npz (either package's)."""
        if path.endswith(".caffemodel"):
            params = load_caffemodel(path, self.train_net, self.params)
            self.params = self.train_step.load_weights(params)
            log(f"Loaded weights from {path}", rank=self.rank)
            return
        params, state = restore(path)
        self.params, self.state = self.train_step.load(params, state)
        log(f"Restored solver state from {path} (iter {self.iteration()})",
            rank=self.rank)

    def auto_resume(self) -> Optional[str]:
        """Restore the newest ``<prefix>_iter_N.solverstate.npz`` under the
        solver's snapshot prefix; None (a fresh start) when there is none."""
        if not self.sp.snapshot_prefix:
            return None
        prefix = os.path.join(self.output_dir, self.sp.snapshot_prefix)
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
        # every residual group's row (a collective), as JAX's gather
        state = self.state._replace(comm_error=self.train_step
                                    .gather_comm_error(self.state.comm_error))
        if self._snap_writer is not None:
            model, statef = self._snap_writer.submit(
                prefix, self.train_net, self.params, state)
            log(f"Snapshotting (async) to {model} / {statef}",
                rank=self.rank)
            return statef
        model, statef = snapshot(prefix, self.train_net, self.params, state)
        log(f"Snapshotting to {model} / {statef}", rank=self.rank)
        return statef

    # ---------------------------------------------------------------- #
    def test(self, test_id: int = 0) -> Dict[str, float]:
        """Average metrics over test_iter batches (Solver::Test)."""
        ev = self.eval_steps[test_id]
        iters = (self.sp.test_iter[test_id]
                 if test_id < len(self.sp.test_iter) else 50)
        acc: Dict[str, float] = {}
        for _ in range(iters):
            batch = self._next_batch(self.test_pipelines[test_id])
            for k, v in ev(self.params, batch).items():
                acc[k] = acc.get(k, 0.0) + float(v)
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
        if sp.test_interval and sp.test_initialization and self.test_nets:
            self._test_all(it)
        # the dispatch window: metrics drain to host floats on the
        # fetcher's thread; put() blocks only when max_in_flight dispatches
        # are unread
        fetcher = AsyncScalarFetcher(self.max_in_flight)
        try:
            while it < max_iter:
                if sp.snapshot and it > 0 and it % sp.snapshot == 0:
                    # every step in flight is checked BEFORE the params are
                    # persisted: a NaN is never snapshotted
                    last = self._hard_sync(fetcher, "snapshot", last)
                    with span_recorder.span("snapshot", "ckpt",
                                            {"iter": it}):
                        self.snapshot_now()
                t_in = time.perf_counter()
                with span_recorder.span("prefetch_wait", "input",
                                        {"iter": it}):
                    batch = (next(self._device_feed)
                             if self._device_feed is not None
                             else self._next_batch(self.train_pipelines))
                t0 = time.perf_counter()
                with span_recorder.span("dispatch", "step", {"iter": it}):
                    self.params, self.state, m = self.train_step.step(
                        self.params, self.state, batch)
                with span_recorder.span("dispatch_window", "step",
                                        {"iter": it}):
                    fetcher.put(it, m)
                it += 1
                self.stats["input_stall_s"] += t0 - t_in
                self.stats["train_step_s"] += time.perf_counter() - t0
                self.stats["train_iters"] += 1
                self._check_divergence(fetcher)
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
                    self._dump_trace()
                if sp.test_interval and it % sp.test_interval == 0 and \
                        self.test_nets:
                    last = self._hard_sync(fetcher, "test", last)
                    self._test_all(it)
            last = self._hard_sync(fetcher, "final", last)
        finally:
            self.stats["steps_in_flight"] = round(fetcher.mean_in_flight(),
                                                  3)
            fetcher.close()
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

    def _write_artifacts(self) -> None:
        if self.rank != 0:
            return
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
        self.group.close()
        if err is not None:
            raise err
