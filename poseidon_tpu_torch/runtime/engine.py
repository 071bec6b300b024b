"""Engine: solver-driven training on one GPU or data-parallel over ranks
(the synchronous subset of ``poseidon_tpu/runtime/engine.py``, Caffe's
``Solver::Solve``).

- resolve the train and test nets from a SolverParameter (file or inline,
  the shared-net pattern filtered by phase);
- a data pipeline per data layer, prefetching on a daemon thread;
- the loop: one ``TrainStep.step`` per iteration, with display, test,
  snapshot cadence and the divergence abort from the solver prototxt;
- metrics rows written as the JAX engine's CSVs.

The prototxt batch_size is the batch of one rank's device (the JAX engine
multiplies it by its local device count; here the multiplier is 1): the
global batch is batch_size x world. Rank and world come from the launcher
env contract (``runtime/cluster.py``): each rank reads its own
``Shard(rank, world)`` of the records, the step all-reduces as its
``CommConfig`` says (``parallel/strategies.py``), parameters and momentum
are broadcast from rank 0 after init and restore, metrics are averaged over
the ranks, only rank 0 logs and writes the CSVs, and every rank writes the
(identical) snapshots, as in the JAX engine. Parameters are filled from
``sp.random_seed`` (1 when unset) with a CPU ``torch.Generator``; the
dropout generator is seeded from it with the rank folded in
(``parallel/mesh.rank_seed``), so a seed gives the same run on any device;
the random streams are torch's, not JAX's. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional

import torch

from ..core.net import Net
from ..data.pipeline import BatchPipeline, build_phase_pipelines
from ..data.workload import Shard
from ..numeric import resolve_device
from ..parallel.mesh import DataGroup, rank_seed
from ..parallel.strategies import CommConfig, auto_strategies
from ..parallel.trainer import (build_eval_step, build_train_step,
                                init_train_state)
from ..proto.messages import NetParameter, SolverParameter, load_net
from ..solvers.updates import learning_rate
from .checkpoint import latest_snapshot, load_caffemodel, restore, snapshot
from .cluster import init_distributed
from .metrics import MetricsTable, log


class TrainingDivergedError(RuntimeError):
    """Raised when the training loss goes non-finite."""

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


class Engine:
    def __init__(self, sp: SolverParameter, output_dir: str = ".",
                 device=None, comm: Optional[CommConfig] = None,
                 sfb_auto: bool = False):
        self.sp = sp
        self.output_dir = output_dir
        self.comm = comm or CommConfig()
        self.sfb_auto = sfb_auto
        self.train_pipelines: List[BatchPipeline] = []
        self.test_pipelines: List[List[BatchPipeline]] = []
        self.group: DataGroup = init_distributed(resolve_device(device))
        self.device = self.group.device
        self.rank, self.world = self.group.rank, self.group.world
        # seconds spent waiting for the data pipeline / in the step, and
        # the steps taken, over this engine's train() calls
        self.stats = {"input_stall_s": 0.0, "train_step_s": 0.0,
                      "train_iters": 0}
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
            train_param, "TRAIN", shard=shard)
        self.train_net = Net(train_param, "TRAIN", device=self.device,
                             source_shapes=train_shapes)
        self.test_nets: List[Net] = []
        for tp in test_params:
            pipes, shapes = build_phase_pipelines(tp, "TEST", shard=shard)
            self.test_pipelines.append(pipes)
            self.test_nets.append(Net(tp, "TEST", device=self.device,
                                      source_shapes=shapes))
        if self.sfb_auto:
            # the cost model's picks land before the step is built
            self.comm.layer_strategies.update(
                auto_strategies(self.train_net))
        group = self.group if self.group.distributed else None
        self.train_step = build_train_step(self.train_net, sp, group,
                                           self.comm)
        self.eval_steps = [build_eval_step(n, group) for n in self.test_nets]
        if group is not None:
            sync = self.train_step.sync
            batch = next(iter(train_shapes.values()))[0]
            log(f"data parallel: {self.world} ranks x batch {batch}, sync "
                f"{self.train_step.kinds}, reduce {self.comm.reduce}, wire "
                f"{self.comm.wire_dtype or 'f32'}, {len(sync.hooked)} DWBP "
                f"bucket(s) of {self.comm.bucket_mb:g} MB, "
                f"{len(sync.fused)} after backward", rank=self.rank)
        seed = sp.random_seed if sp.random_seed >= 0 else 1
        self.train_net.generator.manual_seed(rank_seed(seed, self.rank))
        params = self.train_net.init(torch.Generator().manual_seed(seed))
        self.params, self.state = self.train_step.load(
            params, init_train_state(params))
        self.metrics = MetricsTable("train")
        self.test_metrics = [MetricsTable(f"test_{i}")
                             for i in range(len(self.test_nets))]

    # ---------------------------------------------------------------- #
    def _next_batch(self, pipes: List[BatchPipeline]
                    ) -> Dict[str, torch.Tensor]:
        batch: Dict[str, torch.Tensor] = {}
        for pipe in pipes:
            for k, v in next(pipe).items():
                batch[k] = torch.from_numpy(v).to(self.device)
        return batch

    def iteration(self) -> int:
        return int(self.state.solver.it)

    def restore_from(self, path: str) -> None:
        """Weights from a .caffemodel, or params + solver state from a
        .solverstate.npz (either package's)."""
        if path.endswith(".caffemodel"):
            params = load_caffemodel(path, self.train_net, self.params)
            self.params, self.state = self.train_step.load(params, self.state)
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
        model, statef = snapshot(prefix, self.train_net, self.params,
                                 self.state)
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

    def train(self, max_iter: Optional[int] = None) -> Dict[str, float]:
        sp = self.sp
        max_iter = max_iter or sp.max_iter
        it = self.iteration()
        last: Dict[str, float] = {}
        if sp.test_interval and sp.test_initialization and self.test_nets:
            self._test_all(it)
        while it < max_iter:
            if sp.snapshot and it > 0 and it % sp.snapshot == 0:
                self.snapshot_now()
            t_in = time.perf_counter()
            batch = self._next_batch(self.train_pipelines)
            t0 = time.perf_counter()
            self.params, self.state, m = self.train_step.step(
                self.params, self.state, batch)
            row = {k: float(v) for k, v in m.items()}  # waits for the step
            self.stats["input_stall_s"] += t0 - t_in
            self.stats["train_step_s"] += time.perf_counter() - t0
            self.stats["train_iters"] += 1
            it += 1
            if not math.isfinite(row["loss"]):
                raise TrainingDivergedError(it - 1, "loss", row["loss"])
            self.metrics.accumulate(row)
            last = row
            if sp.display and it % sp.display == 0:
                flushed = self.metrics.flush_row(it)
                lr = learning_rate(sp, it - 1)
                extras = ", ".join(f"{k} = {v:.4f}"
                                   for k, v in flushed.items()
                                   if k not in ("iter", "time"))
                log(f"Iteration {it}, lr = {lr:.6g}, {extras}",
                    rank=self.rank)
            if sp.test_interval and it % sp.test_interval == 0 and \
                    self.test_nets:
                self._test_all(it)
        if sp.snapshot_after_train:
            self.snapshot_now()
        self._write_artifacts()
        return last

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
        """Stop and join every pipeline thread and destroy the process
        group this engine started (idempotent)."""
        for pipe in self.train_pipelines:
            pipe.close()
        for pipes in self.test_pipelines:
            for pipe in pipes:
                pipe.close()
        self.train_pipelines = []
        self.test_pipelines = []
        self.group.close()
