"""Smoke test of the PyTorch port on one NVIDIA GPU (H100):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final ``ok`` line:

1. Card and toolchain: ``nvidia-smi`` name and power limit, torch/CUDA
   versions. Builds every CUDA kernel of ``poseidon_tpu_torch/ops/csrc``
   (one nvcc per source, all started together) and prints the build time.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the AlexNet paths give them, with CUDA-event times for the kernel, the
   plain version and a one-call library yardstick the port never calls,
   beside the least time the card could take (bytes at its memory rate or
   operations at the peak rate of the operands' type, f32 67 or bf16 989
   TFLOP/s, the larger):
   - lrn_fwd (K4): norm1/norm2 at serving bucket 64 (f32, bf16) and at
     training batch 256 (f32), an odd even-window case, and the window's
     and the tile's edges (n=1, n=32, C=2 below the halo, one h*w
     position, batch 1 with C=131 off the 64-channel chunks); each case
     must be bitwise equal to the plain version, and the registers, shared
     memory, spills and resident blocks per SM of its tiles are printed
     once;
   - lrn_bwd (K5): norm1/norm2 at batch 256 in f32 and bf16, n=4 with C=37,
     and the window's edges (n=1, n=32, C=2 below the halo, one h*w
     position, batch 1 with C=131 off the 64-channel chunks); each case
     prints whether it is bitwise equal to the plain version;
   - pool_bwd (K6): pool1/pool2/pool5 MAX at batch 256 in f32, pool1 and
     pool5 in bf16, a constant input (ties: first max wins), AVE with pad
     1 and a ceil-mode clamp, a plane of several bands (1,2,600,600),
     GoogLeNet's 3x3 s1 p1 MAX, 5x5 s3 AVE and 7x7 s1 AVE, rows and a
     plane of -inf (flat index 0), a stride larger than the window, a
     global MAX pool of 13x13 planes (one window of 169 taps); the
     library yardstick is torch's max or avg pooling backward where its
     ceil mode gives Caffe's shape. Each case must be bitwise equal to the
     plain version (and a second launch to the first); small cases also
     print the profiler's device time, since the host paces their launches;
     the registers, shared memory, spills and resident blocks per SM at
     each case's band plan are printed once;
   - sgd_update (K7): the AlexNet arena (60,965,224) and a ragged P+7;
   - flash_fwd (K1): out and lse at the gpt_small prefill shapes
     (1,12,16|64|256,64) f32 causal, its training shape (8,12,1024,64) f32
     causal, the byte-level LM's training and decode-prefill shapes
     (8,4,256,32) and (1,4,32,32), (8,12,512,64) causal and not in f32
     and bf16, the ring-chunk modes +1/0/-1 at (2,4,128,64), an odd
     (1,3,48,16); the library yardstick is F.scaled_dot_product_attention.
     f32 cases also print the bound at the 3xTF32 rate (3 x operations over
     TF32's 495 TFLOP/s); each case relaunches the kernel on the same
     inputs, which must give bitwise-equal out and lse; the registers,
     shared memory, spills and resident blocks per SM of the
     instantiations for each dtype and head dim the cases use (both key
     splits) are printed once.
   - flash_dq (K2) and flash_dkv (K3): dq, dk and dv against the plain
     backward at the gpt_small training shape (8,12,1024,64) f32 causal
     (the main case), the byte-level LM's (8,4,256,32), (8,12,512,64)
     causal and not in f32 and bf16, the
     ring-chunk modes +1/0/-1 at (2,4,128,64) with delta passed in, an odd
     (1,3,48,16); the library yardstick is the backward of
     F.scaled_dot_product_attention (forward + backward less the forward),
     timed against K2+K3 together. Each case also prints the bound at the
     3xTF32 rate (3 x operations over TF32's 495 TFLOP/s) and relaunches
     both kernels on the same inputs, which must give bitwise-equal dq, dk
     and dv; the registers, shared memory, spills and resident blocks per
     SM of each kernel's f32 and bf16 instantiation at D = 64 are printed
     once.
   - ``[layout]``: K4-, K5- and K6-NHWC on channels-last tensors at
     AlexNet's norm and pool shapes, batch 256, f32 and bf16, each bitwise
     equal to its plain version (the run fails otherwise; K6-NHWC also on
     a second launch), with the library call on the same tensors; the
     registers, shared memory, spills and resident blocks per SM of K4-
     (at 4 and 8 bf16 channels a lane), K5- and K6-NHWC; K4-NHWC's bf16
     pair at 8 and at 4 channels a lane, in turns, each bitwise; the powf
     floors (the pair's powf alone: one an element beside K4-NHWC's pair,
     two beside K5-NHWC's); each kernel's time over its library call's in
     this run; conv1 in bf16 NHWC with and without the space-to-depth
     rewrite.
3. The CNN serving slice: ``BucketedExecutor.from_files`` on AlexNet (3x227x227,
   buckets 1/4/16/64, seeded filler weights) behind the port's
   ``InferenceServer`` on 127.0.0.1 port 0, driven by the port's
   ``ServingClient``. Launch counters are zeroed just before and read just
   after: every forward must have launched the LRN kernel twice (and no
   other kernel). Replies are held against a direct ``Net`` forward on the
   card; one bucket-16
   forward is held against the same forward with the plain LRN on the card
   and against the CPU. Bucket-64 load runs LOAD_REQUESTS requests at one
   client and again at two; p50/p99 latency and img/s are printed with the
   request count beside them.
4. The training slice: full-width AlexNet (alexnet_train_val.prototxt and
   alexnet_solver.prototxt: batch 256, crop 227, mirror, mean file) trained
   by ``Engine.train()`` for TRAIN_ITERS steps from a synthetic
   ILSVRC-shaped LMDB written into a temporary directory (only the sources,
   the mean file and the cadence are overridden). Launch counters are
   zeroed just before and read just after: exactly 2 lrn_fwd per forward,
   2 lrn_bwd, 3 pool_bwd and 1 sgd_update per step, no flash_fwd. Every
   loss must be finite; the snapshot must restore bitwise. One step is held against the
   same step with the plain versions swapped in on the card. Then the
   device step time (CUDA events over a fixed on-device batch), the loop's
   img/s and data-wait share, the top kernels of one profiled step (in
   which every port kernel must show device time, and whose kernels may
   not sum past PROFILE_BUSY_MARGIN times the step by CUDA events) and
   the peak device memory. ``Engine.train()`` runs under its defaults: the
   native batcher, the CUDA-stream prefetcher and the in-flight window.
   Then ``[loop]`` (``phase_loop``) on the same data, with the host's
   ``os.cpu_count()`` and the card's name and power limit: (a) the
   batchers alone in img/s (native f32 with crop 227, mirror and the mean
   file; native uint8 on a mean-value variant of the layer; the Python
   source and transformer); (b) the serial loop as it was (Python batches,
   inline copies, window 1) for LOOP_SERIAL_STEPS steps and the pipelined
   loop (native, prefetch 2, window 2) for LOOP_STEPS, one Engine build
   each, their img/s and data-wait share from the host spans beside the
   device step, the warm-up steps left out, the pipelined loop's K4-K7
   launches zeroed just before and read just after (2/2/3/1 a step); (c)
   under cuDNN's deterministic algorithms the serial and the pipelined
   loop on native batches end bitwise equal, and the device transform of
   the first uint8 batch is the native f32 batch bitwise; (d) the run
   fails unless the pipelined loop read native batches through the CUDA
   prefetch stage.
5. The data-parallel slice (``phase_dp``), AlexNet train_val at full
   width in f32: a one-rank NCCL group in this process (a file store in a
   temporary directory): the DENSE step (61 DWBP buckets of 4 MB) held
   bitwise against the one-device step for DP_STEPS steps from the same
   params, momentum and batch (cuDNN's deterministic algorithms on, both
   arms), its launch counters zeroed just before and read just after (2
   lrn_fwd, 2 lrn_bwd, 3 pool_bwd, 1 sgd_update a step); SFB on
   ``auto_strategies``' picks (fc6-fc8) against DENSE after one step at
   DP_SFB_TOL; the buckets issued in DWBP order, all but the first layer's
   while backward still ran, with each one's window to the end of backward
   by CUDA events; the device step of the one-device step, DENSE and
   DENSE_FUSED in turns. Then two ``python -m poseidon_tpu_torch train``
   processes on the one card (gloo, since they share it) under the
   launcher env contract at DP_CLI_BATCH a rank, for each of DP_CLI_RUNS:
   both exit 0, their DP_CLI_ITERS snapshots bitwise equal, every loss
   finite, the wall time a step. One ``[dp]`` line sums it up.
6. The managed-communication slice (``phase_topk``), AlexNet train_val at
   full width in f32 on the same data: a one-rank NCCL group at batch 256
   (a) TOPK at fraction 1 on every layer held bitwise against DENSE for
   TOPK_STEPS steps (cuDNN deterministic), the residual zero; (b) TOPK on
   fc6-fc8 at fraction 0.01, global and in blocks of 4096: every leaf,
   every step, sent + residual = g + residual before (bitwise), at most k
   sent, a nonzero residual, and exactly 2 lrn_fwd, 2 lrn_bwd, 3
   pool_bwd and 1 sgd_update a step (counters zeroed just before each
   run, read just after); (c) the device step of DENSE, TOPK-global and
   TOPK-blocked in turns, and ``topk_compress`` alone on fc6's weight
   (37,748,736 entries, k 377,487) beside its bytes' bound and
   ``torch.topk`` alone; (d) four ``train --strategy topk --dcn_slices
   2`` processes on the one card over gloo at 64 a rank: all exit 0,
   snapshots bitwise equal, the residuals one row a slice and the rows
   different; (e) the static comm table of AlexNet at batch 256 for
   DENSE, the SFB auto picks and TOPK on a flat group of 8 and on 2
   slices of 4 devices. One ``[topk]`` line sums it up.
7. The LM serving slice: ``serve --generate``'s executor
   (``build_generate_executor("gpt_small")``: full width and depth, seeded
   weights, page 64, rungs 1/2/4/8, prompt buckets 16/64/256) behind the
   port's ``InferenceServer``, driven by the port's ``ServingClient``: a
   seeded mix of LM_REQUESTS requests from LM_CLIENTS clients (prompts of
   4..250 tokens hitting every bucket, max_new 32, a quarter streamed),
   then LM_SOLO_REQUESTS from one client and one request alone. Launch
   counters are zeroed just before and read just after: flash_fwd exactly
   12 per prefill, no other kernel. Every reply has 32 tokens, every
   streamed chunk list is cumulative, every page is free after the drain.
   The alone-served request is held against the dense ``generate`` on the
   card (tokens equal, logits within LM_TOL); one prefill's logits against
   the CPU. Then time to first token and request latency p50/p99 with
   their counts, generated tokens/s at 8 and 1 clients, CUDA-event prefill
   time per bucket, per decode rung the profiled device busy time, the
   CUDA-event span and the host wall time, and peak device memory.
8. The LM training slice: gpt_small at full width and depth (max_seq 1024,
   remat on, seeded weights) trained by ``build_dp_sp_train_step`` at
   batch 8 x seq 1024 with bench.py's SGD solver on one fixed seeded
   batch. Launch counters are zeroed just before LMT_LOSS_STEPS steps and
   read just after: exactly LMT_LAUNCHES per step, no CNN kernel. Every
   loss finite and the last below the first. One step with the kernels
   against the same step with the plain flash versions swapped in (loss
   and every updated parameter at STEP_TOL, gradients at GRAD_TOL); remat
   against none (loss equal, gradients at GRAD_TOL, peak memory without
   remat); a snapshot restoring bitwise. Then the device step time,
   tokens/s, MFU (6*P*T) and the executed share (8*P*T) over 67 TFLOP/s,
   peak device memory and the top kernels of one profiled step, in which
   every port kernel launched on the step must show device time.
9. ``python -m poseidon_tpu_torch.models.train_lm --generate 48`` at its
   defaults, through its ``main`` in this process: the loss must fall
   below LM_CORPUS_MAX_LOSS by step 200, and the decode must print its
   bytes. Launch counters are zeroed just before and read just after:
   exactly 2 flash_fwd, 2 flash_dq and 2 flash_dkv a step (one a layer,
   remat off), and 2 flash_fwd for the decode's prefill.
10. Real data end to end: ``python -m poseidon_tpu_torch train`` on the
   digits solver (1000 iterations, real UCI digits from the repo) into a
   temporary directory; the final test accuracy must reach DIGITS_MIN_ACC.
11. One JSON line with every kernel's numbers (launches by path, ``dp``,
    ``topk`` and ``loop`` among them), then the ``ok`` line.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# Published H100 SXM rates (NVIDIA data sheet, dense): the least time of a
# kernel is the larger of bytes moved / memory rate and operations / the
# peak rate for its operands' type (f32 outside the tensor cores, bf16 on
# them).
HBM_BYTES_PER_S = 3.35e12
HBM_SOURCE = "H100 SXM data sheet, 3.35 TB/s"
F32_OPS_PER_S = 67e12
OPS_PER_S = {"float32": F32_OPS_PER_S, "bfloat16": 989e12}
# TF32 on the tensor cores: K1-K3 run each f32 product as three TF32
# products (3xTF32), so their least f32 time on the tensor cores is
# 3 x operations over this rate
TF32_OPS_PER_S = 495e12
ALEXNET = "examples/imagenet/alexnet_deploy.prototxt"
ALEXNET_TRAIN = "examples/imagenet/alexnet_train_val.prototxt"
ALEXNET_SOLVER = "examples/imagenet/alexnet_solver.prototxt"
DIGITS_SOLVER = "examples/digits/digits_solver.prototxt"
# the JAX package recorded 0.9417 at 1k iterations (examples/digits/stat.md);
# the band allows for other filler and dropout random streams
DIGITS_MIN_ACC = 0.90
# synthetic ILSVRC-shaped data (examples/make_synthetic_db.py's recipe)
TRAIN_RECORDS, VAL_RECORDS, CLASSES = 512, 100, 1000
TRAIN_ITERS, TEST_INTERVAL, TEST_ITER = 30, 15, 2
TIMED_STEPS = 10
# a profiled step's kernels may sum to at most this times the step's time
# by CUDA events
PROFILE_BUSY_MARGIN = 1.10
BUCKETS = (1, 4, 16, 64)
REQUEST_ROWS = (1, 3, 4, 9, 16, 33, 64)
# bucket-64 requests per concurrency: enough that p99 is not just the max
LOAD_REQUESTS = 300
LRN_ALPHA, LRN_BETA, LRN_K = 1e-4, 0.75, 1.0
# kernel vs plain on the card: f32 differs by powf's last bits; bf16 may
# flip one bf16 rounding step (2^-7 relative) where those bits sit on a tie
KERNEL_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 1e-6)}
# flash_fwd (K1) vs plain: the kernel folds key tiles of tensor-core
# products (f32 as 3xTF32, bf16 with P split into two bf16 parts) summed a
# few MMAs at a time into f32 accumulators, the plain version sums each row
# in one dense f32 pass (the JAX package's own flash-vs-dense test allows
# 2e-4/2e-5); bf16 out may flip one bf16 rounding step. lse is f32 for both
# dtypes and is held at the f32 pair.
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -7, 1e-5)}
# the LM serving slice: gpt_small at full width and depth (vocab 32768,
# d 768, 12 heads, 12 layers, d_ff 3072, max_seq 512), seeded weights
LM_PRESET = "gpt_small"
LM_REQUESTS, LM_CLIENTS, LM_MAX_NEW = 64, 8, 32
LM_SOLO_REQUESTS = 8
LM_PROMPT_MIN, LM_PROMPT_MAX = 4, 250
# logits of one request: paged (served) vs the dense generate on the card,
# and one prefill on the card vs the CPU: f32 everywhere, but cuBLAS picks
# other GEMM splits for other shapes and the CPU sums in another order
LM_TOL = (1e-4, 1e-4)
# flash_dq (K2) and flash_dkv (K3) vs plain: the kernels sum 3xTF32
# tensor-core products tile by tile, the plain version takes each gradient
# in one dense f32 product, so they round differently; bf16 outputs round
# to bf16 from f32 sums of up to S terms
FLASH_BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -7, 1e-3)}
# the LM training slice: gpt_small (vocab 32768, d 768, 12 heads, 12
# layers, d_ff 3072, max_seq 1024, remat on) at the JAX package's own
# training shape (bench.py's lm block): batch 8 x seq 1024, SGD base_lr
# 0.01, fixed, momentum 0.9, seeded tokens and targets, one fixed batch
LMT_PRESET, LMT_BATCH, LMT_SEQ = "gpt_small", 8, 1024
LMT_LOSS_STEPS = 20
LMT_PARAMS = 136_091_136
# per step: 12 flash_fwd in the forward, 12 more when the checkpointed
# blocks recompute their forward in the backward, 12 flash_dq, 12 flash_dkv
LMT_LAUNCHES = {"flash_fwd": 24, "flash_dq": 12, "flash_dkv": 12}
# gradients (kernels vs plain versions; remat vs none): each leaf's max abs
# difference over its max abs value; f32 throughout, but the kernels and the
# plain versions sum attention in other orders, and a recomputed block
# feeds the backward through another graph
GRAD_TOL = 1e-4
# models.train_lm at its defaults: the loss falls from ~5.5-6 (ln 256 and
# the untrained head) and reached 2.36 by step 200 on the CPU; the JAX
# script's docstring says "toward ~2". 3.0 leaves room for the other
# summation orders of the card without passing a run that did not learn.
LM_CORPUS_MAX_LOSS = 3.0
LM_CORPUS_GENERATE = 48
# whole-net comparisons (rtol, atol) on prob and every blob
NET_TOL = (1e-4, 1e-6)
# a training step with the kernels vs the same step with the plain versions
# on the card: the loss and every updated parameter; cuDNN's backward
# algorithms may sum in another order from one call to the next
STEP_TOL = (1e-4, 1e-6)
# the data-parallel phase, AlexNet train_val at full width, f32: a one-rank
# NCCL group at the one-device batch (held bitwise against the one-device
# step for DP_STEPS steps, under cuDNN's deterministic algorithms), then
# two `train` processes on the one card over gloo at DP_CLI_BATCH a rank
DP_BATCH, DP_STEPS = 256, 3
DP_CLI_BATCH, DP_CLI_ITERS, DP_CLI_TIMEOUT_S = 128, 3, 300
DP_CLI_RUNS = (("sfb-auto", ("--strategy", "sfb", "--sfb-auto")),
               ("dense", ()))
# SFB (fc6-fc8) vs DENSE after one step: f32 throughout, but SFB takes each
# FC weight gradient as one product of the gathered factors
DP_SFB_TOL = (1e-4, 1e-6)


# the [topk] phase, AlexNet train_val at full width, f32, on [train]'s
# synthetic LMDB: a one-rank NCCL group at TOPK_BATCH, TOPK_STEPS steps
# a run: TOPK at fraction 1 on every layer against DENSE (bitwise), then
# TOPK on TOPK_LAYERS at the default fraction 0.01, globally and in blocks
# of TOPK_BLOCK (conservation, the count sent, K4-K7 a step); then
# TOPK_CLI_RANKS `train --strategy topk --dcn_slices TOPK_CLI_SLICES`
# processes on the one card over gloo at TOPK_CLI_BATCH a rank
TOPK_BATCH, TOPK_STEPS = 256, 3
TOPK_LAYERS = ("fc6", "fc7", "fc8")
TOPK_BLOCK = 4096
TOPK_CLI_BATCH, TOPK_CLI_RANKS, TOPK_CLI_SLICES = 64, 4, 2
# comm_stats' table: AlexNet at batch 256 a device on these groups
TOPK_TABLE_GROUPS = ({"data": 8}, {"dcn": 2, "data": 4})


# the [ssp] phase, AlexNet train_val at full width, f32, on [train]'s
# synthetic LMDB: (a) the SSP step in this process over a one-rank NCCL
# group, NCHW at SSP_BATCH and NHWC at SSP_CLI_BATCH, staleness
# SSP_STALENESS, SSP_STEPS = 2 (s + 1) steps, DENSE and then TOPK at 0.01
# on TOPK_LAYERS, each with the kernels and with their plain versions
# (cuDNN deterministic), then (NCHW) the local, boundary and sync device
# steps in turns over SSP_TIMED_PERIODS periods; (b) two
# `train --staleness SSP_STALENESS` processes on the card over gloo at
# SSP_CLI_BATCH a rank for SSP_CLI_ITERS iterations, an SSP snapshot at the
# end; (c) two `train --async_ssp --staleness 1 --async_sync_every 2`
# processes for ASYNC_CLI_ITERS iterations, then again under
# --comm_budget_mbps ASYNC_BUDGET_MBPS (low enough that a flush of the
# 244 MB arena overdraws the bucket, so partial pushes must happen)
SSP_BATCH, SSP_STALENESS = 256, 2
SSP_STEPS = 2 * (SSP_STALENESS + 1)
SSP_TIMED_PERIODS = 3
SSP_CLI_BATCH, SSP_CLI_ITERS = 128, 9
ASYNC_CLI_ITERS, ASYNC_BUDGET_MBPS = 8, 100.0
ASYNC_TOKEN = "chip-smoke-async-token"
# a child `train` that reports its kernel launches when it returns: the
# entry point a user calls (runtime/cli.main), then the counters
LAUNCH_REPORT = (
    "import json, sys\n"
    "from poseidon_tpu_torch.runtime.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "from poseidon_tpu_torch.ops import flash, lrn, pool, sgd\n"
    "print('[launches] ' + json.dumps({**lrn.LAUNCHES, **pool.LAUNCHES, "
    "**sgd.LAUNCHES, **flash.LAUNCHES}), flush=True)\n"
    "sys.exit(rc)\n")


# the [loop] phase, AlexNet train_val at full width, batch 256, on the
# synthetic ILSVRC-shaped LMDB of [train]: the serial loop as it was
# (Python batches, inline copies, a sync every step) for LOOP_SERIAL_STEPS
# steps, then the pipelined loop (native batches, prefetch 2, window 2) for
# LOOP_STEPS; each loop's rate leaves its first LOOP_WARMUP (serial:
# LOOP_SERIAL_WARMUP) steps out. Then the serial and the pipelined loop on
# native batches for LOOP_BITWISE_STEPS steps each, under cuDNN's
# deterministic algorithms: final params bitwise equal.
LOOP_SERIAL_STEPS, LOOP_SERIAL_WARMUP = 20, 2
LOOP_STEPS, LOOP_WARMUP = 60, 10
LOOP_BITWISE_STEPS = 4
LOOP_BATCHER_BATCHES, LOOP_PYTHON_BATCHES = 6, 2
# the uint8 variant of the train data layer: ILSVRC's per-channel BGR means
# in place of the mean file (a mean_file stays on the host)
LOOP_MEAN_VALUES = (104.0, 117.0, 123.0)


# the bf16 phases. [bf16_train]: AlexNet train_val at batch 256 under
# --bf16's policy (bf16 compute, conv_s2d) planned NHWC, BF16_TRAIN_ITERS
# steps on [train]'s LMDB with a test pass every BF16_TEST_INTERVAL.
BF16_TRAIN_ITERS, BF16_TEST_INTERVAL = 10, 5
# a bf16 step with the kernels vs the plain versions (bitwise equal to
# each other): cuDNN's bf16 backward algorithms may sum a gradient in
# another order from one call to the next, moving a bf16 rounding (2^-8 of
# an entry), which the update scales by the learning rate
BF16_STEP_TOL = (1e-3, 1e-5)
# conv1 with and without s2d in bf16: each output a bf16 rounding of an f32
# sum taken in another order, so one bf16 step (2^-8 relative) apart at
# most; held at 2^-7 of the output's largest magnitude
BF16_CONV_TOL = 2 ** -7
# [bf16_lm_train]: gpt_small's step with K1-K3's bf16 builds vs the plain
# flash versions. The kernels' bf16 outputs may sit one bf16 step from the
# plain version's (FLASH_TOL, FLASH_BWD_TOL), and every leaf's gradient is
# the f32 cast of a bf16 GEMM's output (8 significant bits): the loss and
# the params after one step within one bf16 step (rtol 2^-7, atol 1e-5;
# the update scales a gradient's difference by lr 0.01), gradients within
# 2^-4 of each leaf's largest
BF16_LM_STEP_TOL = (2 ** -7, 1e-5)
BF16_LM_GRAD_TOL = 2 ** -4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    from poseidon_tpu_torch.ops import _build
    names = _build.sources()
    t0 = time.perf_counter()
    _build.build_all(names)
    for name in names:
        _build.load(name)
    print(f"[build] {len(names)} kernel(s) {names} built (in parallel) and "
          f"loaded in {time.perf_counter() - t0:.2f} s", flush=True)


def bound_ms(nbytes: float, ops: float, dtype_name: str = "float32"):
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the peak rate for ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_case(kernel: str, label: str, got, want, dtype_name: str,
                 time_kernel, time_plain, time_library, nbytes: float,
                 ops: float, card: str, extra: str = "",
                 tol=KERNEL_TOL) -> dict:
    """Hold a kernel's result against its plain version's (already computed
    on the same inputs), time kernel, plain and library, print one line and
    return the record; fails the smoke if they disagree."""
    import torch
    diff = (got.float() - want.float()).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / want.float().abs().clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    rtol, atol = tol[dtype_name]
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    del diff
    ms = cuda_time_ms(time_kernel)
    plain_ms = cuda_time_ms(time_plain)
    library_ms = None if time_library is None else cuda_time_ms(time_library)
    least, by = bound_ms(nbytes, ops, dtype_name)
    rec = {"case": label, "dtype": dtype_name, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "tol_rtol_atol": [rtol, atol], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
           "ops": ops, "bound_ms": least, "bound_by": by}
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"[{kernel}] {label} {dtype_name}{extra}: max_abs={max_abs:.3e} "
          f"max_rel={max_rel:.3e} (rtol {rtol:g}, atol {atol:g}) kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, bound "
          f"{least:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
          f"{ops / 1e9:.3f} Gop; {HBM_SOURCE}, {dtype_name} "
          f"{OPS_PER_S[dtype_name] / 1e12:g} TFLOP/s) [{card}]",
          flush=True)
    check(ok, f"{kernel} disagrees with its plain version on {label} "
              f"{dtype_name}: max_abs {max_abs}")
    torch.cuda.empty_cache()
    return rec


def phase_kernels(card: str):
    """lrn_fwd (K4) vs plain on the card; returns the per-case records and
    the attributes of its tiles."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("norm1 serving", (64, 96, 55, 55), 5, torch.float32),
             ("norm2 serving", (64, 256, 27, 27), 5, torch.float32),
             ("norm1 serving", (64, 96, 55, 55), 5, torch.bfloat16),
             ("norm2 serving", (64, 256, 27, 27), 5, torch.bfloat16),
             ("norm1 train", (256, 96, 55, 55), 5, torch.float32),
             ("norm2 train", (256, 256, 27, 27), 5, torch.float32),
             ("odd", (5, 37, 9, 9), 4, torch.float32),
             # the window's edges and the tile's: one channel, the widest
             # window, C below the halo, one position, a C off the chunks
             ("n=1", (8, 16, 13, 13), 1, torch.float32),
             ("n=32", (8, 70, 13, 13), 32, torch.float32),
             ("C=2", (8, 2, 27, 27), 5, torch.float32),
             ("hw=1", (64, 96, 1, 1), 5, torch.float32),
             ("batch 1, C=131", (1, 131, 27, 27), 5, torch.float32)]
    attrs = {}
    for dtype, c, size in ((torch.float32, 96, 5), (torch.float32, 256, 5),
                           (torch.bfloat16, 96, 5), (torch.float32, 70, 32)):
        key = f"{str(dtype).replace('torch.', '')} C={c} n={size}"
        a = attrs[key] = lrn.lrn_fwd_kernel_attrs(dtype, c, size)
        print(f"[lrn_fwd] lrn_fwd_tile_kernel {key}: {a['registers']} "
              f"registers, {a['dynamic_smem_bytes']} B dynamic shared "
              f"(chunk {a['chunk']}), {a['local_bytes']} B spilled a thread, "
              f"{a['blocks_per_sm']} blocks of {a['threads']} threads an SM "
              f"[{card}]", flush=True)
    records = []
    for label, shape, size, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        got = lrn.lrn_fwd_cuda(x, size, LRN_ALPHA, LRN_BETA, LRN_K)
        torch.cuda.synchronize()
        want = lrn.lrn_across_channels_plain(x, size, LRN_ALPHA, LRN_BETA,
                                             LRN_K)
        again = lrn.lrn_fwd_cuda(x, size, LRN_ALPHA, LRN_BETA, LRN_K)
        bitwise = torch.equal(got, want)
        check(torch.equal(got, again), f"lrn_fwd {label}: a second launch "
                                       f"differs from the first")
        library = None
        if size % 2 == 1:
            # torch's builtin pads size//2 channels before the window, the
            # same window as Caffe's only for odd sizes: a yardstick there
            library = lambda: F.local_response_norm(  # noqa: E731
                x, size, LRN_ALPHA, LRN_BETA, LRN_K)
        # read x once, write y once; per element 2n (window) + 3 + pow
        rec = compare_case(
            "lrn_fwd", label, got, want, str(dtype).replace("torch.", ""),
            lambda: lrn.lrn_fwd_cuda(x, size, LRN_ALPHA, LRN_BETA, LRN_K),
            lambda: lrn.lrn_across_channels_plain(x, size, LRN_ALPHA,
                                                  LRN_BETA, LRN_K),
            library, 2 * x.numel() * x.element_size(),
            x.numel() * (2 * size + 4), card,
            extra=f" {tuple(shape)} n={size} bitwise={bitwise}")
        rec.update(shape=list(shape), local_size=size, bitwise=bitwise)
        records.append(rec)
        check(bitwise, f"lrn_fwd {label}: not bitwise equal to the plain "
                       f"version")
        del x, got, want, again
    return records, attrs


def phase_lrn_bwd(card: str):
    """lrn_bwd (K5) vs plain on the card at AlexNet training shapes."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [("norm1", (256, 96, 55, 55), 5, torch.float32),
             ("norm2", (256, 256, 27, 27), 5, torch.float32),
             ("norm1", (256, 96, 55, 55), 5, torch.bfloat16),
             ("norm2", (256, 256, 27, 27), 5, torch.bfloat16),
             ("odd", (5, 37, 9, 9), 4, torch.float32),
             # the window's edges and the tile's: one channel, the widest
             # window, C below the halo, one position, a C off the chunks
             ("n=1", (8, 16, 13, 13), 1, torch.float32),
             ("n=32", (8, 70, 13, 13), 32, torch.float32),
             ("C=2", (8, 2, 27, 27), 5, torch.float32),
             ("hw=1", (64, 96, 1, 1), 5, torch.float32),
             ("batch 1, C=131", (1, 131, 27, 27), 5, torch.float32)]
    records = []
    for label, shape, size, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        args = (size, LRN_ALPHA, LRN_BETA, LRN_K)
        got = lrn.lrn_bwd_cuda(x, g, *args)
        torch.cuda.synchronize()
        want = lrn.lrn_bwd_plain(x, g, *args)
        bitwise = torch.equal(got, want)
        library = None
        if size % 2 == 1:
            # one autograd call through torch's builtin LRN (the same window
            # as Caffe's at odd n): a yardstick the port never calls
            xr = x.detach().requires_grad_(True)
            yr = F.local_response_norm(xr, *args)
            library = lambda: torch.autograd.grad(  # noqa: E731
                yr, xr, g, retain_graph=True)
        # read x and g once, write dx once; per element 3n + 10 (pow as one)
        rec = compare_case(
            "lrn_bwd", label, got, want, str(dtype).replace("torch.", ""),
            lambda: lrn.lrn_bwd_cuda(x, g, *args),
            lambda: lrn.lrn_bwd_plain(x, g, *args), library,
            3 * x.numel() * x.element_size(), x.numel() * (3 * size + 10),
            card, extra=f" {tuple(shape)} n={size} bitwise={bitwise}")
        rec.update(shape=list(shape), local_size=size, bitwise=bitwise)
        records.append(rec)
        del x, g, got, want, library
    return records


def phase_pool_bwd(card: str):
    """pool_bwd (K6) vs plain on the card at AlexNet training shapes and
    the edges of its band plan and its geometry (the cases above); returns
    the per-case records and the attributes of each case's band plan."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.ops import pool

    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("pool1", (256, 96, 55, 55), 3, 2, 0, "max", f32),
             ("pool2", (256, 256, 27, 27), 3, 2, 0, "max", f32),
             ("pool5", (256, 256, 13, 13), 3, 2, 0, "max", f32),
             ("pool1", (256, 96, 55, 55), 3, 2, 0, "max", bf16),
             ("pool5", (256, 256, 13, 13), 3, 2, 0, "max", bf16),
             ("ties", (8, 16, 27, 27), 3, 2, 0, "max", f32),
             # 13 wide, k2 s2 pad 1: the ceil rule gives 8 windows, the
             # last starting in the padding, so Caffe clamps to 7
             ("ave pad ceil", (8, 16, 13, 13), 2, 2, 1, "ave", f32),
             # a plane of several bands
             ("bands", (1, 2, 600, 600), 3, 2, 0, "max", f32),
             # GoogLeNet's inception pool, loss-branch and final pools
             ("googlenet 3x3 s1 p1", (32, 192, 28, 28), 3, 1, 1, "max", f32),
             ("googlenet 5x5 s3", (32, 512, 14, 14), 5, 3, 0, "ave", f32),
             ("googlenet 7x7 s1", (32, 1024, 7, 7), 7, 1, 0, "ave", f32),
             # rows and a plane of -inf: a window with nothing above -inf
             # sends its cotangent to flat index 0 of the plane
             ("-inf rows", (8, 16, 27, 27), 3, 2, 0, "max", f32),
             # inputs that no window covers
             ("stride > kernel", (8, 16, 13, 13), 2, 3, 0, "max", f32),
             # global MAX pooling: one window of 169 taps a plane
             ("global 13x13", (256, 256, 13, 13), 13, 1, 0, "max", f32)]
    records, attrs = [], {}
    for label, shape, k, st, pd, method, dtype in cases:
        if label == "ties":
            x = torch.full(shape, 0.5, device="cuda", dtype=dtype)
        else:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if label == "-inf rows":
            x[:, :, :3] = -math.inf
            x[0, 1] = -math.inf
        geom = ((k, k), (st, st), (pd, pd))
        if label not in attrs:
            a = attrs[label] = pool.pool_bwd_kernel_attrs(dtype, method,
                                                          shape, *geom)
            print(f"[pool_bwd] pool_bwd_band_kernel {label} "
                  f"{str(dtype).replace('torch.', '')} {method}: "
                  f"{a['registers']} registers, {a['dynamic_smem_bytes']} B "
                  f"dynamic shared ({a['n_bands']} band(s) of "
                  f"{a['band_rows']} rows, {a['planes_per_block']} plane(s) "
                  f"a block), {a['local_bytes']} B spilled a thread, "
                  f"{a['blocks_per_sm']} blocks of {a['threads']} threads an "
                  f"SM [{card}]", flush=True)
        y = pool.pool_forward(x, *geom, method)
        g = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
        got = pool.pool_bwd_cuda(x, g, *geom, method)
        torch.cuda.synchronize()
        want = pool.pool_bwd_plain(x, g, *geom, method)
        again = pool.pool_bwd_cuda(x, g, *geom, method)
        bitwise = torch.equal(got, want)
        check(torch.equal(got, again), f"pool_bwd {label}: a second launch "
                                       f"differs from the first")
        if label == "ties":
            # every window routes its whole cotangent to its first tap
            check(bool((got[:, :, 1::2, :].float() == 0).all()
                       and (got[:, :, :, 1::2].float() == 0).all()),
                  "pool_bwd ties: a non-first tap got a gradient")
        if label == "-inf rows":
            # the -inf plane's windows all keep flat index 0: window (0, 0)
            # sends its cotangent to (0, 0), every other one is dropped
            check(bool(got[0, 1, 0, 0] == g[0, 1, 0, 0])
                  and int((got[0, 1] != 0).sum()) <= 1,
                  "pool_bwd -inf rows: flat index 0 not kept")
        library = None
        # torch's pooling in ceil mode clamps the last window as Caffe does;
        # a yardstick wherever its shape is Caffe's
        ref = (F.max_pool2d if method == "max" else F.avg_pool2d)(
            x, k, st, pd, ceil_mode=True)
        if tuple(ref.shape) == tuple(y.shape) and method == "max":
            _, idx = F.max_pool2d(x, k, st, pd, ceil_mode=True,
                                  return_indices=True)
            library = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731,E501
                g, x, [k, k], [st, st], [pd, pd], [1, 1], True, idx)
        elif tuple(ref.shape) == tuple(y.shape):
            library = lambda: torch.ops.aten.avg_pool2d_backward(  # noqa: E731
                g, x, [k, k], [st, st], [pd, pd], True, True, None)
        del ref
        windows = g.numel()
        # read x (max only) and g once, write dx once; per window k*k
        # compares (max) and k*k adds
        nbytes = (x.numel() * (2 if method == "max" else 1)
                  + g.numel()) * x.element_size()
        rec = compare_case(
            "pool_bwd", label, got, want, str(dtype).replace("torch.", ""),
            lambda: pool.pool_bwd_cuda(x, g, *geom, method),
            lambda: pool.pool_bwd_plain(x, g, *geom, method), library,
            nbytes, windows * k * k * (2 if method == "max" else 1), card,
            extra=f" {method} {tuple(shape)}->{tuple(y.shape[2:])} "
                  f"bitwise={bitwise}")
        if nbytes < 5e7:
            # small launches are paced by the host (wrapper, ctypes): the
            # profiler's kernel durations give the device's share alone
            dev = {"kernel": profiled_device_ms(
                       lambda: pool.pool_bwd_cuda(x, g, *geom, method),
                       key="pool_bwd_band_kernel"),
                   "library": (None if library is None
                               else profiled_device_ms(library))}
            print(f"[pool_bwd] {label}: device time a call (torch.profiler, "
                  f"mean of 10): kernel {dev['kernel']:.4f} ms, library "
                  + ("n/a" if dev["library"] is None
                     else f"{dev['library']:.4f} ms") + f" [{card}]",
                  flush=True)
            rec["device_ms"] = dev
        rec.update(shape=list(shape), method=method, bitwise=bitwise)
        records.append(rec)
        check(bitwise, f"pool_bwd {label}: not bitwise equal to the plain "
                       f"version")
        del x, y, g, got, want, again, library
    return records, attrs


def arena_mults(total: int, device):
    """lr_mult / decay vectors shaped like AlexNet's arena segments: a
    weight segment (lr 1, decay 5e-4) then a bias segment (lr 2, decay 0),
    alternating every 4099 elements, so both arms of the rule run."""
    import torch
    seg = (torch.arange(total, device=device) // 4099) % 2 == 1
    lr = torch.where(seg, 2.0, 1.0).float()
    dec = torch.where(seg, 0.0, 5e-4).float()
    return lr, dec


def phase_sgd(card: str, arena_total: int):
    """sgd_update (K7) vs plain on the card over the AlexNet arena and a
    ragged P+7."""
    import torch
    from poseidon_tpu_torch.ops import sgd

    gen = torch.Generator(device="cuda").manual_seed(3)
    records = []
    for label, n in (("alexnet arena", arena_total),
                     ("ragged tail", arena_total + 7)):
        w = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda")
        h = torch.randn(n, generator=gen, device="cuda") * 1e-3
        lr, dec = arena_mults(n, "cuda")
        rate, mom = 0.01, 0.9
        wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
        sgd.sgd_update_cuda_(wk, g, hk, rate, lr, dec, mom)
        torch.cuda.synchronize()
        sgd.sgd_update_plain_(wp, g, hp, rate, lr, dec, mom)
        got = torch.cat([wk, hk])
        want = torch.cat([wp, hp])
        del wk, hk, wp, hp
        p = torch.nn.Parameter(w.clone())
        p.grad = g.clone()
        opt = torch.optim.SGD([p], lr=rate, momentum=mom, weight_decay=5e-4,
                              foreach=True)
        # five f32 vectors read once, two written once; 8 ops per element
        rec = compare_case(
            "sgd_update", label, got, want, "float32",
            lambda: sgd.sgd_update_cuda_(w, g, h, rate, lr, dec, mom),
            lambda: sgd.sgd_update_plain_(w, g, h, rate, lr, dec, mom),
            opt.step, 7 * n * 4, 8 * n, card, extra=f" P={n}")
        rec.update(length=n, library="torch.optim.SGD(foreach=True) over "
                   "one flat vector: a rough yardstick, not Caffe's rule "
                   "(no lr_mult/decay segments)")
        records.append(rec)
        del w, g, h, lr, dec, got, want, p, opt
        torch.cuda.empty_cache()
    return records


def profiled_device_ms(fn, key: str = "", reps: int = 10) -> float:
    """Device time of one call of ``fn``: the durations of its device ops
    whose name holds ``key`` (all of them for ""), summed over ``reps``
    calls under torch.profiler, divided by ``reps``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and key in e.name)
    return us / reps / 1e3


def flash_cases():
    """(label, shape, dtype, causal, mode) of the K1 checks: the gpt_small
    prefill launches first (the serving path), the training shapes of
    gpt_small and of the byte-level LM (and its decode's prefill), then
    long and odd shapes."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    return ([(f"prefill {s}", (1, 12, s, 64), f32, True, None)
             for s in (16, 64, 256)]
            + [("train", (8, 12, 1024, 64), f32, True, None),
               # the gpt_small training launch under --bf16
               ("train", (8, 12, 1024, 64), bf16, True, None),
               ("lm_corpus train", (8, 4, 256, 32), f32, True, None),
               ("lm_corpus prefill", (1, 4, 32, 32), f32, True, None),
               ("long causal", (8, 12, 512, 64), f32, True, None),
               ("long", (8, 12, 512, 64), f32, False, None),
               ("long causal", (8, 12, 512, 64), bf16, True, None),
               ("long", (8, 12, 512, 64), bf16, False, None),
               ("ring mode +1", (2, 4, 128, 64), f32, True, 1),
               ("ring mode 0", (2, 4, 128, 64), f32, True, 0),
               ("ring mode -1", (2, 4, 128, 64), f32, True, -1),
               ("odd", (1, 3, 48, 16), f32, True, None)])


def phase_flash(card: str):
    """flash_fwd (K1) vs plain on the card, out and lse, and a second launch
    bitwise equal to the first; returns the per-case records (each lse
    error is folded into the record's max) and the attributes of each
    instantiation the cases run."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.ops import flash

    # the instantiations of each dtype and head dim the cases use, with
    # whole key tiles (64-row blocks) and with the key split that the C
    # entry takes for grids of fewer such blocks than the card has SMs
    attrs = {}
    for _, shape, dtype, _, _ in flash_cases():
        name = str(dtype).replace("torch.", "")
        dmax = next(m for m in (32, 64, 128) if shape[-1] <= m)
        for split in (1, 2):
            key = f"{name} D<={dmax} key split {split}"
            if key in attrs:
                continue
            a = attrs[key] = flash.flash_fwd_kernel_attrs(dtype, dmax, split)
            print(f"[flash_fwd] flash_fwd_kernel {key}: "
                  f"{a['registers']} registers, {a['local_bytes']} B local "
                  f"(spills), {a['dynamic_smem_bytes']} B dynamic + "
                  f"{a['static_smem_bytes']} B static shared memory, "
                  f"{a['threads']} threads, {a['blocks_per_sm']} resident "
                  f"blocks per SM, {a['own_rows']} query rows a block, "
                  f"{a['stream_rows']} key rows a tile [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    records = []
    for label, shape, dtype, causal, mode in flash_cases():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        out, lse = flash.flash_fwd_cuda(q, k, v, causal, None, mode)
        torch.cuda.synchronize()
        want_o, want_l = flash.flash_attention_fwd_plain(q, k, v, causal,
                                                         None, mode)
        dtype_name = str(dtype).replace("torch.", "")
        rtol, atol = FLASH_TOL["float32"]
        lse_err = float((lse - want_l).abs().max())
        check(bool(torch.allclose(lse, want_l, rtol=rtol, atol=atol)),
              f"flash_fwd lse disagrees with its plain version on {label} "
              f"{dtype_name}: max_abs {lse_err}")
        library = None
        if mode is None or mode >= 0:
            is_causal = causal and mode != 1
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=is_causal)
        b, h, s, d = shape
        live = 0.5 if causal and mode in (None, 0) else 1.0
        rec = compare_case(
            "flash_fwd", label, out, want_o, dtype_name,
            lambda: flash.flash_fwd_cuda(q, k, v, causal, None, mode),
            lambda: flash.flash_attention_fwd_plain(q, k, v, causal, None,
                                                    mode),
            library, 4 * q.numel() * q.element_size() + b * h * s * 4,
            4.0 * b * h * s * s * d * live, card,
            extra=f" {tuple(shape)} causal={causal} mode={mode} lse "
                  f"max_abs={lse_err:.3e}", tol=FLASH_TOL)
        # no atomics: a second launch on the same inputs is bitwise equal
        again = flash.flash_fwd_cuda(q, k, v, causal, None, mode)
        repeat = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        check(repeat, f"flash_fwd differs from run to run on {label} "
                      f"{dtype_name}")
        rec["bound_3xtf32_ms"] = (3 * rec["ops"] / TF32_OPS_PER_S * 1e3
                                  if dtype == torch.float32 else None)
        # small launches are paced by the host (wrapper, ctypes): the
        # profiler's kernel durations give the device's share alone
        dev = {"kernel": profiled_device_ms(
                   lambda: flash.flash_fwd_cuda(q, k, v, causal, None, mode),
                   key="flash_fwd_kernel"),
               "plain": profiled_device_ms(
                   lambda: flash.flash_attention_fwd_plain(q, k, v, causal,
                                                           None, mode)),
               "library": (None if library is None
                           else profiled_device_ms(library))}
        tf32 = ("" if rec["bound_3xtf32_ms"] is None else
                f", bound {rec['bound_3xtf32_ms']:.4f} ms at the 3xTF32 "
                f"rate (3 x ops / {TF32_OPS_PER_S / 1e12:g} TFLOP/s)")
        print(f"[flash_fwd] {label} {dtype_name}: device time a call "
              f"(torch.profiler, mean of 10): kernel {dev['kernel']:.4f} ms, "
              f"plain {dev['plain']:.4f} ms, library "
              + ("n/a" if dev["library"] is None
                 else f"{dev['library']:.4f} ms") + f"{tf32}; a second "
              f"launch bitwise equal: {repeat} [{card}]", flush=True)
        rec.update(shape=list(shape), causal=causal, mode=mode,
                   lse_max_abs_err=lse_err, device_ms=dev,
                   bitwise_repeat=repeat,
                   max_abs_err=max(rec["max_abs_err"], lse_err))
        records.append(rec)
        del q, k, v, out, lse, want_o, want_l, library, again
    return records, attrs


def flash_bwd_cases():
    """(label, shape, dtype, causal, mode) of the K2/K3 checks: the gpt_small
    training shape first (the main case), the byte-level LM's, then
    shorter, bf16, ring-chunk (delta passed in) and odd shapes."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    return [("train main", (8, 12, 1024, 64), f32, True, None),
            # the gpt_small training launch under --bf16
            ("train main", (8, 12, 1024, 64), bf16, True, None),
            ("lm_corpus train", (8, 4, 256, 32), f32, True, None),
            ("long causal", (8, 12, 512, 64), f32, True, None),
            ("long", (8, 12, 512, 64), f32, False, None),
            ("long causal", (8, 12, 512, 64), bf16, True, None),
            ("long", (8, 12, 512, 64), bf16, False, None),
            ("ring mode +1", (2, 4, 128, 64), f32, True, 1),
            ("ring mode 0", (2, 4, 128, 64), f32, True, 0),
            ("ring mode -1", (2, 4, 128, 64), f32, True, -1),
            ("odd", (1, 3, 48, 16), f32, True, None)]


def sdpa_backward_ms(q, k, v, g, is_causal: bool):
    """The library yardstick of K2+K3 together: F.scaled_dot_product_attention
    forward + backward (torch.autograd.grad) less its forward alone, by CUDA
    events and by the profiler's device time (ms, device ms)."""
    import torch
    import torch.nn.functional as F
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qr, kr, vr,
                                              is_causal=is_causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, kr, vr), g)

    return (cuda_time_ms(fwd_bwd) - cuda_time_ms(fwd),
            profiled_device_ms(fwd_bwd) - profiled_device_ms(fwd))


def phase_flash_bwd(card: str):
    """flash_dq (K2) and flash_dkv (K3) vs the plain backward on the card,
    on the kernel forward's out and lse; returns (K2 records, K3 records,
    the kernels' attributes by dtype at D = 64).
    The plain version and the library call compute dq, dk and dv in one
    call, so their times are of the whole backward, in both kernels'
    records."""
    import torch
    from poseidon_tpu_torch.ops import flash
    from poseidon_tpu_torch.ops.attention import NEG_INF

    attrs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        attrs[name] = flash.flash_bwd_kernel_attrs(dtype, 64)
        for kernel, a in attrs[name].items():
            print(f"[flash_bwd] {kernel} {name} D=64: {a['registers']} "
                  f"registers, {a['local_bytes']} B local (spills), "
                  f"{a['dynamic_smem_bytes']} B dynamic + "
                  f"{a['static_smem_bytes']} B static shared memory, "
                  f"{a['threads']} threads, {a['blocks_per_sm']} resident "
                  f"blocks per SM, tiles of {a['own_rows']} own and "
                  f"{a['stream_rows']} streamed rows [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dq_recs, dkv_recs = [], []
    for label, shape, dtype, causal, mode in flash_bwd_cases():
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                      .to(dtype) for _ in range(4))
        out, lse = flash.flash_fwd_cuda(q, k, v, causal, None, mode)
        # the ring passes its own delta in; the others take rowsum(dO*out)
        delta = flash.flash_delta(g, out)
        if mode is not None:
            delta = delta * 0.5
        args = (q, k, v, g, lse, delta, causal, None, mode)
        dq = flash.flash_dq_cuda(*args)
        dk, dv = flash.flash_dkv_cuda(*args)
        # no atomics: a second launch on the same inputs is bitwise equal
        repeat = (torch.equal(dq, flash.flash_dq_cuda(*args))
                  and all(torch.equal(a, b) for a, b in
                          zip((dk, dv), flash.flash_dkv_cuda(*args))))
        torch.cuda.synchronize()
        want = flash.flash_attention_bwd_plain(q, k, v, out, lse, g, causal,
                                               None, mode, delta)
        # both against the same backward in f64 (the plain version computes
        # in f64 for f64 input): how much of their difference is f32's own.
        # A fully masked row's lse is NEG_INF rounded to f32; in f64 it is
        # NEG_INF itself, so that p stays exp(0) = 1
        lse64 = torch.where(lse == NEG_INF, NEG_INF, lse.double())
        exact = flash.flash_attention_bwd_plain(
            q.double(), k.double(), v.double(), out.double(), lse64,
            g.double(), causal, None, mode, delta.double())
        err64 = {name: max(float((a.double() - e).abs().max())
                           for a, e in zip(got, exact))
                 for name, got in (("kernels", (dq, dk, dv)),
                                   ("plain", want))}
        del exact
        dtype_name = str(dtype).replace("torch.", "")
        b, h, s, d = shape
        live = 0.5 if causal and mode in (None, 0) else 1.0
        n_bytes = q.numel() * q.element_size()
        rows = 2 * b * h * s * 4               # lse and delta, f32
        plain = lambda: flash.flash_attention_bwd_plain(  # noqa: E731
            q, k, v, out, lse, g, causal, None, mode, delta)
        library = (None, None)
        if mode is None or mode >= 0:
            library = sdpa_backward_ms(q, k, v, g, causal and mode != 1)
        extra = f" {tuple(shape)} causal={causal} mode={mode}"
        # K2 reads q, k, v, dO, lse, delta and writes dq: three S x S x D
        # products; K3 the same reads, writes dk and dv: four products
        rec_q = compare_case(
            "flash_dq", label, dq, want[0], dtype_name,
            lambda: flash.flash_dq_cuda(*args), plain, None,
            5 * n_bytes + rows, 6.0 * b * h * s * s * d * live, card,
            extra=extra, tol=FLASH_BWD_TOL)
        rec_kv = compare_case(
            "flash_dkv", label, torch.cat([dk.flatten(), dv.flatten()]),
            torch.cat([want[1].flatten(), want[2].flatten()]), dtype_name,
            lambda: flash.flash_dkv_cuda(*args), plain, None,
            6 * n_bytes + rows, 8.0 * b * h * s * s * d * live, card,
            extra=extra, tol=FLASH_BWD_TOL)
        dev = {"flash_dq": profiled_device_ms(
                   lambda: flash.flash_dq_cuda(*args), key="flash_dq_kernel"),
               "flash_dkv": profiled_device_ms(
                   lambda: flash.flash_dkv_cuda(*args),
                   key="flash_dkv_kernel"),
               "plain": profiled_device_ms(plain),
               "library": library[1]}
        both = rec_q["ms"] + rec_kv["ms"]
        bound = rec_q["bound_ms"] + rec_kv["bound_ms"]
        for rec in (rec_q, rec_kv):
            rec["bound_3xtf32_ms"] = 3 * rec["ops"] / TF32_OPS_PER_S * 1e3
        tf32 = ""
        if dtype == torch.float32:
            tf32 = (f" ({rec_q['bound_3xtf32_ms']:.4f} + "
                    f"{rec_kv['bound_3xtf32_ms']:.4f} ms at the 3xTF32 rate,"
                    f" 3 x ops / {TF32_OPS_PER_S / 1e12:g} TFLOP/s)")
        lib = ("n/a" if library[0] is None else
               f"{library[0]:.4f} ms (device {library[1]:.4f} ms)")
        print(f"[flash_bwd] {label} {dtype_name}{extra}: K2+K3 {both:.4f} ms "
              f"= {rec_q['ms']:.4f} + {rec_kv['ms']:.4f} (device "
              f"{dev['flash_dq']:.4f} + {dev['flash_dkv']:.4f} ms, "
              f"torch.profiler), bound {rec_q['bound_ms']:.4f} + "
              f"{rec_kv['bound_ms']:.4f} = {bound:.4f} ms at "
              f"{OPS_PER_S[dtype_name] / 1e12:g} TFLOP/s{tf32}, plain "
              f"backward {rec_q['plain_ms']:.4f} ms (device "
              f"{dev['plain']:.4f} ms), F.scaled_dot_product_attention "
              f"backward {lib}; a second launch bitwise equal: {repeat}; "
              f"max_abs from an f64 backward: kernels "
              f"{err64['kernels']:.3e}, plain {err64['plain']:.3e} "
              f"[{card}]", flush=True)
        check(repeat, f"flash_dq/flash_dkv differ from run to run on {label} "
                      f"{dtype_name}")
        for rec in (rec_q, rec_kv):
            rec.update(shape=list(shape), causal=causal, mode=mode,
                       library_ms=library[0], device_ms=dev,
                       bitwise_repeat=repeat, max_abs_err_vs_f64=err64,
                       plain_and_library_cover="dq, dk and dv together")
        dq_recs.append(rec_q)
        dkv_recs.append(rec_kv)
        del q, k, v, g, out, lse, delta, dq, dk, dv, want, plain, args
        torch.cuda.empty_cache()
    return dq_recs, dkv_recs, attrs


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_slice(card: str, device=None,
                load_requests: int = LOAD_REQUESTS):
    """The serving path on the card; returns (LRN launches in the run,
    the executor)."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.serving.client import ServingClient, run_load
    from poseidon_tpu_torch.serving.executor import BucketedExecutor
    from poseidon_tpu_torch.serving.server import InferenceServer

    rs = np.random.RandomState(0)
    requests = {n: rs.randn(n, 3, 227, 227).astype(np.float32)
                for n in REQUEST_ROWS}

    zero_launches()
    t0 = time.perf_counter()
    ex = BucketedExecutor.from_files(ALEXNET, buckets=BUCKETS, seed=0,
                                     device=device)
    print(f"[slice] AlexNet executor on {ex.device}: "
          f"{ex.net.param_count()} params, buckets {ex.buckets} warmed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    server = InferenceServer(ex, port=0, max_delay_s=0.002)
    replies = {}
    try:
        cli = ServingClient(server.addr)
        try:
            for n, x in requests.items():
                replies[n] = cli.infer({"data": x})["prob"]
        finally:
            cli.close()
        big = requests[64]
        solo = run_load(server.addr, lambda i: {"data": big},
                        n_requests=load_requests, concurrency=1)
        load = run_load(server.addr, lambda i: {"data": big},
                        n_requests=load_requests, concurrency=2)
    finally:
        server.shutdown()
    sync(ex.device)
    counts = read_launches()
    launches = counts["lrn_fwd"]
    forwards = ex.forwards
    print(f"[slice] {forwards} forwards ({len(BUCKETS)} warm-up, "
          f"dispatches per bucket {ex.calls}); lrn_fwd launches {launches}",
          flush=True)
    check(launches == 2 * forwards,
          f"lrn_fwd launched {launches} times for {forwards} forwards "
          f"(expected 2 per forward)")
    check(counts["lrn_bwd"] == counts["pool_bwd"] == counts["sgd_update"]
          == counts["flash_fwd"] == 0,
          f"CNN serving launched a kernel of another path: {counts}")
    for run in (solo, load):
        check(run["ok"] == run["requests"], f"bucket-64 load failed: {run}")
        img_s = 64 * run["ok"] / run["wall_s"]
        print(f"[slice] bucket 64 via socket, concurrency "
              f"{run['concurrency']}, {run['requests']} requests in "
              f"{run['wall_s']:.3f} s: p50 {run['p50_ms']} ms, p99 "
              f"{run['p99_ms']} ms, {img_s:.1f} img/s [{card}]", flush=True)

    # replies vs a direct forward of the same rows on the card
    rtol, atol = NET_TOL
    for n, prob in replies.items():
        check(prob.shape == (n, 1000), f"reply of {n} rows has shape "
                                       f"{prob.shape}")
        check(bool(np.isfinite(prob).all()), f"non-finite prob ({n} rows)")
        sums = prob.astype(np.float64).sum(axis=1)
        check(bool(np.allclose(sums, 1.0, atol=1e-5)),
              f"prob rows do not sum to 1 ({n} rows): {sums.min()} "
              f"{sums.max()}")
        with torch.inference_mode():
            direct = ex.net({"data": torch.from_numpy(requests[n])
                             .to(ex.device)},
                            ex._params)["prob"].cpu().numpy()
        err = float(np.abs(prob - direct).max())
        print(f"[slice] {n:2d} rows: reply vs direct forward max_abs "
              f"{err:.3e}", flush=True)
        check(bool(np.allclose(prob, direct, rtol=rtol, atol=atol)),
              f"reply of {n} rows disagrees with a direct forward: {err}")
    return launches, ex, solo


def phase_net_checks(ex) -> float:
    """Bucket-16 forward: kernel LRN vs plain LRN on the card, and the card
    vs the CPU on two rows. Returns the kernel-vs-plain max error."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.ops import lrn
    from poseidon_tpu_torch.proto.messages import load_net

    x = torch.from_numpy(np.random.RandomState(1).randn(16, 3, 227, 227)
                         .astype(np.float32)).to(ex.device)
    lrn_layers = [l for l in ex.net.layers if l.TYPE == "LRN"]
    with torch.inference_mode():
        kern = ex.net({"data": x}, ex._params, keep_blobs=True)
        for l in lrn_layers:
            l.across_channels = lrn.lrn_across_channels_plain
        try:
            plain = ex.net({"data": x}, ex._params, keep_blobs=True)
        finally:
            for l in lrn_layers:
                l.across_channels = lrn.lrn_across_channels
    rtol, atol = NET_TOL
    worst = 0.0
    for name in ("norm1", "norm2", "prob"):
        a, b = kern[name].float(), plain[name].float()
        err = float((a - b).abs().max())
        worst = max(worst, err)
        print(f"[net] bucket 16, {name}: kernel vs plain LRN max_abs "
              f"{err:.3e}", flush=True)
        check(torch.allclose(a, b, rtol=rtol, atol=atol),
              f"{name}: kernel and plain LRN forwards disagree ({err})")

    cpu_net = Net(load_net(ALEXNET), "TEST", device="cpu")
    cpu_params = {l: {p: v.cpu() for p, v in d.items()}
                  for l, d in ex._params.items()}
    with torch.inference_mode():
        ref = cpu_net({"data": x[:2].cpu()}, cpu_params)["prob"]
    err = float((kern["prob"][:2].cpu() - ref).abs().max())
    print(f"[net] card vs CPU reference (2 rows) prob max_abs {err:.3e}",
          flush=True)
    check(torch.allclose(kern["prob"][:2].cpu(), ref, rtol=rtol, atol=atol),
          f"card and CPU forwards disagree ({err})")
    return worst


def phase_breakdown(ex, card: str, p50_socket_ms: float) -> None:
    """Where a bucket-64 request's time goes: the device forward (CUDA
    events), the executor's infer on the host clock (pad, H2D, forward,
    D2H), the rest of the socket request (codec, batcher, loopback), and
    the forward's device time by kernel from torch.profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.random.RandomState(2).randn(64, 3, 227, 227).astype(np.float32)
    xd = torch.from_numpy(x).to(ex.device)
    with torch.inference_mode():
        fwd_ms = cuda_time_ms(lambda: ex.net({"data": xd}, ex._params),
                              warmup=2, reps=10)
    t0 = time.perf_counter()
    for _ in range(5):
        ex.infer({"data": x})
    infer_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"[breakdown] bucket 64: device forward {fwd_ms:.3f} ms, "
          f"executor.infer {infer_ms:.3f} ms (host pad + H2D + forward + "
          f"D2H), socket request p50 {p50_socket_ms:.3f} ms (the rest: "
          f"codec, batcher, loopback) [{card}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            ex.net({"data": xd}, ex._params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    busy = sum(per_kernel.values())
    if not busy:
        print("[breakdown] torch.profiler: no device time recorded",
              flush=True)
        return
    print(f"[breakdown] profiled forward: device busy {busy / 1e3:.3f} ms "
          f"of {wall_us / 1e3:.3f} ms wall ({len(per_kernel)} kernels)",
          flush=True)
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:8.3f} ms {100 * us / busy:5.1f}%  {name[:90]}",
              flush=True)


def zero_launches() -> None:
    from poseidon_tpu_torch.ops import flash, lrn, pool, sgd
    for table in (lrn.LAUNCHES, pool.LAUNCHES, sgd.LAUNCHES, flash.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches() -> dict:
    from poseidon_tpu_torch.ops import flash, lrn, pool, sgd
    return {**lrn.LAUNCHES, **pool.LAUNCHES, **sgd.LAUNCHES,
            **flash.LAUNCHES}


def synthetic_ilsvrc_paths(root: str):
    """(train LMDB, val LMDB, mean binaryproto) under ``root``."""
    return (os.path.join(root, "ilsvrc12_train_lmdb"),
            os.path.join(root, "ilsvrc12_val_lmdb"),
            os.path.join(root, "ilsvrc12_mean.binaryproto"))


def write_synthetic_ilsvrc(root: str):
    """Train and val LMDBs of 3x256x256 uint8 Datum records (class
    templates plus noise, examples/make_synthetic_db.py's recipe, CLASSES
    classes) and a mean binaryproto, under ``root``; returns their
    paths."""
    import numpy as np
    from poseidon_tpu_torch.data.lmdb_reader import LMDBWriter
    from poseidon_tpu_torch.proto.wire import Datum, encode_blob, encode_datum

    shape = (3, 256, 256)
    templates = {}

    def template(label: int):
        if label not in templates:
            templates[label] = np.random.RandomState(1_000_000 + label) \
                .randint(60, 196, size=shape).astype(np.int16)
        return templates[label]

    def write(path: str, n: int, seed: int) -> None:
        w = LMDBWriter(path)
        rs = np.random.RandomState(seed)
        for i in range(n):
            label = int(rs.randint(CLASSES))
            img = np.clip(template(label) + rs.normal(0, 30, size=shape),
                          0, 255).astype(np.uint8)
            w.put(f"{i:08d}".encode(), encode_datum(Datum(
                channels=shape[0], height=shape[1], width=shape[2],
                data=img.tobytes(), label=label)))
        w.close()

    train, val, mean = synthetic_ilsvrc_paths(root)
    write(train, TRAIN_RECORDS, 1)
    write(val, VAL_RECORDS, 2)
    with open(mean, "wb") as f:
        f.write(encode_blob(np.full((1,) + shape, 128.0, np.float32)))
    return train, val, mean


def alexnet_net_param(root: str, batch_size=None):
    """alexnet_train_val.prototxt with its data sources and mean file
    pointed at the synthetic LMDBs under ``root`` (both data layers' batch
    set to ``batch_size`` when given)."""
    from poseidon_tpu_torch.proto.messages import load_net

    train_db, val_db, mean = synthetic_ilsvrc_paths(root)
    net_param = load_net(ALEXNET_TRAIN)
    for lp in net_param.layers:
        if lp.canonical_type() == "DATA":
            train = any(r.phase == "TRAIN" for r in lp.include)
            lp.data_param.source = train_db if train else val_db
            lp.transform_param.mean_file = mean
            if batch_size:
                lp.data_param.batch_size = batch_size
    return net_param


def alexnet_solver(root: str, batch_size=None, write: bool = True,
                   iters: int = TRAIN_ITERS, test_interval: int = TEST_INTERVAL,
                   prefix: str = "alexnet"):
    """alexnet_solver.prototxt over alexnet_train_val.prototxt with only the
    data sources, the mean file, the cadence and the snapshot prefix
    pointed at ``root``: every layer, width, batch, crop and mirror stays
    (``batch_size`` cuts the batch for a CPU rehearsal only). ``write``
    writes the synthetic LMDBs first (a later phase reuses them)."""
    from poseidon_tpu_torch.proto.messages import load_solver

    if write:
        t0 = time.perf_counter()
        write_synthetic_ilsvrc(root)
        print(f"[train] synthetic ILSVRC-shaped LMDBs: {TRAIN_RECORDS} train "
              f"+ {VAL_RECORDS} val records of 3x256x256, {CLASSES} classes, "
              f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    sp = load_solver(ALEXNET_SOLVER)
    sp.net, sp.net_param = "", alexnet_net_param(root, batch_size)
    sp.max_iter, sp.display = iters, 10
    sp.test_interval, sp.test_iter = test_interval, [TEST_ITER]
    sp.snapshot, sp.snapshot_prefix = 0, os.path.join(root, prefix)
    return sp


def step_once(eng, params0, hist0, it0, batch, seed: int = 7):
    """One training step from the given params/history/iteration on a fixed
    batch, the dropout generator reseeded; returns (loss, params, history)
    as clones."""
    from poseidon_tpu_torch.parallel.trainer import TrainState
    from poseidon_tpu_torch.solvers.updates import SolverState

    eng.train_net.generator.manual_seed(seed)
    params, state = eng.train_step.load(
        params0, TrainState(SolverState(it0, hist0), {}))
    params, state, m = eng.train_step.step(params, state, batch)
    clone = lambda t: {l: {k: v.clone() for k, v in d.items()}  # noqa: E731
                       for l, d in t.items()}
    return float(m["loss"]), clone(params), clone(state.solver.history)


class plain_versions:
    """Within the block, every LRN and POOLING layer of ``net`` and the
    step's update run their plain versions (no kernel launches)."""

    def __init__(self, net, step):
        self.net, self.step = net, step

    def __enter__(self):
        from poseidon_tpu_torch.ops import lrn, pool, sgd
        for l in self.net.layers:
            if l.TYPE == "LRN":
                l.across_channels = lrn.lrn_across_channels_reference
            elif l.TYPE == "POOLING":
                l.pool = (pool.max_pool_reference if l.method == "MAX"
                          else pool.ave_pool_reference)
        self.step.sgd_update = sgd.sgd_update_plain_
        return self

    def __exit__(self, *exc):
        from poseidon_tpu_torch.ops import lrn, pool, sgd
        for l in self.net.layers:
            if l.TYPE == "LRN":
                l.across_channels = lrn.lrn_across_channels
            elif l.TYPE == "POOLING":
                l.pool = pool.max_pool if l.method == "MAX" else pool.ave_pool
        self.step.sgd_update = sgd.sgd_update_
        return False


def phase_step_vs_plain(eng, batch, tol=STEP_TOL, tag: str = "train"
                        ) -> float:
    """One step with the kernels vs the same step with the plain versions
    swapped into every LRN and POOLING layer and the update, on the card,
    at ``tol`` (rtol, atol). Returns the largest parameter difference."""
    import torch

    clone = lambda t: {l: {k: v.clone() for k, v in d.items()}  # noqa: E731
                       for l, d in t.items()}
    p0, h0 = clone(eng.params), clone(eng.state.solver.history)
    it0 = eng.iteration()
    loss_k, pk, hk = step_once(eng, p0, h0, it0, batch)
    before = read_launches()
    with plain_versions(eng.train_net, eng.train_step):
        loss_p, pp, hp = step_once(eng, p0, h0, it0, batch)
    check(read_launches() == before,
          "the plain-version step launched a kernel: the swap did not take")
    rtol, atol = tol
    check(abs(loss_k - loss_p) <= atol + rtol * abs(loss_p),
          f"step loss with kernels {loss_k} vs plain versions {loss_p}")
    worst = 0.0
    for tree_k, tree_p, what in ((pk, pp, "param"), (hk, hp, "history")):
        for l in tree_k:
            for k in tree_k[l]:
                a, b = tree_k[l][k], tree_p[l][k]
                err = float((a - b).abs().max())
                worst = max(worst, err)
                check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                      f"{what} {l}/{k} after one step: kernels vs plain "
                      f"versions max_abs {err}")
    print(f"[{tag}] one step, kernels vs plain versions on the card: loss "
          f"{loss_k!r} vs {loss_p!r}, every updated param and momentum "
          f"within rtol {rtol:g} atol {atol:g} (max_abs {worst:.3e})",
          flush=True)
    return worst


# each port kernel of a CNN training step by the name of its CUDA kernel
CNN_KERNEL_NAMES = {"lrn_fwd": "lrn_fwd_tile_kernel",
                    "lrn_bwd": "lrn_bwd_kernel",
                    "pool_bwd": "pool_bwd_band_kernel",
                    "sgd_update": "sgd_update_kernel"}
CNN_NHWC_KERNEL_NAMES = {"lrn_fwd_nhwc": "lrn_nhwc_fwd_kernel",
                         "lrn_bwd_nhwc": "lrn_nhwc_bwd_kernel",
                         "pool_bwd_nhwc": "pool_nhwc_band_kernel",
                         "sgd_update": "sgd_update_kernel"}
# a profiled step's kernels by kind: layout shuffles (cuDNN's transposes
# and tensor transforms), torch's copies (the dtype casts, and the entry and
# FC-boundary conversions of a channels-last graph), cuDNN's channel
# slices of a grouped conv, the convolutions' library kernels (cuDNN) and
# the GEMMs' (cuBLAS)
TRANSPOSE_KEYS = ("transpose", "nchwtonhwc", "nhwctonchw", "tensortransform")
COPY_KEYS = ("copy",)
SLICE_KEYS = ("slicec",)
CONV_KEYS = ("cudnn", "conv", "dgrad", "wgrad", "fprop", "implicit")
GEMM_KEYS = ("gemm", "cutlass", "cublas", "nvjet")


def kernel_kind(name: str, port_keys) -> str:
    low = name.lower()
    if any(k in name for k in port_keys):
        return "port"
    for kind, keys in (("transpose", TRANSPOSE_KEYS), ("copy", COPY_KEYS),
                       ("slice", SLICE_KEYS), ("conv", CONV_KEYS),
                       ("gemm", GEMM_KEYS)):
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_train_profile(eng, batch, card: str, tag: str = "train",
                        kernel_names=None) -> dict:
    """Device step time over TIMED_STEPS steps on a fixed on-device batch,
    peak device memory, and the top kernels of one profiled step, with
    each port kernel's time (``kernel_names``: counter name -> CUDA kernel
    name; every one must show device time) and the step's kernels by kind
    (``kernel_kind``), with the layout shuffles counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    params, state = eng.params, eng.state
    step = eng.train_step.step
    for _ in range(2):
        params, state, _m = step(params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        params, state, m = step(params, state, batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(m["loss"])), "non-finite loss in timed steps")
    n = batch["data"].shape[0]
    print(f"[{tag}] device step {step_ms:.3f} ms (CUDA events, mean of "
          f"{TIMED_STEPS} steps, fixed on-device batch {n}): "
          f"{n / step_ms * 1e3:.1f} img/s; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    # the profiler misses the first kernels of the first step it traces
    # (there: conv1 and norm1's lrn_fwd), so a warm-up step goes before the
    # kept one. The schedule's "ProfilerStep#N" range also comes back as a
    # device-side user annotation spanning the whole step, which summed as
    # a kernel would count the step twice: annotations are no kernels.
    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.extend(p.events())) as prof:
        for _ in range(2):
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            prof.step()
    per_kernel, launches = {}, {}
    for e in kept:
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep")):
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
            launches[e.name] = launches.get(e.name, 0) + 1
    busy = sum(per_kernel.values())
    names = dict(CNN_KERNEL_NAMES if kernel_names is None else kernel_names)
    kinds = {}
    for name, us in per_kernel.items():
        k = kinds.setdefault(kernel_kind(name, names.values()),
                             {"ms": 0.0, "launches": 0})
        k["ms"] += us / 1e3
        k["launches"] += launches[name]
    for k in kinds.values():
        k["share"] = k["ms"] * 1e3 / busy if busy else 0.0
    # one step's kernels run one after another on one stream: their sum
    # well past the step's time means an event was counted that is no
    # kernel (tracing itself lengthens the kernels by a few per cent)
    check(busy / 1e3 <= PROFILE_BUSY_MARGIN * step_ms,
          f"profiled step: kernels sum to {busy / 1e3:.3f} ms, past "
          f"{PROFILE_BUSY_MARGIN} x the step's {step_ms:.3f} ms")
    ours = {}
    if busy:
        print(f"[{tag}] profiled step: device busy {busy / 1e3:.3f} ms "
              f"({len(per_kernel)} kernels, {sum(launches.values())} "
              f"launches); top 8:", flush=True)
        for name, us in sorted(per_kernel.items(),
                               key=lambda kv: -kv[1])[:8]:
            print(f"  {us / 1e3:8.3f} ms {100 * us / busy:5.1f}%  "
                  f"x{launches[name]:<3d} {name[:84]}", flush=True)
        for kernel, key in names.items():
            us = sum(v for k, v in per_kernel.items() if key in k)
            ours[kernel] = {"ms": us / 1e3, "share": us / busy}
        print(f"[{tag}] port kernels in the profiled step: " + ", ".join(
            f"{k} {v['ms']:.3f} ms ({100 * v['share']:.1f}%)"
            for k, v in ours.items()) + f" [{card}]", flush=True)
        print(f"[{tag}] the step's kernels by kind: " + ", ".join(
            f"{k} {v['ms']:.3f} ms ({100 * v['share']:.1f}%, "
            f"{v['launches']} launches)" for k, v in sorted(kinds.items()))
            + f" [{card}]", flush=True)
        for kernel, v in ours.items():
            check(v["ms"] > 0, f"{kernel} ({names[kernel]}) launched on the "
                               f"step but shows no device time")
    else:
        print(f"[{tag}] torch.profiler: no device time recorded",
              flush=True)
    eng.params, eng.state = params, state
    return {"step_ms": step_ms, "peak_bytes": peak, "profiled_busy_ms":
            busy / 1e3, "port_kernels": ours, "kinds": kinds,
            "transpose_launches": kinds.get("transpose", {}).get(
                "launches", 0),
            "copy_launches": kinds.get("copy", {}).get("launches", 0)}


def phase_train(card: str, root: str, device=None, batch_size=None) -> dict:
    """Full-width AlexNet through Engine.train() on the card (``device`` and
    ``batch_size`` are for a CPU rehearsal at a cut batch only)."""
    import torch
    from poseidon_tpu_torch.runtime.engine import Engine

    sp = alexnet_solver(root, batch_size)
    eng = Engine(sp, output_dir=root, device=device)
    try:
        n_params = eng.train_net.param_count()
        print(f"[train] AlexNet train net on {eng.device}: {n_params} "
              f"params, batch {eng.train_net.blob_shapes['data']}, arena "
              f"{eng.train_step.arena.total} f32 in "
              f"{eng.train_step.arena.n_buckets} buckets", flush=True)
        check(n_params == 60_965_224, f"AlexNet has {n_params} params")
        zero_launches()
        t0 = time.perf_counter()
        eng.train()
        sync(eng.device)
        wall = time.perf_counter() - t0
        counts = read_launches()
        steps = eng.stats["train_iters"]
        test_forwards = TEST_ITER * (1 + TRAIN_ITERS // TEST_INTERVAL)
        want = {k: 0 for k in counts}
        want.update({"lrn_fwd": 2 * (steps + test_forwards),
                     "lrn_bwd": 2 * steps, "pool_bwd": 3 * steps,
                     "sgd_update": steps})
        print(f"[train] Engine.train(): {steps} steps + {test_forwards} test "
              f"forwards in {wall:.2f} s; launches {counts} (expected "
              f"{want})", flush=True)
        check(steps == TRAIN_ITERS, f"trained {steps} steps")
        check(counts == want, f"launch counts {counts} != {want}")
        check(eng.iteration() == TRAIN_ITERS, "iteration count")
        stall, busy = eng.stats["input_stall_s"], eng.stats["train_step_s"]
        batch_n = eng.train_net.blob_shapes["data"][0]
        loop = {"img_s": steps * batch_n / (stall + busy),
                "data_wait_share": stall / (stall + busy),
                "input_stall_s": stall, "train_step_s": busy}
        print(f"[train] training loop: {loop['img_s']:.1f} img/s, data-wait "
              f"share {loop['data_wait_share']:.3f} ({stall:.2f} s waiting "
              f"on the pipeline, {busy:.2f} s in steps) [{card}]",
              flush=True)

        # the snapshot written after train restores bitwise
        state_path = os.path.join(root, f"alexnet_iter_{TRAIN_ITERS}"
                                        f".solverstate.npz")
        check(os.path.exists(state_path), f"no snapshot {state_path}")
        check(os.path.exists(state_path.replace(".solverstate.npz",
                                                ".caffemodel")),
              "no caffemodel snapshot")
        saved_p = {l: {k: v.clone() for k, v in d.items()}
                   for l, d in eng.params.items()}
        saved_h = {l: {k: v.clone() for k, v in d.items()}
                   for l, d in eng.state.solver.history.items()}
        for l in eng.params:
            for k in eng.params[l]:
                eng.params[l][k].zero_()
        eng.restore_from(state_path)
        check(eng.iteration() == TRAIN_ITERS, "restored iteration")
        for a_tree, b_tree in ((saved_p, eng.params),
                               (saved_h, eng.state.solver.history)):
            for l in a_tree:
                for k in a_tree[l]:
                    check(torch.equal(a_tree[l][k], b_tree[l][k]),
                          f"{l}/{k} did not restore bitwise")
        print(f"[train] snapshot {os.path.basename(state_path)} restored "
              f"bitwise (params and momentum)", flush=True)
        del saved_p, saved_h

        batch = eng._next_batch(eng.train_pipelines)
        phase_step_vs_plain(eng, batch)
        prof = phase_train_profile(eng, batch, card)
        return {"launches": counts, "loop": loop, **prof}
    finally:
        eng.close()


def loop_solver(root: str, max_iter: int, batch_size=None,
                mean_values=None):
    """alexnet_solver's net at full width with no test net, no snapshot
    and display every 10 steps (each display a hard sync, as in [train]);
    with ``mean_values``, the train data layer subtracts them in place of
    the mean file (what the uint8 device transform needs)."""
    from poseidon_tpu_torch.proto.messages import load_solver

    sp = load_solver(ALEXNET_SOLVER)
    sp.net, sp.net_param = "", alexnet_net_param(root, batch_size)
    if mean_values is not None:
        for lp in sp.net_param.layers:
            if lp.canonical_type() == "DATA" and any(
                    r.phase == "TRAIN" for r in lp.include):
                lp.transform_param.mean_file = ""
                lp.transform_param.mean_value = list(mean_values)
    sp.max_iter, sp.display = max_iter, 10
    sp.test_interval, sp.test_iter = 0, []
    sp.snapshot, sp.snapshot_prefix, sp.snapshot_after_train = 0, "", False
    return sp


def train_layer(root: str, batch_size=None):
    from poseidon_tpu_torch.core.net import filter_net
    from poseidon_tpu_torch.proto.messages import NetState
    return next(lp for lp in filter_net(alexnet_net_param(root, batch_size),
                                        NetState(phase="TRAIN"))
                if lp.canonical_type() == "DATA")


def mean_value_layer(root: str, batch_size=None):
    """The train data layer with LOOP_MEAN_VALUES in place of the mean file
    (a variant: the uint8 split needs a per-channel mean)."""
    lp = train_layer(root, batch_size)
    lp.transform_param.mean_file = ""
    lp.transform_param.mean_value = list(LOOP_MEAN_VALUES)
    return lp


def loop_batchers(card: str, root: str, batch: int) -> dict:
    """(a) The batchers alone, img/s: the native f32 batcher (crop 227,
    mirror, mean file), the native uint8 batcher on the mean-value variant,
    and the Python source + transformer the serial loop reads through."""
    import numpy as np
    from poseidon_tpu_torch.data.native import NativeLMDBBatcher
    from poseidon_tpu_torch.data.pipeline import (_effective_transform,
                                                  build_source)
    from poseidon_tpu_torch.data.transformer import DataTransformer
    from poseidon_tpu_torch.proto.wire import read_blob_file

    train_db, _, mean = synthetic_ilsvrc_paths(root)
    rs = np.random.RandomState(0)
    out = {}
    for name, kw, call in (
            ("native_f32", {"mean": read_blob_file(mean)[0]}, "batch"),
            ("native_u8", {"mean_values": np.asarray(LOOP_MEAN_VALUES,
                                                     np.float32)},
             "batch_u8")):
        b = NativeLMDBBatcher(train_db, crop_size=227, mirror=True,
                              train=True, **kw)
        try:
            fn = getattr(b, call)
            fn(rs.randint(0, len(b), size=batch), seed=0)   # warm
            t0 = time.perf_counter()
            for i in range(LOOP_BATCHER_BATCHES):
                fn(rs.randint(0, len(b), size=batch), seed=i + 1)
            dt = time.perf_counter() - t0
            out[name] = LOOP_BATCHER_BATCHES * batch / dt
            threads = b.n_threads
        finally:
            b.close()
    lp = train_layer(root, batch)
    src = build_source(lp)
    tf = DataTransformer(_effective_transform(lp), "TRAIN", seed=0)
    try:
        t0 = time.perf_counter()
        for _ in range(LOOP_PYTHON_BATCHES):
            idx = rs.randint(0, len(src), size=batch)
            tf(np.stack([src.read(int(j))[0] for j in idx]))
        out["python"] = LOOP_PYTHON_BATCHES * batch / (
            time.perf_counter() - t0)
    finally:
        src.close()
    print(f"[loop] (a) batchers alone at batch {batch} (host "
          f"os.cpu_count() {os.cpu_count()}, native threads {threads}): "
          f"native f32 (crop 227, mirror, mean file) {out['native_f32']:.1f}"
          f" img/s over {LOOP_BATCHER_BATCHES} batches; native uint8 "
          f"{out['native_u8']:.1f} img/s (a variant: mean_value "
          f"{'/'.join(f'{v:g}' for v in LOOP_MEAN_VALUES)} in place of the "
          f"mean file); Python source + transformer {out['python']:.1f} "
          f"img/s over {LOOP_PYTHON_BATCHES} batches [{card}]", flush=True)
    return out


def loop_rate(events, first_iter: int, batch: int) -> dict:
    """From one train() call's host spans: img/s over the steps from
    ``first_iter`` on (from the start of that step's prefetch wait to the
    end of the final hard sync), and the data-wait share of those steps
    (prefetch waits over prefetch waits + dispatches + window waits)."""
    def args(e):
        return e.get("args") or {}

    steps = [e for e in events if e["name"] == "prefetch_wait"
             and args(e)["iter"] >= first_iter]
    t0 = min(e["ts"] for e in steps)
    final = [e for e in events if e["name"] == "hard_sync"
             and args(e).get("boundary") == "final"]
    t1 = max(e["ts"] + e["dur"] for e in final)
    wait = sum(e["dur"] for e in steps)
    busy = sum(e["dur"] for e in events
               if e["name"] in ("dispatch", "dispatch_window")
               and args(e)["iter"] >= first_iter)
    n = len(steps)
    return {"steps": n, "img_s": n * batch / ((t1 - t0) / 1e6),
            "data_wait_share": wait / (wait + busy),
            "wall_s": (t1 - t0) / 1e6}


def run_loop(root: str, device, batch_size, steps: int, warmup: int,
             mean_values=None, **engine_kw) -> dict:
    """One Engine build, one train() call of ``steps`` steps with the span
    recorder on; the K4-K7 launches zeroed just before and read just
    after. Returns the rate, the routes, the prefetch stage, the
    launches."""
    from poseidon_tpu_torch.runtime.engine import Engine
    from poseidon_tpu_torch.runtime.spans import recorder

    eng = Engine(loop_solver(root, steps, batch_size, mean_values),
                 output_dir=root, device=device,
                 trace_out=os.path.join(root, "loop.json"), **engine_kw)
    try:
        batch = eng.train_net.blob_shapes["data"][0]
        zero_launches()
        eng.train()
        sync(eng.device)
        counts = read_launches()
        rate = loop_rate(recorder.trace_events(), warmup, batch)
        feed = eng._device_feed
        rate.update(
            routes=[p.route for p in eng.train_pipelines],
            prefetch=(None if feed is None else
                      "passthrough" if feed.passthrough else "cuda-stream"),
            staged=0 if feed is None else feed.staged,
            steps_in_flight=eng.stats["steps_in_flight"],
            launches=counts, batch=batch)
        check(eng.stats["train_iters"] == steps,
              f"loop trained {eng.stats['train_iters']} steps")
        return rate
    finally:
        eng.close()


def loop_bitwise(card: str, root: str, device, batch_size) -> None:
    """(c) The serial and the pipelined loop on native batches end bitwise
    equal (cuDNN deterministic); the device transform of the first uint8
    batch is the native f32 batch, bitwise."""
    import torch
    from poseidon_tpu_torch.data.pipeline import BatchPipeline
    from poseidon_tpu_torch.runtime.engine import Engine, device_input_transform

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    finals = []
    try:
        for kw in (dict(device_prefetch=0, max_in_flight=1),
                   dict(device_prefetch=2, max_in_flight=2)):
            eng = Engine(loop_solver(root, LOOP_BITWISE_STEPS, batch_size),
                         output_dir=root, device=device, **kw)
            try:
                check([p.route for p in eng.train_pipelines] == ["native"],
                      "bitwise arm not on native batches")
                eng.train()
                finals.append([{l: {k: v.clone() for k, v in d.items()}
                                for l, d in t.items()}
                               for t in (eng.params,
                                         eng.state.solver.history)])
            finally:
                eng.close()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    (ps, hs), (pp, hp) = finals
    check(tree_equal(ps, pp) and tree_equal(hs, hp),
          f"serial vs pipelined loop after {LOOP_BITWISE_STEPS} steps: "
          f"params max_abs {tree_max_abs(ps, pp)}, momentum "
          f"{tree_max_abs(hs, hp)}")
    lp = mean_value_layer(root, batch_size)
    batch = lp.data_param.batch_size
    u8 = BatchPipeline(lp, "TRAIN", batch, device_transform=True)
    f32 = BatchPipeline(lp, "TRAIN", batch)
    try:
        check(u8.route == "native-u8" and f32.route == "native",
              f"routes {u8.route}, {f32.route}")
        b8, bf = next(u8), next(f32)
        dev = torch.device(device or "cuda")
        got = device_input_transform([u8], dev)(
            {k: torch.from_numpy(v).to(dev) for k, v in b8.items()})
        want = torch.from_numpy(bf["data"]).to(dev)
        check(got["data"].dtype == torch.float32
              and torch.equal(got["data"], want),
              f"device transform vs host f32 batch: max_abs "
              f"{float((got['data'] - want).abs().max())}")
    finally:
        u8.close()
        f32.close()
    print(f"[loop] (c) under cudnn.deterministic: the serial and the "
          f"pipelined loop on native batches end bitwise equal after "
          f"{LOOP_BITWISE_STEPS} steps (params and momentum); the device "
          f"transform of the first uint8 batch {tuple(b8['data'].shape)} is "
          f"the native f32 batch bitwise [{card}]", flush=True)


def phase_loop(card: str, root: str, step_ms: float, device=None,
               batch_size=None) -> dict:
    """The CNN training loop as a pipeline (see LOOP_*): (a) the batchers
    alone, (b) the serial and the pipelined loop beside the device step of
    [train], (c) the bitwise checks, (d) no hidden fallback. ``device`` and
    ``batch_size`` are for a CPU rehearsal at a cut batch only."""
    import torch

    t_phase = time.perf_counter()
    cuda = torch.device(device or "cuda").type == "cuda"
    print(f"[loop] host os.cpu_count() {os.cpu_count()}; {card}", flush=True)
    batch = batch_size or train_layer(root).data_param.batch_size
    batchers = loop_batchers(card, root, batch)
    serial = run_loop(root, device, batch_size, LOOP_SERIAL_STEPS,
                      LOOP_SERIAL_WARMUP, use_native=False,
                      device_prefetch=0, max_in_flight=1)
    piped = run_loop(root, device, batch_size, LOOP_STEPS, LOOP_WARMUP,
                     device_prefetch=2, max_in_flight=2)
    device_img_s = batch / step_ms * 1e3
    for name, r, what, first in (
            ("serial", serial, "Python batches, inline copy, window 1",
             LOOP_SERIAL_WARMUP),
            ("pipelined", piped, "native batches, CUDA-stream prefetch 2, "
                                 "window 2", LOOP_WARMUP)):
        print(f"[loop] (b) {name} loop ({what}): {r['img_s']:.1f} img/s "
              f"over steps {first}-{first + r['steps'] - 1} "
              f"({r['wall_s']:.2f} s), data-wait share "
              f"{r['data_wait_share']:.3f}, mean steps in flight "
              f"{r['steps_in_flight']}, routes {r['routes']}, prefetch "
              f"{r['prefetch']}; the device step {step_ms:.3f} ms "
              f"({device_img_s:.1f} img/s on the device alone) [{card}]",
              flush=True)
    # (d) no hidden fallback: the pipelined loop read native batches and,
    # on the card, every batch came through the CUDA-stream stage
    check(piped["routes"] == ["native"],
          f"pipelined loop routes {piped['routes']}")
    check(serial["routes"] == ["python"],
          f"serial loop routes {serial['routes']}")
    if cuda:
        check(piped["prefetch"] == "cuda-stream"
              and piped["staged"] >= LOOP_STEPS,
              f"prefetch stage {piped['prefetch']}, {piped['staged']} "
              f"batches staged for {LOOP_STEPS} steps")
    want = {k: 0 for k in piped["launches"]}
    want.update({"lrn_fwd": 2 * LOOP_STEPS, "lrn_bwd": 2 * LOOP_STEPS,
                 "pool_bwd": 3 * LOOP_STEPS, "sgd_update": LOOP_STEPS})
    if cuda:
        check(piped["launches"] == want,
              f"pipelined loop launches {piped['launches']} != {want}")
    print(f"[loop] (d) pipelined loop: routes {piped['routes']}, prefetch "
          f"{piped['prefetch']} ({piped['staged']} batches staged), "
          f"launches {piped['launches']} in {LOOP_STEPS} steps (2/2/3/1 a "
          f"step)", flush=True)
    loop_bitwise(card, root, device, batch_size)
    out = {"host_cpu_count": os.cpu_count(), "batchers_img_s": batchers,
           "serial": serial, "pipelined": piped, "device_step_ms": step_ms,
           "device_img_s": device_img_s,
           "wall_s": time.perf_counter() - t_phase}
    print(f"[loop] phase wall {out['wall_s']:.1f} s", flush=True)
    return out


def phase_layout(card: str):
    """[layout]: K4-, K5- and K6-NHWC against their plain versions on the
    same channels-last tensors at AlexNet's norm1, norm2, pool1, pool2 and
    pool5 at batch 256, f32 and bf16, each bitwise (the run fails
    otherwise), with its time, its bytes bound and the library call on the
    same tensor; then conv1's forward and backward with and without the
    space-to-depth rewrite in bf16 and NHWC. Returns (K4-NHWC records,
    K5-NHWC records, K6-NHWC records, the conv1 timings,
    ``layout_kernel_report``'s attributes, powf floors, library ratios and
    K4-NHWC's bf16 pair at both lane widths)."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.numeric import policy_scope
    from poseidon_tpu_torch.ops import lrn, pool
    from poseidon_tpu_torch.ops.nn import conv2d

    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    rand = lambda shape, dt: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda").to(dt).contiguous(
            memory_format=cl)
    args = (5, LRN_ALPHA, LRN_BETA, LRN_K)
    k4, k5, k6 = [], [], []
    for label, shape in (("norm1", (256, 96, 55, 55)),
                         ("norm2", (256, 256, 27, 27))):
        for dt in (f32, bf16):
            name = str(dt).replace("torch.", "")
            x, g = rand(shape, dt), rand(shape, dt)
            y = lrn.lrn_fwd_nhwc_cuda(x, *args)
            torch.cuda.synchronize()
            want = lrn.lrn_across_channels_plain(x, *args)
            bitwise = torch.equal(y, want)
            check(y.is_contiguous(memory_format=cl),
                  f"lrn_fwd_nhwc {label}: output not channels-last")
            rec = compare_case(
                "lrn_fwd_nhwc", label, y, want, name,
                lambda: lrn.lrn_fwd_nhwc_cuda(x, *args),
                lambda: lrn.lrn_across_channels_plain(x, *args),
                lambda: F.local_response_norm(x, *args),
                2 * x.numel() * x.element_size(), x.numel() * (2 * 5 + 4),
                card, extra=f" {tuple(shape)} channels-last "
                            f"bitwise={bitwise}")
            rec.update(shape=list(shape), bitwise=bitwise)
            k4.append(rec)
            check(bitwise, f"lrn_fwd_nhwc {label} {name}: not bitwise equal "
                           f"to the plain version")
            dx = lrn.lrn_bwd_nhwc_cuda(x, g, *args)
            torch.cuda.synchronize()
            want = lrn.lrn_bwd_plain(x, g, *args)
            bitwise = torch.equal(dx, want)
            xr = x.detach().requires_grad_(True)
            yr = F.local_response_norm(xr, *args)
            rec = compare_case(
                "lrn_bwd_nhwc", label, dx, want, name,
                lambda: lrn.lrn_bwd_nhwc_cuda(x, g, *args),
                lambda: lrn.lrn_bwd_plain(x, g, *args),
                lambda: torch.autograd.grad(yr, xr, g, retain_graph=True),
                3 * x.numel() * x.element_size(), x.numel() * (3 * 5 + 10),
                card, extra=f" {tuple(shape)} channels-last "
                            f"bitwise={bitwise}")
            rec.update(shape=list(shape), bitwise=bitwise)
            k5.append(rec)
            check(bitwise, f"lrn_bwd_nhwc {label} {name}: not bitwise equal "
                           f"to the plain version")
            del x, g, y, dx, want, xr, yr
            torch.cuda.empty_cache()
    for label, shape in LAYOUT_POOLS:
        for dt in (f32, bf16):
            name = str(dt).replace("torch.", "")
            geom = ((3, 3), (2, 2), (0, 0))
            x = rand(shape, dt)
            y = pool.pool_forward(x, *geom, "max")
            check(y.is_contiguous(memory_format=cl),
                  f"{label}: the pooling forward left channels-last")
            g = rand(y.shape, dt)
            dx = pool.pool_bwd_nhwc_cuda(x, g, *geom, "max")
            torch.cuda.synchronize()
            want = pool.pool_bwd_plain(x, g, *geom, "max")
            again = pool.pool_bwd_nhwc_cuda(x, g, *geom, "max")
            bitwise = torch.equal(dx, want)
            check(torch.equal(dx, again), f"pool_bwd_nhwc {label}: a second "
                                          f"launch differs from the first")
            _, idx = F.max_pool2d(x, 3, 2, 0, ceil_mode=True,
                                  return_indices=True)
            library = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731,E501
                g, x, [3, 3], [2, 2], [0, 0], [1, 1], True, idx)
            rec = compare_case(
                "pool_bwd_nhwc", label, dx, want, name,
                lambda: pool.pool_bwd_nhwc_cuda(x, g, *geom, "max"),
                lambda: pool.pool_bwd_plain(x, g, *geom, "max"), library,
                (2 * x.numel() + g.numel()) * x.element_size(),
                g.numel() * 9 * 2, card,
                extra=f" max {tuple(shape)}->{tuple(y.shape[2:])} "
                      f"channels-last bitwise={bitwise}")
            rec.update(shape=list(shape), method="max", bitwise=bitwise)
            k6.append(rec)
            check(bitwise, f"pool_bwd_nhwc {label} {name}: not bitwise "
                           f"equal to the plain version")
            del x, y, g, dx, want, again, idx, library
            torch.cuda.empty_cache()
    extra = layout_kernel_report(card, k4, k5, k6)

    # conv1 forward + backward in bf16, NHWC, with and without s2d
    x = rand((256, 3, 227, 227), f32)
    w = (torch.randn((96, 3, 11, 11), generator=gen, device="cuda") / 11
         ).requires_grad_(True)
    b = torch.zeros(96, device="cuda", requires_grad=True)
    conv1 = {}
    with policy_scope(compute_dtype=bf16):
        outs = {}
        for strategy in ("direct", "s2d"):
            def fwd_bwd(strategy=strategy):
                y = conv2d(x, w, b, (4, 4), (0, 0), act="relu",
                           strategy=strategy)
                torch.autograd.grad(y, (w, b), torch.ones_like(y))
                return y

            outs[strategy] = fwd_bwd().float()
            fwd = lambda strategy=strategy: conv2d(  # noqa: E731
                x, w, b, (4, 4), (0, 0), act="relu", strategy=strategy)
            conv1[strategy] = {"fwd_bwd_ms": cuda_time_ms(fwd_bwd),
                               "fwd_ms": cuda_time_ms(fwd)}
            check(outs[strategy].is_contiguous(memory_format=cl),
                  f"conv1 {strategy}: output not channels-last")
    scale = float(outs["direct"].abs().max())
    diff = float((outs["s2d"] - outs["direct"]).abs().max())
    check(diff <= BF16_CONV_TOL * scale, f"conv1 s2d vs direct in bf16: "
          f"max_abs {diff} of {scale}")
    conv1["s2d_vs_direct_max_abs"] = diff
    print(f"[layout] conv1 (96x3x11x11/s4 at 227, batch 256) bf16 NHWC: "
          f"direct forward {conv1['direct']['fwd_ms']:.4f} ms, forward + "
          f"backward {conv1['direct']['fwd_bwd_ms']:.4f} ms; s2d forward "
          f"{conv1['s2d']['fwd_ms']:.4f} ms, forward + backward "
          f"{conv1['s2d']['fwd_bwd_ms']:.4f} ms; s2d vs direct max_abs "
          f"{diff:.3e} of {scale:.3e} (limit {BF16_CONV_TOL:g} of it) "
          f"[{card}]", flush=True)
    del x, w, b, outs
    torch.cuda.empty_cache()
    return k4, k5, k6, conv1, extra


LAYOUT_POOLS = (("pool1", (256, 96, 55, 55)), ("pool2", (256, 256, 27, 27)),
                ("pool5", (256, 256, 13, 13)))


def lrn_fwd_width_report(card: str) -> dict:
    """K4-NHWC's bf16 pair (norm1 + norm2 at batch 256) at 8 and at 4
    channels a lane (16 and 8 bytes), timed in turns (8, 4, 4, 8) on the
    same tensors, each width bitwise equal to the plain version; returns
    {channels a lane: [ms, ms]}."""
    import torch
    from poseidon_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(12)
    args = (5, LRN_ALPHA, LRN_BETA, LRN_K)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for shape in ((256, 96, 55, 55), (256, 256, 27, 27))]
    for x in xs:
        want = lrn.lrn_across_channels_plain(x, *args)
        for v in (8, 4):
            y = lrn.lrn_fwd_nhwc_cuda(x, *args, lane_channels=v)
            torch.cuda.synchronize()
            check(torch.equal(y, want), f"lrn_fwd_nhwc {tuple(x.shape)} "
                  f"bfloat16 at {v} channels a lane: not bitwise equal to "
                  f"the plain version")
        del want, y
    torch.cuda.empty_cache()
    ms = {8: [], 4: []}
    for v in (8, 4, 4, 8):
        ms[v].append(sum(cuda_time_ms(
            lambda x=x, v=v: lrn.lrn_fwd_nhwc_cuda(
                x, *args, lane_channels=v))
            for x in xs))
    print(f"[layout] lrn_fwd_nhwc bfloat16 pair in turns: 8 channels a lane "
          f"(16 bytes) {ms[8][0]:.4f}, {ms[8][1]:.4f} ms; 4 channels a lane "
          f"(8 bytes) {ms[4][0]:.4f}, {ms[4][1]:.4f} ms; bitwise at both "
          f"[{card}]", flush=True)
    return ms


def layout_kernel_report(card: str, k4, k5, k6) -> dict:
    """[layout]'s K4-, K5- and K6-NHWC attributes at AlexNet's shapes (K4:
    4 f32 channels a lane, 4 and 8 bf16; K5: 4 channels a lane; K6:
    16-byte vectors, 4 f32 or 8 bf16 channels), K4-NHWC's bf16 pair at
    both widths (``lrn_fwd_width_report``), the powf floors (the powf of
    the LRN pair's elements alone, from registers: one an element beside
    K4-NHWC's pair, two beside K5-NHWC's, the least time each kernel's
    unchanged arithmetic allows) with each pair's bytes bound, and each
    NHWC kernel's time over its library call's in this run, the yardstick
    that holds between calls."""
    import torch
    from poseidon_tpu_torch.ops import lrn, pool

    f32, bf16 = torch.float32, torch.bfloat16
    attrs = {}
    for dt, vecs in ((f32, (4,)), (bf16, (4, 8))):
        name = str(dt).replace("torch.", "")
        for vec in vecs:
            a = attrs[f"lrn_fwd_nhwc {name} {vec} a lane"] = \
                lrn.lrn_fwd_nhwc_kernel_attrs(dt, vec, 5)
            print(f"[layout] lrn_nhwc_fwd_kernel {name} ({vec} channels a "
                  f"lane, n=5): {a['registers']} registers, "
                  f"{a['local_bytes']} B spilled a thread, "
                  f"{a['static_smem_bytes']} + {a['dynamic_smem_bytes']} B "
                  f"shared, {a['blocks_per_sm']} blocks of {a['threads']} "
                  f"threads an SM [{card}]", flush=True)
            check(a["static_smem_bytes"] == a["dynamic_smem_bytes"] == 0
                  and a["local_bytes"] == 0, f"lrn_nhwc_fwd_kernel {name} "
                  f"at {vec} a lane takes shared memory or spills: {a}")
        vec = lrn.MAX_NHWC_LANE_CHANNELS
        a = attrs[f"lrn_bwd_nhwc {name}"] = lrn.lrn_bwd_nhwc_kernel_attrs(
            dt, vec, 5)
        print(f"[layout] lrn_nhwc_bwd_kernel {name} ({vec} channels a lane, "
              f"n=5): {a['registers']} registers, {a['local_bytes']} B "
              f"spilled a thread, {a['static_smem_bytes']} + "
              f"{a['dynamic_smem_bytes']} B shared, {a['blocks_per_sm']} "
              f"blocks of {a['threads']} threads an SM [{card}]", flush=True)
        for label, shape in LAYOUT_POOLS:
            a = attrs[f"pool_bwd_nhwc {label} {name}"] = \
                pool.pool_bwd_nhwc_kernel_attrs(dt, "max", shape, (3, 3),
                                                (2, 2), (0, 0))
            print(f"[layout] pool_nhwc_band_kernel {label} {name}: "
                  f"{a['registers']} registers, {a['dynamic_smem_bytes']} B "
                  f"dynamic shared ({a['vec']} channels a vector, "
                  f"{a['group_vecs']} vectors a group, {a['n_groups']} "
                  f"groups, bands of {a['band_rows']} rows x "
                  f"{a['n_bands']}), {a['local_bytes']} B spilled a thread, "
                  f"{a['blocks_per_sm']} blocks of {a['threads']} threads "
                  f"an SM [{card}]", flush=True)
    widths = lrn_fwd_width_report(card)
    n_elems = sum(math.prod(r["shape"]) for r in k5
                  if r["dtype"] == "float32")
    floors = {}
    for powfs, kernel, recs in ((1, "K4-NHWC", k4), (2, "K5-NHWC", k5)):
        floor_ms = floors[powfs] = cuda_time_ms(
            lambda powfs=powfs: lrn.lrn_powf_floor_cuda(
                n_elems, 5, LRN_ALPHA, LRN_BETA, LRN_K, powfs=powfs))
        pair = {r["dtype"]: sum(q["ms"] for q in recs
                                if q["dtype"] == r["dtype"]) for r in recs}
        bound = {dt: bound_ms(sum(q["bytes"] for q in recs
                                  if q["dtype"] == dt),
                              sum(q["ops"] for q in recs if q["dtype"] == dt),
                              dt)[0] for dt in pair}
        print(f"[layout] powf floor: {'the' if powfs == 1 else 'the two'} "
              f"powf an element of the LRN pair's {n_elems} elements alone, "
              f"from registers, {floor_ms:.4f} ms; {kernel} pair float32 "
              f"{pair['float32']:.4f} ms (bytes bound "
              f"{bound['float32']:.4f}), bfloat16 {pair['bfloat16']:.4f} ms "
              f"(bytes bound {bound['bfloat16']:.4f}) [{card}]", flush=True)
    ratios = {}
    for name, recs in (("lrn_fwd_nhwc", k4), ("lrn_bwd_nhwc", k5),
                       ("pool_bwd_nhwc", k6)):
        for dt in ("float32", "bfloat16"):
            main = [r for r in recs if r["dtype"] == dt]
            ms = sum(r["ms"] for r in main)
            lib = sum(r["library_ms"] for r in main)
            ratios[f"{name} {dt}"] = ms / lib
            print(f"[layout] {name} {dt}: {ms:.4f} ms against the library's "
                  f"{lib:.4f} ms in this run: {ms / lib:.3f}x [{card}]",
                  flush=True)
    return {"attributes": attrs, "powf_floor_ms": floors[2],
            "powf_floor_1_ms": floors[1], "powf_floor_elements": n_elems,
            "library_ratio": ratios, "lrn_fwd_nhwc_bf16_widths": widths}


def phase_bf16_train(card: str, root: str, f32: dict, device=None,
                     batch_size=None) -> dict:
    """[bf16_train]: AlexNet train_val at batch 256 under ``--bf16``'s
    policy (bf16 compute, s2d on) planned NHWC, through Engine.train() on
    [train]'s synthetic LMDB; ``f32`` is [train]'s result (the f32 NCHW
    step of this call). ``device`` and ``batch_size`` are for a CPU
    rehearsal at a cut batch only."""
    import torch
    from poseidon_tpu_torch.numeric import policy_scope
    from poseidon_tpu_torch.runtime.engine import Engine

    t_phase = time.perf_counter()
    cuda = torch.device(device or "cuda").type == "cuda"
    out = {}
    with policy_scope(compute_dtype=torch.bfloat16, conv_s2d=True,
                      conv_layout="NHWC"):
        sp = alexnet_solver(root, batch_size, write=False,
                            iters=BF16_TRAIN_ITERS,
                            test_interval=BF16_TEST_INTERVAL,
                            prefix="alexnet_bf16")
        eng = Engine(sp, output_dir=root, device=device)
        try:
            net = eng.train_net
            check(net.conv_layout == "NHWC", f"bf16 net planned "
                                             f"{net.conv_layout}")
            print(f"[bf16_train] AlexNet train net on {eng.device}: "
                  f"{net.param_count()} params, batch "
                  f"{net.blob_shapes['data']}, bf16 compute, conv_s2d on, "
                  f"NHWC (channels-last) [{card}]", flush=True)
            zero_launches()
            eng.train()
            sync(eng.device)
            counts = read_launches()
            steps = eng.stats["train_iters"]
            test_fwd = TEST_ITER * (1 + BF16_TRAIN_ITERS
                                    // BF16_TEST_INTERVAL)
            want = {k: 0 for k in counts}
            if cuda:
                want.update({"lrn_fwd_nhwc": 2 * (steps + test_fwd),
                             "lrn_bwd_nhwc": 2 * steps,
                             "pool_bwd_nhwc": 3 * steps,
                             "sgd_update": steps})
            print(f"[bf16_train] Engine.train(): {steps} steps + {test_fwd} "
                  f"test forwards; launches {counts} (expected {want})",
                  flush=True)
            check(steps == BF16_TRAIN_ITERS, f"trained {steps} steps")
            check(counts == want, f"bf16 launch counts {counts} != {want}")
            batch = eng._next_batch(eng.train_pipelines)
            with torch.no_grad():
                blobs = net.apply(eng.params, batch, train=True,
                                  keep_blobs=True).blobs
            for name in ("conv1", "norm1", "pool1", "conv5", "pool5"):
                check(blobs[name].dtype == torch.bfloat16,
                      f"{name} is {blobs[name].dtype} under bf16")
                check(blobs[name].is_contiguous(
                          memory_format=torch.channels_last),
                      f"{name} is not channels-last under NHWC")
            del blobs
            out["max_param_diff_vs_plain"] = phase_step_vs_plain(
                eng, batch, BF16_STEP_TOL, "bf16_train")
            if cuda:
                prof = phase_train_profile(eng, batch, card, "bf16_train",
                                           CNN_NHWC_KERNEL_NAMES)
                out.update(prof)
                speedup = f32["step_ms"] / prof["step_ms"]
                print(f"[bf16_train] device step {prof['step_ms']:.3f} ms "
                      f"(bf16, NHWC) vs {f32['step_ms']:.3f} ms (f32, NCHW, "
                      f"[train] of this run): {speedup:.3f}x; transpose "
                      f"kernels a step {prof['transpose_launches']}"
                      f" vs {f32['transpose_launches']}, copy kernels "
                      f"{prof['copy_launches']} vs {f32['copy_launches']}; "
                      f"peak device memory {prof['peak_bytes'] / 2**30:.2f} "
                      f"vs {f32['peak_bytes'] / 2**30:.2f} GiB [{card}]",
                      flush=True)
                check(prof["transpose_launches"] < f32["transpose_launches"],
                      f"the NHWC step runs {prof['transpose_launches']} "
                      f"transpose kernels, the NCHW one "
                      f"{f32['transpose_launches']}")
            out["launches"] = counts
        finally:
            eng.close()
        # the loop's img/s through the uint8 device transform
        loop = run_loop(root, device, batch_size, LOOP_STEPS, LOOP_WARMUP,
                        mean_values=LOOP_MEAN_VALUES, device_prefetch=2,
                        max_in_flight=2, device_transform=True)
    loop_want = {k: 0 for k in loop["launches"]}
    if cuda:
        loop_want.update({"lrn_fwd_nhwc": 2 * LOOP_STEPS,
                          "lrn_bwd_nhwc": 2 * LOOP_STEPS,
                          "pool_bwd_nhwc": 3 * LOOP_STEPS,
                          "sgd_update": LOOP_STEPS})
    print(f"[bf16_train] pipelined loop (native uint8 batches, the device "
          f"transform, prefetch 2, window 2; mean_value variant of the data "
          f"layer): {loop['img_s']:.1f} img/s over steps "
          f"{LOOP_WARMUP}-{LOOP_WARMUP + loop['steps'] - 1}, data-wait share "
          f"{loop['data_wait_share']:.3f}, routes {loop['routes']}, prefetch "
          f"{loop['prefetch']}; launches {loop['launches']} [{card}]",
          flush=True)
    check(loop["routes"] == ["native-u8"], f"bf16 loop routes "
                                           f"{loop['routes']}")
    if cuda:
        check(loop["launches"] == loop_want,
              f"bf16 loop launches {loop['launches']} != {loop_want}")
    out["loop"] = loop
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[bf16_train] phase wall {out['wall_s']:.1f} s", flush=True)
    return out


def tree_equal(a, b) -> bool:
    import torch
    return all(torch.equal(a[l][k], b[l][k]) for l in a for k in a[l])


def tree_max_abs(a, b) -> float:
    return max(float((a[l][k] - b[l][k]).abs().max()) for l in a
               for k in a[l])


def phase_dp(card: str, root: str, device=None, batch_size=None,
             cli_batch=None) -> dict:
    """Data-parallel AlexNet on the card (``device``, ``batch_size`` and
    ``cli_batch`` are for a CPU rehearsal at a cut batch only):

    1. a one-rank process group (NCCL on the card) in this process: the
       DENSE step (4 MB DWBP buckets) against the one-device step from the
       same params, momentum and batch, bitwise for DP_STEPS steps, its
       K4-K7 launches counted (zeroed just before, read just after); SFB on
       the auto picks against DENSE after one step; the device step of
       DENSE, DENSE_FUSED and the one-device step in turns; from the issue
       events, the buckets issued mid-backward and each one's window to
       the end of backward;
    2. two ``python -m poseidon_tpu_torch train`` processes on the one card
       (gloo: they share it) under the launcher env contract, for each of
       DP_CLI_RUNS: both exit 0, their snapshots are bitwise equal, every
       loss finite; the wall time a step."""
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.data.pipeline import build_phase_pipelines
    from poseidon_tpu_torch.numeric import resolve_device
    from poseidon_tpu_torch.parallel.strategies import (
        DENSE_FUSED, CommConfig, auto_strategies)
    from poseidon_tpu_torch.parallel.trainer import (TrainStep,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import load_solver
    from poseidon_tpu_torch.runtime.cluster import init_distributed

    t_phase = time.perf_counter()
    dev = resolve_device(device)
    net_param = alexnet_net_param(root, batch_size or DP_BATCH)
    pipes, shapes = build_phase_pipelines(net_param, "TRAIN")
    try:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipes[0]).items()}
    finally:
        for p in pipes:
            p.close()
    net = Net(net_param, "TRAIN", device=dev, source_shapes=shapes)
    sp = load_solver(ALEXNET_SOLVER)
    params0 = net.init(torch.Generator().manual_seed(1))
    state0 = init_train_state(params0)
    group = init_distributed(dev, rank=0, world=1, coordinator=(
        "file://" + os.path.join(root, "dp_store")))
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    check(group.backend == want_backend,
          f"one-rank group on {dev}: backend {group.backend}")

    def run(step, n):
        """n steps from params0; the losses and clones of the params and
        momentum after the first and the last."""
        net.generator.manual_seed(7)
        params, state = step.load(params0, state0)
        losses, kept = [], {}
        for k in range(n):
            params, state, m = step.step(params, state, batch)
            losses.append(float(m["loss"]))
            if k in (0, n - 1):
                kept[k + 1] = (tree_clone(params),
                               tree_clone(state.solver.history))
        return losses, kept

    def device_step_ms(step) -> float:
        params, state = step.load(params0, state0)
        for _ in range(2):
            params, state, _m = step.step(params, state, batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_STEPS):
            params, state, _m = step.step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / TIMED_STEPS

    out = {"batch": shapes["data"][0], "backend": group.backend}
    try:
        one = TrainStep(net, sp)
        dense = TrainStep(net, sp, group, CommConfig())
        n_buckets = len(dense.sync.hooked)
        print(f"[dp] one-rank {group.backend} group on {dev}: AlexNet "
              f"{net.param_count()} params, batch {out['batch']}, "
              f"{n_buckets} DWBP buckets of 4 MB [{card}]", flush=True)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            ref_losses, ref = run(one, DP_STEPS)
            zero_launches()
            losses, got = run(dense, DP_STEPS)
            sync(dev)
            launches = read_launches()
            sfb_comm = CommConfig(layer_strategies=auto_strategies(net))
            sfb = TrainStep(net, sp, group, sfb_comm)
            sfb_losses, sfb_got = run(sfb, 1)
            del sfb
        finally:
            torch.backends.cudnn.deterministic = deterministic
        on_card = dev.type == "cuda"
        want = {k: 0 for k in launches}
        if on_card:
            want.update(lrn_fwd=2 * DP_STEPS, lrn_bwd=2 * DP_STEPS,
                        pool_bwd=3 * DP_STEPS, sgd_update=DP_STEPS)
        print(f"[dp] DENSE, {DP_STEPS} steps: launches {launches} "
              f"(expected {want}) [{card}]", flush=True)
        check(launches == want, f"dp launches {launches} != {want}")
        check(all(math.isfinite(x) for x in losses), f"dp losses {losses}")
        bitwise = (losses == ref_losses and all(
            tree_equal(got[k][i], ref[k][i]) for k in got for i in (0, 1)))
        print(f"[dp] one-rank DENSE vs the one-device step, {DP_STEPS} "
              f"steps (cuDNN deterministic): losses {losses} vs "
              f"{ref_losses}; params and momentum bitwise={bitwise} "
              f"[{card}]", flush=True)
        check(bitwise, "one-rank DENSE step differs from the one-device "
                       "step: max_abs " + str(max(
                           tree_max_abs(got[k][i], ref[k][i])
                           for k in got for i in (0, 1))))
        rtol, atol = DP_SFB_TOL
        sfb_err = max(tree_max_abs(sfb_got[1][i], got[1][i]) for i in (0, 1))
        sfb_ok = all(bool(torch.allclose(sfb_got[1][i][l][k],
                                         got[1][i][l][k], rtol=rtol,
                                         atol=atol))
                     for i in (0, 1) for l in got[1][i] for k in got[1][i][l])
        print(f"[dp] SFB on {sorted(sfb_comm.layer_strategies)} vs DENSE "
              f"after one step: loss {sfb_losses[0]!r} vs {losses[0]!r}, "
              f"max_abs {sfb_err:.3e} (rtol {rtol:g}, atol {atol:g}) "
              f"[{card}]", flush=True)
        check(sfb_ok and abs(sfb_losses[0] - losses[0])
              <= atol + rtol * abs(losses[0]),
              f"SFB vs DENSE after one step: max_abs {sfb_err}")
        del got, ref, sfb_got
        out.update(launches=launches, losses=losses, bitwise=bitwise,
                   sfb_max_abs_err=sfb_err, n_buckets=n_buckets)

        if on_card:
            # in turns, each after two warm-up steps
            times = {}
            for name, step in (("one_device", one), ("dense", dense),
                               ("dense_fused", None), ("dense_2", dense),
                               ("one_device_2", one)):
                if step is None:
                    step = TrainStep(net, sp, group, CommConfig(
                        default_strategy=DENSE_FUSED))
                times[name] = device_step_ms(step)
            out["step_ms"] = times
        # the buckets issued while backward still ran (a warm step):
        # host-side by the hooks, and on the card each one's window from
        # its issue to the end of backward by CUDA events
        first = next(l for l in net.layers if l.params).name
        first_slots = {i for i, s in enumerate(dense.arena.slots)
                       if s.layer == first}
        n_first = sum(1 for b in dense.sync.hooked
                      if first_slots & set(b.leaves))
        params, state = dense.load(params0, state0)
        params, state, _m = dense.step(params, state, batch)
        windows = []
        if on_card:
            windows = issue_windows_ms(dense, params, state, batch)
        else:
            dense.step(params, state, batch)
        mid = dense.sync.issued_mid_backward
        check(dense.sync.issued == list(range(n_buckets)),
              f"buckets issued out of DWBP order: {dense.sync.issued}")
        check(mid >= n_buckets - n_first,
              f"{mid} of {n_buckets} buckets issued mid-backward (the "
              f"first layer's are in {n_first})")
        out.update(issued_mid_backward=mid, windows_ms=windows)
        if on_card:
            check(len(windows) == n_buckets and windows[0] > 0,
                  f"issue windows {windows}")
            print(f"[dp] each bucket's window from its issue to the end of "
                  f"backward (ms, CUDA events, bucket 0 first): "
                  f"{[round(w, 3) for w in windows]} [{card}]", flush=True)
        del one, dense
    finally:
        group.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["two_ranks"] = {name: without_logs(dp_cli_run(
        card, root, name, flags, dev, cli_batch or DP_CLI_BATCH))
        for name, flags in DP_CLI_RUNS}
    out["wall_s"] = time.perf_counter() - t_phase
    t = out.get("step_ms", {})
    print("[dp] " + (
        f"device step (CUDA events, {TIMED_STEPS} steps, batch "
        f"{out['batch']}): one-device {t['one_device']:.3f} / "
        f"{t['one_device_2']:.3f} ms, one-rank NCCL DENSE "
        f"{t['dense']:.3f} / {t['dense_2']:.3f} ms, DENSE_FUSED "
        f"{t['dense_fused']:.3f} ms; buckets issued mid-backward "
        f"{out['issued_mid_backward']} of {out['n_buckets']}, the first "
        f"{out['windows_ms'][0]:.3f} ms and the last "
        f"{out['windows_ms'][-1]:.3f} ms before the end of backward; "
        if t else "")
        + "two ranks on one card over gloo, batch "
        f"{cli_batch or DP_CLI_BATCH} a rank: " + ", ".join(
            f"{name} {r['s_per_step']:.3f} s/step"
            for name, r in out["two_ranks"].items())
        + f"; phase wall {out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def issue_windows_ms(step, params, state, batch) -> list:
    """One data-parallel step with a CUDA event recorded at each bucket's
    issue and one at the end of backward (as the sync's ``finish``
    starts); per issued bucket, the ms from its issue to the end of
    backward."""
    import torch
    sync = step.sync
    issues, end = [], torch.cuda.Event(enable_timing=True)

    def issue(bucket, _issue=sync._issue):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        issues.append(ev)
        _issue(bucket)

    def finish(_finish=sync.finish):
        end.record()
        _finish()

    sync._issue, sync.finish = issue, finish
    try:
        step.step(params, state, batch)
    finally:
        del sync._issue, sync.finish        # back to the class's methods
    end.synchronize()
    return [ev.elapsed_time(end) for ev in issues]


def without_logs(run: dict) -> dict:
    """A ``dp_cli_run`` result for the summary line (the logs are printed
    already)."""
    return {k: v for k, v in run.items() if k != "logs"}


def dp_cli_run(card: str, root: str, name: str, flags, dev, batch: int,
               ranks: int = 2, tag: str = "dp", iters: int = DP_CLI_ITERS,
               env_extra=None, group: bool = True,
               same_snapshots: bool = True) -> dict:
    """``ranks`` ``train`` processes of the port under the env contract,
    sharing the card (or the CPU), each reporting its kernel launches
    when it returns (``LAUNCH_REPORT``); with ``same_snapshots`` their
    snapshots must be bitwise equal, with ``group`` they must have formed
    a gloo group. The result names the first rank's snapshot
    (``state_path``), every rank's log and launches."""
    import numpy as np
    from poseidon_tpu_torch.proto.messages import (load_solver,
                                                   net_to_prototxt,
                                                   solver_to_prototxt)

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, f"{tag}_{name}")
    os.makedirs(work)
    net_file = os.path.join(work, "train_val.prototxt")
    net_param = alexnet_net_param(root, batch)
    with open(net_file, "w") as f:
        f.write(net_to_prototxt(net_param))
    sp = load_solver(ALEXNET_SOLVER)
    sp.net, sp.max_iter, sp.display = net_file, iters, 1
    sp.test_iter, sp.test_interval, sp.snapshot = [], 0, 0
    sp.snapshot_prefix = "alexnet"
    solver = os.path.join(work, "solver.prototxt")
    with open(solver, "w") as f:
        f.write(solver_to_prototxt(sp))
    procs = []
    t0 = time.perf_counter()
    for r in range(ranks):
        env = dict(os.environ, POSEIDON_PROC_ID=str(r),
                   POSEIDON_NUM_PROCS=str(ranks),
                   POSEIDON_COORDINATOR="file://"
                   + os.path.join(work, "store"), **(env_extra or {}))
        cmd = [sys.executable, "-c", LAUNCH_REPORT, "train",
               f"--solver={solver}", "--output_dir",
               os.path.join(work, f"p{r}"), *flags]
        if dev.type == "cpu":
            cmd += ["--device", "cpu"]
        procs.append(subprocess.Popen(cmd, cwd=here, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_CLI_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, log in enumerate(logs):
        for line in log.splitlines():
            print(f"[{tag}:{name}:rank{r}] {line}", flush=True)
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{tag} {name} rank {r} exited "
                                 f"{p.returncode}")
    check(not group or "backend gloo" in logs[0],
          f"{tag} {name}: {ranks} ranks sharing {dev.type} did not choose "
          f"gloo")
    launches = []
    for r, log in enumerate(logs):
        lines = [ln for ln in log.splitlines()
                 if ln.startswith("[launches] ")]
        check(len(lines) == 1, f"{tag} {name} rank {r}: no launch report")
        launches.append(json.loads(lines[0][len("[launches] "):]))
    stem = f"alexnet_iter_{iters}"
    first, *rest = (os.path.join(work, f"p{r}", stem) for r in range(ranks))
    same = True
    for other in (rest if same_snapshots else ()):
        with np.load(first + ".solverstate.npz") as za, \
                np.load(other + ".solverstate.npz") as zb:
            check(sorted(za.files) == sorted(zb.files),
                  "snapshot keys differ")
            same = same and all(np.array_equal(za[k], zb[k])
                                for k in za.files)
        with open(first + ".caffemodel", "rb") as fa, \
                open(other + ".caffemodel", "rb") as fb:
            same = same and fa.read() == fb.read()
    check(same, f"{tag} {name}: the {ranks} ranks' snapshots differ")
    with open(os.path.join(work, "p0",
                           f"{net_param.name}_train_outputs.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    check(len(losses) == iters and all(map(math.isfinite, losses)),
          f"{tag} {name} losses {losses}")
    times = [float(r["time"]) for r in rows]
    s_per_step = (times[-1] - times[0]) / (len(times) - 1)
    print(f"[{tag}] {ranks} ranks, {' '.join(flags) or 'dense'}, batch "
          f"{batch} a rank on one {dev.type} device"
          f"{' over gloo' if group else ''}: all exit 0 in {wall:.1f} s, "
          f"snapshots {stem}{' bitwise equal' if same_snapshots else ''}, "
          f"losses {losses}, {s_per_step:.3f} s a step after the first "
          f"[{card}]", flush=True)
    return {"losses": losses, "s_per_step": s_per_step, "wall_s": wall,
            "state_path": first + ".solverstate.npz", "logs": logs,
            "launches": launches}


def phase_topk(card: str, root: str, device=None, batch_size=None,
               cli_batch=None) -> dict:
    """TOPK managed communication and the two-tier group on the card
    (``device``, ``batch_size`` and ``cli_batch`` are for a CPU rehearsal
    at a cut batch only):

    (a) a one-rank NCCL group: TOPK at fraction 1 on every layer against
        the DENSE step, TOPK_STEPS steps from the same params, momentum,
        batch and dropout seed under cuDNN's deterministic algorithms:
        params and momentum bitwise equal, the residual zero;
    (b) TOPK on TOPK_LAYERS at fraction 0.01, global and blocked: every
        compressed leaf, every step, sends at most k entries, keeps a
        nonzero residual and conserves sent + residual = g + residual
        before, bitwise; K4-K7 launched 2/2/3/1 a step (zeroed just
        before each run, read just after);
    (c) on the card, the device step of DENSE, TOPK-global and
        TOPK-blocked in turns (CUDA events, TIMED_STEPS steps), and
        ``topk_compress`` alone on fc6's weight beside its bytes' bound
        and ``torch.topk`` of the magnitudes alone;
    (d) TOPK_CLI_RANKS ``train --strategy topk --dcn_slices
        TOPK_CLI_SLICES`` processes sharing the card over gloo: all exit
        0, their snapshots bitwise equal, the snapshot's residuals one row
        a slice, the rows different;
    (e) the static comm table (``runtime/comm_stats``) of AlexNet at batch
        256 for DENSE, the SFB auto picks and TOPK on TOPK_TABLE_GROUPS,
        at the H100's published link rates."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.data.pipeline import build_phase_pipelines
    from poseidon_tpu_torch.numeric import resolve_device
    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.parallel.strategies import (TOPK, CommConfig,
                                                        auto_strategies)
    from poseidon_tpu_torch.proto.messages import load_solver
    from poseidon_tpu_torch.runtime.cluster import init_distributed
    from poseidon_tpu_torch.runtime.comm_stats import (comm_summary,
                                                       layer_comm_table)

    t_phase = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    net_param = alexnet_net_param(root, batch_size or TOPK_BATCH)
    pipes, shapes = build_phase_pipelines(net_param, "TRAIN")
    try:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipes[0]).items()}
    finally:
        for p in pipes:
            p.close()
    net = Net(net_param, "TRAIN", device=dev, source_shapes=shapes)
    sp = load_solver(ALEXNET_SOLVER)
    params0 = net.init(torch.Generator().manual_seed(1))
    group = init_distributed(dev, rank=0, world=1, coordinator=(
        "file://" + os.path.join(root, "topk_store")))
    check(group.backend == ("nccl" if on_card else "gloo"),
          f"one-rank group on {dev}: backend {group.backend}")
    fc_topk = {layer: TOPK for layer in TOPK_LAYERS}
    configs = {"dense": CommConfig(),
               "topk_all_1": CommConfig(default_strategy=TOPK,
                                        topk_fraction=1.0),
               "topk_global": CommConfig(layer_strategies=dict(fc_topk)),
               "topk_blocked": CommConfig(layer_strategies=dict(fc_topk),
                                          topk_block=TOPK_BLOCK)}

    def start(step):
        params, state = step.load(params0, T.init_train_state(
            params0, step.comm, step.n_err_groups))
        return params, state

    def run(step, n):
        """n steps from params0 with dropout seed 7: the losses, clones
        of the params and momentum, the last state."""
        net.generator.manual_seed(7)
        params, state = start(step)
        losses = []
        for _ in range(n):
            params, state, m = step.step(params, state, batch)
            losses.append(float(m["loss"]))
        return (losses, tree_clone(params), tree_clone(state.solver.history),
                state)

    def device_step_ms(step) -> float:
        params, state = start(step)
        for _ in range(2):
            params, state, _m = step.step(params, state, batch)
        torch.cuda.synchronize()
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(TIMED_STEPS):
            params, state, _m = step.step(params, state, batch)
        end_ev.record()
        torch.cuda.synchronize()
        return start_ev.elapsed_time(end_ev) / TIMED_STEPS

    compress = T.topk_compress

    def checking(records):
        """``topk_compress`` that records, per call, conservation, the
        count sent against k and whether the residual is nonzero."""
        def wrapped(g, fraction, error, *args, **kw):
            sent, resid = compress(g, fraction, error, *args, **kw)
            records.append({
                "conserved": bool(torch.equal(sent + resid, g + error)),
                "sent": int(torch.count_nonzero(sent)),
                "k": max(1, int(g.numel() * fraction)),
                "resid_nonzero": bool(resid.abs().max() > 0)})
            return sent, resid
        return wrapped

    out = {"batch": shapes["data"][0], "backend": group.backend}
    per_step = ({"lrn_fwd": 2, "lrn_bwd": 2, "pool_bwd": 3, "sgd_update": 1}
                if on_card else {})
    try:
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dense = T.TrainStep(net, sp, group, configs["dense"])
            d_losses, d_params, d_hist, _ = run(dense, TOPK_STEPS)
            all_1 = T.TrainStep(net, sp, group, configs["topk_all_1"])
            a_losses, a_params, a_hist, a_state = run(all_1, TOPK_STEPS)
            resid_zero = all(not bool(v.any()) for lv in
                             a_state.comm_error.values() for v in lv.values())
            del all_1, a_state
            runs = {}
            for name in ("topk_global", "topk_blocked"):
                step = T.TrainStep(net, sp, group, configs[name])
                records = []
                T.topk_compress = checking(records)
                try:
                    zero_launches()
                    losses, *_ = run(step, TOPK_STEPS)
                    sync(dev)
                    launches = read_launches()
                finally:
                    T.topk_compress = compress
                del step
                runs[name] = {"losses": losses, "launches": launches,
                              "records": records}
        finally:
            torch.backends.cudnn.deterministic = deterministic
        bitwise = (a_losses == d_losses and tree_equal(a_params, d_params)
                   and tree_equal(a_hist, d_hist))
        print(f"[topk] (a) one-rank {group.backend} group, AlexNet batch "
              f"{out['batch']}: TOPK at fraction 1 on every layer vs DENSE, "
              f"{TOPK_STEPS} steps (cuDNN deterministic): losses {a_losses} "
              f"vs {d_losses}; params and momentum bitwise={bitwise}, "
              f"residual zero={resid_zero} [{card}]", flush=True)
        check(bitwise, "TOPK at fraction 1 differs from DENSE: max_abs "
              + str(max(tree_max_abs(a_params, d_params),
                        tree_max_abs(a_hist, d_hist))))
        check(resid_zero, "TOPK at fraction 1 left a residual")
        want = {k: 0 for k in read_launches()}
        want.update({k: v * TOPK_STEPS for k, v in per_step.items()})
        for name, r in runs.items():
            recs = r["records"]
            n_leaves = 2 * len(TOPK_LAYERS)
            conserved = sum(x["conserved"] for x in recs)
            within_k = all(x["sent"] <= x["k"] for x in recs)
            nonzero = all(x["resid_nonzero"] for x in recs)
            sent = [x["sent"] for x in recs[:n_leaves]]
            how = ("" if name == "topk_global"
                   else f", blocks of {TOPK_BLOCK}")
            print(f"[topk] (b) {name} on {list(TOPK_LAYERS)} at fraction "
                  f"0.01{how}, {TOPK_STEPS} steps: {conserved}/{len(recs)} "
                  f"leaf-steps "
                  f"conserve sent + residual = g + residual bitwise, sent <= "
                  f"k {within_k}, residual nonzero {nonzero}, step 1 sent "
                  f"{sent} of k {[x['k'] for x in recs[:n_leaves]]}; losses "
                  f"{r['losses']}; launches {r['launches']} (expected "
                  f"{want}) [{card}]", flush=True)
            check(len(recs) == n_leaves * TOPK_STEPS
                  and conserved == len(recs), f"{name}: conservation")
            check(within_k and nonzero, f"{name}: count sent or residual")
            check(all(map(math.isfinite, r["losses"])),
                  f"{name} losses {r['losses']}")
            check(r["launches"] == want,
                  f"{name} launches {r['launches']} != {want}")
        out.update(bitwise=bitwise, losses={
            "dense": d_losses, "topk_all_1": a_losses,
            **{n: r["losses"] for n, r in runs.items()}},
            launches=runs["topk_global"]["launches"],
            launches_blocked=runs["topk_blocked"]["launches"])
        del d_params, d_hist, a_params, a_hist

        if on_card:
            times = {}
            for name in ("dense", "topk_global", "topk_blocked",
                         "topk_blocked_2", "topk_global_2", "dense_2"):
                step = (dense if name.startswith("dense") else
                        T.TrainStep(net, sp, group,
                                    configs[name.removesuffix("_2")]))
                times[name] = device_step_ms(step)
                del step
            out["step_ms"] = times
            w = params0["fc6"]["w"]
            gen = torch.Generator(device=dev).manual_seed(3)
            g = torch.randn(w.shape, generator=gen, device=dev)
            err = 0.1 * torch.randn(w.shape, generator=gen, device=dev)
            k = max(1, int(g.numel() * 0.01))
            least, by = bound_ms(16 * g.numel(), 0)
            out["fc6_compress"] = {
                "entries": g.numel(), "k": k,
                "global_ms": cuda_time_ms(lambda: compress(g, 0.01, err)),
                "blocked_ms": cuda_time_ms(lambda: compress(
                    g, 0.01, err, block=TOPK_BLOCK)),
                "torch_topk_ms": cuda_time_ms(lambda: torch.topk(
                    g.abs().view(-1), k, sorted=False)),
                "bound_ms": least, "bound_by": by}
            c = out["fc6_compress"]
            print(f"[topk] (c) device step (CUDA events, {TIMED_STEPS} "
                  f"steps, batch {out['batch']}, in turns): DENSE "
                  f"{times['dense']:.3f} / {times['dense_2']:.3f} ms, "
                  f"TOPK-global {times['topk_global']:.3f} / "
                  f"{times['topk_global_2']:.3f} ms, TOPK-blocked "
                  f"{times['topk_blocked']:.3f} / "
                  f"{times['topk_blocked_2']:.3f} ms; topk_compress on fc6's "
                  f"weight ({c['entries']} entries, k {c['k']}): global "
                  f"{c['global_ms']:.4f} ms, blocked {c['blocked_ms']:.4f} "
                  f"ms, torch.topk of |x| alone {c['torch_topk_ms']:.4f} ms, "
                  f"bound {least:.4f} ms ({by}: g, residual in, sent, "
                  f"residual out at {HBM_SOURCE}) [{card}]", flush=True)
        del dense
    finally:
        group.close()
    if on_card:
        torch.cuda.empty_cache()

    # (d) ranks in slices over gloo through the CLI
    cli = dp_cli_run(card, root, "two_tier", (
        "--strategy", "topk", "--dcn_slices", str(TOPK_CLI_SLICES)), dev,
        cli_batch or TOPK_CLI_BATCH, ranks=TOPK_CLI_RANKS, tag="topk")
    with np.load(cli["state_path"]) as z:
        errs = {k: z[k] for k in z.files if k.startswith("comm_error/")}
    rows_differ = all(not np.array_equal(v[0], v[1]) for v in errs.values())
    shapes_ok = bool(errs) and all(v.shape[0] == TOPK_CLI_SLICES
                                   for v in errs.values())
    print(f"[topk] (d) {TOPK_CLI_RANKS} ranks in {TOPK_CLI_SLICES} slices "
          f"over gloo: {len(errs)} residual leaves in the snapshot, "
          f"{TOPK_CLI_SLICES} rows each={shapes_ok}, rows differ="
          f"{rows_differ}, {cli['s_per_step']:.3f} s a step [{card}]",
          flush=True)
    check(shapes_ok and rows_differ, "two-tier snapshot residual rows")
    out["two_tier"] = without_logs(cli)
    del out["two_tier"]["state_path"]

    # (e) the static comm table at batch 256
    full = Net(alexnet_net_param(root, TOPK_BATCH), "TRAIN", device="cpu",
               source_shapes={"data": (TOPK_BATCH, 3, 227, 227),
                              "label": (TOPK_BATCH,)})
    table = {}
    for shape in TOPK_TABLE_GROUPS:
        dcn = "dcn" if "dcn" in shape else None
        for name, cfg in (
                ("dense", CommConfig(dcn_axis=dcn)),
                ("sfb-auto", CommConfig(dcn_axis=dcn,
                                        layer_strategies=auto_strategies(
                                            full))),
                ("topk", CommConfig(dcn_axis=dcn, default_strategy=TOPK))):
            key = f"{name} {shape}"
            table[key] = comm_summary(layer_comm_table(full, cfg, shape))
            print(f"[topk] (e) comm_stats, AlexNet batch {TOPK_BATCH} a "
                  f"device, {key}: {table[key]} (bytes a step a device; "
                  f"est_comm_ms at the H100 SXM's published NVLink 450 GB/s "
                  f"and NIC 50 GB/s, not measured)", flush=True)
    out["comm_table"] = table
    out["wall_s"] = time.perf_counter() - t_phase
    t = out.get("step_ms")
    print("[topk] " + (
        f"TOPK at fraction 1 bitwise to DENSE={bitwise}; fc6-fc8 at 0.01 "
        f"conserved, K4-K7 2/2/3/1 a step; device step DENSE "
        f"{t['dense']:.3f}, TOPK-global {t['topk_global']:.3f}, "
        f"TOPK-blocked {t['topk_blocked']:.3f} ms; fc6 compress global "
        f"{out['fc6_compress']['global_ms']:.4f} / blocked "
        f"{out['fc6_compress']['blocked_ms']:.4f} ms (bound "
        f"{out['fc6_compress']['bound_ms']:.4f}); " if t else "")
        + f"{TOPK_CLI_RANKS} gloo ranks in {TOPK_CLI_SLICES} slices "
        f"bitwise, rows differ, {cli['s_per_step']:.3f} s a step; phase "
        f"wall {out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def sum_launches(per_rank) -> dict:
    return {k: sum(r[k] for r in per_rank) for k in per_rank[0]}


ASYNC_TIER_KEYS = ("async_final_clock", "async_gate_blocks",
                   "async_blocked_s", "async_comm_bytes_sent",
                   "async_comm_bytes_recv", "async_comm_partial_pushes",
                   "async_comm_full_pushes", "async_d2h_ms_per_flush",
                   "async_push_ms_per_flush", "async_refresh_ms_per_flush",
                   "async_gate_ms_per_flush", "async_h2d_ms_per_flush")


def async_tier_report(log: str, rank: int) -> dict:
    """The numbers of a rank's ``async-SSP tier (rank r): k=v, ...``
    line."""
    head = f"async-SSP tier (rank {rank}): "
    lines = [ln for ln in log.splitlines() if ln.startswith(head)]
    check(len(lines) == 1, f"rank {rank}: no async-SSP tier report")
    out = {}
    for part in lines[0][len(head):].split(", "):
        k, _, v = part.partition("=")
        if k in ASYNC_TIER_KEYS:
            out[k] = float(v)
    check(sorted(out) == sorted(ASYNC_TIER_KEYS),
          f"rank {rank}: tier report {lines[0]}")
    return out


def phase_ssp(card: str, root: str, device=None, batch_size=None,
              cli_batch=None) -> dict:
    """SSP on the card, both forms (``device``, ``batch_size`` and
    ``cli_batch`` are for a CPU rehearsal at a cut batch only):

    (a) the compiled SSP step (``parallel/trainer.SSPTrainStep``) in this
        process over a one-rank NCCL group, staleness SSP_STALENESS,
        SSP_STEPS steps from the same params, batch and dropout seed under
        cuDNN's deterministic algorithms, in both layouts: NCHW at
        SSP_BATCH, then NHWC at SSP_CLI_BATCH (the layout and batch of the
        ranks of (b) and (c)). In each: DENSE, then TOPK at 0.01 on
        TOPK_LAYERS, each with the kernels (K4-K6, or their NHWC entries,
        and K7 launched exactly 2/2/3/1 a step, zeroed just before, read
        just after) and with their plain versions (no launch), the anchor,
        local params and momentum held at STEP_TOL; DENSE against the
        sync step (one group): the local params after the first period's
        local steps bitwise, the anchor after its boundary, whose fold is
        the identity up to rounding, at STEP_TOL. On the card, NCHW, the
        device ms of a local step, of a boundary step and of the sync
        step, in turns;
    (b) two ``train --staleness SSP_STALENESS`` processes sharing the card
        over gloo, SSP_CLI_ITERS iterations and a snapshot at the end: all
        exit 0 with finite losses, the anchors (.caffemodel) and SSP
        snapshots bitwise equal across ranks, the snapshot ``kind`` "ssp"
        with a row a rank, restored by the port and loaded into an
        ``SSPTrainStep``; each rank launched K4-K6's NHWC entries and K7
        2/2/3/1 a step (an unflagged ``train`` plans NHWC on the card);
    (c) two ``train --async_ssp --staleness 1 --async_sync_every 2``
        processes (rank 0 hosts the ParamService at an explicit
        POSEIDON_ASYNC_SERVICE address behind an HMAC token),
        ASYNC_CLI_ITERS iterations, then again under --comm_budget_mbps
        ASYNC_BUDGET_MBPS: all exit 0 with finite losses and launch
        2/2/3/1 a step as in (b); each worker's
        final clock, gate blocks and blocked seconds, bytes pushed and
        pulled and partial pushes (> 0 in the managed run), and the tier's
        ms a clock (D2H, push enqueue, refresh, gate, H2D)."""
    import socket
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.data.pipeline import build_phase_pipelines
    from poseidon_tpu_torch.numeric import resolve_device
    from poseidon_tpu_torch.parallel import trainer as T
    from poseidon_tpu_torch.parallel.strategies import TOPK, CommConfig
    from poseidon_tpu_torch.proto.messages import load_solver
    from poseidon_tpu_torch.runtime import checkpoint as CK
    from poseidon_tpu_torch.runtime.cluster import init_distributed

    t_phase = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sp = load_solver(ALEXNET_SOLVER)
    group = init_distributed(dev, rank=0, world=1, coordinator=(
        "file://" + os.path.join(root, "ssp_store")))
    check(group.backend == ("nccl" if on_card else "gloo"),
          f"one-rank group on {dev}: backend {group.backend}")
    configs = {"dense": CommConfig(),
               "topk": CommConfig(layer_strategies={
                   layer: TOPK for layer in TOPK_LAYERS})}
    period = SSP_STALENESS + 1
    rtol, atol = STEP_TOL
    out = {"backend": group.backend, "staleness": SSP_STALENESS,
           "steps": SSP_STEPS, "layouts": {}}

    def build(layout, rows):
        """The AlexNet train net planned ``layout`` at ``rows`` images, its
        first batch on the device and its params from seed 1."""
        net_param = alexnet_net_param(root, rows)
        pipes, shapes = build_phase_pipelines(net_param, "TRAIN")
        try:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipes[0]).items()}
        finally:
            for p in pipes:
                p.close()
        net = Net(net_param, "TRAIN", device=dev, source_shapes=shapes,
                  conv_layout=layout)
        check(net.conv_layout == layout, f"net planned {net.conv_layout}")
        return net, batch, net.init(torch.Generator().manual_seed(1))

    def run(net, step, batch, params0, n, plain):
        """n steps from params0 with dropout seed 7: losses, launches and
        clones of the anchor, local params, momentum and last state, and
        (``first``) of the local params after the first period's local
        steps and of the anchor after its boundary."""
        net.generator.manual_seed(7)
        anchor, state = step.load(params0, T.init_ssp_state(
            params0, step.n_groups, step.comm))
        losses, first = [], {}
        zero_launches()
        with (plain_versions(net, step) if plain
              else contextlib.nullcontext()):
            for i in range(n):
                anchor, state, m = step.step(anchor, state, batch)
                losses.append(float(m["loss"]))
                if i + 1 == SSP_STALENESS:
                    first[i + 1] = tree_clone(state.local_params)
                elif i + 1 == period:
                    first[i + 1] = tree_clone(anchor)
        sync(dev)
        return {"losses": losses, "launches": read_launches(),
                "anchor": tree_clone(anchor),
                "local": tree_clone(state.local_params),
                "history": tree_clone(state.local_history),
                "state": state, "first": first}

    def vs_plain(layout, net, batch, params0, want):
        """DENSE and TOPK SSP runs with the kernels against their plain
        versions; DENSE against the sync step up to the first boundary."""
        rows = batch["data"].shape[0]
        runs = {}
        for name, cfg in configs.items():
            step = T.SSPTrainStep(net, sp, SSP_STALENESS, group, cfg)
            k = run(net, step, batch, params0, SSP_STEPS, plain=False)
            p = run(net, step, batch, params0, SSP_STEPS, plain=True)
            worst = 0.0
            for what in ("anchor", "local", "history"):
                for l in k[what]:
                    for key in k[what][l]:
                        a, b = k[what][l][key], p[what][l][key]
                        err = float((a - b).abs().max())
                        worst = max(worst, err)
                        check(bool(torch.allclose(a, b, rtol=rtol,
                                                  atol=atol)),
                              f"SSP {layout} {name} {what} {l}/{key}: "
                              f"kernels vs plain max_abs {err}")
            check(all(abs(x - y) <= atol + rtol * abs(y) for x, y in
                      zip(k["losses"], p["losses"])),
                  f"SSP {layout} {name} losses {k['losses']} vs "
                  f"{p['losses']}")
            check(all(map(math.isfinite, k["losses"])),
                  f"SSP {layout} {name} losses {k['losses']}")
            check(k["launches"] == want,
                  f"SSP {layout} {name} launches {k['launches']} != {want}")
            check(not any(p["launches"].values()),
                  f"SSP {layout} {name}: the plain run launched a kernel")
            resid = [bool(v.abs().max() > 0) for lv in
                     k["state"].comm_error.values() for v in lv.values()]
            check(name != "topk" or (resid and all(resid)),
                  f"SSP {layout} TOPK left no residual at its boundaries")
            print(f"[ssp] (a) one-rank {group.backend} group, AlexNet "
                  f"{layout} batch {rows}, staleness {SSP_STALENESS}, "
                  f"{name}: {SSP_STEPS} steps ({SSP_STEPS // period} "
                  f"boundaries) with the kernels vs their plain versions "
                  f"(cuDNN deterministic): anchor, local params and "
                  f"momentum within rtol {rtol:g} atol {atol:g} (max_abs "
                  f"{worst:.3e}); losses {k['losses']}; launches "
                  f"{k['launches']} (expected {want}) [{card}]", flush=True)
            runs[name] = {"losses": k["losses"], "launches": k["launches"],
                          "max_abs_vs_plain": worst}
            if name == "dense":
                dense_first = k["first"]
            del k, p, step
        # one group: the SSP local steps are the sync step without its
        # one-rank all-reduce (bitwise), and the boundary folds a mean over
        # one group, anchor + (local - anchor), the identity up to
        # rounding (STEP_TOL). Held at the first boundary: past it that
        # rounding reaches ReLU and max-pool decisions and the two runs
        # part as any two summation orders do.
        sync_step = T.TrainStep(net, sp, group, CommConfig())
        net.generator.manual_seed(7)
        params, state = sync_step.load(params0, T.init_train_state(
            params0, sync_step.comm, sync_step.n_err_groups))
        vs_sync = {}
        for i in range(period):
            params, state, _m = sync_step.step(params, state, batch)
            if i + 1 in dense_first:
                ssp_tree = dense_first[i + 1]
                vs_sync[i + 1] = {
                    "max_abs": tree_max_abs(tree_clone(params), ssp_tree),
                    "bitwise": tree_equal(params, ssp_tree),
                    "close": all(bool(torch.allclose(
                        ssp_tree[l][key], params[l][key], rtol=rtol,
                        atol=atol)) for l in params for key in params[l])}
        local, fold = vs_sync[SSP_STALENESS], vs_sync[period]
        print(f"[ssp] (a) one group, {layout}, DENSE vs the sync step: the "
              f"local params after {SSP_STALENESS} steps max_abs "
              f"{local['max_abs']:.3e} (bitwise {local['bitwise']}), the "
              f"anchor after the boundary at step {period} max_abs "
              f"{fold['max_abs']:.3e} (bitwise {fold['bitwise']}); within "
              f"rtol {rtol:g} atol {atol:g}: {local['close']}, "
              f"{fold['close']} [{card}]", flush=True)
        check(local["bitwise"] and fold["close"],
              f"one-group SSP {layout} vs sync: {vs_sync}")
        return {"batch": rows, "runs": runs,
                "launches": runs["dense"]["launches"],
                "launches_topk": runs["topk"]["launches"],
                "vs_sync": {str(n): v for n, v in vs_sync.items()}
                }, sync_step

    def step_times(net, batch, params0, sync_step):
        """Device ms a step, in turns sync, SSP, SSP, sync, each over
        SSP_TIMED_PERIODS periods after a warm-up."""
        ssp = T.SSPTrainStep(net, sp, SSP_STALENESS, group,
                             configs["dense"])

        def ssp_times():
            """(local steps, boundary steps), mean ms."""
            anchor, state = ssp.load(params0, T.init_ssp_state(
                params0, 1, ssp.comm))
            for _ in range(period):
                anchor, state, _m = ssp.step(anchor, state, batch)
            torch.cuda.synchronize()
            local, boundary = [], []
            for _ in range(SSP_TIMED_PERIODS * period):
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                s0.record()
                anchor, state, _m = ssp.step(anchor, state, batch)
                s1.record()
                torch.cuda.synchronize()
                (boundary if state.it % period == 0 else local).append(
                    s0.elapsed_time(s1))
            return sum(local) / len(local), sum(boundary) / len(boundary)

        def sync_time():
            params, state = sync_step.load(params0, T.init_train_state(
                params0, sync_step.comm, sync_step.n_err_groups))
            for _ in range(2):
                params, state, _m = sync_step.step(params, state, batch)
            torch.cuda.synchronize()
            ms = []
            for _ in range(SSP_TIMED_PERIODS * period):
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                s0.record()
                params, state, _m = sync_step.step(params, state, batch)
                s1.record()
                torch.cuda.synchronize()
                ms.append(s0.elapsed_time(s1))
            return sum(ms) / len(ms)

        t = {}
        t["sync"] = sync_time()
        t["local"], t["boundary"] = ssp_times()
        t["local_2"], t["boundary_2"] = ssp_times()
        t["sync_2"] = sync_time()
        print(f"[ssp] (a) device step (CUDA events, one step a pair, "
              f"{SSP_TIMED_PERIODS * period} steps a run, {net.conv_layout} "
              f"batch {batch['data'].shape[0]}, in turns sync, SSP, SSP, "
              f"sync): sync {t['sync']:.3f} / {t['sync_2']:.3f} ms, SSP "
              f"local {t['local']:.3f} / {t['local_2']:.3f} ms, SSP "
              f"boundary {t['boundary']:.3f} / {t['boundary_2']:.3f} ms "
              f"[{card}]", flush=True)
        return t

    # (a) in both layouts: NCHW at SSP_BATCH, and NHWC at the ranks' batch
    # of (b) and (c), the layout an unflagged `train` plans on the card
    nchw_step = {"lrn_fwd": 2, "lrn_bwd": 2, "pool_bwd": 3, "sgd_update": 1}
    nhwc_step = {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2, "pool_bwd_nhwc": 3,
                 "sgd_update": 1}
    cases = (("NCHW", batch_size or SSP_BATCH, nchw_step),
             ("NHWC", cli_batch or SSP_CLI_BATCH, nhwc_step))
    deterministic = torch.backends.cudnn.deterministic
    try:
        for layout, rows, per_step in cases:
            net, batch, params0 = build(layout, rows)
            want = {k: 0 for k in read_launches()}
            if on_card:
                want.update({k: v * SSP_STEPS for k, v in per_step.items()})
            torch.backends.cudnn.deterministic = True
            try:
                res, sync_step = vs_plain(layout, net, batch, params0, want)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            out["layouts"][layout] = res
            if on_card and layout == "NCHW":
                out["step_ms"] = step_times(net, batch, params0, sync_step)
            del sync_step, batch, params0
            if on_card:
                torch.cuda.empty_cache()
    finally:
        group.close()

    def want_cli(iters):
        """A child rank's launches: (a)'s NHWC count a step, per
        iteration."""
        out_ = {k: 0 for k in read_launches()}
        if on_card:
            out_.update({k: v * iters for k, v in nhwc_step.items()})
        return out_

    # (b) two `train --staleness` ranks over gloo, an SSP snapshot
    cli = dp_cli_run(card, root, "ssp", ("--staleness", str(SSP_STALENESS)),
                     dev, cli_batch or SSP_CLI_BATCH, tag="ssp",
                     iters=SSP_CLI_ITERS)
    with np.load(cli["state_path"]) as z:
        kind = str(z["kind"])
        rows = {k: z[k].shape[0] for k in z.files
                if k.startswith("local_params/")}
    anchor, st = CK.restore(cli["state_path"])
    step = T.SSPTrainStep(net, sp, SSP_STALENESS, None, CommConfig())
    anchor, st = step.load(*CK.coerce_state(anchor, st,
                                            staleness=SSP_STALENESS,
                                            n_dev=2, comm=CommConfig()))
    restored = (isinstance(st, T.SSPState) and st.it == SSP_CLI_ITERS
                and all(bool(torch.isfinite(v).all()) for lv in
                        anchor.values() for v in lv.values()))
    print(f"[ssp] (b) two `train --staleness {SSP_STALENESS}` ranks over "
          f"gloo: snapshot kind {kind!r}, local rows {sorted(set(rows.values()))}"
          f", restored into an SSPTrainStep at iteration {st.it}: "
          f"{restored}; launches a rank {cli['launches']} [{card}]",
          flush=True)
    check(kind == "ssp" and set(rows.values()) == {2} and restored,
          "SSP snapshot kind, rows or restore")
    check(all(r == want_cli(SSP_CLI_ITERS) for r in cli["launches"]),
          f"SSP ranks' launches {cli['launches']}")
    del step, anchor, st
    out["cli"] = without_logs(cli)
    del out["cli"]["state_path"]

    # (c) two async ranks, dense and then managed
    out["async"] = {}
    for name, flags in (
            ("dense", ()),
            ("managed", ("--comm_budget_mbps", str(ASYNC_BUDGET_MBPS)))):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        run_ = dp_cli_run(
            card, root, f"async_{name}",
            ("--async_ssp", "--staleness", "1", "--async_sync_every", "2",
             *flags), dev, cli_batch or SSP_CLI_BATCH, tag="async_ssp",
            iters=ASYNC_CLI_ITERS, group=False, same_snapshots=False,
            env_extra={"POSEIDON_ASYNC_SERVICE": f"127.0.0.1:{port}",
                       "POSEIDON_ASYNC_TOKEN": ASYNC_TOKEN})
        workers = [async_tier_report(log, r)
                   for r, log in enumerate(run_["logs"])]
        for r, w in enumerate(workers):
            print(f"[ssp] (c) async {name}, rank {r}: final clock "
                  f"{w['async_final_clock']:g}, gate blocks "
                  f"{w['async_gate_blocks']:g}, blocked "
                  f"{w['async_blocked_s']:g} s, pushed "
                  f"{w['async_comm_bytes_sent']:.0f} B, pulled "
                  f"{w['async_comm_bytes_recv']:.0f} B, partial pushes "
                  f"{w['async_comm_partial_pushes']:g}; tier ms a flush: "
                  f"D2H {w['async_d2h_ms_per_flush']:g}, push "
                  f"{w['async_push_ms_per_flush']:g}, refresh "
                  f"{w['async_refresh_ms_per_flush']:g}, gate "
                  f"{w['async_gate_ms_per_flush']:g}, H2D "
                  f"{w['async_h2d_ms_per_flush']:g} [{card}]", flush=True)
            check(w["async_final_clock"] == ASYNC_CLI_ITERS // 2 - 1,
                  f"async {name} rank {r} final clock")
        check(all(r == want_cli(ASYNC_CLI_ITERS)
                  for r in run_["launches"]),
              f"async {name} ranks' launches {run_['launches']}")
        partial = sum(w["async_comm_partial_pushes"] for w in workers)
        check(name != "managed" or partial > 0,
              "the managed run made no partial push")
        out["async"][name] = {"workers": workers,
                              **{k: v for k, v in without_logs(run_).items()
                                 if k != "state_path"}}
    # the launches of a path: every rank of its run (the dense async run)
    out["cli_launches"] = sum_launches(cli["launches"])
    out["async_launches"] = sum_launches(out["async"]["dense"]["launches"])
    out["wall_s"] = time.perf_counter() - t_phase
    t = out.get("step_ms")
    print("[ssp] " + (
        f"local {t['local']:.3f} / {t['local_2']:.3f} ms, boundary "
        f"{t['boundary']:.3f} / {t['boundary_2']:.3f} ms, sync "
        f"{t['sync']:.3f} / {t['sync_2']:.3f} ms; " if t else "")
        + f"SSP kernels vs plain held in NCHW and NHWC, K4-K7 2/2/3/1 a "
        f"step; two SSP ranks "
        f"bitwise, kind ssp restored; async dense and managed runs done; "
        f"phase wall {out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def phase_digits(card: str, flags=(), tag: str = "digits") -> float:
    """The CLI on real data: the digits solver, 1000 iterations, on the
    card (its default layout: NHWC there), with ``flags`` added; returns
    the final test accuracy."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "poseidon_tpu_torch", "train",
             f"--solver={DIGITS_SOLVER}", "--output_dir", out_dir, *flags],
            cwd=here, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"digits training exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(out_dir,
                               "digits_quick_test0_outputs.csv")) as f:
            rows = list(csv.DictReader(f))
    final = rows[-1]
    acc = float(final["accuracy"])
    policy = [ln for ln in proc.stdout.splitlines()
              if "numeric policy:" in ln]
    check(bool(policy), "the train command logged no numeric policy")
    print(f"[{tag}] python -m poseidon_tpu_torch train --solver="
          f"{DIGITS_SOLVER} {' '.join(flags)}: {policy[0].strip()}",
          flush=True)
    print(f"[{tag}] python -m poseidon_tpu_torch train --solver="
          f"{DIGITS_SOLVER} {' '.join(flags)}: {len(rows)} test rows, "
          f"iteration "
          f"{final['iter']} accuracy {acc:.4f} loss {float(final['loss']):.4f}"
          f" (recorded for the JAX package: 0.9417; required >= "
          f"{DIGITS_MIN_ACC}) in {wall:.1f} s [{card}]", flush=True)
    check(int(final["iter"]) == 1000, f"last test row at {final['iter']}")
    check(acc >= DIGITS_MIN_ACC, f"digits accuracy {acc} < {DIGITS_MIN_ACC}")
    return acc


def lm_traffic(ex, n_requests: int, seed: int = 0):
    """A seeded mix of prompts: lengths uniform in [LM_PROMPT_MIN,
    min(LM_PROMPT_MAX, largest bucket)], the first of them one per prompt
    bucket so every bucket is hit; token ids uniform over the vocabulary."""
    import numpy as np
    rs = np.random.RandomState(seed)
    hi = min(LM_PROMPT_MAX, ex.prompt_buckets[-1])
    lengths = rs.randint(LM_PROMPT_MIN, hi + 1, size=n_requests)
    lengths[:len(ex.prompt_buckets)] = [min(b, hi) for b in ex.prompt_buckets]
    return [rs.randint(0, ex.cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in lengths]


def paged_logits(ex, prompt, max_new: int):
    """One request through the executor's paged path by hand (bucketed
    prefill, then rung-1 decode steps): (tokens, per-step logits)."""
    import numpy as np
    sid = -1
    ex.pool.alloc(sid, ex.reserve_len(len(prompt), max_new))
    try:
        logits, caches = ex.prefill(prompt)
        ex.pool.write_prefill(sid, caches)
        table = ex.pool.table([sid])
        steps = [logits]
        pos = len(prompt)
        for _ in range(max_new - 1):
            tok = np.array([int(np.argmax(steps[-1]))])
            steps.append(ex.decode(tok, table, np.array([pos]))[0])
            pos += 1
    finally:
        ex.pool.free(sid)
    logits = np.stack(steps)
    return np.argmax(logits, axis=-1), logits


def phase_lm(card: str, device=None, preset: str = LM_PRESET,
             n_requests: int = LM_REQUESTS,
             solo_requests: int = LM_SOLO_REQUESTS) -> dict:
    """The LM serving slice: ``serve --generate``'s executor behind the
    port's InferenceServer, driven by the port's ServingClient. ``device``,
    ``preset`` and the request counts are for a CPU rehearsal only."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.models.generate import generate, prefill_cached
    from poseidon_tpu_torch.runtime.cli import build_generate_executor
    from poseidon_tpu_torch.serving.client import ServingClient, run_load
    from poseidon_tpu_torch.serving.server import InferenceServer

    on_card = torch.device(device or "cuda").type == "cuda"
    if on_card:
        # the slice's own peak: weights, KV pool and activations above
        # whatever earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ex = build_generate_executor(preset, device=device)
    cfg = ex.cfg
    pool_bytes = sum(t.numel() * t.element_size()
                     for pair in ex.pool.caches for t in pair)
    print(f"[lm] {preset} on {ex.device}: {cfg.n_params()} params (vocab "
          f"{cfg.vocab_size}, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_layers} layers, d_ff {cfg.d_ff}, max_seq {cfg.max_seq}); "
          f"page {ex.page_size}, rungs {ex.decode_rungs}, buckets "
          f"{ex.prompt_buckets}; KV pool {ex.pool.num_pages} pages = "
          f"{pool_bytes / 1e6:.1f} MB; built and warmed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if preset == "gpt_small":
        check(cfg.n_params() == 135_697_920, f"gpt_small has "
                                              f"{cfg.n_params()} params")
    prompts = lm_traffic(ex, n_requests)
    streamed = {}                 # request index -> [t_submit, t_first, chunks]
    lock = threading.Lock()

    def make_inputs(i):
        inputs = {"prompt": prompts[i % len(prompts)],
                  "max_new": LM_MAX_NEW}
        if i % 4 == 0:
            rec = [time.monotonic(), None, []]
            with lock:
                streamed[i] = rec

            def on_tokens(toks, rec=rec):
                if rec[1] is None:
                    rec[1] = time.monotonic()
                rec[2].append(len(toks))
            inputs["on_tokens"] = on_tokens
        return inputs

    alone = prompts[1][:64]
    zero_launches()
    prefills0 = ex.prefills
    server = InferenceServer(ex, port=0)
    try:
        load = run_load(server.addr, make_inputs, n_requests=n_requests,
                        concurrency=LM_CLIENTS, op="generate")
        sched = server.batcher.snapshot()
        streamed_load = dict(streamed)
        solo = run_load(server.addr, make_inputs, n_requests=solo_requests,
                        concurrency=1, op="generate")
        cli = ServingClient(server.addr)
        try:
            served_alone = cli.generate(alone, max_new=LM_MAX_NEW)
        finally:
            cli.close()
    finally:
        server.shutdown()
    sync(ex.device)
    counts = read_launches()
    prefills = ex.prefills - prefills0
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    per_prefill = cfg.n_layers if on_card else 0
    print(f"[lm] {prefills} prefills, decode steps per rung "
          f"{ex.decode_calls}; launches {counts} (flash_fwd expected "
          f"{per_prefill} x {prefills})", flush=True)
    check(counts["flash_fwd"] == per_prefill * prefills,
          f"flash_fwd launched {counts['flash_fwd']} times for {prefills} "
          f"prefills (expected {per_prefill} per prefill)")
    check(all(v == 0 for k, v in counts.items() if k != "flash_fwd"),
          f"LM serving launched a CNN kernel: {counts}")
    for run, n in ((load, n_requests), (solo, solo_requests)):
        check(run["ok"] == n and run["tokens"] == n * LM_MAX_NEW,
              f"generate load: {run} (expected {n} replies of "
              f"{LM_MAX_NEW} tokens)")
    check(ex.pool.all_free(), "KV pages leaked after the drain")
    for i, (_, t_first, chunks) in streamed_load.items():
        check(chunks == list(range(1, LM_MAX_NEW + 1)),
              f"request {i}: streamed chunk lengths {chunks}")
    buckets_hit = sorted({ex.prompt_bucket_for(len(p)) for p in prompts})
    check(buckets_hit == list(ex.prompt_buckets),
          f"traffic hit buckets {buckets_hit}")
    ttft = sched["ttft"]
    client_ttft = sorted((t1 - t0_) * 1e3 for t0_, t1, _ in
                         streamed_load.values())
    print(f"[lm] {n_requests} requests from {LM_CLIENTS} clients (prompts "
          f"{LM_PROMPT_MIN}..{max(len(p) for p in prompts)} tokens, max_new "
          f"{LM_MAX_NEW}, {len(streamed_load)} streamed) in "
          f"{load['wall_s']:.3f} s: request latency p50 {load['p50_ms']} ms "
          f"p99 {load['p99_ms']} ms (n={load['ok']}); time to first token "
          f"p50 {ttft.get('p50_ms')} ms p99 {ttft.get('p99_ms')} ms "
          f"(n={ttft.get('count')}, scheduler: submit to first token; "
          f"streamed clients see p50 "
          f"{client_ttft[len(client_ttft) // 2]:.3f} ms, n="
          f"{len(client_ttft)}); {load['goodput_tps']:.1f} generated "
          f"tokens/s at {LM_CLIENTS} clients; decode batch fill "
          f"{sched['fill']:.3f} [{card}]", flush=True)
    print(f"[lm] {solo_requests} requests from 1 client: p50 "
          f"{solo['p50_ms']} ms p99 {solo['p99_ms']} ms (n={solo['ok']}), "
          f"{solo['goodput_tps']:.1f} generated tokens/s; the slice's peak "
          f"device memory (weights, pool, activations) {peak / 2**30:.3f} "
          f"GiB [{card}]", flush=True)

    # the request served alone vs the dense generate on the same device
    toks_p, logits_p = paged_logits(ex, alone, LM_MAX_NEW)
    toks_d, logits_d = generate(ex._params, cfg,
                                torch.from_numpy(alone[None]).to(ex.device),
                                LM_MAX_NEW)
    toks_d, logits_d = toks_d[0].cpu().numpy(), logits_d[0].cpu().numpy()
    rtol, atol = LM_TOL
    err = float(np.abs(logits_p - logits_d).max())
    print(f"[lm] alone-served request ({len(alone)} prompt tokens): served "
          f"tokens == paged tokens == dense generate tokens: "
          f"{np.array_equal(served_alone['tokens'], toks_p)} / "
          f"{np.array_equal(toks_p, toks_d)}; paged vs dense logits max_abs "
          f"{err:.3e} (rtol {rtol:g}, atol {atol:g})", flush=True)
    check(np.array_equal(served_alone["tokens"], toks_p)
          and np.array_equal(toks_p, toks_d),
          "the alone-served request's tokens differ from the dense path")
    check(bool(np.allclose(logits_p, logits_d, rtol=rtol, atol=atol)),
          f"paged and dense logits disagree ({err})")

    # one prefill on the device vs the same prefill on the CPU
    bucket = ex.prompt_buckets[min(1, len(ex.prompt_buckets) - 1)]
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(prompts[2][:bucket])] = prompts[2][:bucket]
    last = torch.tensor([min(len(prompts[2]), bucket) - 1])
    cpu_params = {n: {l: v.cpu() for l, v in d.items()}
                  for n, d in ex._params.items()}
    with torch.inference_mode():
        dev_logits, _ = prefill_cached(ex._params, cfg,
                                       torch.from_numpy(toks).to(ex.device),
                                       last.to(ex.device), bucket)
        cpu_logits, _ = prefill_cached(cpu_params, cfg,
                                       torch.from_numpy(toks), last, bucket)
    dev_logits = dev_logits.cpu()
    err_cpu = float((dev_logits - cpu_logits).abs().max())
    print(f"[lm] bucket-{bucket} prefill first-token logits, {ex.device} vs "
          f"CPU: max_abs {err_cpu:.3e} (rtol {rtol:g}, atol {atol:g})",
          flush=True)
    check(bool(torch.allclose(dev_logits, cpu_logits, rtol=rtol, atol=atol)),
          f"prefill logits on {ex.device} and the CPU disagree ({err_cpu})")
    del cpu_params

    out = {"requests": n_requests, "clients": LM_CLIENTS,
           "max_new": LM_MAX_NEW, "prefills": prefills,
           "flash_launches": counts["flash_fwd"], "launches": counts,
           "decode_calls": dict(ex.decode_calls),
           "p50_ms": load["p50_ms"], "p99_ms": load["p99_ms"],
           "ttft": ttft, "tokens_per_s_8": load["goodput_tps"],
           "tokens_per_s_1": solo["goodput_tps"],
           "solo_p50_ms": solo["p50_ms"], "peak_bytes": peak,
           "pool_bytes": pool_bytes, "alone_logits_max_abs": err,
           "cpu_logits_max_abs": err_cpu}
    if on_card:
        out.update(phase_lm_timing(ex, card))
    return out


def phase_lm_timing(ex, card: str) -> dict:
    """CUDA-event prefill time per bucket; per decode rung the device busy
    time of a step (the sum of its device ops in torch.profiler, over 5
    profiled steps), its CUDA-event span and its host wall time (tensors
    in, logits back on the host; unprofiled, mean of 10), whose ratio is
    the busy share; the top kernels of a step at the largest rung."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from poseidon_tpu_torch.models.generate import prefill_cached

    prefill_ms = {}
    with torch.inference_mode():
        for b in ex.prompt_buckets:
            toks = torch.zeros((1, b), dtype=torch.long, device=ex.device)
            last = torch.tensor([b - 1], device=ex.device)
            prefill_ms[b] = cuda_time_ms(
                lambda: prefill_cached(ex._params, ex.cfg, toks, last, b),
                warmup=2, reps=10)
    print("[lm] prefill (CUDA events, mean of 10): " + ", ".join(
        f"bucket {b} {ms:.3f} ms" for b, ms in prefill_ms.items())
        + f" [{card}]", flush=True)
    b = ex.prompt_buckets[-1]
    toks = torch.zeros((1, b), dtype=torch.long, device=ex.device)
    last = torch.tensor([b - 1], device=ex.device)
    with torch.inference_mode():
        prefill_busy = profiled_device_ms(
            lambda: prefill_cached(ex._params, ex.cfg, toks, last, b))
        prefill_flash = profiled_device_ms(
            lambda: prefill_cached(ex._params, ex.cfg, toks, last, b),
            key="flash_fwd_kernel")
    print(f"[lm] bucket-{b} prefill: device busy {prefill_busy:.4f} ms "
          f"(torch.profiler, mean of 10), of which flash_fwd "
          f"{prefill_flash:.4f} ms in {ex.cfg.n_layers} launches [{card}]",
          flush=True)
    decode = {}
    width = ex.pool.max_pages_per_seq
    steps = 5
    top = []
    for r in ex.decode_rungs:
        args = (np.zeros((r,), np.int64), np.zeros((r, width), np.int64),
                np.zeros((r,), np.int64))
        span = cuda_time_ms(lambda: ex._run_decode(*args), warmup=2, reps=10)
        t0 = time.perf_counter()
        for _ in range(10):
            ex._run_decode(*args)       # returns host logits: synchronizes
        wall = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                ex._run_decode(*args)
            torch.cuda.synchronize()
        per_kernel, launches = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                launches += 1
                per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                      + e.time_range.elapsed_us())
        busy = sum(per_kernel.values()) / steps / 1e3
        decode[r] = {"device_busy_ms": busy, "cuda_event_ms": span,
                     "host_wall_ms": wall,
                     "busy_share": busy / wall if wall else None,
                     "device_ops_per_step": launches / steps}
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        print(f"[lm] decode rung {r}: device busy {busy:.3f} ms "
              f"(torch.profiler, {launches / steps:.0f} device ops a step), "
              f"CUDA-event span {span:.3f} ms, host wall {wall:.3f} ms a "
              f"step: busy share {decode[r]['busy_share']:.3f} [{card}]",
              flush=True)
    if top:
        print(f"[lm] rung {ex.decode_rungs[-1]} step, top kernels (mean ms "
              f"a step):", flush=True)
        for name, us in top:
            print(f"  {us / steps / 1e3:8.4f} ms  {name[:90]}", flush=True)
    return {"prefill_ms": prefill_ms, "prefill_busy_ms": prefill_busy,
            "prefill_flash_ms": prefill_flash, "decode": decode}


def lm_train_setup(preset: str, batch: int, seq: int, device):
    """(cfg, solver, params, tokens, targets): gpt_small (or the tiny preset
    of a CPU rehearsal) with seeded weights, the SGD solver of bench.py's
    lm block, and seeded tokens and targets (RandomState(1), as there)."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.proto.messages import SolverParameter

    if preset == "gpt_small":
        cfg = tfm.gpt_small_config(max_seq=seq)
    else:
        cfg = tfm.TransformerConfig(vocab_size=512, d_model=64, n_heads=2,
                                    n_layers=2, d_ff=128, max_seq=seq,
                                    remat=True)
    sp = SolverParameter(base_lr=0.01, lr_policy="fixed", momentum=0.9)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    rs = np.random.RandomState(1)
    toks, tgts = (torch.from_numpy(rs.randint(
        0, cfg.vocab_size, size=(batch, seq)).astype(np.int64)).to(device)
        for _ in range(2))
    return cfg, sp, params, toks, tgts


def tree_clone(tree):
    return {n: {l: v.clone() for l, v in d.items()} for n, d in tree.items()}


def grad_errors(got, want):
    """Each leaf's max abs difference over its max abs value; the worst
    (error, leaf)."""
    worst = (0.0, "")
    for n in want:
        for l in want[n]:
            a, b = got[n][l].float(), want[n][l].float()
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            worst = max(worst, (err, f"{n}/{l}"))
    return worst


def phase_lm_train(card: str, device=None, preset: str = LMT_PRESET,
                   batch: int = LMT_BATCH, seq: int = LMT_SEQ,
                   loss_steps: int = LMT_LOSS_STEPS,
                   per_step=LMT_LAUNCHES, tag: str = "lm_train",
                   step_tol=STEP_TOL, grad_tol: float = GRAD_TOL,
                   peak=("float32", F32_OPS_PER_S)) -> dict:
    """The LM training slice: gpt_small at batch 8 x seq 1024 with remat,
    trained by the port's build_dp_sp_train_step on the card, under the
    numeric policy the caller set (``[bf16_lm_train]`` runs it under bf16
    with its tolerances and the bf16 peak). ``device``, ``preset``, the
    shape and ``per_step`` (0 on the CPU, where the plain versions count
    nothing) are for a CPU rehearsal only."""
    import dataclasses
    import functools
    import numpy as np
    import torch
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.ops import flash
    from poseidon_tpu_torch.runtime.lm_checkpoint import restore_lm, save_lm
    from poseidon_tpu_torch.solvers.updates import SolverState, init_state

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    cfg, sp, params, toks, tgts = lm_train_setup(preset, batch, seq, dev)
    n_par = cfg.n_params()
    print(f"[{tag}] {preset} on {dev}: {n_par} params (vocab "
          f"{cfg.vocab_size}, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_layers} layers, d_ff {cfg.d_ff}, max_seq {cfg.max_seq}), "
          f"remat {cfg.remat!r}; batch {batch} x seq {seq}; SGD base_lr "
          f"{sp.base_lr} {sp.lr_policy} momentum {sp.momentum}", flush=True)
    if preset == "gpt_small":
        check(n_par == LMT_PARAMS, f"gpt_small has {n_par} params")
    step = tfm.build_dp_sp_train_step(cfg, sp, dev)
    state = init_state(params)

    # the main path: LMT_LOSS_STEPS steps on the fixed batch, launch
    # counters zeroed just before and read just after
    zero_launches()
    losses = []
    for _ in range(loss_steps):
        params, state, m = step(params, state, toks, tgts)
        losses.append(float(m["loss"]))        # synchronizes the device
    counts = read_launches()
    want = {k: 0 for k in counts}
    want.update({k: n * loss_steps for k, n in per_step.items()})
    print(f"[{tag}] {loss_steps} steps: launches {counts} (expected "
          f"{want}: per step {dict(per_step)}); loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} [{', '.join(f'{x:.4f}' for x in losses)}]",
          flush=True)
    check(counts == want, f"LM training launches {counts} != {want}")
    check(all(np.isfinite(losses)), f"non-finite LM loss: {losses}")
    check(losses[-1] < losses[0], f"LM loss did not fall over {loss_steps} "
                                  f"steps on a fixed batch: {losses}")
    check(state.it == loss_steps, f"solver iteration {state.it}")

    # one step with the kernels vs the same step with the plain flash
    # versions swapped into the transformer, on the card
    p0, s0 = tree_clone(params), SolverState(state.it,
                                             tree_clone(state.history))

    def loss_and_grads_peak(cfg_x):
        """loss_and_grads on p0, and the bytes it took above what was
        allocated before it (activations and the returned gradients)."""
        base = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        loss, grads = tfm.loss_and_grads(p0, cfg_x, toks, tgts)
        sync(dev)
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        return loss, grads, peak

    loss_k, grads_k, peak_remat = loss_and_grads_peak(cfg)
    pk, _, mk = step(p0, s0, toks, tgts)
    before = read_launches()
    tfm.maybe_flash_attention = functools.partial(
        flash.maybe_flash_attention, plain=True)
    try:
        loss_p, grads_p = tfm.loss_and_grads(p0, cfg, toks, tgts)
        pp, _, mp = step(p0, s0, toks, tgts)
    finally:
        tfm.maybe_flash_attention = flash.maybe_flash_attention
    sync(dev)
    check(read_launches() == before,
          "the plain-version LM step launched a kernel: the swap did not take")
    rtol, atol = step_tol
    check(abs(float(mk["loss"]) - float(mp["loss"]))
          <= atol + rtol * abs(float(mp["loss"])),
          f"LM step loss with kernels {float(mk['loss'])} vs plain "
          f"{float(mp['loss'])}")
    worst_p = 0.0
    for n in pk:
        for l in pk[n]:
            err = float((pk[n][l] - pp[n][l]).abs().max())
            worst_p = max(worst_p, err)
            check(bool(torch.allclose(pk[n][l], pp[n][l], rtol=rtol,
                                      atol=atol)),
                  f"LM param {n}/{l} after one step: kernels vs plain "
                  f"max_abs {err}")
    g_err, g_leaf = grad_errors(grads_k, grads_p)
    print(f"[{tag}] one step, kernels vs plain flash versions on the "
          f"card: loss {float(mk['loss'])!r} vs {float(mp['loss'])!r}, every "
          f"updated param within rtol {rtol:g} atol {atol:g} (max_abs "
          f"{worst_p:.3e}); gradients max|diff|/max|grad| {g_err:.3e} at "
          f"{g_leaf} (limit {grad_tol:g})", flush=True)
    check(g_err <= grad_tol, f"LM gradients, kernels vs plain: {g_err} at "
                             f"{g_leaf}")
    del pk, pp, grads_p, mk, mp

    # remat vs none: the same loss, gradients within GRAD_TOL; what a
    # forward and backward take above what was live before it, with and
    # without remat
    cfg_none = dataclasses.replace(cfg, remat=False)
    zero_launches()
    loss_n, grads_n, peak_none = loss_and_grads_peak(cfg_none)
    none_counts = read_launches()
    r_err, r_leaf = grad_errors(grads_k, grads_n)
    print(f"[{tag}] remat {cfg.remat!r} vs none: loss {float(loss_k)!r} "
          f"vs {float(loss_n)!r} (equal: {bool(torch.equal(loss_k, loss_n))});"
          f" gradients max|diff|/max|grad| {r_err:.3e} at {r_leaf}; launches "
          f"without remat {none_counts}; a forward and backward's peak above "
          f"what was live before it: {peak_remat / 2**30:.3f} GiB with "
          f"remat, {peak_none / 2**30:.3f} GiB without [{card}]", flush=True)
    check(bool(torch.equal(loss_k, loss_n)),
          f"LM loss with remat {float(loss_k)} != without {float(loss_n)}")
    check(r_err <= grad_tol, f"LM gradients, remat vs none: {r_err} at "
                             f"{r_leaf}")
    del grads_k, grads_n, p0, s0

    # the snapshot restores bitwise
    with tempfile.TemporaryDirectory() as d:
        path = save_lm(os.path.join(d, "gpt"), params, state)
        rp, rstate = restore_lm(path)
    check(rstate.it == state.it, f"restored iteration {rstate.it}")
    for a_tree, b_tree in ((params, rp), (state.history, rstate.history)):
        for n in a_tree:
            for l in a_tree[n]:
                check(torch.equal(a_tree[n][l].cpu(), b_tree[n][l]),
                      f"{n}/{l} did not restore bitwise")
    print(f"[{tag}] snapshot {os.path.basename(path)} restored bitwise "
          f"(params and momentum)", flush=True)
    del rp, rstate

    out = {"preset": preset, "params": n_par, "batch": batch, "seq": seq,
           "steps": loss_steps, "launches": counts,
           "launches_per_step": {k: counts[k] // loss_steps
                                 for k in per_step},
           "losses": losses, "grad_err_kernels_vs_plain": g_err,
           "grad_err_remat_vs_none": r_err,
           "fwd_bwd_peak_bytes": {"remat": peak_remat, "none": peak_none},
           "launches_no_remat": none_counts}
    if on_card:
        out.update(phase_lm_train_timing(step, params, state, toks, tgts,
                                         n_par, card, tag, peak))
        for name, n in out["launches_per_step"].items():
            ms = out["port_kernels"].get(name, {}).get("ms", 0.0)
            check(n == 0 or ms > 0,
                  f"{name} launched {n} times a step but the profiled step "
                  f"shows no device time for it (a kernel renamed away from "
                  f"'{name}_kernel'?)")
    return out


def phase_lm_train_timing(step, params, state, toks, tgts, n_par: int,
                          card: str, tag: str = "lm_train",
                          peak=("float32", F32_OPS_PER_S)) -> dict:
    """Device step time by CUDA events over TIMED_STEPS steps, tokens/s,
    MFU by the 6*P*T convention and the executed share with the recompute
    (8*P*T), both over ``peak`` (the dense rate of the products' type: f32
    67, bf16 989 TFLOP/s), the peak device memory, and the top kernels of
    one profiled step with K1, K2 and K3's shares."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    peak_name, peak_ops = peak
    n_tok = toks.numel()
    for _ in range(2):
        params, state, _m = step(params, state, toks, tgts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        params, state, m = step(params, state, toks, tgts)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak_mem = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(m["loss"])), "non-finite loss in timed steps")
    tok_s = n_tok / step_ms * 1e3
    mfu = 6.0 * n_par * n_tok / (step_ms / 1e3) / peak_ops
    executed = 8.0 * n_par * n_tok / (step_ms / 1e3) / peak_ops
    print(f"[{tag}] device step {step_ms:.3f} ms (CUDA events, mean of "
          f"{TIMED_STEPS} steps, fixed on-device batch of {n_tok} tokens): "
          f"{tok_s:.1f} tokens/s; MFU {mfu:.4f} (6*P*T, P={n_par}, T={n_tok},"
          f" over {peak_name} {peak_ops / 1e12:g} TFLOP/s, the H100 SXM's "
          f"dense peak); executed-FLOP share with the recompute "
          f"{executed:.4f} (8*P*T); peak device memory "
          f"{peak_mem / 2**30:.3f} GiB [{card}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, toks, tgts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    busy = sum(per_kernel.values())
    ours = {}
    if busy:
        print(f"[{tag}] profiled step: device busy {busy / 1e3:.3f} ms of "
              f"{wall_ms:.3f} ms wall ({len(per_kernel)} kernels); top 10:",
              flush=True)
        for name, us in sorted(per_kernel.items(),
                               key=lambda kv: -kv[1])[:10]:
            print(f"  {us / 1e3:8.3f} ms {100 * us / busy:5.1f}%  "
                  f"{name[:90]}", flush=True)
        for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
            us = sum(v for k, v in per_kernel.items()
                     if f"{kernel}_kernel" in k)
            ours[kernel] = {"ms": us / 1e3, "share": us / busy}
        print(f"[{tag}] port kernels in the profiled step: " + ", ".join(
            f"{k} {v['ms']:.3f} ms ({100 * v['share']:.1f}%)"
            for k, v in ours.items()) + f" [{card}]", flush=True)
    else:
        print(f"[{tag}] torch.profiler: no device time recorded",
              flush=True)
    return {"step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
            "mfu_peak": f"{peak_name} {peak_ops / 1e12:g} TFLOP/s",
            "executed_share": executed, "peak_bytes": peak_mem,
            "profiled_busy_ms": busy / 1e3, "profiled_wall_ms": wall_ms,
            "port_kernels": ours}


def phase_lm_corpus(card: str, extra_args=()) -> dict:
    """``models.train_lm``'s ``main`` at its defaults (200 steps, seq 256,
    batch 8, d 128, 2 layers, 4 heads, remat off) with ``--generate``, in
    this process: the loss must fall below LM_CORPUS_MAX_LOSS by the last
    step and the decode must print its bytes. Launch counters are zeroed
    just before and read just after: on the card, one flash_fwd, flash_dq
    and flash_dkv per layer a step (two flash_fwd with ``--remat``), and one
    flash_fwd per layer for the decode's prefill; none on the CPU.
    ``extra_args`` are for a CPU rehearsal only."""
    import contextlib
    import io
    from poseidon_tpu_torch.models import train_lm
    from poseidon_tpu_torch.numeric import resolve_device

    argv = ["--generate", str(LM_CORPUS_GENERATE), *extra_args]
    args = train_lm.parse_args(argv)
    buf = io.StringIO()
    t0 = time.perf_counter()
    zero_launches()
    try:
        with contextlib.redirect_stdout(buf):
            train_lm.main(argv)
    finally:
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"[lm_corpus] {line}", flush=True)
    counts = read_launches()
    wall = time.perf_counter() - t0
    want = {k: 0 for k in counts}
    if resolve_device(args.device).type == "cuda":
        fwd_per_step = args.n_layers * (2 if args.remat else 1)
        want.update(flash_fwd=args.steps * fwd_per_step + args.n_layers,
                    flash_dq=args.steps * args.n_layers,
                    flash_dkv=args.steps * args.n_layers)
    steps = [(int(l.split()[1]), float(l.split()[3])) for l in lines
             if l.startswith("step ")]
    gen = [l for l in lines if l.startswith("generated: ")]
    check(len(steps) >= 2, f"models.train_lm printed {len(steps)} step lines")
    first, last = steps[0][1], steps[-1][1]
    print(f"[lm_corpus] python -m poseidon_tpu_torch.models.train_lm "
          f"{' '.join(argv)}: loss {first:.4f} at step {steps[0][0]} -> "
          f"{last:.4f} at step {steps[-1][0]} (required < "
          f"{LM_CORPUS_MAX_LOSS}) in {wall:.1f} s; launches {counts} "
          f"(expected {want}) [{card}]", flush=True)
    check(counts == want, f"models.train_lm launches {counts} != {want}")
    check(all(math.isfinite(x) for _, x in steps),
          f"non-finite loss: {steps}")
    check(last < LM_CORPUS_MAX_LOSS and last < first,
          f"models.train_lm loss {first} -> {last}")
    check(len(gen) == 1 and len(gen[0]) > len("generated: ''"),
          f"--generate printed {gen}")
    return {"losses": steps, "wall_s": wall, "generated": gen[0],
            "launches": counts}


def bf16_launch(records, case: str) -> dict:
    """The bf16 record of ``case`` (the gpt_small training launch under
    --bf16): its times, bound and library time."""
    rec = next(r for r in records if r["case"] == case
               and r["dtype"] == "bfloat16")
    return {k: rec.get(k) for k in ("ms", "device_ms", "bound_ms", "bound_by",
                                    "library_ms", "plain_ms",
                                    "max_abs_err")}


def kernel_entry(name: str, replaces: str, launches: int, records,
                 main_cases, source=None, dtype: str = "float32",
                 **extra) -> dict:
    """One kernel's entry of the JSON line: launches on the main path, the
    largest error over every case, and the sums of the main-path cases in
    the main path's ``dtype``."""
    main = [r for r in records if r["case"] in main_cases
            and r["dtype"] == dtype]
    libs = [r["library_ms"] for r in main]
    least, by = bound_ms(sum(r["bytes"] for r in main),
                         sum(r["ops"] for r in main), dtype)
    return {"name": name, "route": "cuda",
            "source": source or f"poseidon_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": least, "bound_by": by,
            "library_ms": (None if any(v is None for v in libs)
                           else sum(libs)),
            "main_cases": list(main_cases), "main_dtype": dtype, **extra,
            "cases": records}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        card = card_line()
        print(card, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        phase_build()
        from poseidon_tpu_torch.core.net import Net
        from poseidon_tpu_torch.numeric import policy_scope
        from poseidon_tpu_torch.proto.messages import load_net
        arena_total = Net(load_net(ALEXNET), "TEST",
                          device="cpu").param_count()
        k4, k4_attrs = phase_kernels(card)
        k5 = phase_lrn_bwd(card)
        k6, k6_attrs = phase_pool_bwd(card)
        k7 = phase_sgd(card, arena_total)
        k1, fwd_attrs = phase_flash(card)
        k2, k3, bwd_attrs = phase_flash_bwd(card)
        k4n, k5n, k6n, conv1, layout = phase_layout(card)
        serving_launches, ex, solo = phase_slice(card)
        phase_net_checks(ex)
        phase_breakdown(ex, card, solo["p50_ms"])
        del ex
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root:
            train = phase_train(card, root)
            torch.cuda.empty_cache()
            loop = phase_loop(card, root, train["step_ms"])
            torch.cuda.empty_cache()
            bf16 = phase_bf16_train(card, root, train)
            torch.cuda.empty_cache()
            dp = phase_dp(card, root)
            torch.cuda.empty_cache()
            topk = phase_topk(card, root)
            torch.cuda.empty_cache()
            ssp = phase_ssp(card, root)
        torch.cuda.empty_cache()
        lm = phase_lm(card)
        torch.cuda.empty_cache()
        lm_train = phase_lm_train(card)
        torch.cuda.empty_cache()
        with policy_scope(compute_dtype=torch.bfloat16):
            bf16_lm = phase_lm_train(card, tag="bf16_lm_train",
                                     step_tol=BF16_LM_STEP_TOL,
                                     grad_tol=BF16_LM_GRAD_TOL,
                                     peak=("bfloat16", OPS_PER_S["bfloat16"]))
        torch.cuda.empty_cache()
        lm_corpus = phase_lm_corpus(card)
        digits_acc = phase_digits(card)
        bf16_digits_acc = phase_digits(card, ("--bf16",), "bf16_digits")
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        return 1

    launches = train["launches"]
    bf16_launches = bf16["launches"]
    dp_launches = dp["launches"]
    topk_launches = topk["launches"]
    loop_launches = loop["pipelined"]["launches"]
    kernels = [
        kernel_entry("lrn_fwd", "poseidon_tpu/ops/pallas_kernels.py:443",
                     launches["lrn_fwd"], k4, ("norm1 train", "norm2 train"),
                     launches_by_path={"serving": serving_launches,
                                       "training": launches["lrn_fwd"],
                                       "dp": dp_launches["lrn_fwd"],
                                       "topk": topk_launches["lrn_fwd"],
                                       "loop": loop_launches["lrn_fwd"],
                                       "bf16_train": bf16_launches[
                                           "lrn_fwd"]},
                     attributes=k4_attrs),
        kernel_entry("lrn_bwd", "poseidon_tpu/ops/pallas_kernels.py:601",
                     launches["lrn_bwd"], k5, ("norm1", "norm2"),
                     launches_by_path={"training": launches["lrn_bwd"],
                                       "dp": dp_launches["lrn_bwd"],
                                       "topk": topk_launches["lrn_bwd"],
                                       "loop": loop_launches["lrn_bwd"],
                                       "bf16_train": bf16_launches[
                                           "lrn_bwd"]}),
        kernel_entry("pool_bwd", "poseidon_tpu/ops/pallas_kernels.py:741",
                     launches["pool_bwd"], k6, ("pool1", "pool2", "pool5"),
                     launches_by_path={"training": launches["pool_bwd"],
                                       "dp": dp_launches["pool_bwd"],
                                       "topk": topk_launches["pool_bwd"],
                                       "loop": loop_launches["pool_bwd"],
                                       "bf16_train": bf16_launches[
                                           "pool_bwd"]},
                     attributes=k6_attrs),
        kernel_entry("sgd_update", "poseidon_tpu/ops/pallas_kernels.py:838",
                     launches["sgd_update"], k7, ("alexnet arena",),
                     launches_by_path={"training": launches["sgd_update"],
                                       "dp": dp_launches["sgd_update"],
                                       "topk": topk_launches["sgd_update"],
                                       "loop": loop_launches["sgd_update"],
                                       "bf16_train": bf16_launches[
                                           "sgd_update"]}),
        kernel_entry("flash_fwd", "poseidon_tpu/ops/pallas_kernels.py:77",
                     lm["flash_launches"], k1, ("prefill 256",),
                     launches_by_path={"lm_serving": lm["flash_launches"],
                                       "lm_training": lm_train["launches"][
                                           "flash_fwd"],
                                       "lm_corpus": lm_corpus["launches"][
                                           "flash_fwd"],
                                       "cnn_serving": 0,
                                       "cnn_training": launches["flash_fwd"],
                                       "dp": dp_launches["flash_fwd"],
                                       "topk": topk_launches["flash_fwd"],
                                       "loop": loop_launches["flash_fwd"],
                                       "bf16_lm_training": bf16_lm[
                                           "launches"]["flash_fwd"],
                                       "bf16_train": bf16_launches[
                                           "flash_fwd"]},
                     launches_per_prefill=(lm["flash_launches"]
                                           // max(1, lm["prefills"])),
                     profiled_ms_per_prefill_256=lm["prefill_flash_ms"],
                     launches_per_training_step=lm_train[
                         "launches_per_step"]["flash_fwd"],
                     bound_3xtf32_ms=sum(r["bound_3xtf32_ms"] for r in k1
                                         if r["case"] == "prefill 256"
                                         and r["dtype"] == "float32"),
                     training_launch={
                         k: next(r for r in k1 if r["case"] == "train")[k]
                         for k in ("ms", "device_ms", "bound_ms",
                                   "bound_3xtf32_ms", "library_ms")},
                     bf16_training_launch=bf16_launch(k1, "train"),
                     launches_per_bf16_training_step=bf16_lm[
                         "launches_per_step"]["flash_fwd"],
                     profiled_ms_per_bf16_training_step=bf16_lm[
                         "port_kernels"]["flash_fwd"]["ms"],
                     attributes=fwd_attrs),
    ]
    for name, line, recs in (("flash_dq", 208, k2), ("flash_dkv", 255, k3)):
        kernels.append(kernel_entry(
            name, f"poseidon_tpu/ops/pallas_kernels.py:{line}",
            lm_train["launches"][name], recs, ("train main",),
            source="poseidon_tpu_torch/ops/csrc/flash_bwd.cu",
            launches_per_training_step=lm_train["launches_per_step"][name],
            launches_by_path={"lm_training": lm_train["launches"][name],
                              "lm_corpus": lm_corpus["launches"][name],
                              "lm_serving": lm["launches"][name],
                              "cnn_training": launches[name],
                              "dp": dp_launches[name],
                              "topk": topk_launches[name],
                              "loop": loop_launches[name],
                              "bf16_lm_training": bf16_lm["launches"][name],
                              "bf16_train": bf16_launches[name]},
            profiled_ms_per_training_step=lm_train["port_kernels"][name][
                "ms"],
            bf16_training_launch=bf16_launch(recs, "train main"),
            launches_per_bf16_training_step=bf16_lm["launches_per_step"][
                name],
            profiled_ms_per_bf16_training_step=bf16_lm["port_kernels"][
                name]["ms"],
            bound_3xtf32_ms=sum(r["bound_3xtf32_ms"] for r in recs
                                if r["case"] == "train main"
                                and r["dtype"] == "float32"),
            attributes_d64={dt: a[f"{name}_kernel"]
                            for dt, a in bwd_attrs.items()},
            plain_and_library_cover="dq, dk and dv together"))
    # the channels-last kernels, whose main path is [bf16_train]'s
    # Engine.train() (bf16, NHWC)
    for name, line, src, recs, cases in (
            ("lrn_fwd_nhwc", 443, "lrn_fwd", k4n, ("norm1", "norm2")),
            ("lrn_bwd_nhwc", 601, "lrn_bwd", k5n, ("norm1", "norm2")),
            ("pool_bwd_nhwc", 741, "pool_bwd", k6n,
             ("pool1", "pool2", "pool5"))):
        kernels.append(kernel_entry(
            name, f"poseidon_tpu/ops/pallas_kernels.py:{line}",
            bf16_launches[name], recs, cases,
            source=f"poseidon_tpu_torch/ops/csrc/{src}.cu",
            dtype="bfloat16",
            launches_by_path={"bf16_train": bf16_launches[name],
                              "bf16_loop": bf16["loop"]["launches"][name],
                              "training": launches[name],
                              "loop": loop_launches[name],
                              "dp": dp_launches[name],
                              "topk": topk_launches[name],
                              "lm_training": lm_train["launches"][name]},
            f32_main={k: sum(r[k] for r in recs if r["case"] in cases
                             and r["dtype"] == "float32")
                      for k in ("ms", "plain_ms", "library_ms", "bytes")},
            profiled_ms_per_bf16_training_step=bf16["port_kernels"][name][
                "ms"],
            library_ratio={dt: layout["library_ratio"][f"{name} {dt}"]
                           for dt in ("float32", "bfloat16")},
            attributes={k: v for k, v in layout["attributes"].items()
                        if k.startswith(name)},
            **({"powf_floor_ms": layout["powf_floor_ms"],
                "powf_floor_elements": layout["powf_floor_elements"]}
               if name == "lrn_bwd_nhwc" else {}),
            **({"powf_floor_ms": layout["powf_floor_1_ms"],
                "powf_floor_elements": layout["powf_floor_elements"],
                "bf16_ms_by_lane_channels": layout[
                    "lrn_fwd_nhwc_bf16_widths"]}
               if name == "lrn_fwd_nhwc" else {})))
    # the SSP paths: the compiled step in this process (DENSE, in each
    # layout), the two `train --staleness` ranks, the two async-SSP ranks
    # (every rank's)
    for entry in kernels:
        name = entry["name"]
        entry["launches_by_path"].update(
            ssp=ssp["layouts"]["NCHW"]["launches"][name],
            ssp_nhwc=ssp["layouts"]["NHWC"]["launches"][name],
            ssp_cli=ssp["cli_launches"][name],
            async_ssp=ssp["async_launches"][name])
    summary = {"train_step_ms": train["step_ms"],
               "train_peak_bytes": train["peak_bytes"],
               "train_loop": train["loop"],
               "train_port_kernels": train["port_kernels"],
               "digits_final_accuracy": digits_acc,
               "dp": dp,
               "topk": topk,
               "ssp": ssp,
               "loop": loop,
               "lm_serving": lm,
               "lm_training": lm_train,
               "lm_corpus": lm_corpus,
               "layout_conv1": conv1,
               "bf16_train": bf16,
               "bf16_lm_training": bf16_lm,
               "bf16_digits_final_accuracy": bf16_digits_acc,
               "wall_s": time.perf_counter() - t_start}
    print(f"[summary] {json.dumps(summary)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
