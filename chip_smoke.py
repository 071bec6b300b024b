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
     (1,3,48,16), and ``[lm_par]``'s call sites in f32 and bf16 (a seq
     rank's ring blocks, modes 0 and +1 at (4,12,512,64); a tp or Ulysses
     rank's 6 heads at (4,6,1024,64)) and ``[lm_pp_ep]``'s (a pp2
     microbatch's, an ep2 rank's and the CLI pairs' (2,12,1024,64), a
     pp2xtp2 rank's (2,6,1024,64); the MoE decode's prefill is the
     (1,12,64,64) prefill case) and ``[lm_tp_serve]``'s (a tp2 shard's
     prefill, (1,6,16|64|256,64) f32); the library yardstick is
     F.scaled_dot_product_attention.
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
     (1,3,48,16), ``[lm_par]``'s and ``[lm_pp_ep]``'s call sites as for
     K1 (the ring blocks with delta passed in); the library yardstick is the backward of
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
   Then ``[fleet]``: (a) AlexNet deploy as 3 replicas on cuda:0
   (``build_serving_fleet`` with devices 0,0,0, seed-0 filler weights,
   each batcher admitting FLEET_MAX_QUEUE requests) behind
   ``InferenceServer(fleet=...)``: replies of 1, 4, 16 and 64 rows from
   each replica within NET_TOL of a direct forward; bucket-64 closed loops
   at 1, 2, 3 and 6 clients (p50/p99, img/s, the front door's and replica
   0's batcher's p50, every replica routed at 3), beside ``[slice]``'s
   one-engine runs of the same call at 1 and 2; open loops from clients
   enough for their rate: probes at 1.5, 2 and 3x the best closed loop up
   to the first that sheds, the best goodput of the closed loops and
   probes the capacity (saturated if a probe shed), then 0.5x and 1.5x of
   the capacity (goodput, sheds, late fires, the rate the requests left
   at, whether the offered rate was realized; the 0.5x loop must realize
   it); a rolling
   reload to seed-1 weights under load (no request errors, at most one
   replica draining in the transition log, every reply during the roll
   within NET_TOL of exactly one of the two forwards on the rows where
   they differ, every later one of the new); replica 0 killed mid-load
   (its executor made to raise): no accepted request lost, one DEAD
   replica; K4 launches exactly 2 x the replicas' forwards (counters
   zeroed before the build, warm-ups included). (b) gpt_small
   ``--generate`` (f32, max_seq 512) as 2 replicas: 32 prompts from 8
   clients with greedy tokens equal to one GenerateExecutor's (that pass,
   straight into the executor's scheduler, and the same prompts through
   the socket to a 1-replica fleet, timed beside the fleet's waves), a
   rolling reload to seed-1 weights, the same prompts again equal to the seed-1
   executor's; K1 exactly 12 x the replicas' prefills; K1 against its
   plain version at their prefill shapes is ``[flash_fwd]``'s "prefill"
   cases, printed again. (c) ``serve --replicas 2 --devices 0,0 --watch
   <prefix> --poll_s 0.5 --metrics_port 0`` as a child: a reply at the
   seed-0 forward, a seed-1 ``<prefix>_iter_2.solverstate.npz`` and the
   ``reload`` op, replies at the seed-1 forward, ``serving.replicas.0.*``
   and ``.1.*`` rows on the metrics endpoint, exit 0 on SIGTERM with the
   final stats line; then ``bench_serve --replicas 2 --offered_rps R``'s
   JSON line; each child's K4 launches exactly 2 x its forwards.
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
6b. ``[zoo]`` (``phase_zoo``, after the SSP, mesh and fabric phases): (a)
   GoogLeNet from ``models/zoo.py`` (aux heads, 1000 classes) at batch 32
   x 3 x 224 x 224 in f32, planned "auto" (NHWC on the card) as an
   unflagged ``train`` plans it, bvlc_googlenet's quick solver, synthetic
   uint8-range images less the ILSVRC means: one warm-up step, then 5
   steps by CUDA events (ms a step, img/s, peak memory), the launch
   counters zeroed just before and read just after: exactly 2 K4-NHWC, 2
   K5-NHWC, 16 K6-NHWC (13 MAX, 3 AVE) and 1 K7 a step; one step with the
   kernels against the same step with the plain versions at STEP_TOL;
   the device step of TIMED_STEPS more and one profiled step's kernels
   by kind (every port kernel must show device time);
   K6-NHWC alone at the inception modules' 3x3 s1 p1 pools (32, C,
   28|14|7, 28|14|7), bitwise to plain, beside the library's backward and
   the bytes bound (CUDA events and the profiler's device time). (b) The
   catalog net (``examples/catalog/layer_catalog.prototxt``: every layer
   type beyond the CNN core, STOCHASTIC pooling, a shared conv weight,
   the uniform, sparse gaussian and positive_unitball fillers), one
   forward and backward on the card against the CPU at NET_TOL, and the
   siamese example net 3 SGD steps on the card against the CPU at
   NET_TOL, each sharer's blob its owner's arena leaf, K6 2 and K7 1 a
   step. The phase must take at most 60 s.
6c. ``[dispatch]`` and ``[remat]`` (``phase_dispatch`` after ``[train]``,
   ``dispatch_googlenet`` after ``[zoo]``), f32, "auto" layout (NHWC on
   the card), cuDNN's deterministic algorithms on, an ``inv`` rate that
   moves every step: (a) AlexNet train_val at batch 256 on [train]'s
   LMDB through ``Engine.train()`` at ``steps_per_dispatch``
   DISPATCH_K for DISPATCH_ITERS steps (chunks at 0, 4 and 8: the first
   runs its steps eagerly and captures them into one CUDA graph, the
   others replay it), the counters zeroed just before and read just after:
   the wrappers count the warm-up's launches and the capture's (each
   replay launches what the capture recorded, without a wrapper call), so
   a replay's K4-/K5-/K6-NHWC and K7's device-rate entry are the capture's
   counts and the kernels ran warm-up + replays x capture times; (b) the
   K-step graph against K eager steps, bitwise (params, momentum, losses)
   over two dispatches, from one state and the same batches and dropout
   stream; (c) ms a step by CUDA events, eager and graph, in turns, and
   the card's busy share of each (torch.profiler's device time over the
   CUDA-event wall of the same calls); the same on GoogLeNet (``[zoo]``'s
   net, batch 32, ``reuse_batch``), bitwise too, its launches counted the
   same way. (d) K7's device-rate entry against its plain version over
   the AlexNet arena at an ``inv`` rate (in ``[sgd_update_devrate]``).
   ``[remat]``: the no-remat step's peak on the card
   (``measured_peak_bytes``), then ``Engine(remat="auto",
   hbm_budget_gb=REMAT_BUDGET_SHARE x that peak, steps_per_dispatch=K)``:
   its plan's layers, ``Engine.train()`` for REMAT_ITERS steps (launches
   counted), and the remat arm (eager, and one replay of the engine's
   graph, whose checkpointed dropouts draw from registered generator
   slots) against the stored arm, bitwise over DISPATCH_K steps, with the
   peak memory above the start and ms a step of each arm. The two phases
   must take at most DISPATCH_BUDGET_S together.
6d. ``[tune]`` and ``[profile]`` (``phase_tune``, ``phase_profile``, after
   ``[tools]``, on its LMDB), f32: (a) the im2col lowering against the
   direct conv on AlexNet's conv1, conv3 and conv4 (grouped: im2col takes
   direct, bitwise) at TUNE_CONV_BATCH x 227², NCHW and NHWC, cuDNN
   deterministic: y, dx and dw each within IM2COL_TOL of its sum's L1
   bound, the output in x's memory format, each lowering's forward and
   forward+backward CUDA-event ms; (b) ``python -m poseidon_tpu_torch
   tune --model alexnet --windows 2 --iters 2`` as a child (the full
   space at 32 x 227², its store under the temporary directory) reporting
   its launches: every trial row, each conv layer's winner and timings,
   the composite A/B (never slower than the defaults) and search_cost_s;
   its step arms must have launched K4-K7, K4-/K5-/K6-NHWC and K7's
   device-rate entry; (c) a second ``tune`` loads the plan
   (``"source": "persisted"``) within TUNE_MEMO_MAX_S; (d) ``train``
   with the plan loaded (``--tuned_plan auto``) and with its knobs as
   flags (``--tuned_plan off``), TUNE_TRAIN_ITERS steps at batch 256,
   cuDNN deterministic: snapshots bitwise, stats.yaml's ``tuned_plan``
   sources "(plan)" and "(flag)". ``[profile]``: ``train --profile
   PROFILE_STEPS`` at batch 256 in the layout ``train`` plans on the card
   (NHWC): the trace and the per-layer table (``runtime/attribution``),
   K4-NHWC in norm1/norm2's forward rows, K5-NHWC in their backward rows,
   K6-NHWC in the pools' backward rows, K7 in ``optimizer_update``; each
   kernel's events in the trace equal its counter's rise over the window
   (a session that dropped some runs again, at most PROFILE_TRIES times);
   named coverage at least PROFILE_COVERAGE; the residual's top ops. The
   two phases must take at most TUNE_PROFILE_BUDGET_S together.
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
   Then ``[lm_tp_serve]``: the same gpt_small as a tp2 ``GenerateExecutor``
   (``mesh_cfg`` tp 2, both shards on cuda:0, built through
   ``build_generate_executor``) beside the one-device executor from the
   same weights: (a) prefill logits at every bucket within LM_TOL, and the
   tokens of LM_REQUESTS requests from LM_CLIENTS clients equal, or each
   flip shown as an f32 near-tie (the two top logits within LM_TOL of each
   other at the first step that differs, both arms fed the same prefix);
   (b) launch counters zeroed before the tp2 traffic and read after it:
   flash_fwd exactly 2 x 12 a prefill (K1 itself is held against its
   plain version at the shards' (1,6,16|64|256,64) in ``[flash_fwd]``);
   (c) ``swap_params`` to seed-1 weights while LMTP_SWAP_REQUESTS
   requests are in flight: each completes, and the requests submitted
   after the swap give the seed-1 one-device executor's tokens; (d)
   generated tokens/s at 8 and at 1 client, and a decode step's host wall
   beside its profiled device busy time at rungs 1 and 8, both executors
   in this call.
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
10. ``[lm_par]``, LM sequence and tensor parallelism, every rank a gloo
   process sharing the card (a correctness path): one job of LMP_RANKS
   ranks runs (a) ``ring_flash_attention`` and ``ulysses_attention`` over
   a seq group of 2, a rank's block (4,12,512,64) of a causal sequence of
   1024, f32 and bf16: out, dq, dk, dv against K1-K3 and against the
   plain versions on the gathered sequence (FLASH_TOL / FLASH_BWD_TOL;
   bf16's atol LMP_BF16_ATOL_SHARE of the largest magnitude), exact
   launches a rank (ring: rank r runs r + 1 of K1 forward and of K2 and K3
   backward; Ulysses one each), the card ms of each rank's ring forward
   and backward beside the one-device flash; (b) gpt_small at full width
   and LMP_LAYERS of its 12 layers (remat on), f32, global batch 4 x
   1024: the one-device step
   (the control, rank 0), then sp2 (data 1 x seq 2), tp2 (data 1 x model
   2) and sp2xtp2 (data 1 x seq 2 x model 2), each from the control's
   weights, a warm-up and LMP_STEPS steps: after step 1 the loss within
   LMP_LOSS_RTOL and every leaf within LMP_TOL of the control's, after
   the last the max abs difference; exact K1-K3 launches a rank (2 L
   (r+1) K1 and L (r+1) K2 and K3 a step at seq index r, L the layers;
   2L/L/L under tp);
   the wall a step, the peak memory a rank and the bytes a rank sends a
   step by kind (ring K/V, ring dK/dV, tp all-reduces, gradient
   all-reduces); (c) two ``train_lm --mode sp --par_axis 2`` and two
   ``--mode tp --par_axis 2`` ranks at gpt_small's width (LMP_CLI_ARGS),
   at once: exit 0, finite losses falling, rank 0's display lines with
   tok/s, each rank's launches.
11. ``[lm_pp_ep]``, LM pipeline and expert parallelism, every rank a gloo
   process sharing the card (a correctness path): one job of LPE_RANKS
   ranks runs (a) gpt_small at full width and LMP_LAYERS layers (remat
   on), f32, global batch 4 x 1024: the one-device step (the control,
   rank 0), then pp2 (data 1 x stage 2, half the layers a stage,
   LPE_MICRO microbatches) and
   pp2xtp2 (data 1 x stage 2 x model 2), each from the control's weights
   (``pp_shard`` of ``to_pp_layout``), a warm-up and LMP_STEPS steps:
   after step 1 the loss within LMP_LOSS_RTOL and every leaf within
   LMP_TOL of the control's, after the last the max abs difference; the
   stage ranks' non-block leaves bitwise alike; (b) the same width with
   LPE_EXPERTS experts a layer (``MoEConfig``, capacity factor 1.25, so
   tokens drop): ep2 (data 1 x expert 2) against a one-device control
   that routes each rank's row block as its own source (its losses and
   gradients summed at the global normalizer: ep2's function, drops
   included), the same checks plus each layer's dropped tokens equal in
   both arms; and a dropless cached decode (``generate`` with the
   ``MoEConfig``, a prompt of LPE_DECODE_PROMPT tokens) equal to
   ``moe_forward``'s argmax on the grown sequence. Exact K1-K3 launches a
   rank, the wall a step, the peak memory a rank and the bytes a rank
   sends a step by kind (pp activations and cotangents, the stage sum,
   tp all-reduces, the ep dispatch and return, the gradient sums); (c)
   two ``train_lm --mode pp --par_axis 2 --microbatches 2`` and two
   ``--mode ep --par_axis 2 --experts 8`` ranks at LMP_CLI_ARGS, at once:
   exit 0, finite losses falling, rank 0's display lines, each rank's
   launches exact.
12. Real data end to end: ``python -m poseidon_tpu_torch train`` on the
   digits solver (1000 iterations, real UCI digits from the repo) into a
   temporary directory, f32 and ``--bf16`` at once; each final test
   accuracy must reach DIGITS_MIN_ACC.
13. One JSON line with every kernel's numbers (launches by path, ``zoo_*``,
    ``dp``, ``topk``, ``loop``, ``lm_par_*``, ``lm_pp_ep_*``,
    ``lm_tp_serve``, ``fleet_cnn``, ``fleet_generate``, ``fleet_cli``,
    ``tune`` and ``profile`` among them), then the ``ok`` line.
"""

from __future__ import annotations

import contextlib
import csv
import gc
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
LOAD_REQUESTS = 150
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
# the [lm_tp_serve] phase: gpt_small served tensor-parallel over LMTP_TP
# shards, every shard on cuda:0 (the machine has one GPU, so a check of
# the tp path's correctness and launches, not of tp on cards of their
# own), beside the one-device executor from the same seed-0 weights
LMTP_TP = 2
LMTP_SWAP_REQUESTS = 8
LMTP_TIMING_RUNGS = (1, 8)
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
# the [lm_par] phase: LM sequence and tensor parallelism, every rank a
# gloo process sharing the card (NCCL cannot put two ranks on one GPU), so
# a correctness path, not a speed claim. (a) ring flash attention and
# Ulysses over a seq group of 2 at gpt_small's attention shape, a rank's
# block LMP_ATT_SHAPE (a global sequence of 1024), causal, f32 and bf16,
# against the flash kernels and the plain versions on the gathered
# sequence; (b) gpt_small at full width and LMP_LAYERS layers (remat on),
# f32, global
# batch LMP_BATCH x LMP_SEQ, seeded as [lm_train], the one-device step (the
# control) and each of LMP_ARMS from the control's weights: a warm-up
# step, then LMP_STEPS steps from the same weights; (c) two `train_lm
# --mode sp --par_axis 2` and two `--mode tp --par_axis 2` ranks
LMP_RANKS = 4
LMP_ATT_SHAPE = (4, 12, 512, 64)
LMP_ATT_SHAPE_TINY = (1, 4, 64, 16)     # a CPU rehearsal's
LMP_BATCH, LMP_SEQ, LMP_STEPS = 4, 1024, 3
# the depth of (b), of [lm_pp_ep]'s (a) and (b) and of both phases' CLI
# ranks: gpt_small's width at a third of its 12 layers, cut to keep the
# whole smoke inside 1000 s of its 1200 s limit (1032 s at 12 layers and
# 950.6 s at 6 on one H100, before [lm_tp_serve] added ~50 s)
LMP_LAYERS = 2
LMP_ARMS = {"sp2": (("data", "seq"), (1, 2), "sp"),
            "tp2": (("data", "model"), (1, 2), "tp"),
            "sp2xtp2": (("data", "seq", "model"), (1, 2, 2), "tp")}
# after step 1 every arm against the control: the loss and every leaf
# (the ring regroups attention's sums, tp the wo and w2 contractions)
LMP_LOSS_RTOL = 1e-5
LMP_TOL = (1e-4, 1e-6)
# the ring's outputs against the gathered sequence in bf16: FLASH_TOL's
# (FLASH_BWD_TOL's) rtol, and an atol of its atol or 2^-7 of the largest
# magnitude in the reference's block a head (this rank's rows of one
# (batch, head)), whichever is larger:
# each ring block's out (and dq, dk, dv) leaves K1 (K2, K3) in bf16 and is
# merged in f32, and delta comes from the merged bf16 output, so an entry
# whose blocks nearly cancel sits a bf16 rounding of a block's value from
# the one-pass kernel (as in JAX's ring; tests/test_torch_sequence.py
# pins it on the CPU). A row's own largest magnitude is too small a scale
# for a late key's dk, which few queries feed. Ulysses runs one K1-K3
# pass over its heads and is held at FLASH_TOL / FLASH_BWD_TOL.
LMP_BF16_ATOL_SHARE = 2 ** -7
# (c) at gpt_small's width: the script's default lr 0.05 (sized for its
# d 128) diverges there (read on the card: 5.84 -> 15.68 in 6 steps);
# 0.005 falls smoothly (on the CPU at seq 128: 5.98 -> 3.73)
LMP_CLI_ARGS = ("--d_model", "768", "--n_heads", "12",
                "--n_layers", str(LMP_LAYERS),
                "--seq", "1024", "--batch", "4", "--steps", "4",
                "--display", "2", "--remat", "--lr", "0.005")
LMP_TIMEOUT_S = 600
# a child `train_lm` rank that reports its kernel launches when it returns
LMP_CLI_LAUNCH = (
    "import json, sys\n"
    "from poseidon_tpu_torch.models.train_lm import main\n"
    "main(sys.argv[1:])\n"
    "from poseidon_tpu_torch.ops import flash\n"
    "print('[launches] ' + json.dumps(flash.LAUNCHES), flush=True)\n")

# the [lm_pp_ep] phase: LM pipeline and expert parallelism, every rank a
# gloo process sharing the card, a correctness path as [lm_par]: (a)
# gpt_small (remat, f32, LMP_BATCH x LMP_SEQ) as the one-device control
# and LPE_PP_ARMS; (b) the same width with LPE_EXPERTS experts a layer as
# ep2 and its per-source control, and a dropless MoE decode; (c) the
# train_lm pp and ep pairs at LMP_CLI_ARGS. Step 1 against the control at
# [lm_par]'s LMP_LOSS_RTOL and LMP_TOL.
LPE_RANKS = 4
LPE_MICRO = 2
LPE_PP_ARMS = {"pp2": (("data", "stage"), (1, 2), False),
               "pp2xtp2": (("data", "stage", "model"), (1, 2, 2), True)}
LPE_EXPERTS = 8
LPE_EP_SHAPE = (1, 2)
LPE_DECODE_PROMPT, LPE_DECODE_NEW = 64, 8
LPE_CLI_MODES = {"pp": ("--par_axis", "2", "--microbatches", "2"),
                 "ep": ("--par_axis", "2", "--experts", "8")}
LPE_TIMEOUT_S = 600

# whole-net comparisons (rtol, atol) on prob and every blob
NET_TOL = (1e-4, 1e-6)
# the [fleet] phase, the serving fleet on the card: (a) AlexNet deploy as
# FLEET_REPLICAS replicas on cuda:0 (`build_serving_fleet`, devices 0,0,0,
# buckets 1/4/16/64, seeded filler weights) behind InferenceServer(fleet=),
# each replica's batcher admitting FLEET_MAX_QUEUE requests so that an
# overloaded fleet sheds: every bucket's reply from each replica; bucket-64
# closed loops of FLEET_CLOSED_REQUESTS at FLEET_CLOSED_CLIENTS clients (1
# and 2 as [slice]'s engine runs, FLEET_REPLICAS, and two a replica); open
# loops, each planned for FLEET_OPEN_S from 2 x rate x the deepest closed
# loop's p99 clients (at most FLEET_OPEN_MAX_CLIENTS): probes at
# FLEET_PROBE_LOADS x the best closed loop up to the first that sheds, the
# best goodput of the closed loops and probes the capacity, then
# FLEET_OPEN_LOADS of the capacity; a rate is realized if at most
# FLEET_OPEN_LATE_SHARE of the requests fired late and they left at 0.95
# of it or more (the 0.5x loop must realize it); a rolling reload to
# seed-1 weights under FLEET_ROLL_CLIENTS clients; replica 0 killed (its executor made to raise) under a closed loop of
# FLEET_KILL_REQUESTS. (b) gpt_small --generate (f32, max_seq 512) as
# FLEET_LM_REPLICAS replicas: FLEET_LM_REQUESTS prompts from LM_CLIENTS
# clients (max_new FLEET_LM_MAX_NEW), a rolling reload to seed-1 weights,
# the same prompts again, all beside one executor's scheduler and a
# 1-replica fleet on the same prompts. (c) `serve --replicas 2 --devices 0,0 --watch
# <prefix> --poll_s 0.5 --metrics_port 0` and `bench_serve --replicas 2
# --offered_rps R` as subprocesses.
FLEET_REPLICAS = 3
FLEET_MAX_QUEUE = 4
FLEET_CLOSED_REQUESTS = 60
FLEET_CLOSED_CLIENTS = (1, 2, 3, 6)
FLEET_PROBE_LOADS = (1.5, 2.0, 3.0)
FLEET_OPEN_LOADS = (0.5, 1.5)
FLEET_OPEN_S = 2.0
FLEET_OPEN_MAX_CLIENTS = 64
FLEET_OPEN_LATE_SHARE = 0.05
FLEET_ROLL_CLIENTS = 3
FLEET_KILL_REQUESTS = 60
FLEET_LM_REPLICAS = 2
FLEET_LM_REQUESTS = 32
FLEET_LM_MAX_NEW = 16
FLEET_CLI_REQUESTS = 40
FLEET_TIMEOUT_S = 300
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
SSP_CLI_BATCH, SSP_CLI_ITERS = 128, 6
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


# the [spmd] phase, AlexNet train_val at full width, f32 (unflagged
# `train` ranks plan NHWC on the card), on [train]'s synthetic LMDB, every
# child under cuDNN's deterministic algorithms (SPMD_LAUNCH): (a) two
# `train --mesh fsdp2` ranks, then two `--mesh fsdp2,replicated` ranks;
# (b) two `--mesh tp2` ranks, then two `--mesh tp2,replicated`; (c) two
# `--mesh fsdp2 --staleness 2` ranks; SPMD_CLI_ITERS iterations each at
# SPMD_CLI_BATCH a rank, the ranks sharing the card over gloo; (b) also
# runs both arms for SPMD_TP_GATE_ITERS iterations, at once, and both arms
# in one pair of processes (spmd_tp_pair). (d) in this process, K7
# on AlexNet's shard-major fsdp shards for each of SPMD_FSDP and at
# tp2's two lengths. The pairs run two at a time (four gloo processes on
# the card): fsdp2 beside its control, spmd_tp_pair beside (c), each tp2
# run beside its control, so their walls a step are read under
# contention.
SPMD_CLI_BATCH, SPMD_CLI_ITERS = 128, 4
SPMD_FSDP = (2, 4)
# tp shards re-associate the FC contractions (cuBLAS blocks an (M/2, K)
# product otherwise than the (M, K) one; dx sums two partial products):
# for SPMD_TP_GATE_ITERS iterations (momentum carried into the second
# update) (b)'s params and momentum stay within the train-step tolerance
# of its replicated control. From the second forward on those ulps part
# ReLU and max-pool decisions, and a unit that flips moves its filter's
# (or its bias's) gradient by a whole term: the pair (spmd_tp_pair) reads
# the distance and the decisions apart after every iteration and fails if
# an element leaves the tolerance before a decision has parted, or if an
# arm's K7 call does not receive the params and momentum its previous
# call left (the carry between steps, bitwise). After SPMD_CLI_ITERS the
# CLI runs' losses are held at SPMD_TP_LOSS_RTOL and their distance is
# reported
SPMD_TP_TOL = (1e-4, 1e-6)
SPMD_TP_GATE_ITERS = 2
SPMD_TP_LOSS_RTOL = 1e-5
SPMD_LAUNCH = (
    "import torch\n"
    "torch.backends.cudnn.deterministic = True\n"
    + LAUNCH_REPORT.replace(
        "sys.exit(rc)\n",
        "if torch.cuda.is_available():\n"
        "    print('[peak] %d' % torch.cuda.max_memory_allocated(), "
        "flush=True)\n"
        "sys.exit(rc)\n"))


# the [fabric] phase, AlexNet train_val at full width, f32, planned NHWC
# on the card, under cuDNN's deterministic algorithms: (a) in this
# process, two SliceWorkers (parallel/fabric.py) over a loopback
# ParamService, each slice's local step the one-device train step at
# FABRIC_BATCH on seeded batches, FABRIC_CLOCKS clocks at staleness
# FABRIC_STALENESS, slice 1 killed at FABRIC_KILL (every member lost, its
# client abandoned raw) and re-admitted under its id at FABRIC_REJOIN,
# then the fixed-membership replay; each push applied before its refresh
# and the slices dispatched in order, so the two anchors and loss
# trajectories must be bitwise equal. (b) `train --async_ssp --slice
# --mesh fsdp2` as 2 slices x 2 gloo ranks sharing the card at
# FABRIC_CLI_BATCH a rank, FABRIC_CLI_ITERS iterations, a clock every
# FABRIC_CLI_SYNC (FABRIC_LAUNCH: every K7 call also runs the plain
# version on copies of its inputs and must agree bitwise)
FABRIC_BATCH = 64
FABRIC_CLOCKS, FABRIC_KILL, FABRIC_REJOIN, FABRIC_STALENESS = 5, 2, 3, 1
FABRIC_CLI_BATCH, FABRIC_CLI_ITERS, FABRIC_CLI_SYNC = 64, 4, 2
FABRIC_LAUNCH = (
    "import json, sys, torch\n"
    "torch.backends.cudnn.deterministic = True\n"
    "from poseidon_tpu_torch.ops import sgd\n"
    "from poseidon_tpu_torch.parallel import spmd\n"
    "k7 = []\n"
    "def checked(w, g, h, rate, lr, dec, mom):\n"
    "    wp, hp = w.clone(), h.clone()\n"
    "    sgd.sgd_update_plain_(wp, g, hp, rate, lr, dec, mom)\n"
    "    before = sgd.LAUNCHES['sgd_update']\n"
    "    sgd.sgd_update_(w, g, h, rate, lr, dec, mom)\n"
    "    k7.append({'length': w.numel(), 'launches': "
    "sgd.LAUNCHES['sgd_update'] - before, 'bitwise': bool(torch.equal(w, wp)"
    " and torch.equal(h, hp))})\n"
    "spmd.sgd_update_ = checked\n"
    + SPMD_LAUNCH.split("torch.backends.cudnn.deterministic = True\n", 1)[1]
    .replace("sys.exit(rc)\n", "print('[k7] ' + json.dumps(k7), "
             "flush=True)\nsys.exit(rc)\n"))

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


# [zoo]: GoogLeNet from models/zoo.py (aux heads, 1000 classes) at
# bvlc_googlenet's train batch, f32, planned as an unflagged `train` plans
# it ("auto": NHWC on the card; the catalog and siamese nets too, the CPU
# references NCHW), bvlc_googlenet's quick solver; synthetic
# uint8-range images from ZOO_SEED less the ILSVRC means. ZOO_WARMUP
# steps, then ZOO_TIMED_STEPS by CUDA events; the port kernels of one
# step (13 MAX and 3 AVE pools, 2 LRNs): exactly ZOO_LAUNCHES. K6-NHWC
# alone at the inception modules' 3x3 s1 p1 MAX pools (ZOO_POOLS). Then the
# catalog net (examples/catalog) forward and backward on the card against
# the CPU, and the siamese example net for ZOO_SIAMESE_STEPS steps.
ZOO_BATCH = 32
ZOO_SEED = 21
ZOO_WARMUP, ZOO_TIMED_STEPS = 1, 5
ZOO_LAUNCHES = {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2, "pool_bwd_nhwc": 16,
                "sgd_update": 1}
ZOO_SOLVER = dict(base_lr=0.01, lr_policy="poly", power=0.5,
                  max_iter=2400000, momentum=0.9, weight_decay=2e-4)
ZOO_POOLS = (("inception_3a/pool", (32, 192, 28, 28)),
             ("inception_3b/pool", (32, 256, 28, 28)),
             ("inception_4a/pool", (32, 480, 14, 14)),
             ("inception_4b/pool", (32, 512, 14, 14)),
             ("inception_4e/pool", (32, 528, 14, 14)),
             ("inception_5a/pool", (32, 832, 7, 7)))
ZOO_CATALOG = "examples/catalog/layer_catalog.prototxt"
ZOO_SIAMESE = "examples/siamese/mnist_siamese_train_test.prototxt"
ZOO_SIAMESE_BATCH, ZOO_SIAMESE_STEPS = 64, 3

# [tools]: AlexNet train_val at full width, f32, planned as an unflagged
# `train` plans it (NHWC on the card), on [train]'s synthetic LMDB. (a)
# batch TOOLS_MICRO x iter_size TOOLS_ITER_SIZE through Engine.train() for
# TOOLS_ITERS steps (exactly TOOLS_LAUNCHES a step); one step from fixed
# parameters on fixed micro-batches against a batch TOOLS_MICRO x
# TOOLS_ITER_SIZE step on the same rows, every dropout mask taken by row
# from one bank (TOOLS_SEED) so both arms drop the same units, at
# TOOLS_TOL (the CPU tests' PARAM_TOL: cuDNN may pick other algorithms at
# another batch); the same step against the plain versions at STEP_TOL;
# the device step of each arm by CUDA events (TOOLS_TIMED_STEPS after a
# warm-up, two rounds in turns) and its peak memory. (b) `time` and (c)
# `extract_features` as children (TOOLS_TIME_ITERS timed calls), and the
# dataset tools on the LMDB (TOOLS_LEVELDB_RECORDS through a LevelDB).
TOOLS_MICRO, TOOLS_ITER_SIZE, TOOLS_ITERS = 128, 2, 4
TOOLS_LAUNCHES = {"lrn_fwd_nhwc": 4, "lrn_bwd_nhwc": 4, "pool_bwd_nhwc": 6,
                  "sgd_update": 1}
TOOLS_TOL = (1e-4, 1e-6)
TOOLS_SEED = 22
TOOLS_TIMED_STEPS = 3
TOOLS_TIME_ITERS = 10
TOOLS_LEVELDB_RECORDS = 8
TOOLS_BUDGET_S = 60.0
TOOLS_TIMEOUT_S = 300

# [dispatch] and [remat] (the docstring's 6c): K steps a dispatch, a CUDA
# graph on the card; DISPATCH_LAUNCHES and DISPATCH_ZOO_LAUNCHES are one
# step's port kernels (K7 through its device-rate entry); the remat plan's
# budget is REMAT_BUDGET_SHARE of the measured no-remat peak.
DISPATCH_K = 4
DISPATCH_ITERS = 12
DISPATCH_SEED = 23
DISPATCH_LR = dict(lr_policy="inv", gamma=0.01, power=0.75)
DISPATCH_LAUNCHES = {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2,
                     "pool_bwd_nhwc": 3, "sgd_update_devrate": 1}
DISPATCH_ZOO_LAUNCHES = {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2,
                         "pool_bwd_nhwc": 16, "sgd_update_devrate": 1}
DISPATCH_TURNS = ("eager", "graph", "graph", "eager")
REMAT_BUDGET_SHARE = 0.75
REMAT_ITERS = 8
DISPATCH_BUDGET_S = 90.0


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


# The device kernel each launch counter counts, one a counted launch: the
# names torch.profiler gives those kernels' device ops.
COUNTED_KERNELS = {"lrn_fwd": "lrn_fwd_tile_kernel",
                   "lrn_bwd": "lrn_bwd_kernel",
                   "lrn_fwd_nhwc": "lrn_nhwc_fwd_kernel",
                   "lrn_bwd_nhwc": "lrn_nhwc_bwd_kernel",
                   "pool_bwd": "pool_bwd_band_kernel",
                   "pool_bwd_nhwc": "pool_nhwc_band_kernel",
                   "sgd_update": "sgd_update_kernel",
                   "flash_fwd": "flash_fwd_kernel",
                   "flash_dq": "flash_dq_kernel",
                   "flash_dkv": "flash_dkv_kernel"}


def profiled_device_ms(fn, key: str = "", reps: int = 10,
                       tries: int = 10) -> float:
    """Device time of one call of ``fn``: the durations of its device ops
    whose name holds ``key`` (a port kernel's name, or "" for all ops),
    summed over ``reps`` calls under torch.profiler, divided by ``reps``.
    Each session traces a dropped round of ``reps`` calls, then a kept
    one. The profiler can lose device ops launched through the port's
    ctypes libraries (whole sessions of small K6-NHWC launches, or some of
    them), so a kept round counts before it is summed: each port kernel
    must show exactly ``reps`` x its launch counter's rise over one call,
    and without a ``key`` (no counter speaks for library ops) the round's
    op count must be a nonzero multiple of ``reps`` equal to another
    session's, and the two sessions' sums are averaged. A session that
    fails its count runs again, up to ``tries``; then SmokeFailure, so no
    0 and no partial sum is returned. The schedule's step annotations are
    no device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    before = read_launches()
    fn()
    torch.cuda.synchronize()
    want = {COUNTED_KERNELS[k]: reps * (n - before[k])
            for k, n in read_launches().items() if n != before[k]}
    check(not key or key in want,
          f"profiled_device_ms: key {key!r} names no kernel that one call "
          f"launched (launches {want} over {reps} calls)")
    seen, counts = {}, []
    for _ in range(tries):
        kept = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.extend(p.events())
                     ) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ops = [e for e in kept if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
        got = {name: sum(name in e.name for e in ops) for name in want}
        mine = [e.time_range.elapsed_us() for e in ops if key in e.name]
        counts.append((len(mine), got))
        if got != want:
            print(f"[profiler] a session recorded port kernels {got} of "
                  f"{want}: rerun", flush=True)
            continue
        if key:
            return sum(mine) / reps / 1e3
        n = len(mine)
        if n and n % reps == 0:
            if n in seen:
                return (seen[n] + sum(mine)) / (2 * reps) / 1e3
            seen[n] = sum(mine)
    raise SmokeFailure(
        f"profiled_device_ms: {tries} sessions of {reps} calls recorded "
        f"(ops named {key!r}, port kernels) {counts}; want port kernels "
        f"{want}" + ("" if key else " and two equal nonzero multiples of "
                     f"{reps} ops"))


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
               ("odd", (1, 3, 48, 16), f32, True, None)]
            + lm_par_flash_cases() + lm_pp_ep_flash_cases()
            + lm_tp_flash_cases())


def lm_tp_flash_cases():
    """(label, shape, dtype, causal, mode) of K1 at ``[lm_tp_serve]``'s
    call sites: a tp shard's prefill, its H/LMTP_TP heads at each gpt_small
    prompt bucket, f32."""
    import torch
    return [(f"lm_tp_serve prefill {s}", (1, 12 // LMTP_TP, s, 64),
             torch.float32, True, None) for s in (16, 64, 256)]


def lm_par_flash_cases():
    """(label, shape, dtype, causal, mode) of K1-K3 at every [lm_par] call
    site, in f32 and bf16: a seq rank's ring blocks (the diagonal, mode 0,
    and a past block, mode +1, delta passed in) with all 12 heads (sp2)
    and with a tp rank's 6 (sp2xtp2), a tp rank's (or Ulysses') 6 heads
    over the whole sequence, and the control's 12 heads at batch 4."""
    import torch
    b, h, s_local, d = LMP_ATT_SHAPE
    return [(label, shape, dtype, True, mode)
            for dtype in (torch.float32, torch.bfloat16)
            for label, shape, mode in (
                ("lm_par ring mode 0", LMP_ATT_SHAPE, 0),
                ("lm_par ring mode +1", LMP_ATT_SHAPE, 1),
                ("lm_par sp2xtp2 ring mode 0", (b, h // 2, s_local, d), 0),
                ("lm_par sp2xtp2 ring mode +1", (b, h // 2, s_local, d), 1),
                ("lm_par tp heads", (b, h // 2, 2 * s_local, d), None),
                ("lm_par control", (b, h, 2 * s_local, d), None))]


def lm_pp_ep_flash_cases():
    """(label, shape, dtype, causal, mode) of K1-K3 at every [lm_pp_ep]
    call site, in f32 and bf16: a pp2 microbatch's, an ep2 rank's and the
    CLI pairs' 2 rows x 12 heads (LMP_BATCH / 2 rows of LMP_SEQ) and a
    pp2xtp2 rank's 6 heads. The MoE decode's prefill is (1,12,64,64), the
    "prefill 64" case."""
    import torch
    b, h, s, d = LMP_BATCH // 2, 12, LMP_SEQ, 64
    return [(label, shape, dtype, True, None)
            for dtype in (torch.float32, torch.bfloat16)
            for label, shape in (("lm_pp_ep pp2 and ep2", (b, h, s, d)),
                                 ("lm_pp_ep pp2xtp2", (b, h // 2, s, d)))]


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
    return ([("train main", (8, 12, 1024, 64), f32, True, None),
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
            + lm_par_flash_cases() + lm_pp_ep_flash_cases())


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
    the executor, the bucket-64 runs at one client and at two)."""
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
        c0 = server.batcher.latency.count
        solo = run_load(server.addr, lambda i: {"data": big},
                        n_requests=load_requests, concurrency=1)
        solo["server"] = window_tail(server.batcher.latency, c0)
        c0 = server.batcher.latency.count
        load = run_load(server.addr, lambda i: {"data": big},
                        n_requests=load_requests, concurrency=2)
        load["server"] = window_tail(server.batcher.latency, c0)
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
              f"{run['p99_ms']} ms, {img_s:.1f} img/s; batcher p50 "
              f"{run['server']['p50_ms']} ms [{card}]", flush=True)

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
    return launches, ex, solo, load


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


def fleet_forward(net, params, x):
    """prob of a direct forward of ``x`` through ``net`` at ``params``."""
    import torch
    with torch.inference_mode():
        return net({"data": torch.from_numpy(x).to(net.device)},
                   params)["prob"].float().cpu().numpy()


def fleet_which(prob, old, new, rows) -> str:
    """"old" or "new": which params' forward ``prob`` matches at NET_TOL
    on ``rows`` (rows where the two forwards differ beyond it); anything
    else (both, neither) fails the run."""
    import numpy as np
    rtol, atol = NET_TOL
    is_old = bool(np.allclose(prob[rows], old[rows], rtol=rtol, atol=atol))
    is_new = bool(np.allclose(prob[rows], new[rows], rtol=rtol, atol=atol))
    check(is_old != is_new, f"a reply matches {'both' if is_old else 'neither'}"
                            f" of the old and new params' forwards")
    return "old" if is_old else "new"


def window_tail(win, count0: int) -> dict:
    """p50/p99/mean (ms) of what a LatencyWindow recorded after its count
    stood at ``count0``: the server's side of one load run."""
    from poseidon_tpu_torch.runtime.metrics import LatencyWindow
    new = win.count - count0
    samples = win.samples()
    check(0 < new <= len(samples), f"{new} new samples in a window of "
                                   f"{len(samples)}")
    tail = LatencyWindow()
    for v in samples[len(samples) - new:]:
        tail.record(v)
    return tail.summary()


def fleet_max_draining(transitions) -> int:
    """The most replicas DRAINING at once, read from the transition log."""
    draining = most = 0
    for _, old, new in transitions:
        if new == "DRAINING":
            draining += 1
        elif old == "DRAINING":
            draining -= 1
        most = max(most, draining)
    return most


def fleet_cnn(card: str, dev, model: str, slice_runs) -> dict:
    """(a) of the FLEET_* comment."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net
    from poseidon_tpu_torch.runtime.cli import build_serving_fleet
    from poseidon_tpu_torch.serving.client import ServingClient, run_load
    from poseidon_tpu_torch.serving.fleet import DEAD
    from poseidon_tpu_torch.serving.server import InferenceServer

    on_card = dev.type == "cuda"
    ref_net = Net(load_net(model), "TEST", device=dev)
    row_shape = tuple(ref_net.blob_shapes["data"][1:])
    per_forward = (sum(l.TYPE == "LRN" for l in ref_net.layers)
                   if on_card else 0)
    rs = np.random.RandomState(3)
    reqs = {n: rs.randn(n, *row_shape).astype(np.float32) for n in BUCKETS}
    big = reqs[BUCKETS[-1]]
    p_old = ref_net.init(torch.Generator().manual_seed(0))
    want = {n: fleet_forward(ref_net, p_old, x) for n, x in reqs.items()}
    p_new = ref_net.init(torch.Generator().manual_seed(1))
    big_new = fleet_forward(ref_net, p_new, big)
    new_host = {l: {k: v.cpu().numpy() for k, v in d.items()}
                for l, d in p_new.items()}
    rtol, atol = NET_TOL
    rows = ~np.all(np.isclose(big_new, want[BUCKETS[-1]], rtol=rtol,
                              atol=atol), axis=1)
    check(int(rows.sum()) >= BUCKETS[-1] // 2,
          f"seed 0 and seed 1 agree on {BUCKETS[-1] - int(rows.sum())} of "
          f"{BUCKETS[-1]} rows: the roll could not tell them apart")
    name = ref_net.name or "net"
    del ref_net, p_old, p_new
    if on_card:
        torch.cuda.empty_cache()

    transitions, tr_lock = [], threading.Lock()

    def observer(index, old, new, reason):
        with tr_lock:
            transitions.append((index, old, new))

    zero_launches()
    t0 = time.perf_counter()
    mgr = build_serving_fleet(
        model, "", ",".join(map(str, BUCKETS)), FLEET_REPLICAS,
        devices_spec=",".join("0" * FLEET_REPLICAS) if on_card else "",
        max_delay_s=0.002, max_queue=FLEET_MAX_QUEUE,
        device="" if on_card else "cpu", on_transition=observer)
    build_s = time.perf_counter() - t0
    server = InferenceServer(fleet=mgr)
    out = {"replicas": FLEET_REPLICAS, "max_queue": FLEET_MAX_QUEUE,
           "build_s": build_s, "net": name}
    try:
        labels = [rep.device_label for rep in mgr.replicas]
        print(f"[fleet] (a) {FLEET_REPLICAS} {name} replicas on {labels}, "
              f"buckets {BUCKETS}, built and warmed in {build_s:.2f} s",
              flush=True)
        worst = 0.0
        for rep in mgr.replicas:
            for n, x in reqs.items():
                got = rep.batcher.submit({"data": x})["prob"]
                err = float(np.abs(got - want[n]).max())
                worst = max(worst, err)
                check(bool(np.allclose(got, want[n], rtol=rtol, atol=atol)),
                      f"replica {rep.index}, {n} rows: reply vs direct "
                      f"forward {err}")
        print(f"[fleet] (a) replies of {list(BUCKETS)} rows from each "
              f"replica vs a direct forward: max_abs {worst:.3e} (rtol "
              f"{rtol:g}, atol {atol:g})", flush=True)
        out["reply_max_abs"] = worst

        def routed():
            return [rep.routed for rep in mgr.replicas]

        closed = {}
        rep0 = mgr.replicas[0].batcher
        for conc in FLEET_CLOSED_CLIENTS:
            before = routed()
            door0, rep00 = mgr.latency.count, rep0.latency.count
            run = run_load(server.addr, lambda i: {"data": big},
                           n_requests=FLEET_CLOSED_REQUESTS,
                           concurrency=conc)
            spread = [a - b for a, b in zip(routed(), before)]
            check(run["ok"] == FLEET_CLOSED_REQUESTS,
                  f"closed loop at {conc}: {run}")
            run["routed"] = spread
            run["img_s"] = BUCKETS[-1] * run["ok"] / run["wall_s"]
            # where a request's time goes: the front door (route, submit,
            # reply) and replica 0's batcher (queue + forward)
            run["door"] = window_tail(mgr.latency, door0)
            run["replica0"] = (window_tail(rep0.latency, rep00)
                               if spread[0] else None)
            closed[conc] = run
            print(f"[fleet] (a) bucket {BUCKETS[-1]}, {FLEET_REPLICAS} "
                  f"replicas, closed loop at {conc} client(s), "
                  f"{run['requests']} requests in {run['wall_s']:.3f} s: "
                  f"p50 {run['p50_ms']} ms, p99 {run['p99_ms']} ms, "
                  f"{run['img_s']:.1f} img/s, {run['goodput_rps']:.2f} req/s, "
                  f"routed {spread}; front door p50 {run['door']['p50_ms']} "
                  f"ms, replica 0's batcher p50 "
                  f"{(run['replica0'] or {}).get('p50_ms')} ms [{card}]",
                  flush=True)
        check(all(n > 0 for n in closed[FLEET_REPLICAS]["routed"]),
              f"a concurrency-{FLEET_REPLICAS} load left a replica out: "
              f"{closed[FLEET_REPLICAS]['routed']}")
        for run in slice_runs:
            conc = run["concurrency"]
            if conc not in closed:
                continue
            mine = closed[conc]
            print(f"[fleet] (a) at concurrency {conc}, [slice]'s one engine "
                  f"in this run: p50 {run['p50_ms']} ms, p99 "
                  f"{run['p99_ms']} ms, "
                  f"{BUCKETS[-1] * run['ok'] / run['wall_s']:.1f} img/s, "
                  f"batcher p50 {run['server']['p50_ms']} ms; the fleet: "
                  f"p50 {mine['p50_ms']} ms, p99 {mine['p99_ms']} ms, "
                  f"{mine['img_s']:.1f} img/s, front door p50 "
                  f"{mine['door']['p50_ms']} ms, replica 0's batcher p50 "
                  f"{(mine['replica0'] or {}).get('p50_ms')} ms [{card}]",
                  flush=True)
        out["closed"] = {str(k): v for k, v in closed.items()}
        best = max(run["goodput_rps"] for run in closed.values())
        p99_s = closed[FLEET_CLOSED_CLIENTS[-1]]["p99_ms"] / 1e3

        def open_loop(rate):
            """One open loop at ``rate`` req/s for FLEET_OPEN_S, from
            enough clients that each request's slot finds one free (twice
            the rate times the deepest closed loop's p99)."""
            n = max(12, int(rate * FLEET_OPEN_S))
            clients = min(FLEET_OPEN_MAX_CLIENTS,
                          max(FLEET_REPLICAS, math.ceil(2 * rate * p99_s)))
            fired = []

            def fire(i):
                fired.append(time.monotonic())
                return {"data": big}

            run = run_load(server.addr, fire, n_requests=n,
                           concurrency=clients, offered_rps=rate)
            check(run["error"] == 0 and run["ok"] + run["shed"]
                  + run["deadline"] == n and run["ok"] > 0,
                  f"open loop at {rate:.2f} req/s: {run}")
            # the rate the requests left at, first fire to last
            span = max(fired) - min(fired)
            run["fired_rps"] = (n - 1) / span if span > 0 else 0.0
            run["realized"] = bool(
                run["late_fires"] <= FLEET_OPEN_LATE_SHARE * n
                and run["fired_rps"] >= 0.95 * rate)
            return run

        def open_line(label, run):
            print(f"[fleet] (a) open loop {label} ({run['offered_rps']:.2f} "
                  f"offered, {run['requests']} requests, "
                  f"{run['concurrency']} clients): goodput "
                  f"{run['goodput_rps']:.2f} req/s "
                  f"({BUCKETS[-1] * run['goodput_rps']:.1f} img/s), fired "
                  f"at {run['fired_rps']:.2f} req/s, achieved "
                  f"{run['achieved_rps']:.2f} (tail included), shed "
                  f"{run['shed']}, late fires {run['late_fires']}, p50 "
                  f"{run['p50_ms']} ms, p99 {run['p99_ms']} ms; offered "
                  f"rate realized: {run['realized']} [{card}]", flush=True)

        # capacity: the best goodput at any load measured here, closed loops
        # and open-loop probes at rising rates above the best closed loop
        # up to the first that sheds (closed loops move in convoys and may
        # not saturate the fleet; past saturation goodput collapses, since
        # a shed request's 40 MB is read all the same); a lower bound
        # unless a probe shed
        probes = []
        for load in FLEET_PROBE_LOADS:
            run = open_loop(load * best)
            probes.append(run)
            open_line(f"probe at {load}x the best closed loop's {best:.2f} "
                      f"req/s", run)
            if run["shed"]:
                break
        capacity = max(best, *(run["goodput_rps"] for run in probes))
        saturated = probes[-1]["shed"] > 0
        print(f"[fleet] (a) capacity {capacity:.2f} req/s, the best goodput "
              f"of the closed loops and probes; saturated (a probe shed): "
              f"{saturated}", flush=True)
        out.update(capacity_rps=capacity, saturated=saturated, probes=probes,
                   open={})
        for frac in FLEET_OPEN_LOADS:
            run = open_loop(frac * capacity)
            out["open"][str(frac)] = run
            open_line(f"at {frac}x of {capacity:.2f} req/s", run)
        check(out["open"][str(FLEET_OPEN_LOADS[0])]["realized"],
              f"the open loop at {FLEET_OPEN_LOADS[0]}x did not realize its "
              f"rate: {out['open'][str(FLEET_OPEN_LOADS[0])]}")

        # the rolling reload under load
        replies, errors, stop = [], [], threading.Event()
        rep_lock = threading.Lock()

        def hammer():
            cli = ServingClient(server.addr)
            try:
                while not stop.is_set():
                    t_sub = time.monotonic()
                    try:
                        prob = cli.infer({"data": big})["prob"]
                    except Exception as e:  # noqa: BLE001 — checked below
                        errors.append(e)
                        return
                    with rep_lock:
                        replies.append((t_sub, time.monotonic(), prob))
            finally:
                cli.close()

        def wait_replies(cond, what):
            t_end = time.monotonic() + FLEET_TIMEOUT_S
            while not cond() and not errors:
                check(time.monotonic() < t_end, what)
                time.sleep(0.005)

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(FLEET_ROLL_CLIENTS)]
        for t in threads:
            t.start()
        try:
            wait_replies(lambda: len(replies) >= 6, "no replies before "
                                                    "the roll")
            t_roll0 = time.monotonic()
            swapped = mgr.rolling_reload(new_host)
            t_roll1 = time.monotonic()
            wait_replies(lambda: sum(r[0] > t_roll1 for r in replies) >= 6,
                         "no replies after the roll")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=FLEET_TIMEOUT_S)
        check(not errors, f"a request failed during the roll: {errors[:1]}")
        kinds = {"before": {"old": 0, "new": 0},
                 "during": {"old": 0, "new": 0},
                 "after": {"old": 0, "new": 0}}
        for t_sub, t_done, prob in replies:
            when = ("before" if t_done < t_roll0 else
                    "after" if t_sub > t_roll1 else "during")
            kinds[when][fleet_which(prob, want[BUCKETS[-1]], big_new,
                                    rows)] += 1
        most = fleet_max_draining(transitions)
        print(f"[fleet] (a) rolling reload to seed-1 weights under "
              f"{FLEET_ROLL_CLIENTS} clients: {swapped} replicas swapped in "
              f"{t_roll1 - t_roll0:.3f} s, {len(replies)} replies, none "
              f"failed (old/new before {kinds['before']}, during "
              f"{kinds['during']}, after {kinds['after']}; each checked on "
              f"the {int(rows.sum())} rows where the two differ); at most "
              f"{most} replica draining in the transition log, witness "
              f"{mgr.max_concurrent_draining} [{card}]", flush=True)
        check(swapped == FLEET_REPLICAS, f"{swapped} replicas swapped")
        check(kinds["before"]["new"] == 0 and kinds["after"]["old"] == 0,
              f"replies on the wrong params around the roll: {kinds}")
        check(most == 1 and mgr.max_concurrent_draining == 1,
              f"{most} replicas draining at once")
        out["roll"] = {"swapped": swapped, "s": t_roll1 - t_roll0,
                       "replies": kinds, "max_draining": most}

        # replica 0 killed mid-load
        victim = mgr.replicas[0].executor
        die = threading.Event()
        real_infer = victim.infer

        def infer(inputs):
            if die.is_set():
                raise RuntimeError("replica killed by the smoke")
            return real_infer(inputs)

        victim.infer = infer
        box = {}
        loader = threading.Thread(target=lambda: box.update(run=run_load(
            server.addr, lambda i: {"data": big},
            n_requests=FLEET_KILL_REQUESTS, concurrency=FLEET_REPLICAS)),
            daemon=True)
        routed0 = mgr.routed_total
        loader.start()
        t_end = time.monotonic() + FLEET_TIMEOUT_S
        while mgr.routed_total - routed0 < FLEET_KILL_REQUESTS // 4:
            check(time.monotonic() < t_end, "the kill's load never started")
            time.sleep(0.002)
        die.set()
        loader.join(timeout=FLEET_TIMEOUT_S)
        run = box["run"]
        states = mgr.state_counts()
        print(f"[fleet] (a) replica 0 killed mid-load ({FLEET_KILL_REQUESTS} "
              f"requests, {FLEET_REPLICAS} clients): ok {run['ok']}, shed "
              f"{run['shed']}, deadline {run['deadline']}, errors "
              f"{run['error']}; states {states}, deaths {mgr.deaths}, "
              f"failovers {mgr.failovers}; p99 {run['p99_ms']} ms [{card}]",
              flush=True)
        check(run["error"] == 0 and run["deadline"] == 0
              and run["ok"] + run["shed"] == FLEET_KILL_REQUESTS,
              f"the kill lost an accepted request: {run}")
        check(states[DEAD] == 1 and mgr.deaths == 1,
              f"the killed replica is not DEAD: {states}")
        out["kill"] = {**run, "states": states, "failovers": mgr.failovers}
        out["stats"] = {k: v for k, v in server.stats_snapshot().items()
                        if k != "replicas"}
    finally:
        server.shutdown()
    sync(dev)
    counts = read_launches()
    forwards = sum(rep.executor.forwards for rep in mgr.replicas)
    k4 = counts["lrn_fwd"] + counts["lrn_fwd_nhwc"]
    print(f"[fleet] (a) {forwards} forwards over the replicas "
          f"({[rep.executor.forwards for rep in mgr.replicas]}, warm-ups "
          f"included); launches {counts} (K4 expected {per_forward} x "
          f"{forwards})", flush=True)
    check(k4 == per_forward * forwards,
          f"K4 launched {k4} times for {forwards} forwards")
    check(all(v == 0 for k, v in counts.items()
              if k not in ("lrn_fwd", "lrn_fwd_nhwc")),
          f"the CNN fleet launched a kernel of another path: {counts}")
    out.update(launches=counts, forwards=forwards)
    return out


def fleet_lm_tokens(addr_or_sched, prompts, clients: int,
                    max_new: int = FLEET_LM_MAX_NEW) -> list:
    """Greedy tokens of every prompt (``max_new`` each), from ``clients``
    threads: through a socket address, or straight into a scheduler."""
    from poseidon_tpu_torch.serving.client import ServingClient
    out = [None] * len(prompts)
    errors = []
    nxt = {"v": 0}
    lock = threading.Lock()

    def worker():
        cli = (ServingClient(addr_or_sched)
               if isinstance(addr_or_sched, tuple) else None)
        try:
            while True:
                with lock:
                    i = nxt["v"]
                    if i >= len(prompts):
                        return
                    nxt["v"] = i + 1
                try:
                    if cli is not None:
                        r = cli.generate(prompts[i], max_new=max_new)
                    else:
                        r = addr_or_sched.submit(
                            {"prompt": prompts[i], "max_new": max_new},
                            timeout_s=300)
                    out[i] = [int(t) for t in r["tokens"]]
                except Exception as e:  # noqa: BLE001 — checked below
                    errors.append(e)
        finally:
            if cli is not None:
                cli.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_TIMEOUT_S)
    check(not errors, f"a generate request failed: {errors[:1]}")
    return out


def fleet_generate(card: str, dev, preset: str, k1_records) -> dict:
    """(b) of the FLEET_* comment."""
    from poseidon_tpu_torch.runtime.cli import (build_generate_executor,
                                                build_generate_fleet)
    from poseidon_tpu_torch.serving.server import InferenceServer

    on_card = dev.type == "cuda"
    want, new_host, one_s = [], None, []
    for seed in (0, 1):
        ref = build_generate_executor(preset, device=dev, seed=seed)
        if seed == 0:
            prompts = lm_traffic(ref, FLEET_LM_REQUESTS, seed=5)
            n_layers = ref.cfg.n_layers
        sched = ref.make_batcher(max_queue=FLEET_LM_REQUESTS)
        try:
            # the same traffic through one executor's scheduler, straight
            # into it (no socket): the fleet's same-traffic baseline
            t0 = time.perf_counter()
            want.append(fleet_lm_tokens(sched, prompts, LM_CLIENTS))
            one_s.append(time.perf_counter() - t0)
        finally:
            sched.close()
        if seed == 1:
            new_host = {n: {l: v.cpu() for l, v in d.items()}
                        for n, d in ref._params.items()}
        del ref
    # and through the socket and the router to one replica: what the
    # front door costs, apart from the second replica (outside the launch
    # count below)
    solo = build_generate_fleet(preset, 1, "0" if on_card else "",
                                device="" if on_card else "cpu")
    server = InferenceServer(fleet=solo)
    try:
        t0 = time.perf_counter()
        got_solo = fleet_lm_tokens(server.addr, prompts, LM_CLIENTS)
        solo_s = time.perf_counter() - t0
    finally:
        server.shutdown()
    check(got_solo == want[0], "one generate replica's tokens differ from "
                               "one executor's")
    del solo
    transitions, tr_lock = [], threading.Lock()

    def observer(index, old, new, reason):
        with tr_lock:
            transitions.append((index, old, new))

    t0 = time.perf_counter()
    mgr = build_generate_fleet(
        preset, FLEET_LM_REPLICAS,
        ",".join("0" * FLEET_LM_REPLICAS) if on_card else "",
        device="" if on_card else "cpu", on_transition=observer)
    build_s = time.perf_counter() - t0
    zero_launches()
    server = InferenceServer(fleet=mgr)
    try:
        t0 = time.perf_counter()
        got0 = fleet_lm_tokens(server.addr, prompts, LM_CLIENTS)
        wave0_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        swapped = mgr.rolling_reload(new_host)
        roll_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got1 = fleet_lm_tokens(server.addr, prompts, LM_CLIENTS)
        wave1_s = time.perf_counter() - t0
        routed = [rep.routed for rep in mgr.replicas]
    finally:
        server.shutdown()
    sync(dev)
    counts = read_launches()
    prefills = sum(rep.executor.prefills for rep in mgr.replicas)
    per_prefill = n_layers if on_card else 0
    same0 = sum(a == b for a, b in zip(got0, want[0]))
    same1 = sum(a == b for a, b in zip(got1, want[1]))
    most = fleet_max_draining(transitions)
    tokens = FLEET_LM_REQUESTS * FLEET_LM_MAX_NEW
    print(f"[fleet] (b) the same {FLEET_LM_REQUESTS} prompts from "
          f"{LM_CLIENTS} clients straight into one executor's scheduler: "
          f"{one_s[0]:.3f} s ({tokens / one_s[0]:.1f} tokens/s) at seed 0, "
          f"{one_s[1]:.3f} s ({tokens / one_s[1]:.1f} tokens/s) at seed 1; "
          f"through the socket to a 1-replica fleet {solo_s:.3f} s "
          f"({tokens / solo_s:.1f} tokens/s, tokens equal) [{card}]",
          flush=True)
    print(f"[fleet] (b) {FLEET_LM_REPLICAS} {preset} generate replicas "
          f"(built and warmed in {build_s:.2f} s), {FLEET_LM_REQUESTS} "
          f"prompts from {LM_CLIENTS} clients, max_new {FLEET_LM_MAX_NEW}: "
          f"wave 1 {wave0_s:.3f} s ({tokens / wave0_s:.1f} tokens/s), tokens "
          f"equal to one executor's for {same0}/{FLEET_LM_REQUESTS}; rolling "
          f"reload to seed-1 weights ({swapped} swapped in {roll_s:.3f} s, at "
          f"most {most} draining); wave 2 {wave1_s:.3f} s "
          f"({tokens / wave1_s:.1f} tokens/s), tokens equal to the seed-1 "
          f"executor's for {same1}/{FLEET_LM_REQUESTS}; routed {routed} "
          f"[{card}]", flush=True)
    check(same0 == same1 == FLEET_LM_REQUESTS,
          "generate replicas' tokens differ from one executor's")
    check(want[0] != want[1], "seed 0 and seed 1 generate the same tokens")
    check(swapped == FLEET_LM_REPLICAS and most == 1,
          f"the generate roll: {swapped} swapped, {most} draining")
    print(f"[fleet] (b) {prefills} prefills over the replicas "
          f"({[rep.executor.prefills for rep in mgr.replicas]}); launches "
          f"{counts} (flash_fwd expected {per_prefill} x {prefills})",
          flush=True)
    check(counts["flash_fwd"] == per_prefill * prefills,
          f"flash_fwd launched {counts['flash_fwd']} times for {prefills} "
          f"prefills")
    check(all(v == 0 for k, v in counts.items() if k != "flash_fwd"),
          f"the generate fleet launched a kernel of another path: {counts}")
    prefill = [r for r in k1_records if r["case"].startswith("prefill ")]
    if prefill:
        print(f"[fleet] (b) K1 vs plain at these replicas' prefill shapes "
              f"(the [flash_fwd] cases {[r['case'] for r in prefill]}): "
              f"max_abs {max(r['max_abs_err'] for r in prefill):.3e} (rtol "
              f"{FLASH_TOL['float32'][0]:g}, atol {FLASH_TOL['float32'][1]:g})",
              flush=True)
    return {"replicas": FLEET_LM_REPLICAS, "build_s": build_s,
            "wave_s": [wave0_s, wave1_s], "roll_s": roll_s,
            "tokens_per_s": [tokens / wave0_s, tokens / wave1_s],
            "one_executor_tokens_per_s": [tokens / t for t in one_s],
            "one_replica_tokens_per_s": tokens / solo_s,
            "prefills": prefills, "launches": counts, "routed": routed}


def fleet_child(cmd, here: str):
    """Start a child with its output read line by line on a daemon thread;
    returns (process, lines)."""
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))

    threading.Thread(target=pump, daemon=True).start()
    return proc, lines


def fleet_launches(lines, tag: str) -> dict:
    found = [ln for ln in lines if ln.startswith("[launches] ")]
    check(len(found) == 1, f"{tag}: no launch report")
    return json.loads(found[0][len("[launches] "):])


def fleet_cli(card: str, dev, root: str, model: str, rate: float) -> dict:
    """(c) of the FLEET_* comment."""
    import re
    import signal
    import urllib.request

    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.parallel.trainer import init_train_state
    from poseidon_tpu_torch.proto.messages import load_net
    from poseidon_tpu_torch.runtime.checkpoint import snapshot
    from poseidon_tpu_torch.serving.client import ServingClient

    on_card = dev.type == "cuda"
    here = os.path.dirname(os.path.abspath(__file__))
    place = ["--devices", "0,0"] if on_card else ["--device", "cpu"]
    buckets = ",".join(map(str, BUCKETS))
    net = Net(load_net(model), "TEST", device=dev)
    per_forward = (sum(l.TYPE == "LRN" for l in net.layers)
                   if on_card else 0)
    x = np.random.RandomState(4).randn(
        4, *net.blob_shapes["data"][1:]).astype(np.float32)
    p_old = net.init(torch.Generator().manual_seed(0))
    want_old = fleet_forward(net, p_old, x)
    p_new = net.init(torch.Generator().manual_seed(1))
    want_new = fleet_forward(net, p_new, x)
    prefix = os.path.join(root, "fleet_cli", "alexnet")
    rtol, atol = NET_TOL
    out = {}
    t0 = time.perf_counter()
    proc, lines = fleet_child(
        [sys.executable, "-c", LAUNCH_REPORT, "serve", f"--model={model}",
         "--buckets", buckets, "--replicas", "2", *place, "--watch", prefix,
         "--poll_s", "0.5", "--metrics_port", "0"], here)
    try:
        port = metrics = None
        t_end = time.monotonic() + FLEET_TIMEOUT_S
        while not (port and metrics):
            check(proc.poll() is None and time.monotonic() < t_end,
                  "serve --replicas never logged its addresses: "
                  + "\n".join(lines[-20:]))
            for ln in list(lines):
                m = re.search(r"listening on [\d.]+:(\d+) \(2 replicas\)",
                              ln)
                port = int(m.group(1)) if m else port
                m = re.search(r"metrics endpoint on http://[\d.]+:(\d+)/",
                              ln)
                metrics = int(m.group(1)) if m else metrics
            time.sleep(0.05)
        up_s = time.perf_counter() - t0
        cli = ServingClient(("127.0.0.1", port))
        try:
            got = cli.infer({"data": x})["prob"]
            err_old = float(np.abs(got - want_old).max())
            check(bool(np.allclose(got, want_old, rtol=rtol, atol=atol)),
                  f"serve's reply vs the seed-0 forward {err_old}")
            state = init_train_state(p_new)
            snapshot(prefix, net, p_new,
                     state._replace(solver=state.solver._replace(it=2)))
            reply = cli.reload()
            check(reply.get("ok") and str(reply.get("path")).endswith(
                "alexnet_iter_2.solverstate.npz")
                and reply.get("reload_generation") == 1,
                  f"the reload op: {reply}")
            got = cli.infer({"data": x})["prob"]
            err_new = float(np.abs(got - want_new).max())
            check(bool(np.allclose(got, want_new, rtol=rtol, atol=atol)),
                  f"serve's reply after the reload vs the seed-1 forward "
                  f"{err_new}")
            cli.stats()
        finally:
            cli.close()
        body = urllib.request.urlopen(f"http://127.0.0.1:{metrics}/",
                                      timeout=30).read().decode()
        rows = {i: sorted(ln.split("=")[0] for ln in body.splitlines()
                          if ln.startswith(f"serving.replicas.{i}."))
                for i in (0, 1)}
        check(all(rows.values()), f"the metrics endpoint has no replica "
                                  f"rows: {body[:400]}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=FLEET_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    time.sleep(0.2)                  # the pump's last lines
    for ln in lines:
        print(f"[fleet:serve] {ln}", flush=True)
    check(rc == 0, f"serve exited {rc} on SIGTERM")
    final = [ln for ln in lines if "serving_final_stats" in ln]
    check(len(final) == 1, "serve printed no final stats line")
    stats = json.loads(final[0])["serving_final_stats"]
    serve_counts = fleet_launches(lines, "serve")
    serve_fwd = 2 * len(BUCKETS) + stats["batches"]
    print(f"[fleet] (c) `serve --replicas 2 {' '.join(place)} --watch "
          f"--poll_s 0.5 --metrics_port 0` up in {up_s:.2f} s; reply vs "
          f"seed-0 forward max_abs {err_old:.3e}, after the reload op (gen "
          f"{stats['reload_generation']}, reloads {stats['reloads']}) vs "
          f"seed-1 {err_new:.3e}; metrics rows a replica "
          f"{[len(r) for r in rows.values()]}; SIGTERM exit {rc}; launches "
          f"{serve_counts} (K4 expected {per_forward} x {serve_fwd}) "
          f"[{card}]", flush=True)
    check(serve_counts["lrn_fwd"] + serve_counts["lrn_fwd_nhwc"]
          == per_forward * serve_fwd, "serve's K4 launches")

    proc, lines = fleet_child(
        [sys.executable, "-c", LAUNCH_REPORT, "bench_serve",
         f"--model={model}", "--buckets", buckets, "--replicas", "2",
         *place, "--offered_rps", f"{rate:.3f}", "--requests",
         str(FLEET_CLI_REQUESTS), "--concurrency", "8", "--batch", "16"],
        here)
    rc = proc.wait(timeout=FLEET_TIMEOUT_S)
    time.sleep(0.2)
    for ln in lines:
        print(f"[fleet:bench_serve] {ln}", flush=True)
    check(rc == 0, f"bench_serve exited {rc}")
    result = json.loads(next(ln for ln in lines
                             if ln.startswith('{"metric"')))
    bench_counts = fleet_launches(lines, "bench_serve")
    bench_fwd = 2 * len(BUCKETS) + result["batches"]
    print(f"[fleet] (c) `bench_serve --replicas 2 --offered_rps "
          f"{rate:.3f}`: ok {result['ok']}, shed {result['shed']}, p50 "
          f"{result['p50_ms']} ms, p99 {result['p99_ms']} ms, achieved "
          f"{result['achieved_rps']:.2f} req/s, late fires "
          f"{result['late_fires']}, routed {result['routing']}; launches "
          f"{bench_counts} (K4 expected {per_forward} x {bench_fwd}) "
          f"[{card}]", flush=True)
    check(result["ok"] > 0, f"bench_serve: {result}")
    check(bench_counts["lrn_fwd"] + bench_counts["lrn_fwd_nhwc"]
          == per_forward * bench_fwd, "bench_serve's K4 launches")
    out.update(serve_up_s=up_s, serve_stats_batches=stats["batches"],
               bench=result, launches={k: serve_counts[k] + bench_counts[k]
                                       for k in serve_counts})
    return out


def phase_fleet(card: str, k1_records=(), slice_runs=(), device=None,
                model: str = ALEXNET, preset: str = LM_PRESET) -> dict:
    """The serving fleet on the card: (a), (b) and (c) of the FLEET_*
    comment. ``device``, ``model`` and ``preset`` are for a CPU rehearsal
    only (a deploy net with a 'data' input and a 'prob' output)."""
    from poseidon_tpu_torch.numeric import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device(device)
    cnn = fleet_cnn(card, dev, model, slice_runs)
    gen = fleet_generate(card, dev, preset, k1_records)
    with tempfile.TemporaryDirectory() as root:
        cli = fleet_cli(card, dev, root, model, cnn["capacity_rps"])
    out = {"cnn": cnn, "generate": gen, "cli": cli,
           "launches": {"fleet_cnn": cnn["launches"],
                        "fleet_generate": gen["launches"],
                        "fleet_cli": cli["launches"]},
           "wall_s": time.perf_counter() - t0}
    print(f"[fleet] {cnn['net']} x{FLEET_REPLICAS} and {preset} "
          f"x{FLEET_LM_REPLICAS} behind one door, rolled and killed with no "
          f"request lost, the CLI's fleet, watch and metrics; phase wall "
          f"{out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def zero_launches() -> None:
    from poseidon_tpu_torch.ops import flash, lrn, pool, sgd
    for table in (lrn.LAUNCHES, pool.LAUNCHES, sgd.LAUNCHES, flash.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches() -> dict:
    from poseidon_tpu_torch.ops import _build
    return _build.launch_counts()


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

    eng.train_net.manual_seed(seed)
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
            elif l.TYPE == "POOLING" and l.method in ("MAX", "AVE"):
                l.pool = (pool.max_pool_reference if l.method == "MAX"
                          else pool.ave_pool_reference)
        self.step.sgd_update = sgd.sgd_update_plain_
        return self

    def __exit__(self, *exc):
        from poseidon_tpu_torch.ops import lrn, pool, sgd
        for l in self.net.layers:
            if l.TYPE == "LRN":
                l.across_channels = lrn.lrn_across_channels
            elif l.TYPE == "POOLING" and l.method in ("MAX", "AVE"):
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
        steps = int(eng.stats.counters["train_iters"])
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
        stall, busy = (eng.stats.timers["input_stall"],
                       eng.stats.timers["train_step"])
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
            steps_in_flight=eng.stats.counters["steps_in_flight"],
            launches=counts, batch=batch)
        check(eng.stats.counters["train_iters"] == steps,
              f"loop trained {eng.stats.counters['train_iters']:g} steps")
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
            steps = int(eng.stats.counters["train_iters"])
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
               same_snapshots: bool = True,
               launcher: str = LAUNCH_REPORT, rank_env=None) -> dict:
    """``ranks`` ``train`` processes of the port under the env contract,
    sharing the card (or the CPU), each reporting its kernel launches
    when it returns (``LAUNCH_REPORT``); with ``same_snapshots`` their
    snapshots must be bitwise equal, with ``group`` they must have formed
    a gloo group. ``rank_env(r)`` adds rank r's own variables. The result
    names the first rank's snapshot (``state_path``), every rank's log and
    launches."""
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
                   + os.path.join(work, "store"), **(env_extra or {}),
                   **(rank_env(r) if rank_env else {}))
        cmd = [sys.executable, "-c", launcher, "train",
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
    s_per_step = ((times[-1] - times[0]) / (len(times) - 1)
                  if len(times) > 1 else float("nan"))
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


def snapshot_arrays(path: str) -> dict:
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def peak_bytes(logs) -> list:
    """Every rank's ``torch.cuda.max_memory_allocated`` (SPMD_LAUNCH)."""
    return [int(next(ln for ln in log.splitlines()
                     if ln.startswith("[peak] ")).split()[1])
            for log in logs]


def spmd_tp_pair_rank(root: str, rank: str, device: str, batch: str,
                      iters: str, out: str) -> int:
    """One of the two ranks of [spmd] (b)'s in-process tp2 pair (started
    by ``spmd_tp_pair``): the tp2 step and its replicated control on one
    two-rank gloo mesh, AlexNet train_val at ``batch`` under cuDNN's
    deterministic algorithms, fed the same params, batches (the LMDB's
    first ``iters``) and dropout streams, planned and seeded as the
    Engine of a ``train --mesh tp2`` rank plans and seeds them.
    After each iteration: both arms' losses; the distance between their
    canonical params and momentum (``export``); the ReLU decisions (the
    sign of each ReLU's top) and max-pool argmaxes (recomputed from each
    pool's input) of that iteration's forward that differ between the
    arms. Every K7 call runs the kernel and, on copies of its inputs, the
    plain version: its arm, length, launches, whether they agree bitwise
    and whether it received the params and momentum that the previous
    call of its arm and length left (bitwise; None for the first). Rank 0
    writes the iterations, every rank its K7 calls, as JSON to ``out`` +
    ``.rank<r>``."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.data.pipeline import build_phase_pipelines
    from poseidon_tpu_torch.ops import sgd
    from poseidon_tpu_torch.parallel import spmd
    from poseidon_tpu_torch.parallel.mesh import rank_seed
    from poseidon_tpu_torch.parallel.strategies import CommConfig
    from poseidon_tpu_torch.parallel.trainer import init_train_state
    from poseidon_tpu_torch.proto.messages import load_solver
    from poseidon_tpu_torch.runtime.cluster import init_distributed

    torch.backends.cudnn.deterministic = True
    rank, batch, iters = int(rank), int(batch), int(iters)
    rtol, atol = SPMD_TP_TOL
    cfg = MeshConfig(tp=2)
    group = init_distributed(torch.device(device), rank=rank, world=2,
                             coordinator="file://" + out + ".store",
                             mesh_cfg=cfg)
    try:
        dev = group.device
        net_param = alexnet_net_param(root, batch)
        pipes, shapes = build_phase_pipelines(net_param, "TRAIN")
        try:
            batches = [{k: torch.from_numpy(v).to(dev)
                        for k, v in next(pipes[0]).items()}
                       for _ in range(iters)]
        finally:
            for p in pipes:
                p.close()
        # planned as an unflagged `train` plans it ("auto": NHWC on the
        # card, NCHW on the CPU)
        net = Net(net_param, "TRAIN", device=dev, source_shapes=shapes,
                  conv_layout="auto")
        sp = load_solver(ALEXNET_SOLVER)
        seed = sp.random_seed if sp.random_seed >= 0 else 1
        params0 = net.init(torch.Generator().manual_seed(seed))
        net.generator.manual_seed(rank_seed(seed, group.batch_index))
        comm = CommConfig()
        k7, left = [], {}

        def checked(arm):
            def update(w, g, h, rate, lr, dec, mom):
                key = (arm, w.numel())
                carried = (None if key not in left else bool(
                    torch.equal(w, left[key][0])
                    and torch.equal(h, left[key][1])))
                wp, hp = w.clone(), h.clone()
                sgd.sgd_update_plain_(wp, g, hp, rate, lr, dec, mom)
                before = sgd.LAUNCHES["sgd_update"]
                sgd.sgd_update_(w, g, h, rate, lr, dec, mom)
                k7.append({"arm": arm, "length": w.numel(),
                           "launches": sgd.LAUNCHES["sgd_update"] - before,
                           "bitwise": bool(torch.equal(w, wp)
                                           and torch.equal(h, hp)),
                           "carried": carried})
                left[key] = (w.clone(), h.clone())
            return update

        arms = {}
        for arm, shard in (("tp2", True), ("control", False)):
            plan = spmd.ShardingPlan.build(net, cfg, comm, shard_params=shard,
                                           enable_tp=shard)
            step = spmd.SpmdTrainStep(net, sp, group, plan, comm)
            step.sgd_update = checked(arm)
            arms[arm] = [step, *step.load(params0, init_train_state(
                params0, comm, plan.n_dp))]
        apply, seen = net.apply, {}

        def keep_blobs(*a, **kw):
            res = apply(*a, **{**kw, "keep_blobs": True})
            seen["blobs"] = res.blobs
            return res

        net.apply = keep_blobs
        relus = [l for l in net.layers if l.TYPE == "RELU"]
        pools = [l for l in net.layers
                 if l.TYPE == "POOLING" and l.method == "MAX"]
        rows = []
        for k, feed in enumerate(batches):
            stream = net.generator.get_state()
            losses, blobs = {}, {}
            for arm, rec in arms.items():
                net.generator.set_state(stream)
                rec[1], rec[2], m = rec[0].step(rec[1], rec[2], feed)
                losses[arm] = float(m["loss"])
                blobs[arm] = seen.pop("blobs")
            a, b = blobs["tp2"], blobs["control"]
            flips = {l.name: int(((a[l.lp.top[0]] > 0)
                                  != (b[l.lp.top[0]] > 0)).sum())
                     for l in relus}
            for l in pools:
                idx = [F.max_pool2d(x[l.lp.bottom[0]].float(), l.kernel,
                                    l.stride, l.pad, ceil_mode=True,
                                    return_indices=True)[1] for x in (a, b)]
                flips[l.name] = int((idx[0] != idx[1]).sum())
            del a, b, blobs
            trees = {arm: rec[0].export(rec[1], rec[2])
                     for arm, rec in arms.items()}
            if rank == 0:
                err, outside = 0.0, {}
                for what in ("params", "history"):
                    got, want = ((p if what == "params" else st.solver.history)
                                 for p, st in (trees["tp2"], trees["control"]))
                    for lname, lv in want.items():
                        for pname, w in lv.items():
                            d = (got[lname][pname] - w).abs()
                            err = max(err, float(d.max()))
                            n = int((d > atol + rtol * w.abs()).sum())
                            if n:
                                outside[f"{what}/{lname}/{pname}"] = n
                rows.append({"iteration": k + 1, "losses": losses,
                             "max_abs": err, "outside": outside,
                             "flips": flips})
            del trees
        with open(f"{out}.rank{rank}", "w") as f:
            json.dump({"iterations": rows, "k7": k7}, f)
    finally:
        group.close()
    return 0


def spmd_tp_pair(card: str, root: str, dev, batch: int, iters: int,
                 tp_lengths) -> dict:
    """[spmd] (b)'s in-process tp2 pair (``spmd_tp_pair_rank``) as two
    processes sharing the card: prints the distance and the differing
    decisions after each iteration, and fails unless the first
    SPMD_TP_GATE_ITERS iterations end within SPMD_TP_TOL, no element
    leaves the tolerance before a decision has parted the arms (that
    iteration's forward or an earlier one), every K7 call agrees
    bitwise with the plain version (one launch each on the card) and
    receives what its arm's previous call left, and K7 ran at
    ``tp_lengths`` in the tp2 arm."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "spmd_tp_pair")
    cmd = ("import sys, chip_smoke; "
           "sys.exit(chip_smoke.spmd_tp_pair_rank(*sys.argv[1:]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", cmd, root, str(r), dev.type, str(batch),
         str(iters), out], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_CLI_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            print(f"[spmd:tp_pair:rank{r}] {line}", flush=True)
        check(p.returncode == 0, f"tp2 pair rank {r} exited {p.returncode}")
    res = []
    for r in range(2):
        with open(f"{out}.rank{r}") as f:
            res.append(json.load(f))
    rtol, atol = SPMD_TP_TOL
    for row in res[0]["iterations"]:
        relu = {k: v for k, v in row["flips"].items() if k.startswith("relu")}
        pool = {k: v for k, v in row["flips"].items()
                if not k.startswith("relu")}
        print(f"[spmd] (b) pair, iteration {row['iteration']}: loss tp2 "
              f"{row['losses']['tp2']!r} control "
              f"{row['losses']['control']!r}; params and momentum max_abs "
              f"{row['max_abs']:.3e}, elements outside rtol {rtol:g} atol "
              f"{atol:g}: {sum(row['outside'].values())} in "
              f"{len(row['outside'])} leaves; in this iteration's forward "
              f"ReLU decisions differing {relu}, max-pool argmaxes "
              f"differing {pool} [{card}]", flush=True)
    calls = res[0]["k7"] + res[1]["k7"]
    on_card = dev.type == "cuda"
    lengths = sorted({c["length"] for c in calls if c["arm"] == "tp2"})
    print(f"[spmd] (b) pair: K7 {len(calls)} calls on the two ranks, at "
          f"{lengths} (tp2) and "
          f"{sorted({c['length'] for c in calls if c['arm'] == 'control'})}"
          f" (control), every one bitwise to plain: "
          f"{all(c['bitwise'] for c in calls)} [{card}]", flush=True)
    carried = [c["carried"] for c in calls if c["carried"] is not None]
    print(f"[spmd] (b) pair: K7 received the params and momentum its "
          f"arm's previous call left, bitwise, at {sum(carried)} of "
          f"{len(carried)} later calls [{card}]", flush=True)
    check(all(c["bitwise"] for c in calls), "K7 in the tp2 pair vs plain")
    check(all(carried) and len(carried) == len(calls) - 6,
          "the tp2 pair's params or momentum changed between steps")
    check(all(c["launches"] == int(on_card) for c in calls),
          "K7 in the tp2 pair: launches a call")
    check(lengths == sorted(tp_lengths),
          f"K7 in the tp2 pair at {lengths}, not {sorted(tp_lengths)}")
    rows = res[0]["iterations"]
    check(not any(row["outside"] for row in rows[:SPMD_TP_GATE_ITERS]),
          f"the tp2 pair left PARAM_TOL within {SPMD_TP_GATE_ITERS} "
          f"iterations: {[row['outside'] for row in rows]}")
    parted = [any(row["flips"].values()) for row in rows]
    first = {"outside": next((r["iteration"] for r in rows if r["outside"]),
                             None),
             "apart": next((r["iteration"] for r, p in zip(rows, parted)
                            if p), None)}
    print(f"[spmd] (b) pair: the first iteration outside rtol {rtol:g} "
          f"atol {atol:g}: {first['outside']}; the first forward with a "
          f"decision apart: {first['apart']} [{card}]", flush=True)
    check(first["outside"] is None or (first["apart"] is not None
                                       and first["apart"]
                                       <= first["outside"]),
          f"the tp2 pair left the tolerance before any decision parted: "
          f"{first}")
    return {"iterations": rows, "k7_calls": len(calls),
            "k7_tp2_lengths": lengths, "first": first}


def spmd_k7_shards(card: str, net, sp, tp_layouts) -> list:
    """(d) K7 on AlexNet's fsdp shards: for each F of SPMD_FSDP, the
    shard-major multiplier segments of fsdp ranks 0 and F-1 with random
    w, g, h of the shard's length, kernel vs plain bitwise; the same at
    tp2's two lengths (``tp_layouts``: its arena, whole, and a rank's tp
    leaves, each with its own multiplier vectors); then a shard taken at
    an offset off 16 bytes, which the kernel refuses (the SPMD step
    copies its shard into allocated buffers instead)."""
    import torch
    from poseidon_tpu_torch.ops import sgd
    from poseidon_tpu_torch.parallel import spmd

    gen = torch.Generator(device="cuda").manual_seed(5)
    records = []
    rate, mom = 0.01, 0.9
    cases = []
    for f in SPMD_FSDP:
        layout = net.arena_layout(4.0, align=f)
        lr_all, dec_all = spmd.shard_mult_vectors(layout, sp, f)
        n = layout.padded_total // f
        cases += [(f"fsdp{f} shard {fi}", layout.padded_total,
                   lr_all[fi * n:(fi + 1) * n], dec_all[fi * n:(fi + 1) * n])
                  for fi in (0, f - 1)]
    for label, layout in zip(("tp2 arena", "tp2 tp leaves"), tp_layouts):
        cases.append((label, layout.padded_total,
                      *layout.mult_vectors(sp.weight_decay)))
    for label, total, lr_np, dec_np in cases:
        n = len(lr_np)
        lr = torch.from_numpy(lr_np.copy()).cuda()
        dec = torch.from_numpy(dec_np.copy()).cuda()
        w = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda")
        h = torch.randn(n, generator=gen, device="cuda") * 1e-3
        wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
        sgd.sgd_update_cuda_(wk, g, hk, rate, lr, dec, mom)
        torch.cuda.synchronize()
        sgd.sgd_update_plain_(wp, g, hp, rate, lr, dec, mom)
        bitwise = torch.equal(wk, wp) and torch.equal(hk, hp)
        got, want = torch.cat([wk, hk]), torch.cat([wp, hp])
        del wk, hk, wp, hp
        p = torch.nn.Parameter(w.clone())
        p.grad = g.clone()
        opt = torch.optim.SGD([p], lr=rate, momentum=mom,
                              weight_decay=5e-4, foreach=True)
        rec = compare_case(
            "sgd_update", label, got, want, "float32",
            lambda: sgd.sgd_update_cuda_(w, g, h, rate, lr, dec, mom),
            lambda: sgd.sgd_update_plain_(w, g, h, rate, lr, dec, mom),
            opt.step, 7 * n * 4, 8 * n, card,
            extra=f" P={n} of padded_total {total}, bitwise={bitwise}")
        check(bitwise, f"K7 on the {label} is not bitwise")
        rec.update(length=n, bitwise=bitwise)
        records.append(rec)
        del w, g, h, lr, dec, got, want, p, opt
        torch.cuda.empty_cache()
    buf = torch.zeros(1 + 1024, device="cuda")
    view = buf[1:]
    try:
        sgd.sgd_update_cuda_(view, view, view, rate, view, view, mom)
        refused = False
    except ValueError as e:
        refused = "16-byte aligned" in str(e)
    print(f"[spmd] (d) K7 on a shard at an offset off 16 bytes: refused="
          f"{refused} (the step copies its shard into allocated buffers, "
          f"aligned whatever the shard's offset) [{card}]", flush=True)
    check(refused, "K7 took a vector off 16 bytes")
    return records


def phase_spmd(card: str, root: str, device=None, cli_batch=None) -> dict:
    """The SPMD mesh planner on the card (``device`` and ``cli_batch``
    are for a CPU rehearsal at a cut batch): (a), (b), (c) and (d) of
    the SPMD_* constants' comment. Two ranks sharing one card over gloo
    measure correctness and the host's staging, not a link."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.numeric import resolve_device
    from poseidon_tpu_torch.parallel import spmd
    from poseidon_tpu_torch.proto.messages import load_solver

    t_phase = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    batch = cli_batch or SPMD_CLI_BATCH
    iters = SPMD_CLI_ITERS
    out = {"batch": batch, "iters": iters, "arms": {}}
    per_step = {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2, "pool_bwd_nhwc": 3,
                "sgd_update": 1}

    def want(k7: int, n: int = iters):
        w = {k: 0 for k in read_launches()}
        if on_card:
            w.update({k: v * n for k, v in per_step.items()})
            w["sgd_update"] = k7 * n
        return w

    def arm(name, flags, k7=1, n=iters):
        run_ = dp_cli_run(card, root, name, flags, dev, batch, tag="spmd",
                          iters=n, launcher=SPMD_LAUNCH)
        peaks = peak_bytes(run_["logs"]) if on_card else []
        check(all(r == want(k7, n) for r in run_["launches"]),
              f"spmd {name} ranks' launches {run_['launches']} != "
              f"{want(k7, n)}")
        res = {**without_logs(run_), "peak_bytes": peaks}
        out["arms"][name] = res
        print(f"[spmd] {name}: {' '.join(flags)}, "
              f"{run_['s_per_step'] * 1e3:.1f} ms a step (wall, after the "
              f"first), peak "
              f"{[round(p / 2**30, 3) for p in peaks]} GiB a rank, "
              f"launches a rank {run_['launches'][0]} [{card}]", flush=True)
        return run_

    # every pair of CLI runs below runs beside another pair (four gloo
    # processes on the card): the walls a step are read under contention
    from concurrent.futures import ThreadPoolExecutor

    def together(*calls):
        with ThreadPoolExecutor(len(calls)) as pool:
            futures = [pool.submit(fn, *a, **kw) for fn, a, kw in calls]
            return [f.result() for f in futures]

    # (a) fsdp2 against its replicated control
    sh, rep = together(
        (arm, ("fsdp2", ("--mesh", "fsdp2")), {}),
        (arm, ("fsdp2_replicated", ("--mesh", "fsdp2,replicated")), {}))
    log0 = sh["logs"][0]
    line = next(ln for ln in log0.splitlines() if "spmd: " in ln)
    padded = int(line.split(" f32 (align 2)")[0].rsplit(" ", 1)[1])
    shard = int(line.split("the update over a ")[1].split("-f32")[0])
    print(f"[spmd] (a) {line.strip()} [{card}]", flush=True)
    check(shard * 2 == padded, f"K7 runs over {shard} of {padded} f32")
    a, b = (snapshot_arrays(r["state_path"]) for r in (sh, rep))
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    print(f"[spmd] (a) fsdp2 vs fsdp2,replicated: snapshots bitwise={same}; "
          f"losses {sh['losses']} vs {rep['losses']}; K7 1 a step over the "
          f"{shard}-f32 shard (padded_total {padded}) [{card}]", flush=True)
    check(same, "fsdp2 and its replicated control differ")
    out.update(fsdp2_bitwise=same, padded_total=padded, shard=shard)

    # (b) tp2 against its replicated control
    rtol, atol = SPMD_TP_TOL

    def distance(x, y, n):
        """max_abs over params and momentum, and the elements (and their
        leaves) outside rtol/atol."""
        a, b = (snapshot_arrays(r["state_path"]) for r in (x, y))
        keys = [k for k in b if k.startswith(("params/", "history/"))]
        err = max(float(np.abs(a[k] - b[k]).max()) for k in keys)
        outside = {k: int((np.abs(a[k] - b[k])
                           > atol + rtol * np.abs(b[k])).sum())
                   for k in keys}
        outside = {k: v for k, v in outside.items() if v}
        print(f"[spmd] (b) tp2 vs tp2,replicated after {n} iteration(s): "
              f"params and momentum max_abs {err:.3e}; elements outside "
              f"rtol {rtol:g} atol {atol:g}: {outside or 0} [{card}]",
              flush=True)
        return err, outside

    # the same pair in one pair of processes: the distance after every
    # iteration and the decisions that part the runs; K7 against plain at
    # every call, at the two lengths a tp2 rank updates (its arena whole,
    # its tp leaves), as the step lays them out
    sp = load_solver(ALEXNET_SOLVER)
    net = Net(alexnet_net_param(root, batch), "TRAIN", device="cpu",
              source_shapes={"data": (batch, 3, 227, 227),
                             "label": (batch,)})
    tp_layouts = spmd.step_layouts(
        net, spmd.ShardingPlan.build(net, MeshConfig(tp=2)))[::2]
    # the pair of processes beside (c)'s SSP pair on the fsdp mesh, whose
    # DENSE deltas reshard at the boundary
    out["tp2_pair"], ssp = together(
        (spmd_tp_pair, (card, root, dev, batch, iters,
                        [lay.padded_total for lay in tp_layouts]), {}),
        (arm, ("fsdp2_ssp", ("--mesh", "fsdp2", "--staleness", "2")), {}))
    out["ssp_losses"] = ssp["losses"]
    # the short pair of CLI runs, both arms at once: momentum carries into
    # its second update
    n_gate = min(SPMD_TP_GATE_ITERS, iters)
    tp1, tpr1 = together(
        (arm, (f"tp2_{n_gate}", ("--mesh", "tp2")), {"k7": 2, "n": n_gate}),
        (arm, (f"tp2_replicated_{n_gate}", ("--mesh", "tp2,replicated")),
         {"n": n_gate}))
    err1, outside1 = distance(tp1, tpr1, n_gate)
    check(not outside1, f"tp2 vs its replicated control after {n_gate} "
                        f"iterations: {outside1}")
    tp, tpr = together(
        (arm, ("tp2", ("--mesh", "tp2")), {"k7": 2}),
        (arm, ("tp2_replicated", ("--mesh", "tp2,replicated")), {}))
    plan_line = next(ln for ln in tp["logs"][0].splitlines()
                     if "sharding plan:" in ln)
    print(f"[spmd] (b) {plan_line.strip()} [{card}]", flush=True)
    check("tp {'fc6': 'column', 'fc7': 'column', 'fc8': 'column'}"
          in plan_line, "tp2 plan")
    err, outside = distance(tp, tpr, iters)
    losses_ok = bool(np.allclose(tp["losses"], tpr["losses"],
                                 rtol=SPMD_TP_LOSS_RTOL, atol=0))
    print(f"[spmd] (b) tp2 vs tp2,replicated losses within rtol "
          f"{SPMD_TP_LOSS_RTOL:g} over {iters} iterations: {losses_ok} "
          f"[{card}]", flush=True)
    check(losses_ok, f"tp2 losses {tp['losses']} vs {tpr['losses']}")
    rows = out["tp2_pair"]["iterations"]
    print(f"[spmd] (b) the pair's losses equal to the CLI runs' (the same "
          f"seeds and batches): tp2 "
          f"{[r['losses']['tp2'] for r in rows] == tp['losses']}, control "
          f"{[r['losses']['control'] for r in rows] == tpr['losses']} "
          f"[{card}]", flush=True)
    out.update(tp2_max_abs_gate=err1, tp2_max_abs=err,
               tp2_outside=outside, tp2_plan=plan_line.strip())

    # (d) K7 on the shards and at tp2's lengths, and the sharded state's
    # bytes a rank
    out["k7"] = spmd_k7_shards(card, net, sp, tp_layouts) if on_card else []
    fs = spmd.sharded_state_bytes(net, spmd.ShardingPlan.build(
        net, MeshConfig(fsdp=2)))
    rs = spmd.sharded_state_bytes(net, spmd.ShardingPlan.build(
        net, MeshConfig(fsdp=2, shard=False), shard_params=False))
    out.update(sharded_state_bytes=fs, replicated_state_bytes=rs)
    print(f"[spmd] (d) params + momentum a rank: fsdp2 sharded state "
          f"{fs['total']} B against the replicated arm's {rs['total']} B "
          f"({fs['total'] / rs['total']:.3f}x) [{card}]", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[spmd] fsdp2 bitwise to its control, tp2 within rtol "
          f"{rtol:g} atol {atol:g} of its control after {n_gate} "
          f"iterations and past it only after decisions part, SSP on fsdp2 "
          f"done, K7 on the shards and at tp2's lengths bitwise; phase wall "
          f"{out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def fabric_chaos(card: str, root: str, dev, batch: int) -> dict:
    """[fabric] (a): the chaos run and its fixed-membership replay in this
    process (the FABRIC_* constants' comment), then one dispatch's step
    with the kernels against the same step with the plain versions at
    STEP_TOL. The launches of each arm are zeroed just before it and read
    just after."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.parallel import fabric as F
    from poseidon_tpu_torch.parallel.async_ssp import (ParamService,
                                                       _tree_copy,
                                                       _tree_sub)
    from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import load_solver

    fast = dict(heartbeat_s=0.1, reconnect_deadline_s=30.0,
                backoff_base_s=0.01, backoff_cap_s=0.1)
    sp = load_solver(ALEXNET_SOLVER)
    shapes = {"data": (batch, 3, 227, 227), "label": (batch,)}
    nets = [Net(alexnet_net_param(root, batch), "TRAIN", device=dev,
                source_shapes=shapes, conv_layout="auto") for _ in (0, 1)]
    steps = [build_train_step(n, sp) for n in nets]
    init = {l: {k: v.detach().cpu().numpy() for k, v in d.items()}
            for l, d in nets[0].init(torch.Generator().manual_seed(1))
            .items()}

    def to_dev(tree):
        return {l: {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                    for k, v in d.items()} for l, d in tree.items()}

    def to_host(tree):
        return {l: {k: v.detach().cpu().numpy() for k, v in d.items()}
                for l, d in tree.items()}

    def feed(sid, clock):
        g = torch.Generator(device=dev).manual_seed(1000 + 17 * sid + clock)
        return {"data": torch.randn(shapes["data"], generator=g,
                                    device=dev),
                "label": torch.randint(0, 1000, shapes["label"],
                                       generator=g, device=dev
                                       ).to(torch.float32)}

    state0 = init_train_state(to_dev(init))

    def wait_for(pred, what, timeout_s=120.0):
        deadline = time.time() + timeout_s
        while not pred():
            check(time.time() < deadline, f"[fabric] timed out: {what}")
            time.sleep(0.005)

    def drive(chaos: bool) -> dict:
        svc = ParamService(_tree_copy(init), n_workers=2,
                           record_events=True, liveness_timeout_s=0.0)
        addr = ("127.0.0.1", svc.port)
        sw = [F.SliceWorker(sid, [0, 1], addr, FABRIC_STALENESS,
                            n_slices=2, client_opts=fast) for sid in (0, 1)]
        caches = [c for c, _ in (sw[0].join(), sw[1].join())]
        states = [state0, state0]
        losses = {0: [], 1: []}
        t0 = time.perf_counter()

        def dispatch(sid, clock):
            w = sw[sid]
            w.gate(clock, timeout_s=300)
            prev = _tree_copy(caches[sid])
            nets[sid].generator.manual_seed(7 + 100 * sid + clock)
            p, states[sid], m = steps[sid].step(to_dev(caches[sid]),
                                                states[sid],
                                                feed(sid, clock))
            caches[sid] = to_host(p)
            losses[sid].append((clock, float(m["loss"])))
            pushed = w.push(_tree_sub(caches[sid], prev))
            wait_for(lambda: w.client.poll_view().get(sid, -1) >= pushed,
                     f"slice {sid} clock {pushed} applied")
            caches[sid], _ = w.refresh()

        try:
            for clock in range(FABRIC_CLOCKS):
                if chaos and clock == FABRIC_KILL:
                    check(sw[1].fail_member(1) == "shrunk"
                          and sw[1].fail_member(0) == "dead",
                          "slice 1's members did not die in order")
                    sw[1].client.abandon()
                    wait_for(lambda: 1 in svc.failed_workers,
                             "slice 1 evicted")
                if clock == FABRIC_REJOIN:
                    if chaos:
                        sw[1] = F.SliceWorker(1, [10, 11], addr,
                                              FABRIC_STALENESS, n_slices=2,
                                              client_opts=fast)
                        caches[1], _ = sw[1].join()
                        check(sw[1].client.clock == FABRIC_KILL - 1,
                              "the re-admitted slice's rendezvous clock")
                    else:
                        caches[1], _ = sw[1].refresh()
                    states[1] = state0
                dispatch(0, clock)
                if not (FABRIC_KILL <= clock < FABRIC_REJOIN):
                    dispatch(1, clock)
            sw[0].mark_done()
            sw[1].mark_done()
            wait_for(lambda: svc.clocks[0] >= FABRIC_CLOCKS - 1,
                     "the survivor's last clock")
            applied = [(e[1], e[2]) for e in svc.events
                       if e[0] == "push" and not e[4]]
            return {"anchor": _tree_copy(svc.anchor), "losses": losses,
                    "applied": applied, "rejoins": svc.rejoins,
                    "wall_s": time.perf_counter() - t0}
        finally:
            for w in sw:
                w.close()
            svc.close()

    out = {}
    arms = {}
    for name, chaos in (("chaos", True), ("replay", False)):
        zero_launches()
        arms[name] = drive(chaos)
        arms[name]["launches"] = read_launches()
    c, r = arms["chaos"], arms["replay"]
    same = all(np.array_equal(c["anchor"][l][k], r["anchor"][l][k])
               for l in r["anchor"] for k in r["anchor"][l])
    dispatched = {name: sum(len(v) for v in a["losses"].values())
                  for name, a in arms.items()}
    once = len(c["applied"]) == len(set(c["applied"])) == dispatched["chaos"]
    print(f"[fabric] (a) 2 slices x one-device AlexNet f32 NHWC at {batch}, "
          f"{FABRIC_CLOCKS} clocks, staleness {FABRIC_STALENESS}: slice 1 "
          f"killed at clock {FABRIC_KILL}, re-admitted at {FABRIC_REJOIN} "
          f"(rejoins {c['rejoins']}); chaos anchor bitwise to the replay: "
          f"{same}; losses equal: {c['losses'] == r['losses']}; every "
          f"(slice, clock) applied once: {once}; wall {c['wall_s']:.1f} s "
          f"/ {r['wall_s']:.1f} s for {dispatched['chaos']} / "
          f"{dispatched['replay']} dispatches [{card}]", flush=True)
    check(same and c["losses"] == r["losses"],
          "the chaos run differs from its fixed-membership replay")
    check(once and c["rejoins"] >= 1, "a (slice, clock) applied twice, "
                                      "or slice 1 never re-admitted")
    check(all(math.isfinite(v) for ls in c["losses"].values()
              for _, v in ls), f"chaos losses {c['losses']}")
    per_step = {"lrn_fwd_nhwc": 2, "lrn_bwd_nhwc": 2, "pool_bwd_nhwc": 3,
                "sgd_update": 1}
    for name, a in arms.items():
        want = {k: 0 for k in a["launches"]}
        if dev.type == "cuda":
            want.update({k: v * dispatched[name]
                         for k, v in per_step.items()})
        check(a["launches"] == want,
              f"[fabric] {name} launches {a['launches']} != {want}")
    # one dispatch's step, the kernels against their plain versions
    rtol, atol = STEP_TOL
    runs = []
    for plain in (False, True):
        before = read_launches()
        nets[0].generator.manual_seed(7)
        ctx = (plain_versions(nets[0], steps[0]) if plain
               else contextlib.nullcontext())
        with ctx:
            p, st, m = steps[0].step(to_dev(init), state0, feed(0, 0))
        runs.append((float(m["loss"]), to_host(p),
                     to_host(st.solver.history)))
        if plain:
            check(read_launches() == before,
                  "the plain-version step launched a kernel")
    worst = 0.0
    for i in (1, 2):
        for l in runs[0][i]:
            for k in runs[0][i][l]:
                a, b = runs[0][i][l][k], runs[1][i][l][k]
                worst = max(worst, float(np.abs(a - b).max()))
                check(bool(np.allclose(a, b, rtol=rtol, atol=atol)),
                      f"[fabric] {l}/{k}: kernels vs plain versions")
    print(f"[fabric] (a) one dispatch's step, kernels vs plain versions: "
          f"loss {runs[0][0]!r} vs {runs[1][0]!r}, params and momentum "
          f"within rtol {rtol:g} atol {atol:g} (max_abs {worst:.3e}) "
          f"[{card}]", flush=True)
    out.update(batch=batch, bitwise=same, applied_once=once,
               rejoins=c["rejoins"], dispatches=dispatched,
               launches=c["launches"], replay_launches=r["launches"],
               wall_s={k: a["wall_s"] for k, a in arms.items()},
               step_vs_plain_max_abs=worst)
    return out


FABRIC_FLUSH_KEYS = ("gather", "d2h", "push", "refresh", "gate", "h2d",
                     "broadcast")


def phase_fabric(card: str, root: str, device=None, batch=None,
                 cli_batch=None) -> dict:
    """The two-tier fabric on the card (``device``, ``batch`` and
    ``cli_batch`` are for a CPU rehearsal at a cut batch): (a)
    ``fabric_chaos``; (b) the CLI's slices (the FABRIC_* constants'
    comment): every rank exits 0 (a non-finite loss on any rank exits
    non-zero) and launches K4-/K5-/K6-NHWC and K7 2/2/3/1 a step, rank
    0's losses finite; every member's parameters bitwise its leader's
    after every refresh (their digests); every K7 call bitwise to its
    plain version on copies of its inputs, one launch each over the
    rank's fsdp shard; the ms a flush by phase of each slice's leader and
    members, and each rank's peak."""
    import socket
    import numpy as np
    import torch
    from poseidon_tpu_torch.numeric import resolve_device

    t_phase = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"chaos": fabric_chaos(card, root, dev, batch or FABRIC_BATCH)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache() if on_card else None

    # (b) the CLI: 2 slices x 2 gloo ranks, fsdp2 inside each slice
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    iters = FABRIC_CLI_ITERS
    run_ = dp_cli_run(
        card, root, "fsdp2_slices",
        ("--async_ssp", "--slice", "--mesh", "fsdp2", "--staleness", "1",
         "--async_sync_every", str(FABRIC_CLI_SYNC)), dev,
        cli_batch or FABRIC_CLI_BATCH, ranks=4, tag="fabric", iters=iters,
        same_snapshots=False, launcher=FABRIC_LAUNCH,
        env_extra={"POSEIDON_ASYNC_SERVICE": f"127.0.0.1:{port}",
                   "POSEIDON_ASYNC_TOKEN": ASYNC_TOKEN,
                   "POSEIDON_FABRIC_DIGEST": "1"},
        rank_env=lambda r: {"POSEIDON_SLICE_ID": str(r // 2),
                            "POSEIDON_SLICE_SIZE": "2"})
    logs = run_["logs"]
    want = {k: 0 for k in read_launches()}
    if on_card:
        want.update({"lrn_fwd_nhwc": 2 * iters, "lrn_bwd_nhwc": 2 * iters,
                     "pool_bwd_nhwc": 3 * iters, "sgd_update": iters})
    check(all(r == want for r in run_["launches"]),
          f"fabric ranks' launches {run_['launches']} != {want}")
    refreshes = 1 + iters // FABRIC_CLI_SYNC
    for sid in (0, 1):
        check(f"fabric tier: slice {sid} of 2 (2 process(es)/slice"
              in logs[2 * sid], f"slice {sid}'s leader did not speak")
        digests = [[ln.split()[-1] for ln in logs[2 * sid + m].splitlines()
                    if ln.startswith(f"fabric digest: slice {sid} ")]
                   for m in (0, 1)]
        check(digests[0] == digests[1]
              and len(digests[0]) == refreshes + (sid == 0),
              f"slice {sid}'s member parted from its leader: {digests}")
    k7 = []
    for r, log in enumerate(logs):
        line = next(ln for ln in log.splitlines() if ln.startswith("[k7] "))
        k7.append(json.loads(line[len("[k7] "):]))
    shard = k7[0][0]["length"] if k7[0] else 0
    k7_ok = (all(len(calls) == iters for calls in k7)
             and all(c["bitwise"] and c["length"] == shard
                     and c["launches"] == (1 if on_card else 0)
                     for calls in k7 for c in calls))
    print(f"[fabric] (b) K7 on each rank's fsdp2 shard ({shard} f32): "
          f"{sum(map(len, k7))} calls, each bitwise to its plain version "
          f"with {'one launch' if on_card else 'no launch (CPU)'}: "
          f"{k7_ok} [{card}]", flush=True)
    check(k7_ok, f"fabric K7 calls {k7}")
    flush = {}
    for r, log in enumerate(logs):
        head = (f"async-SSP tier (rank {r // 2}): " if r % 2 == 0
                else "fabric member (rank ")
        line = next(ln for ln in log.splitlines() if ln.startswith(head))
        vals = dict(part.partition("=")[::2] for part in
                    line.split("): ", 1)[1].split(", "))
        flush[r] = {k: float(vals[f"async_{k}_ms_per_flush"])
                    for k in FABRIC_FLUSH_KEYS
                    if f"async_{k}_ms_per_flush" in vals}
        print(f"[fabric] (b) rank {r} ({'leader' if r % 2 == 0 else 'member'}"
              f" of slice {r // 2}) ms a flush: "
              + ", ".join(f"{k} {v:g}" for k, v in flush[r].items())
              + f" [{card}]", flush=True)
    peaks = peak_bytes(logs) if on_card else []
    out["cli"] = {**{k: v for k, v in without_logs(run_).items()
                     if k != "state_path"},
                  "k7_calls": sum(map(len, k7)), "k7_bitwise": k7_ok,
                  "shard": shard, "flush_ms": flush, "peak_bytes": peaks,
                  "refreshes": refreshes}
    out["cli_launches"] = sum_launches(run_["launches"])
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[fabric] chaos bitwise to its replay, 2 slices x 2 fsdp2 ranks "
          f"by the CLI: members bitwise to their leaders, K7 bitwise; peak "
          f"{[round(p / 2**30, 3) for p in peaks]} GiB a rank; phase wall "
          f"{out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def phase_digits(card: str, runs=(((), "digits"),)) -> list:
    """The CLI on real data: the digits solver, 1000 iterations, on the
    card (its default layout: NHWC there), once a (flags, tag) of
    ``runs``, the runs at once; returns each run's final test accuracy."""
    here = os.path.dirname(os.path.abspath(__file__))
    with contextlib.ExitStack() as stack:
        procs = []
        t0 = time.perf_counter()
        for flags, tag in runs:
            out_dir = stack.enter_context(tempfile.TemporaryDirectory())
            # the runs share the host's cores
            env = dict(os.environ, OMP_NUM_THREADS=str(max(
                1, (os.cpu_count() or 2) // len(runs))))
            procs.append((flags, tag, out_dir, subprocess.Popen(
                [sys.executable, "-m", "poseidon_tpu_torch", "train",
                 f"--solver={DIGITS_SOLVER}", "--output_dir", out_dir,
                 *flags], cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        accs = []
        for flags, tag, out_dir, proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"digits training exited {proc.returncode}:\n"
                  f"{stdout[-3000:]}\n{stderr[-3000:]}")
            with open(os.path.join(out_dir,
                                   "digits_quick_test0_outputs.csv")) as f:
                rows = list(csv.DictReader(f))
            accs.append(digits_report(card, flags, tag, rows, stdout, wall))
    return accs


def digits_report(card: str, flags, tag: str, rows, stdout: str,
                  wall: float) -> float:
    """One digits run's checks and lines; -> its final accuracy."""
    final = rows[-1]
    acc = float(final["accuracy"])
    policy = [ln for ln in stdout.splitlines()
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
          f"{DIGITS_MIN_ACC}) in {wall:.1f} s of the runs' wall [{card}]",
          flush=True)
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
    import torch
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
    top = []
    for r in ex.decode_rungs:
        decode[r], top = decode_step_timing(ex, r)
        print(f"[lm] decode rung {r}: device busy "
              f"{decode[r]['device_busy_ms']:.3f} ms (torch.profiler, "
              f"{decode[r]['device_ops_per_step']:.0f} device ops a step), "
              f"CUDA-event span {decode[r]['cuda_event_ms']:.3f} ms, host "
              f"wall {decode[r]['host_wall_ms']:.3f} ms a step: busy share "
              f"{decode[r]['busy_share']:.3f} [{card}]", flush=True)
    if top:
        print(f"[lm] rung {ex.decode_rungs[-1]} step, top kernels (mean ms "
              f"a step):", flush=True)
        for name, ms in top:
            print(f"  {ms:8.4f} ms  {name[:90]}", flush=True)
    return {"prefill_ms": prefill_ms, "prefill_busy_ms": prefill_busy,
            "prefill_flash_ms": prefill_flash, "decode": decode}


def decode_step_timing(ex, r: int, steps: int = 5):
    """One decode step of ``ex`` at rung ``r`` (inactive rows, the scratch
    page): its device busy time (the sum of its device ops in
    torch.profiler over ``steps`` profiled steps), its CUDA-event span and
    its host wall time (tensors in, logits back on the host; unprofiled,
    mean of 10), whose ratio is the busy share. Returns (that dict, the
    step's top 6 kernels as (name, mean ms a step))."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = (np.zeros((r,), np.int64),
            np.zeros((r, ex.pool.max_pages_per_seq), np.int64),
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
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return ({"device_busy_ms": busy, "cuda_event_ms": span,
             "host_wall_ms": wall, "busy_share": busy / wall if wall else None,
             "device_ops_per_step": launches / steps},
            [(name, us / steps / 1e3) for name, us in top])


def forced_logits(ex, prompt, tokens):
    """Per-step logits (len(tokens), V) of one request through ``ex``'s
    paged path by hand, fed ``tokens`` (not its own argmax): step 0 from
    the prefill, step i from the rung-1 decode of tokens[i - 1]."""
    import numpy as np
    sid = -1
    ex.pool.alloc(sid, ex.reserve_len(len(prompt), len(tokens)))
    try:
        logits, caches = ex.prefill(prompt)
        ex.pool.write_prefill(sid, caches)
        table = ex.pool.table([sid])
        steps = [logits]
        for i, tok in enumerate(tokens[:-1]):
            steps.append(ex.decode(np.array([tok]), table,
                                   np.array([len(prompt) + i]))[0])
    finally:
        ex.pool.free(sid)
    return np.stack(steps)


def lm_tp_flips(one, tp, prompts, want, got) -> list:
    """Each request whose tp tokens (``got``) differ from the one-device
    executor's (``want``): both arms fed the one-device tokens (the same
    prefix), the first step whose tokens differ must be an f32 near-tie:
    the one-device logits of the two tokens within LM_TOL of each other,
    and the two arms' logits there within LM_TOL. Returns one record a
    flip; fails otherwise."""
    import numpy as np
    rtol, atol = LM_TOL
    flips = []
    for i, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        k = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        lo = forced_logits(one, prompts[i], w)[k]
        lt = forced_logits(tp, prompts[i], w)[k]
        a, b = w[k], g[k]
        gap = float(abs(lo[a] - lo[b]))
        err = float(np.abs(lo - lt).max())
        rec = {"request": i, "step": k, "one": a, "tp": b, "top2_gap": gap,
               "logits_max_abs": err}
        print(f"[lm_tp_serve] request {i} flips at step {k}: one-device "
              f"token {a}, tp token {b}; one-device logits {lo[a]:.7g} vs "
              f"{lo[b]:.7g} (gap {gap:.3e}), the arms' logits max_abs "
              f"{err:.3e} (rtol {rtol:g}, atol {atol:g})", flush=True)
        check(gap <= atol + rtol * abs(float(lo[a]))
              and bool(np.allclose(lo, lt, rtol=rtol, atol=atol)),
              f"request {i}: tp and one-device tokens part at step {k} "
              f"without a near-tie ({rec})")
        flips.append(rec)
    return flips


def phase_lm_tp_serve(card: str, device=None, preset: str = LM_PRESET,
                      n_requests: int = LM_REQUESTS,
                      solo_requests: int = LM_SOLO_REQUESTS,
                      swap_requests: int = LMTP_SWAP_REQUESTS) -> dict:
    """``[lm_tp_serve]`` (the module docstring's item 7). ``device``,
    ``preset`` and the request counts are for a CPU rehearsal only."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.config import MeshConfig
    from poseidon_tpu_torch.models.transformer import init_params
    from poseidon_tpu_torch.runtime.cli import build_generate_executor

    t_phase = time.perf_counter()
    dev = torch.device(device or "cuda:0")
    on_card = dev.type == "cuda"
    group = (str(dev),) * LMTP_TP
    t0 = time.perf_counter()
    one = build_generate_executor(preset, device=dev)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = build_generate_executor(preset, mesh_cfg=MeshConfig(tp=LMTP_TP),
                                 devices=group)
    tp_s = time.perf_counter() - t0
    cfg = one.cfg
    print(f"[lm_tp_serve] {preset} as tp{LMTP_TP} over {list(group)} "
          f"(mesh {tp.snapshot()['mesh']}; {cfg.n_heads // LMTP_TP} heads "
          f"and d_ff {cfg.d_ff // LMTP_TP} a shard), built and warmed in "
          f"{tp_s:.2f} s, beside one device ({one_s:.2f} s); seed-0 weights",
          flush=True)

    # (a) prefill logits at every bucket
    rtol, atol = LM_TOL
    prompts = lm_traffic(one, n_requests)
    prefill_err = {}
    for b, prompt in zip(one.prompt_buckets, prompts):
        lo, _ = one._run_prefill(prompt)
        lt, _ = tp._run_prefill(prompt)
        prefill_err[b] = float(np.abs(lo - lt).max())
        check(bool(np.allclose(lt, lo, rtol=rtol, atol=atol)),
              f"tp{LMTP_TP} prefill logits at bucket {b} disagree with one "
              f"device's ({prefill_err[b]})")
    print(f"[lm_tp_serve] (a) prefill first-token logits, tp{LMTP_TP} vs "
          f"one device, max_abs by bucket {prefill_err} (rtol {rtol:g}, atol "
          f"{atol:g})", flush=True)

    def serve(ex, reqs, clients):
        """Greedy tokens of ``reqs`` from ``clients`` threads straight into
        ``ex``'s scheduler, and the generated tokens/s."""
        sched = ex.make_batcher(max_queue=len(reqs))
        try:
            t0 = time.perf_counter()
            toks = fleet_lm_tokens(sched, reqs, clients, LM_MAX_NEW)
            return toks, len(reqs) * LM_MAX_NEW / (time.perf_counter() - t0)
        finally:
            sched.close()

    # (a), (b), (d): the same traffic through each scheduler in turns (one
    # device at 8 clients, tp at 8 and at 1, one device at 1); the launch
    # counters span the tp runs alone
    solo = prompts[:solo_requests]
    want, one_8 = serve(one, prompts, LM_CLIENTS)
    zero_launches()
    prefills0 = tp.prefills
    got, tp_8 = serve(tp, prompts, LM_CLIENTS)
    got_1, tp_1 = serve(tp, solo, 1)
    sync(dev)
    counts = read_launches()
    prefills = tp.prefills - prefills0
    want_1, one_1 = serve(one, solo, 1)
    check(tp.pool.all_free() and one.pool.all_free(),
          "KV pages leaked after the drain")
    check(all(len(t) == LM_MAX_NEW for t in got + want + got_1 + want_1),
          f"a reply without {LM_MAX_NEW} tokens")
    flips = (lm_tp_flips(one, tp, prompts, want, got)
             + lm_tp_flips(one, tp, solo, want_1, got_1))
    same = sum(a == b for a, b in zip(got, want))
    per_prefill = LMTP_TP * cfg.n_layers if on_card else 0
    print(f"[lm_tp_serve] (a) {n_requests} requests from {LM_CLIENTS} "
          f"clients, max_new {LM_MAX_NEW}: tp{LMTP_TP} tokens equal to one "
          f"device's for {same}/{n_requests} ({len(flips)} near-tie flips "
          f"in all, the {solo_requests} 1-client requests included); (b) "
          f"{prefills} tp prefills, launches {counts} (flash_fwd expected "
          f"{per_prefill} x {prefills})", flush=True)
    check(counts["flash_fwd"] == per_prefill * prefills,
          f"flash_fwd launched {counts['flash_fwd']} times for {prefills} "
          f"tp{LMTP_TP} prefills (expected {per_prefill} a prefill)")
    check(all(v == 0 for k, v in counts.items() if k != "flash_fwd"),
          f"tp serving launched a kernel of another path: {counts}")

    # (c) swap_params to seed-1 weights while requests are in flight
    new = init_params(cfg, torch.Generator().manual_seed(1))
    swap_prompts = lm_traffic(one, 2 * swap_requests, seed=7)
    before, after = swap_prompts[:swap_requests], swap_prompts[swap_requests:]
    sched = tp.make_batcher(max_queue=2 * swap_requests)
    box = {}
    try:
        flight = threading.Thread(
            target=lambda: box.update(toks=fleet_lm_tokens(
                sched, before, LM_CLIENTS, LM_MAX_NEW)), daemon=True)
        flight.start()
        deadline = time.monotonic() + 120
        while not sched.inflight_rows:
            check(time.monotonic() < deadline, "the swap's traffic stalled")
            time.sleep(0.001)
        t0 = time.perf_counter()
        version = tp.swap_params(new)
        swap_s = time.perf_counter() - t0
        inflight = sched.inflight_rows
        got_new = fleet_lm_tokens(sched, after, LM_CLIENTS, LM_MAX_NEW)
        flight.join(timeout=300)
        check(not flight.is_alive() and "toks" in box,
              "requests in flight during the swap did not complete")
    finally:
        sched.close()
    one.swap_params(new)
    want_new, _ = serve(one, after, LM_CLIENTS)
    flips_new = lm_tp_flips(one, tp, after, want_new, got_new)
    same_new = sum(a == b for a, b in zip(got_new, want_new))
    print(f"[lm_tp_serve] (c) swap_params to seed-1 weights in {swap_s:.3f} "
          f"s with {inflight} sequences in flight (version {version}): the "
          f"{swap_requests} requests in flight completed; the "
          f"{swap_requests} submitted after it equal the seed-1 one-device "
          f"executor's tokens for {same_new}/{swap_requests} "
          f"({len(flips_new)} near-tie flips)", flush=True)
    check(all(len(t) == LM_MAX_NEW for t in box["toks"]),
          "a request in flight during the swap came back short")

    # (d) tokens/s and a decode step's host wall beside its device time
    print(f"[lm_tp_serve] (d) generated tokens/s, one device / tp{LMTP_TP}: "
          f"{one_8:.1f} / {tp_8:.1f} at {LM_CLIENTS} clients "
          f"({tp_8 / one_8:.3f}x), {one_1:.1f} / {tp_1:.1f} at 1 client "
          f"({tp_1 / one_1:.3f}x) [{card}]", flush=True)
    decode = {}
    if on_card:
        for r in LMTP_TIMING_RUNGS:
            for arm, ex in (("one", one), (f"tp{LMTP_TP}", tp)):
                decode[f"{arm} rung {r}"], _ = decode_step_timing(ex, r)
            a, b = decode[f"one rung {r}"], decode[f"tp{LMTP_TP} rung {r}"]
            print(f"[lm_tp_serve] (d) decode rung {r}, one device / "
                  f"tp{LMTP_TP}: host wall {a['host_wall_ms']:.3f} / "
                  f"{b['host_wall_ms']:.3f} ms a step "
                  f"({b['host_wall_ms'] / a['host_wall_ms']:.3f}x), device "
                  f"busy {a['device_busy_ms']:.3f} / "
                  f"{b['device_busy_ms']:.3f} ms ({a['device_ops_per_step']:.0f}"
                  f" / {b['device_ops_per_step']:.0f} device ops), busy share "
                  f"{a['busy_share']:.3f} / {b['busy_share']:.3f} [{card}]",
                  flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[lm_tp_serve] phase wall {wall:.1f} s", flush=True)
    return {"tp": LMTP_TP, "devices": list(group),
            "mesh": tp.snapshot()["mesh"], "build_s": tp_s,
            "prefill_logits_max_abs": prefill_err,
            "requests": n_requests, "tokens_equal": same, "flips": flips,
            "prefills": prefills, "launches": counts,
            "launches_per_prefill": counts["flash_fwd"] // max(1, prefills),
            "swap": {"s": swap_s, "inflight": inflight,
                     "tokens_equal": same_new, "flips": flips_new},
            "tokens_per_s": {"one": {LM_CLIENTS: one_8, 1: one_1},
                             f"tp{LMTP_TP}": {LM_CLIENTS: tp_8, 1: tp_1}},
            "decode": decode, "wall_s": wall}


def lm_train_setup(preset: str, batch: int, seq: int, device,
                   n_layers: int = 0):
    """(cfg, solver, params, tokens, targets): gpt_small (``n_layers`` of
    its layers when given, or the tiny preset of a CPU rehearsal) with
    seeded weights, the SGD solver of bench.py's lm block, and seeded
    tokens and targets (RandomState(1), as there)."""
    import dataclasses

    import numpy as np
    import torch
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.proto.messages import SolverParameter

    if preset == "gpt_small":
        cfg = tfm.gpt_small_config(max_seq=seq)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
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


def lmp_flash_want(per_layer: int, layers: int, remat: bool,
                   steps: int) -> dict:
    """K1, K2 and K3 launches of ``steps`` LM steps whose attention makes
    ``per_layer`` launches of each kernel a layer a direction."""
    fwd = per_layer * layers * (2 if remat else 1)
    return {"flash_fwd": fwd * steps,
            "flash_dq": per_layer * layers * steps,
            "flash_dkv": per_layer * layers * steps}


def lmp_compare(got, want, dtype_name: str, tol, ring: bool) -> tuple:
    """(ok, max_abs, the largest share of its tolerance an entry uses) of
    ``got`` against ``want`` (B, H, S, D) at ``tol``; a ring's bf16 atol
    is at least LMP_BF16_ATOL_SHARE of the largest magnitude in want's
    (S, D) block of each (batch, head)."""
    rtol, atol = tol[dtype_name]
    got, want = got.float(), want.float()
    if ring and dtype_name == "bfloat16":
        atol = (LMP_BF16_ATOL_SHARE * want.abs().amax(
            (-2, -1), keepdim=True)).clamp(min=atol)
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    return (bool((err <= bound).all()), float(err.max()),
            float((err / bound).max()))


def lmp_attention(card: str, rank: int, dev, shape=LMP_ATT_SHAPE) -> dict:
    """(a) on a rank of the seq group of 2: ring flash attention and
    Ulysses on this rank's block of seeded (B, H, 1024, D) q, k, v and
    cotangent, in f32 and bf16: out, dq, dk, dv against the flash
    kernels and the plain versions on the gathered sequence, each
    direction's launches, and the card ms of a ring forward and backward
    beside the one-device flash on the whole sequence."""
    import torch
    from poseidon_tpu_torch.ops import flash
    from poseidon_tpu_torch.parallel import sequence as seq_mod
    from poseidon_tpu_torch.runtime import cluster

    group = cluster.build_named_groups(("seq",), (2,), rank, dev, "gloo",
                                       ranks=range(2))
    if group is None:
        return {}
    seq = group["seq"]
    b, h, s_local, d = shape
    full = (b, h, 2 * s_local, d)
    rows = slice(rank * s_local, (rank + 1) * s_local)
    on_card = dev.type == "cuda"
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(17)
        q, k, v, g = (torch.randn(full, generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
        # the references on the gathered sequence: K1-K3, and the plain
        # versions
        refs = {}
        for ref, plain in (("kernels", False), ("plain", True)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = flash.flash_attention(*leaves, True, None, None, plain)
            grads = torch.autograd.grad(o, leaves, g)
            refs[ref] = [t[:, :, rows].detach() for t in (o, *grads)]
        for kind in ("ring", "ulysses"):
            leaves = [t[:, :, rows].clone().requires_grad_(True)
                      for t in (q, k, v)]
            sync(dev)
            zero_launches()
            if kind == "ring":
                o = seq_mod.ring_flash_attention(*leaves, seq, True)
            else:
                o = seq_mod.ulysses_attention(*leaves, seq, causal=True)
            sync(dev)
            fwd = read_launches()
            zero_launches()
            grads = torch.autograd.grad(o, leaves, g[:, :, rows])
            sync(dev)
            bwd = read_launches()
            per = rank + 1 if kind == "ring" else 1
            want_fwd = {"flash_fwd": per if on_card else 0}
            want_bwd = {"flash_dq": per if on_card else 0,
                        "flash_dkv": per if on_card else 0}
            got_fwd = {k2: fwd[k2] for k2 in want_fwd}
            got_bwd = {k2: bwd[k2] for k2 in want_bwd}
            check(got_fwd == want_fwd and got_bwd == want_bwd
                  and fwd["flash_dq"] == fwd["flash_dkv"] == 0
                  and bwd["flash_fwd"] == 0,
                  f"{kind} {name} rank {rank}: launches forward {fwd}, "
                  f"backward {bwd}; expected {want_fwd}, {want_bwd}")
            rec = {"launches_fwd": got_fwd, "launches_bwd": got_bwd}
            for ref, want in refs.items():
                for tname, a, w, tol in zip(
                        ("out", "dq", "dk", "dv"), (o, *grads), want,
                        (FLASH_TOL,) + (FLASH_BWD_TOL,) * 3):
                    ok, err, used = lmp_compare(a.detach(), w, name, tol,
                                                kind == "ring")
                    rec[f"{tname}_vs_{ref}"] = err
                    rec["tol_used"] = max(rec.get("tol_used", 0.0), used)
                    check(ok, f"{kind} {name} rank {rank}: {tname} vs the "
                              f"{ref} on the gathered sequence, max_abs "
                              f"{err}")
            out[f"{kind} {name}"] = rec
        if on_card:
            ql, kl, vl, gl = (t[:, :, rows].contiguous() for t in (q, k, v, g))
            o_l, lse_l = seq_mod.ring_flash_fwd(ql, kl, vl, seq, True)
            ring_fwd = cuda_time_ms(lambda: seq_mod.ring_flash_fwd(
                ql, kl, vl, seq, True), warmup=1, reps=5)
            ring_bwd = cuda_time_ms(lambda: seq_mod.ring_flash_bwd(
                ql, kl, vl, o_l, lse_l, gl, seq, True), warmup=1, reps=5)
            o_f, lse_f = flash.flash_fwd_cuda(q, k, v, True)
            delta = flash.flash_delta(g, o_f)
            one_fwd = cuda_time_ms(lambda: flash.flash_fwd_cuda(q, k, v,
                                                                True))
            one_bwd = cuda_time_ms(lambda: flash.flash_bwd_cuda(
                q, k, v, g, lse_f, delta, True))
            out[f"ms {name}"] = {"ring_fwd": ring_fwd, "ring_bwd": ring_bwd,
                                 "one_device_fwd": one_fwd,
                                 "one_device_bwd": one_bwd}
        del q, k, v, g, refs
    return out


def lm_control(tag: str, dev, step, params, tk, tg, want: dict,
               what: str):
    """A one-device control of an LM phase (``tag``) on this rank: a
    warm-up, then LMP_STEPS steps from ``params``; ((losses, {1: tree,
    LMP_STEPS: tree}), record) with its launches exactly ``want``."""
    from poseidon_tpu_torch.solvers.updates import init_state
    step(params, init_state(params), tk, tg)               # the warm-up
    sync(dev)
    zero_launches()
    p, st = params, init_state(params)
    losses, kept, walls = [], {}, []
    for i in range(LMP_STEPS):
        t0 = time.perf_counter()
        p, st, m = step(p, st, tk, tg)
        losses.append(float(m["loss"]))                    # synchronizes
        walls.append(time.perf_counter() - t0)
        if i in (0, LMP_STEPS - 1):
            kept[i + 1] = tree_clone(p)
    counts = read_launches()
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"[{tag}] {what} launches {counts} != {want}")
    return (losses, kept), {"losses": losses, "launches": counts,
                            "wall_s": walls}


def lm_arm(tag: str, arm: str, rank: int, dev, step, params, tk, tg,
           canonical, control, want: dict, digest_layers=()) -> dict:
    """One arm of an LM phase (``tag``) on this rank: a warm-up, then LMP_STEPS steps from
    ``params`` (this rank's shards); after step 1 and the last, the
    canonical tree (``canonical``, a collective every rank of the arm
    calls) against the control's (rank 0): after step 1 the loss within
    LMP_LOSS_RTOL and every leaf within LMP_TOL. The launches exactly
    ``want``; the record holds the walls, the bytes sent a step by kind,
    the peak memory and, for ``digest_layers``, the digest of this rank's
    leaves of them after the last step."""
    import torch
    from poseidon_tpu_torch.parallel import mesh as mesh_mod
    from poseidon_tpu_torch.solvers.updates import init_state

    on_card = dev.type == "cuda"
    step(params, init_state(params), tk, tg)               # the warm-up
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    mesh_mod.EXCHANGED.clear()
    p, st = params, init_state(params)
    losses, walls, dist = [], [], {}
    for i in range(LMP_STEPS):
        t0 = time.perf_counter()
        p, st, m = step(p, st, tk, tg)
        losses.append(float(m["loss"]))                    # synchronizes
        walls.append(time.perf_counter() - t0)
        if i not in (0, LMP_STEPS - 1):
            continue
        sent = dict(mesh_mod.EXCHANGED)
        canon = canonical(p)
        mesh_mod.EXCHANGED.clear()
        mesh_mod.EXCHANGED.update(sent)        # the gathers are not the step's
        if control is not None:
            ref = control[1][i + 1]
            dist[f"max_abs_step{i + 1}"] = max(
                float((canon[a][b] - ref[a][b]).abs().max())
                for a in ref for b in ref[a])
            if i == 0:
                want_loss = control[0][0]
                check(abs(losses[0] - want_loss)
                      <= LMP_LOSS_RTOL * abs(want_loss),
                      f"[{tag}] {arm} step 1 loss {losses[0]!r} vs the "
                      f"control's {want_loss!r}")
                rtol, atol = LMP_TOL
                for a in ref:
                    for b in ref[a]:
                        check(bool(torch.allclose(canon[a][b], ref[a][b],
                                                  rtol=rtol, atol=atol)),
                              f"[{tag}] {arm} step 1 {a}/{b} vs the "
                              f"control: max_abs "
                              f"{float((canon[a][b] - ref[a][b]).abs().max())}")
        del canon
    counts = read_launches()
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"[{tag}] {arm} rank {rank} launches {counts} != {want}")
    rec = {"rank": rank, "losses": losses, "wall_s": walls,
           "launches": counts,
           "exchanged_bytes_a_step": {k: v / LMP_STEPS for k, v in
                                      mesh_mod.EXCHANGED.items()},
           "peak_bytes": (torch.cuda.max_memory_allocated() if on_card
                          else 0), **dist}
    if digest_layers:
        rec["digest"] = lpe_digest(p, digest_layers)
    return rec


def lmp_canonical(params, kind: str, groups, cfg):
    """The arm's params in the canonical one-device layout (a tp arm's
    shards all-gathered over its tp group)."""
    from poseidon_tpu_torch.models import transformer as tfm
    if kind != "tp":
        return params
    return tfm.from_tp_layout(tfm.tp_unshard(params, groups["model"]), cfg)


def lmp_steps(card: str, rank: int, dev, preset: str) -> dict:
    """(b) on this rank: the control (rank 0 alone: the one-device step,
    a warm-up, then LMP_STEPS steps) and then each arm of LMP_ARMS, every
    rank of the job building every arm's groups."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.runtime import cluster

    on_card = dev.type == "cuda"
    cfg, sp, params0, toks, tgts = lm_train_setup(preset, LMP_BATCH,
                                                  LMP_SEQ, dev, LMP_LAYERS)
    out = {}
    control = None
    if rank == 0:
        control, out["control"] = lm_control(
            "lm_par", dev, tfm.build_dp_sp_train_step(cfg, sp, dev),
            params0, toks, tgts,
            lmp_flash_want(1, cfg.n_layers, True, LMP_STEPS)
            if on_card else {}, "control")
    for arm, (axes, shape, kind) in LMP_ARMS.items():
        n = int(np.prod(shape))
        groups = cluster.build_named_groups(axes, shape, rank, dev, "gloo",
                                            ranks=range(n))
        if groups is None:
            continue
        b_loc = LMP_BATCH // groups.size("data")
        s_loc = LMP_SEQ // groups.size("seq")
        di, si = groups.index("data"), groups.index("seq")
        tk = toks[di * b_loc:(di + 1) * b_loc, si * s_loc:(si + 1) * s_loc]
        tg = tgts[di * b_loc:(di + 1) * b_loc, si * s_loc:(si + 1) * s_loc]
        if kind == "sp":
            params = params0
            step = tfm.build_dp_sp_train_step(cfg, sp, groups=groups)
        else:
            params = tfm.tp_shard(tfm.to_tp_layout(params0, cfg), cfg,
                                  groups.index("model"), groups.size("model"))
            step = tfm.build_dp_tp_train_step(
                cfg, sp, groups, seq_axis="seq" if "seq" in axes else None)
        per = groups.index("seq") + 1 if "seq" in axes else 1
        out[arm] = lm_arm(
            "lm_par", arm, rank, dev, step, params, tk, tg,
            lambda p: lmp_canonical(p, kind, groups, cfg), control,
            lmp_flash_want(per, cfg.n_layers, True, LMP_STEPS)
            if on_card else {})
        out[arm]["coords"] = {a: groups.index(a) for a in axes}
        del params, step
        if on_card:
            torch.cuda.empty_cache()
    return out


def lm_par_rank(rank: str, world: str, store: str, out_dir: str,
                device: str = "cuda", preset: str = LMT_PRESET) -> int:
    """One rank of ``[lm_par]``'s (a) and (b) job: a gloo group of
    ``world`` processes (sharing the card, or on the CPU for a
    rehearsal); writes its results to ``<out_dir>/rank<r>.json``."""
    import torch
    from poseidon_tpu_torch.runtime import cluster

    rank, world = int(rank), int(world)
    group = cluster.init_distributed(torch.device(device), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        card = card_line() if group.device.type == "cuda" else "cpu"
        res = {"backend": group.backend,
               "attention": lmp_attention(
                   card, rank, group.device,
                   LMP_ATT_SHAPE if preset == LMT_PRESET
                   else LMP_ATT_SHAPE_TINY),
               "steps": lmp_steps(card, rank, group.device, preset)}
    finally:
        group.close()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def lmp_launch(cmds, envs, timeout: float = LMP_TIMEOUT_S):
    """Start every command at once from the repo's root; (return codes,
    logs) once all have ended (any still running at the timeout is
    killed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(cmd, cwd=here, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(cmds, envs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def phase_lm_par(card: str, device=None, preset: str = LMT_PRESET,
                 cli_args=LMP_CLI_ARGS) -> dict:
    """LM sequence and tensor parallelism on the card (the header's
    ``[lm_par]``): (a) and (b) as one job of LMP_RANKS gloo ranks sharing
    the card, then (c) the two CLI pairs at once. ``device``, ``preset``
    and ``cli_args`` are for a CPU rehearsal only."""
    device = device or "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ, OMP_NUM_THREADS="4")
        codes, logs = lmp_launch(
            [[sys.executable, "-c",
              "import sys, chip_smoke as cs; "
              "sys.exit(cs.lm_par_rank(*sys.argv[1:]))", str(r),
              str(LMP_RANKS), os.path.join(work, "store"), work, device,
              preset] for r in range(LMP_RANKS)], [env] * LMP_RANKS)
        for r, log in enumerate(logs):
            for line in log.splitlines():
                print(f"[lm_par:rank{r}] {line}", flush=True)
        check(all(c == 0 for c in codes), f"[lm_par] ranks exited {codes}")
        ranks = []
        for r in range(LMP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        job_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks),
              "[lm_par] the ranks did not choose gloo")
        for r, res in enumerate(ranks[:2]):
            for key, rec in res["attention"].items():
                if key.startswith("ms "):
                    print(f"[lm_par] (a) rank {r} {key[3:]}: ring forward "
                          f"{rec['ring_fwd']:.3f} ms, backward "
                          f"{rec['ring_bwd']:.3f} ms (the seq group of 2 "
                          f"over gloo, K/V staged through the host); the "
                          f"one-device flash on the whole sequence "
                          f"{rec['one_device_fwd']:.4f} / "
                          f"{rec['one_device_bwd']:.4f} ms [{card}]",
                          flush=True)
                else:
                    errs = ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                                     if k.endswith(("kernels", "plain")))
                    print(f"[lm_par] (a) rank {r} {key}: launches forward "
                          f"{rec['launches_fwd']}, backward "
                          f"{rec['launches_bwd']}; max_abs against the "
                          f"gathered sequence: {errs}; the largest share "
                          f"of its tolerance an entry used "
                          f"{rec['tol_used']:.3f} [{card}]", flush=True)
        control = ranks[0]["steps"]["control"]
        print(f"[lm_par] (b) control (one device, {LMP_BATCH} x {LMP_SEQ}): "
              f"losses {control['losses']}, wall a step "
              f"{[round(w, 4) for w in control['wall_s']]} s, launches "
              f"{control['launches']} [{card}]", flush=True)
        arms = {}
        for arm in LMP_ARMS:
            per_rank = [r["steps"][arm] for r in ranks if arm in r["steps"]]
            head = per_rank[0]
            arms[arm] = {"ranks": per_rank,
                         "max_abs_step1": head.get("max_abs_step1"),
                         "max_abs_step3": head.get(
                             f"max_abs_step{LMP_STEPS}"),
                         "wall_s_a_step": max(max(r["wall_s"][1:])
                                              for r in per_rank),
                         "launches": sum_launches([r["launches"]
                                                   for r in per_rank])}
            for r in per_rank:
                sent = {k: int(v)
                        for k, v in r["exchanged_bytes_a_step"].items()}
                print(f"[lm_par] (b) {arm} rank {r['rank']} {r['coords']}: "
                      f"losses {r['losses']}, wall a step "
                      f"{[round(w, 3) for w in r['wall_s']]} s, launches "
                      f"{r['launches']}, bytes sent a step {sent}, peak "
                      f"{r['peak_bytes'] / 2**30:.3f} GiB [{card}]",
                      flush=True)
            print(f"[lm_par] (b) {arm}: after step 1 within rtol "
                  f"{LMP_TOL[0]:g} atol {LMP_TOL[1]:g} of the control (max_abs "
                  f"{head.get('max_abs_step1')!r}), loss within "
                  f"{LMP_LOSS_RTOL:g}; after step {LMP_STEPS} max_abs "
                  f"{head.get(f'max_abs_step{LMP_STEPS}')!r} [{card}]",
                  flush=True)

    # (c) the CLI: two sp ranks and two tp ranks at once, on the card
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        cmds, envs = [], []
        for mode in ("sp", "tp"):
            for r in range(2):
                envs.append(dict(os.environ, POSEIDON_PROC_ID=str(r),
                                 POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="4",
                                 POSEIDON_COORDINATOR="file://"
                                 + os.path.join(work, f"{mode}.store")))
                cmds.append([sys.executable, "-c", LMP_CLI_LAUNCH,
                             "--mode", mode, "--par_axis", "2", *cli_args]
                            + (["--device", "cpu"] if device == "cpu"
                               else []))
        codes, logs = lmp_launch(cmds, envs)
    cli = {}
    for i, mode in enumerate(("sp", "tp")):
        for r in range(2):
            for line in logs[2 * i + r].splitlines():
                print(f"[lm_par:{mode}:rank{r}] {line}", flush=True)
        check(codes[2 * i] == codes[2 * i + 1] == 0,
              f"[lm_par] train_lm --mode {mode} ranks exited "
              f"{codes[2 * i:2 * i + 2]}")
        lines = logs[2 * i].splitlines()
        steps = [ln.split() for ln in lines if ln.startswith("step ")]
        losses = [float(x[3]) for x in steps]
        shown = [x for x in steps if "tok/s" in x]
        launches = [json.loads(ln[len("[launches] "):])
                    for log in logs[2 * i:2 * i + 2]
                    for ln in log.splitlines()
                    if ln.startswith("[launches] ")]
        check(any(ln.startswith("mesh: data=1 x ") for ln in lines)
              and shown and len(launches) == 2,
              f"[lm_par] train_lm --mode {mode}: no mesh, display or launch "
              f"lines")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"[lm_par] train_lm --mode {mode} losses {losses}")
        cli[mode] = {"losses": losses,
                     "tok_s": [float(x[4].replace(",", "")) for x in shown],
                     "launches": launches}
        print(f"[lm_par] (c) train_lm --mode {mode} --par_axis 2, two ranks: "
              f"losses {losses}, tok/s {cli[mode]['tok_s']}, launches "
              f"{launches} [{card}]", flush=True)
    wall = time.perf_counter() - t0
    print(f"[lm_par] phase {wall:.1f} s ((a)+(b) job {job_s:.1f} s, (c) "
          f"{time.perf_counter() - t1:.1f} s) [{card}]", flush=True)
    launches = {arm: a["launches"] for arm, a in arms.items()}
    launches["control"] = control["launches"]
    launches.update({f"cli_{m}": sum_launches(c["launches"])
                     for m, c in cli.items()})
    return {"attention": [r["attention"] for r in ranks[:2]],
            "control": control, "arms": arms, "cli": cli,
            "launches": launches, "wall_s": wall}


def lpe_canonical(params, groups, tp: bool, cfg):
    """A pp (or pp x tp) rank's shards gathered into the canonical tree."""
    from poseidon_tpu_torch.models import transformer as tfm
    tree = tfm.from_pp_layout(tfm.pp_unshard(
        params, groups["stage"], groups["model"] if tp else None), cfg)
    return tfm.from_tp_layout(tree, cfg) if tp else tree


def lpe_digest(tree, layers) -> str:
    """The sha256 of ``layers``' leaves' bytes, in tree order."""
    import hashlib
    h = hashlib.sha256()
    for n in layers:
        for v in tree[n].values():
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def lpe_pp(card: str, rank: int, dev, preset: str) -> dict:
    """(a) on this rank: the control (rank 0 alone) and each arm of
    LPE_PP_ARMS, every rank of the job building every arm's groups."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.runtime import cluster

    on_card = dev.type == "cuda"
    cfg, sp, params0, toks, tgts = lm_train_setup(preset, LMP_BATCH,
                                                  LMP_SEQ, dev, LMP_LAYERS)
    out, control = {}, None
    if rank == 0:
        control, out["control"] = lm_control(
            "lm_pp_ep", dev, tfm.build_dp_sp_train_step(cfg, sp, dev),
            params0, toks,
            tgts, lmp_flash_want(1, cfg.n_layers, True, LMP_STEPS)
            if on_card else {}, "control")
    for arm, (axes, shape, tp) in LPE_PP_ARMS.items():
        n = int(np.prod(shape))
        groups = cluster.build_named_groups(axes, shape, rank, dev, "gloo",
                                            ranks=range(n))
        if groups is None:
            continue
        tree = tfm.to_tp_layout(params0, cfg) if tp else params0
        params = tfm.pp_shard(tfm.to_pp_layout(tree, cfg), cfg,
                              groups.index("stage"), groups.size("stage"),
                              groups.index("model"), groups.size("model"))
        step = tfm.build_dp_pp_train_step(cfg, sp, groups, LPE_MICRO)
        per_stage = cfg.n_layers // groups.size("stage")
        rec = lm_arm(
            "lm_pp_ep", arm, rank, dev, step, params, toks, tgts,
            lambda p: lpe_canonical(p, groups, tp, cfg), control,
            lmp_flash_want(LPE_MICRO, per_stage, True, LMP_STEPS)
            if on_card else {},
            digest_layers=[k for k in params if k != "blocks"])
        rec["coords"] = {a: groups.index(a) for a in axes}
        out[arm] = rec
        del params, step
        if on_card:
            torch.cuda.empty_cache()
    return out


def lpe_moe_control_step(mcfg, sp, n_src: int):
    """The one-device control of an ep step over ``n_src`` sources: each
    source's row block routed as its own source (all experts local, the
    block's capacity), its token-loss sum over the GLOBAL token count plus
    aux / n_src, the blocks' losses and gradients summed: the function
    the ep step computes, drops included."""
    import torch
    from poseidon_tpu_torch.models import moe
    from poseidon_tpu_torch.models import transformer as tfm
    from poseidon_tpu_torch.solvers.updates import make_update_fn

    def step(params, state, toks, tgts):
        b = toks.shape[0] // n_src

        def loss_fn(p):
            total = 0.0
            for src in range(n_src):
                rows = slice(src * b, (src + 1) * b)
                logits, aux = moe.moe_forward(p, mcfg, toks[rows])
                logp = torch.log_softmax(logits, dim=-1)
                picked = torch.gather(logp, -1, tgts[rows][..., None])
                total = (total - picked.sum() / float(toks.numel())
                         + aux / float(n_src))
            return total

        loss, grads = tfm._grads(params, loss_fn)
        update = make_update_fn(sp, tfm.transformer_mults(params))
        params, state = update(params, grads, state)
        return params, state, {"loss": loss}

    return step


def lpe_drops(params, mcfg, toks, group=None) -> list:
    """Each MoE layer's dropped tokens in one forward of ``toks`` (over the
    expert ``group`` when given), counted from the routing itself: the
    layer input's top-1 expert (the first of ties), then each expert's
    tokens past the capacity."""
    import torch
    from poseidon_tpu_torch.models import moe
    from poseidon_tpu_torch.models import transformer as tfm

    b_sz, s = toks.shape
    bcfg = mcfg.base
    cap = moe.resolved_capacity(mcfg, b_sz * s)
    drops = []
    with torch.no_grad():
        x = tfm.embed_tokens(params, toks)
        for i in range(bcfg.n_layers):
            blk = params[f"block{i}"]
            x = tfm.attention_sublayer(bcfg, x, blk)
            h = tfm._layer_norm(x, blk["ln2_g"], blk["ln2_b"]).reshape(
                b_sz * s, bcfg.d_model)
            top = torch.softmax((h @ blk["wg"].T).float(), -1).argmax(-1)
            load = torch.bincount(top, minlength=mcfg.n_experts)
            drops.append(int((load - cap).clamp(min=0).sum()))
            y, _ = moe.moe_ffn(h, blk["wg"], blk["w1e"], blk["w2e"], mcfg,
                               expert_group=group)
            x = x + y.reshape(x.shape).to(x.dtype)
    return drops


def lpe_ep(card: str, rank: int, dev, preset: str) -> dict:
    """(b) on this rank: the per-source control and the MoE decode (rank
    0), then ep2 over ranks 0..1, from one seeded MoE model at the dense
    control's width with LPE_EXPERTS experts a layer."""
    import dataclasses

    import numpy as np
    import torch
    from poseidon_tpu_torch.models import moe
    from poseidon_tpu_torch.models.generate import generate
    from poseidon_tpu_torch.runtime import cluster

    on_card = dev.type == "cuda"
    cfg, sp, _, toks, tgts = lm_train_setup(preset, LMP_BATCH, LMP_SEQ,
                                            "cpu", LMP_LAYERS)
    toks, tgts = toks.to(dev), tgts.to(dev)
    mcfg = moe.MoEConfig(base=cfg, n_experts=LPE_EXPERTS)
    n = int(np.prod(LPE_EP_SHAPE))
    # every rank of the job builds the mesh's groups (new_group's order)
    groups = cluster.build_named_groups(("data", "expert"), LPE_EP_SHAPE,
                                        rank, dev, "gloo", ranks=range(n))
    if groups is None:
        return {}
    params0 = moe.init_moe_params(mcfg, torch.Generator().manual_seed(0),
                                  dev)
    b = LMP_BATCH // n
    out, control = {}, None
    if rank == 0:
        out["n_params"] = sum(v.numel() for d in params0.values()
                              for v in d.values())
        out["control_drops"] = [lpe_drops(params0, mcfg,
                                          toks[s * b:(s + 1) * b])
                                for s in range(n)]
        control, out["control"] = lm_control(
            "lm_pp_ep", dev, lpe_moe_control_step(mcfg, sp, n), params0,
            toks, tgts,
            lmp_flash_want(n, cfg.n_layers, True, LMP_STEPS)
            if on_card else {}, "ep control")
        # the dropless cached decode against moe_forward's argmax
        prompt = toks[:1, :LPE_DECODE_PROMPT]
        sync(dev)
        zero_launches()
        with torch.inference_mode():
            got, logits = generate(params0, mcfg, prompt, LPE_DECODE_NEW)
        sync(dev)
        counts = read_launches()
        want = {"flash_fwd": cfg.n_layers} if on_card else {}
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"[lm_pp_ep] MoE decode launches {counts} != {want}")
        full = dataclasses.replace(
            mcfg, capacity=LPE_DECODE_PROMPT + LPE_DECODE_NEW)
        seq, worst = prompt, 0.0
        with torch.inference_mode():
            for t in range(LPE_DECODE_NEW):
                ref = moe.moe_forward(params0, full, seq)[0][:, -1]
                worst = max(worst, float((ref - logits[:, t]).abs().max()))
                check(torch.equal(ref.argmax(-1), got[:, t]),
                      f"[lm_pp_ep] MoE decode token {t}: "
                      f"{got[:, t].tolist()} vs moe_forward's argmax "
                      f"{ref.argmax(-1).tolist()}")
                seq = torch.cat([seq, got[:, t:t + 1]], dim=1)
        out["decode"] = {"tokens": got[0].tolist(), "launches": counts,
                         "max_abs_logits": worst}
    expert = groups["expert"]
    rows = slice(groups.batch_index * b, (groups.batch_index + 1) * b)
    params = moe.ep_shard(params0, mcfg, expert.rank, expert.world)
    del params0
    drops = lpe_drops(params, mcfg, toks[rows], expert)
    rec = lm_arm("lm_pp_ep", "ep2", rank, dev,
                 moe.build_dp_ep_train_step(mcfg, sp, groups),
                 params, toks[rows], tgts[rows],
                  lambda p: moe.ep_unshard(p, expert), control,
                  lmp_flash_want(1, cfg.n_layers, True, LMP_STEPS)
                  if on_card else {})
    rec.update(drops=drops, coords={"data": groups.index("data"),
                                    "expert": expert.rank})
    out["ep2"] = rec
    return out


def lm_pp_ep_rank(rank: str, world: str, store: str, out_dir: str,
                  device: str = "cuda", preset: str = LMT_PRESET) -> int:
    """One rank of ``[lm_pp_ep]``'s (a) and (b) job: a gloo group of
    ``world`` processes (sharing the card, or on the CPU for a
    rehearsal); writes its results to ``<out_dir>/rank<r>.json``."""
    import torch
    from poseidon_tpu_torch.runtime import cluster

    rank, world = int(rank), int(world)
    group = cluster.init_distributed(torch.device(device), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        card = card_line() if group.device.type == "cuda" else "cpu"
        res = {"backend": group.backend,
               "pp": lpe_pp(card, rank, group.device, preset)}
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
        res["ep"] = lpe_ep(card, rank, group.device, preset)
    finally:
        group.close()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def lpe_print_arm(arm: str, per_rank, card: str) -> None:
    for r in per_rank:
        sent = {k: int(v) for k, v in r["exchanged_bytes_a_step"].items()}
        print(f"[lm_pp_ep] {arm} rank {r['rank']} {r['coords']}: losses "
              f"{r['losses']}, wall a step "
              f"{[round(w, 3) for w in r['wall_s']]} s, launches "
              f"{r['launches']}, bytes sent a step {sent}, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB [{card}]", flush=True)
    head = per_rank[0]
    print(f"[lm_pp_ep] {arm}: after step 1 within rtol {LMP_TOL[0]:g} atol "
          f"{LMP_TOL[1]:g} of the control (max_abs "
          f"{head.get('max_abs_step1')!r}), loss within "
          f"{LMP_LOSS_RTOL:g}; after step {LMP_STEPS} max_abs "
          f"{head.get(f'max_abs_step{LMP_STEPS}')!r} [{card}]", flush=True)


def lpe_arm_summary(per_rank) -> dict:
    head = per_rank[0]
    return {"ranks": per_rank,
            "max_abs_step1": head.get("max_abs_step1"),
            f"max_abs_step{LMP_STEPS}": head.get(f"max_abs_step{LMP_STEPS}"),
            "wall_s_a_step": max(max(r["wall_s"][1:]) for r in per_rank),
            "launches": sum_launches([r["launches"] for r in per_rank])}


def phase_lm_pp_ep(card: str, device=None, preset: str = LMT_PRESET,
                   cli_args=LMP_CLI_ARGS) -> dict:
    """LM pipeline and expert parallelism on the card (the header's
    ``[lm_pp_ep]``): (a) and (b) as one job of LPE_RANKS gloo ranks
    sharing the card, then (c) the two CLI pairs at once. ``device``,
    ``preset`` and ``cli_args`` are for a CPU rehearsal only."""
    device = device or "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ, OMP_NUM_THREADS="4")
        codes, logs = lmp_launch(
            [[sys.executable, "-c",
              "import sys, chip_smoke as cs; "
              "sys.exit(cs.lm_pp_ep_rank(*sys.argv[1:]))", str(r),
              str(LPE_RANKS), os.path.join(work, "store"), work, device,
              preset] for r in range(LPE_RANKS)], [env] * LPE_RANKS,
            timeout=LPE_TIMEOUT_S)
        for r, log in enumerate(logs):
            for line in log.splitlines():
                print(f"[lm_pp_ep:rank{r}] {line}", flush=True)
        check(all(c == 0 for c in codes), f"[lm_pp_ep] ranks exited {codes}")
        ranks = []
        for r in range(LPE_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    job_s = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" for r in ranks),
          "[lm_pp_ep] the ranks did not choose gloo")
    arms, launches = {}, {}
    for kind, control_key in (("pp", "control"), ("ep", "control")):
        control = ranks[0][kind][control_key]
        launches[f"{kind}_control"] = control["launches"]
        print(f"[lm_pp_ep] ({'a' if kind == 'pp' else 'b'}) {kind} control "
              f"(one device, {LMP_BATCH} x {LMP_SEQ}"
              + ("" if kind == "pp" else
                 f", {LPE_EXPERTS} experts, "
                 f"{ranks[0]['ep']['n_params']:,} params, each rank's rows "
                 f"its own source") + f"): losses {control['losses']}, wall "
              f"a step {[round(w, 4) for w in control['wall_s']]} s, "
              f"launches {control['launches']} [{card}]", flush=True)
    for arm in list(LPE_PP_ARMS) + ["ep2"]:
        kind = "ep" if arm == "ep2" else "pp"
        per_rank = [r[kind][arm] for r in ranks if arm in r[kind]]
        lpe_print_arm(arm, per_rank, card)
        arms[arm] = lpe_arm_summary(per_rank)
        launches[arm] = arms[arm]["launches"]
    # the stage ranks' non-block leaves bitwise alike (and the tp ranks')
    for arm in LPE_PP_ARMS:
        digests = {r["rank"]: r["digest"][:16] for r in arms[arm]["ranks"]}
        by_tp = {}
        for r in arms[arm]["ranks"]:
            by_tp.setdefault(r["coords"].get("model", 0), set()).add(
                r["digest"])
        check(all(len(d) == 1 for d in by_tp.values()),
              f"[lm_pp_ep] {arm}: the stage ranks' non-block leaves differ "
              f"after step {LMP_STEPS} (sha256 by rank {digests})")
        print(f"[lm_pp_ep] {arm}: the stage ranks' non-block leaves (embed, "
              f"pos, ln_f, head) bitwise alike after step {LMP_STEPS}; "
              f"every rank's alike: {len(set(digests.values())) == 1} "
              f"[{card}]", flush=True)
    control_drops = ranks[0]["ep"]["control_drops"]
    for rec in arms["ep2"]["ranks"]:
        src = rec["coords"]["data"] * LPE_EP_SHAPE[1] + rec["coords"][
            "expert"]
        check(rec["drops"] == control_drops[src],
              f"[lm_pp_ep] ep2 rank {rec['rank']} drops {rec['drops']} vs "
              f"the control's {control_drops[src]}")
    print(f"[lm_pp_ep] (b) tokens dropped a layer at step 1, source by "
          f"source (capacity factor 1.25): ep2 "
          f"{[r['drops'] for r in arms['ep2']['ranks']]}, control "
          f"{control_drops} [{card}]", flush=True)
    decode = ranks[0]["ep"]["decode"]
    launches["ep_decode"] = decode["launches"]
    print(f"[lm_pp_ep] (b) MoE decode (dropless, prompt "
          f"{LPE_DECODE_PROMPT}, {LPE_DECODE_NEW} new): tokens "
          f"{decode['tokens']} equal to moe_forward's argmax, logits max_abs "
          f"{decode['max_abs_logits']:.3e}, launches {decode['launches']} "
          f"[{card}]", flush=True)

    # (c) the CLI: two pp ranks and two ep ranks at once
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        cmds, envs = [], []
        for mode, flags in LPE_CLI_MODES.items():
            for r in range(2):
                envs.append(dict(os.environ, POSEIDON_PROC_ID=str(r),
                                 POSEIDON_NUM_PROCS="2", OMP_NUM_THREADS="4",
                                 POSEIDON_COORDINATOR="file://"
                                 + os.path.join(work, f"{mode}.store")))
                cmds.append([sys.executable, "-c", LMP_CLI_LAUNCH,
                             "--mode", mode, *flags, *cli_args]
                            + (["--device", "cpu"] if device == "cpu"
                               else []))
        codes, logs = lmp_launch(cmds, envs, timeout=LPE_TIMEOUT_S)
    cli = {}
    for i, mode in enumerate(LPE_CLI_MODES):
        for r in range(2):
            for line in logs[2 * i + r].splitlines():
                print(f"[lm_pp_ep:{mode}:rank{r}] {line}", flush=True)
        check(codes[2 * i] == codes[2 * i + 1] == 0,
              f"[lm_pp_ep] train_lm --mode {mode} ranks exited "
              f"{codes[2 * i:2 * i + 2]}")
        lines = logs[2 * i].splitlines()
        steps = [ln.split() for ln in lines if ln.startswith("step ")]
        losses = [float(x[3]) for x in steps]
        shown = [x for x in steps if "tok/s" in x]
        counts = [json.loads(ln[len("[launches] "):])
                  for log in logs[2 * i:2 * i + 2]
                  for ln in log.splitlines()
                  if ln.startswith("[launches] ")]
        check(any(ln.startswith("mesh: data=1 x ") for ln in lines)
              and shown and len(counts) == 2,
              f"[lm_pp_ep] train_lm --mode {mode}: no mesh, display or "
              f"launch lines")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"[lm_pp_ep] train_lm --mode {mode} losses {losses}")
        n_steps = int(cli_args[cli_args.index("--steps") + 1])
        n_layers = int(cli_args[cli_args.index("--n_layers") + 1])
        per = ((LPE_MICRO, n_layers // 2) if mode == "pp"
               else (1, n_layers))
        want = (lmp_flash_want(*per, True, n_steps) if device != "cpu"
                else {})
        check(all(c[k] == want.get(k, 0) for c in counts for k in c),
              f"[lm_pp_ep] train_lm --mode {mode} launches {counts} != "
              f"{want} a rank")
        cli[mode] = {"losses": losses,
                     "tok_s": [float(x[4].replace(",", "")) for x in shown],
                     "launches": counts}
        print(f"[lm_pp_ep] (c) train_lm --mode {mode} "
              f"{' '.join(LPE_CLI_MODES[mode])}, two ranks: losses "
              f"{losses}, tok/s {cli[mode]['tok_s']}, launches {counts} "
              f"[{card}]", flush=True)
    wall = time.perf_counter() - t0
    print(f"[lm_pp_ep] phase {wall:.1f} s ((a)+(b) job {job_s:.1f} s, (c) "
          f"{time.perf_counter() - t1:.1f} s) [{card}]", flush=True)
    launches.update({f"cli_{m}": sum_launches(c["launches"])
                     for m, c in cli.items()})
    return {"controls": {k: ranks[0][k]["control"] for k in ("pp", "ep")},
            "arms": arms, "drops": {"control": control_drops,
                                    "ep2": [r["drops"] for r in
                                            arms["ep2"]["ranks"]]},
            "decode": decode, "cli": cli, "launches": launches,
            "wall_s": wall}


def zoo_googlenet(card: str, device=None, batch: int = ZOO_BATCH,
                  keep=None) -> dict:
    """[zoo] (a): GoogLeNet trained at full width (``device`` and ``batch``
    are for a CPU rehearsal at a cut batch only); ``keep`` (a dict) gets
    the net, its step, batch and state for ``dispatch_googlenet``."""
    import types

    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.models import zoo
    from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import SolverParameter

    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    if on_card:
        # the step's own peak: weights, state and activations above what
        # earlier phases still hold once their garbage is collected
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
    net = Net(zoo.googlenet(), "TRAIN", device=dev,
              source_shapes=zoo.googlenet_shapes(batch), conv_layout="auto")
    if on_card:
        check(net.conv_layout == "NHWC",
              f"GoogLeNet planned {net.conv_layout} on the card, not the "
              f"NHWC an unflagged train plans")
    step = build_train_step(net, SolverParameter(**ZOO_SOLVER))
    params = net.init(torch.Generator().manual_seed(ZOO_SEED))
    params, state = step.load(params, init_train_state(params))
    gen = torch.Generator().manual_seed(ZOO_SEED)
    img = torch.randint(0, 256, (batch, 3, 224, 224), generator=gen,
                        dtype=torch.uint8)
    mean = torch.tensor(LOOP_MEAN_VALUES).view(1, 3, 1, 1)
    data = {"data": (img.float() - mean).to(dev),
            "label": torch.randint(0, 1000, (batch,), generator=gen)
            .float().to(dev)}
    pools = [l for l in net.layers if l.TYPE == "POOLING"]
    print(f"[zoo] GoogLeNet (aux heads, 1000 classes) on {dev}: "
          f"{net.param_count()} params, batch {tuple(data['data'].shape)}, "
          f"{net.conv_layout}, {sum(l.method == 'MAX' for l in pools)} MAX "
          f"and {sum(l.method == 'AVE' for l in pools)} AVE pools, arena "
          f"{step.arena.total} f32 (owners only)", flush=True)
    net.manual_seed(ZOO_SEED)
    losses = []
    for _ in range(ZOO_WARMUP):
        params, state, m = step.step(params, state, data)
        losses.append(float(m["loss"]))
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    zero_launches()
    t0 = time.perf_counter()
    if on_card:
        start.record()
    timed = []
    for _ in range(ZOO_TIMED_STEPS):
        params, state, m = step.step(params, state, data)
        timed.append(m["loss"])
    if on_card:
        end.record()
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / ZOO_TIMED_STEPS
    step_ms = (start.elapsed_time(end) / ZOO_TIMED_STEPS if on_card
               else wall_ms)
    counts = read_launches()
    losses += [float(v) for v in timed]
    check(all(math.isfinite(v) for v in losses),
          f"GoogLeNet loss not finite: {losses}")
    want = {k: 0 for k in counts}
    want.update({k: v * ZOO_TIMED_STEPS for k, v in ZOO_LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    rate = batch / (step_ms / 1e3)
    print(f"[zoo] GoogLeNet {ZOO_TIMED_STEPS} f32 steps after "
          f"{ZOO_WARMUP} warm-up: {step_ms:.3f} ms a step by CUDA events "
          f"({wall_ms:.3f} ms host wall), {rate:.1f} img/s, peak device "
          f"memory {peak} B above the phase's start, losses {losses}; "
          f"launches {counts} (expected "
          f"{want}) [{card}]", flush=True)
    if on_card:
        check(counts == want, f"GoogLeNet launch counts {counts} != {want}")
    shim = types.SimpleNamespace(params=params, state=state, train_net=net,
                                 train_step=step,
                                 iteration=lambda: int(state.solver.it))
    worst = phase_step_vs_plain(shim, data, tag="zoo")
    # where the step's time goes: one profiled step's kernels by kind
    prof = (phase_train_profile(shim, data, card, tag="zoo",
                                kernel_names=CNN_NHWC_KERNEL_NAMES)
            if on_card else {})
    if keep is not None:
        keep.update(net=net, step=step, data=data, state=shim.state,
                    history=shim.state.solver.history,
                    it=int(shim.state.solver.it))
    return {"step_ms": step_ms, "wall_ms": wall_ms, "img_s": rate,
            "peak_bytes": peak, "losses": losses, "launches": counts,
            "per_step": ZOO_LAUNCHES, "params": net.param_count(),
            "layout": net.conv_layout, "batch": batch,
            "step_vs_plain_max_abs": worst, "profile": prof}


def zoo_inception_pools(card: str) -> list:
    """[zoo]: K6-NHWC alone at the inception modules' 3x3 s1 p1 MAX pools,
    batch 32, f32, channels-last: bitwise to its plain version, its CUDA-
    event and profiled device times beside the library's backward and the
    bytes bound (records only)."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.ops import pool

    gen = torch.Generator(device="cuda").manual_seed(ZOO_SEED)
    cl = torch.channels_last
    geom = ((3, 3), (1, 1), (1, 1))
    records = []
    for label, shape in ZOO_POOLS:
        x = torch.randn(shape, generator=gen, device="cuda").contiguous(
            memory_format=cl)
        y = pool.pool_forward(x, *geom, "max")
        g = torch.randn(y.shape, generator=gen, device="cuda").contiguous(
            memory_format=cl)
        dx = pool.pool_bwd_nhwc_cuda(x, g, *geom, "max")
        torch.cuda.synchronize()
        want = pool.pool_bwd_plain(x, g, *geom, "max")
        bitwise = torch.equal(dx, want)
        _, idx = F.max_pool2d(x, 3, 1, 1, ceil_mode=True,
                              return_indices=True)
        library = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731,E501
            g, x, [3, 3], [1, 1], [1, 1], [1, 1], True, idx)
        rec = compare_case(
            "pool_bwd_nhwc", label, dx, want, "float32",
            lambda: pool.pool_bwd_nhwc_cuda(x, g, *geom, "max"),
            lambda: pool.pool_bwd_plain(x, g, *geom, "max"), library,
            (2 * x.numel() + g.numel()) * x.element_size(),
            g.numel() * 9 * 2, card,
            extra=f" max 3x3 s1 p1 {tuple(shape)} channels-last "
                  f"bitwise={bitwise}")
        dev = {"kernel": profiled_device_ms(
                   lambda: pool.pool_bwd_nhwc_cuda(x, g, *geom, "max"),
                   key="pool_nhwc_band_kernel"),
               "library": profiled_device_ms(library)}
        print(f"[zoo] K6-NHWC {label} {tuple(shape)}: device time a call "
              f"(torch.profiler, mean of 10): kernel {dev['kernel']:.4f} "
              f"ms, library {dev['library']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms [{card}]", flush=True)
        rec.update(shape=list(shape), method="max", bitwise=bitwise,
                   device_ms=dev)
        records.append(rec)
        check(bitwise, f"pool_bwd_nhwc {label}: not bitwise equal to the "
                       f"plain version")
        del x, y, g, dx, want, idx, library
    torch.cuda.empty_cache()
    return records


def catalog_inputs(seed: int = 0) -> dict:
    """The catalog net's inputs (its prototxt's header says what each is)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return {"data": rs.rand(4, 3, 12, 12).astype(np.float32),
            "label": rs.randint(0, 5, (4, 1, 1, 1)).astype(np.float32),
            "target": rs.rand(4, 5, 1, 1).astype(np.float32),
            "sim": rs.randint(0, 2, (4, 1, 1, 1)).astype(np.float32),
            "H": rs.rand(1, 1, 5, 5).astype(np.float32)}


def zoo_catalog(card: str, device=None) -> dict:
    """[zoo] (b): the catalog net, one forward and backward on the card
    against the same net and params on the CPU, at NET_TOL: the loss,
    the tops, every owner gradient and the float inputs' gradients."""
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.proto.messages import load_net

    dev = torch.device(device or "cuda")
    inputs = catalog_inputs(ZOO_SEED)
    diff = ("data", "target", "H")
    init = Net(load_net(ZOO_CATALOG), "TRAIN", device="cpu").init(
        torch.Generator().manual_seed(ZOO_SEED))

    def run(d):
        net = Net(load_net(ZOO_CATALOG), "TRAIN", device=d,
                  conv_layout="auto")
        params = {l: {k: v.to(d).clone().requires_grad_(True)
                      for k, v in lv.items()} for l, lv in init.items()}
        feeds = {k: torch.from_numpy(v).to(d).requires_grad_(k in diff)
                 for k, v in inputs.items()}
        out = net.apply(params, feeds, keep_blobs=True)
        out.loss.backward()
        sync(torch.device(d))
        got = {"loss": out.loss.detach().reshape(1)}
        got.update({f"top {k}": out.blobs[k].detach().float()
                    for k in ("logits", "prob", "top2", "sp", "mv", "f2")})
        got.update({f"d{l}/{k}": v.grad for l, lv in params.items()
                    for k, v in lv.items()})
        got.update({f"d{k}": feeds[k].grad for k in diff})
        return net, {k: v.cpu() for k, v in got.items()}

    zero_launches()
    net, card_out = run(dev)
    counts = read_launches()
    _, cpu_out = run("cpu")
    rtol, atol = NET_TOL
    errs = {}
    for k, want in cpu_out.items():
        got = card_out[k]
        errs[k] = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
              f"catalog net {k}: card vs CPU max_abs {errs[k]}")
    types_ = sorted({l.TYPE for l in net.layers})
    loss_card, loss_cpu = float(card_out["loss"]), float(cpu_out["loss"])
    print(f"[zoo] catalog net ({len(types_)} layer types {types_}, "
          f"STOCHASTIC pooling, conv_a/conv_b sharing one weight) on "
          f"{dev} {net.conv_layout} vs the CPU: loss {loss_card!r} vs "
          f"{loss_cpu!r}, every top and gradient within rtol {rtol:g} atol "
          f"{atol:g} (max_abs {max(errs.values()):.3e}); launches {counts} "
          f"[{card}]", flush=True)
    return {"max_abs": errs, "launches": counts, "types": types_,
            "layout": net.conv_layout}


def zoo_siamese(card: str, device=None) -> dict:
    """[zoo] (b): the siamese example net (named params) trained
    ZOO_SIAMESE_STEPS steps on the card against the CPU from the same
    params and batches, at NET_TOL; each sharer's blobs are its owner's
    leaves, one tensor in the arena; the K6 and K7 launches exact."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.parallel.trainer import (build_train_step,
                                                     init_train_state)
    from poseidon_tpu_torch.proto.messages import load_net, load_solver

    dev = torch.device(device or "cuda")
    n = ZOO_SIAMESE_BATCH
    shapes = {"pair_data": (n, 2, 28, 28), "sim": (n,)}
    sp = load_solver("examples/siamese/mnist_siamese_solver.prototxt")
    rs = np.random.RandomState(ZOO_SEED)
    batches = [{"pair_data": rs.rand(*shapes["pair_data"]).astype(
                    np.float32),
                "sim": rs.randint(0, 2, size=(n,)).astype(np.float32)}
               for _ in range(ZOO_SIAMESE_STEPS)]
    init = None
    runs = {}
    for d in (dev, torch.device("cpu")):
        net = Net(load_net(ZOO_SIAMESE), "TRAIN", device=d,
                  source_shapes=shapes, conv_layout="auto")
        if init is None:
            init = net.init(torch.Generator().manual_seed(ZOO_SEED))
        params = {l: {k: v.to(d).clone() for k, v in lv.items()}
                  for l, lv in init.items()}
        step = build_train_step(net, sp)
        params, state = step.load(params, init_train_state(params))
        leaves = step._leaf_tree
        lo = step.flat_w.data_ptr()
        hi = lo + step.flat_w.numel() * step.flat_w.element_size()
        for sharer, owner in (("conv1_p", "conv1"), ("ip1_p", "ip1"),
                              ("feat_p", "feat")):
            got = net._layer_params(leaves, net._layer_by_name[sharer])
            for k in ("w", "b"):
                check(got[k] is leaves[owner][k]
                      and lo <= got[k].data_ptr() < hi,
                      f"siamese {sharer}/{k} is not {owner}'s arena leaf")
        zero_launches()
        losses = []
        for b in batches:
            params, state, m = step.step(
                params, state, {k: torch.from_numpy(v).to(d)
                                for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs[d.type] = {"losses": losses, "launches": read_launches(),
                        "params": {l: {k: v.detach().cpu().clone()
                                       for k, v in lv.items()}
                                   for l, lv in params.items()},
                        "layout": net.conv_layout,
                        "owners": list(net.param_defs)}
        del net, step, params, state, leaves
    card_run, cpu_run = runs[dev.type], runs["cpu"]
    rtol, atol = NET_TOL
    check(np.allclose(card_run["losses"], cpu_run["losses"], rtol=rtol,
                      atol=atol),
          f"siamese losses card {card_run['losses']} vs CPU "
          f"{cpu_run['losses']}")
    worst = 0.0
    for l, lv in cpu_run["params"].items():
        for k, want in lv.items():
            got = card_run["params"][l][k]
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
                  f"siamese {l}/{k} after {ZOO_SIAMESE_STEPS} steps: card vs "
                  f"CPU max_abs {err}")
    counts = card_run["launches"]
    if dev.type == "cuda":
        k6 = "pool_bwd_nhwc" if card_run["layout"] == "NHWC" else "pool_bwd"
        want = {k: 0 for k in counts}
        want.update({k6: 2 * ZOO_SIAMESE_STEPS,
                     "sgd_update": ZOO_SIAMESE_STEPS})
        check(counts == want, f"siamese launch counts {counts} != {want}")
    print(f"[zoo] siamese net (owners {card_run['owners']}, sharers one "
          f"tensor with their owners in the arena) {ZOO_SIAMESE_STEPS} SGD "
          f"steps at batch {n} on {dev} {card_run['layout']} vs the CPU: "
          f"losses {card_run['losses']} vs {cpu_run['losses']}, every param "
          f"within rtol {rtol:g} atol {atol:g} (max_abs {worst:.3e}); "
          f"launches {counts} [{card}]", flush=True)
    return {"losses": card_run["losses"], "cpu_losses": cpu_run["losses"],
            "max_abs": worst, "launches": counts,
            "layout": card_run["layout"]}


def phase_zoo(card: str, device=None, batch: int = ZOO_BATCH,
              keep=None) -> dict:
    """[zoo]: GoogLeNet from the model zoo trained at full width, K6-NHWC
    at its inception pools, the catalog net and the siamese net against
    the CPU (``device`` and ``batch`` for a CPU rehearsal only; ``keep``
    as ``zoo_googlenet``'s)."""
    import torch
    t0 = time.perf_counter()
    googlenet = zoo_googlenet(card, device, batch, keep)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    pools = zoo_inception_pools(card) if device is None else []
    catalog = zoo_catalog(card, device)
    siamese = zoo_siamese(card, device)
    wall = time.perf_counter() - t0
    print(f"[zoo] phase wall {wall:.1f} s (budget 60 s) [{card}]",
          flush=True)
    if device is None:
        check(wall <= 60.0, f"[zoo] took {wall:.1f} s, over its 60 s")
    return {"googlenet": googlenet, "inception_pools": pools,
            "catalog": catalog, "siamese": siamese,
            "launches": {"zoo_googlenet": googlenet["launches"],
                         "zoo_catalog": catalog["launches"],
                         "zoo_siamese": siamese["launches"]},
            "wall_s": wall}


def tools_env() -> dict:
    """[tools] (d): whether PIL, cv2 and h5py import here (IMAGE_DATA,
    WINDOW_DATA and HDF5_DATA need them; no phase does)."""
    import importlib
    out = {}
    for mod in ("PIL", "cv2", "h5py"):
        try:
            m = importlib.import_module(mod)
            out[mod] = getattr(m, "__version__", "yes")
        except Exception as e:  # noqa: BLE001 — absent or broken: say so
            out[mod] = f"no ({type(e).__name__})"
    print(f"[env] PIL {out['PIL']}, cv2 {out['cv2']}, h5py {out['h5py']}",
          flush=True)
    return out


class dropout_bank:
    """Within the block, each DROPOUT layer of ``nets`` keeps the rows of
    one fixed mask bank (per layer name, ``rows`` rows from ``seed``) in
    the order its forwards consume them, so a step over K micro-batches
    and a step over their concatenation drop the same units.
    ``reset`` rewinds every layer to row 0."""

    def __init__(self, nets, rows: int, seed: int):
        self.nets, self.rows, self.seed = nets, rows, seed

    def __enter__(self):
        import torch
        gen = torch.Generator().manual_seed(self.seed)
        self.masks, self.layers = {}, []
        for net in self.nets:
            for layer in net.layers:
                if layer.TYPE != "DROPOUT":
                    continue
                self.layers.append(layer)
                if layer.name not in self.masks:
                    shape = (self.rows,) + tuple(
                        net.blob_shapes[layer.lp.bottom[0]][1:])
                    keep = 1.0 - layer.lp.dropout_param.dropout_ratio
                    self.masks[layer.name] = (
                        (torch.rand(shape, generator=gen) < keep)
                        .to(net.device), keep)
                layer.forward = self._forward(layer.name)
        self.reset()
        return self

    def _forward(self, name: str):
        import torch

        def forward(params, bottoms, train):
            x = bottoms[0]
            mask, keep = self.masks[name]
            lo = self.cursor[name]
            self.cursor[name] = lo + x.shape[0]
            return [torch.where(mask[lo:lo + x.shape[0]], x / keep,
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))]
        return forward

    def reset(self) -> None:
        self.cursor = {name: 0 for name in self.masks}

    def __exit__(self, *exc):
        for layer in self.layers:
            del layer.forward
        return False


def tools_step(step, params0, hist0, it0, batch):
    """One step of ``step`` from the given params, momentum and iteration
    on ``batch``; (loss, params, momentum) as clones."""
    from poseidon_tpu_torch.parallel.trainer import TrainState
    from poseidon_tpu_torch.solvers.updates import SolverState
    params, state = step.load(params0, TrainState(SolverState(it0, hist0),
                                                  {}))
    params, state, m = step.step(params, state, batch)
    return (float(m["loss"]), tree_clone(params),
            tree_clone(state.solver.history))


def tools_step_ms(step, params0, hist0, batch, dev):
    """(device ms a step by CUDA events over TOOLS_TIMED_STEPS after one
    warm-up, peak bytes allocated above the start); on the CPU the host
    clock and no peak."""
    import torch
    from poseidon_tpu_torch.parallel.trainer import TrainState
    from poseidon_tpu_torch.solvers.updates import SolverState
    on_card = dev.type == "cuda"
    params, state = step.load(params0, TrainState(SolverState(0, hist0), {}))
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    params, state, _m = step.step(params, state, batch)
    sync(dev)
    t0 = time.perf_counter()
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(TOOLS_TIMED_STEPS):
        params, state, _m = step.step(params, state, batch)
    if on_card:
        end.record()
    sync(dev)
    if not on_card:
        return (time.perf_counter() - t0) * 1e3 / TOOLS_TIMED_STEPS, None
    return (start.elapsed_time(end) / TOOLS_TIMED_STEPS,
            torch.cuda.max_memory_allocated() - base)


def tools_iter_size(card: str, root: str, dev, micro: int) -> dict:
    """[tools] (a): AlexNet at batch ``micro`` x iter_size through
    Engine.train(), then against the big batch and the plain versions."""
    import dataclasses

    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.parallel.trainer import build_train_step
    from poseidon_tpu_torch.runtime import checkpoint
    from poseidon_tpu_torch.runtime.engine import Engine

    k = TOOLS_ITER_SIZE
    on_card = dev.type == "cuda"
    work = os.path.join(root, "tools")
    sp = loop_solver(root, TOOLS_ITERS, batch_size=micro)
    sp.iter_size, sp.display = k, 2
    eng = Engine(sp, output_dir=work, device=dev)
    try:
        check(eng.iter_size == k and eng.train_step.iter_size == k,
              f"the engine runs iter_size {eng.iter_size}, not {k}")
        if on_card:
            check(eng.train_net.conv_layout == "NHWC",
                  f"AlexNet planned {eng.train_net.conv_layout} on the "
                  f"card, not the NHWC an unflagged train plans")
        zero_launches()
        t0 = time.perf_counter()
        eng.train()
        sync(dev)
        wall = time.perf_counter() - t0
        counts = read_launches()
        want = {name: 0 for name in counts}
        if on_card:
            want.update({name: v * TOOLS_ITERS
                         for name, v in TOOLS_LAUNCHES.items()})
        print(f"[tools] (a) Engine.train(): AlexNet "
              f"{eng.train_net.conv_layout} batch {micro} x iter_size {k}, "
              f"{TOOLS_ITERS} steps in "
              f"{wall:.2f} s; launches {counts} (expected {want}) [{card}]",
              flush=True)
        check(counts == want, f"iter_size launches {counts} != {want}")
        check(eng.iteration() == TOOLS_ITERS, "iteration count")
        with open(os.path.join(work, "stats.yaml")) as f:
            stats = f.read()
        for key in (f"  train_iters: {TOOLS_ITERS}", f"  iteration: "
                    f"{TOOLS_ITERS}", "  lr:", "  train_loss:", "comm:"):
            check(key in stats, f"stats.yaml lacks {key!r}")

        # fixed micro-batches, and the big batch of the same rows
        micro_batches = eng._next_train_batch()
        big = {t: torch.cat([mb[t] for mb in micro_batches])
               for t in micro_batches[0]}
        net_big = Net(eng._train_param, "TRAIN", device=dev,
                      source_shapes={t: tuple(v.shape)
                                     for t, v in big.items()})
        step_big = build_train_step(net_big,
                                    dataclasses.replace(sp, iter_size=1))
        p0, h0 = tree_clone(eng.params), tree_clone(eng.state.solver.history)
        it0 = eng.iteration()
        with dropout_bank([eng.train_net, net_big], k * micro,
                          TOOLS_SEED) as bank:
            loss_k, pk, hk = tools_step(eng.train_step, p0, h0, it0,
                                        micro_batches)
            bank.reset()
            loss_b, pb, hb = tools_step(step_big, p0, h0, it0, big)
        rtol, atol = TOOLS_TOL
        gaps = {"params": tree_max_abs(pk, pb),
                "momentum": tree_max_abs(hk, hb),
                "loss": abs(loss_k - loss_b)}
        close = all(bool(torch.allclose(a[l][n], b[l][n], rtol=rtol,
                                        atol=atol))
                    for a, b in ((pk, pb), (hk, hb)) for l in a for n in a[l])
        print(f"[tools] (a) one step at {micro} x iter_size {k} vs one at "
              f"{k * micro} on the same rows and dropout masks: loss "
              f"{loss_k!r} vs {loss_b!r}, max_abs params "
              f"{gaps['params']:.3e}, momentum {gaps['momentum']:.3e} (rtol "
              f"{rtol:g}, atol {atol:g}) [{card}]", flush=True)
        check(close and gaps["loss"] <= atol + rtol * abs(loss_b),
              f"iter_size {k} vs the big batch: {gaps}")
        del pk, hk, pb, hb
        plain_max_abs = phase_step_vs_plain(eng, micro_batches, tag="tools")
        times = {"iter_size": [], "big": []}
        peaks = {}
        for arm in ("iter_size", "big", "big", "iter_size"):
            step, batch = ((eng.train_step, micro_batches)
                           if arm == "iter_size" else (step_big, big))
            ms, peak = tools_step_ms(step, p0, h0, batch, dev)
            times[arm].append(ms)
            peaks[arm] = peak
        print(f"[tools] (a) device step by CUDA events ({TOOLS_TIMED_STEPS} "
              f"steps after a warm-up, in turns): {micro} x iter_size {k} "
              f"{times['iter_size']} ms, {k * micro} x 1 {times['big']} ms; "
              f"peak memory above the start {peaks['iter_size']} B vs "
              f"{peaks['big']} B [{card}]", flush=True)
        model, _ = checkpoint.snapshot(os.path.join(work, "alexnet"),
                                       eng.train_net, eng.params, eng.state)
        return {"launches": counts, "per_step": TOOLS_LAUNCHES,
                "micro": micro, "iter_size": k, "wall_s": wall,
                "gap_vs_big_batch": gaps, "tol": list(TOOLS_TOL),
                "plain_max_abs": plain_max_abs, "step_ms": times,
                "peak_bytes": peaks, "layout": eng.train_net.conv_layout,
                "weights": model}
    finally:
        eng.close()


def tools_child(args, dev, here: str) -> tuple:
    """A `python -m poseidon_tpu_torch <args>` child reporting its
    launches (LAUNCH_REPORT): (output lines, launches)."""
    cmd = [sys.executable, "-c", LAUNCH_REPORT, *args]
    if dev.type == "cpu":
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def tools_wait(proc, tag: str) -> tuple:
    try:
        text = proc.communicate(timeout=TOOLS_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = text.splitlines()
    check(proc.returncode == 0, f"[tools] {tag} exited {proc.returncode}:\n"
          + "\n".join(lines[-30:]))
    return lines, fleet_launches(lines, tag)


def tools_datasets(card: str, root: str) -> dict:
    """[tools] (c): compute_image_mean, partition_data (2 shards) and
    convert_db through the CLI on the synthetic LMDB; the mean against a
    numpy mean of the records."""
    import numpy as np
    from poseidon_tpu_torch.data.leveldb_reader import LevelDBWriter
    from poseidon_tpu_torch.data.lmdb_reader import LMDBReader
    from poseidon_tpu_torch.proto.wire import decode_datum, read_blob_file
    from poseidon_tpu_torch.runtime.cli import main as cli_main

    def records(path):
        r = LMDBReader(path)
        try:
            return [(r.key_at(i), r.value_at(i)) for i in range(len(r))]
        finally:
            r.close()

    t0 = time.perf_counter()
    train_db, val_db, _ = synthetic_ilsvrc_paths(root)
    work = os.path.join(root, "tools")
    mean_file = os.path.join(work, "mean.binaryproto")
    check(cli_main(["compute_image_mean", train_db, mean_file]) == 0,
          "compute_image_mean")
    recs = records(train_db)
    total = wide = None
    for _, v in recs:
        arr = decode_datum(v).to_array()
        total = arr if total is None else total + arr
        wide = (arr.astype(np.float64) if wide is None
                else wide + arr)
    want = (total / len(recs)).astype(np.float32)
    mean = read_blob_file(mean_file)[0]
    check(mean.shape == want.shape and np.array_equal(mean, want),
          "compute_image_mean differs from the numpy f32 mean")
    f64_gap = float(np.abs(mean - wide / len(recs)).max())
    check(cli_main(["partition_data", train_db, "2"]) == 0, "partition_data")
    shards = [records(f"{train_db}_{k}") for k in range(2)]
    check([len(x) for x in shards] == [len(recs) // 2,
                                       len(recs) - len(recs) // 2]
          and shards[0] + shards[1] == recs, "partition_data's shards")
    val = records(val_db)
    out = os.path.join(work, "val_copy")
    check(cli_main(["convert_db", val_db, out]) == 0, "convert_db")
    check(records(out) == val, "convert_db LMDB -> LMDB records")
    ldb = os.path.join(work, "val_leveldb")
    w = LevelDBWriter(ldb)
    for key, value in val[:TOOLS_LEVELDB_RECORDS]:
        w.put(key, value)
    w.close()
    out2 = os.path.join(work, "val_from_leveldb")
    check(cli_main(["convert_db", ldb, out2]) == 0, "convert_db LevelDB")
    check(records(out2) == val[:TOOLS_LEVELDB_RECORDS],
          "convert_db LevelDB -> LMDB records")
    wall = time.perf_counter() - t0
    print(f"[tools] (c) compute_image_mean over {len(recs)} records equal to "
          f"the numpy f32 mean bitwise (max_abs {f64_gap:.3e} to the f64 "
          f"mean), partition_data 2 shards of {[len(x) for x in shards]}, "
          f"convert_db {len(val)} LMDB and {TOOLS_LEVELDB_RECORDS} LevelDB "
          f"records, all by the CLI in {wall:.2f} s (host work) [{card}]",
          flush=True)
    return {"records": len(recs), "mean_f64_max_abs": f64_gap,
            "shards": [len(x) for x in shards], "convert_db": len(val),
            "convert_db_leveldb": TOOLS_LEVELDB_RECORDS, "wall_s": wall}


def tools_extract_check(card: str, net_file: str, weights: str,
                        prefix: str, dev) -> dict:
    """[tools] (c): extract_features' fc7 rows against this process's Net
    forward of the same first TEST batch and weights, at NET_TOL."""
    import numpy as np
    import torch
    from poseidon_tpu_torch.core.net import Net
    from poseidon_tpu_torch.data.lmdb_reader import LMDBReader
    from poseidon_tpu_torch.data.pipeline import (build_phase_pipelines,
                                                  place_batch)
    from poseidon_tpu_torch.proto.messages import load_net
    from poseidon_tpu_torch.proto.wire import decode_datum
    from poseidon_tpu_torch.runtime.checkpoint import load_caffemodel

    net_param = load_net(net_file)
    pipes, shapes = build_phase_pipelines(net_param, "TEST")
    try:
        host = {}
        for p in pipes:
            host.update(next(p))
    finally:
        for p in pipes:
            p.close()
    net = Net(net_param, "TEST", device=dev, source_shapes=shapes)
    params = load_caffemodel(weights, net,
                             net.init(torch.Generator().manual_seed(0)))
    with torch.no_grad():
        want = net.apply(params, place_batch(host, dev), train=False,
                         keep_blobs=True).blobs["fc7"].float().cpu().numpy()
    r = LMDBReader(f"{prefix}_fc7")
    try:
        got = np.stack([np.asarray(decode_datum(r.value_at(i)).float_data,
                                   np.float32) for i in range(len(r))])
    finally:
        r.close()
    rtol, atol = NET_TOL
    err = float(np.abs(got - want).max()) if got.shape == want.shape else None
    print(f"[tools] (c) extract_features fc7 {got.shape} vs the Net's "
          f"forward {want.shape} on {dev}: max_abs {err} (rtol {rtol:g}, "
          f"atol {atol:g}) [{card}]", flush=True)
    check(got.shape == want.shape and np.allclose(got, want, rtol=rtol,
                                                  atol=atol),
          f"extract_features fc7 differs from the forward: max_abs {err}")
    return {"rows": int(got.shape[0]), "max_abs_err": err}


def phase_tools(card: str, root: str, device=None, micro: int = TOOLS_MICRO,
                train_step_ms=None) -> dict:
    """[tools]: iter_size against the big batch, the `time` and
    `extract_features` commands, the dataset tools (``device`` and
    ``micro`` are for a CPU rehearsal at a cut batch only)."""
    import torch
    from poseidon_tpu_torch.numeric import policy_scope
    from poseidon_tpu_torch.proto.messages import net_to_prototxt

    t0 = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    here = os.path.dirname(os.path.abspath(__file__))
    out = {"env": tools_env()}
    with policy_scope(conv_layout="AUTO"):
        out["iter_size"] = tools_iter_size(card, root, dev, micro)
        if on_card:
            torch.cuda.empty_cache()
        # the smoke's train_val over the synthetic LMDB, both data layers
        # at the big batch (alexnet_train_val's 256 on the card)
        batch = TOOLS_ITER_SIZE * micro
        net_file = os.path.join(root, "tools", "train_val.prototxt")
        with open(net_file, "w") as f:
            f.write(net_to_prototxt(alexnet_net_param(root, batch)))
        proc = tools_child(["time", "--model", net_file, "--iterations",
                            str(TOOLS_TIME_ITERS)], dev, here)
        out["datasets"] = tools_datasets(card, root)
        lines, time_counts = tools_wait(proc, "time")
        ms = {}
        for line in lines:
            for key, name in (("Average Forward pass:", "forward_ms"),
                              ("Average Forward-Backward:",
                               "forward_backward_ms")):
                if line.startswith(key):
                    ms[name] = float(line[len(key):].split()[0])
        check(len(ms) == 2, "time printed no forward/backward times")
        n = TOOLS_TIME_ITERS + 1
        want = {k: 0 for k in time_counts}
        if on_card:
            want.update(lrn_fwd_nhwc=4 * n, lrn_bwd_nhwc=2 * n,
                        pool_bwd_nhwc=3 * n)
        print(f"[tools] (b) `time` ({batch} x 3 x 227 x 227, "
              f"{TOOLS_TIME_ITERS} calls after a warm-up, CUDA events): "
              f"forward {ms['forward_ms']} ms, forward+backward "
              f"{ms['forward_backward_ms']} ms, beside [train]'s device "
              f"step {train_step_ms} ms (NCHW, with the update) and "
              f"(a)'s big-batch step {out['iter_size']['step_ms']['big']} "
              f"ms (NHWC); launches {time_counts} (expected {want}) "
              f"[{card}]", flush=True)
        check(time_counts == want, f"time launches {time_counts} != {want}")
        out["time"] = {**ms, "launches": time_counts,
                       "iterations": TOOLS_TIME_ITERS}
        prefix = os.path.join(root, "tools", "feat")
        proc = tools_child(["extract_features", "--model", net_file,
                            "--weights", out["iter_size"]["weights"],
                            "--blobs", "fc7", "--num_batches", "1",
                            "--out_prefix", prefix], dev, here)
        _lines, extract_counts = tools_wait(proc, "extract_features")
        want = {k: 0 for k in extract_counts}
        if on_card:
            want.update(lrn_fwd_nhwc=2)
        print(f"[tools] (c) `extract_features --blobs fc7 --num_batches 1`: "
              f"launches {extract_counts} (expected {want}) [{card}]",
              flush=True)
        check(extract_counts == want,
              f"extract_features launches {extract_counts} != {want}")
        out["extract"] = {"launches": extract_counts,
                          **tools_extract_check(card, net_file,
                                                out["iter_size"]["weights"],
                                                prefix, dev)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"[tools] phase wall {out['wall_s']:.1f} s (budget "
          f"{TOOLS_BUDGET_S:g} s) [{card}]", flush=True)
    return out


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms within the block (benchmarking
    off), the settings found put back after it."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def stack_rows(batches) -> dict:
    """Batches stacked to [K, ...] (the K-step dispatch's input)."""
    import torch
    return {t: torch.stack([b[t] for b in batches]) for t in batches[0]}


def dispatch_arm(step, net, p0, h0, it0: int, batches, seed: int,
                 reuse=None) -> tuple:
    """The steps of ``batches`` from (p0, h0, it0), the dropout stream
    reseeded to ``seed``: single steps for a one-step ``step``, K-step
    dispatches else (of ``reuse``, one batch, under reuse_batch);
    -> (losses, params, momentum), clones."""
    from poseidon_tpu_torch.parallel.trainer import TrainState
    from poseidon_tpu_torch.solvers.updates import SolverState
    net.manual_seed(seed)
    params, state = step.load(p0, TrainState(SolverState(it0, h0), {}))
    k = step.steps_per_dispatch
    losses = []
    for i in range(0, len(batches), k):
        if k == 1:
            params, state, m = step.step(params, state, batches[i])
            losses.append(float(m["loss"]))
        else:
            params, state, m = step.multi_step(
                params, state, reuse if reuse is not None
                else stack_rows(batches[i:i + k]))
            losses += m["loss"].tolist()
    return losses, tree_clone(params), tree_clone(state.solver.history)


def events_ms(fn) -> float:
    """The wall of ``fn()`` on the card by CUDA events, ms."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def busy_share(fn) -> dict:
    """The card's busy share over one call of ``fn``: the time some device
    op (a kernel or a copy, on any stream: the union of their intervals)
    ran, by torch.profiler, over the wall of the same call by CUDA events
    (a warm-up call is traced first and dropped: the profiler misses the
    first kernels it sees). Tracing lengthens the host's part, so the
    share is a floor; None when the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    kept, walls = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.extend(p.events())) as prof:
        for _ in range(2):
            walls.append(events_ms(fn))
            prof.step()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kept
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("ProfilerStep"))
    busy_us, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    busy = busy_us / 1e3
    return {"busy_ms": busy, "wall_ms": walls[-1], "device_ops": len(spans),
            "share": busy / walls[-1] if busy else None}


def dispatch_timing(card: str, tag: str, n_steps: int, run: dict) -> dict:
    """ms a step of each arm of ``run`` ({arm: fn running n_steps steps})
    by CUDA events in DISPATCH_TURNS, then each arm's busy share."""
    ms = {arm: [] for arm in run}
    for arm in DISPATCH_TURNS:
        ms[arm].append(events_ms(run[arm]) / n_steps)
    share = {arm: busy_share(run[arm]) for arm in run}
    for arm in run:
        sh = share[arm]
        print(f"[dispatch] {tag} {arm}: {ms[arm]} ms a step by CUDA events "
              f"({n_steps} steps a turn, in turns {list(DISPATCH_TURNS)}); "
              f"busy share "
              + ("not measured (the profiler saw no device work)"
                 if sh["share"] is None else
                 f"{sh['share']:.3f} ({sh['busy_ms']:.3f} ms of "
                 f"{sh['device_ops']} device ops in {sh['wall_ms']:.3f} ms)")
              + f" [{card}]", flush=True)
    return {"ms": ms, "busy": share}


def dispatch_expected(per_step: dict, counts: dict, k: int) -> dict:
    """What the wrappers count over a K-step capture's warm-up and capture
    (2K steps' worth), every other counter 0."""
    want = {name: 0 for name in counts}
    want.update({name: 2 * k * v for name, v in per_step.items()})
    return want


def dispatch_alexnet(card: str, root: str, dev, batch_size) -> dict:
    """[dispatch] (a)-(c) on AlexNet; returns the live engine too (for
    [remat])."""
    import torch
    from poseidon_tpu_torch.parallel.trainer import build_train_step
    from poseidon_tpu_torch.runtime.engine import Engine
    from poseidon_tpu_torch.solvers.updates import learning_rates

    on_card = dev.type == "cuda"
    k = DISPATCH_K
    sp = loop_solver(root, DISPATCH_ITERS, batch_size)
    sp.display = DISPATCH_ITERS
    for key, v in DISPATCH_LR.items():
        setattr(sp, key, v)
    eng = Engine(sp, output_dir=os.path.join(root, "dispatch"), device=dev,
                 steps_per_dispatch=k)
    step = eng.train_step
    check(eng.steps_per_dispatch == k and step.steps_per_dispatch == k,
          f"the engine runs steps_per_dispatch {eng.steps_per_dispatch}")
    if on_card:
        check(eng.train_net.conv_layout == "NHWC",
              f"AlexNet planned {eng.train_net.conv_layout} on the card")
    zero_launches()
    t0 = time.perf_counter()
    eng.train()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_launches()
    per_replay = step.graph_launches
    replays = step.replays
    n_chunks = DISPATCH_ITERS // k
    want = {name: 0 for name in counts}
    if on_card:
        want = dispatch_expected(DISPATCH_LAUNCHES, counts, k)
        check(replays == n_chunks - 1,
              f"{replays} replays of the graph, not {n_chunks - 1}")
        check(per_replay == {n: k * v for n, v in DISPATCH_LAUNCHES.items()},
              f"a replay launches {per_replay}")
    ran = {n: counts[n] // 2 + replays * per_replay.get(n, 0)
           for n in DISPATCH_LAUNCHES}
    print(f"[dispatch] (a) Engine.train(): AlexNet "
          f"{eng.train_net.conv_layout} batch "
          f"{eng.train_net.blob_shapes['data'][0]}, {DISPATCH_ITERS} steps "
          f"at steps_per_dispatch {k} in {wall:.2f} s ({n_chunks} "
          f"dispatches: a warm-up and capture, {replays} replays); the "
          f"wrappers counted {counts} (expected {want}: the warm-up's and "
          f"the capture's launches); a replay launches {per_replay}, so "
          f"the kernels ran {ran} times [{card}]", flush=True)
    check(counts == want, f"dispatch launch counts {counts} != {want}")
    check(eng.iteration() == DISPATCH_ITERS, "iteration count")
    check(math.isfinite(eng.metrics.rows[-1]["loss"]), "non-finite loss")

    # (b) the graph against eager steps, bitwise
    batches = [eng._next_train_batch() for _ in range(2 * k)]
    net = eng.train_net
    eager = build_train_step(net, sp)
    graph = build_train_step(net, sp, steps_per_dispatch=k)
    p0, h0 = tree_clone(eng.params), tree_clone(eng.state.solver.history)
    it0 = eng.iteration()
    le, pe, he = dispatch_arm(eager, net, p0, h0, it0, batches, DISPATCH_SEED)
    lg, pg, hg = dispatch_arm(graph, net, p0, h0, it0, batches, DISPATCH_SEED)
    rates = learning_rates(sp, it0, 2 * k).tolist()
    check(graph.replays == (1 if on_card else 0),
          f"the graph arm replayed {graph.replays} times")
    same = le == lg and tree_equal(pe, pg) and tree_equal(he, hg)
    print(f"[dispatch] (b) {2 * k} steps as {2} K={k} dispatches (a "
          f"warm-up and capture, then a replay) vs {2 * k} eager steps, "
          f"rates {[round(r, 9) for r in rates]}"
          f": losses {lg} vs {le}; bitwise {same} (params max_abs "
          f"{tree_max_abs(pg, pe):.3e}, momentum {tree_max_abs(hg, he):.3e})"
          f" [{card}]", flush=True)
    check(same, "the K-step graph is not bitwise to eager steps")
    del pe, he, pg, hg
    if eng._device_feed is not None:
        # no more batches: the prefetcher's copies would share the card
        # with the timed steps
        eng._device_feed.close()
        eng._device_feed = None

    # (c) ms a step and busy share, in turns
    timing = None
    if on_card:
        fixed = batches[:k]
        stacked = stack_rows(fixed)
        state = {}

        def start(arm, st):
            state[arm] = st.load(p0, eng.state._replace(
                solver=eng.state.solver._replace(history=h0)))

        start("eager", eager)
        start("graph", graph)

        def run_eager():
            p, s = state["eager"]
            for b in fixed:
                p, s, _m = eager.step(p, s, b)
            state["eager"] = (p, s)

        def run_graph():
            p, s = state["graph"]
            p, s, _m = graph.multi_step(p, s, stacked)
            state["graph"] = (p, s)

        timing = dispatch_timing(card, "(c) AlexNet", k,
                                 {"eager": run_eager, "graph": run_graph})
    return {"engine": eng, "launches": counts, "per_replay": per_replay,
            "replays": replays, "ran": ran, "wall_s": wall,
            "bitwise": same, "losses": lg, "timing": timing}


def remat_alexnet(card: str, root: str, dev, batch_size, disp) -> dict:
    """[remat] on AlexNet, beside [dispatch]'s live engine (its no-remat
    net gives the peak the budget is cut from)."""
    import torch
    from poseidon_tpu_torch.core import remat as R
    from poseidon_tpu_torch.parallel.trainer import build_train_step
    from poseidon_tpu_torch.runtime.engine import Engine

    on_card = dev.type == "cuda"
    k = DISPATCH_K
    base_eng = disp["engine"]
    probe = base_eng._probe_batch()
    peak = R.measured_peak_bytes(base_eng.train_net, base_eng.params, probe)
    budget_gb = (REMAT_BUDGET_SHARE * peak / 2**30 if on_card else 1e-9)
    sp = loop_solver(root, REMAT_ITERS, batch_size)
    sp.display = REMAT_ITERS
    for key, v in DISPATCH_LR.items():
        setattr(sp, key, v)
    eng = Engine(sp, output_dir=os.path.join(root, "remat"), device=dev,
                 steps_per_dispatch=k, remat="auto", hbm_budget_gb=budget_gb)
    try:
        plan = eng.remat_plan
        check(plan is not None and plan.active,
              f"no remat plan at a budget of {budget_gb:.3f} GiB")
        print(f"[remat] no-remat step peak {peak} B on the card (one "
              f"forward and backward, measured_peak_bytes), budget "
              f"{REMAT_BUDGET_SHARE} of it ({budget_gb:.4f} GiB): "
              f"{plan.describe()}, layers {list(plan.layers)}, the "
              f"engine's measured peak {plan.measured_peak_bytes} B "
              f"(source {plan.source}) [{card}]", flush=True)
        zero_launches()
        eng.train()
        sync(dev)
        counts = read_launches()
        check(eng.iteration() == REMAT_ITERS, "iteration count")
        check(math.isfinite(eng.metrics.rows[-1]["loss"]), "non-finite loss")
        if on_card:
            check(all(counts[n] > 0 for n in DISPATCH_LAUNCHES),
                  f"[remat] Engine.train() launched {counts}")
        print(f"[remat] Engine.train(): {REMAT_ITERS} steps at "
              f"steps_per_dispatch {k} with the plan's checkpoints, "
              f"{eng.train_step.replays} replay(s); the wrappers counted "
              f"{counts} (recomputed forwards launch K4-NHWC and the pool "
              f"forward again); a replay launches "
              f"{eng.train_step.graph_launches} [{card}]", flush=True)
        net = eng.train_net
        batches = [eng._next_train_batch() for _ in range(k)]
        stored = build_train_step(net, sp)
        remat = build_train_step(net, sp, remat_plan=plan)
        p0, h0 = tree_clone(eng.params), tree_clone(eng.state.solver.history)
        it0 = eng.iteration()
        arms, ms, peaks = {}, {}, {}
        for arm in ("stored", "remat", "remat", "stored"):
            st = stored if arm == "stored" else remat
            if on_card:
                gc.collect()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            arms[arm] = dispatch_arm(st, net, p0, h0, it0, batches,
                                     DISPATCH_SEED)
            sync(dev)
            ms.setdefault(arm, []).append((time.perf_counter() - t) * 1e3 / k)
            if on_card:
                peaks.setdefault(arm, []).append(
                    torch.cuda.max_memory_allocated() - base)
        # the engine's own K-step graph with the plan: one replay
        arms["remat graph"] = dispatch_arm(eng.train_step, net, p0, h0, it0,
                                           batches, DISPATCH_SEED)
        (ls, ps, hs), (lr, pr, hr), (lg, pg, hg) = (
            arms["stored"], arms["remat"], arms["remat graph"])
        same = (ls == lr == lg and tree_equal(ps, pr) and tree_equal(hs, hr)
                and tree_equal(ps, pg) and tree_equal(hs, hg))
        print(f"[remat] {k} steps from one state, batches and dropout "
              f"stream: stored {ls}, remat {lr}, remat through the "
              f"engine's graph {lg}: bitwise {same}; a step's peak above "
              f"the start stored {peaks.get('stored')} B, remat "
              f"{peaks.get('remat')} B (planned saving {plan.saved_bytes} "
              f"B); ms a step (host wall around the synced arm) stored "
              f"{ms['stored']}, remat {ms['remat']} [{card}]", flush=True)
        check(same, "the remat arm is not bitwise to the stored arm")
        timing = None
        if on_card:
            timing = {}
            for arm, st in (("stored", stored), ("remat", remat)):
                fixed = batches[0]
                ps0 = st.load(p0, eng.state._replace(
                    solver=eng.state.solver._replace(history=h0)))
                holder = {"ps": ps0}

                def run(st=st, holder=holder, fixed=fixed):
                    p, s = holder["ps"]
                    for _ in range(k):
                        p, s, _m = st.step(p, s, fixed)
                    holder["ps"] = (p, s)
                timing[arm] = [events_ms(run) / k for _ in range(2)]
            print(f"[remat] ms a step by CUDA events ({k} steps, two "
                  f"rounds): stored {timing['stored']}, remat "
                  f"{timing['remat']} [{card}]", flush=True)
        return {"plan": plan.to_doc(), "no_remat_peak_bytes": peak,
                "budget_gb": budget_gb, "launches": counts,
                "per_replay": eng.train_step.graph_launches,
                "replays": eng.train_step.replays, "bitwise": same,
                "peak_bytes": peaks, "host_ms": ms, "step_ms": timing}
    finally:
        eng.close()


def phase_dispatch(card: str, root: str, device=None,
                   batch_size=None) -> dict:
    """[dispatch] (a)-(c) and [remat] on AlexNet (``device`` and
    ``batch_size`` are for a CPU rehearsal at a cut batch only)."""
    import torch
    from poseidon_tpu_torch.numeric import policy_scope
    t0 = time.perf_counter()
    dev = torch.device(device or "cuda")
    with policy_scope(conv_layout="AUTO"), cudnn_deterministic():
        disp = dispatch_alexnet(card, root, dev, batch_size)
        try:
            remat = remat_alexnet(card, root, dev, batch_size, disp)
        finally:
            disp.pop("engine").close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[dispatch] AlexNet and [remat] phase wall {wall:.1f} s "
          f"[{card}]", flush=True)
    return {"alexnet": disp, "remat": remat, "wall_s": wall}


def dispatch_googlenet(card: str, live: dict, device=None) -> dict:
    """[dispatch] on [zoo]'s GoogLeNet: a K-step graph under reuse_batch
    against eager steps, bitwise, its launches, then ms a step and busy
    share of each."""
    import torch
    from poseidon_tpu_torch.parallel.trainer import build_train_step
    from poseidon_tpu_torch.proto.messages import SolverParameter

    t0 = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    k = DISPATCH_K
    net, eager, data = live["net"], live["step"], live["data"]
    sp = SolverParameter(**ZOO_SOLVER)
    with cudnn_deterministic():
        graph = build_train_step(net, sp, steps_per_dispatch=k,
                                 reuse_batch=True)
        p0, h0 = tree_clone(eager.params()), tree_clone(live["history"])
        it0 = live["it"]
        zero_launches()
        lg, pg, hg = dispatch_arm(graph, net, p0, h0, it0, [data] * (2 * k),
                                  DISPATCH_SEED, reuse=data)
        sync(dev)
        counts = read_launches()
        want = {n: 0 for n in counts}
        if on_card:
            want = dispatch_expected(DISPATCH_ZOO_LAUNCHES, counts, k)
        le, pe, he = dispatch_arm(eager, net, p0, h0, it0, [data] * (2 * k),
                                  DISPATCH_SEED)
        same = le == lg and tree_equal(pe, pg) and tree_equal(he, hg)
        print(f"[dispatch] GoogLeNet {net.conv_layout} batch "
              f"{data['data'].shape[0]}: {2 * k} steps as 2 K={k} "
              f"dispatches under reuse_batch (a warm-up and capture, then "
              f"a replay) vs {2 * k} eager steps: losses {lg} vs {le}, "
              f"bitwise {same}; the wrappers counted {counts} (expected "
              f"{want}); a replay launches {graph.graph_launches} "
              f"[{card}]", flush=True)
        check(same, "GoogLeNet's K-step graph is not bitwise to eager "
                    "steps")
        check(counts == want, f"GoogLeNet dispatch launches {counts} != "
                              f"{want}")
        del pe, he, pg, hg
        timing = None
        if on_card:
            check(graph.replays == 1, f"{graph.replays} replays")
            state = {"eager": eager.load(p0, live["state"]._replace(
                solver=live["state"].solver._replace(history=h0))),
                     "graph": graph.load(p0, live["state"]._replace(
                         solver=live["state"].solver._replace(
                             history=h0)))}

            def run_eager():
                p, s = state["eager"]
                for _ in range(k):
                    p, s, _m = eager.step(p, s, data)
                state["eager"] = (p, s)

            def run_graph():
                p, s = state["graph"]
                p, s, _m = graph.multi_step(p, s, data)
                state["graph"] = (p, s)

            timing = dispatch_timing(card, "GoogLeNet", k,
                                     {"eager": run_eager,
                                      "graph": run_graph})
    wall = time.perf_counter() - t0
    print(f"[dispatch] GoogLeNet phase wall {wall:.1f} s [{card}]",
          flush=True)
    return {"launches": counts, "per_replay": graph.graph_launches,
            "bitwise": same, "losses": lg, "timing": timing, "wall_s": wall}


# [tune] and [profile] (the docstring's 6d): the im2col lowering against the
# direct conv at AlexNet's conv1, conv3 and conv4 (batch TUNE_CONV_BATCH,
# f32, each element within IM2COL_TOL of its sum's L1 bound); the tune
# search as a child `tune` (TUNE_ARGS, full space, AlexNet at 32 x 227²);
# its memo hit; a `train --tuned_plan auto` against the same run with the
# plan's knobs as flags (TUNE_TRAIN_ITERS steps, bitwise); `train --profile
# PROFILE_STEPS` at batch 256 with its per-layer attribution, each port
# kernel in its layer's row and the named coverage at least
# PROFILE_COVERAGE (JAX's ATTR_COVERAGE_TARGET). The two phases must take
# at most TUNE_PROFILE_BUDGET_S together.
TUNE_CONV_BATCH = 256
TUNE_CONVS = (("conv1", 3, 227, 96, 11, 4, 0, 1),
              ("conv3", 256, 13, 384, 3, 1, 1, 1),
              ("conv4", 384, 13, 384, 3, 1, 1, 2))
IM2COL_TOL = 1e-5
TUNE_ARGS = ("--model", "alexnet", "--windows", "2", "--iters", "2")
TUNE_TIMEOUT_S = 300
TUNE_MEMO_MAX_S = 10.0
TUNE_TRAIN_ITERS = 4
PROFILE_STEPS = 3
PROFILE_COVERAGE = 0.90
PROFILE_TRIES = 10
# a kernel symbol: (its counter, its launches a step, the rows it must
# land in)
PROFILE_ROWS = {
    "lrn_nhwc_fwd_kernel": ("lrn_fwd_nhwc", 2, "fwd", ("norm1", "norm2")),
    "lrn_nhwc_bwd_kernel": ("lrn_bwd_nhwc", 2, "bwd", ("norm1", "norm2")),
    "pool_nhwc_band_kernel": ("pool_bwd_nhwc", 3, "bwd",
                              ("pool1", "pool2", "pool5")),
    "sgd_update_kernel": ("sgd_update", 1, "misc", ("optimizer_update",))}
TUNE_PROFILE_BUDGET_S = 120.0


def tune_conv_pair(card: str, dev, batch: int) -> list:
    """[tune] (a): im2col against the direct conv on AlexNet's conv1, conv3
    and conv4 (grouped: im2col takes direct, bitwise) in both layouts, f32
    under the policy's flags (TF32 off), cuDNN deterministic: y, dx and
    dw, each element within IM2COL_TOL of the L1 bound of its sum (the
    same conv on |x|, |w|, |g|); a channels-last x keeps a channels-last
    y; CUDA-event ms of forward and forward+backward of each lowering."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.numeric import apply_policy, memory_format
    from poseidon_tpu_torch.ops import nn as NN

    apply_policy()
    rows = []
    gen = torch.Generator().manual_seed(TOOLS_SEED)
    for name, c, hw, o, k, s, p, g in TUNE_CONVS:
        x0 = torch.randn((batch, c, hw, hw), generator=gen).to(dev)
        w = (torch.randn((o, c // g, k, k), generator=gen) * 0.05).to(dev)
        b = (torch.randn((o,), generator=gen) * 0.05).to(dev)
        oh = (hw + 2 * p - k) // s + 1
        gy = torch.randn((batch, o, oh, oh), generator=gen).to(dev)
        for layout in ("NCHW", "NHWC"):
            x = (x0.contiguous(memory_format=torch.channels_last)
                 if layout == "NHWC" else x0).detach().requires_grad_(True)
            wl = w.detach().requires_grad_(True)
            got = {}
            for strat in ("im2col", "direct"):
                y = NN.conv2d(x, wl, b, (s, s), (p, p), g, strategy=strat)
                dx, dw = torch.autograd.grad(y, (x, wl), gy)
                got[strat] = (y.detach(), dx, dw)
                check(memory_format(y) == memory_format(x),
                      f"[tune] {name} {layout} {strat}: the output left "
                      f"x's memory format")
            ax = x0.abs().detach().requires_grad_(True)
            aw = w.abs().detach().requires_grad_(True)
            ay = F.conv2d(ax, aw, None, s, p, groups=g)
            bdx, bdw = torch.autograd.grad(ay, (ax, aw), gy.abs())
            bounds = (ay.detach() + b.abs().view(1, -1, 1, 1), bdx, bdw)
            worst = 0.0
            for part, a, e, bound in zip(("y", "dx", "dw"), got["im2col"],
                                         got["direct"], bounds):
                ratio = float(((a - e).abs() / bound.clamp_min(1e-30))
                              .max())
                worst = max(worst, ratio)
                check(ratio <= IM2COL_TOL,
                      f"[tune] {name} {layout}: im2col {part} off direct "
                      f"by {ratio:.3g} of its L1 bound (> {IM2COL_TOL})")
            bitwise = all(torch.equal(a, e) for a, e in
                          zip(got["im2col"], got["direct"]))
            if g > 1:
                check(bitwise, f"[tune] {name}: grouped im2col must take "
                               f"the direct conv")
            del got, ax, aw, ay, bdx, bdw, bounds
            ms = {}
            if dev.type == "cuda":
                for strat in ("im2col", "direct"):
                    def fwd(strat=strat):
                        with torch.no_grad():
                            NN.conv2d(x, wl, b, (s, s), (p, p), g,
                                      strategy=strat)

                    def fwd_bwd(strat=strat):
                        y = NN.conv2d(x, wl, b, (s, s), (p, p), g,
                                      strategy=strat)
                        torch.autograd.grad(y, (x, wl), gy)

                    ms[strat] = (cuda_time_ms(fwd, 2, 5),
                                 cuda_time_ms(fwd_bwd, 2, 5))
            row = {"conv": name, "layout": layout, "group": g,
                   "max_l1_share": worst, "bitwise": bitwise,
                   "ms": {k_: {"fwd": v[0], "fwd_bwd": v[1]}
                          for k_, v in ms.items()}}
            rows.append(row)
            times = ", ".join(
                f"{k_} fwd {v[0]:.4f} ms, fwd+bwd {v[1]:.4f} ms"
                for k_, v in ms.items())
            print(f"[tune] (a) {name} x{batch} {layout}"
                  + (" (grouped: im2col takes direct)" if g > 1 else "")
                  + f": im2col vs direct y/dx/dw within {worst:.3g} of "
                  f"their L1 bounds (tol {IM2COL_TOL:g}), bitwise="
                  f"{bitwise}; {times or 'no timing on the CPU'}"
                  + (f"; im2col/direct fwd+bwd "
                     f"{ms['im2col'][1] / ms['direct'][1]:.3f}x"
                     if ms else "") + f" [{card}]", flush=True)
        del x0, w, b, gy
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def stats_section(path: str, name: str) -> dict:
    """One top-level section of a stats.yaml (``StatsRegistry``'s
    rendering: two-space indents, scalar values) as nested dicts of
    strings."""
    out: dict = {}
    stack = [(-1, out)]
    inside = False
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            depth = (len(line) - len(line.lstrip(" "))) // 2
            key, _, val = line.strip().partition(":")
            if depth == 0:
                inside = key == name
                continue
            if not inside:
                continue
            while stack[-1][0] >= depth:
                stack.pop()
            if val.strip():
                stack[-1][1][key] = val.strip()
            else:
                child: dict = {}
                stack[-1][1][key] = child
                stack.append((depth, child))
    return out


def tune_solver(root: str, work: str, iters: int, batch=None,
                display=None) -> str:
    """A solver file over [train]'s net at full width (``batch`` for a
    CPU rehearsal only) on the synthetic LMDB: ``iters`` steps, no test,
    a snapshot after training; -> its path."""
    from poseidon_tpu_torch.proto.messages import (load_solver,
                                                   net_to_prototxt,
                                                   solver_to_prototxt)
    os.makedirs(work, exist_ok=True)
    net_file = os.path.join(work, "train_val.prototxt")
    with open(net_file, "w") as f:
        f.write(net_to_prototxt(alexnet_net_param(root, batch)))
    sp = load_solver(ALEXNET_SOLVER)
    sp.net, sp.max_iter, sp.display = net_file, iters, display or iters
    sp.test_iter, sp.test_interval, sp.snapshot = [], 0, 0
    sp.snapshot_after_train = True
    sp.snapshot_prefix = os.path.join(work, "alexnet")
    solver = os.path.join(work, "solver.prototxt")
    with open(solver, "w") as f:
        f.write(solver_to_prototxt(sp))
    return solver


def cli_captured(argv) -> tuple:
    """``runtime/cli.main(argv)`` in this process, its stdout echoed and
    kept: (rc, lines)."""
    import io
    from poseidon_tpu_torch.runtime.cli import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return rc, text.splitlines()


def plan_flags(knobs: dict) -> list:
    """A plan's training knobs as the explicit ``train`` flags that mean
    the same (the managed tier's wire dtype has no counterpart off the
    async tier, and never enters a compiled step)."""
    flags = ["--conv_layout", str(knobs["conv_layout"]).lower(),
             "--arena_bucket_mb", str(knobs["arena_bucket_mb"]),
             "--device_prefetch", str(knobs["device_prefetch"]),
             "--max_in_flight", str(knobs["max_in_flight"]),
             "--steps_per_dispatch", str(knobs["steps_per_dispatch"])]
    if knobs["conv_strategy"]:
        flags += ["--conv_strategy", knobs["conv_strategy"]]
    if knobs["mesh"]:
        flags += ["--mesh", knobs["mesh"]]
    if knobs["remat"]:
        flags += ["--remat", knobs["remat"]]
    if float(knobs["hbm_budget_gb"]):
        flags += ["--hbm_budget_gb", str(knobs["hbm_budget_gb"])]
    return flags


def phase_tune(card: str, root: str, device=None, batch=None,
               tune_args=TUNE_ARGS) -> dict:
    """[tune] (a)-(d) (``device``, ``batch`` and ``tune_args`` are for a
    CPU rehearsal at a cut size only)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    dev = torch.device(device or "cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "tune")
    store = os.path.join(work, "store")
    os.makedirs(work, exist_ok=True)
    out: dict = {}
    with cudnn_deterministic():
        out["conv"] = tune_conv_pair(card, dev, batch or TUNE_CONV_BATCH)
    # (b) the search, as a user runs it
    plan_file = os.path.join(work, "plan.json")
    args = ["tune", *tune_args, "--compile_cache_dir", store,
            "--out", plan_file]
    t1 = time.perf_counter()
    proc = tools_child(args, dev, here)
    try:
        text = proc.communicate(timeout=TUNE_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = text.splitlines()
    check(proc.returncode == 0, f"[tune] tune exited {proc.returncode}:\n"
          + "\n".join(lines[-40:]))
    out["search_wall_s"] = time.perf_counter() - t1
    for ln in lines:
        if ln.startswith("[tune] "):
            print(f"[tune] (b) child: {ln}", flush=True)
    line = json.loads(next(ln for ln in reversed(lines)
                           if ln.startswith('{"metric": "tune"')))
    print(f"[tune] (b) {json.dumps(line)}", flush=True)
    check(line["source"] == "measured", "[tune] the first tune measured "
          "nothing")
    with open(plan_file) as f:
        doc = json.load(f)
    out["launches"] = fleet_launches(lines, "[tune]")
    for knob, trial in sorted(doc["trials"].items()):
        if knob == "conv_strategy":
            for layer, row in trial["per_layer"].items():
                print(f"[tune] (b) conv_strategy {layer}: -> "
                      f"{row['winner']} [{row['source']}] "
                      f"{json.dumps(row['timings_ms'])}", flush=True)
            continue
        print(f"[tune] (b) trial {knob}: -> {trial['winner']} "
              f"[{trial['source']}] {json.dumps(trial.get('timings_ms'))}"
              + (f" arms {json.dumps(trial.get('arms'))}"
                 if "arms" in trial else ""), flush=True)
    ab = doc["ab"]
    print(f"[tune] (b) composite A/B {json.dumps(ab)}; search_cost_s "
          f"{doc['search_cost_s']}; child wall {out['search_wall_s']:.1f} s; "
          f"launches {json.dumps(out['launches'])} [{card}]", flush=True)
    if ab.get("reverted"):
        check(ab["speedup"] == 1.0, "[tune] a reverted plan reports 1.0")
    else:
        check(ab["speedup"] >= 1.0, f"[tune] the plan ships a composite "
              f"arm slower than the defaults: {ab}")
    check(doc["device_kind"] == (torch.cuda.get_device_name(0)
                                 if dev.type == "cuda" else "cpu"),
          "[tune] the plan names another device")
    if dev.type == "cuda":
        # each arm's peak above the allocation at its start: a budget to
        # plan against
        check(doc["trials"]["remat_batch"].get("budget_bytes", 0) > 0,
              f"[tune] no measured peak: {doc['trials']['remat_batch']}")
        # the step arms ran the TPU kernels' counterparts: NCHW K4-K7, the
        # NHWC entries, K7's device-rate entry in the K=4 graph arm
        for k in ("lrn_fwd", "lrn_bwd", "pool_bwd", "sgd_update",
                  "lrn_fwd_nhwc", "lrn_bwd_nhwc", "pool_bwd_nhwc",
                  "sgd_update_devrate"):
            check(out["launches"].get(k, 0) > 0,
                  f"[tune] the search launched no {k}: {out['launches']}")
    out["doc"] = {k: doc[k] for k in ("knobs", "ab", "search_cost_s",
                                      "skipped", "device_kind",
                                      "torch_version", "cuda_version")}
    out["trials"] = doc["trials"]
    # (c) the memo hit
    t1 = time.perf_counter()
    rc, lines2 = cli_captured(args[:-2] + (["--device", "cpu"]
                                           if dev.type == "cpu" else []))
    memo_s = time.perf_counter() - t1
    again = json.loads(lines2[-1])
    print(f"[tune] (c) second tune: source {again['source']} in "
          f"{memo_s:.2f} s [{card}]", flush=True)
    check(rc == 0 and again["source"] == "persisted"
          and again["path"] == line["path"],
          f"[tune] the second tune did not load the plan: {again}")
    check(memo_s <= TUNE_MEMO_MAX_S, f"[tune] the memo hit took "
          f"{memo_s:.1f} s")
    out["memo_s"] = memo_s
    # (d) the plan against the same knobs as flags
    knobs = doc["knobs"]
    states = {}
    extra = ["--device", "cpu"] if dev.type == "cpu" else []
    with cudnn_deterministic():
        for arm, flags in (("plan", ["--compile_cache_dir", store]),
                           ("flags", ["--tuned_plan", "off",
                                      "--compile_cache_dir", store]
                            + plan_flags(knobs))):
            arm_dir = os.path.join(work, arm)
            solver = tune_solver(root, arm_dir, TUNE_TRAIN_ITERS, batch)
            rc, lines3 = cli_captured(["train", f"--solver={solver}",
                                       "--output_dir", arm_dir, *flags,
                                       *extra])
            check(rc == 0, f"[tune] (d) train ({arm}) exited {rc}")
            desc = [ln for ln in lines3 if ln.startswith("[tuned_plan] ")]
            print(f"[tune] (d) {arm}: {desc[-1] if desc else '-'}",
                  flush=True)
            snap = os.path.join(arm_dir, f"alexnet_iter_{TUNE_TRAIN_ITERS}"
                                ".solverstate.npz")
            with np.load(snap) as z:
                states[arm] = {k: z[k].copy() for k in z.files}
            section = stats_section(os.path.join(arm_dir, "stats.yaml"),
                                    "tuned_plan")
            want = "(plan)" if arm == "plan" else "(flag)"
            check(section.get("conv_layout", "").endswith(want),
                  f"[tune] (d) {arm}: stats.yaml's tuned_plan section "
                  f"{section}")
            out[f"train_{arm}_sources"] = section
    a, b = states["plan"], states["flags"]
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    print(f"[tune] (d) train --tuned_plan auto vs the same knobs as flags, "
          f"{TUNE_TRAIN_ITERS} steps: snapshots bitwise={same} [{card}]",
          flush=True)
    check(same, "[tune] (d) the plan's run is not bitwise to the flags'")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[tune] phase wall {out['wall_s']:.1f} s [{card}]", flush=True)
    return out


def profile_session(card: str, root: str, dev, batch, tag: str) -> dict:
    """One `train --profile PROFILE_STEPS` session; -> its trace's
    kernel counts, their rows and the window's counter rise."""
    from poseidon_tpu_torch.runtime import attribution as A
    from poseidon_tpu_torch.proto.messages import load_net

    work = os.path.join(root, "profile", tag)
    solver = tune_solver(root, work, 2 + PROFILE_STEPS, batch,
                         display=2 + PROFILE_STEPS)
    extra = ["--device", "cpu"] if dev.type == "cpu" else []
    rc, lines = cli_captured(["train", f"--solver={solver}", "--output_dir",
                              work, "--profile", str(PROFILE_STEPS),
                              "--tuned_plan", "off", *extra])
    check(rc == 0, f"[profile] train exited {rc}")
    check(any(ln.startswith("Wrote profiler trace to ") for ln in lines),
          "[profile] no trace written")
    trace = os.path.join(work, "profile", "rank0.trace.json")
    check(os.path.exists(trace), "[profile] no trace file")
    section = stats_section(os.path.join(work, "stats.yaml"), "profile")
    counters = {k: int(v) for k, v in section.get("launches", {}).items()}
    events = A.load_trace_events(trace)
    layers = {l.name for l in load_net(os.path.join(
        work, "train_val.prototxt")).layers}
    smap = A.trace_scope_map(events, layers)
    result = A.attribute(events, smap, steps=PROFILE_STEPS)
    rows, counts = {}, {}
    for ev in events:
        if ev["stats"].get("cat") != "kernel":
            continue
        for kname in PROFILE_ROWS:
            if kname in ev["name"]:
                counts[kname] = counts.get(kname, 0) + 1
                where = smap.get(ev["stats"].get("hlo_op"))
                rows.setdefault(kname, set()).add(where)
    return {"counters": counters, "counts": counts, "rows": rows,
            "result": result, "trace": trace,
            "trace_bytes": os.path.getsize(trace)}


def phase_profile(card: str, root: str, device=None, batch=None) -> dict:
    """[profile]: `train --profile PROFILE_STEPS` on AlexNet at 256, f32,
    the layout `train` plans on the card (NHWC): the trace, the
    attribution table, each port kernel in its layer's row, each
    kernel's events in the trace equal to its counter's rise over the
    window (a session the profiler dropped launches from runs again, at
    most PROFILE_TRIES times), named coverage >= PROFILE_COVERAGE
    (``device`` and ``batch`` for a CPU rehearsal only)."""
    import torch
    t0 = time.perf_counter()
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    seen = []
    for attempt in range(PROFILE_TRIES if cuda else 1):
        s = profile_session(card, root, dev, batch, f"s{attempt}")
        want = {k: s["counters"].get(row[0], 0)
                for k, row in PROFILE_ROWS.items()}
        got = {k: s["counts"].get(k, 0) for k in PROFILE_ROWS}
        seen.append(got)
        if got == want:
            break
        print(f"[profiler] a session recorded port kernels {got} of "
              f"{want}: rerun", flush=True)
    else:
        if cuda:
            raise SmokeFailure(f"[profile] {PROFILE_TRIES} sessions: trace "
                               f"counts {seen}, counters {want}")
    # the table itself is the engine's (train --profile printed it above)
    res = s["result"]
    top = [f"{r['op'][:90]}: {r['ms']} ms" for r in
           res["residual"]["top_ops"]]
    print(f"[profile] AlexNet x{batch or 256} f32 in train's layout: "
          f"residual top ops {top}; op events {res['op_events']}; trace "
          f"{s['trace_bytes']} B; sessions {len(seen)} [{card}]",
          flush=True)
    if cuda:
        for kname, (counter, n, phase, layers) in PROFILE_ROWS.items():
            allowed = {(l, phase) for l in layers}
            check(s["rows"].get(kname) and s["rows"][kname] <= allowed,
                  f"[profile] {kname} landed in {s['rows'].get(kname)}, "
                  f"not in {sorted(allowed)}")
            check(s["counters"].get(counter) == n * PROFILE_STEPS,
                  f"[profile] {counter} launched "
                  f"{s['counters'].get(counter)} times in the window, "
                  f"want {n * PROFILE_STEPS}")
            print(f"[profile] {kname}: {s['counts'][kname]} launches in "
                  f"the trace = its counter's rise over the window, all in "
                  f"{sorted(s['rows'][kname])}", flush=True)
    check(res["coverage"] >= PROFILE_COVERAGE,
          f"[profile] named coverage {res['coverage']} < "
          f"{PROFILE_COVERAGE}")
    wall = time.perf_counter() - t0
    print(f"[profile] named coverage {res['coverage']:.4f} (target "
          f"{PROFILE_COVERAGE}) of {res['total_ms']:.3f} ms a step; phase "
          f"wall {wall:.1f} s [{card}]", flush=True)
    return {"launches": s["counters"], "coverage": res["coverage"],
            "total_ms": res["total_ms"], "rows": res["rows"],
            "residual": res["residual"], "sessions": len(seen),
            "wall_s": wall}


def phase_sgd_devrate(card: str, arena_total: int) -> list:
    """[dispatch] (d): K7's device-rate entry against its plain version
    (the rate as a 0-d tensor) over the AlexNet arena at an ``inv`` rate,
    beside the by-value entry's time."""
    import torch
    from poseidon_tpu_torch.ops import sgd
    from poseidon_tpu_torch.proto.messages import SolverParameter
    from poseidon_tpu_torch.solvers.updates import learning_rate

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = arena_total
    w = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    h = torch.randn(n, generator=gen, device="cuda") * 1e-3
    lr, dec = arena_mults(n, "cuda")
    sp = SolverParameter(base_lr=0.01, **DISPATCH_LR)
    rate_f = learning_rate(sp, 1234)
    rate = torch.tensor(rate_f, device="cuda")
    mom = 0.9
    wk, hk, wp, hp = w.clone(), h.clone(), w.clone(), h.clone()
    sgd.sgd_update_devrate_cuda_(wk, g, hk, rate, lr, dec, mom)
    torch.cuda.synchronize()
    sgd.sgd_update_plain_(wp, g, hp, rate, lr, dec, mom)
    got, want = torch.cat([wk, hk]), torch.cat([wp, hp])
    bitwise = bool(torch.equal(got, want))
    del wk, hk, wp, hp
    by_value_ms = cuda_time_ms(
        lambda: sgd.sgd_update_cuda_(w, g, h, rate_f, lr, dec, mom))
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    opt = torch.optim.SGD([p], lr=rate_f, momentum=mom, weight_decay=5e-4,
                          foreach=True)
    # five f32 vectors read once and two written once, and the rate's
    # float; 8 ops an element
    rec = compare_case(
        "sgd_update_devrate", "alexnet arena inv", got, want, "float32",
        lambda: sgd.sgd_update_devrate_cuda_(w, g, h, rate, lr, dec, mom),
        lambda: sgd.sgd_update_plain_(w, g, h, rate, lr, dec, mom),
        opt.step, 7 * n * 4 + 4, 8 * n, card,
        extra=f" P={n} rate {rate_f!r} (it 1234)")
    rec.update(length=n, bitwise=bitwise, by_value_entry_ms=by_value_ms,
               library="torch.optim.SGD(foreach=True) over one flat "
                       "vector: a rough yardstick, not Caffe's rule")
    print(f"[dispatch] (d) K7's device-rate entry bitwise to its plain "
          f"version: {bitwise}; {rec['ms']:.4f} ms beside the by-value "
          f"entry's {by_value_ms:.4f} ms on the same vectors [{card}]",
          flush=True)
    check(bitwise, "K7's device-rate entry is not bitwise to plain")
    del w, g, h, lr, dec, got, want, p, opt
    torch.cuda.empty_cache()
    return [rec]


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

    def lap(tag: str) -> None:
        print(f"[lap] {tag} ends at {time.perf_counter() - t_start:.1f} s",
              flush=True)

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
        lap("build")
        k4, k4_attrs = phase_kernels(card)
        k5 = phase_lrn_bwd(card)
        k6, k6_attrs = phase_pool_bwd(card)
        k7 = phase_sgd(card, arena_total)
        k7d = phase_sgd_devrate(card, arena_total)
        k1, fwd_attrs = phase_flash(card)
        k2, k3, bwd_attrs = phase_flash_bwd(card)
        k4n, k5n, k6n, conv1, layout = phase_layout(card)
        lap("kernels, flash and layout")
        serving_launches, ex, solo, load = phase_slice(card)
        phase_net_checks(ex)
        phase_breakdown(ex, card, solo["p50_ms"])
        del ex
        torch.cuda.empty_cache()
        lap("slice")
        fleet = phase_fleet(card, k1, (solo, load))
        lap("fleet")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as root:
            train = phase_train(card, root)
            lap("train")
            torch.cuda.empty_cache()
            dispatch = phase_dispatch(card, root)
            torch.cuda.empty_cache()
            loop = phase_loop(card, root, train["step_ms"])
            torch.cuda.empty_cache()
            bf16 = phase_bf16_train(card, root, train)
            lap("dispatch, loop and bf16_train")
            torch.cuda.empty_cache()
            dp = phase_dp(card, root)
            torch.cuda.empty_cache()
            topk = phase_topk(card, root)
            lap("dp and topk")
            torch.cuda.empty_cache()
            ssp = phase_ssp(card, root)
            lap("ssp")
            torch.cuda.empty_cache()
            spmd = phase_spmd(card, root)
            lap("spmd")
            torch.cuda.empty_cache()
            fabric = phase_fabric(card, root)
            lap("fabric")
            torch.cuda.empty_cache()
            tools = phase_tools(card, root, train_step_ms=train["step_ms"])
            lap("tools")
            torch.cuda.empty_cache()
            tune = phase_tune(card, root)
            torch.cuda.empty_cache()
            profile = phase_profile(card, root)
            lap("tune and profile")
        torch.cuda.empty_cache()
        tp_wall = tune["wall_s"] + profile["wall_s"]
        print(f"[tune] and [profile] took {tp_wall:.1f} s (budget "
              f"{TUNE_PROFILE_BUDGET_S:g} s) [{card}]", flush=True)
        check(tp_wall <= TUNE_PROFILE_BUDGET_S,
              f"[tune] and [profile] took {tp_wall:.1f} s")
        live = {}
        zoo = phase_zoo(card, keep=live)
        dispatch["googlenet"] = dispatch_googlenet(card, live)
        dispatch["wall_s"] += dispatch["googlenet"]["wall_s"]
        del live
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[dispatch] and [remat] took {dispatch['wall_s']:.1f} s "
              f"(budget {DISPATCH_BUDGET_S:g} s) [{card}]", flush=True)
        check(dispatch["wall_s"] <= DISPATCH_BUDGET_S,
              f"[dispatch] and [remat] took {dispatch['wall_s']:.1f} s")
        lap("zoo and dispatch_googlenet")
        lm = phase_lm(card)
        torch.cuda.empty_cache()
        lm_tp = phase_lm_tp_serve(card)
        lap("lm and lm_tp_serve")
        torch.cuda.empty_cache()
        lm_train = phase_lm_train(card)
        torch.cuda.empty_cache()
        with policy_scope(compute_dtype=torch.bfloat16):
            bf16_lm = phase_lm_train(card, tag="bf16_lm_train",
                                     step_tol=BF16_LM_STEP_TOL,
                                     grad_tol=BF16_LM_GRAD_TOL,
                                     peak=("bfloat16", OPS_PER_S["bfloat16"]))
        torch.cuda.empty_cache()
        lap("lm_train and bf16_lm_train")
        lm_corpus = phase_lm_corpus(card)
        lap("lm_corpus")
        torch.cuda.empty_cache()
        lm_par = phase_lm_par(card)
        lap("lm_par")
        torch.cuda.empty_cache()
        lm_pp_ep = phase_lm_pp_ep(card)
        lap("lm_pp_ep")
        digits_acc, bf16_digits_acc = phase_digits(
            card, (((), "digits"), (("--bf16",), "bf16_digits")))
        lap("digits")
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
        # the device-rate entry, whose main path is [dispatch]'s
        # Engine.train() at steps_per_dispatch K: the wrappers' count is
        # the warm-up's and the capture's launches; each replay launches
        # what the capture recorded (runs_by_path)
        kernel_entry("sgd_update_devrate",
                     "poseidon_tpu/ops/pallas_kernels.py:838",
                     dispatch["alexnet"]["launches"]["sgd_update_devrate"],
                     k7d, ("alexnet arena inv",),
                     source="poseidon_tpu_torch/ops/csrc/sgd_update.cu",
                     launches_by_path={},
                     by_value_entry_ms=k7d[0]["by_value_entry_ms"]),
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
                     launches_per_tp_prefill=lm_tp["launches_per_prefill"],
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
        # the SPMD paths: every rank of each `train --mesh` run
        entry["launches_by_path"].update(
            {f"spmd_{arm}": sum_launches(r["launches"])[name]
             for arm, r in spmd["arms"].items()})
        # the fabric's paths: the in-process chaos arm, and every rank of
        # the CLI's two slices
        entry["launches_by_path"].update(
            fabric_chaos=fabric["chaos"]["launches"][name],
            fabric_cli=fabric["cli_launches"][name])
        # the LM's sp and tp paths: every rank of each [lm_par] arm, the
        # control, and the two train_lm pairs
        entry["launches_by_path"].update(
            {f"lm_par_{path}": counts.get(name, 0)
             for path, counts in lm_par["launches"].items()})
        # the LM's pp and ep paths: every rank of each [lm_pp_ep] arm, the
        # two controls, the MoE decode and the two train_lm pairs
        entry["launches_by_path"].update(
            {f"lm_pp_ep_{path}": counts.get(name, 0)
             for path, counts in lm_pp_ep["launches"].items()})
        # the tp-sharded generate executor's traffic
        entry["launches_by_path"]["lm_tp_serve"] = lm_tp["launches"].get(
            name, 0)
        # [zoo]'s paths: GoogLeNet's timed steps, the catalog net's
        # forward and backward, the siamese steps
        entry["launches_by_path"].update(
            {path: counts.get(name, 0)
             for path, counts in zoo["launches"].items()})
        if name == "pool_bwd_nhwc":
            entry["zoo_inception_cases"] = zoo["inception_pools"]
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]]
                + [r["max_abs_err"] for r in zoo["inception_pools"]])
        # [dispatch]'s and [remat]'s paths (wrapper counts: the warm-up's
        # and the capture's), and what a replay of each graph launches
        dg = dispatch["googlenet"]
        entry["launches_by_path"].update(
            dispatch=dispatch["alexnet"]["launches"].get(name, 0),
            dispatch_googlenet=dg["launches"].get(name, 0),
            remat=dispatch["remat"]["launches"].get(name, 0))
        entry["launches_per_replay"] = {
            "dispatch": dispatch["alexnet"]["per_replay"].get(name, 0),
            "dispatch_googlenet": dg["per_replay"].get(name, 0),
            "remat": dispatch["remat"]["per_replay"].get(name, 0)}
        entry["runs_by_path"] = {
            "dispatch": dispatch["alexnet"]["ran"].get(name, 0),
            "dispatch_googlenet": dg["launches"].get(name, 0) // 2
            + dg["per_replay"].get(name, 0)}
        # [tune]'s child (every arm of the search) and [profile]'s window
        entry["launches_by_path"].update(
            tune=tune["launches"].get(name, 0),
            profile=profile["launches"].get(name, 0))
        # [tools]' paths: Engine.train() at iter_size 2, and the `time`
        # and `extract_features` children
        entry["launches_by_path"].update(
            tools_iter_size=tools["iter_size"]["launches"][name],
            tools_time=tools["time"]["launches"][name],
            tools_extract=tools["extract"]["launches"][name])
        # the serving fleet's paths: the CNN replicas, the generate
        # replicas, and the serve and bench_serve children
        entry["launches_by_path"].update(
            {path: counts.get(name, 0)
             for path, counts in fleet["launches"].items()})
        if name == "sgd_update":
            entry["fabric_cli_k7"] = {
                k: fabric["cli"][k] for k in ("k7_calls", "k7_bitwise",
                                              "shard")}
            entry["cases"] += spmd["k7"]
            entry["max_abs_err"] = max(r["max_abs_err"]
                                       for r in entry["cases"])
    summary = {"train_step_ms": train["step_ms"],
               "train_peak_bytes": train["peak_bytes"],
               "train_loop": train["loop"],
               "train_port_kernels": train["port_kernels"],
               "digits_final_accuracy": digits_acc,
               "dp": dp,
               "topk": topk,
               "ssp": ssp,
               "spmd": {k: v for k, v in spmd.items() if k != "k7"},
               "fabric": fabric,
               "loop": loop,
               "lm_serving": lm,
               "lm_tp_serve": lm_tp,
               "lm_training": lm_train,
               "lm_corpus": lm_corpus,
               "layout_conv1": conv1,
               "bf16_train": bf16,
               "bf16_lm_training": bf16_lm,
               "lm_par": lm_par,
               "lm_pp_ep": lm_pp_ep,
               "fleet": fleet,
               "zoo": zoo,
               "tools": tools,
               "dispatch": dispatch,
               "tune": tune,
               "profile": profile,
               "bf16_digits_final_accuracy": bf16_digits_acc,
               "wall_s": time.perf_counter() - t_start}
    print(f"[smoke] total wall {summary['wall_s']:.1f} s of the 1200 s "
          f"limit [{card}]", flush=True)
    print(f"[summary] {json.dumps(summary)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
