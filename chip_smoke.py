"""Smoke test of the PyTorch port on one NVIDIA GPU (H100):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final ``ok`` line:

1. Card and toolchain: ``nvidia-smi`` name and power limit, torch/CUDA
   versions. Builds and loads every CUDA kernel of
   ``poseidon_tpu_torch/ops/csrc`` with nvcc and prints the build time.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the AlexNet serving path gives them (norm1 and norm2 at bucket 64, f32
   and bf16, plus an odd even-window case), with CUDA-event times for the
   kernel, the plain version and the one-call library yardstick
   (``F.local_response_norm``, which the port never calls), beside the
   bytes bound at the card's published memory rate.
3. The serving slice: ``BucketedExecutor.from_files`` on AlexNet (3x227x227,
   buckets 1/4/16/64, seeded filler weights) behind the port's
   ``InferenceServer`` on 127.0.0.1 port 0, driven by the port's
   ``ServingClient``. Launch counters are zeroed just before and read just
   after: every forward must have launched the LRN kernel twice. Replies
   are held against a direct ``Net`` forward on the card; one bucket-16
   forward is held against the same forward with the plain LRN on the card
   and against the CPU. Bucket-64 load runs LOAD_REQUESTS requests at one
   client and again at two; p50/p99 latency and img/s are printed with the
   request count beside them.
4. One JSON line with every kernel's numbers, then the ``ok`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

# Published H100 SXM memory rate (NVIDIA data sheet): the bytes bound of a
# memory-bound kernel is bytes moved / this rate.
HBM_BYTES_PER_S = 3.35e12
HBM_SOURCE = "H100 SXM data sheet, 3.35 TB/s"
ALEXNET = "examples/imagenet/alexnet_deploy.prototxt"
BUCKETS = (1, 4, 16, 64)
REQUEST_ROWS = (1, 3, 4, 9, 16, 33, 64)
# bucket-64 requests per concurrency: enough that p99 is not just the max
LOAD_REQUESTS = 300
LRN_ALPHA, LRN_BETA, LRN_K = 1e-4, 0.75, 1.0
# kernel vs plain on the card: f32 differs by powf's last bits; bf16 may
# flip one bf16 rounding step (2^-7 relative) where those bits sit on a tie
KERNEL_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 1e-6)}
# whole-net comparisons (rtol, atol) on prob and every blob
NET_TOL = (1e-4, 1e-6)


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
    for name in names:
        _build.load(name)
    print(f"[build] {len(names)} kernel(s) {names} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(card: str):
    """LRN kernel vs plain on the card; returns the per-case records."""
    import torch
    import torch.nn.functional as F
    from poseidon_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("norm1", (64, 96, 55, 55), 5, torch.float32),
             ("norm2", (64, 256, 27, 27), 5, torch.float32),
             ("norm1", (64, 96, 55, 55), 5, torch.bfloat16),
             ("norm2", (64, 256, 27, 27), 5, torch.bfloat16),
             ("odd", (5, 37, 9, 9), 4, torch.float32)]
    records = []
    for label, shape, size, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        got = lrn.lrn_fwd_cuda(x, size, LRN_ALPHA, LRN_BETA, LRN_K)
        torch.cuda.synchronize()
        want = lrn.lrn_across_channels_plain(x, size, LRN_ALPHA, LRN_BETA,
                                             LRN_K)
        diff = (got.float() - want.float()).abs()
        max_abs = float(diff.max())
        max_rel = float((diff / want.float().abs().clamp_min(1e-30)).max())
        dname = str(dtype).replace("torch.", "")
        rtol, atol = KERNEL_TOL[dname]
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        ms = cuda_time_ms(lambda: lrn.lrn_fwd_cuda(x, size, LRN_ALPHA,
                                                   LRN_BETA, LRN_K))
        plain_ms = cuda_time_ms(lambda: lrn.lrn_across_channels_plain(
            x, size, LRN_ALPHA, LRN_BETA, LRN_K))
        library_ms = None
        if size % 2 == 1:
            # torch's builtin pads size//2 channels before the window, the
            # same window as Caffe's only for odd sizes: a yardstick there
            library_ms = cuda_time_ms(lambda: F.local_response_norm(
                x, size, LRN_ALPHA, LRN_BETA, LRN_K))
        nbytes = 2 * x.numel() * x.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"case": label, "shape": list(shape), "local_size": size,
               "dtype": dname, "max_abs_err": max_abs,
               "max_rel_err": max_rel, "tol_rtol_atol": [rtol, atol],
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bytes": nbytes, "bound_ms": bound_ms}
        records.append(rec)
        print(f"[lrn_fwd] {label} {tuple(shape)} n={size} {dname}: "
              f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
              f"(rtol {rtol:g}, atol {atol:g}) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.local_response_norm "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
              f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB / "
              f"{HBM_SOURCE}) [{card}]", flush=True)
        check(ok, f"lrn_fwd disagrees with its plain version on {label} "
                  f"{dname}: max_abs {max_abs}")
    return records


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
    from poseidon_tpu_torch.ops import lrn
    from poseidon_tpu_torch.serving.client import ServingClient, run_load
    from poseidon_tpu_torch.serving.executor import BucketedExecutor
    from poseidon_tpu_torch.serving.server import InferenceServer

    rs = np.random.RandomState(0)
    requests = {n: rs.randn(n, 3, 227, 227).astype(np.float32)
                for n in REQUEST_ROWS}

    for k in lrn.LAUNCHES:
        lrn.LAUNCHES[k] = 0
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
    launches = lrn.LAUNCHES["lrn_fwd"]
    forwards = ex.forwards
    print(f"[slice] {forwards} forwards ({len(BUCKETS)} warm-up, "
          f"dispatches per bucket {ex.calls}); lrn_fwd launches {launches}",
          flush=True)
    check(launches == 2 * forwards,
          f"lrn_fwd launched {launches} times for {forwards} forwards "
          f"(expected 2 per forward)")
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
    try:
        card = card_line()
        print(card, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        phase_build()
        records = phase_kernels(card)
        launches, ex, solo = phase_slice(card)
        phase_net_checks(ex)
        phase_breakdown(ex, card, solo["p50_ms"])
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        return 1

    f32_main = [r for r in records
                if r["dtype"] == "float32" and r["case"] in ("norm1", "norm2")]
    kernels = [{
        "name": "lrn_fwd",
        "route": "cuda",
        "source": "poseidon_tpu_torch/ops/csrc/lrn_fwd.cu",
        "replaces": "poseidon_tpu/ops/pallas_kernels.py:443",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records
                           if r["dtype"] == "float32"),
        # per AlexNet forward at bucket 64 (norm1 + norm2, f32)
        "ms": sum(r["ms"] for r in f32_main),
        "plain_ms": sum(r["plain_ms"] for r in f32_main),
        "bound_ms": sum(r["bound_ms"] for r in f32_main),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in f32_main),
        "cases": records,
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
