"""The measured per-layer conv lowering (the port of ``poseidon_tpu/ops/
conv_tune.py``, Caffe con Troll's regime, arXiv:1504.04343): under
``conv_strategy="auto"`` each conv layer takes the lowering that a short
measured run on its own geometry finds fastest.

- **candidates** come from ``ops/nn.conv_strategy_applicable`` (never a
  strategy that cannot lower the layer): direct (cuDNN), im2col (patches
  and one GEMM) and s2d (the stem rewrite);
- **measurement** is forward and backward (dx and dw) on the layer's
  (C, H, W, k, s, p, group) at a micro batch of at most ``MICRO_BATCH``,
  each call ending in ``torch.cuda.synchronize`` on the card, timed by
  ``runtime/tuned_plan.interleaved_min_ms`` (every candidate warmed, then
  interleaved windows, the min of each);
- **the decision is made once** per (geometry, layout, micro batch,
  device type and name, compute dtype): an in-process memo serves repeated
  geometries (GoogLeNet's inception branches measure once), and the winner
  is persisted in the tuned store (``runtime/compile_cache.py``), so a
  restarted process skips the measurement. Without a configured store it
  falls back to the active tuned plan's (``tuned_plan.active_store_dir``).

``core/net.py`` calls :func:`resolve` for every conv layer when a net is
built under ``conv_strategy="auto"`` and logs the table; explicit
strategies bypass this module.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

# strategies "auto" may choose between ("" is not a candidate: it defers
# to the policy's conv_s2d)
CANDIDATES = ("direct", "im2col", "s2d")

MICRO_BATCH = 4      # micro-run batch
MICRO_ITERS = 2      # timed calls per interleaved window
TRIAL_WINDOWS = 3    # interleaved windows per candidate (min-of-k)
TRIAL_WARMUP = 2     # un-timed calls per candidate before ANY timing

_NAMESPACE = "conv_strategy"
_memo: Dict[str, Dict] = {}


def clear_memo() -> None:
    """Test hook: drop the in-process decisions (NOT the persisted ones)."""
    _memo.clear()


def strategy_key(parts: Dict) -> str:
    from ..runtime.compile_cache import step_key
    return step_key(kind=_NAMESPACE, **parts)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _key_parts(c: int, h: int, w: int, kernel: Tuple[int, int],
               stride: Tuple[int, int], pad: Tuple[int, int], group: int,
               out_ch: int, layout: str, micro_batch: int,
               device: torch.device) -> Dict:
    """JAX's parts, with the device's type and name and the compute dtype
    where JAX has its backend and device kind, and the framework, so a
    document of either package never answers the other."""
    from ..numeric import policy
    return {
        "c": c, "h": h, "w": w,
        "kh": kernel[0], "kw": kernel[1],
        "sh": stride[0], "sw": stride[1],
        "ph": pad[0], "pw": pad[1],
        "group": group, "out_ch": out_ch, "layout": layout,
        "micro_batch": micro_batch,
        "framework": "torch",
        "device_type": device.type,
        "device_name": _device_name(device),
        "compute_dtype": str(policy().compute_dtype).replace("torch.", ""),
    }


def _micro_arrays(c, h, w, kernel, group, out_ch, layout, micro_batch,
                  device: torch.device):
    """x (channels-last under NHWC), w, b drawn from a seeded CPU
    generator and moved to ``device``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((micro_batch, c, h, w), generator=gen)
    wgt = torch.randn((out_ch, c // group) + tuple(kernel),
                      generator=gen) * 0.05
    b = torch.randn((out_ch,), generator=gen) * 0.05
    x = x.to(device)
    if layout == "NHWC":
        x = x.contiguous(memory_format=torch.channels_last)
    return x, wgt.to(device), b.to(device)


def _make_step(strategy: str, x, wgt, b, stride, pad, group, layout: str):
    """One candidate's forward and backward (dx AND dw: both matter in
    training) as a zero-arg callable that ends synchronized on the card,
    for the interleaved timer. ``layout`` is carried by x's memory
    format."""
    from . import nn as NN

    xg = x.detach().requires_grad_(True)
    wg = wgt.detach().requires_grad_(True)
    cuda = x.device.type == "cuda"

    def run():
        y = NN.conv2d(xg, wg, b, stride, pad, group, strategy=strategy)
        torch.autograd.grad(y.float().square().sum(), (xg, wg))
        if cuda:
            torch.cuda.synchronize(x.device)

    return run


def _measure_candidates(cands, x, wgt, b, stride, pad, group,
                        layout: str) -> Dict[str, float]:
    """Every candidate warmed TRIAL_WARMUP times before any timing, then
    interleaved order-alternating windows with the min of each (the
    estimator ``tuned_plan.interleaved_min_ms``)."""
    from ..runtime import tuned_plan
    fns = {s: _make_step(s, x, wgt, b, stride, pad, group, layout)
           for s in cands}
    return tuned_plan.interleaved_min_ms(fns, windows=TRIAL_WINDOWS,
                                         iters=MICRO_ITERS,
                                         warmup=TRIAL_WARMUP)


def resolve(name: str, c: int, h: int, w: int, kernel: Tuple[int, int],
            stride: Tuple[int, int], pad: Tuple[int, int], group: int,
            out_ch: int, layout: str, batch: int,
            cache_dir: Optional[str] = None, device=None) -> Dict:
    """The decision document for one conv geometry on ``device`` (the
    GPU unless given): ``{"winner", "timings_ms", "source", "key", ...}``
    where ``source`` is "memo" | "persisted" | "measured" |
    "only-candidate". ``name`` is informational (the first layer that
    triggered the measurement); the key is geometric, so shape-identical
    layers share."""
    from ..numeric import resolve_device
    from . import nn as NN
    device = resolve_device(device)
    if cache_dir is None:
        from ..config import compile_cache_config
        cache_dir = compile_cache_config().cache_dir
        if not cache_dir:
            # a loaded tuned plan that resolved conv_strategy="auto"
            # points here at the plan's own store, so the per-layer
            # winners the tune run persisted memo-hit
            from ..runtime.tuned_plan import active_store_dir
            cache_dir = active_store_dir()

    micro_batch = max(1, min(batch, MICRO_BATCH))
    parts = _key_parts(c, h, w, kernel, stride, pad, group, out_ch, layout,
                       micro_batch, device)
    key = strategy_key(parts)
    if key in _memo:
        return dict(_memo[key], source="memo")

    from ..runtime.compile_cache import load_tuned, save_tuned
    doc = load_tuned(cache_dir, _NAMESPACE, key)
    if doc is not None and doc.get("winner") in CANDIDATES:
        _memo[key] = doc
        return dict(doc, source="persisted")

    x, wgt, b = _micro_arrays(c, h, w, kernel, group, out_ch, layout,
                              micro_batch, device)
    cands = [s for s in CANDIDATES
             if NN.conv_strategy_applicable(s, x, wgt, stride, group)]
    doc = {"key": key, "layer": name, "parts": parts, "timings_ms": {}}
    if len(cands) == 1:
        doc.update(winner=cands[0], source="only-candidate")
    else:
        timings = _measure_candidates(cands, x, wgt, b, stride, pad, group,
                                      layout)
        doc["timings_ms"] = {s: round(ms, 4) for s, ms in timings.items()}
        doc.update(
            winner=min(doc["timings_ms"], key=doc["timings_ms"].get),
            source="measured",
            measured_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
        save_tuned(cache_dir, _NAMESPACE, key, doc)
    _memo[key] = doc
    return dict(doc)


def describe(doc: Dict) -> str:
    """One human line per decision, for the construction-time table."""
    times = " | ".join(f"{s} {ms:.3f}ms"
                       for s, ms in sorted(doc.get("timings_ms", {}).items(),
                                           key=lambda kv: kv[1]))
    return (f"{doc.get('layer', '?')}: -> {doc['winner']} "
            f"[{doc.get('source', '?')}]"
            + (f" ({times})" if times else ""))
