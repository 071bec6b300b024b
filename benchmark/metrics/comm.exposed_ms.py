"""Device ms a step of the gradient exchange not hidden behind compute:
the union of rank 0's NCCL kernels over the traced display period, less
the part of it that other kernels overlap, over its steps."""

from benchmark.trace import union


def _subtract(spans, cover):
    """Seconds of the merged ``spans`` that the merged ``cover`` leaves."""
    left, j = 0.0, 0
    for a, b in spans:
        t = a
        while j < len(cover) and cover[j][1] <= t:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            lo, hi = max(cover[k][0], t), min(cover[k][1], b)
            if lo > t:
                left += lo - t
            t = max(t, hi)
            k += 1
        if b > t:
            left += b - t
    return left


def read(ctx):
    if ctx.trace is None:
        return None
    nccl = [(t, t + d) for n, t, d in ctx.trace.kernels if "nccl" in n.lower()]
    if not nccl:
        return None
    other = [(t, t + d) for n, t, d in ctx.trace.kernels
             if "nccl" not in n.lower()]
    exposed_us = _subtract(union(nccl), union(other))
    return exposed_us / 1e3 / ctx.trace.steps
