"""The input pipeline's share of the traced display period, in %: the
engine's ``prefetch_wait`` spans (the loop waiting on ``DevicePrefetcher``
for the next batch) over the period's wall time."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace.span_s("prefetch_wait") / ctx.trace.window_s
