"""The card's idle share of the traced display period, in %: one less the
union of its device operations over the period's wall time."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
