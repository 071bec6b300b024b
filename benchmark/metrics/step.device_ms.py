"""Device ms a step: the union of the kernels', memsets' and device
copies' intervals over the traced display period, over its steps."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.trace.steps
