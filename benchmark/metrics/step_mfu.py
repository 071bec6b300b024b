"""The whole step's share of the card's peak, in %: the model FLOPs of
the traced steps over the device's busy seconds in them and the dense
peak at the cell's compute dtype. It bounds every kernel's roofline share
that moves the same metric."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.trace.busy_s <= 0:
        return None
    flops = (ctx.costs.model_flops_per_image(ctx.net) * ctx.batch
             * ctx.trace.steps)
    return 100.0 * flops / ctx.trace.busy_s / \
        ctx.peaks["flops_s"][ctx.precision]
