"""The port's channels-last pooling backward (K6-NHWC,
``ops/csrc/pool_bwd.cu``) against its roofline, in %: the least seconds
of the step's pooling backward passes (MAX reads x and dy and writes dx,
AVE reads dy and writes dx, over the HBM rate; ``costs.pool_bwd_bound_s``)
over the kernel's summed device time."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    secs, n = ctx.trace.kernel_s(lambda name: "pool_nhwc_band_kernel" in name)
    if n == 0 or secs <= 0:
        return None
    bound = ctx.costs.pool_bwd_bound_s(ctx.net, ctx.elem_bytes,
                                       ctx.peaks["hbm_bytes_s"])
    return 100.0 * bound * ctx.trace.steps / secs
