"""The port's channels-last LRN kernels (K4-NHWC forward, K5-NHWC
backward, ``ops/csrc/lrn_{fwd,bwd}.cu``) against their roofline, in %: the
least seconds of the step's across-channel LRNs (each input byte read
once and each output byte written once over the HBM rate, or the ops over
the peak where larger; ``costs.lrn_bound_s``) over the kernels' summed
device time."""


def _mine(name):
    return "lrn_nhwc_fwd_kernel" in name or "lrn_nhwc_bwd_kernel" in name


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    secs, n = ctx.trace.kernel_s(_mine)
    if n == 0 or secs <= 0:
        return None
    bound = ctx.costs.lrn_bound_s(ctx.net, ctx.elem_bytes,
                                  ctx.peaks["hbm_bytes_s"],
                                  ctx.peaks["flops_s"][ctx.precision])
    return 100.0 * bound * ctx.trace.steps / secs
