"""cuDNN's convolutions against their roofline, in %: the convs' FLOPs in
the traced steps (forward, data gradient except at the data layer, weight
gradient; ``costs.conv_flops_per_step``) over the summed device time of
the convolution kernels and the dense peak at the cell's compute dtype.
A kernel is a convolution's by its name: cuDNN's fprop, dgrad and wgrad
engines and implicit GEMMs, its Winograd and FFT algorithms with their
helpers (the filter flip, the complex pointwise products and complex
GEMMs, which no FC layer runs). Real-valued cuBLAS GEMMs are the FC
layers'; cuDNN's layout transforms are ``layout.transform_ms``'s."""

import re

CONV = re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd|fft|"
                  r"cudnn|flip_filter|pointwise_mult_and_sum_complex|"
                  r"gemm_cf32|cgemm|computeOffsets|scalePackedTensor", re.I)
LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw|nchw2nhwc|nhwc2nchw", re.I)


def is_conv(name):
    return bool(CONV.search(name)) and not LAYOUT.search(name)


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    secs, n = ctx.trace.kernel_s(is_conv)
    if n == 0 or secs <= 0:
        return None
    flops = ctx.costs.conv_flops_per_step(ctx.net) * ctx.trace.steps
    return 100.0 * flops / secs / ctx.peaks["flops_s"][ctx.precision]
