"""Device ms a step in layout conversions: cuDNN's ``nchwToNhwc`` and
``nhwcToNchw`` transforms and ATen's copy kernels (the filters' and the
batch's channels-last copies; under bf16 the casts ride the same
kernels), over the traced display period."""

import re

LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw|nchw2nhwc|nhwc2nchw|"
                    r"direct_copy_kernel|copy_kernel", re.I)


def read(ctx):
    if ctx.trace is None:
        return None
    secs, _ = ctx.trace.kernel_s(lambda n: bool(LAYOUT.search(n)))
    return 1e3 * secs / ctx.trace.steps
