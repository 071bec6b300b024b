"""The 95th percentile of the window's step times: the interval between
consecutive step-end CUDA events, one sample a dispatch divided by its
steps (a K-step CUDA graph gives one sample of its K steps' mean)."""

import numpy as np


def read(ctx):
    if len(ctx.step_ms) < 20:
        return None
    return float(np.percentile(np.asarray(ctx.step_ms), 95))
