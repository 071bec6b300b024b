"""Seconds from the process's start to the window's first dispatch:
torch's import, the inputs and weights, the engine's build (kernel
libraries built or loaded), the checked steps and the warm-up (host
clock)."""


def read(ctx):
    return ctx.setup_s
