"""Host ms a step inside the engine's ``dispatch`` spans (enqueueing
``TrainStep.step`` or ``multi_step``) over the traced display period."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 1e3 * ctx.trace.span_s("dispatch") / ctx.trace.steps
