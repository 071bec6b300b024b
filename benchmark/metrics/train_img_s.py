"""Images trained over the window's wall time, every rank's rows counted:
the window's steps times the batch times the ranks, over the seconds from
its first dispatch to its final hard sync (host clock)."""


def read(ctx):
    if not ctx.window_s:
        return None
    return ctx.window_steps * ctx.batch * ctx.chips / ctx.window_s
