"""Model FLOPs utilisation of the window, in %: the conv and FC FLOPs of
a trained image (``costs.model_flops_per_image``) times ``train_img_s``
over the card's published dense peak at the cell's compute dtype, times
the cards."""


def read(ctx):
    if not ctx.window_s or ctx.peaks is None:
        return None
    img_s = ctx.window_steps * ctx.batch * ctx.chips / ctx.window_s
    peak = ctx.peaks["flops_s"][ctx.precision] * ctx.chips
    return 100.0 * ctx.costs.model_flops_per_image(ctx.net) * img_s / peak
