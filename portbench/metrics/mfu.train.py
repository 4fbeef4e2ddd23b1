"""mfu.train: the model's product FLOPs of the images stepped in the
traced window (``counts.train_flops``: forward, dW and dX, no
elementwise work), over the window, against the peak of the
configuration's precision."""

from portbench import counts


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    rate = ctx.peaks["ops_per_s"][ctx.model.config["precision"]]
    return 100.0 * counts.train_flops(ctx.model) * ctx.images / (
        ctx.window_s * rate)
