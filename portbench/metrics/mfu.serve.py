"""mfu.serve: the forward product FLOPs of the rows answered in the
traced window (padding rows excluded), over the window, against the
peak of the served precision (int8: the int8 rate)."""

from portbench import counts


def read(ctx):
    if ctx.kind != "serve" or not ctx.answers.answered:
        return None
    rate = ctx.peaks["ops_per_s"][ctx.precision]
    return 100.0 * counts.forward_flops(ctx.model) * ctx.answers.answered / (
        ctx.window_s * rate)
