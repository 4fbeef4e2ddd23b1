"""idle_pct.serve: the share of the traced window in which no operation
ran on the device: 1 - (the union of the device's kernel, copy and set
intervals over every stream) / the window."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
