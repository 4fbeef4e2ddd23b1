"""batch_rows.serve: real (unpadded) rows a dispatch over the window,
the batcher's ``requests`` over its ``batches``."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.stats.get("batches"):
        return None
    return ctx.stats["requests"] / ctx.stats["batches"]
