"""dispatch_ms.serve: the mean host-clock ``device`` + ``d2h`` segment
of the window's dispatches, in ms (from the answered requests' marks,
once a dispatch).  The copy in sits inside the device segment: the
batcher's ``h2d`` mark is empty."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.answers.dispatches:
        return None
    seconds = [s for s, _ in ctx.answers.dispatches.values()]
    return 1e3 * sum(seconds) / len(seconds)
