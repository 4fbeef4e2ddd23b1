"""queue_ms.serve: the median of the answered requests' ``queue``
marks (the batcher's segment timeline: from enqueue to the start of
the batch that took them), in ms."""

import numpy


def read(ctx):
    if ctx.kind != "serve":
        return None
    waits = ctx.answers.queue_s[numpy.isfinite(ctx.answers.queue_s)]
    return float(numpy.median(waits)) * 1e3 if len(waits) else None
