"""collect_ms.serve: the median ``serve.collect`` span of the traced
window, in ms: from the batcher's worker claiming a batch's first
request to closing the batch, the batching delay it actually waited
(the program's spans: ``portbench.spans``)."""

import statistics

from portbench import spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    values = spans.durations_ms(ctx, "serve.collect")
    return statistics.median(values) if values else None
