"""host_idle_pct.serve: the share of the traced window in which no
operation ran on the device while the batcher's worker was at work:
in a span of its own other than ``serve.idle`` (waiting for traffic)
and ``serve.collect`` (waiting out the batching delay), i.e. staging,
the copy in, the launch, the wait for the copy back or the answers
(the program's spans, on the profiler's clock: ``portbench.spans``)."""

from portbench import spans

WAITS = ("serve.idle", "serve.collect")


def read(ctx):
    if ctx.kind != "serve":
        return None
    return spans.host_idle_pct(ctx, "serve.batch",
                               lambda name: name not in WAITS)
