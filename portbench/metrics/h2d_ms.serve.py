"""h2d_ms.serve: the mean ``serve.h2d`` span of the traced window, in
ms a dispatch: from the end of the batch's staging to the return of
the copy into the rung's static input (on the card a pageable copy,
which the host waits out), the call into the engine included (the
program's spans: ``portbench.spans``)."""

from portbench import spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    values = spans.durations_ms(ctx, "serve.h2d")
    return sum(values) / len(values) if values else None
