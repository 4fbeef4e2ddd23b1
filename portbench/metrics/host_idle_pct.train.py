"""host_idle_pct.train: the share of the traced window in which no
operation ran on the device while the training loop's thread was in
one of its spans (``loader.gather``, ``fused.train_step`` with its
replay and state hand-over, ``decision.run`` with its class-end read;
the program's spans, on the profiler's clock: ``portbench.spans``).
At most ``idle_pct.train``, of which it is the part the loop's own
host work holds."""

from portbench import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.host_idle_pct(ctx, "fused.train_step", lambda name: True)
