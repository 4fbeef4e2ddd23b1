"""max_pool_bwd_roofline: the ``max_pool_bwd`` kernel's share of its
byte bound in the traced window (``counts.max_pool_bwd_bound_s``: x,
y, dy and dx once each, a step's pools) over the device time of its
launches, found by name."""

from portbench import counts
from portbench.trace import matching_seconds

FRAGMENTS = ("pool_bwd_cells", "pool_bwd_overlap")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds, launches = matching_seconds(ctx.trace, FRAGMENTS)
    if not launches:
        return None
    bound = counts.max_pool_bwd_bound_s(ctx.model, ctx.batch, ctx.peaks)
    return 100.0 * bound * ctx.steps / seconds
