"""conv_wgrad_roofline: the ``conv_wgrad`` kernel's share of its
roofline in the traced window: the summed bound of the steps' conv
layers (``counts.conv_wgrad_bound_s``: the work counted once against
the bf16 rate, the bytes once against the memory rate) over the summed
device time of the kernel's launches, found by name."""

from portbench import counts
from portbench.trace import matching_seconds

FRAGMENTS = ("wgrad_kernel", "wgrad_tc_kernel", "reduce_splits")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds, launches = matching_seconds(ctx.trace, FRAGMENTS)
    if not launches:
        return None
    bound = counts.conv_wgrad_bound_s(ctx.model, ctx.batch, ctx.peaks)
    return 100.0 * bound * ctx.steps / seconds
