"""matmul_int8_roofline: the ``matmul_int8`` kernel's share of its
roofline in the traced window: the bound of every dispatch's quantized
products at its rung (``counts.matmul_int8_bound_s``; each dispatch's
rung from its rows, ``ctx.answers.dispatches``) over the device time of
the kernel's launches (its split-K epilogue included), found by
name."""

from portbench import counts
from portbench.trace import matching_seconds

FRAGMENTS = ("matmul_int8_tc_kernel", "matmul_int8_splitk_epilogue")


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    seconds, launches = matching_seconds(ctx.trace, FRAGMENTS)
    if not launches:
        return None
    bound = 0.0
    for _, n in ctx.answers.dispatches.values():
        rung = min(r for r in ctx.ladder if r >= n)
        bound += counts.matmul_int8_bound_s(ctx.model, rung, ctx.peaks)
    return 100.0 * bound / seconds
