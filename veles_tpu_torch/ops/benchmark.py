"""Device benchmark: the computing-power rating.

Counterpart of ``veles_tpu/ops/benchmark.py``: the rating that a slave
sends the master in its handshake, for load balancing, timed on the
matmul kernel's self-multiply (:func:`matmul_benchmark`)."""

from veles_tpu_torch.ops.matmul import matmul_benchmark

__all__ = ["estimate_computing_power", "matmul_benchmark"]


def estimate_computing_power(size=1024, repeats=3, device=None):
    """1000 / seconds per ``size``-cubed product, the reference's
    arbitrary power unit.

    A slope below the least credible time (one implying more than 1
    PFLOP/s) is measured again with a chain 4 and then 16 times as long;
    if it never becomes credible the rating raises ``RuntimeError``
    rather than publish a number made of noise.  ``device`` as in
    :func:`matmul_benchmark` (``None``: the card)."""
    min_credible_s = 2.0 * size ** 3 / 1e15
    for scale in (1, 4, 16):
        elapsed = matmul_benchmark(size=size, repeats=repeats * scale,
                                   device=device)
        if elapsed >= min_credible_s:
            return 1000.0 / elapsed
    raise RuntimeError(
        "estimate_computing_power: matmul timing slope stayed below "
        "the minimum credible time (%.3g s for a %d^3 matmul) after "
        "remeasurement; refusing to publish a power rating from "
        "noise" % (min_credible_s, size))
