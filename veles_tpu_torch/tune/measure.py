"""The one timing discipline for schedule ranking.

Counterpart of ``veles_tpu/tune/measure.py``: the GA tuner's fitness and
``ops.matmul.autotune_matmul``'s sweep rank schedules through these
helpers.

- **Pass filtering** (``filter_passes``): a non-positive chain slope
  measured noise, not the program; such passes are discarded, never
  clamped.
- **Positive majority** (``rank``): a candidate's median runs over ALL
  its samples and must be positive with a positive majority, so a
  noise-swamped candidate cannot win on two small surviving samples.
- **Interleaving** (``interleaved_slopes``): one sample of every
  candidate a round, so drift of the card's clock or of the host spreads
  over all candidates alike.

The port's clock: on a CUDA device a chain's time is DEVICE time.  A
spin kernel (``torch.cuda._sleep``) holds the stream while the host
enqueues the chain, and CUDA events around the chain time it back to
back on the card, so the host's per-launch cost does not decide the
ranking (the discipline of ``chip_smoke.device_ms``).  The spin grows
when the enqueue outlasts it.  On the CPU, where only the tests run,
the wall clock times the chain.
"""

import time

__all__ = ["filter_passes", "chain_seconds", "slope_sample",
           "interleaved_slopes", "rank", "positive_majority_median"]

#: spin cycles a device chain starts behind; doubled (up to
#: ``_SPIN_MAX``) whenever the host's enqueue outlasted the spin
_SPIN = [2 * 10 ** 7]
_SPIN_MAX = 2 * 10 ** 9


def filter_passes(samples):
    """Drop noise-dominated timing passes (non-positive slopes).
    Returns the retained passes; when EVERY pass is non-positive the raw
    list comes back unchanged so the caller's plausibility check (not
    this filter) rejects the measurement."""
    used = [s for s in samples if s > 0]
    return used if used else list(samples)


def positive_majority_median(samples):
    """Median over ALL samples, published only when a positive
    MAJORITY of passes survived and the median itself is positive;
    ``None`` otherwise (the candidate measured only noise)."""
    import numpy
    positive = sum(1 for s in samples if s > 0)
    if not samples or positive < len(samples) // 2 + 1:
        return None
    med = float(numpy.median(samples))
    return med if med > 0 else None


def _device_chain_seconds(run, n, device):
    import torch
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        while True:
            spin = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            spin.record()
            torch.cuda._sleep(_SPIN[0])
            start.record()
            t0 = time.perf_counter()
            run(n)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            end.synchronize()
            if enqueue_ms < spin.elapsed_time(start) or \
                    _SPIN[0] >= _SPIN_MAX:
                return start.elapsed_time(end) / 1e3
            _SPIN[0] *= 2


def chain_seconds(run, n, device=None):
    """Seconds of ``run(n)``: ``n`` queued or dependent kernel calls.
    ``device`` a CUDA device: device time on the card's clock, the host
    hidden behind a spin (``run`` only enqueues; this waits).  Otherwise
    the wall clock around ``run(n)``, which owns its blocking."""
    if device is not None:
        import torch
        device = torch.device(device)
        if device.type == "cuda":
            return _device_chain_seconds(run, n, device)
    start = time.perf_counter()
    run(n)
    return time.perf_counter() - start


def slope_sample(run, n1, n2, device=None):
    """One (t(n2) - t(n1)) / (n2 - n1) slope sample: the fixed cost of a
    chain cancels, the time of one call remains.  May be zero or
    negative when noise swamps the chain delta: callers filter
    (``filter_passes``), never clamp."""
    t1 = chain_seconds(run, n1, device)
    t2 = chain_seconds(run, n2, device)
    return (t2 - t1) / (n2 - n1)


def interleaved_slopes(runners, n1, n2, rounds=5, device=None):
    """Round-robin slope samples: one sample of EVERY candidate per
    round, ``rounds`` rounds.  ``runners`` maps candidate key ->
    ``run(n)`` callable (already built and warm).  A runner that raises
    mid-round just misses that round's sample."""
    samples = {key: [] for key in runners}
    for _ in range(rounds):
        for key, run in runners.items():
            try:
                samples[key].append(slope_sample(run, n1, n2, device))
            except Exception:
                continue
    return samples


def rank(samples_by_key):
    """{key: median seconds or None} under the positive-majority
    discipline; keys whose every sample was noise come back None and
    must never be crowned."""
    return {key: positive_majority_median(samples)
            for key, samples in samples_by_key.items()}
