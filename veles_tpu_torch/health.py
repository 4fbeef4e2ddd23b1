"""Numerics health: shared finiteness checks and watchdog failures.

Counterpart of ``veles_tpu/health.py``.  One bad minibatch must never
silently poison a training run: the fused step and the per-unit GD
chain *skip* non-finite updates, the decision unit detects divergence
and triggers :meth:`veles_tpu_torch.snapshotter.Snapshotter.rollback`,
and :func:`all_finite` validates an update payload before it is
applied.  This module holds the pieces every plane shares so the guards
cannot drift apart.  Tensors (``torch.Tensor``) pass through
``numpy.asarray`` after a host copy.
"""

import math

import numpy

__all__ = ["all_finite", "DivergenceError", "EmaSpikeWatch",
           "RollbackExhausted", "is_finite_metric", "PoisonedUpdate"]


class DivergenceError(RuntimeError):
    """Training diverged and no recovery path exists (no snapshotter
    attached, or nothing good to roll back to).  Raised loudly instead
    of letting the run converge to garbage."""


class RollbackExhausted(DivergenceError):
    """The bounded rollback retry budget is spent and the run still
    diverges; continuing would loop rollback -> divergence forever."""


class PoisonedUpdate(RuntimeError):
    """An update part failed the finiteness validation; raised BEFORE
    the poisoned part touched any state.  ``Workflow.
    apply_update_validated`` raises it, and the master's ``Server``
    quarantines the sender (drop, TTL blacklist, requeue of its
    minibatch)."""

    def __init__(self, unit=None):
        name = type(unit).__name__ if unit is not None else "?"
        super(PoisonedUpdate, self).__init__(
            "non-finite update part for unit %s" % name)
        self.unit_name = name


def is_finite_metric(metric):
    """True only for a real, finite scalar metric.  ``None`` and NaN
    both fail: ``NaN < best`` is silently False, so a NaN metric could
    otherwise be *recorded as best* when no best exists yet."""
    if metric is None:
        return False
    try:
        return math.isfinite(float(metric))
    except (TypeError, ValueError):
        return False


def all_finite(obj):
    """Recursively check a payload tree (nested dicts/lists of numpy
    arrays, tensors and scalars) for non-finite floats.  Non-numeric
    leaves (str, bytes, bool, None) and integer arrays are vacuously
    finite."""
    if obj is None or isinstance(obj, (bool, int, str, bytes)):
        return True
    if isinstance(obj, float):
        return math.isfinite(obj)
    if isinstance(obj, numpy.ndarray):
        if obj.dtype.kind not in "fc":
            return True
        return bool(numpy.isfinite(obj).all())
    if isinstance(obj, numpy.generic):
        if obj.dtype.kind not in "fc":
            return True
        return bool(numpy.isfinite(obj))
    if isinstance(obj, dict):
        return all(all_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return all(all_finite(v) for v in obj)
    # tensors (and anything array-like) reach here via __array__
    detach = getattr(obj, "detach", None)
    if detach is not None:
        obj = detach().cpu()
    try:
        arr = numpy.asarray(obj)
    except Exception:
        return True  # opaque object: nothing numeric to validate
    if arr.dtype.kind not in "fc":
        return True
    return bool(numpy.isfinite(arr).all())


class EmaSpikeWatch(object):
    """The EMA spike discipline the divergence watchdog trips on
    (docs/health.md), shared by every plane that asks "has this series
    suddenly gone bad?".

    Semantics (the JAX package's, bit for bit): a value
    spikes when ``value > spike_factor * max(EMA, spike_floor)`` and an
    EMA exists; a spiking value is reported and NOT folded into the EMA
    (one outlier must not drag the baseline up to meet the next one),
    while a healthy value updates ``EMA = beta * EMA + (1-beta) *
    value``.  The floor keeps near-zero converged baselines from
    turning ordinary noise into "spikes".  Callers gate non-finite
    values themselves (:func:`is_finite_metric`) — NaN comparisons are
    silently False and would sail through."""

    def __init__(self, spike_factor=10.0, spike_floor=1.0, beta=0.5,
                 label="value"):
        self.spike_factor = float(spike_factor)
        self.spike_floor = float(spike_floor)
        self.beta = float(beta)
        self.label = label
        self.ema = None

    def reset(self):
        """Start a fresh observation window (post-rollback)."""
        self.ema = None

    def observe(self, value):
        """Fold a trusted baseline value into the EMA WITHOUT a spike
        check."""
        value = float(value)
        self.ema = value if self.ema is None else \
            self.beta * self.ema + (1.0 - self.beta) * value

    def update(self, value):
        """Check ``value`` against the spike threshold, then fold it in
        when healthy.  Returns the human-readable spike reason, or
        None."""
        value = float(value)
        threshold = self.spike_factor * max(
            self.ema if self.ema is not None else value,
            self.spike_floor)
        if self.ema is not None and value > threshold:
            return "%s spiked to %.4g (EMA %.4g, threshold %.4g)" % (
                self.label, value, self.ema, threshold)
        self.observe(value)
        return None
