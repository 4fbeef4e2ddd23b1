"""Communication analysis of a step.

Counterpart of ``veles_tpu/parallel/analysis.py``, which parses the
collectives out of a compiled program's optimized HLO text.  The port
has no HLO: :func:`collective_bytes` runs the function once and reads
what the collective layer (``parallel/collectives.py``) issued in that
run — each collective's result bytes, by kind, in the reference's
return shape ({kind: bytes, ..., "total": bytes}).  A captured step's
replays count like its capture run (the counters are registered with
``graphs.py``).
"""

from veles_tpu_torch.parallel import collectives

__all__ = ["collective_bytes", "collective_counts"]


def _delta(counter, fn, args):
    before = dict(counter.paths)
    fn(*args)
    return {kind: counter.paths[kind] - before[kind]
            for kind in collectives.KINDS}


def collective_bytes(fn, *args):
    """Run ``fn(*args)`` once; the bytes of the collectives it issued,
    by kind, plus "total"."""
    out = _delta(collectives.COLLECTIVE_BYTES, fn, args)
    out["total"] = sum(out.values())
    return out


def collective_counts(fn, *args):
    """Run ``fn(*args)`` once; the collectives it issued, by kind, plus
    "total"."""
    out = _delta(collectives.COLLECTIVES, fn, args)
    out["total"] = sum(out.values())
    return out
