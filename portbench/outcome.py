"""What one run of a cell hands back to the harness: the end-to-end
numbers, what the per-layer readers read (the context), the profiler's
trace of the window, and the deferred comparison with the reference."""

import contextlib

import torch

from portbench import counts

__all__ = ["Outcome", "peak_reserved", "profiled", "sync"]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_reserved(dev):
    """The caching allocator's peak of reserved bytes, the captured
    graphs' private pools included (their blocks count as reserved, not
    as allocated, between replays); 0 off the card."""
    return torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" \
        else 0


@contextlib.contextmanager
def profiled(trace, dev):
    """A ``torch.profiler`` over the block when ``trace``, else
    nothing; yields the profiler or None."""
    if not trace:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


class Outcome(object):
    """The context a per-layer reader gets (``read(ctx)``): ``kind``
    ("train" or "serve"), ``model`` (:class:`portbench.model.Model`),
    ``traffic``, ``peaks``, ``window_s`` and, in a traced run,
    ``trace`` (:class:`portbench.trace.Trace`); a training run adds
    ``steps``, ``batch``, ``images`` and ``peak_window_bytes``, a
    serving run ``answers`` (:class:`portbench.serve.Answers`),
    ``stats`` (the batcher's counters over the window), ``ladder`` and
    ``precision``."""

    def __init__(self, kind, model, traffic, window_s, prof):
        self.kind = kind
        self.model = model
        self.traffic = traffic
        self.peaks = counts.load_peaks()
        self.window_s = window_s
        self.prof = prof
        self.trace = None
        self.e2e = {}
        self.attempted = self.failed = 0
        self.missing = 0
        self.memory_peak_bytes = 0
        self.extra = {}
        self.check = None

    def read_trace(self):
        if self.prof is not None:
            from portbench.trace import Trace
            self.trace = Trace(self.prof)
            self.prof = None
        return self.trace
