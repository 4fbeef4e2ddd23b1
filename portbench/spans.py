"""The program's own spans of a traced window, for the per-layer
readers: what the port's tracer recorded while the window's
``torch.profiler`` ran (``veles_tpu_torch.observe.trace``:
``tracer.profiled_spans()``, on the profiler's clock), clipped to the
trace's extent, and the device's idle time inside a set of them.

Everything here returns None where the program recorded no such span
(a program without profiler-linked recording has no
``profiled_spans``), so a broken link shows as a missing metric, never
as 0.
"""

__all__ = ["window_spans", "thread_of", "union", "idle_seconds",
           "host_idle_pct", "durations_ms"]


def window_spans(ctx):
    """The program's spans that overlap the traced window, each clipped
    to it; None when there are none."""
    trace = ctx.trace
    if trace is None or not (trace.host or trace.device):
        return None
    try:
        from veles_tpu_torch.observe.trace import tracer
    except ImportError:
        return None
    read = getattr(tracer, "profiled_spans", None)
    if read is None:
        return None
    events = trace.host + trace.device
    lo = min(start for start, _, _ in events)
    hi = max(end for _, end, _ in events)
    spans = [s._replace(start_us=max(s.start_us, lo),
                        end_us=min(s.end_us, hi))
             for s in read() if s.end_us > lo and s.start_us < hi]
    return spans or None


def thread_of(spans, name):
    """The track id of the thread holding the most spans named
    ``name``, or None."""
    counts = {}
    for span in spans:
        if span.name == name:
            counts[span.tid] = counts.get(span.tid, 0) + 1
    return max(counts, key=counts.get) if counts else None


def union(intervals):
    """Sorted disjoint [start, end] lists covering ``intervals``."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        elif end > start:
            merged.append([start, end])
    return merged


def idle_seconds(trace, intervals):
    """The seconds of ``intervals`` (microseconds on the profiler's
    clock) in which no operation ran on the device: their union less
    its overlap with the union of the device's intervals, which the
    ``Trace`` merged once as it read them."""
    work = union(intervals)
    busy = trace._union
    total = sum(end - start for start, end in work)
    overlap, j = 0.0, 0
    for start, end in work:
        while j < len(busy) and busy[j][1] <= start:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < end:
            overlap += min(end, busy[k][1]) - max(start, busy[k][0])
            k += 1
    return (total - overlap) / 1e6


def host_idle_pct(ctx, anchor, keep):
    """The share of the window (%) in which the device was idle while
    the thread holding the ``anchor`` spans was in a span for which
    ``keep(name)`` holds; None without such spans."""
    spans = window_spans(ctx)
    if not spans:
        return None
    tid = thread_of(spans, anchor)
    if tid is None:
        return None
    work = [(s.start_us, s.end_us) for s in spans
            if s.tid == tid and keep(s.name)]
    if not work:
        return None
    return 100.0 * idle_seconds(ctx.trace, work) / ctx.window_s


def durations_ms(ctx, name):
    """The durations (ms) of the window's spans named ``name``, or
    None."""
    spans = window_spans(ctx)
    if not spans:
        return None
    out = [(s.end_us - s.start_us) / 1e3 for s in spans if s.name == name]
    return out or None
