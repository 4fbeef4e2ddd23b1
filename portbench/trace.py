"""Reading a ``torch.profiler`` trace of the measured window: the
device's activity intervals (kernels, copies, sets), the time the
device was busy (the union of those intervals, so overlapping streams
count once), device time by operation name, and the longest idle gaps
with what the host was doing then.
"""

import collections

from torch.autograd import DeviceType

__all__ = ["Trace", "matching_seconds"]


class Trace(object):
    """The device intervals of one profiled window (microseconds on the
    profiler's clock) and the host events around them, read from the
    profiler's raw events (its tree of function events is never built:
    a window holds hundreds of thousands of kernels)."""

    def __init__(self, prof):
        self.device = []   # (start_us, end_us, name)
        self.host = []     # (start_us, end_us, name)
        for evt in prof.profiler.kineto_results.events():
            start = evt.start_ns() / 1e3
            item = (start, start + evt.duration_ns() / 1e3, evt.name())
            if evt.device_type() == DeviceType.CUDA:
                if item[1] > item[0]:
                    self.device.append(item)
            else:
                self.host.append(item)
        self.device.sort()
        self._union = self._merge()

    def _merge(self):
        merged = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                if end > merged[-1][1]:
                    merged[-1][1] = end
            else:
                merged.append([start, end])
        return merged

    @property
    def busy_s(self):
        return sum(end - start for start, end in self._union) / 1e6

    def by_name(self):
        """{name: device seconds}, summed over its intervals."""
        out = collections.defaultdict(float)
        for start, end, name in self.device:
            out[name] += (end - start) / 1e6
        return dict(out)

    def idle_gaps(self, top=10):
        """The ``top`` longest gaps between device activity, each named
        by the shortest host event that spans its middle."""
        gaps = []
        for (_, end), (start, _) in zip(self._union, self._union[1:]):
            gaps.append((start - end, end, start))
        gaps.sort(reverse=True)
        out = []
        for length, lo, hi in gaps[:top]:
            mid = (lo + hi) / 2.0
            spans = [(e - s, n) for s, e, n in self.host if s <= mid <= e]
            name = min(spans)[1] if spans else "(no host event)"
            out.append([name, length / 1e6])
        return out

    def breakdown(self, top=10):
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps(top)]}


def matching_seconds(trace, fragments):
    """(device seconds, launches) of the intervals whose name holds any
    of ``fragments``."""
    seconds, launches = 0.0, 0
    for start, end, name in trace.device:
        if any(frag in name for frag in fragments):
            seconds += (end - start) / 1e6
            launches += 1
    return seconds, launches
