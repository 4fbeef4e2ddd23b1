"""The trace reader on a made-up profile: the busy time is the union of
the device intervals, kernels are matched by name, and an idle gap is
named by the shortest host event around its middle."""

import pytest
from torch.autograd import DeviceType

from portbench.trace import Trace, matching_seconds


class Event(object):
    def __init__(self, name, start_us, dur_us, device):
        self._args = (name, start_us, dur_us, device)

    def name(self):
        return self._args[0]

    def start_ns(self):
        return int(self._args[1] * 1000)

    def duration_ns(self):
        return int(self._args[2] * 1000)

    def device_type(self):
        return DeviceType.CUDA if self._args[3] else DeviceType.CPU


class Profile(object):
    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def trace():
    return Trace(Profile([
        Event("wgrad_tc_kernel<128>", 0, 100, True),
        Event("fprop", 50, 100, True),        # overlaps on another stream
        Event("wgrad_tc_kernel<64>", 400, 50, True),
        Event("Memcpy HtoD", 1000, 10, True),
        Event("step", 0, 2000, False),
        Event("cudaGraphLaunch", 200, 150, False),
    ]))


def test_busy_is_the_union_of_the_device_intervals():
    assert trace().busy_s == pytest.approx((150 + 50 + 10) / 1e6)


def test_kernels_are_matched_by_name():
    seconds, launches = matching_seconds(trace(), ("wgrad_tc_kernel",))
    assert launches == 2 and seconds == pytest.approx(150 / 1e6)


def test_breakdown_and_idle_gaps():
    out = trace().breakdown(top=2)
    assert out["device_ops"][0] == ["wgrad_tc_kernel<128>",
                                    pytest.approx(1e-4)]
    assert len(out["device_ops"]) == 2
    assert out["idle_gaps"][0] == ["step", pytest.approx(550 / 1e6)]
    assert out["idle_gaps"][1] == ["cudaGraphLaunch",
                                   pytest.approx(250 / 1e6)]
