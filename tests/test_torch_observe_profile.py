"""The port's profiler hook and heartbeat
(veles_tpu_torch/observe/profile.py) on the CPU, as tests/test_observe.py
and tests/test_telemetry.py hold the JAX package's:

- the ``ProfilerHook`` window accounting (a recording fake profiler),
  its environment window, and a real ``torch.profiler`` window on the
  CPU writing a Chrome trace that parses;
- heartbeat lines: periodic plus a last one, strict JSON under NaN,
  schema v3 with the telemetry blocks and v2 still readable, and a
  port line passes the JAX package's ``validate_heartbeat`` while a JAX
  line passes the port's (both ways on the same records);
- the introspection refresh is gated as in JAX: a heartbeat with no
  compile and no step FLOPs carries no ``compile`` block.
"""

import json
import time

import pytest

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe.profile import (HEARTBEAT_SCHEMA_VERSION,
                                             HEARTBEAT_SCHEMAS, Heartbeat,
                                             ProfilerHook,
                                             validate_heartbeat)


class FakeProfiler(object):
    def __init__(self, calls):
        self.calls = calls

    def stop(self):
        self.calls.append(("stop", None))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))


def test_profiler_hook_window_accounting(monkeypatch, tmp_path):
    calls = []

    def start():
        calls.append(("start", None))
        return FakeProfiler(calls)
    logdir = str(tmp_path / "prof")
    hook = ProfilerHook(logdir, start_step=2, stop_step=4)
    monkeypatch.setattr(hook, "start_profiler", start)
    states = []
    for _ in range(10):
        hook.step()
        states.append(hook.state)
    assert states[:2] == ["idle", "idle"]
    assert states[2:4] == ["tracing", "tracing"]
    assert states[4:] == ["done"] * 6
    assert [c[0] for c in calls] == ["start", "stop", "export"]
    assert calls[-1][1].startswith(logdir) and hook.trace_path == calls[-1][1]
    hook.stop()  # idempotent
    assert len(calls) == 3


def test_profiler_hook_that_cannot_start_never_retries(monkeypatch,
                                                       tmp_path):
    calls = []

    def broken():
        calls.append("start")
        raise RuntimeError("no profiler here")
    hook = ProfilerHook(str(tmp_path), start_step=0, stop_step=5)
    monkeypatch.setattr(hook, "start_profiler", broken)
    for _ in range(5):
        hook.step()
    assert hook.state == "done" and calls == ["start"]


def test_profiler_hook_env_window(monkeypatch, tmp_path):
    monkeypatch.setenv("VELES_PROFILE", str(tmp_path))
    monkeypatch.setenv("VELES_PROFILE_WINDOW", "7:9")
    hook = ProfilerHook.from_env()
    assert hook.logdir == str(tmp_path)
    assert (hook.start_step, hook.stop_step) == (7, 9)
    monkeypatch.setenv("VELES_PROFILE_WINDOW", "junk")
    assert (ProfilerHook.from_env().start_step,
            ProfilerHook.from_env().stop_step) == (5, 25)
    monkeypatch.delenv("VELES_PROFILE")
    assert ProfilerHook.from_env() is None


def test_torch_profiler_window_writes_a_chrome_trace(tmp_path):
    import torch
    from veles_tpu_torch.observe import profile
    hook = profile.install_profiler(
        ProfilerHook(str(tmp_path / "prof"), start_step=1, stop_step=3))
    try:
        x = torch.ones(64, 64)
        for _ in range(5):
            torch.matmul(x, x)
            profile.profiler_step()
    finally:
        assert profile.uninstall_profiler() is hook
    assert hook.state == "done" and hook.trace_path
    with open(hook.trace_path) as fin:
        doc = json.load(fin)
    names = {event.get("name") for event in doc["traceEvents"]}
    assert any("mm" in str(name) for name in names)
    profile.profiler_step()  # no hook: a None check


def _port_registry():
    reg = MetricsRegistry()
    reg.counter("train.samples").inc(640)
    reg.counter("train.steps").inc(10)
    reg.histogram("step.train_s").observe(0.01)
    reg.gauge("health.skip_count").set(0)
    return reg


def test_heartbeat_lines_validate_in_both_packages(tmp_path):
    from veles_tpu.observe.profile import \
        validate_heartbeat as jax_validate
    reg = _port_registry()
    path = str(tmp_path / "hb.jsonl")
    heartbeat = Heartbeat(path, interval=0.05, registry=reg).start()
    time.sleep(0.2)
    reg.counter("train.samples").inc(640)
    heartbeat.stop()
    with open(path) as fin:
        lines = [json.loads(line) for line in fin if line.strip()]
    assert len(lines) >= 2
    for record in lines:
        validate_heartbeat(record)
        jax_validate(record)
        assert record["schema"] == HEARTBEAT_SCHEMA_VERSION == 3
    assert lines[-1]["counters"]["train.samples"] == 1280
    assert lines[-1]["health"] == {"skip_count": 0}
    assert "step.train_s" in lines[-1]["histograms"]
    assert any("throughput_sps" in record for record in lines)
    # nothing compiled and no step FLOPs: no introspection block
    assert all("compile" not in record for record in lines)


def test_jax_heartbeat_lines_pass_the_port_validator(tmp_path):
    from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from veles_tpu.observe.profile import Heartbeat as JaxHeartbeat
    reg = JaxRegistry()
    reg.counter("train.samples").inc(64)
    reg.histogram("step.train_s").observe(0.02)
    line = JaxHeartbeat(str(tmp_path / "j.jsonl"), registry=reg).line()
    assert validate_heartbeat(json.loads(json.dumps(line))) is not None
    v2 = dict(line)
    v2["schema"] = 2
    v2.pop("series")
    v2.pop("alerts")
    assert validate_heartbeat(v2)["schema"] == 2


def test_heartbeat_schemas_match_jax():
    from veles_tpu.observe import profile as jax_profile
    assert HEARTBEAT_SCHEMAS == jax_profile.HEARTBEAT_SCHEMAS
    assert HEARTBEAT_SCHEMA_VERSION == jax_profile.HEARTBEAT_SCHEMA_VERSION


def test_heartbeat_stays_strict_json_under_nan(tmp_path):
    reg = MetricsRegistry()
    reg.gauge("metric.train").set(float("nan"))
    reg.histogram("step.train_s").observe(0.01)

    class FakeDecision(object):
        epoch_number = 1
        epoch_metrics = [None, float("nan"), 2.0]

    class FakeWorkflow(object):
        decision = FakeDecision()

    path = str(tmp_path / "nan_hb.jsonl")
    heartbeat = Heartbeat(path, interval=60, registry=reg,
                          workflow=FakeWorkflow())
    heartbeat.write_line()
    raw = open(path).read()
    assert "NaN" not in raw and "Infinity" not in raw
    record = json.loads(raw)
    validate_heartbeat(record)
    assert record["gauges"]["metric.train"] is None
    assert record["metrics"] == [None, None, 2.0]
    assert record["epoch"] == 1 and record["workflow"] == "FakeWorkflow"


def test_heartbeat_v2_stays_readable_and_v3_is_enforced(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.jsonl"), registry=MetricsRegistry())
    v2 = hb.line()
    v2["schema"] = 2
    v2.pop("series")
    v2.pop("alerts")
    assert validate_heartbeat(v2)["schema"] == 2
    v3 = hb.line()
    v3.pop("series")
    with pytest.raises(ValueError, match="series"):
        validate_heartbeat(v3)
    bad = hb.line()
    bad["schema"] = 99
    with pytest.raises(ValueError, match="schema"):
        validate_heartbeat(bad)


@pytest.mark.parametrize("record,match", [
    ([], "not an object"),
    ({"kind": "heartbeat"}, "missing"),
])
def test_validate_heartbeat_rejects_malformed(record, match):
    with pytest.raises(ValueError, match=match):
        validate_heartbeat(record)


def test_heartbeat_carries_compile_memory_and_mfu_once_compiled(
        tmp_path, monkeypatch):
    import numpy
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.observe import introspect
    keep = Array(numpy.ones(1000, numpy.float32))  # in the census
    keep.device_array(Device(backend="cpu"))
    monkeypatch.setenv("VELES_PEAK_TFLOPS", "1")
    monkeypatch.setattr(introspect, "_peak_cache", {})
    reg = MetricsRegistry()
    introspect.note_capture("probe", 0.5, reg)
    introspect.set_step_flops(2e10, reg)
    for _ in range(4):
        reg.histogram("step.train_s").observe(0.04)
    line = Heartbeat(str(tmp_path / "hb.jsonl"), registry=reg).line()
    validate_heartbeat(line)
    assert line["compile"]["captures"] == 1
    assert line["compile"]["count"] == 1
    assert line["mfu_pct"] == pytest.approx(50.0)
    assert line["gauges"]["xla.mfu_pct"] == pytest.approx(50.0)
    assert line["gauges"]["xla.mem.live_bytes"] >= keep.mem.nbytes
