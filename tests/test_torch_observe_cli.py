"""The port's ``summary``, ``baseline`` and observability command line
(veles_tpu_torch/observe/summary.py, baseline.py, __main__.py) against
the JAX package's on the same files, and the launcher's telemetry
flags through ``python -m veles_tpu_torch ... -d cpu``:

- ``summary.render`` / ``digest_line`` / ``request_digest_line`` give
  the JAX package's text on one serve trace (request-scoped spans from
  a ``ContinuousBatcher`` on the CPU), its flight dump and a heartbeat
  file;
- ``baseline.gate`` / ``render_report`` give JAX's verdicts and text on
  the same records, against a baseline written to ``tmp_path`` (never
  a committed file); the port's default baseline is its own file name;
- each ``python -m veles_tpu_torch.observe`` command (``merge``,
  ``summary``, ``requests``, ``fleet``, ``regress``) prints what the
  JAX package's prints on the same files, with the same exit code;
- ``--trace``, ``--metrics-interval``, ``--metrics-path``, ``--alerts``
  and ``--profile`` write a trace that passes ``validate_trace``,
  heartbeat lines that pass both packages' ``validate_heartbeat``, and
  a ``torch.profiler`` Chrome trace.
"""

import io
import json
import os
import subprocess
import sys

import numpy
import pytest

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch.observe import baseline, summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A serve trace with request-scoped spans, its flight dump, a
    heartbeat file and two hosts' series snapshots, made by the port."""
    from tests.test_torch_reqtrace import _engine
    from veles_tpu_torch.observe.flight import flight
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    from veles_tpu_torch.observe.profile import Heartbeat
    from veles_tpu_torch.observe.timeseries import SeriesRing
    from veles_tpu_torch.observe.trace import tracer
    from veles_tpu_torch.serve import ContinuousBatcher
    directory = tmp_path_factory.mktemp("observe_files")
    out = {}
    batcher = ContinuousBatcher(_engine(seed=21),
                                max_delay_s=0.002).start()
    tracer.start()
    try:
        x = numpy.zeros(16, numpy.float32)
        for i in range(10):
            req = batcher.submit(x, trace="cli-%d" % i)
            assert req.done.wait(10) and req.error is None
        with tracer.span("outer", cat="test"):
            with tracer.span("inner", cat="test"):
                pass
            tracer.counter("depth", 3)
            tracer.instant("marker", cat="test")
    finally:
        tracer.stop()
        batcher.stop()
    out["trace"] = tracer.save(str(directory / "serve_trace.json"))
    out["flight"] = flight.dump(reason="cli test",
                                path=str(directory / "flight.json"))
    reg = MetricsRegistry()
    heartbeat = Heartbeat(str(directory / "hb.jsonl"), registry=reg)
    for i in range(5):
        reg.counter("train.steps").inc(10)
        reg.counter("train.samples").inc(640)
        line = heartbeat.line()
        line["ts"] = 1000.0 + i
        if i == 4:
            line["alerts"]["history"] = [
                {"alert": "slo_burn.interactive", "state": "firing",
                 "ts": line["ts"]}]
        with open(heartbeat.path, "a") as fout:
            fout.write(json.dumps(line) + "\n")
    out["heartbeats"] = heartbeat.path
    for host, wall0, lat, reqs in (("h0", 1000.0, 0.010, 10),
                                   ("h1", 1500.0, 0.200, 30)):
        reg = MetricsRegistry()
        ring = SeriesRing(interval_s=1.0, registry=reg)
        ring.tick(now=0.0, wall=wall0)
        reg.counter("req").inc(reqs)
        reg.gauge("depth").set(reqs)
        for _ in range(20):
            reg.histogram("lat").observe(lat)
        ring.tick(now=1.0, wall=wall0 + 1.0)
        path = directory / ("%s.json" % host)
        path.write_text(json.dumps(ring.take_chunk(label=host)))
        out[host] = str(path)
    base = directory / "BASE.json"
    base.write_text(json.dumps({"schema": 1, "source": "test", "metrics": {
        "tflops": {"value": 100.0, "direction": "higher",
                   "tolerance_pct": 10.0},
        "p99_ms": {"value": 20.0, "direction": "lower",
                   "tolerance_pct": 10.0}}}))
    out["baseline"] = str(base)
    for name, record in (("good", {"tflops": 101.0, "p99_ms": 19.0}),
                         ("bad", {"tflops": 70.0, "p99_ms": 19.0})):
        path = directory / ("%s.json" % name)
        path.write_text(json.dumps(record))
        out[name] = str(path)
    return out


def _render(module, doc):
    buf = io.StringIO()
    module.render(module.summarize(doc, top=5), out=buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["trace", "flight", "heartbeats"])
def test_summary_text_equals_jax(files, kind):
    from veles_tpu.observe import summary as jax_summary
    doc = summary.load(files[kind])
    jax_doc = jax_summary.load(files[kind])
    assert doc == jax_doc
    text = _render(summary, doc)
    assert text == _render(jax_summary, jax_doc)
    assert text.startswith({"trace": "trace", "flight": "flight",
                            "heartbeats": "heartbeats"}[kind] + " digest")
    assert summary.digest_line(doc) == jax_summary.digest_line(jax_doc)
    assert summary.request_digest_line(doc) == \
        jax_summary.request_digest_line(jax_doc)
    if kind == "trace":
        assert "request segments: 10 requests" in \
            summary.request_digest_line(doc)


def test_summarize_heartbeats_reads_the_port_file(files):
    digest = summary.summarize(summary.load(files["heartbeats"]))
    assert digest["events"] == 5 and digest["invalid"] == 0
    assert digest["schemas"] == {3: 5}
    assert digest["rates"]["train.steps"] == pytest.approx(10.0)
    assert digest["alerts_fired"] == ["slo_burn.interactive"]


GATE_RECORDS = [
    {"tflops": 95.0, "p99_ms": 21.0},           # ok
    {"tflops": 85.0, "p99_ms": 19.0},           # higher-is-better drops
    {"tflops": 120.0, "p99_ms": 26.0},          # improved + regressed
    {"other": 1.0},                             # missing
    {"metric": "tflops", "value": 50.0},        # headline folding
]


@pytest.mark.parametrize("record", GATE_RECORDS)
def test_baseline_gate_and_report_equal_jax(files, record):
    from veles_tpu.observe import baseline as jax_baseline
    ok, report = baseline.gate(record, baseline_path=files["baseline"])
    jax_ok, jax_report = jax_baseline.gate(
        record, baseline_path=files["baseline"])
    assert (ok, report) == (jax_ok, jax_report)
    assert baseline.render_report(report) == \
        jax_baseline.render_report(jax_report)


def test_no_baseline_passes_and_names_the_ports_file(tmp_path,
                                                     monkeypatch):
    from veles_tpu.observe import baseline as jax_baseline
    monkeypatch.delenv("VELES_PERF_BASELINE", raising=False)
    assert baseline.DEFAULT_BASELINE == "PERF_BASELINE_TORCH.json"
    assert jax_baseline.DEFAULT_BASELINE == "PERF_BASELINE.json"
    absent = str(tmp_path / "absent.json")
    ok, report = baseline.gate({"tflops": 1.0}, baseline_path=absent)
    assert ok and report["status"] == "no_baseline"
    assert report == jax_baseline.gate({"tflops": 1.0},
                                       baseline_path=absent)[1]
    lines = baseline.render_report(report)
    assert lines == [line.replace("PERF_BASELINE.json",
                                  "PERF_BASELINE_TORCH.json")
                     for line in jax_baseline.render_report(report)]
    # the default never reaches the JAX package's committed baseline
    monkeypatch.chdir(tmp_path)
    assert os.path.basename(baseline._default_path()) == \
        "PERF_BASELINE_TORCH.json"
    assert baseline.load_baseline() is None
    monkeypatch.setenv("VELES_PERF_BASELINE", str(tmp_path / "mine.json"))
    assert baseline._default_path() == str(tmp_path / "mine.json")


def test_steady_state_rates_equal_jax():
    from veles_tpu.observe import baseline as jax_baseline

    def bucket(rate):
        return {"counters": {"req": {"delta": rate, "rate": rate}}}
    buckets = [bucket(0.0), bucket(0.0)] + [
        bucket(r) for r in (95.0, 100.0, 105.0, 98.0, 102.0)]
    rates = baseline.steady_state_rates(buckets)
    assert rates == jax_baseline.steady_state_rates(buckets)
    assert 90.0 <= rates["req.rate"] <= 110.0


def _cli(main, argv, capsys):
    code = main(argv)
    captured = capsys.readouterr()
    return code, captured.out


CLI_CASES = {
    "summary": lambda f, d: ["summary", f["trace"], "--top", "4"],
    "summary-flight": lambda f, d: ["summary", f["flight"]],
    "summary-heartbeats": lambda f, d: ["summary", f["heartbeats"]],
    "requests": lambda f, d: ["requests", f["trace"], "--top", "3"],
    "fleet": lambda f, d: ["fleet", f["h0"], f["h1"], "--offset",
                           "h1=-500", "--rules"],
    "fleet-json": lambda f, d: ["fleet", f["h0"], f["h1"], "--json"],
    "regress-ok": lambda f, d: ["regress", f["good"], "--baseline",
                                f["baseline"]],
    "regress-bad": lambda f, d: ["regress", f["bad"], f["trace"],
                                 "--baseline", f["baseline"]],
    "regress-json": lambda f, d: ["regress", f["bad"], "--baseline",
                                  f["baseline"], "--json"],
    "merge": lambda f, d: ["merge", "-o", str(d / "merged.json"),
                           f["trace"], f["trace"], "--offset",
                           "b=0.5"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_observe_cli_prints_what_jax_prints(files, case, capsys,
                                            tmp_path):
    from veles_tpu.observe.__main__ import main as jax_main
    from veles_tpu_torch.observe.__main__ import main
    argv = CLI_CASES[case](files, tmp_path)
    code, out = _cli(main, argv, capsys)
    if case == "merge":
        ours = json.loads((tmp_path / "merged.json").read_text())
    jax_code, jax_out = _cli(jax_main, argv, capsys)
    assert (code, out) == (jax_code, jax_out)
    assert out
    if case == "merge":
        theirs = json.loads((tmp_path / "merged.json").read_text())
        # the one difference: each names its own merge tool
        assert ours["otherData"].pop("tool") == \
            "veles_tpu_torch.observe.merge"
        assert theirs["otherData"].pop("tool") == "veles_tpu.observe.merge"
        assert ours == theirs
    if case.startswith("regress"):
        assert code == (0 if case == "regress-ok" else 1)


def test_observe_cli_runs_as_a_module(files):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.observe", "summary",
         files["trace"]], capture_output=True, text=True, timeout=120,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("trace digest:")
    assert "jax" not in proc.stderr


_FUSED = """

_unfused_build = build


def build(launcher):
    workflow = _unfused_build(launcher)
    workflow.fuse(pipeline=True)
    return workflow
"""


def test_launcher_flags_write_trace_heartbeat_and_profile(tmp_path):
    from tests.test_torch_cli import _WF
    from veles_tpu.observe.profile import \
        validate_heartbeat as jax_validate
    from veles_tpu_torch.observe.profile import validate_heartbeat
    from veles_tpu_torch.observe.trace import validate_trace
    wf = tmp_path / "observe_cli_workflow.py"
    # the CPU fuses only when asked: fuse with the input pipeline
    wf.write_text(_WF + _FUSED)
    trace = str(tmp_path / "run_trace.json")
    beats = str(tmp_path / "beats.jsonl")
    prof = str(tmp_path / "prof")
    env = dict(os.environ, PYTHONPATH=ROOT, VELES_PROFILE_WINDOW="1:3")
    env.pop("VELES_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", str(wf), "-", "-d", "cpu",
         "--trace", trace, "--metrics-interval", "0.1", "--metrics-path",
         beats, "--alerts", "--profile", prof,
         "root.cli_test.max_epochs=3"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(trace) as fin:
        doc = json.load(fin)
    validate_trace(doc)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"fused.train_step", "fused.eval_step", "FusedTrainer",
            "pipeline.fill", "pipeline.h2d", "pipeline.wait"} <= names
    assert any(name.endswith(".run") for name in names)
    with open(beats) as fin:
        lines = [json.loads(line) for line in fin if line.strip()]
    assert lines
    for record in lines:
        validate_heartbeat(record)
        jax_validate(record)
    last = lines[-1]
    assert last["counters"]["train.steps"] == 9
    assert last["counters"]["train.samples"] == 9 * 32
    assert last["epoch"] == 3 and last["workflow"] == "StandardWorkflow"
    assert last["health"]["skip_count"] == 0
    assert isinstance(last["mfu_pct"], float) and last["mfu_pct"] > 0
    assert last["gauges"]["xla.step_flops"] > 0
    assert last["gauges"]["xla.mem.live_bytes"] > 0
    assert len(last["alerts"]["history"]) == 0
    assert last["series"]["schema"] >= 1
    traces = [name for name in os.listdir(prof) if name.endswith(".json")]
    assert len(traces) == 1, proc.stderr[-3000:]
    with open(os.path.join(prof, traces[0])) as fin:
        assert json.load(fin)["traceEvents"]
