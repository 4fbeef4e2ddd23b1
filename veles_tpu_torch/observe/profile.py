"""Profiler hooks and the periodic JSONL heartbeat.

Counterpart of ``veles_tpu/observe/profile.py``:

- :class:`ProfilerHook` runs ``torch.profiler`` (CPU activities, and
  CUDA ones where a card is present) around a window of fused train
  steps and writes its Chrome trace into a directory
  (``VELES_PROFILE=dir`` enables it from the environment,
  ``VELES_PROFILE_WINDOW=start:stop`` picks the window, default 5:25:
  past the captures, so the trace shows steady state, and short, so
  the file stays small).  The per-step call (:func:`profiler_step`) is
  a module-global None check when no hook is installed.  The trace
  carries the program's own spans of the window beside the profiler's
  events (:func:`add_spans_to_chrome_trace`): every thread's, the
  batcher's worker and the input pipeline's included, whose ranges the
  profiler does not record, on the profiler's clock and each on its
  thread's track;
- :class:`Heartbeat` appends one JSON line every ``interval`` seconds
  (``--metrics-interval N`` / ``--metrics-path PATH``): the registry's
  snapshot, the health counters, the decision's epoch and metrics, and
  the samples/s derived from ``train.samples``.  The line is the JAX
  package's, schema for schema, so either package's
  :func:`validate_heartbeat` and ``observe summary`` read either's
  files.
"""

import json
import logging
import math
import os
import threading
import time

from veles_tpu_torch.observe.metrics import health_snapshot
from veles_tpu_torch.observe.metrics import registry as _registry

__all__ = ["ProfilerHook", "install_profiler", "uninstall_profiler",
           "profiler_step", "add_spans_to_chrome_trace", "Heartbeat",
           "validate_heartbeat",
           "HEARTBEAT_SCHEMA_VERSION", "HEARTBEAT_SCHEMAS"]

HEARTBEAT_SCHEMA_VERSION = 3

_logger = logging.getLogger("profile")

#: schemas :func:`validate_heartbeat` accepts: v2 (before the telemetry
#: plane) and v3 (with the ``series`` and ``alerts`` blocks)
HEARTBEAT_SCHEMAS = (2, 3)


def _start_profiler():
    """A started ``torch.profiler.profile`` over the CPU and, where a
    card is present, CUDA activities."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def add_spans_to_chrome_trace(path, spans):
    """Write ``spans`` (``observe.trace.ProfiledSpan``, on the
    profiler's clock) into the Chrome trace ``torch.profiler`` exported
    to ``path``: complete events of this process on their threads'
    tracks, by native thread id (the profiler's own track of a thread
    it recorded operators on; a thread it did not, or a request track,
    gets a track named after it), their ids, parents and sequence
    numbers in ``args``.  Returns the number written."""
    if not spans:
        return 0
    with open(path) as fin:
        doc = json.load(fin)
    events = doc.setdefault("traceEvents", [])
    # the exporter writes microseconds past baseTimeNanoseconds
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    pid = os.getpid()
    named = {event.get("tid") for event in events
             if event.get("ph") == "M" and event.get("name") ==
             "thread_name" and event.get("pid") == pid}
    for span in spans:
        tid = span.tid
        if tid not in named:
            named.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": span.thread or str(tid)}})
        args = dict(span.args or ())
        for key, value in (("span_id", span.id), ("parent", span.parent),
                           ("seq", span.seq)):
            if value is not None:
                args[key] = value
        events.append({"ph": "X", "name": span.name, "cat": span.cat,
                       "pid": pid, "tid": tid,
                       "ts": span.start_us - base_us,
                       "dur": max(0.0, span.end_us - span.start_us),
                       "args": args})
    tmp = path + ".tmp"
    with open(tmp, "w") as fout:
        json.dump(doc, fout)
    os.replace(tmp, path)
    return len(spans)


class ProfilerHook(object):
    """Drive ``torch.profiler`` around a window of train steps."""

    #: makes and starts a profiler; tests swap in a recording fake
    start_profiler = staticmethod(_start_profiler)

    def __init__(self, logdir, start_step=None, stop_step=None):
        if start_step is None or stop_step is None:
            env_start, env_stop = self._window_from_env()
            start_step = env_start if start_step is None else start_step
            stop_step = env_stop if stop_step is None else stop_step
        self.logdir = logdir
        self.start_step = max(0, int(start_step))
        self.stop_step = max(self.start_step + 1, int(stop_step))
        self.steps = 0
        self.state = "idle"  # -> "tracing" -> "done"
        #: the Chrome trace written at the window's end, once it is
        self.trace_path = None
        self._profiler = None
        self._window = None   # perf_counter readings at start and stop

    @staticmethod
    def _window_from_env(environ=None):
        environ = environ if environ is not None else os.environ
        window = environ.get("VELES_PROFILE_WINDOW", "")
        try:
            start, stop = window.split(":", 1)
            return int(start), int(stop)
        except ValueError:
            return 5, 25

    @classmethod
    def from_env(cls, environ=None):
        """A hook when ``VELES_PROFILE`` names a directory, else None."""
        environ = environ if environ is not None else os.environ
        logdir = environ.get("VELES_PROFILE", "")
        if not logdir:
            return None
        start, stop = cls._window_from_env(environ)
        return cls(logdir, start, stop)

    def step(self):
        """Account one train step; start or stop the profiler at the
        window's edges.  One int compare in between."""
        self.steps += 1
        if self.state == "idle" and self.steps > self.start_step:
            self._start()
        elif self.state == "tracing" and self.steps > self.stop_step:
            self.stop()

    def _start(self):
        try:
            os.makedirs(self.logdir, exist_ok=True)
            self._profiler = self.start_profiler()
            self._window = [time.perf_counter(), None]
        except Exception as exc:
            # a profiler that cannot start must never stop training;
            # "done" also ends the per-step retries
            self.state = "done"
            _logger.warning("profiler did not start (%s: %s)",
                            type(exc).__name__, exc)
            return
        self.state = "tracing"

    def stop(self):
        """Idempotent: stop tracing and write the Chrome trace if the
        window is still open."""
        if self.state != "tracing":
            self.state = "done"
            return
        self.state = "done"
        profiler, self._profiler = self._profiler, None
        try:
            self._window[1] = time.perf_counter()
            profiler.stop()
            path = os.path.join(self.logdir, "veles_profile.%d.%d.json" % (
                os.getpid(), int(time.time())))
            profiler.export_chrome_trace(path)
            self.trace_path = path
        except Exception as exc:
            _logger.warning("profiler trace not written (%s: %s)",
                            type(exc).__name__, exc)
            return
        try:
            add_spans_to_chrome_trace(path, self.window_spans())
        except Exception as exc:
            _logger.warning("the program's spans not added to %s (%s: %s)",
                            path, type(exc).__name__, exc)

    def window_spans(self):
        """The tracer's spans (``observe.trace.ProfiledSpan``) that
        overlap this hook's window, once it has closed."""
        from veles_tpu_torch.observe.trace import tracer
        if self._window is None or self._window[1] is None:
            return []
        lo, hi = (tracer.profiler_ns(t) / 1e3 for t in self._window)
        return [span for span in tracer.profiled_spans()
                if span.end_us >= lo and span.start_us <= hi]


_hook = None
_hook_lock = threading.Lock()


def install_profiler(hook):
    """Make ``hook`` the process profiler (stopping any previous one)."""
    global _hook
    with _hook_lock:
        previous, _hook = _hook, hook
    if previous is not None:
        previous.stop()
    return hook


def uninstall_profiler():
    global _hook
    with _hook_lock:
        hook, _hook = _hook, None
    if hook is not None:
        hook.stop()
    return hook


def profiler_step():
    """Per-train-step tick (the fused trainer calls it); a plain None
    check when no profiler is installed."""
    hook = _hook
    if hook is not None:
        hook.step()


# -- heartbeat ---------------------------------------------------------------

#: required keys -> allowed types of one heartbeat line (schema v2 on):
#: both clocks, ``ts`` (wall, comparable across hosts) and ``mono``
_HEARTBEAT_REQUIRED = {
    "kind": str, "schema": int, "ts": (int, float),
    "mono": (int, float), "elapsed_s": (int, float), "session": str,
    "counters": dict, "gauges": dict, "histograms": dict, "health": dict,
}


def _jsonsafe(value):
    """Replace non-finite floats with None, recursively: a bare NaN
    token is not RFC-8259 JSON."""
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, dict):
        return {key: _jsonsafe(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonsafe(item) for item in value]
    return value


def validate_heartbeat(record):
    """Schema check of one parsed heartbeat line; raises ValueError."""
    if not isinstance(record, dict):
        raise ValueError("heartbeat line is not an object")
    for key, types in _HEARTBEAT_REQUIRED.items():
        if key not in record:
            raise ValueError("heartbeat missing %r" % key)
        if not isinstance(record[key], types):
            raise ValueError("heartbeat %r has type %s" %
                             (key, type(record[key]).__name__))
    if record["kind"] != "heartbeat":
        raise ValueError("kind must be 'heartbeat'")
    if record["schema"] not in HEARTBEAT_SCHEMAS:
        raise ValueError("unknown heartbeat schema %r" % record["schema"])
    if record["schema"] >= 3:
        for key in ("series", "alerts"):
            if not isinstance(record.get(key), dict):
                raise ValueError(
                    "schema 3 heartbeat needs a %r block" % key)
        if "schema" not in record["series"]:
            raise ValueError("series block lacks a schema")
    if "mfu_pct" in record and record["mfu_pct"] is not None and \
            not isinstance(record["mfu_pct"], (int, float)):
        raise ValueError("mfu_pct must be numeric or null")
    if "compile" in record and not isinstance(record["compile"], dict):
        raise ValueError("compile block must be an object")
    for name, hist in record["histograms"].items():
        if not isinstance(hist, dict) or "count" not in hist:
            raise ValueError("histogram %r lacks a count" % name)
    return record


class Heartbeat(object):
    """Append one status JSON line to ``path`` every ``interval`` s on
    a daemon thread, and a last one at stop."""

    def __init__(self, path, interval=5.0, workflow=None, registry=None):
        self.path = path
        self.interval = max(0.05, float(interval))
        self.workflow = workflow
        self.registry = registry if registry is not None else _registry
        self._stop = threading.Event()
        self._thread = None
        self._t0 = time.monotonic()
        self._last_sample = (self._t0, self._samples())

    def _samples(self):
        counter = self.registry.peek("train.samples")
        return counter.value if counter is not None else 0

    def line(self):
        """One heartbeat record (plain data)."""
        from veles_tpu_torch import logger
        now = time.monotonic()
        # introspection refreshes first, so this line carries this
        # tick's recompiles, memory and MFU; only in a run that
        # compiled or stepped something, so a unit test's heartbeat
        # touches no device
        intro = None
        mfu = None
        if self.registry.peek("compile.count") is not None or \
                self.registry.peek("xla.step_flops") is not None:
            try:
                from veles_tpu_torch.observe import introspect as intro
                intro.poll_recompiles()
                intro.device_memory_gauges(self.registry)
                mfu = intro.mfu_snapshot(self.registry)
            except Exception:
                intro = None
        snap = self.registry.snapshot()
        record = {
            "kind": "heartbeat",
            "schema": HEARTBEAT_SCHEMA_VERSION,
            "ts": time.time(),
            "mono": now,
            "elapsed_s": round(now - self._t0, 3),
            "session": logger.session_id,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": snap["histograms"],
            "health": health_snapshot(self.registry),
        }
        if intro is not None:
            record["compile"] = intro.compile_snapshot(self.registry)
            record["mfu_pct"] = mfu
        # the telemetry plane rides the heartbeat's cadence: tick the
        # series ring at this line's wall stamp, evaluate the alert
        # rules over it, embed the compact v3 blocks
        try:
            from veles_tpu_torch.observe.alerts import alerts
            from veles_tpu_torch.observe.timeseries import series
            series.maybe_tick(now=now, wall=record["ts"])
            if alerts.rules:
                alerts.evaluate(series.buckets(last=32),
                                wall=record["ts"])
            record["series"] = series.heartbeat_block()
            record["alerts"] = alerts.snapshot(history=4)
        except Exception:
            record["series"] = {"schema": 0}
            record["alerts"] = {"schema": 0, "active": [],
                                "firing": [], "fired_total": 0,
                                "history": []}
        last_t, last_samples = self._last_sample
        samples = self._samples()
        if now > last_t:
            record["throughput_sps"] = round(
                (samples - last_samples) / (now - last_t), 3)
        self._last_sample = (now, samples)
        workflow = self.workflow
        if workflow is not None:
            record["workflow"] = type(workflow).__name__
            decision = getattr(workflow, "decision", None)
            if decision is not None:
                epoch = getattr(decision, "epoch_number", None)
                if epoch is not None:
                    record["epoch"] = int(epoch)
                record["metrics"] = getattr(
                    decision, "epoch_metrics", None)
        return record

    def write_line(self):
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        record = _jsonsafe(self.line())
        with open(self.path, "a") as fout:
            fout.write(json.dumps(record, default=repr,
                                  allow_nan=False) + "\n")
        # the flight ring keeps a condensed copy for post-mortems
        from veles_tpu_torch.observe.flight import flight
        if flight.enabled:
            flight.record(
                "heartbeat", "heartbeat", wall=record.get("ts"),
                args={key: record.get(key) for key in
                      ("elapsed_s", "throughput_sps", "epoch",
                       "health", "mfu_pct", "compile")
                      if record.get(key) is not None})

    def _loop(self):
        try:
            while not self._stop.wait(self.interval):
                try:
                    self.write_line()
                except OSError:
                    pass  # a full disk must not take training down
        finally:
            try:
                self.write_line()  # the last state, even of short runs
            except OSError:
                pass

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="heartbeat")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
