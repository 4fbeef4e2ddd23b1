"""Span tracer: Chrome trace-event JSON, viewable in Perfetto.

Counterpart of ``veles_tpu/observe/trace.py``, whole and stdlib-only:
the event, chunk and document schemas are the JAX package's, so its
``validate_trace`` accepts this module's documents.  A span is host
time: it brackets host calls and never synchronizes the card, so a
span around an asynchronous launch measures the enqueue, and the wait
lands in whichever later span makes the host copy.

Records *complete* events ("ph": "X") with microsecond timestamps on a
``time.perf_counter`` base — the same clock the unit/pipeline timers
use, so a span's ``dur`` agrees with the accumulated timer it rides on.
Each thread gets its own track (a ``thread_name`` metadata event is
emitted on first sight), so the prefetch worker's fill/H2D spans render
on a separate lane from the graph thread's unit-run spans and the
overlap is visible directly.

Design rules:

- **zero overhead when disabled**: ``tracer.enabled`` is a plain bool;
  hot call sites guard on it (one attribute load) and every public
  method returns immediately when tracing is off.  ``span()`` returns
  a shared no-op context manager;
- **no locks on the hot path**: event dicts are appended to a plain
  list (``list.append`` is atomic under the GIL); the lock guards only
  start/save and first-sight thread registration;
- **bounded memory**: past ``max_events`` new events are counted as
  dropped instead of growing the buffer without bound.

The module-level :data:`tracer` singleton is the instance the whole
system instruments against; ``tracer.start()`` begins a recording and
``tracer.save(path)`` writes it.
"""

import functools
import json
import os
import threading
import time

from veles_tpu_torch.observe.flight import flight as _global_flight

__all__ = ["SpanTracer", "tracer", "span", "instant", "traced",
           "validate_trace", "CHUNK_SCHEMA_VERSION"]

#: schema of the bounded trace chunks slaves ship to the master
#: (observe/cluster.py collects them, observe/merge.py stitches them)
CHUNK_SCHEMA_VERSION = 1


class _NullSpan(object):
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span(object):
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_start")

    def __init__(self, owner, name, cat, args):
        self._tracer = owner
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(
            self._name, self._start, time.perf_counter() - self._start,
            cat=self._cat, args=self._args)
        return False


class SpanTracer(object):
    """Thread-safe trace-event recorder with a Perfetto-loadable dump."""

    def __init__(self, max_events=1000000, flight=None, label=None):
        self.enabled = False
        self.dropped = 0
        #: process/track label used by cross-process merge (e.g.
        #: "master" / "slave:<mid>"); defaults to pid at merge time
        self.label = label
        self._max_events = max_events
        self._events = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        # wall-clock anchor taken at the SAME instant as the
        # perf_counter epoch: event ts (µs since epoch) + this anchor
        # maps any event onto the wall clock, which is what cross-host
        # trace merging needs (offset-corrected wall time is the only
        # shared timeline two processes have)
        self._epoch_wall = time.time()
        self._pid = os.getpid()
        self._tids = {}
        self._tid_names = {}
        self._flight = flight if flight is not None else _global_flight

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Clear any previous events and begin recording."""
        with self._lock:
            self._events = []
            self._tids = {}
            self._tid_names = {}
            self.dropped = 0
            self._epoch = time.perf_counter()
            self._epoch_wall = time.time()
            self.enabled = True
        return self

    def stop(self):
        self.enabled = False
        return self

    @property
    def active(self):
        """True when an instrumented site should call in: full tracing
        is on, OR the always-on flight recorder wants the event.  Hot
        sites guard on this instead of ``enabled`` so the flight ring
        stays populated in ordinary (untraced) runs."""
        return self.enabled or self._flight.enabled

    @property
    def events(self):
        return list(self._events)

    def wall_time(self, when):
        """Map a perf_counter reading onto the wall clock via the
        start() anchor (cross-process correlation currency)."""
        return self._epoch_wall + (when - self._epoch)

    # -- recording ---------------------------------------------------------

    def _tid(self):
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            name = threading.current_thread().name
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[ident] = tid
                    self._tid_names[tid] = name
            self._append({
                "name": "thread_name", "ph": "M", "pid": self._pid,
                "tid": tid, "args": {"name": name}})
        return tid

    def tids_for(self, idents):
        """Map thread idents -> this tracer's track ids (idents never
        seen record no events, so they are simply absent)."""
        return {self._tids[i] for i in idents if i in self._tids}

    def request_track(self, key, label):
        """Allocate (or reuse) a dedicated track for one request leg
        (observe/requests.py).  Request-scoped spans cannot share the
        recording thread's track: one batch completes many requests
        whose queue spans overlap without nesting, and one hedged
        request's legs run concurrently — each leg gets its own lane,
        keyed by an arbitrary hashable (id, leg discriminator) and
        labeled with the request id so legs group visually."""
        key = ("req", key)
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.get(key)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[key] = tid
                    self._tid_names[tid] = label
            self._append({
                "name": "thread_name", "ph": "M", "pid": self._pid,
                "tid": tid, "args": {"name": label}})
        return tid

    def _append(self, event):
        if len(self._events) >= self._max_events:
            self.dropped += 1
            return
        self._events.append(event)

    def _ts(self, when):
        return (when - self._epoch) * 1e6

    def complete(self, name, start, dur, cat="span", args=None,
                 tid=None):
        """Record a complete ("X") event from perf_counter timings —
        the primitive every instrumented timer calls, so the trace and
        the accumulated timers always report the SAME measurement.
        Always feeds the flight recorder's ring (compact tuple, no
        serialization) so post-mortem dumps work without ``--trace``.
        ``tid`` overrides the recording thread's track — request-
        scoped spans land on their :meth:`request_track` lane."""
        flt = self._flight
        if flt.enabled:
            flt.record("span", name, cat, self.wall_time(start), dur,
                       args)
        if not self.enabled:
            return
        event = {"name": name, "cat": cat, "ph": "X",
                 "ts": self._ts(start), "dur": dur * 1e6,
                 "pid": self._pid,
                 "tid": self._tid() if tid is None else tid}
        if args:
            event["args"] = args
        self._append(event)

    def span(self, name, cat="span", **args):
        """Context manager recording one complete event around a block."""
        if not self.enabled and not self._flight.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def traced(self, name=None, cat="span"):
        """Decorator form of :meth:`span` (label defaults to the
        function's qualified name)."""
        def decorate(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                if not self.enabled and not self._flight.enabled:
                    return fn(*a, **kw)
                start = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.complete(label, start,
                                  time.perf_counter() - start, cat=cat)
            return wrapper
        return decorate

    def instant(self, name, cat="event", **args):
        """Record a point event (protocol messages, faults, rollbacks)."""
        flt = self._flight
        if flt.enabled:
            flt.record("instant", name, cat, args=args or None)
        if not self.enabled:
            return
        event = {"name": name, "cat": cat, "ph": "i", "s": "t",
                 "ts": self._ts(time.perf_counter()),
                 "pid": self._pid, "tid": self._tid()}
        if args:
            event["args"] = args
        self._append(event)

    def counter(self, name, value, cat="counter"):
        """Record a counter sample (renders as a filled track)."""
        flt = self._flight
        if flt.enabled:
            flt.record("counter", name, cat, args={"value": value})
        if not self.enabled:
            return
        self._append({"name": name, "cat": cat, "ph": "C",
                      "ts": self._ts(time.perf_counter()),
                      "pid": self._pid, "tid": self._tid(),
                      "args": {"value": value}})

    # -- cross-process shipping --------------------------------------------

    def take_chunk(self, max_events=4096, idents=None, extra=None):
        """Pop up to ``max_events`` recorded events into a bounded,
        self-describing chunk a slave can ship to its master
        (docs/observability.md, distributed tracing).

        ``idents`` (optional) restricts the chunk to events recorded by
        those thread idents — the in-process two-node tests use it to
        keep a shared tracer's master and slave events separable; real
        one-process-per-role deployments ship everything.  Thread-name
        metadata is carried as a ``threads`` map (the popped "M" events
        may have shipped in an earlier chunk).  Returns None when there
        is nothing to ship."""
        with self._lock:
            # the hot path appends WITHOUT this lock, so the buffer
            # object must never be rebound here: examine a fixed-length
            # prefix and splice it in place — concurrent appends land
            # past index n on the SAME list and survive untouched
            n = len(self._events)
            if not n:
                return None
            tids = None if idents is None else self.tids_for(idents)
            taken, kept = [], []
            for index in range(n):
                event = self._events[index]
                # thread metadata never ships (the chunk's ``threads``
                # map replaces it — popped "M" events would leave later
                # chunks nameless); scoped chunks also keep foreign
                # threads' events behind
                if (len(taken) < max_events and event["ph"] != "M"
                        and (tids is None or event["tid"] in tids)):
                    taken.append(event)
                else:
                    kept.append(event)
            self._events[:n] = kept
            if not taken:
                return None
            threads = {str(e["tid"]): self._tid_names.get(e["tid"], "")
                       for e in taken}
            chunk = {
                "schema": CHUNK_SCHEMA_VERSION,
                "pid": self._pid,
                "label": self.label,
                "wall_epoch": self._epoch_wall,
                "threads": threads,
                "events": taken,
            }
            if extra:
                chunk.update(extra)
            return chunk

    # -- output ------------------------------------------------------------

    def save(self, path):
        """Write ``{"traceEvents": [...]}`` atomically — the JSON
        object form Perfetto and chrome://tracing both load."""
        # bounded acquire: save() also runs from the launcher's fatal-
        # signal hook, which may interrupt the very thread holding the
        # lock (take_chunk/save) — a dying process must still get its
        # trace out (list() of the buffer is GIL-atomic regardless)
        locked = self._lock.acquire(timeout=2.0)
        try:
            doc = {"traceEvents": list(self._events),
                   "displayTimeUnit": "ms",
                   "otherData": {"tool": "veles_tpu_torch.observe",
                                 "dropped_events": self.dropped,
                                 # merge anchors: wall time of ts=0 and
                                 # this process's identity, so a saved
                                 # per-process file can join a merged
                                 # cross-host timeline offline
                                 "wall_epoch": self._epoch_wall,
                                 "pid": self._pid,
                                 "label": self.label}}
        finally:
            if locked:
                self._lock.release()
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fout:
            json.dump(doc, fout)
        os.replace(tmp, path)
        return path


def validate_trace(doc):
    """Structural check of a loaded trace document; raises ValueError.

    Verifies the Perfetto-loadable shape (``traceEvents`` list, known
    phases, required fields per phase) and that the complete events on
    each thread track NEST — overlapping non-nested spans on one track
    mean a broken instrumentation site (e.g. a span closed on a
    different thread than it opened on).  Used by tests and available
    to external consumers of ``--trace`` output.
    """
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace must be {'traceEvents': [...]}")
    per_track = {}
    for i, event in enumerate(doc["traceEvents"]):
        if not isinstance(event, dict):
            raise ValueError("event %d is not an object" % i)
        ph = event.get("ph")
        if ph not in ("X", "M", "i", "C"):
            raise ValueError("event %d: unknown phase %r" % (i, ph))
        for key in ("name", "pid", "tid"):
            if key not in event:
                raise ValueError("event %d: missing %r" % (i, key))
        if ph == "X":
            ts, dur = event.get("ts"), event.get("dur")
            if not isinstance(ts, (int, float)) or \
                    not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    "event %d: complete event needs numeric ts/dur" % i)
            per_track.setdefault(
                (event["pid"], event["tid"]), []).append(event)
    epsilon = 1.0  # microsecond slack for float rounding
    for track, events in per_track.items():
        events.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for event in events:
            end = event["ts"] + event["dur"]
            while stack and stack[-1] <= event["ts"] + epsilon:
                stack.pop()
            if stack and end > stack[-1] + epsilon:
                raise ValueError(
                    "track %r: span %r [%f..%f] overlaps but does not "
                    "nest within its enclosing span (ends %f)" %
                    (track, event["name"], event["ts"], end, stack[-1]))
            stack.append(end)
    # request-span contract (observe/requests.py): every request-
    # scoped event carries its id, one track never mixes requests,
    # and segment spans ride under a serve.request parent
    for i, event in enumerate(doc["traceEvents"]):
        if event.get("cat") != "req" or event.get("ph") not in \
                ("X", "i"):
            continue
        trace_id = (event.get("args") or {}).get("trace")
        if not isinstance(trace_id, str) or not trace_id:
            raise ValueError(
                "event %d: request-scoped event %r has no args.trace "
                "id (orphan)" % (i, event.get("name")))
    for track, events in per_track.items():
        req_events = [e for e in events if e.get("cat") == "req"]
        if not req_events:
            continue
        ids = {(e.get("args") or {}).get("trace")
               for e in req_events}
        if len(ids) > 1:
            raise ValueError(
                "track %r: request track mixes trace ids %r" %
                (track, sorted(ids)))
        if any(e["name"].startswith("serve.req.")
               for e in req_events) and \
                not any(e["name"] == "serve.request"
                        for e in req_events):
            raise ValueError(
                "track %r: segment spans for trace %r without an "
                "enclosing serve.request span" %
                (track, next(iter(ids))))
    return doc


#: The process-wide tracer every subsystem instruments against.
tracer = SpanTracer()


def span(name, cat="span", **args):
    return tracer.span(name, cat=cat, **args)


def instant(name, cat="event", **args):
    return tracer.instant(name, cat=cat, **args)


def traced(name=None, cat="span"):
    return tracer.traced(name, cat=cat)
