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

Profiler-linked recording: while a ``torch.profiler`` records, a span
is recorded too, from any thread, whether or not the tracer was
started (:attr:`SpanTracer.live`; the test is the autograd profiler's
module flag, which every thread reads, where its per-thread state
reads False on threads the profiler did not start on and its
``record_function`` ranges are lost there).  Those spans go to a
bounded buffer of their own, read by :meth:`SpanTracer.profiled_spans`
on the profiler's clock: the profiler stamps its events on the wall
clock, so the tracer keeps anchor pairs of ``perf_counter`` and
``time.time_ns`` readings, one when such a recording begins and
another whenever a span ends a second or more after the last one, and
interpolates between the two around each stamp.
``observe.profile.ProfilerHook`` writes them into the Chrome trace it
exports, on the threads' own tracks.

A span opened live (:meth:`SpanTracer.span`, :meth:`SpanTracer.open`)
is the parent of the spans recorded inside it on its thread, and
passes them its sequence number (``seq``: the batch or the step they
belong to).  With the tracer and the profiler off, a guarded site costs
one check of :attr:`SpanTracer.live`.
"""

import bisect
import collections
import functools
import itertools
import json
import os
import sys
import threading
import time

from veles_tpu_torch.observe.flight import flight as _global_flight

__all__ = ["SpanTracer", "tracer", "span", "instant", "traced",
           "validate_trace", "profiler_recording", "ProfiledSpan",
           "CHUNK_SCHEMA_VERSION"]

#: schema of the bounded trace chunks slaves ship to the master
#: (observe/cluster.py collects them, observe/merge.py stitches them)
CHUNK_SCHEMA_VERSION = 1

#: the longest stretch between two clock anchors of a profiler-linked
#: recording (seconds)
ANCHOR_EVERY_S = 1.0

#: track ids of request tracks in an exported profile, above any
#: thread id the kernel hands out
REQUEST_TRACK_BASE = 1 << 30

#: one span recorded while a profiler recorded: ``start_us`` and
#: ``end_us`` on the profiler's clock (wall-clock microseconds, as
#: ``torch.profiler``'s raw events stamp theirs), ``tid`` the thread's
#: native id (a request track's is ``REQUEST_TRACK_BASE`` plus its
#: track id), ``thread`` its name, ``id`` and ``parent`` the span ids,
#: ``seq`` the batch or step sequence number, ``args`` the span's own
ProfiledSpan = collections.namedtuple(
    "ProfiledSpan", "name cat start_us end_us tid thread id parent seq "
    "args")


def profiler_recording():
    """True while a ``torch.profiler`` records, read from any thread;
    False while torch is not loaded (no profiler can run then)."""
    module = sys.modules.get("torch.autograd.profiler")
    return module is not None and \
        getattr(module, "_is_profiler_enabled", False)


class _NullSpan(object):
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()
    live = False
    start = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self, end=None, **args):
        pass


_NULL_SPAN = _NullSpan()


class _Span(object):
    """One span: recorded on exit (or :meth:`close`).  A live one (the
    tracer or a profiler recording when it opened) holds an id and sits
    on its thread's stack of open spans, so the spans recorded inside
    it name it as their parent; a flight-only one feeds the ring."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_start", "_id",
                 "_seq", "_parent", "_closed")

    def __init__(self, owner, name, cat, args, live=False, seq=None):
        self._tracer = owner
        self._name = name
        self._cat = cat
        self._args = args
        self._id = next(owner._ids) if live else None
        self._seq = seq
        self._parent = None
        self._closed = False
        self._start = None

    def __enter__(self):
        if self._start is None:  # not begun by SpanTracer.open
            self._begin(time.perf_counter())
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def start(self):
        """The ``perf_counter`` reading the span began at."""
        return self._start

    @property
    def live(self):
        """True when the span records its id and parent (the tracer or
        a profiler recorded when it opened); False for a flight-only
        one."""
        return self._id is not None

    def _begin(self, start):
        self._start = start
        if self._id is not None:
            stack = self._tracer._stack()
            if stack:
                top = stack[-1]
                self._parent = top._id
                if self._seq is None:
                    self._seq = top._seq
            stack.append(self)

    def close(self, end=None, **args):
        """End the span at ``end`` (a ``perf_counter`` reading; now by
        default), adding ``args`` to its own, and record it; a second
        close does nothing."""
        if self._closed:
            return
        self._closed = True
        if end is None:
            end = time.perf_counter()
        if args:
            self._args = dict(self._args or (), **args)
        owner = self._tracer
        if self._id is not None:
            stack = owner._stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
        owner._record(self._name, self._cat, self._start,
                      end - self._start, self._args, None, self._id,
                      self._parent, self._seq)


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
        # the live spans' ids and each thread's stack of open ones
        self._ids = itertools.count(1)
        self._local = threading.local()
        # profiler-linked recording: its spans (tuples, see _link), the
        # clock anchors [(perf_counter, wall ns)], the native thread
        # names, and whether a recording is under way
        self._linked = []
        self._linked_max = max(1, max_events // 4)
        self._linked_on = False
        self._anchors = []
        self._anchor_due = 0.0
        self._threads = {}   # native id -> name
        #: spans a full profiler-linked buffer turned away
        self.linked_dropped = 0

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
    def live(self):
        """True when a span should be recorded with its id and parent:
        the tracer is on, or a ``torch.profiler`` records.  The one
        check a span site makes while both are off."""
        return self.enabled or profiler_recording()

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
                 tid=None, seq=None):
        """Record a complete ("X") event from perf_counter timings —
        the primitive every instrumented timer calls, so the trace and
        the accumulated timers always report the SAME measurement.
        Always feeds the flight recorder's ring (compact tuple, no
        serialization) so post-mortem dumps work without ``--trace``.
        ``tid`` overrides the recording thread's track — request-
        scoped spans land on their :meth:`request_track` lane.  On the
        recording thread the innermost open live span is the parent,
        and lends its ``seq`` unless one is given."""
        parent = None
        linking = profiler_recording()
        if tid is None and (self.enabled or linking):
            stack = self._stack()
            if stack:
                top = stack[-1]
                parent = top._id
                if seq is None:
                    seq = top._seq
        self._record(name, cat, start, dur, args, tid, None, parent, seq,
                     linking)

    def _record(self, name, cat, start, dur, args, tid, span_id, parent,
                seq, linking=None):
        flt = self._flight
        if flt.enabled:
            flt.record("span", name, cat, self.wall_time(start), dur,
                       args)
        if linking is None:
            linking = profiler_recording()
        if linking:
            self._link(name, cat, start, start + dur, args, tid, span_id,
                       parent, seq)
        elif self._linked_on:
            self._linked_on = False  # that recording ended
        if not self.enabled:
            return
        event = {"name": name, "cat": cat, "ph": "X",
                 "ts": self._ts(start), "dur": dur * 1e6,
                 "pid": self._pid,
                 "tid": self._tid() if tid is None else tid}
        if seq is not None:
            args = dict(args or (), seq=seq)
        if args:
            event["args"] = args
        self._append(event)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name, cat="span", **args):
        """Context manager recording one complete event around a block."""
        if self.enabled or profiler_recording():
            return _Span(self, name, cat, args or None, live=True)
        if self._flight.enabled:
            return _Span(self, name, cat, args or None)
        return _NULL_SPAN

    def open(self, name, start=None, cat="span", args=None, seq=None):
        """:meth:`span` begun at ``start`` (a ``perf_counter`` reading,
        now by default) and left open until its ``close(end=None,
        **args)`` (or the end of a ``with`` block over it): for a site
        that has already read the clock, or whose span outlives a
        block.  Live, it is the parent of the spans recorded on this
        thread meanwhile; as :meth:`span`, it is flight-only while only
        the flight ring is on, and the shared null span while both are
        off (its ``live`` tells them apart)."""
        if self.enabled or profiler_recording():
            opened = _Span(self, name, cat, args, live=True, seq=seq)
        elif self._flight.enabled:
            opened = _Span(self, name, cat, args)
        else:
            return _NULL_SPAN
        opened._begin(time.perf_counter() if start is None else start)
        return opened

    def traced(self, name=None, cat="span"):
        """Decorator form of :meth:`span` (label defaults to the
        function's qualified name)."""
        def decorate(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                if not self.enabled and not self._flight.enabled and \
                        not profiler_recording():
                    return fn(*a, **kw)
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return wrapper
        return decorate

    # -- profiler-linked recording -----------------------------------------

    def _anchor(self):
        """One (perf_counter, wall ns) pair, the wall reading between
        two perf_counter ones."""
        before = time.perf_counter()
        wall = time.time_ns()
        after = time.perf_counter()
        self._anchors.append(((before + after) / 2.0, wall))
        self._anchor_due = after + ANCHOR_EVERY_S

    def _link(self, name, cat, start, end, args, tid, span_id, parent,
              seq):
        if not self._linked_on:
            with self._lock:
                if not self._linked_on:
                    # a new profiler recording: a fresh buffer and a
                    # fresh anchor pair
                    self._linked = []
                    self._anchors = []
                    self.linked_dropped = 0
                    self._anchor()
                    self._linked_on = True
        elif end >= self._anchor_due:
            with self._lock:
                if end >= self._anchor_due:
                    self._anchor()
        if len(self._linked) >= self._linked_max:
            self.linked_dropped += 1
            return
        if tid is None:
            # cached: the native id is a system call
            tid = getattr(self._local, "native", None)
            if tid is None:
                tid = self._local.native = threading.get_native_id()
                self._threads[tid] = threading.current_thread().name
        else:
            tid = REQUEST_TRACK_BASE + tid
        self._linked.append((name, cat, start, end, tid, span_id, parent,
                             seq, args))

    def profiler_ns(self, when):
        """A ``perf_counter`` reading on the profiler's clock (wall
        nanoseconds): interpolated between the anchor pairs around it,
        or offset by the nearest one outside them."""
        anchors = self._anchors
        if not anchors:
            return self.wall_time(when) * 1e9
        i = bisect.bisect_right(anchors, when, key=lambda a: a[0])
        if 0 < i < len(anchors):
            (p0, w0), (p1, w1) = anchors[i - 1], anchors[i]
            if p1 > p0:
                return w0 + (when - p0) * (w1 - w0) / (p1 - p0)
        p, w = anchors[min(i, len(anchors) - 1)]
        return w + (when - p) * 1e9

    def profiled_spans(self):
        """The spans of the last profiler-linked recording, as
        :class:`ProfiledSpan` tuples on the profiler's clock, in the
        order they ended."""
        names = dict(self._threads)
        names.update((REQUEST_TRACK_BASE + tid, label)
                     for tid, label in self._tid_names.items())
        out = []
        for name, cat, start, end, tid, span_id, parent, seq, args in \
                list(self._linked):
            out.append(ProfiledSpan(
                name, cat, self.profiler_ns(start) / 1e3,
                self.profiler_ns(end) / 1e3, tid, names.get(tid, ""),
                span_id, parent, seq, args))
        return out

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
