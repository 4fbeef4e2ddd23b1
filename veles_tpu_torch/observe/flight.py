"""Black-box flight recorder: the last N telemetry events, always.

Counterpart of ``veles_tpu/observe/flight.py``, whole and stdlib-only:
the dump schema is the JAX package's, so its ``validate_flight``
accepts this module's dumps and the reverse.

``--trace`` answers "where does the time go" when someone *planned* to
look; this module answers "what happened just before it died" when
nobody did.  A bounded ring buffer (``collections.deque(maxlen=N)``)
holds the most recent spans, instants, counters and heartbeat lines the
telemetry layer produced, at near-zero cost (one tuple build + one
GIL-atomic append per event, no locks, no serialization), and is dumped
as schema-versioned JSON when something goes wrong:

- a serve-tier SLO violation (``serve/batcher.py``, with the tail
  exemplars of ``observe/requests.py``);
- a canary rollback (``serve/freshness.py``);
- an alert firing (``observe/alerts.py``).

(The JAX package also dumps on training divergence, snapshot rollback,
update quarantine and a crash escaping the launcher; those hooks wait
for the training side of the port's observability.)

The recorder is fed by the span tracer (``trace.py``): every
instrumented ``complete``/``instant``/``counter`` site routes a compact
record here even while full tracing is off, so the ring is populated in
ordinary production runs without anyone passing ``--trace``.  Chaos-
injected failures therefore leave a loadable timeline instead of
demanding log archaeology.

Disable with ``VELES_FLIGHT=0``; resize with ``VELES_FLIGHT_CAPACITY``.
Dumps validate against :func:`validate_flight` (``schema: 1``).
"""

import collections
import json
import logging
import os
import threading
import time

__all__ = ["FlightRecorder", "flight", "validate_flight",
           "FLIGHT_SCHEMA_VERSION"]

FLIGHT_SCHEMA_VERSION = 1

_logger = logging.getLogger("flight")

#: required keys -> allowed types of one flight dump document
_FLIGHT_REQUIRED = {
    "kind": str, "schema": int, "reason": str, "ts": (int, float),
    "mono": (int, float), "pid": int, "host": str, "events": list,
}

#: required keys of one serialized flight event
_EVENT_REQUIRED = ("ts", "mono", "thread", "kind", "name")


class FlightRecorder(object):
    """Bounded always-on ring of recent telemetry events + crash dump.

    The hot method is :meth:`record`: build one tuple, append to a
    maxlen deque — both effectively atomic under the GIL, so the hot
    path takes no lock (the lock guards only dumps, which snapshot the
    ring).  ``enabled`` is a plain bool; when False every method
    returns immediately.
    """

    def __init__(self, capacity=None, enabled=None, base_path=None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "VELES_FLIGHT_CAPACITY", 4096))
            except ValueError:
                capacity = 4096
        if enabled is None:
            enabled = os.environ.get("VELES_FLIGHT", "1") not in (
                "0", "false", "no", "off")
        self.enabled = bool(enabled)
        self.capacity = max(16, int(capacity))
        #: dump destination stem; dumps land at
        #: ``<base_path>.<reason>.<seq>.json`` (launcher points this
        #: next to ``--trace`` when one is set)
        self.base_path = base_path or "veles_flight"
        self.dumps = 0
        self.last_dump_path = None
        self._buf = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    # -- recording (hot) ---------------------------------------------------

    def record(self, kind, name, cat=None, wall=None, dur=None,
               args=None):
        """Append one event: ``kind`` is span/instant/counter/heartbeat,
        ``wall`` the event's wall-clock time (now when omitted),
        ``dur`` seconds for spans, ``args`` a small plain-data dict."""
        if not self.enabled:
            return
        self._buf.append((
            time.time() if wall is None else wall,
            time.perf_counter(),
            threading.current_thread().name,
            kind, name, cat, dur, args))

    def __len__(self):
        return len(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()

    # -- dumping -----------------------------------------------------------

    def snapshot(self):
        """The ring as serializable event dicts, oldest first.

        The lock acquire is BOUNDED: dumps run from failure paths —
        including a signal handler interrupting the very thread that
        holds the lock — and a black box that deadlocks the dying
        process is worse than a marginally racy copy (list(deque) is
        a single GIL-atomic operation either way)."""
        locked = self._lock.acquire(timeout=2.0)
        try:
            raw = list(self._buf)
        finally:
            if locked:
                self._lock.release()
        events = []
        for wall, mono, thread, kind, name, cat, dur, args in raw:
            event = {"ts": wall, "mono": mono, "thread": thread,
                     "kind": kind, "name": name}
            if cat is not None:
                event["cat"] = cat
            if dur is not None:
                event["dur_s"] = dur
            if args:
                event["args"] = args
            events.append(event)
        return events

    def document(self, reason="", extra=None):
        """``extra`` merges additional top-level blocks into the dump
        (e.g. the request-tracing exemplar timelines,
        observe/requests.py); required schema keys always win —
        validate_flight tolerates the additions."""
        from veles_tpu_torch import logger as _vlogger
        doc = {
            "kind": "flight",
            "schema": FLIGHT_SCHEMA_VERSION,
            "reason": reason or "dump",
            "ts": time.time(),
            "mono": time.perf_counter(),
            "pid": os.getpid(),
            "host": os.uname().nodename,
            "session": getattr(_vlogger, "session_id", ""),
            "capacity": self.capacity,
            "events": self.snapshot(),
        }
        if extra:
            for key, value in extra.items():
                doc.setdefault(key, value)
        return doc

    def dump(self, reason="", path=None, extra=None):
        """Write the ring to ``path`` (default: sequenced next to
        ``base_path``) atomically.  NEVER raises — the recorder runs on
        failure paths where a second fault must not mask the first.
        Returns the written path, or None."""
        if not self.enabled:
            return None
        try:
            doc = self.document(reason, extra=extra)
            if path is None:
                locked = self._lock.acquire(timeout=2.0)
                try:
                    seq, self.dumps = self.dumps, self.dumps + 1
                finally:
                    if locked:
                        self._lock.release()
                path = "%s.%s.%d.json" % (
                    self.base_path,
                    (reason or "dump").replace(" ", "_").replace(
                        os.sep, "_"),
                    seq)
            directory = os.path.dirname(os.path.abspath(path))
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fout:
                json.dump(doc, fout, default=repr)
            os.replace(tmp, path)
            self.last_dump_path = path
            _logger.warning("flight recorder dumped %d events to %s "
                            "(reason: %s)", len(doc["events"]), path,
                            doc["reason"])
            return path
        except Exception as exc:
            _logger.error("flight dump failed: %s", exc)
            return None


def validate_flight(doc):
    """Schema check of a loaded flight dump; raises ValueError.  The
    contract tests and external post-mortem tooling rely on."""
    if not isinstance(doc, dict):
        raise ValueError("flight dump is not an object")
    for key, types in _FLIGHT_REQUIRED.items():
        if key not in doc:
            raise ValueError("flight dump missing %r" % key)
        if not isinstance(doc[key], types):
            raise ValueError("flight dump %r has type %s" %
                             (key, type(doc[key]).__name__))
    if doc["kind"] != "flight":
        raise ValueError("kind must be 'flight'")
    if doc["schema"] != FLIGHT_SCHEMA_VERSION:
        raise ValueError("unknown flight schema %r" % doc["schema"])
    for i, event in enumerate(doc["events"]):
        if not isinstance(event, dict):
            raise ValueError("flight event %d is not an object" % i)
        for key in _EVENT_REQUIRED:
            if key not in event:
                raise ValueError("flight event %d missing %r" % (i, key))
    return doc


#: The process-wide recorder the tracer feeds and failure paths dump.
flight = FlightRecorder()
