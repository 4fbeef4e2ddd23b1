"""Request-scoped serve-tier tracing: ids, timelines, tail exemplars.

Counterpart of ``veles_tpu/observe/requests.py``, whole and
stdlib-only: the ids, the sampling hash and the segment taxonomy are
the JAX package's, so a front of one package and a host of the other
stitch one request's legs under one id.

The serve tier reports aggregate histograms; when
p99 spikes they cannot say WHERE the tail lives — admission, batching
delay, H2D staging, device compute, or the wire.  This module is the
per-request substrate:

- **Trace ids.**  A request id is a short plain string minted at the
  front door (``mint_trace_id``) or supplied by the client (HTTP
  ``X-Trace-Id`` / body field, binary-transport hello default +
  per-frame override).  Ids cross the wire as bounded JSON strings —
  ``normalize_trace_id`` enforces charset/length so the serve port's
  never-unpickle trust boundary is unchanged.
- **Segment marks.**  Serve components stamp cheap ``perf_counter``
  marks on their existing request objects as ``(segment, start,
  dur)`` tuples — the canonical taxonomy is :data:`SEGMENTS`.  Marks
  are on for EVERY request while :data:`enabled` (the
  ``VELES_REQTRACE=0`` kill switch exists for the bench.py
  ``trace_overhead`` A/B), because tail exemplars need the timeline
  of requests that only turn out slow at completion.
- **Sampled span emission.**  Full request-track spans go to the
  :mod:`veles_tpu_torch.observe.trace` tracer only for *sampled* requests.
  Sampling is DETERMINISTIC in the id (crc32 hash, no RNG) so the two
  legs of one hedged request — on two hosts, two processes — make the
  same keep/drop decision and stitch under one id in the merged
  timeline (observe/merge.py).
- **Tail exemplars.**  Every non-shadow request past its class SLO
  budget (serve/qos.py) or above the rolling p99 keeps its complete
  segment timeline in a bounded ring (:class:`ExemplarRing`), dumped
  with the flight recorder on ``serve.slo_violation`` so a violation
  always carries the offending request's breakdown.
- **Critical-path analyzer.**  :func:`analyze_files` over
  ``trace.json host0.json ...`` with per-label offsets — a
  per-segment p50/p99 table, dominant-segment tail attribution, and
  hedge win/loss + requeue accounting over saved traces, flight
  dumps, and merged documents, reusing merge.py's offset-corrected
  timeline so cross-host legs land on one clock.

Stdlib-only and import-light, like the rest of the observe layer.
"""

import collections
import itertools
import json
import os
import re
import sys
import threading
import time
import zlib

from veles_tpu_torch.observe.metrics import registry as _registry

__all__ = [
    "SEGMENTS", "REQUEST_SPAN", "SEGMENT_PREFIX", "LEG_SPAN",
    "enabled", "sample_rate", "mint_trace_id", "normalize_trace_id",
    "sampled", "timeline", "emit_spans", "ExemplarRing", "exemplars",
    "extract_requests", "analyze", "analyze_files", "render_requests",
]

# Canonical segment taxonomy (docs/observability.md).  admit: front-
# door admission (quota wait, chaos, decode gating); queue: enqueue ->
# batch assembly start; assemble: gather/pad rows into the staging
# buffer; h2d: host->device transfer; device: compiled dispatch;
# d2h: result sync back to host; wire_rx/wire_tx: transport frame
# decode/reply.  "leg" is reserved for fleet hedge-leg spans.
SEGMENTS = ("admit", "queue", "assemble", "h2d", "device", "d2h",
            "wire_rx", "wire_tx")

REQUEST_SPAN = "serve.request"
SEGMENT_PREFIX = "serve.req."
LEG_SPAN = SEGMENT_PREFIX + "leg"

_TRUTHY = ("1", "true", "on", "yes")

# Kill switch for the whole per-request path: marks, exemplars, span
# emission.  bench.py trace_overhead flips this module attribute for
# its stamps-on vs fully-off A/B.
enabled = os.environ.get("VELES_REQTRACE", "1").strip().lower() \
    in _TRUTHY

# Span-emission sampling rate in [0, 1]; marks/exemplars ignore it.
sample_rate = float(os.environ.get("VELES_REQTRACE_SAMPLE", "1.0"))

_ID_RE = re.compile(r"[A-Za-z0-9_.:-]{1,64}\Z")
_ids = itertools.count(1)
_ID_PREFIX = "%08x" % (zlib.crc32(
    ("%d.%.9f" % (os.getpid(), time.time())).encode()) & 0xffffffff)


def mint_trace_id():
    """Cheap process-unique id: <boot-hash>-<counter>.  A few hundred
    ns — safe to mint per request on the serve hot path."""
    return "%s-%x" % (_ID_PREFIX, next(_ids))


def normalize_trace_id(value):
    """Validate an id that crossed a trust boundary (wire frame, HTTP
    header).  Returns the id or None; never raises.  Plain bounded
    string only — the serve port never unpickles, and trace ids do
    not change that."""
    if not isinstance(value, str):
        return None
    value = value.strip()
    if _ID_RE.fullmatch(value) is None:
        return None
    return value


def sampled(trace_id, rate=None):
    """Deterministic keep/drop for span emission: both hedge legs of
    one request hash the same id, so they sample together."""
    rate = sample_rate if rate is None else rate
    if not trace_id or rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    bucket = zlib.crc32(trace_id.encode("utf-8", "replace")) & 0xffff
    return bucket < int(rate * 65536.0)


def timeline(marks, t0):
    """Marks [(segment, start_perf, dur_s)] -> plain-data timeline
    with offsets relative to the request's arrival t0."""
    return [{"seg": name, "start_s": round(start - t0, 6),
             "dur_s": round(max(0.0, dur), 6)}
            for name, start, dur in marks]


def emit_spans(tr, trace_id, start, end, marks, args=None):
    """Emit one request's timeline as spans on a dedicated request
    track: a ``serve.request`` parent covering [start, end] plus one
    ``serve.req.<segment>`` child per mark.  Each leg gets its OWN
    track (keyed by (id, start)) so concurrent hedge legs in one
    process never overlap-without-nesting on a shared lane; the track
    label repeats the id, which is how legs visually group."""
    tid = tr.request_track((trace_id, start), "req:%s" % trace_id)
    _registry.counter("serve.reqtrace.sampled").inc()
    top = {"trace": trace_id}
    if args:
        top.update(args)
    tr.complete(REQUEST_SPAN, start, max(0.0, end - start),
                cat="req", args=top, tid=tid)
    for name, seg_start, dur in marks:
        tr.complete(SEGMENT_PREFIX + name, seg_start, max(0.0, dur),
                    cat="req", args={"trace": trace_id}, tid=tid)


class ExemplarRing:
    """Bounded ring of complete segment timelines for tail requests.

    A request is kept when it exceeds its class SLO budget (the
    caller passes ``budget_s`` from serve/qos.py) or lands strictly
    above the rolling p99 of recent latencies.  Shadow/mirror traffic is
    excluded — canary mirrors are tagged but never exemplars.  The
    ring is dumped with the flight recorder on ``serve.slo_violation``
    so a violation always carries a breakdown."""

    def __init__(self, capacity=None, window=256, min_samples=32):
        if capacity is None:
            capacity = int(os.environ.get(
                "VELES_REQTRACE_EXEMPLARS", "64"))
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        self._window = collections.deque(maxlen=int(window))
        self._min_samples = int(min_samples)
        self._p99 = None
        self._notes = 0
        self.seen = 0
        self.kept = 0

    @property
    def capacity(self):
        return self._ring.maxlen

    def rolling_p99(self):
        with self._lock:
            return self._p99

    def note(self, trace, latency_s, marks=(), t0=0.0, slo_class=None,
             budget_s=None, kind="host", shadow=False, extra=None):
        """Consider one completed request; returns True if kept."""
        if shadow:
            return False
        with self._lock:
            self.seen += 1
            self._window.append(latency_s)
            self._notes += 1
            # nearest-rank p99 over the window, refreshed every 32
            # notes — a sort of <=256 floats, off by default cadence
            if (self._p99 is None or self._notes % 32 == 0) and \
                    len(self._window) >= self._min_samples:
                ranked = sorted(self._window)
                self._p99 = ranked[min(len(ranked) - 1,
                                       int(0.99 * len(ranked)))]
            over_budget = budget_s is not None and latency_s > budget_s
            # strictly ABOVE the rolling p99: a uniform-latency steady
            # state ties everything at p99 and ">=" would keep (and pay
            # the timeline build for) every single request
            over_p99 = self._p99 is not None and latency_s > self._p99
            if not (over_budget or over_p99):
                return False
            entry = {
                "trace": trace,
                "class": slo_class,
                "kind": kind,
                "latency_s": round(latency_s, 6),
                "over": "budget" if over_budget else "p99",
                "budget_s": budget_s,
                "ts": time.time(),
                "timeline": timeline(marks, t0),
            }
            if extra:
                entry.update(extra)
            self._ring.append(entry)
            self.kept += 1
        _registry.counter("serve.reqtrace.exemplars").inc()
        return True

    def snapshot(self):
        with self._lock:
            return {"capacity": self._ring.maxlen, "seen": self.seen,
                    "kept": self.kept,
                    "rolling_p99_s": self._p99,
                    "entries": list(self._ring)}

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._window.clear()
            self._p99 = None
            self._notes = 0
            self.seen = 0
            self.kept = 0

    def dump(self, reason="serve.slo_violation", path=None):
        """Flight-recorder dump carrying the exemplar timelines.
        Never raises (flight.dump's contract)."""
        from veles_tpu_torch.observe.flight import flight
        return flight.dump(reason, path=path,
                           extra={"exemplars": self.snapshot()})


exemplars = ExemplarRing()


# ---------------------------------------------------------------- #
# critical-path analyzer                                           #
# ---------------------------------------------------------------- #

_HEDGE_FIRED = "serve.hedge.fired"
_HEDGE_WIN = "serve.hedge.win"
_REQUEUE = "serve.fleet.requeue"


def _new_record():
    return {"segments": {}, "legs": [], "class": None, "hedges": 0,
            "requeues": 0, "total_s": 0.0, "spans": 0,
            "exemplar": False}


def _new_counts():
    return {"hedge_fired": 0, "hedge_wins": 0, "requeues": 0,
            "exemplars": 0}


def _fold_span(records, trace, name, dur_s, args, start_s=None):
    rec = records.setdefault(trace, _new_record())
    rec["spans"] += 1
    if name == REQUEST_SPAN:
        rec["total_s"] = max(rec["total_s"], dur_s)
        rec["class"] = args.get("slo_class") or rec["class"]
        for key in ("hedges", "requeues"):
            try:
                rec[key] = max(rec[key], int(args.get(key) or 0))
            except (TypeError, ValueError):
                pass
        if args.get("tier") == "host" or args.get("host"):
            rec["legs"].append({"host": args.get("host"),
                                "start_s": start_s, "dur_s": dur_s})
    elif name == LEG_SPAN:
        rec["legs"].append({"host": args.get("host"),
                            "start_s": start_s, "dur_s": dur_s,
                            "hedge": bool(args.get("hedge"))})
    elif name.startswith(SEGMENT_PREFIX):
        seg = name[len(SEGMENT_PREFIX):]
        rec["segments"].setdefault(seg, []).append(dur_s)


def _extract_trace(doc, records, counts):
    for event in doc.get("traceEvents", ()):
        ph = event.get("ph")
        args = event.get("args") or {}
        if ph == "X":
            trace = args.get("trace")
            if not trace:
                continue
            _fold_span(records, trace, event.get("name", ""),
                       float(event.get("dur") or 0.0) / 1e6, args,
                       start_s=float(event.get("ts") or 0.0) / 1e6)
        elif ph == "i":
            name = event.get("name")
            if name == _HEDGE_FIRED:
                counts["hedge_fired"] += 1
            elif name == _HEDGE_WIN:
                counts["hedge_wins"] += 1
            elif name == _REQUEUE:
                counts["requeues"] += 1


def _extract_flight(doc, records, counts):
    for event in doc.get("events", ()):
        kind = event.get("kind")
        args = event.get("args") or {}
        if kind == "span" and args.get("trace"):
            _fold_span(records, args["trace"], event.get("name", ""),
                       float(event.get("dur_s") or 0.0), args,
                       start_s=event.get("mono"))
        elif kind == "instant":
            name = event.get("name")
            if name == _HEDGE_FIRED:
                counts["hedge_fired"] += 1
            elif name == _HEDGE_WIN:
                counts["hedge_wins"] += 1
            elif name == _REQUEUE:
                counts["requeues"] += 1
    block = doc.get("exemplars") or {}
    for index, entry in enumerate(block.get("entries", ())):
        counts["exemplars"] += 1
        trace = entry.get("trace") or "untraced-%d" % index
        rec = records.setdefault(trace, _new_record())
        rec["exemplar"] = True
        rec["class"] = entry.get("class") or rec["class"]
        rec["total_s"] = max(rec["total_s"],
                             float(entry.get("latency_s") or 0.0))
        for item in entry.get("timeline", ()):
            seg = item.get("seg")
            if not seg or seg == "leg":
                continue
            rec["segments"].setdefault(seg, []).append(
                float(item.get("dur_s") or 0.0))


def extract_requests(doc, records=None, counts=None):
    """Fold one document — saved trace, merged trace, or flight dump
    — into per-trace-id request records.  Pass the same ``records``/
    ``counts`` across calls to accumulate over many files."""
    records = {} if records is None else records
    counts = _new_counts() if counts is None else counts
    if doc.get("kind") == "flight":
        _extract_flight(doc, records, counts)
    else:
        _extract_trace(doc, records, counts)
    return records, counts


def _request_total(rec):
    if rec["total_s"] > 0.0:
        return rec["total_s"]
    return sum(sum(durs) for durs in rec["segments"].values())


def _dominant_segment(rec):
    best, best_dur = None, -1.0
    for seg, durs in rec["segments"].items():
        total = sum(durs)
        if total > best_dur:
            best, best_dur = seg, total
    return best


def analyze(records, counts, top=5):
    """Records -> the critical-path report: per-segment p50/p99,
    dominant-segment tail attribution, hedge/requeue accounting."""
    from veles_tpu_torch.observe.metrics import percentiles
    seg_durs = {}
    totals = []
    classes = {}
    legs = 0
    for rec in records.values():
        totals.append(_request_total(rec))
        legs += len(rec["legs"])
        if rec["class"]:
            classes[rec["class"]] = classes.get(rec["class"], 0) + 1
        for seg, durs in rec["segments"].items():
            seg_durs.setdefault(seg, []).extend(durs)
    segments = {}
    for seg, durs in seg_durs.items():
        pct = percentiles(durs, ps=(50, 99))
        segments[seg] = {
            "count": len(durs),
            "p50_ms": round(pct.get("p50", 0.0) * 1e3, 3),
            "p99_ms": round(pct.get("p99", 0.0) * 1e3, 3),
            "max_ms": round(max(durs) * 1e3, 3) if durs else 0.0,
        }
    tail = {"count": 0, "threshold_ms": None, "dominant": {},
            "worst": None}
    if totals:
        ranked = sorted(totals)
        threshold = ranked[min(len(ranked) - 1,
                               int(0.99 * len(ranked)))]
        tail["threshold_ms"] = round(threshold * 1e3, 3)
        worst_total = -1.0
        for trace, rec in records.items():
            total = _request_total(rec)
            if total < threshold:
                continue
            tail["count"] += 1
            dom = _dominant_segment(rec)
            if dom:
                tail["dominant"][dom] = tail["dominant"].get(dom, 0) + 1
            if total > worst_total:
                worst_total = total
                tail["worst"] = {
                    "trace": trace,
                    "latency_ms": round(total * 1e3, 3),
                    "dominant": dom,
                    "legs": len(rec["legs"]),
                    "class": rec["class"],
                }
    fired = counts["hedge_fired"]
    wins = counts["hedge_wins"]
    requeues = max(counts["requeues"],
                   sum(r["requeues"] for r in records.values()))
    hedged = sum(1 for r in records.values() if r["hedges"])
    report = {
        "kind": "requests",
        "requests": len(records),
        "legs": legs,
        "classes": classes,
        "segments": segments,
        "tail": tail,
        "hedge": {"fired": max(fired, sum(
            r["hedges"] for r in records.values())),
            "wins": wins, "losses": max(0, fired - wins),
            "hedged_requests": hedged},
        "requeues": requeues,
        "exemplars": counts["exemplars"],
        "top": top,
    }
    return report


def analyze_files(paths, offsets=None, top=5):
    """Load a mix of trace files and flight dumps; trace files are
    stitched through merge.py first (offset-corrected onto one clock,
    first file is the reference) so one hedged request's legs on two
    hosts fold into one record under its id."""
    from veles_tpu_torch.observe import merge
    offsets = offsets or {}
    parts = []
    flight_docs = []
    labels = []
    for path in paths:
        with open(path) as fin:
            doc = json.load(fin)
        base = os.path.basename(path)
        if doc.get("kind") == "flight":
            flight_docs.append(doc)
            labels.append(base)
            continue
        label = (doc.get("otherData") or {}).get("label") or base
        offset = offsets.get(label, offsets.get(base, 0.0))
        parts.append(merge.part_from_doc(doc, label=label,
                                         offset_s=offset))
        labels.append(label)
    records, counts = {}, _new_counts()
    if parts:
        merged = merge.merge_parts(parts)
        extract_requests(merged, records, counts)
    for doc in flight_docs:
        extract_requests(doc, records, counts)
    report = analyze(records, counts, top=top)
    report["files"] = labels
    return report


def render_requests(report, out=None):
    """Human-readable rendering of :func:`analyze`'s report — the
    ``observe requests`` CLI output."""
    out = out if out is not None else sys.stdout
    print("request digest: %d requests, %d legs, %d exemplars" % (
        report["requests"], report["legs"], report["exemplars"]),
        file=out)
    if report.get("classes"):
        print("  classes: %s" % ", ".join(
            "%s x%d" % (name, count) for name, count in
            sorted(report["classes"].items())), file=out)
    if report["segments"]:
        print("  segment            count     p50 ms     p99 ms     "
              "max ms", file=out)
        known = [s for s in SEGMENTS if s in report["segments"]]
        extra = sorted(set(report["segments"]) - set(known))
        for seg in known + extra:
            row = report["segments"][seg]
            print("  %-16s %7d %10.3f %10.3f %10.3f" % (
                seg, row["count"], row["p50_ms"], row["p99_ms"],
                row["max_ms"]), file=out)
    tail = report["tail"]
    if tail["count"]:
        dom = ", ".join("%s x%d" % (seg, count) for seg, count in
                        sorted(tail["dominant"].items(),
                               key=lambda kv: -kv[1]))
        print("  tail (>= %.3f ms): %d requests; dominant: %s" % (
            tail["threshold_ms"], tail["count"], dom or "n/a"),
            file=out)
        worst = tail["worst"]
        if worst:
            print("    worst: %s  %.3f ms  dominant=%s  legs=%d" % (
                worst["trace"], worst["latency_ms"],
                worst["dominant"], worst["legs"]), file=out)
    hedge = report["hedge"]
    print("  hedges: fired %d, wins %d, losses %d "
          "(%d hedged requests); requeues: %d" % (
              hedge["fired"], hedge["wins"], hedge["losses"],
              hedge["hedged_requests"], report["requeues"]), file=out)
