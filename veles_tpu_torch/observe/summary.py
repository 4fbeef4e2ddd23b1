"""Textual digests of trace files, flight dumps and heartbeat files.

Counterpart of ``veles_tpu/observe/summary.py``, whole and
stdlib-only.  CI logs and bug reports cannot attach a Perfetto UI;
this module turns a trace (``--trace`` output or a merged cluster
trace), a flight dump or a heartbeat JSONL file into a few lines of
text: per-track top-N spans by SELF time (span duration minus the
duration of spans nested inside it: where time is spent, not merely
enclosed) plus the last value of every counter track.

``python -m veles_tpu_torch.observe summary <trace.json|flight.json>``
is the CLI; :func:`digest_line` is the one-line form.
"""

import json

__all__ = ["load", "summarize", "summarize_trace", "summarize_flight",
           "summarize_heartbeats", "render", "digest_line",
           "request_digest_line"]


def load(path):
    """A trace file, a flight dump, or a heartbeat JSONL file
    (``--metrics-path`` output) — JSONL is detected by failing the
    single-document parse and folded into a ``heartbeats`` doc."""
    with open(path) as fin:
        text = fin.read()
    try:
        return json.loads(text)
    except ValueError:
        records = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # a torn final line from a killed process
        if not records:
            raise
        return {"kind": "heartbeats", "records": records}


def _self_times(events):
    """Per-(pid,tid) self time: sweep sorted complete events with a
    stack (the same nesting walk validate_trace does), subtracting each
    child's duration from its parent."""
    per_track = {}
    for event in events:
        if event.get("ph") != "X":
            continue
        per_track.setdefault(
            (event.get("pid"), event.get("tid")), []).append(event)
    out = {}  # track -> {name: [self_us, total_us, count]}
    for track, spans in per_track.items():
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stats = out.setdefault(track, {})
        stack = []  # [end_us, name]
        for event in spans:
            end = event["ts"] + event["dur"]
            while stack and stack[-1][0] <= event["ts"] + 1.0:
                stack.pop()
            if stack:
                parent = stats.get(stack[-1][1])
                if parent is not None:
                    parent[0] -= event["dur"]
            entry = stats.setdefault(event["name"], [0.0, 0.0, 0])
            entry[0] += event["dur"]
            entry[1] += event["dur"]
            entry[2] += 1
            stack.append([end, event["name"]])
    return out


def _track_names(events):
    """(pid,tid) -> "process/thread" display names from metadata."""
    procs, threads = {}, {}
    for event in events:
        if event.get("ph") != "M":
            continue
        args = event.get("args") or {}
        if event.get("name") == "process_name":
            procs[event.get("pid")] = args.get("name", "")
        elif event.get("name") == "thread_name":
            threads[(event.get("pid"), event.get("tid"))] = \
                args.get("name", "")
    out = {}
    for key, name in threads.items():
        pid = key[0]
        proc = procs.get(pid)
        out[key] = "%s/%s" % (proc, name) if proc else \
            "pid%s/%s" % (pid, name)
    return out, procs


def summarize_trace(doc, top=10):
    events = doc.get("traceEvents", [])
    names, procs = _track_names(events)
    tracks = {}
    for track, stats in _self_times(events).items():
        label = names.get(track) or (
            "%s/tid%s" % (procs.get(track[0], "pid%s" % track[0]),
                          track[1]))
        rows = sorted(
            ((name, s[0] / 1e6, s[1] / 1e6, s[2])
             for name, s in stats.items()),
            key=lambda row: -row[1])[:top]
        tracks[label] = [
            {"name": name, "self_s": round(self_s, 6),
             "total_s": round(total_s, 6), "count": count}
            for name, self_s, total_s, count in rows]
    counters = {}
    for event in events:
        if event.get("ph") == "C":
            counters[event["name"]] = (
                event.get("args") or {}).get("value")
    return {"kind": "trace", "tracks": tracks, "counters": counters,
            "events": sum(1 for e in events if e.get("ph") != "M")}


def summarize_flight(doc, top=10):
    tracks = {}
    counters = {}
    instants = {}
    for event in doc.get("events", ()):
        kind = event.get("kind")
        thread = event.get("thread", "?")
        if kind == "span":
            stats = tracks.setdefault(thread, {})
            entry = stats.setdefault(event["name"], [0.0, 0])
            entry[0] += float(event.get("dur_s") or 0.0)
            entry[1] += 1
        elif kind == "counter":
            counters[event["name"]] = (
                event.get("args") or {}).get("value")
        elif kind == "instant":
            instants[event["name"]] = instants.get(event["name"], 0) + 1
    rendered = {}
    for thread, stats in tracks.items():
        rows = sorted(((name, s[0], s[1]) for name, s in stats.items()),
                      key=lambda row: -row[1])[:top]
        rendered[thread] = [
            {"name": name, "self_s": round(total, 6),
             "total_s": round(total, 6), "count": count}
            for name, total, count in rows]
    return {"kind": "flight", "reason": doc.get("reason"),
            "tracks": rendered, "counters": counters,
            "instants": instants,
            "events": len(doc.get("events", ()))}


def summarize_heartbeats(doc, top=10):
    """Digest a heartbeat JSONL file: schema v2 lines (pre-telemetry)
    and v3 lines (``series`` + ``alerts`` blocks) side by side —
    counter RATES derived from consecutive lines' cumulative values,
    published under the measure.py filter-passes discipline, plus the
    last line's health and any alerts the file recorded."""
    from veles_tpu_torch.observe.profile import validate_heartbeat
    from veles_tpu_torch.tune.measure import (filter_passes,
                                              positive_majority_median)
    lines, schemas, invalid = [], {}, 0
    for record in doc.get("records", ()):
        try:
            validate_heartbeat(record)
        except ValueError:
            invalid += 1
            continue
        lines.append(record)
        schema = record["schema"]
        schemas[schema] = schemas.get(schema, 0) + 1
    samples = {}
    prev = None
    for record in lines:
        if prev is not None and record["ts"] > prev["ts"] and \
                record["session"] == prev["session"]:
            dt = record["ts"] - prev["ts"]
            for name, value in record["counters"].items():
                delta = value - prev["counters"].get(name, 0)
                if delta >= 0:  # a reset between lines is not a rate
                    samples.setdefault(name, []).append(delta / dt)
        prev = record
    rates = {}
    for name, rate_samples in samples.items():
        med = positive_majority_median(filter_passes(rate_samples))
        if med is not None:
            rates[name] = round(med, 3)
    ranked = sorted(rates.items(), key=lambda kv: -kv[1])[:top]
    last = lines[-1] if lines else {}
    alert_names = set()
    for record in lines:
        for entry in (record.get("alerts") or {}).get("history", ()):
            if entry.get("state") == "firing":
                alert_names.add(entry.get("alert"))
    return {"kind": "heartbeats", "events": len(lines),
            "invalid": invalid, "schemas": schemas,
            "sessions": len({r["session"] for r in lines}),
            "rates": dict(ranked),
            "health": last.get("health") or {},
            "throughput_sps": last.get("throughput_sps"),
            "series": last.get("series") or {},
            "alerts_fired": sorted(a for a in alert_names if a),
            "tracks": {}, "counters": {}, "instants": {}}


def summarize(doc, top=10):
    """Dispatch on document shape: flight dump, heartbeat JSONL, or
    trace file."""
    if doc.get("kind") == "flight":
        return summarize_flight(doc, top=top)
    if doc.get("kind") == "heartbeats":
        return summarize_heartbeats(doc, top=top)
    return summarize_trace(doc, top=top)


def render(summary, out=None):
    """Human-readable multi-line rendering (the CLI's output)."""
    import sys
    out = out if out is not None else sys.stdout
    header = "%s digest: %d events" % (summary["kind"],
                                       summary["events"])
    if summary.get("reason"):
        header += " (reason: %s)" % summary["reason"]
    print(header, file=out)
    if summary["kind"] == "heartbeats":
        print("  lines: %d valid (%d invalid), schemas %s, "
              "%d session(s)"
              % (summary["events"], summary["invalid"],
                 ",".join("v%d x%d" % (s, n) for s, n in
                          sorted(summary["schemas"].items())),
                 summary["sessions"]), file=out)
        if summary.get("throughput_sps") is not None:
            print("  last throughput: %.3f samples/s"
                  % summary["throughput_sps"], file=out)
        if summary.get("rates"):
            print("  steady-state rates (per second):", file=out)
            for name, rate in sorted(summary["rates"].items()):
                print("    %-32s %s" % (name, rate), file=out)
        series = summary.get("series") or {}
        if series.get("schema"):
            print("  series ring: %s buckets @ %ss"
                  % (series.get("buckets_held"),
                     series.get("interval_s")), file=out)
        if summary.get("alerts_fired"):
            print("  alerts fired: %s"
                  % ", ".join(summary["alerts_fired"]), file=out)
        return
    for label in sorted(summary["tracks"]):
        rows = summary["tracks"][label]
        if not rows:
            continue
        print("  track %s:" % label, file=out)
        for row in rows:
            print("    %-32s self %10.4fs  total %10.4fs  x%d" %
                  (row["name"], row["self_s"], row["total_s"],
                   row["count"]), file=out)
    if summary.get("counters"):
        print("  counters (last values):", file=out)
        for name in sorted(summary["counters"]):
            print("    %-32s %s" % (name, summary["counters"][name]),
                  file=out)
    if summary.get("instants"):
        print("  instants:", file=out)
        for name in sorted(summary["instants"]):
            print("    %-32s x%d" % (name, summary["instants"][name]),
                  file=out)


def request_digest_line(doc, top=3):
    """One line of per-request-segment attribution when the document
    carries request-scoped spans or exemplars (observe/requests.py);
    None otherwise — ``observe summary`` and :func:`digest_line`
    append it so CI logs show WHERE request time went."""
    from veles_tpu_torch.observe import requests as reqtrace
    records, counts = reqtrace.extract_requests(doc)
    if not records:
        return None
    report = reqtrace.analyze(records, counts, top=top)
    segs = sorted(report["segments"].items(),
                  key=lambda kv: -kv[1]["p99_ms"])[:top]
    parts = ", ".join("%s p99 %.3f ms" % (name, row["p99_ms"])
                      for name, row in segs)
    return "request segments: %d requests, %d legs; %s" % (
        report["requests"], report["legs"], parts or "no segments")


def digest_line(doc, top=3):
    """One line: the global top-N spans by self time, for CI logs."""
    summary = summarize(doc, top=top)
    merged = {}
    for rows in summary["tracks"].values():
        for row in rows:
            entry = merged.setdefault(row["name"], [0.0, 0])
            entry[0] += row["self_s"]
            entry[1] += row["count"]
    ranked = sorted(merged.items(), key=lambda kv: -kv[1][0])[:top]
    spans = ", ".join("%s %.3fs x%d" % (name, s, c)
                      for name, (s, c) in ranked) or "no spans"
    line = "trace digest: %d events; top self-time: %s" % (
        summary["events"], spans)
    req = request_digest_line(doc, top=top)
    return line if req is None else "%s; %s" % (line, req)
