"""Observability CLI: ``python -m veles_tpu_torch.observe <command>``.

Counterpart of ``veles_tpu/observe/__main__.py``, the same commands
over the port's modules.

Commands:

- ``merge -o OUT master.json slave.json [--offset label=secs] ...`` —
  stitch saved per-process trace files into one Perfetto document with
  per-process tracks and offset-corrected timestamps (the first file
  is the reference clock).
- ``summary <trace.json|flight.json> [--top N]`` — print a textual
  digest (top spans by self time per track, counter last values) of a
  trace file or a flight-recorder dump, for CI logs and bug reports.
- ``requests trace.json host0.json ... [--offset label=secs]`` —
  request-scoped critical-path analysis over saved traces, flight
  dumps, and merged documents: per-segment p50/p99 table, dominant-
  segment tail attribution, hedge win/loss + requeue accounting.
  Trace files are offset-stitched like ``merge`` first, so one hedged
  request's legs on two hosts fold under one id.
- ``fleet series0.json series1.json [--offset label=secs] [--rules]``
  — merge per-host telemetry series snapshots (observe/timeseries.py)
  into offset-corrected fleet rollups and print the per-metric table;
  ``--rules`` evaluates the stock serve alert rules over the rollup.
- ``regress record.json [--baseline PERF_BASELINE_TORCH.json]
  [trace...]`` — the perf-regression sentinel: compare a compact bench
  record against the port's baseline; exits 1 naming the regressed
  metric (and the dominant tail segment when traces are given).
"""

import argparse
import sys


def _parse_offsets(entries):
    offsets = {}
    for entry in entries or ():
        label, sep, value = entry.partition("=")
        if not sep:
            raise SystemExit(
                "--offset expects label=seconds, got %r" % entry)
        offsets[label] = float(value)
    return offsets


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.observe",
        description="trace merging and digesting tools")
    sub = parser.add_subparsers(dest="command", required=True)

    pm = sub.add_parser("merge", help="merge per-process trace files")
    pm.add_argument("inputs", nargs="+", metavar="TRACE",
                    help="saved trace files; the first is the "
                         "reference clock")
    pm.add_argument("-o", "--output", required=True, metavar="OUT")
    pm.add_argument("--offset", action="append", default=[],
                    metavar="LABEL=SECS",
                    help="seconds to ADD to that process's clock to "
                         "land on the reference clock (repeatable); "
                         "defaults to the join-time estimate of 0")
    pm.add_argument("--trace-id", default=None)

    ps = sub.add_parser("summary",
                        help="digest a trace file or flight dump")
    ps.add_argument("input", metavar="TRACE_OR_FLIGHT")
    ps.add_argument("--top", type=int, default=10)

    pr = sub.add_parser(
        "requests",
        help="critical-path analysis of request-scoped traces")
    pr.add_argument("inputs", nargs="+", metavar="TRACE_OR_FLIGHT",
                    help="saved trace files and/or flight dumps; "
                         "trace files are offset-stitched first (the "
                         "first is the reference clock)")
    pr.add_argument("--offset", action="append", default=[],
                    metavar="LABEL=SECS",
                    help="clock offset for that process, as in merge")
    pr.add_argument("--top", type=int, default=5)
    pr.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")

    pf = sub.add_parser(
        "fleet",
        help="merge per-host telemetry snapshots into fleet rollups")
    pf.add_argument("inputs", nargs="+", metavar="SERIES",
                    help="per-host series snapshot files "
                         "(observe/timeseries.py snapshot/take_chunk)")
    pf.add_argument("--offset", action="append", default=[],
                    metavar="LABEL=SECS",
                    help="clock offset to ADD to that host's stamps")
    pf.add_argument("--interval", type=float, default=None,
                    help="rollup bucket width (default: the first "
                         "snapshot's interval)")
    pf.add_argument("--rules", action="store_true",
                    help="evaluate the stock serve alert rules over "
                         "the rollup")
    pf.add_argument("--json", action="store_true")

    pg = sub.add_parser(
        "regress", help="perf-regression gate vs the port's baseline")
    pg.add_argument("record", metavar="RECORD_JSON",
                    help="compact bench record (bench.py's last "
                         "line, saved as JSON)")
    pg.add_argument("traces", nargs="*", metavar="TRACE_OR_FLIGHT",
                    help="optional traces/flight dumps; a failing "
                         "gate then names the dominant tail segment")
    pg.add_argument("--baseline", default=None)
    pg.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)
    if args.command == "merge":
        from veles_tpu_torch.observe import merge
        merged = merge.merge_files(
            args.inputs, args.output,
            offsets=_parse_offsets(args.offset),
            trace_id=args.trace_id)
        for warning in merged["otherData"].get("warnings", ()):
            print("warning: %s" % warning, file=sys.stderr)
        print("merged %d events from %d processes -> %s" % (
            sum(1 for e in merged["traceEvents"]
                if e.get("ph") != "M"),
            len(merged["otherData"]["parts"]), args.output))
        return 0
    if args.command == "summary":
        from veles_tpu_torch.observe import summary
        doc = summary.load(args.input)
        summary.render(summary.summarize(doc, top=args.top))
        line = summary.request_digest_line(doc, top=args.top)
        if line:
            print("  " + line)
        return 0
    if args.command == "requests":
        from veles_tpu_torch.observe import requests as reqtrace
        report = reqtrace.analyze_files(
            args.inputs, offsets=_parse_offsets(args.offset),
            top=args.top)
        if args.json:
            import json
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            reqtrace.render_requests(report)
        return 0
    if args.command == "fleet":
        import json
        import os
        from veles_tpu_torch.observe.timeseries import (FleetTelemetry,
                                                        fleet_summary)
        offsets = _parse_offsets(args.offset)
        fleet = None
        for path in args.inputs:
            with open(path) as fh:
                snap = json.load(fh)
            if snap.get("kind") != "series":
                raise SystemExit(
                    "%s is not a series snapshot (kind=%r)"
                    % (path, snap.get("kind")))
            host = snap.get("label") or \
                os.path.splitext(os.path.basename(path))[0]
            if fleet is None:
                fleet = FleetTelemetry(
                    interval_s=args.interval or
                    snap.get("interval_s") or 5.0)
            if host in offsets:
                fleet.set_offset(host, offsets[host])
            if not fleet.add_chunk(host, snap):
                print("warning: dropped malformed snapshot %s" % path,
                      file=sys.stderr)
        rollup = fleet.rollup()
        summary = fleet_summary(rollup)
        fired = []
        if args.rules:
            from veles_tpu_torch.observe.alerts import (AlertManager,
                                                        default_rules)
            manager = AlertManager(default_rules())
            manager.evaluate(rollup, dump=False)
            fired = manager.history()
        if args.json:
            import json as _json
            print(_json.dumps({"summary": summary, "alerts": fired,
                               "fleet": fleet.snapshot()},
                              indent=2, sort_keys=True))
            return 0
        print("fleet rollup: %d buckets from %d host(s) %s"
              % (summary["buckets"], len(summary["hosts"]),
                 ",".join(summary["hosts"])))
        for name in sorted(summary["counters"]):
            row = summary["counters"][name]
            print("  counter %-32s total %-10s %s/s"
                  % (name, row["delta"], row["rate"]))
        for name in sorted(summary["gauges"]):
            print("  gauge   %-32s max %s"
                  % (name, summary["gauges"][name]))
        for name in sorted(summary["hists"]):
            row = summary["hists"][name]
            print("  hist    %-32s n=%-7d p50 %s p95 %s p99 %s"
                  % (name, row["count"], row.get("p50"),
                     row.get("p95"), row.get("p99")))
        for record in fired:
            print("  alert   %-32s %s %s" % (
                record["alert"], record["state"],
                record.get("reason", "")))
        return 0
    if args.command == "regress":
        import json
        from veles_tpu_torch.observe import baseline
        with open(args.record) as fh:
            record = json.load(fh)
        analysis = None
        if args.traces:
            from veles_tpu_torch.observe import requests as reqtrace
            analysis = reqtrace.analyze_files(args.traces)
        ok, report = baseline.gate(record,
                                   baseline_path=args.baseline,
                                   analysis=analysis)
        if args.json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            for line in baseline.render_report(report):
                print(line)
        return 0 if ok else 1
    return 1


if __name__ == "__main__":
    sys.exit(main())
