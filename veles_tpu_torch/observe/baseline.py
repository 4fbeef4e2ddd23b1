"""The perf-regression sentinel: bench records against a baseline.

Counterpart of ``veles_tpu/observe/baseline.py``.  A baseline file pins
per-metric expectations (value, direction, tolerance) and :func:`gate`
compares a run's compact record plus heartbeat-derived steady-state
rates against it, under the ``tune/measure.py`` filter-passes
discipline (drop jitter-dominated samples, never clamp).  ``python -m
veles_tpu_torch.observe regress`` fronts it; a failure names the
regressed metric and, when a request trace or flight dump is at hand,
the dominant segment of the critical-path analyzer
(observe/requests.py).

The port's baseline is a file of its own, :data:`DEFAULT_BASELINE`
(``PERF_BASELINE_TORCH.json`` at the repository's root;
``$VELES_PERF_BASELINE`` or an explicit path overrides it).  The root
``PERF_BASELINE.json`` holds the JAX package's TPU numbers and is never
read by default: the port's numbers come from the card.  Until such a
file exists the gate passes with status ``no_baseline``.

Baseline format::

    {"schema": 1, "source": "<the run it was taken from>",
     "metrics": {"images_per_s": {"value": 470.0,
                                  "direction": "higher",
                                  "tolerance_pct": 10.0}, ...}}

``direction`` names which way is BETTER; a metric regresses when it
moves the other way by more than ``tolerance_pct``.  A metric in the
baseline but absent from the run is reported ``missing`` (the run did
not cover it) and does not fail the gate; a missing baseline passes
with status ``no_baseline``: the sentinel cannot regress against
nothing, and first runs must not be red.
"""

import json
import math
import os

__all__ = ["BASELINE_SCHEMA_VERSION", "DEFAULT_BASELINE",
           "load_baseline", "steady_state_rates", "compare", "gate",
           "dominant_segment", "render_report"]

BASELINE_SCHEMA_VERSION = 1

#: the port's own baseline at the repository's root (never the JAX
#: package's PERF_BASELINE.json); $VELES_PERF_BASELINE or an explicit
#: path argument overrides it
DEFAULT_BASELINE = "PERF_BASELINE_TORCH.json"


def _default_path():
    env = os.environ.get("VELES_PERF_BASELINE")
    if env:
        return env
    if os.path.exists(DEFAULT_BASELINE):
        return DEFAULT_BASELINE
    # else the repository root the package sits in (runs start from any
    # working directory)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, DEFAULT_BASELINE)


def load_baseline(path=None):
    """The parsed baseline, or ``None`` when there is none to hold a
    run against (missing file, unreadable JSON, wrong shape)."""
    path = path or _default_path()
    try:
        with open(path) as fh:
            base = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(base, dict) or \
            not isinstance(base.get("metrics"), dict):
        return None
    base.setdefault("schema", BASELINE_SCHEMA_VERSION)
    base["path"] = path
    return base


def steady_state_rates(buckets, names=None):
    """Steady-state per-second rates from telemetry buckets, one per
    counter, under the measure.py discipline: per-bucket rate samples
    filtered through ``filter_passes`` (a zero-rate bucket during
    warmup or drain measures the weather, not the program) and
    published as ``positive_majority_median`` — ``None``-valued
    metrics (no positive majority) are omitted."""
    from veles_tpu_torch.tune.measure import (filter_passes,
                                              positive_majority_median)
    samples = {}
    for bucket in buckets:
        for name, entry in (bucket.get("counters") or {}).items():
            rate = (entry or {}).get("rate")
            if isinstance(rate, (int, float)) and \
                    not isinstance(rate, bool) and math.isfinite(rate):
                samples.setdefault(name, []).append(float(rate))
    out = {}
    for name, rates in samples.items():
        if names is not None and name not in names:
            continue
        med = positive_majority_median(filter_passes(rates))
        if med is not None:
            out[name + ".rate"] = med
    return out


def _metric_values(record):
    """Flatten a compact bench record (or any {name: number} map)
    into comparable scalars; a headline metric/value pair is folded
    in under its own metric name."""
    values = {}
    if not isinstance(record, dict):
        return values
    headline = record.get("metric")
    for key, value in record.items():
        if isinstance(value, bool) or \
                not isinstance(value, (int, float)):
            continue
        if not math.isfinite(float(value)):
            continue
        values[key] = float(value)
    if headline and isinstance(values.get("value"), float):
        values[str(headline)] = values.pop("value")
    return values


def compare(record, baseline):
    """Per-metric verdicts of a run against a baseline.  Returns a
    list of ``{"metric", "status", "value", "baseline", "direction",
    "tolerance_pct", "delta_pct"}`` — status one of ``ok``,
    ``improved``, ``regressed``, ``missing`` (metric not in the run).
    Metrics the RUN has but the baseline does not are ignored: the
    baseline is the contract, new metrics join it by being
    committed."""
    values = _metric_values(record)
    results = []
    for name, spec in sorted((baseline.get("metrics") or {}).items()):
        base_value = spec.get("value")
        if not isinstance(base_value, (int, float)) or \
                isinstance(base_value, bool) or base_value == 0:
            continue
        direction = spec.get("direction", "higher")
        tolerance = float(spec.get("tolerance_pct", 10.0))
        entry = {"metric": name, "baseline": float(base_value),
                 "direction": direction, "tolerance_pct": tolerance}
        value = values.get(name)
        if value is None:
            entry.update(status="missing", value=None,
                         delta_pct=None)
            results.append(entry)
            continue
        delta_pct = 100.0 * (value - base_value) / abs(base_value)
        # signed so that POSITIVE means better: a lower-is-better
        # metric improving shrinks, so flip its sign
        gain_pct = delta_pct if direction == "higher" else -delta_pct
        if gain_pct < -tolerance:
            status = "regressed"
        elif gain_pct > tolerance:
            status = "improved"
        else:
            status = "ok"
        entry.update(status=status, value=value,
                     delta_pct=round(delta_pct, 2))
        results.append(entry)
    return results


def dominant_segment(analysis):
    """The segment that dominates the p99 tail in an analyzer report
    (observe/requests.py ``analyze``), or ``None``."""
    if not isinstance(analysis, dict):
        return None
    dominant = ((analysis.get("tail") or {}).get("dominant")) or {}
    if not dominant:
        return None
    return max(sorted(dominant), key=lambda seg: dominant[seg])


def gate(record, baseline_path=None, analysis=None, rates=None):
    """The go/no-go verdict: ``(ok, report)``.

    ``record`` is a compact bench record (or any flat metric map);
    ``rates`` optionally folds in :func:`steady_state_rates` output;
    ``analysis`` optionally attaches the analyzer report so a failure
    can name the dominant tail segment.  A missing baseline passes
    with ``status: "no_baseline"`` — never red on first run."""
    baseline = load_baseline(baseline_path)
    if baseline is None:
        return True, {"kind": "perf_gate", "status": "no_baseline",
                      "path": baseline_path or _default_path(),
                      "results": [], "regressed": []}
    merged = dict(record or {})
    for name, value in (rates or {}).items():
        merged.setdefault(name, value)
    results = compare(merged, baseline)
    regressed = [r for r in results if r["status"] == "regressed"]
    report = {"kind": "perf_gate",
              "status": "regressed" if regressed else "ok",
              "path": baseline.get("path"),
              "source": baseline.get("source"),
              "results": results,
              "regressed": [r["metric"] for r in regressed]}
    segment = dominant_segment(analysis)
    if segment:
        report["dominant_segment"] = segment
    return not regressed, report


def render_report(report):
    """Human lines for the CLI."""
    lines = []
    status = report.get("status")
    if status == "no_baseline":
        lines.append("perf gate: no baseline at %s (pass; commit "
                     "%s to arm the sentinel)"
                     % (report.get("path"), DEFAULT_BASELINE))
        return lines
    for entry in report.get("results", ()):
        if entry["status"] == "missing":
            lines.append("  %-34s missing from run (baseline %.6g)"
                         % (entry["metric"], entry["baseline"]))
            continue
        lines.append(
            "  %-34s %-9s %.6g vs %.6g (%+.2f%%, tol %.1f%% %s)"
            % (entry["metric"], entry["status"].upper(),
               entry["value"], entry["baseline"], entry["delta_pct"],
               entry["tolerance_pct"], entry["direction"]))
    if status == "regressed":
        head = "perf gate: REGRESSED — " + \
            ", ".join(report["regressed"])
        if report.get("dominant_segment"):
            head += " (dominant tail segment: %s)" \
                % report["dominant_segment"]
    else:
        head = "perf gate: ok (%d metrics vs %s)" \
            % (len(report.get("results", ())),
               report.get("source") or report.get("path"))
    lines.insert(0, head)
    return lines
