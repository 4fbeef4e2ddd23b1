"""Time-series rollups: bounded rings of fixed-interval buckets.

Counterpart of ``veles_tpu/observe/timeseries.py``, whole and
stdlib-only: the bucket and chunk schemas are the JAX package's, so a
chunk from either package merges in the other's
:class:`FleetTelemetry`.

The storage layer of the fleet telemetry plane.  A
:class:`SeriesRing` samples the process MetricsRegistry at heartbeat
cadence into fixed-interval buckets —
counter -> per-second rate (plus the exact delta), gauge -> last
value, histogram -> a mergeable log-binned digest of the observations
that arrived since the previous tick — bounded in memory and
serializable as plain JSON.

Slaves and serve hosts ship not-yet-shipped buckets as bounded chunks
over the links that already carry trace chunks (the client/server
``series_chunk`` frame beside ``trace_chunk``, the fleet link's
``telemetry`` op beside its keepalive pings); the master/router-side
:class:`FleetTelemetry` aligns per-host buckets onto the LOCAL clock
with the observe/cluster.py NTP-style offsets and merges them into
fleet rollups with kind-true semantics:

- **counters sum** — rates (and deltas) add across hosts;
- **latency digests merge** — bin-wise, so a fleet percentile is
  recovered from the union of every host's observations rather than
  averaged from per-host percentiles (which has no meaning);
- **gauges take the max** — queue depth: the worst host is the one a
  burn-rate alert must see.

Everything here is stdlib-only and never raises into a caller's job
cycle: malformed chunks are counted and dropped whole, exactly the
TraceCollector discipline.
"""

import collections
import math
import os
import threading
import time

__all__ = ["SERIES_SCHEMA_VERSION", "DIGEST_BASE", "digest_values",
           "merge_digests", "digest_percentiles", "SeriesRing",
           "FleetTelemetry", "fleet_summary", "series"]

SERIES_SCHEMA_VERSION = 1

#: Log-spaced digest bin edges: ``edge(i) = DIGEST_BASE ** i``.  Base
#: 2**0.25 puts 4 bins per octave — a recovered percentile is off by
#: at most ~19% relative, bin keys stay small integers over the whole
#: microsecond..hour latency range, and two digests merge by adding
#: bin counts (the property per-host percentiles can never have).
DIGEST_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(DIGEST_BASE)
#: Non-positive observations (rate floors, zero durations) land in
#: the dedicated "z" bin whose edge is 0.0.
_ZERO_BIN = "z"


def _bin_key(value):
    if value <= 0.0:
        return _ZERO_BIN
    # ceil puts a value at its UPPER edge's bin: edge(i-1) < v <= edge(i)
    return str(int(math.ceil(math.log(value) / _LOG_BASE - 1e-12)))


def _bin_edge(key):
    if key == _ZERO_BIN:
        return 0.0
    return DIGEST_BASE ** int(key)


def digest_values(values):
    """Digest a batch of observations into a mergeable summary:
    ``{"count", "sum", "min", "max", "bins": {key: n}}``.  Non-finite
    values are skipped — a NaN latency must not poison a fleet
    percentile."""
    count = 0
    total = 0.0
    lo = hi = None
    bins = {}
    for value in values:
        value = float(value)
        if not math.isfinite(value):
            continue
        count += 1
        total += value
        if lo is None or value < lo:
            lo = value
        if hi is None or value > hi:
            hi = value
        key = _bin_key(value)
        bins[key] = bins.get(key, 0) + 1
    return {"count": count, "sum": total, "min": lo, "max": hi,
            "bins": bins}


def merge_digests(digests):
    """Bin-wise merge — the percentile-merge half of the rollup
    contract.  Tolerates None / malformed entries (a host's bucket
    may simply lack the histogram this round)."""
    out = {"count": 0, "sum": 0.0, "min": None, "max": None, "bins": {}}
    for digest in digests:
        if not isinstance(digest, dict):
            continue
        try:
            out["count"] += int(digest.get("count") or 0)
            out["sum"] += float(digest.get("sum") or 0.0)
        except (TypeError, ValueError):
            continue
        for bound, pick in (("min", min), ("max", max)):
            val = digest.get(bound)
            if isinstance(val, (int, float)) and math.isfinite(val):
                out[bound] = val if out[bound] is None \
                    else pick(out[bound], val)
        raw = digest.get("bins")
        if isinstance(raw, dict):
            for key, n in raw.items():
                try:
                    out["bins"][key] = out["bins"].get(key, 0) + int(n)
                except (TypeError, ValueError):
                    continue
    return out


def digest_percentiles(digest, ps=(50, 95, 99)):
    """Nearest-rank percentiles recovered from a digest: each bin
    answers with its UPPER edge (pessimistic by at most one bin
    width, ~19%), clamped into the digest's exact [min, max]."""
    if not isinstance(digest, dict):
        return {}
    bins = digest.get("bins") or {}
    items = sorted((_bin_edge(key), int(n)) for key, n in bins.items()
                   if n)
    total = sum(n for _, n in items)
    if not total:
        return {}
    lo, hi = digest.get("min"), digest.get("max")
    out = {}
    for p in ps:
        rank = max(1, min(total, int(math.ceil(p / 100.0 * total))))
        cum = 0
        value = items[-1][0]
        for edge, n in items:
            cum += n
            if cum >= rank:
                value = edge
                break
        if isinstance(hi, (int, float)):
            value = min(value, hi)
        if isinstance(lo, (int, float)):
            value = max(value, lo)
        out["p%d" % p] = value
    return out


class SeriesRing(object):
    """Bounded ring of fixed-interval buckets over one
    MetricsRegistry.

    ``tick()`` closes one bucket: counter values become {delta, rate}
    against the previous tick, gauges report their last (finite
    numeric) value, histograms digest exactly the observations that
    arrived since the previous tick (count delta against the window
    ring — see ``Histogram.recent``).  The FIRST tick only primes the
    counter baselines and emits no bucket: a ring attached to a
    long-running registry must not open with a since-boot "rate".

    ``maybe_tick()`` is the pull-cadence entry for callers without a
    heartbeat thread (the serve transport answering a telemetry poll,
    the slave shipping beside an update): it ticks only once
    ``interval_s`` has elapsed, so heartbeat and link cadences share
    one ring without double-sampling.  Rates always divide by the
    ACTUAL elapsed time, so a late tick stays correct.
    """

    def __init__(self, interval_s=5.0, capacity=240, registry=None,
                 label=None):
        from veles_tpu_torch.observe import metrics as _metrics
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.label = label
        self._metrics_mod = _metrics
        self._registry = registry if registry is not None \
            else _metrics.registry
        self._lock = threading.Lock()
        self._buckets = collections.deque(maxlen=self.capacity)
        self._last_counters = None     # None = unprimed
        self._last_hist_counts = {}
        self._last_tick = None         # monotonic
        self._seq = 0
        self._shipped_seq = 0          # take_chunk cursor

    def __len__(self):
        with self._lock:
            return len(self._buckets)

    def maybe_tick(self, now=None, wall=None):
        """Tick if (and only if) the interval elapsed — or prime on
        first call.  Returns the new bucket or None."""
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last_tick
        if last is not None and now - last < self.interval_s:
            return None
        return self.tick(now=now, wall=wall)

    def tick(self, now=None, wall=None):
        """Close one bucket from the registry's current state.
        Returns the bucket dict, or None on the priming tick."""
        _m = self._metrics_mod
        now = time.monotonic() if now is None else now
        wall = time.time() if wall is None else wall
        counters = {}
        gauges = {}
        hists = {}
        cur_counters = {}
        cur_hist_counts = {}
        pairs = self._registry.items()
        with self._lock:
            primed = self._last_tick is not None and \
                self._last_counters is not None
            dur = (now - self._last_tick) if primed else None
            for name, metric in pairs:
                if isinstance(metric, _m.Counter):
                    cur_counters[name] = value = metric.value
                    if not primed:
                        continue
                    delta = value - self._last_counters.get(name, 0)
                    if delta < 0:
                        # registry reset between ticks (bench A/B
                        # legs): the whole lifetime value is new
                        delta = value
                    counters[name] = {
                        "delta": delta,
                        "rate": delta / max(dur, 1e-9)}
                elif isinstance(metric, _m.Gauge):
                    value = metric.value
                    if isinstance(value, bool) or not \
                            isinstance(value, (int, float)):
                        continue
                    if not math.isfinite(value):
                        continue
                    if primed:
                        gauges[name] = value
                elif isinstance(metric, _m.Histogram):
                    cur_hist_counts[name] = count = metric.count
                    if not primed:
                        continue
                    delta = count - self._last_hist_counts.get(name, 0)
                    if delta < 0:
                        delta = count
                    if delta <= 0:
                        continue
                    values = metric.recent(delta)
                    digest = digest_values(values)
                    if delta > len(values):
                        # window ring overran between ticks: the
                        # digest covers the newest `window` values;
                        # name the loss instead of hiding it
                        digest["dropped"] = delta - len(values)
                    hists[name] = digest
            self._last_counters = cur_counters
            self._last_hist_counts = cur_hist_counts
            self._last_tick = now
            if not primed:
                return None
            bucket = {"seq": self._seq, "ts": wall,
                      "dur_s": round(dur, 6),
                      "counters": counters, "gauges": gauges,
                      "hists": hists}
            self._seq += 1
            self._buckets.append(bucket)
        try:
            self._registry.gauge("telemetry.buckets").set(
                len(self._buckets))
        except Exception:
            pass
        return bucket

    def buckets(self, last=None):
        """The newest ``last`` buckets (all when None), oldest first."""
        with self._lock:
            out = list(self._buckets)
        if last is not None and last > 0:
            out = out[-int(last):]
        return out

    def last_bucket(self):
        with self._lock:
            return self._buckets[-1] if self._buckets else None

    def snapshot(self, last=None, label=None):
        """Serializable, mergeable view: the wire/export format every
        consumer (telemetry polls, ``observe fleet`` files,
        FleetTelemetry.add_chunk) shares."""
        return {"kind": "series", "schema": SERIES_SCHEMA_VERSION,
                "interval_s": self.interval_s,
                "label": label if label is not None else self.label,
                "buckets": self.buckets(last=last)}

    def take_chunk(self, max_buckets=32, label=None):
        """Pop a bounded chunk of NOT-yet-shipped buckets (the trace
        ``take_chunk`` contract): returns a snapshot-shaped dict or
        None when nothing new accrued.  Single-consumer — the
        master-link shipper; fan-out readers use ``snapshot`` (the
        receiving FleetTelemetry dedups by seq either way)."""
        with self._lock:
            fresh = [b for b in self._buckets
                     if b["seq"] >= self._shipped_seq]
            fresh = fresh[:max(1, int(max_buckets))]
            if not fresh:
                return None
            self._shipped_seq = fresh[-1]["seq"] + 1
        try:
            self._registry.counter("telemetry.chunks_shipped").inc()
        except Exception:
            pass
        return {"kind": "series", "schema": SERIES_SCHEMA_VERSION,
                "interval_s": self.interval_s,
                "label": label if label is not None else self.label,
                "buckets": fresh}

    def heartbeat_block(self):
        """The compact ``series`` block a v3 heartbeat line carries:
        ring shape plus the newest bucket (the full ring ships over
        the chunk paths, not the heartbeat file)."""
        with self._lock:
            held = len(self._buckets)
            last = self._buckets[-1] if self._buckets else None
        return {"schema": SERIES_SCHEMA_VERSION,
                "interval_s": self.interval_s,
                "buckets_held": held,
                "last": last}

    def clear(self):
        """Reset buckets AND baselines (test isolation / bench legs)."""
        with self._lock:
            self._buckets.clear()
            self._last_counters = None
            self._last_hist_counts = {}
            self._last_tick = None
            self._seq = 0
            self._shipped_seq = 0


class FleetTelemetry(object):
    """Master/router-side store: bounded per-host bucket series plus
    clock offsets, merged on demand into fleet rollups.

    Offsets follow the trace-merge convention (observe/cluster.py):
    ``host_wall + offset = local_wall``, fed either directly from the
    slave's ``clock_report`` (``set_offset``) or from raw NTP probe
    samples the fleet link's telemetry polls piggyback
    (``add_probe`` -> ``estimate_offset``, min-delay sample wins).

    ``add_chunk`` validates-and-drops like TraceCollector: a
    malformed chunk is counted, never raised; re-shipped buckets
    (snapshot-mode producers overlap on purpose) dedup by per-host
    ``seq`` so a rollup never double-counts."""

    def __init__(self, interval_s=5.0, max_buckets_per_host=240):
        self.interval_s = float(interval_s)
        self.max_buckets = int(max_buckets_per_host)
        self._lock = threading.Lock()
        self._hosts = {}       # label -> deque of buckets
        self._last_seq = {}    # label -> newest seq accepted
        self._offsets = {}     # label -> (offset_s, delay_s)
        self._probes = {}      # label -> deque of NTP samples
        self.chunks = 0
        self.dropped = 0

    # -- clock alignment ----------------------------------------------------

    def set_offset(self, host, offset, delay=None):
        try:
            offset = float(offset)
        except (TypeError, ValueError):
            return
        if not math.isfinite(offset):
            return
        with self._lock:
            self._offsets[str(host)] = (offset, delay)

    def offset(self, host):
        with self._lock:
            entry = self._offsets.get(str(host))
        return entry[0] if entry else 0.0

    def add_probe(self, host, sample):
        """Feed one (t0, t1, t2, t3) wall-clock probe; the offset
        estimate is refreshed from the newest 8 samples (min-delay
        wins — the cluster.estimate_offset discipline)."""
        from veles_tpu_torch.observe.cluster import estimate_offset
        try:
            t0, t1, t2, t3 = (float(v) for v in sample)
        except (TypeError, ValueError):
            return
        if not all(math.isfinite(v) for v in (t0, t1, t2, t3)):
            return
        host = str(host)
        with self._lock:
            ring = self._probes.setdefault(
                host, collections.deque(maxlen=8))
            ring.append((t0, t1, t2, t3))
            samples = list(ring)
        try:
            offset, delay = estimate_offset(samples)
        except (ValueError, ZeroDivisionError):
            return
        self.set_offset(host, offset, delay)

    # -- ingest -------------------------------------------------------------

    def add_chunk(self, host, chunk):
        """Ingest one series chunk for ``host``; False (and counted)
        when malformed.  Never raises."""
        if not isinstance(chunk, dict) or \
                chunk.get("schema") != SERIES_SCHEMA_VERSION or \
                not isinstance(chunk.get("buckets"), list):
            self.dropped += 1
            return False
        host = str(host)
        accepted = 0
        with self._lock:
            ring = self._hosts.setdefault(
                host, collections.deque(maxlen=self.max_buckets))
            last_seq = self._last_seq.get(host)
            for bucket in chunk["buckets"]:
                if not isinstance(bucket, dict) or not \
                        isinstance(bucket.get("ts"), (int, float)):
                    continue
                seq = bucket.get("seq")
                if isinstance(seq, int):
                    if last_seq is not None and seq <= last_seq:
                        continue  # overlap re-ship: already held
                    last_seq = seq
                ring.append(bucket)
                accepted += 1
            if last_seq is not None:
                self._last_seq[host] = last_seq
            self.chunks += 1
        return accepted > 0

    def hosts(self):
        with self._lock:
            return sorted(self._hosts)

    def host_buckets(self, host):
        with self._lock:
            return list(self._hosts.get(str(host), ()))

    # -- rollup -------------------------------------------------------------

    def rollup(self, window=None):
        """Merge per-host buckets onto the local clock: bucket cell =
        ``floor((ts + offset) / interval_s)``.  Returns merged
        buckets oldest first (the newest ``window`` cells when set),
        each carrying the contributing host list."""
        with self._lock:
            hosts = {h: list(ring) for h, ring in self._hosts.items()}
            offsets = {h: entry[0]
                       for h, entry in self._offsets.items()}
        cells = {}
        for host, buckets in hosts.items():
            off = offsets.get(host, 0.0)
            for bucket in buckets:
                key = int(math.floor(
                    (bucket["ts"] + off) / self.interval_s))
                cell = cells.get(key)
                if cell is None:
                    cell = cells[key] = {
                        "hosts": set(), "counters": {},
                        "gauges": {}, "hists": {}}
                cell["hosts"].add(host)
                for name, c in (bucket.get("counters") or {}).items():
                    if not isinstance(c, dict):
                        continue
                    agg = cell["counters"].setdefault(
                        name, {"delta": 0, "rate": 0.0})
                    try:
                        agg["delta"] += c.get("delta") or 0
                        agg["rate"] += c.get("rate") or 0.0
                    except TypeError:
                        continue
                for name, value in (bucket.get("gauges") or {}).items():
                    if not isinstance(value, (int, float)):
                        continue
                    prev = cell["gauges"].get(name)
                    cell["gauges"][name] = value if prev is None \
                        else max(prev, value)
                for name, digest in (bucket.get("hists") or {}).items():
                    cell["hists"].setdefault(name, []).append(digest)
        keys = sorted(cells)
        if window is not None and window > 0:
            keys = keys[-int(window):]
        out = []
        for key in keys:
            cell = cells[key]
            out.append({
                "ts": key * self.interval_s,
                "dur_s": self.interval_s,
                "hosts": sorted(cell["hosts"]),
                "counters": cell["counters"],
                "gauges": cell["gauges"],
                "hists": {name: merge_digests(ds)
                          for name, ds in cell["hists"].items()},
            })
        return out

    def series(self, name, kind="counter", field="rate", window=None):
        """One metric's per-bucket values over the rollup tail:
        counters -> ``field`` ("rate"/"delta", 0.0 when absent),
        gauges -> value-or-None, hists -> digest-or-None."""
        out = []
        for bucket in self.rollup(window=window):
            if kind == "counter":
                entry = bucket["counters"].get(name)
                out.append((entry or {}).get(field, 0.0)
                           if entry else 0.0)
            elif kind == "gauge":
                out.append(bucket["gauges"].get(name))
            else:
                out.append(bucket["hists"].get(name))
        return out

    def snapshot(self):
        """Plain-data view for /healthz and the ``observe fleet``
        CLI."""
        with self._lock:
            hosts = {
                host: {
                    "buckets": len(ring),
                    "offset_s": self._offsets.get(host, (0.0,))[0],
                    "last_ts": ring[-1]["ts"] if ring else None,
                }
                for host, ring in self._hosts.items()}
        return {"schema": SERIES_SCHEMA_VERSION,
                "interval_s": self.interval_s,
                "hosts": hosts, "chunks": self.chunks,
                "dropped": self.dropped}

    def clear(self):
        with self._lock:
            self._hosts.clear()
            self._last_seq.clear()
            self._offsets.clear()
            self._probes.clear()
            self.chunks = 0
            self.dropped = 0


def fleet_summary(buckets):
    """Collapse rollup buckets (or any bucket list) into one
    per-metric table — the ``observe fleet`` CLI body, the /healthz
    digest, and what soak receipts compare against per-host evidence:
    counters -> total delta + mean rate, gauges -> max, histograms ->
    merged-digest count/p50/p95/p99."""
    buckets = list(buckets)
    counters, gauges, hist_digests = {}, {}, {}
    hosts = set()
    for bucket in buckets:
        for host in bucket.get("hosts") or ():
            hosts.add(host)
        for name, entry in (bucket.get("counters") or {}).items():
            if not isinstance(entry, dict):
                continue
            agg = counters.setdefault(name, {"delta": 0, "rates": []})
            agg["delta"] += entry.get("delta") or 0
            rate = entry.get("rate")
            if isinstance(rate, (int, float)):
                agg["rates"].append(float(rate))
        for name, value in (bucket.get("gauges") or {}).items():
            if not isinstance(value, (int, float)):
                continue
            prev = gauges.get(name)
            gauges[name] = value if prev is None else max(prev, value)
        for name, digest in (bucket.get("hists") or {}).items():
            hist_digests.setdefault(name, []).append(digest)
    out_counters = {
        name: {"delta": agg["delta"],
               "rate": round(sum(agg["rates"]) / len(agg["rates"]), 4)
               if agg["rates"] else 0.0}
        for name, agg in counters.items()}
    out_hists = {}
    for name, digests in hist_digests.items():
        merged = merge_digests(digests)
        row = {"count": merged["count"]}
        row.update(digest_percentiles(merged))
        out_hists[name] = row
    return {"buckets": len(buckets), "hosts": sorted(hosts),
            "counters": out_counters, "gauges": gauges,
            "hists": out_hists}


def _default_interval_s():
    """``VELES_SERIES_INTERVAL_S`` overrides the global ring's 5 s
    bucket width — how a soak driver runs its subprocess hosts at
    soak-scale cadence without a config file."""
    try:
        value = float(os.environ.get("VELES_SERIES_INTERVAL_S", ""))
    except ValueError:
        return 5.0
    return value if value > 0 else 5.0


#: The process-wide ring every producer feeds: the Heartbeat ticks it
#: at metrics cadence, the slave's update shipping and the serve
#: transport's telemetry polls ``maybe_tick`` it as a fallback, and
#: every shipper chunks from it.
series = SeriesRing(interval_s=_default_interval_s())
