"""Cluster-scope trace correlation: clock offsets + chunk collection.

Counterpart of ``veles_tpu/observe/cluster.py``, whole and
stdlib-only; the fleet front estimates its hosts' clock offsets with
the same :func:`estimate_offset` over its telemetry polls.

A master and its slaves each record spans against their own process
clock; to read one job's ``proto.job_out -> slave step -> proto.
update_in`` path as a single flame graph the timelines must share a
clock.  Two pieces make that possible:

- :func:`estimate_offset` — an NTP-style offset estimate from the
  four-timestamp probe exchange the client runs at join time
  (``clock_probe`` / ``clock_probe_ack`` protocol messages).  The
  classic formulation: for each probe ``(t0, t1, t2, t3)`` (client
  send, server receive, server reply, client receive — all wall
  clock), offset = ((t1 - t0) + (t2 - t3)) / 2 and round-trip delay =
  (t3 - t0) - (t2 - t1).  The estimate from the MINIMUM-delay probe
  wins: queueing noise only ever inflates delay, so the fastest
  exchange is the one where the symmetric-path assumption is most
  honest.  Error is bounded by delay/2 under path asymmetry.

- :class:`TraceCollector` — the master-side store for the bounded
  trace chunks slaves ship back with their updates (or at session
  end).  Chunks keep their per-process wall anchors; the collector
  attaches the estimated clock offset and a stable track label per
  slave, which is exactly the shape :mod:`veles_tpu_torch.observe.merge`
  consumes.

Stdlib-only and import-light, like the rest of the observe package.
"""

import threading

from veles_tpu_torch.observe.trace import CHUNK_SCHEMA_VERSION

__all__ = ["estimate_offset", "probe_sample", "TraceCollector"]


def probe_sample(t0, t1, t2, t3):
    """One probe -> (offset_s, delay_s): positive offset means the
    SERVER clock is ahead of the client clock."""
    return ((t1 - t0) + (t2 - t3)) / 2.0, (t3 - t0) - (t2 - t1)


def estimate_offset(samples):
    """Best (offset_s, delay_s) over probe tuples ``(t0, t1, t2, t3)``.

    Picks the minimum-delay sample (see module docstring); raises
    ValueError on an empty sample set.  The returned offset converts a
    client wall timestamp to the server's clock as ``t + offset``.
    """
    if not samples:
        raise ValueError("no clock probe samples")
    best = None
    for sample in samples:
        offset, delay = probe_sample(*sample)
        if best is None or delay < best[1]:
            best = (offset, delay)
    return best


class TraceCollector(object):
    """Bounded per-slave store of shipped trace chunks + clock offsets.

    Keys are the slave's stable machine-process id (``mid``), so a
    slave that reconnects (quarantine TTL, network blip) keeps
    accumulating into the same logical track.  Memory is bounded by
    ``max_events`` across all slaves; past it new chunks are counted
    in ``dropped_events`` instead of growing the store — the master's
    observability must never become the master's OOM."""

    def __init__(self, max_events=500000):
        self._lock = threading.Lock()
        self._max_events = int(max_events)
        self._chunks = {}       # key -> [chunk, ...]
        self._offsets = {}      # key -> (offset_s, delay_s)
        self.total_events = 0
        self.dropped_events = 0

    def set_offset(self, key, offset, delay=None):
        """Record a slave's estimated clock offset (slave clock +
        offset = master clock at merge time; the protocol reports the
        server-ahead convention, see :func:`estimate_offset`)."""
        with self._lock:
            self._offsets[key] = (float(offset),
                                  None if delay is None else float(delay))

    def offset(self, key):
        pair = self._offsets.get(key)
        return pair[0] if pair else 0.0

    def add_chunk(self, key, chunk):
        """Store one shipped chunk; returns the number of events kept.
        Malformed or unknown-schema chunks are dropped whole (counted),
        never raised — a misbehaving slave must not take the master's
        event loop down."""
        if (not isinstance(chunk, dict)
                or chunk.get("schema") != CHUNK_SCHEMA_VERSION
                or not isinstance(chunk.get("events"), list)):
            with self._lock:
                self.dropped_events += (
                    len(chunk["events"])
                    if isinstance(chunk, dict)
                    and isinstance(chunk.get("events"), list) else 1)
            return 0
        events = chunk["events"]
        with self._lock:
            room = self._max_events - self.total_events
            if room <= 0:
                self.dropped_events += len(events)
                return 0
            if len(events) > room:
                self.dropped_events += len(events) - room
                chunk = dict(chunk, events=events[:room])
                events = chunk["events"]
            self._chunks.setdefault(key, []).append(chunk)
            self.total_events += len(events)
            return len(events)

    def keys(self):
        with self._lock:
            return list(self._chunks)

    def parts(self):
        """The merge-ready view: one part per slave — ``{"label",
        "offset_s", "chunks"}`` (see :func:`veles_tpu_torch.observe.merge.
        merge_parts`)."""
        with self._lock:
            out = []
            for key, chunks in self._chunks.items():
                label = chunks[0].get("label") or "slave:%s" % key
                out.append({
                    "label": label,
                    "offset_s": self.offset(key),
                    "chunks": list(chunks),
                })
            return out
