"""Merge per-process traces into one cluster-scope Perfetto timeline.

Counterpart of ``veles_tpu/observe/merge.py``, whole and stdlib-only.

Input: any mix of

- saved trace documents (``SpanTracer.save`` output, whose
  ``otherData`` carries the ``wall_epoch`` anchor and process label),
- shipped trace chunks (``SpanTracer.take_chunk`` output collected by
  the master's :class:`veles_tpu_torch.observe.cluster.TraceCollector`).

Output: ONE ``{"traceEvents": [...]}`` document where every source
process gets its own synthetic pid (with a ``process_name`` metadata
event), thread tracks keep their names, and all timestamps are
offset-corrected onto a single reference clock: each event's local
``ts`` (µs since its tracer's perf_counter epoch) is first mapped onto
its process's wall clock via the recorded ``wall_epoch`` anchor, then
shifted by the per-process clock offset estimated at join time
(observe/cluster.py), then rebased so the merged timeline starts at 0.
A job's ``proto.job_out`` (master), ``slave.job`` / fill / step spans
(slave) and ``proto.update_in`` (master) line up on adjacent process
tracks, linked by the job id in their args.

Entry point: :func:`merge_files` (the JAX package's ``observe merge``
command line waits for the port's ``observe/__main__.py``).
"""

import json

__all__ = ["part_from_doc", "merge_parts", "merge_run", "merge_files"]

_SYNTH_PID_BASE = 1


def part_from_doc(doc, label=None, offset_s=0.0):
    """Normalize a saved trace document into a merge part."""
    other = doc.get("otherData") or {}
    events = [e for e in doc.get("traceEvents", ())
              if e.get("ph") != "M" or e.get("name") == "thread_name"]
    threads = {}
    body = []
    for event in events:
        if event.get("ph") == "M":
            threads[str(event.get("tid"))] = (
                (event.get("args") or {}).get("name", ""))
        else:
            body.append(event)
    return {
        "label": label or other.get("label")
        or "pid:%s" % other.get("pid", "?"),
        "offset_s": float(offset_s),
        "chunks": [{
            "schema": 1,
            "pid": other.get("pid"),
            "wall_epoch": float(other.get("wall_epoch", 0.0)),
            "threads": threads,
            "events": body,
        }],
    }


def merge_parts(parts, trace_id=None):
    """Merge normalized parts (see module docstring) into one doc.

    Each part: ``{"label": str, "offset_s": float, "chunks": [chunk]}``
    where a chunk carries its own ``wall_epoch`` anchor, a ``threads``
    tid->name map, and raw tracer events.  ``offset_s`` is ADDED to the
    part's wall times to land on the reference clock (the master's),
    matching the join-time estimate convention of observe/cluster.py.
    """
    staged = []   # (wall_s, part_index, event)
    labels = []
    threads = {}  # (part_index, tid) -> name
    dropped = 0
    for index, part in enumerate(parts):
        labels.append(part.get("label") or "proc%d" % index)
        offset = float(part.get("offset_s") or 0.0)
        for chunk in part.get("chunks", ()):
            anchor = float(chunk.get("wall_epoch") or 0.0)
            for tid, name in (chunk.get("threads") or {}).items():
                threads.setdefault((index, str(tid)), name)
            for event in chunk.get("events", ()):
                ts = event.get("ts")
                if not isinstance(ts, (int, float)):
                    dropped += 1
                    continue
                staged.append((anchor + ts / 1e6 + offset, index, event))
    if not staged:
        base = 0.0
    else:
        base = min(wall for wall, _, _ in staged)
    out = []
    for index, label in enumerate(labels):
        pid = _SYNTH_PID_BASE + index
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": label}})
        # deterministic per-part ordering keeps merged docs diffable
        out.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"sort_index": index}})
    for (index, tid), name in sorted(threads.items(),
                                     key=lambda kv: str(kv[0])):
        out.append({"name": "thread_name", "ph": "M",
                    "pid": _SYNTH_PID_BASE + index, "tid": int(tid),
                    "args": {"name": name or "thread-%s" % tid}})
    staged.sort(key=lambda item: item[0])
    for wall, index, event in staged:
        merged = dict(event)
        merged["pid"] = _SYNTH_PID_BASE + index
        merged["ts"] = (wall - base) * 1e6
        out.append(merged)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "veles_tpu_torch.observe.merge",
            "trace_id": trace_id,
            "parts": labels,
            "wall_base": base,
            "dropped_events": dropped,
        },
    }


def merge_run(master_doc, collector, trace_id=None, master_label="master"):
    """Master trace + a TraceCollector's shipped slave chunks -> one
    merged doc (the launcher's end-of-run auto-merge)."""
    parts = [part_from_doc(master_doc, label=master_label)]
    parts.extend(collector.parts())
    return merge_parts(parts, trace_id=trace_id)


def merge_files(paths, out_path, offsets=None, trace_id=None):
    """Merge saved per-process trace files (first file is the reference
    clock).  ``offsets`` maps a file's label (or basename) to the
    seconds to add onto its clock; files whose otherData lacks an
    anchor merge at offset 0 with a warning in the result metadata."""
    import os
    offsets = offsets or {}
    parts = []
    warnings = []
    for path in paths:
        with open(path) as fin:
            doc = json.load(fin)
        label = (doc.get("otherData") or {}).get("label") or \
            os.path.basename(path)
        offset = offsets.get(label, offsets.get(os.path.basename(path),
                                                0.0))
        if (doc.get("otherData") or {}).get("wall_epoch") is None:
            # a pre-anchor trace file merges at wall 0 — decades away
            # from any anchored peer on the rebased timeline; say so
            # instead of silently producing an unusable merge
            warnings.append(
                "%s has no wall_epoch anchor; its events merge at an "
                "arbitrary clock position" % os.path.basename(path))
        parts.append(part_from_doc(doc, label=label, offset_s=offset))
    merged = merge_parts(parts, trace_id=trace_id)
    if warnings:
        merged["otherData"]["warnings"] = warnings
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fout:
        json.dump(merged, fout)
    os.replace(tmp, out_path)
    return merged
