"""Digest-keyed persistent schedule cache.

Counterpart of ``veles_tpu/tune/cache.py``, with its file layout,
schema, bank format, merge policy and counters.  The tuner's winners
live in one JSON table, ``<cache-dir>/schedules.json``
(``VELES_SCHEDULE_CACHE`` names the directory; the default is
``schedule_cache`` under ``root.common.dirs.cache``), mapping a sha256
digest of

    (op name, shape tuple, dtype, precision level, device kind,
     torch version, port kernel version)

to the winning schedule: a kernel's launch parameters ONLY, never
anything that changes what is computed (the precision level and the
dtype are key coordinates, never genes).  Where the JAX key names
``"jax"`` (its version) the port's names ``"torch"``.  The device kind is
the name of the card the operand lies on
(``torch.cuda.get_device_name``), ``"cpu"`` for a CPU tensor.  The port
kernel version (``ops.common.PORT_KERNEL_VERSIONS``) rides the digest,
so a schedule tuned for an old kernel design misses for a new one.

:func:`consult` is the kernels' hook (``ops/matmul.py``,
``matmul_int8.py``, ``conv_vjp.py``, ``attention.py``,
``pool_bwd.py``): a memoized table lookup keyed by (cache, op, device
kind, the call's key coordinates), so a repeated call pays neither the
JSON dump nor the sha256 of its digest; every ``put`` and bank merge
clears the memo.  It runs on the host only (no CUDA call, sync or
copy), so it also runs inside a CUDA-graph capture: a captured step
keeps the schedule it captured with.  A corrupt or malformed entry is
one logged warning and the kernel's static plan, never an error.  It
counts ``tune.cache_hits`` / ``tune.cache_misses`` and, under
:func:`record_specs`, records the full spec (how ``tune/walk.py``
harvests the shapes a step uses).

A bank the JAX package exported merges as ``invalid``: its entries
name ``"jax"`` where the port's name ``"torch"``, and their schedules
are Pallas tiles, not the port's genes.
"""

import functools
import hashlib
import json
import logging
import os
import tempfile
import threading

import torch

__all__ = ["ScheduleCache", "schedule_key", "schedule_for", "consult",
           "provenance", "cache_for", "default_cache_dir",
           "device_kind", "record_specs", "tune_counters",
           "SCHEDULE_CACHE_SCHEMA", "MeasurementLog", "measurement_log",
           "record_measurement", "load_bank", "BANK_FILE_NAME"]

logger = logging.getLogger("veles_tpu_torch.tune")

#: bump when the cache FILE layout changes (entry payloads carry their
#: own per-kernel versions inside the digest)
SCHEDULE_CACHE_SCHEMA = 1

_FILE_NAME = "schedules.json"

#: the measured-triple sidecar beside ``schedules.json``: the cost
#: model's training data
_MEASUREMENTS_NAME = "measurements.jsonl"

#: an append that finds the sidecar past this size compacts it to the
#: newest ``_MEASUREMENTS_KEEP`` rows
_MEASUREMENTS_MAX_BYTES = 8 * 2 ** 20
_MEASUREMENTS_KEEP = 10000

#: the portable fleet-bank file name used by the publish channel
BANK_FILE_NAME = "schedule_bank.json"


def default_cache_dir():
    """``$VELES_SCHEDULE_CACHE`` or ``<root.common.dirs.cache>/
    schedule_cache``, resolved per call so that tests redirect it
    through the environment."""
    env = os.environ.get("VELES_SCHEDULE_CACHE", "")
    if env:
        return env
    from veles_tpu_torch.config import root
    return os.path.join(root.common.dirs.get(
        "cache", os.path.join(tempfile.gettempdir(), "veles_tpu_torch",
                              "cache")), "schedule_cache")


@functools.lru_cache(maxsize=4096)
def _digest(payload_json):
    return hashlib.sha256(payload_json.encode("utf-8")).hexdigest()


def schedule_key(op, shape, dtype, precision_level, device_kind,
                 extra=None):
    """(digest, payload) for one schedule-cache entry.  ``shape`` is the
    family's key shape (``tune/spec.py``); ``extra`` carries the port
    kernel version."""
    payload = {
        "op": str(op),
        "shape": [int(s) for s in shape],
        "dtype": str(dtype),
        "precision_level": int(precision_level),
        "device_kind": str(device_kind),
        "torch": torch.__version__,
    }
    if extra:
        payload.update({str(k): extra[k] for k in sorted(extra)})
    return _digest(json.dumps(payload, sort_keys=True)), payload


#: card names by device index, read once (a host-only lookup after)
_KINDS = {}


def device_kind(device=None):
    """The key's device coordinate: the card's name for a CUDA device,
    ``"cpu"`` for the CPU.  ``device`` a ``torch.device``, a string or
    None (the first card where there is one, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    kind = _KINDS.get(index)
    if kind is None:
        kind = _KINDS[index] = torch.cuda.get_device_name(index)
    return kind


class ScheduleCache(object):
    """One on-disk schedule table: lazy load, atomic save, tolerant of
    corruption (a broken file logs a warning and reads as empty: it is a
    CACHE; the kernels' static rules are the source of truth)."""

    def __init__(self, path=None):
        self.path = path or os.path.join(default_cache_dir(),
                                         _FILE_NAME)
        self._lock = threading.Lock()
        self._entries = None
        self._warned = set()

    # -- load/save -----------------------------------------------------------

    def _read_disk(self):
        """The on-disk table, or {} (with ONE warning when corrupt)."""
        try:
            with open(self.path) as fin:
                data = json.load(fin)
            if (not isinstance(data, dict)
                    or data.get("schema") != SCHEDULE_CACHE_SCHEMA
                    or not isinstance(data.get("entries"), dict)):
                raise ValueError("unrecognized schedule cache layout")
            return data["entries"]
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as exc:
            self._warn_once(
                "corrupt", "schedule cache %s unreadable (%s); "
                "the kernels' static plans serve" % (self.path, exc))
            return {}

    def _load(self):
        if self._entries is None:
            self._entries = self._read_disk()
        return self._entries

    def _adopt(self, entries):
        """Replace the in-memory table (under the lock); the consult
        memo was built from the old one."""
        self._entries = entries
        invalidate()

    def _save(self):
        data = {"schema": SCHEDULE_CACHE_SCHEMA,
                "entries": self._entries or {}}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = "%s.%d.%d.tmp" % (self.path, os.getpid(),
                                threading.get_ident())
        with open(tmp, "w") as fout:
            json.dump(data, fout, indent=1, sort_keys=True)
            fout.flush()
        os.replace(tmp, self.path)

    def _warn_once(self, key, message):
        if key not in self._warned:
            self._warned.add(key)
            logger.warning(message)

    # -- table API -----------------------------------------------------------

    def get(self, digest):
        """The full entry dict for ``digest`` or None.  A structurally
        invalid entry (no ``schedule`` dict) warns once and misses."""
        with self._lock:
            entry = self._load().get(digest)
        if entry is None:
            return None
        if (not isinstance(entry, dict)
                or not isinstance(entry.get("schedule"), dict)):
            self._warn_once(
                digest, "schedule cache entry %s malformed; ignoring "
                "(the kernel's static plan serves this shape)"
                % digest[:12])
            return None
        return entry

    def put(self, digest, payload, schedule, fitness=None,
            source="ga", evals=None):
        """Persist one winner.  ``schedule`` is the family's gene dict;
        ``fitness`` the GA's (negative seconds)."""
        entry = dict(payload)
        entry["schedule"] = dict(schedule)
        entry["source"] = source
        if fitness is not None:
            entry["fitness"] = float(fitness)
        if evals is not None:
            entry["evals"] = int(evals)
        with self._lock:
            # re-read the file before the read-modify-write: another
            # process may have added or re-tuned entries since the lazy
            # load; the disk wins for every digest but this one
            merged = self._read_disk()
            merged[digest] = entry
            self._adopt(merged)
            self._save()
        return entry

    def entries(self):
        with self._lock:
            return dict(self._load())

    def __len__(self):
        with self._lock:
            return len(self._load())

    # -- fleet bank ----------------------------------------------------------

    def export_bank(self, path):
        """Write the whole table as one portable bank file (atomic
        write): entries verbatim plus per-entry ``host`` provenance.
        Returns the entry count."""
        import socket
        host = socket.gethostname()
        with self._lock:
            entries = self._read_disk()
            self._adopt(entries)
        exported = {}
        for digest, entry in sorted(entries.items()):
            entry = dict(entry)
            entry.setdefault("host", host)
            exported[digest] = entry
        bank = {"schema": SCHEDULE_CACHE_SCHEMA,
                "kind": "schedule_bank", "host": host,
                "torch": torch.__version__, "entries": exported}
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fout:
            json.dump(bank, fout, indent=1, sort_keys=True)
            fout.flush()
        os.replace(tmp, path)
        return len(exported)

    def merge_bank(self, bank):
        """Merge a fleet bank (dict or path) into the table under the
        same re-read-before-write discipline as :meth:`put`.

        Per digest, the disk wins except for a better fitness: a bank
        entry is adopted only when the digest is absent locally or the
        bank's measured fitness is strictly higher (negative seconds).
        An entry whose digest does not match a recompute over its own
        key coordinates is ``stale``; one whose schedule is not the
        port's genes, or whose key is not the port's (a JAX bank names
        ``"jax"``), is ``invalid``.  Returns the count dict
        ``{"adopted", "kept", "stale", "invalid", "total"}``."""
        from veles_tpu_torch.tune.spec import valid_schedule
        if not isinstance(bank, dict):
            bank = load_bank(bank)
        entries = bank.get("entries") or {}
        counts = {"adopted": 0, "kept": 0, "stale": 0, "invalid": 0,
                  "total": len(entries)}
        adoptable = {}
        for digest, entry in entries.items():
            if not isinstance(entry, dict):
                counts["invalid"] += 1
                continue
            payload = {k: v for k, v in entry.items()
                       if k not in _NON_KEY_FIELDS}
            if _digest(json.dumps(payload, sort_keys=True)) != digest:
                counts["stale"] += 1
                continue
            if ("torch" not in payload or "jax" in payload
                    or valid_schedule(entry.get("op"),
                                      entry.get("schedule")) is None):
                counts["invalid"] += 1
                continue
            adoptable[digest] = entry
        with self._lock:
            merged = self._read_disk()
            for digest, entry in adoptable.items():
                local = merged.get(digest)
                if local is not None and not _fitter(entry, local):
                    counts["kept"] += 1
                    continue
                merged[digest] = dict(entry)
                counts["adopted"] += 1
            self._adopt(merged)
            if counts["adopted"]:
                self._save()
        reg = _counters()
        reg.counter("tune.bank_merged").inc()
        if counts["adopted"]:
            reg.counter("tune.bank_entries").inc(counts["adopted"])
        return counts


#: entry fields that ride beside the key payload (everything else in an
#: entry is a schedule_key coordinate)
_NON_KEY_FIELDS = frozenset(
    ("schedule", "source", "fitness", "evals", "host"))


def _fitter(challenger, incumbent):
    """True when the challenger's measured fitness strictly beats the
    incumbent's (an unmeasured challenger never displaces anything; an
    unmeasured incumbent yields to any measured challenger)."""
    cf = challenger.get("fitness")
    if cf is None:
        return False
    inf = incumbent.get("fitness")
    return inf is None or float(cf) > float(inf)


def load_bank(path):
    """Read + structurally verify one bank file; raises ValueError on
    anything that is not a schedule bank of the current schema."""
    with open(path) as fin:
        bank = json.load(fin)
    if (not isinstance(bank, dict)
            or bank.get("kind") != "schedule_bank"
            or bank.get("schema") != SCHEDULE_CACHE_SCHEMA
            or not isinstance(bank.get("entries"), dict)):
        raise ValueError("%s is not a schedule bank (schema %s)"
                         % (path, SCHEDULE_CACHE_SCHEMA))
    return bank


class MeasurementLog(object):
    """The ``measurements.jsonl`` sidecar: every measured (spec,
    schedule, slope) triple the tuner ranks, one JSON row a line: the
    cost model's training set.  Rows carry the full digest payload, so
    loads filter to the CURRENT torch version, device kind and kernel
    version."""

    def __init__(self, path=None):
        self.path = path or os.path.join(default_cache_dir(),
                                         _MEASUREMENTS_NAME)
        self._lock = threading.Lock()
        self._warned = False

    def append(self, digest, payload, schedule, slope, mode="measure"):
        row = {"digest": str(digest), "payload": dict(payload),
               "schedule": dict(schedule), "slope": float(slope),
               "mode": str(mode)}
        line = json.dumps(row, sort_keys=True) + "\n"
        with self._lock:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as fout:
                fout.write(line)
            try:
                oversized = (os.path.getsize(self.path)
                             > _MEASUREMENTS_MAX_BYTES)
            except OSError:
                oversized = False
            if oversized:
                self._compact()

    def _compact(self):
        with open(self.path) as fin:
            lines = fin.readlines()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fout:
            fout.writelines(lines[-_MEASUREMENTS_KEEP:])
            fout.flush()
        os.replace(tmp, self.path)

    def rows(self, op=None, mode=None, current_only=True, kind=None):
        """The parsed rows, newest last.  ``current_only`` keeps only
        rows whose payload matches the current torch version, the device
        kind (``kind``, default :func:`device_kind`) and the family's
        port kernel version, and whose digest recompute matches.
        Unparseable lines are skipped (one warning)."""
        try:
            with open(self.path) as fin:
                lines = fin.readlines()
        except FileNotFoundError:
            return []
        except OSError as exc:
            self._warn("measurement log %s unreadable (%s)"
                       % (self.path, exc))
            return []
        kind_now = (kind or device_kind()) if current_only else None
        if current_only:
            from veles_tpu_torch.tune.spec import current_kernel_version
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                payload = row["payload"]
                digest = row["digest"]
                float(row["slope"])
                row["schedule"], row["mode"]
            except (ValueError, KeyError, TypeError):
                self._warn("measurement log %s has unparseable rows; "
                           "skipping them" % self.path)
                continue
            if op is not None and payload.get("op") != op:
                continue
            if mode is not None and row.get("mode") != mode:
                continue
            if current_only:
                if (payload.get("torch") != torch.__version__
                        or payload.get("device_kind") != kind_now):
                    continue
                version = current_kernel_version(payload.get("op"))
                if (version is not None
                        and payload.get("kernel_version") != version):
                    continue
                recomputed = _digest(json.dumps(payload,
                                                sort_keys=True))
                if recomputed != digest:
                    continue
            out.append(row)
        return out

    def count_by_family(self, mode=None, current_only=True):
        counts = {}
        for row in self.rows(mode=mode, current_only=current_only):
            op = row["payload"].get("op", "?")
            counts[op] = counts.get(op, 0) + 1
        return counts

    def _warn(self, message):
        if not self._warned:
            self._warned = True
            logger.warning(message)


# -- process-wide consult hook ----------------------------------------------

_instances_lock = threading.Lock()
_instances = {}
_log_instances = {}


def _cache_path():
    return os.path.join(default_cache_dir(), _FILE_NAME)


def cache_for(path=None):
    """The ScheduleCache singleton for ``path`` (default: the resolved
    cache dir), keyed by resolved path so that a redirected
    ``VELES_SCHEDULE_CACHE`` gets a fresh table."""
    resolved = path or _cache_path()
    inst = _instances.get(resolved)
    if inst is None:
        with _instances_lock:
            inst = _instances.get(resolved)
            if inst is None:
                inst = _instances[resolved] = ScheduleCache(resolved)
    return inst


def measurement_log(path=None):
    """The MeasurementLog singleton for ``path``, keyed like
    :func:`cache_for`."""
    resolved = path or os.path.join(default_cache_dir(),
                                    _MEASUREMENTS_NAME)
    with _instances_lock:
        inst = _log_instances.get(resolved)
        if inst is None:
            inst = _log_instances[resolved] = MeasurementLog(resolved)
        return inst


def record_measurement(digest, payload, schedule, slope,
                       mode="measure"):
    """Append one measured triple to the sidecar; never raises (a
    read-only cache dir must not break a tune run)."""
    try:
        measurement_log().append(digest, payload, schedule, slope,
                                 mode=mode)
    except Exception as exc:
        logger.warning("measurement log append failed (%s); triple "
                       "dropped", exc)


#: active recording sink (tune/walk.py)
_recording = None


class record_specs(object):
    """Context manager: while active, every consult appends ``{"op",
    "shape", "dtype", "precision_level", "device_kind", "extra", "raw",
    "digest"}`` to the returned list (dedup by digest): the walk's
    harvest of what a step really consulted."""

    def __enter__(self):
        global _recording
        self._saved = _recording
        self._sink = []
        self._seen = set()
        _recording = self
        return self._sink

    def __exit__(self, *exc):
        global _recording
        _recording = self._saved
        return False

    def add(self, spec):
        if spec["digest"] not in self._seen:
            self._seen.add(spec["digest"])
            self._sink.append(spec)


def _counters():
    from veles_tpu_torch.observe.metrics import registry
    return registry


def _recorded(spec, kind, digest):
    return {"op": str(spec["op"]),
            "shape": [int(s) for s in spec["shape"]],
            "dtype": str(spec["dtype"]),
            "precision_level": int(spec["precision_level"]),
            "device_kind": kind, "extra": dict(spec.get("extra") or {}),
            "raw": dict(spec.get("raw") or {}), "digest": digest}


def schedule_for(op, shape, dtype, precision_level, extra=None,
                 raw=None, device=None):
    """The cached ``schedule`` dict for this (op, shape, dtype, precision
    level, device kind) or None, unmemoized and unvalidated (the JAX
    package's consult).  Counts hits and misses; records under
    :class:`record_specs`.  Never raises."""
    try:
        kind = device_kind(device)
        digest, _ = schedule_key(op, shape, dtype, precision_level,
                                 kind, extra)
        if _recording is not None:
            _recording.add(_recorded(
                {"op": op, "shape": shape, "dtype": dtype,
                 "precision_level": precision_level, "extra": extra,
                 "raw": raw}, kind, digest))
        entry = cache_for().get(digest)
        reg = _counters()
        if entry is None:
            reg.counter("tune.cache_misses").inc()
            return None
        reg.counter("tune.cache_hits").inc()
        return entry["schedule"]
    except Exception as exc:
        logger.warning("schedule cache consult failed (%s); using the "
                       "static plan", exc)
        return None


#: (cache path, op, device kind, key coordinates) -> (spec, kind,
#: digest, validated schedule or None); cleared by every table change
_memo = {}


def invalidate():
    """Forget every memoized consult (a table changed)."""
    _memo.clear()


def consult(op, coords, device, build_spec):
    """The kernels' consult: the validated tuned schedule for one call,
    or None (the kernel's static plan serves).

    ``coords`` is a hashable tuple of the call's key coordinates (what
    ``build_spec`` reads), ``device`` the operands' device and
    ``build_spec()`` the family's ``*_spec`` dict for the call, built
    only on a memo miss.  Host-only; counts ``tune.cache_hits`` /
    ``tune.cache_misses``; records under :class:`record_specs`.  An
    entry that fails validation against the call's spec warns once and
    serves the static plan.  Never raises."""
    try:
        kind = device_kind(device)
        path = _cache_path()
        key = (path, op, kind, coords)
        hit = _memo.get(key)
        if hit is None:
            from veles_tpu_torch.tune.spec import valid_schedule
            spec = build_spec()
            digest, _ = schedule_key(
                spec["op"], spec["shape"], spec["dtype"],
                spec["precision_level"], kind, spec.get("extra"))
            entry = cache_for(path).get(digest)
            schedule = None if entry is None else valid_schedule(
                op, entry["schedule"], spec)
            hit = _memo[key] = (spec, kind, digest, schedule)
        spec, kind, digest, schedule = hit
        if _recording is not None:
            _recording.add(_recorded(spec, kind, digest))
        _counters().counter("tune.cache_hits" if schedule is not None
                            else "tune.cache_misses").inc()
        return schedule
    except Exception as exc:  # never let the cache break a kernel call
        logger.warning("schedule cache consult failed (%s); using the "
                       "static plan", exc)
        return None


def provenance(op, shape, dtype, precision_level, extra=None,
               device=None):
    """"tuned" when a cache entry would really serve this spec (the
    consult's structural validation), else "static".  No counters, no
    recording."""
    try:
        digest, _ = schedule_key(op, shape, dtype, precision_level,
                                 device_kind(device), extra)
        entry = cache_for().get(digest)
        if entry is None:
            return "static"
        from veles_tpu_torch.tune.spec import valid_schedule
        return ("tuned" if valid_schedule(op, entry["schedule"])
                else "static")
    except Exception:
        return "static"


def tune_counters():
    """Snapshot of the tune metric set + cache population for receipts
    (the serve engine's compile receipt, the CLI's TUNE.json)."""
    reg = _counters()
    out = {}
    for name in ("tune.cache_hits", "tune.cache_misses", "tune.evals",
                 "tune.bank_published", "tune.bank_merged",
                 "tune.bank_entries"):
        metric = reg.peek(name)
        if metric is not None:
            out[name.split(".", 1)[1]] = metric.value
    try:
        out["entries"] = len(cache_for())
    except Exception:
        pass
    return out
