"""Workflow snapshots: whole-workflow pickles with codecs, manifests,
restore, retention and in-process rollback.

Counterpart of ``veles_tpu/snapshotter.py``.  Preserved capabilities:
interval + time-interval gating with a ``skip`` Bool, compression
codecs (none/gz/bz2/xz, snappy when importable) sniffed from the magic
bytes on restore, the ``_current`` symlink, restore via
:meth:`SnapshotterBase.import_file`, the sqlite history sink, the
size warning with a per-unit pickle-size top-5, and the freshness
loop's :func:`publish_snapshot` / :func:`read_latest`.

Crash consistency: every snapshot is written to ``<dest>.tmp``,
fsynced, ``os.replace``d into place, and the directory fsynced, so a
``kill -9`` at any instant leaves either the complete new file or no
new file.  A sidecar manifest (``<dest>.manifest``, JSON: sha256,
nbytes, codec, epoch, workflow checksum/metric) makes every snapshot
verifiable; :meth:`import_file` checks it before unpickling and falls
back to the newest previous-good snapshot of the same workflow when
the preferred one is truncated or corrupt.  ``keep=N`` bounds the
on-disk history (the best-by-metric and the ``_current`` target always
survive).  :meth:`SnapshotterBase.rollback` restores the newest
verified snapshot's model state into the live workflow when training
diverges, within a retry budget.

Device state: a fused workflow first hands its step's state to the
unit Arrays, and each Array copies its tensor to the host as it pickles,
so a snapshot holds numpy arrays and Python numbers and no ``torch``
object: it loads on a host without a card.

One format for both packages: the port's classes keep the JAX
package's module paths under ``veles_tpu_torch``, and
:meth:`import_file` also reads a snapshot the JAX package wrote.  Its
unpickler maps a class path ``veles_tpu.X`` to ``veles_tpu_torch.X`` as
a string, without importing ``veles_tpu``; a class with no counterpart
in the port, and anything of ``jax``, raises :class:`SnapshotError`
naming it.

:func:`publish_schedule_bank` publishes the kernel schedule cache
(``veles_tpu_torch.tune``) beside the snapshots as a manifest-verified
``schedule_bank.json``; a :class:`Snapshotter` with a publish directory
calls it after each snapshot publish, and a failure is logged without
stopping training.

Telemetry, as in the JAX package: ``health.rollbacks`` and
``health.rollbacks_remaining`` (set at initialize and at each
rollback), a ``snapshot.rollback`` instant and a flight-recorder dump
when a rollback lands; ``snapshot.exports`` and the ``snapshot.write_s``
histogram with a ``snapshot.export`` span per export; the
``freshness.publish`` and ``tune.bank_publish`` instants beside the
``serve.freshness.published`` and ``tune.bank_published`` counters.
"""

import bz2
import glob
import gzip
import hashlib
import importlib
import json
import logging
import lzma
import os
import pickle
import time

from veles_tpu_torch import chaos
from veles_tpu_torch.config import root
from veles_tpu_torch.health import RollbackExhausted
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.observe.flight import flight as _flight
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.units import Unit

__all__ = ["SnapshotterBase", "Snapshotter", "SnapshotError",
           "RollbackExhausted", "MANIFEST_SUFFIX", "LATEST_NAME",
           "publish_snapshot", "publish_schedule_bank", "read_latest",
           "write_state_snapshot",
           "load_state_snapshot", "latest_state_snapshot"]

#: sidecar manifest filename suffix (next to the snapshot it describes)
MANIFEST_SUFFIX = ".manifest"

#: the publish directory's atomic pointer file (freshness loop)
LATEST_NAME = "LATEST"

#: module-level logger for the static restore/verify paths
_log = logging.getLogger("Snapshotter")


class SnapshotError(Exception):
    """No usable snapshot could be restored."""


CODECS = {
    "": (lambda path: open(path, "wb"), lambda path: open(path, "rb")),
    "gz": (lambda path: gzip.open(path, "wb", 6),
           lambda path: gzip.open(path, "rb")),
    "bz2": (lambda path: bz2.open(path, "wb", 6),
            lambda path: bz2.open(path, "rb")),
    "xz": (lambda path: lzma.open(path, "wb", preset=1),
           lambda path: lzma.open(path, "rb")),
}

try:  # snappy framing, when the module is there
    import snappy  # noqa: F401

    class _SnappyWriter(object):
        def __init__(self, path):
            self._file = open(path, "wb")
            self._compressor = snappy.StreamCompressor()

        def write(self, data):
            self._file.write(self._compressor.compress(data))

        def flush(self):
            self._file.flush()

        def close(self):
            self._file.close()

        def __enter__(self):
            return self

        def __exit__(self, *args):
            self.close()

    class _SnappyReader(object):
        def __init__(self, path):
            with open(path, "rb") as fin:
                self._data = snappy.StreamDecompressor().decompress(
                    fin.read())
            self._pos = 0

        def read(self, size=-1):
            if size < 0:
                size = len(self._data) - self._pos
            chunk = self._data[self._pos:self._pos + size]
            self._pos += len(chunk)
            return chunk

        def readline(self):
            idx = self._data.find(b"\n", self._pos)
            end = len(self._data) if idx < 0 else idx + 1
            chunk = self._data[self._pos:end]
            self._pos = end
            return chunk

        def close(self):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *args):
            self.close()

    CODECS["snappy"] = (_SnappyWriter, _SnappyReader)
except ImportError:
    pass

#: JAX package classes whose port counterpart has another name: its
#: devices are one class here (a restored unit takes the launcher's
#: device at initialize)
_RENAMED = {
    ("veles_tpu.backends", "CPUDevice"): ("veles_tpu_torch.backends",
                                          "Device"),
    ("veles_tpu.backends", "TPUDevice"): ("veles_tpu_torch.backends",
                                          "Device"),
    ("veles_tpu.backends", "NumpyDevice"): ("veles_tpu_torch.backends",
                                            "Device"),
}


class _Unpickler(pickle.Unpickler):
    """Reads the port's snapshots and the JAX package's: a class path
    ``veles_tpu.X`` resolves to ``veles_tpu_torch.X`` (mapped as a
    string: ``veles_tpu`` is never imported)."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top in ("jax", "jaxlib"):
            raise SnapshotError(
                "the snapshot holds %s.%s, a JAX object the port cannot "
                "restore" % (module, name))
        if top != "veles_tpu":
            return super(_Unpickler, self).find_class(module, name)
        port_module, port_name = _RENAMED.get(
            (module, name), ("veles_tpu_torch" + module[len(top):], name))
        try:
            return getattr(importlib.import_module(port_module), port_name)
        except (ImportError, AttributeError):
            raise SnapshotError(
                "the snapshot holds %s.%s, which has no counterpart in "
                "the port (no %s.%s)" % (module, name, port_module,
                                         port_name))


#: warn when a snapshot exceeds this many bytes
SIZE_WARNING = 1 << 30


def _write_bytes_atomic(path, data):
    """The ONE tmp -> fsync -> ``os.replace`` -> dir-fsync sequence for
    small metadata files (manifests, the publish LATEST pointer)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fout:
        fout.write(data)
        fout.flush()
        os.fsync(fout.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    """Durably record a rename/creation in its directory; best-effort
    (some filesystems refuse O_RDONLY directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _file_sha256(path):
    digest = hashlib.sha256()
    with open(path, "rb") as fin:
        for block in iter(lambda: fin.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def _manifest_path(path):
    """Manifest sidecar for a snapshot; symlinks (``_current``) resolve
    to their target first, since the sidecar sits next to the data."""
    return os.path.realpath(path) + MANIFEST_SUFFIX


def read_latest(publish_dir):
    """The publish directory's ``LATEST`` pointer as a dict, or None
    when absent/unparseable/mid-replace — the watcher treats every
    failure mode as "nothing new yet"."""
    try:
        with open(os.path.join(publish_dir, LATEST_NAME), "rb") as fin:
            latest = json.loads(fin.read().decode())
    except (OSError, ValueError):
        return None
    if not isinstance(latest, dict) or "snapshot" not in latest:
        return None
    return latest


def _next_publish_ordinal(publish_dir):
    """Next export ordinal: one past the largest already published
    (scanned from filenames AND the LATEST pointer, so a crashed
    publish that never flipped LATEST still cannot reuse its
    ordinal)."""
    best = 0
    latest = read_latest(publish_dir)
    if latest is not None:
        try:
            best = int(latest.get("ordinal", 0))
        except (TypeError, ValueError):
            best = 0
    try:
        names = os.listdir(publish_dir)
    except OSError:
        names = []
    for name in names:
        head = name.split("_", 1)[0]
        if head.isdigit():
            best = max(best, int(head))
    return best + 1


def _copy_atomic(src, dest):
    """Stream-copy ``src`` to ``dest`` through tmp -> fsync ->
    os.replace, so the final path is never torn."""
    tmp = dest + ".tmp"
    with open(src, "rb") as fin, open(tmp, "wb") as fout:
        for block in iter(lambda: fin.read(1 << 20), b""):
            fout.write(block)
        fout.flush()
        os.fsync(fout.fileno())
    os.replace(tmp, dest)


def publish_snapshot(path, publish_dir, keep=8):
    """Publish a manifest-verified snapshot into the watched publish
    directory — the trainer half of the train-to-serve freshness loop
    (docs/serving.md "Freshness loop").

    The publish contract the serve-side ``SnapshotWatcher`` relies on:

    - the snapshot bytes and the sidecar manifest are copied (manifest
      FIRST, both atomically) under an export-ordinal-ordered name
      ``NNNNNN_<basename>``, so publication order survives clock skew
      and same-second exports;
    - only after both are in place does the ``LATEST`` pointer flip
      (atomic tmp -> ``os.replace``), so a watcher that sees an ordinal
      can always find its files — a crash at any instant leaves LATEST
      pointing at a complete previous publish;
    - the publish dir keeps its own bounded history (``keep`` newest
      ordinals; the LATEST target always survives) and is EXEMPT from
      the train directory's ``keep=N`` retention — it is a *view* for
      the serve fleet, not the training run's crash-recovery history
      (docs/checkpointing.md).

    An unverifiable snapshot is refused here — the publish side is the
    first line of the "a poisoned snapshot never reaches the fleet"
    defense.  Returns ``{"ordinal", "snapshot", "sha256"}``.

    Chaos point ``freshness.publish``: ``truncate`` writes only half the
    snapshot bytes at the final path (a torn, non-atomic copy: the
    watcher must skip and retry), ``crash`` dies after the copy but
    before the LATEST flip (a stale pointer; the ordinal is burned)."""
    real = os.path.realpath(path)
    ok, detail = SnapshotterBase.verify_snapshot(real)
    if ok is False:
        raise SnapshotError(
            "refusing to publish %s: %s" % (path, detail))
    if ok is None:
        raise SnapshotError(
            "refusing to publish %s without a manifest: the watcher "
            "verifies BEFORE unpickling, an unverifiable snapshot "
            "could never be accepted (%s)" % (path, detail))
    os.makedirs(publish_dir, exist_ok=True)
    ordinal = _next_publish_ordinal(publish_dir)
    name = "%06d_%s" % (ordinal, os.path.basename(real))
    dest = os.path.join(publish_dir, name)
    # manifest first: from the instant the data file exists the watcher
    # can verify it — there is no window where a complete-looking
    # snapshot sits beside no manifest
    _copy_atomic(real + MANIFEST_SUFFIX, dest + MANIFEST_SUFFIX)
    fault = chaos.plan.fire("freshness.publish") \
        if chaos.plan is not None else None
    if fault is not None and fault.action == "truncate":
        with open(real, "rb") as fin:
            payload = fin.read()
        with open(dest, "wb") as fout:
            fout.write(payload[:max(1, len(payload) // 2)])
    else:
        _copy_atomic(real, dest)
    _fsync_dir(publish_dir)
    if fault is not None and fault.action == "crash":
        raise chaos.ChaosCrash("simulated crash mid-publish (LATEST "
                               "not flipped)")
    manifest = SnapshotterBase.read_manifest(dest) or {}
    latest = {
        "version": 1,
        "ordinal": ordinal,
        "snapshot": name,
        "sha256": manifest.get("sha256"),
        "published": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    _write_bytes_atomic(
        os.path.join(publish_dir, LATEST_NAME),
        json.dumps(latest, indent=1, sort_keys=True).encode())
    # bounded history: this is a serve-side view, not the training
    # run's recovery history — prune ordinals past `keep` (the LATEST
    # target is by construction among the newest)
    if keep and keep > 0:
        published = []
        for entry in os.listdir(publish_dir):
            head = entry.split("_", 1)[0]
            if head.isdigit() and not entry.endswith(".tmp") and \
                    not entry.endswith(MANIFEST_SUFFIX):
                published.append((int(head), entry))
        for _, entry in sorted(published)[:-keep]:
            for victim in (entry, entry + MANIFEST_SUFFIX):
                try:
                    os.remove(os.path.join(publish_dir, victim))
                except OSError:
                    pass
    _registry.counter("serve.freshness.published").inc()
    _tracer.instant("freshness.publish", cat="freshness",
                    ordinal=ordinal, snapshot=name)
    return {"ordinal": ordinal, "snapshot": dest,
            "sha256": latest["sha256"]}


def publish_schedule_bank(publish_dir, cache=None):
    """Publish the local schedule cache as a manifest-verified fleet
    bank beside the snapshots (``schedule_bank.json``): one host's
    tuning serves the fleet.

    The channel discipline of :func:`publish_snapshot`: the manifest
    lands FIRST, so from the instant the bank's bytes flip a watcher
    can verify them; in the (manifest new, bank old) window
    verification fails and the watcher retries at its next poll.
    Returns ``{"bank", "entries"}``, or None when the cache is empty
    (nothing to share is not an error)."""
    from veles_tpu_torch.tune.cache import BANK_FILE_NAME, cache_for
    cache = cache_for() if cache is None else cache
    if len(cache) == 0:
        return None
    os.makedirs(publish_dir, exist_ok=True)
    dest = os.path.join(publish_dir, BANK_FILE_NAME)
    tmp = dest + ".export"
    count = cache.export_bank(tmp)
    SnapshotterBase.write_manifest(tmp, workflow_name="schedule_bank")
    os.replace(tmp + MANIFEST_SUFFIX, dest + MANIFEST_SUFFIX)
    os.replace(tmp, dest)
    _fsync_dir(publish_dir)
    _registry.counter("tune.bank_published").inc()
    _tracer.instant("tune.bank_publish", cat="tune", entries=count)
    return {"bank": dest, "entries": count}


class SnapshotterBase(Unit):
    """Common logic: gating, naming, codec selection, restore."""

    hide_from_registry = True

    @classmethod
    def init_parser(cls, parser):
        parser.add_argument(
            "--snapshot-dir", default=None,
            help="snapshot output directory")
        parser.add_argument(
            "--snapshot-interval", type=int, default=None,
            help="snapshot every N improvements")
        parser.add_argument(
            "--snapshot-time-interval", type=float, default=None,
            help="minimum seconds between snapshots")
        parser.add_argument(
            "--snapshot-compress", default=None,
            choices=("", "gz", "bz2", "xz"),
            help="snapshot compression codec")
        parser.add_argument(
            "--disable-snapshotting", action="store_true")
        parser.add_argument(
            "--snapshot-db", default=None,
            help="sqlite file recording snapshot history")
        parser.add_argument(
            "--snapshot-keep", type=int, default=None, metavar="N",
            help="retain only the newest N snapshots (plus the "
                 "best-by-metric and the _current target); 0 keeps "
                 "everything")
        parser.add_argument(
            "--rollback-budget", type=int, default=None, metavar="N",
            help="in-process divergence rollbacks allowed before the "
                 "run hard-fails (docs/health.md)")
        parser.add_argument(
            "--publish-dir", default=None, metavar="DIR",
            help="also publish every manifest-verified snapshot into "
                 "this watched directory for the serve fleet's "
                 "freshness loop (docs/serving.md)")
        parser.add_argument(
            "--publish-keep", type=int, default=None, metavar="N",
            help="published snapshots retained in the publish dir "
                 "(its own bounded view; the train dir's "
                 "--snapshot-keep is separate)")
        return parser

    @classmethod
    def apply_args(cls, args):
        cfg = {}
        if getattr(args, "snapshot_dir", None):
            cfg["dir"] = args.snapshot_dir
        if getattr(args, "snapshot_interval", None) is not None:
            cfg["interval"] = args.snapshot_interval
        if getattr(args, "snapshot_time_interval", None) is not None:
            cfg["time_interval"] = args.snapshot_time_interval
        if getattr(args, "snapshot_compress", None) is not None:
            cfg["compression"] = args.snapshot_compress
        if getattr(args, "snapshot_db", None):
            cfg["db"] = args.snapshot_db
        if getattr(args, "snapshot_keep", None) is not None:
            cfg["keep"] = args.snapshot_keep
        if getattr(args, "rollback_budget", None) is not None:
            cfg["rollback_budget"] = args.rollback_budget
        root.common.snapshot.update(cfg)
        fresh = {}
        if getattr(args, "publish_dir", None):
            fresh["publish_dir"] = args.publish_dir
        if getattr(args, "publish_keep", None) is not None:
            fresh["keep"] = args.publish_keep
        if fresh:
            root.common.freshness.update(fresh)
        if getattr(args, "disable_snapshotting", False):
            root.common.disable.update({"snapshotting": True})

    def __init__(self, workflow, **kwargs):
        cfg = root.common.snapshot
        self.prefix = kwargs.pop("prefix", "wf")
        self.directory = kwargs.pop(
            "directory", cfg.get("dir") or
            root.common.dirs.get("snapshots", "/tmp"))
        self.compression = kwargs.pop(
            "compression", cfg.get("compression", "gz"))
        self.interval = kwargs.pop("interval", cfg.get("interval", 1))
        self.time_interval = kwargs.pop(
            "time_interval", cfg.get("time_interval", 15))
        self._db_path = kwargs.pop("db_path", cfg.get("db"))
        # retention: 0/None = unlimited; the best-by-metric snapshot and the _current target always survive
        self.keep = kwargs.pop("keep", cfg.get("keep", 0))
        self.keep_best = kwargs.pop("keep_best", True)
        # divergence recovery (docs/health.md): in-process rollbacks
        # allowed before the run hard-fails with RollbackExhausted
        self.rollback_budget = kwargs.pop(
            "rollback_budget", cfg.get("rollback_budget", 3))
        # freshness-loop publishing (docs/serving.md): None = off
        fresh = root.common.freshness
        self.publish_dir = kwargs.pop(
            "publish_dir", fresh.get("publish_dir"))
        self.publish_keep = kwargs.pop(
            "publish_keep", fresh.get("keep", 8))
        super(SnapshotterBase, self).__init__(workflow, **kwargs)
        self.skip = Bool(False)
        self.suffix = None
        self.destination = None
        self.rollbacks = 0
        #: {"bytes", "seconds", "destination"} of the last export
        self.last_export = None
        self._counter = 0
        self._exports = 0
        self._last_time = 0.0

    def initialize(self, **kwargs):
        os.makedirs(self.directory, exist_ok=True)
        self._last_time = time.time()
        _registry.gauge("health.rollbacks_remaining").set(
            max(0, self.rollback_budget - self.rollbacks))
        return super(SnapshotterBase, self).initialize(**kwargs)

    def run(self):
        if root.common.disable.get("snapshotting", False):
            return
        self._counter += 1
        if bool(self.skip):
            return
        if self._counter % self.interval:
            return
        # time_interval throttles REPEAT snapshots; the first one is
        # exempt, else a short run (or a crash before time_interval
        # elapses) leaves nothing on disk to resume from
        if self.destination is not None and \
                time.time() - self._last_time < self.time_interval:
            return
        self._last_time = time.time()
        self.export()

    def export(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _workflow_epoch_metric(self):
        decision = getattr(self.workflow, "decision", None)
        metric = getattr(decision, "best_metric", None)
        epoch = getattr(decision, "epoch_number", None)
        return (epoch, float(metric) if metric is not None else None)

    def _record_in_db(self, destination, nbytes):
        """Append a row to the sqlite snapshot history.  Enabled via
        ``db_path=`` kwarg or root.common.snapshot.db.  A DB failure
        (locked/readonly sqlite) only warns: the snapshot itself is
        already safe on disk and must not abort the training step."""
        db_path = self._db_path
        if not db_path:
            return
        try:
            self._record_in_db_unchecked(destination, nbytes)
        except Exception as exc:
            self.warning(
                "snapshot db record failed (%s: %s); continuing — the "
                "snapshot itself is safe at %s",
                type(exc).__name__, exc, destination)

    def _record_in_db_unchecked(self, destination, nbytes):
        import sqlite3
        epoch, metric = self._workflow_epoch_metric()
        with sqlite3.connect(self._db_path) as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS snapshots ("
                "  id INTEGER PRIMARY KEY AUTOINCREMENT,"
                "  timestamp TEXT NOT NULL,"
                "  prefix TEXT, workflow TEXT, checksum TEXT,"
                "  destination TEXT, bytes INTEGER,"
                "  epoch INTEGER, best_metric REAL)")
            conn.execute(
                "INSERT INTO snapshots (timestamp, prefix, workflow, "
                "checksum, destination, bytes, epoch, best_metric) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                (time.strftime("%Y-%m-%d %H:%M:%S"), self.prefix,
                 type(self.workflow).__name__,
                 getattr(self.workflow, "checksum", None),
                 destination, nbytes, epoch, metric))

    def _destination(self):
        # the export ordinal disambiguates same-second exports: a
        # second-resolution timestamp alone silently OVERWRITES the
        # previous snapshot (destroying the previous-good fallback)
        self._exports += 1
        suffix = self.suffix or "%s.%03d" % (
            time.strftime("%Y%m%d_%H%M%S"), self._exports)
        ext = (".%s" % self.compression) if self.compression else ""
        return os.path.join(
            self.directory,
            "%s_%s.%d.pickle%s" % (self.prefix, suffix,
                                   pickle.HIGHEST_PROTOCOL, ext))

    def _update_current_link(self):
        # atomic replace: _current is the canonical crash-resume
        # target, so there must never be a window without it
        link = os.path.join(self.directory, "%s_current" % self.prefix)
        temp = link + ".tmp"
        try:
            try:
                os.remove(temp)
            except FileNotFoundError:
                pass
            os.symlink(os.path.basename(self.destination), temp)
            os.replace(temp, link)
            _fsync_dir(self.directory)
        except OSError as exc:
            # a failed flip means _current (the canonical resume
            # target) silently stops tracking the newest snapshot —
            # that must never be invisible
            self.warning(
                "failed to update snapshot link %s -> %s (%s); resume "
                "will use an OLDER snapshot", link,
                os.path.basename(self.destination), exc)

    # -- verification / restore --------------------------------------------

    @staticmethod
    def write_manifest(destination, workflow_name=None, checksum=None,
                       codec=None, epoch=None, best_metric=None):
        """Write the sidecar manifest for a finished snapshot file,
        atomically (tmp -> fsync -> replace -> dir fsync)."""
        manifest = {
            "version": 1,
            "sha256": _file_sha256(destination),
            "nbytes": os.path.getsize(destination),
            "codec": codec or "",
            "workflow": workflow_name,
            "checksum": checksum,
            "epoch": epoch,
            "best_metric": best_metric,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        _write_bytes_atomic(
            destination + MANIFEST_SUFFIX,
            json.dumps(manifest, indent=1, sort_keys=True).encode())
        return manifest

    @staticmethod
    def read_manifest(path):
        """The manifest dict for a snapshot path, or None when absent
        or unparseable."""
        try:
            with open(_manifest_path(path), "rb") as fin:
                manifest = json.loads(fin.read().decode())
        except (OSError, ValueError):
            return None
        return manifest if isinstance(manifest, dict) else None

    @staticmethod
    def verify_snapshot(path):
        """Check a snapshot against its manifest.

        Returns ``(True, manifest)`` when it verifies, ``(None,
        reason)`` when there is no manifest to check against (legacy
        snapshot — restorable but unverifiable), and ``(False,
        reason)`` on truncation or checksum mismatch."""
        real = os.path.realpath(path)
        if not os.path.isfile(real):
            return False, "missing file %s" % real
        manifest = SnapshotterBase.read_manifest(real)
        if manifest is None:
            return None, "no manifest"
        nbytes = os.path.getsize(real)
        if nbytes != manifest.get("nbytes"):
            return False, "size mismatch (%d on disk, %s in manifest)" \
                % (nbytes, manifest.get("nbytes"))
        digest = _file_sha256(real)
        if digest != manifest.get("sha256"):
            return False, "sha256 mismatch"
        return True, manifest

    @staticmethod
    def _iter_verified_snapshots(directory, exclude=()):
        """Manifest-verified snapshots in ``directory``, newest first.

        Candidates are ordered by a cheap mtime stat and HASHED LAZILY,
        so a fallback restore only pays sha256 for the snapshots it
        actually tries, not the whole retained history."""
        exclude = {os.path.realpath(p) for p in exclude}
        found = []
        for mpath in glob.glob(os.path.join(directory,
                                            "*" + MANIFEST_SUFFIX)):
            snap = mpath[:-len(MANIFEST_SUFFIX)]
            if os.path.realpath(snap) in exclude:
                continue
            try:
                found.append((os.path.getmtime(snap), snap))
            except OSError:
                continue
        for _, snap in sorted(found, reverse=True):
            if SnapshotterBase.verify_snapshot(snap)[0]:
                yield snap

    @staticmethod
    def _verified_snapshots(directory, exclude=()):
        return list(SnapshotterBase._iter_verified_snapshots(
            directory, exclude=exclude))

    @staticmethod
    def _load_pickle(path):
        """Unpickle one snapshot file.  The codec is sniffed from the
        file's magic bytes, not the extension — the ``_current``
        symlink (the natural -w target) carries no extension."""
        with open(path, "rb") as probe:
            magic = probe.read(10)
        if magic[:2] == b"\x1f\x8b":
            codec = "gz"
        elif magic[:3] == b"BZh":
            codec = "bz2"
        elif magic[:6] == b"\xfd7zXZ\x00":
            codec = "xz"
        elif magic.startswith(b"\xff\x06\x00\x00sNaPpY") and \
                "snappy" in CODECS:
            codec = "snappy"
        else:
            # unknown magic: fall back to the extension (covers plain
            # pickles and any codec the sniff list lags behind)
            ext = os.path.splitext(path)[1].lstrip(".")
            codec = ext if ext in CODECS else ""
        _, opener = CODECS[codec]
        with opener(path) as fin:
            return _Unpickler(fin).load()

    @staticmethod
    def import_file(path, fallback=True):
        """Restore a workflow object from a snapshot file.

        The sidecar manifest, when present, is verified (size + sha256)
        BEFORE unpickling.  A snapshot that fails verification or fails
        to load falls back to the newest previous-good (manifest-
        verified) snapshot in the same directory, so a torn write or a
        corrupted ``_current`` target never strands a resume; pass
        ``fallback=False`` to fail fast instead."""
        real = os.path.realpath(path)
        want = SnapshotterBase.read_manifest(real)

        def same_workflow(candidate):
            # NEVER fall back across workflows: a shared snapshot
            # directory (the out-of-the-box default) may hold several
            # models' histories.  Prefer the manifest identity; with no
            # primary manifest, require a shared filename prefix.
            if want is not None:
                manifest = SnapshotterBase.read_manifest(candidate)
                if manifest is None or \
                        manifest.get("workflow") != want.get("workflow"):
                    return False
                if manifest.get("checksum") != want.get("checksum"):
                    _log.warning(
                        "fallback snapshot %s was written by a "
                        "different source revision of %s", candidate,
                        want.get("workflow"))
                return True
            return os.path.basename(candidate).split("_")[0] == \
                os.path.basename(real).split("_")[0]

        def candidates():
            yield real, False
            if fallback:  # evaluated only once the primary has failed
                for prev in SnapshotterBase._iter_verified_snapshots(
                        os.path.dirname(real) or ".", exclude=(real,)):
                    if same_workflow(prev):
                        yield prev, True  # just verified — don't re-hash

        tried = 0
        errors = []
        for candidate, verified in candidates():
            tried += 1
            if not verified:
                ok, detail = SnapshotterBase.verify_snapshot(candidate)
                if ok is False:
                    _log.warning("snapshot %s failed verification: %s",
                                 candidate, detail)
                    errors.append("%s: %s" % (candidate, detail))
                    continue
                if ok is None:
                    _log.debug("snapshot %s has no manifest; restoring "
                               "unverified (legacy)", candidate)
            try:
                restored = SnapshotterBase._load_pickle(candidate)
            except Exception as exc:
                _log.warning("snapshot %s failed to load (%s: %s)",
                             candidate, type(exc).__name__, exc)
                errors.append("%s: %s" % (candidate, exc))
                continue
            if candidate != real:
                _log.warning(
                    "restored previous-good snapshot %s (%s was "
                    "invalid)", candidate, path)
            return restored
        raise SnapshotError(
            "no usable snapshot for %s (tried %d candidate(s): %s)" %
            (path, tried, "; ".join(errors) or "none found"))

    @staticmethod
    def resolve_resume(spec, directory=None):
        """Resolve a ``--resume`` spec to a snapshot path, or None.

        ``auto`` picks the newest ``*_current`` target under the
        snapshot directory (``root.common.snapshot.dir`` falling back
        to ``root.common.dirs.snapshots``), then the newest manifest-
        verified snapshot; None means "nothing to resume — start
        fresh".  Any other spec is an explicit path (which must
        exist).  Validation and previous-good fallback happen at
        :meth:`import_file` time."""
        if not spec:
            return None
        if spec != "auto":
            if not os.path.exists(spec):
                raise SnapshotError("--resume %s: no such snapshot" %
                                    spec)
            return spec
        if directory is None:
            cfg = root.common.snapshot
            directory = cfg.get("dir") or root.common.dirs.get(
                "snapshots", "/tmp")
        if not os.path.isdir(directory):
            return None
        targets = []
        for link in glob.glob(os.path.join(directory, "*_current")):
            target = os.path.realpath(link)
            if os.path.isfile(target):
                targets.append((os.path.getmtime(target), target))
            else:
                _log.warning("broken snapshot link %s -> %s", link,
                             target)
        if targets:
            return sorted(targets, reverse=True)[0][1]
        verified = SnapshotterBase._verified_snapshots(directory)
        return verified[0] if verified else None

    # -- in-process divergence rollback (docs/health.md) --------------------

    def rollback(self, reason=""):
        """Restore the newest manifest-VERIFIED snapshot's model state
        into the LIVE workflow, in process — the decision watchdog's
        recovery path when training diverges (sustained non-finite
        steps, loss spike).

        Unlike ``--resume`` this does not replace the workflow object:
        the run keeps its loader position and epoch bookkeeping and
        only the model state (params + solver accumulators) rolls back,
        via the workflow's ``adopt_model_state`` hook; the caller then
        applies LR backoff and reseeds stochastic streams so the retry
        is not a bit-exact replay of the divergence.  Bounded by
        ``rollback_budget``: when the budget is spent the run
        HARD-FAILS with :class:`RollbackExhausted` — looping rollback
        -> divergence forever is worse than dying loudly."""
        self.rollbacks += 1
        _registry.counter("health.rollbacks").inc()
        _registry.gauge("health.rollbacks_remaining").set(
            max(0, self.rollback_budget - self.rollbacks))
        if self.rollbacks > self.rollback_budget:
            raise RollbackExhausted(
                "rollback budget exhausted (%d allowed) and training "
                "still diverges: %s" % (self.rollback_budget, reason))
        adopt = getattr(self.workflow, "adopt_model_state", None)
        if adopt is None:
            raise SnapshotError(
                "cannot roll back: workflow %s has no "
                "adopt_model_state hook" % type(self.workflow).__name__)
        errors = []
        for path in self._iter_verified_snapshots(self.directory):
            if not os.path.basename(path).startswith(self.prefix + "_"):
                continue
            try:
                # verified just above by the iterator: no fallback
                # cascade — each candidate stands or falls alone
                restored = self.import_file(path, fallback=False)
                adopt(restored)
            except Exception as exc:
                self.warning("rollback candidate %s unusable (%s: %s)",
                             path, type(exc).__name__, exc)
                errors.append("%s: %s" % (path, exc))
                continue
            self.warning(
                "rolled back model state to verified snapshot %s "
                "[%d/%d, reason: %s]", path, self.rollbacks,
                self.rollback_budget, reason or "unspecified")
            _tracer.instant("snapshot.rollback", cat="snapshot",
                            path=path, reason=reason)
            # the timeline before the rollback is about to be overwritten
            # by the restored state's: keep it in a black-box dump
            _flight.dump(reason="rollback")
            return path
        raise SnapshotError(
            "no verified snapshot to roll back to in %s (%s)" %
            (self.directory, "; ".join(errors) or "none found"))


class Snapshotter(SnapshotterBase):
    """Pickles the whole workflow through the selected codec."""

    def export(self):
        destination = self._destination()
        start = time.perf_counter()
        self._sync_fused_state()
        payload = pickle.dumps(self.workflow,
                               protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > SIZE_WARNING:
            self.check_snapshot_size()
        try:
            self._write_atomic(destination, payload)
        except OSError as exc:
            # Disk trouble (ENOSPC and friends) must not kill a
            # training run: the previous snapshot and _current are
            # untouched, so recovery capability degrades but survives.
            self.error(
                "snapshot write to %s failed (%s); previous snapshot "
                "kept, training continues", destination, exc)
            self._remove_quiet(destination + ".tmp")
            return
        self.destination = destination
        epoch, metric = self._workflow_epoch_metric()
        try:
            self.write_manifest(
                destination, workflow_name=type(self.workflow).__name__,
                checksum=getattr(self.workflow, "checksum", None),
                codec=self.compression, epoch=epoch, best_metric=metric)
        except OSError as exc:
            self.warning("manifest write for %s failed (%s); snapshot "
                         "restorable but unverifiable", destination, exc)
        self._update_current_link()
        self._record_in_db(destination, len(payload))
        self._apply_retention()
        # elapsed stamped BEFORE the publish copy: it is the checkpoint
        # write cost, and the train-dir snapshot is already durable
        # whether or not the freshness view gets its copy
        elapsed = time.perf_counter() - start
        self._publish(destination)
        _registry.counter("snapshot.exports").inc()
        _registry.histogram("snapshot.write_s").observe(elapsed)
        if _tracer.enabled:
            _tracer.complete("snapshot.export", start, elapsed,
                             cat="snapshot",
                             args={"bytes": len(payload),
                                   "destination": destination})
        self.last_export = {"bytes": len(payload), "seconds": elapsed,
                            "destination": destination}
        self.info("snapshot -> %s (%.1f MB, %.2f s)", destination,
                  len(payload) / 1e6, elapsed)

    def _publish(self, destination):
        """Trainer-side freshness hook: push the finished (verified,
        manifested) snapshot into the publish directory.  A publish
        failure degrades freshness, not training — warn and continue;
        the train-dir snapshot is already safe."""
        if not self.publish_dir:
            return
        try:
            receipt = publish_snapshot(destination, self.publish_dir,
                                       keep=self.publish_keep)
        except Exception as exc:
            self.warning(
                "snapshot publish to %s failed (%s: %s); training "
                "continues, the serve fleet keeps its current model",
                self.publish_dir, type(exc).__name__, exc)
            return
        self.info("published snapshot #%d -> %s", receipt["ordinal"],
                  receipt["snapshot"])
        try:
            bank = publish_schedule_bank(self.publish_dir)
        except Exception as exc:
            self.warning("schedule bank publish to %s failed (%s: "
                         "%s); the fleet keeps its current schedules",
                         self.publish_dir, type(exc).__name__, exc)
            return
        if bank is not None:
            self.info("published schedule bank (%d entries) -> %s",
                      bank["entries"], bank["bank"])

    def _write_atomic(self, destination, payload):
        """tmp -> fsync -> os.replace -> directory fsync.  A crash at
        any instant leaves either the complete new snapshot or only a
        ``.tmp`` residue — the final path is never torn, so ``_current``
        can never point at a half-written file."""
        tmp = destination + ".tmp"
        writer, _ = CODECS.get(self.compression, CODECS[""])
        with writer(tmp) as fout:
            if chaos.plan is not None:
                self._chaos_write(fout, payload)
            fout.write(payload)
        _fsync_file(tmp)
        os.replace(tmp, destination)
        _fsync_dir(self.directory)

    def _chaos_write(self, fout, payload):
        fault = chaos.plan.fire("snapshot.write")
        if fault is None:
            return
        if fault.action == "crash":
            # half the payload lands in the .tmp file, then the
            # "process dies": os.replace never runs
            fout.write(payload[:max(1, len(payload) // 2)])
            flush = getattr(fout, "flush", None)
            if flush is not None:
                flush()
            raise chaos.ChaosCrash("simulated crash mid-snapshot-write")
        if fault.action == "enospc":
            raise chaos.enospc()

    @staticmethod
    def _remove_quiet(path):
        try:
            os.remove(path)
        except OSError:
            pass

    def _apply_retention(self):
        """Prune old snapshots beyond ``keep``; the best-by-metric
        (lower is better, the decision's convention) and the _current
        target always survive."""
        keep = int(self.keep or 0)
        if keep <= 0:
            return
        snaps = []
        for path in glob.glob(os.path.join(self.directory,
                                           self.prefix + "_*")):
            name = os.path.basename(path)
            if os.path.islink(path) or name.endswith(MANIFEST_SUFFIX) \
                    or name.endswith(".tmp"):
                continue
            if ".pickle" not in name:
                continue
            snaps.append((os.path.getmtime(path), path))
        snaps.sort(reverse=True)
        survivors = {os.path.realpath(p) for _, p in snaps[:keep]}
        link = os.path.join(self.directory, "%s_current" % self.prefix)
        if os.path.exists(link):
            survivors.add(os.path.realpath(link))
        if self.keep_best:
            best = None
            for _, path in snaps:
                manifest = self.read_manifest(path)
                metric = manifest.get("best_metric") if manifest else None
                if metric is not None and (best is None or
                                           metric < best[0]):
                    best = (metric, path)
            if best is not None:
                survivors.add(os.path.realpath(best[1]))
        for _, path in snaps:
            if os.path.realpath(path) in survivors:
                continue
            self.debug("retention (keep=%d): pruning %s", keep, path)
            self._remove_quiet(path)
            self._remove_quiet(path + MANIFEST_SUFFIX)

    def _sync_fused_state(self):
        """A fused workflow hands its step's state to the unit Arrays
        first; each Array then copies its tensor to the host as it
        pickles (``Array.__getstate__``)."""
        trainer = getattr(self.workflow, "fused_trainer", None)
        if trainer is not None:
            trainer.sync()

    def check_snapshot_size(self):
        """Log the top-5 units by pickle size."""
        sizes = []
        for unit in self.workflow.units:
            try:
                sizes.append((len(pickle.dumps(
                    unit, protocol=pickle.HIGHEST_PROTOCOL)), unit.name))
            except Exception:
                pass
        sizes.sort(reverse=True)
        self.warning("snapshot is large; top units by pickle size:")
        for nbytes, name in sizes[:5]:
            self.warning("  %8.1f MB  %s", nbytes / 1e6, name)


# -- raw state snapshots (parallel/mesh.py MeshManager) -------------------
#
# The elastic mesh's pre-reshard safety snapshots are plain pickled
# state pytrees, not whole workflows, but they ride the SAME atomics
# and manifest contract as every other snapshot in this module: tmp ->
# fsync -> os.replace -> dir-fsync, sha256+size sidecar written after
# the data is durable, verify-before-unpickle on restore.  That is
# what lets a crash mid-reshard recover through the existing
# ``--resume auto`` machinery instead of a parallel bespoke path.

def write_state_snapshot(path, obj, workflow_name=None, epoch=None):
    """Atomically pickle ``obj`` to ``path`` and write its manifest
    sidecar; returns the manifest.  Honors the ``snapshot.write``
    chaos point (crash leaves only a ``.tmp`` residue — the final
    path is never torn)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fout:
        if chaos.plan is not None:
            fault = chaos.plan.fire("snapshot.write")
            if fault is not None:
                if fault.action == "crash":
                    fout.write(payload[:max(1, len(payload) // 2)])
                    fout.flush()
                    raise chaos.ChaosCrash(
                        "simulated crash mid-snapshot-write")
                if fault.action == "enospc":
                    raise chaos.enospc()
        fout.write(payload)
    _fsync_file(tmp)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")
    return SnapshotterBase.write_manifest(
        path, workflow_name=workflow_name, epoch=epoch)


def load_state_snapshot(path):
    """Verify ``path`` against its manifest, then unpickle it.  Raises
    :class:`SnapshotError` on a failed or impossible verification —
    a torn or tampered state snapshot must never be resumed from."""
    ok, detail = SnapshotterBase.verify_snapshot(path)
    if not ok:
        raise SnapshotError("state snapshot %s failed verification: %s"
                            % (path, detail))
    return SnapshotterBase._load_pickle(os.path.realpath(path))


def latest_state_snapshot(directory):
    """The newest manifest-verified snapshot in ``directory`` (or None)
    — the ``--resume auto`` semantics for raw state snapshots."""
    for snap in SnapshotterBase._iter_verified_snapshots(directory):
        return snap
    return None
