"""Workflow — the container unit holding and executing the unit graph.

Counterpart of ``veles_tpu/workflow.py``: dependency-ordered
initialization with partial re-queue, the worklist-driven run loop
delimited by StartPoint/EndPoint, per-unit run-time statistics, Graphviz
graph generation, run-results gathering (``gather_results`` /
``write_results``), the source ``checksum``, ``package_export`` for
the native runtime, and :func:`restore_workflow`, the one bootstrap
path of ``-w`` / ``--resume``.  The run loop is a flat worklist (no
recursion, no thread pool).

A run is one ``<name>.run`` span (``cat="workflow"``) while the
tracer records or the flight ring is on.

Not ported: the master-slave exchange (``generate_data_for_*``,
``do_job``, ``NoMoreJobs``; ROADMAP.md Queue 1 item 12).
"""

import hashlib
import inspect
import json
import sys
import threading
import time
from collections import deque

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.plumbing import EndPoint, StartPoint
from veles_tpu_torch.units import Unit

__all__ = ["Workflow", "restore_workflow"]


def restore_workflow(path, launcher=None):
    """Restore a workflow from a (manifest-verified) snapshot, written by
    the port or by the JAX package, and re-home it: attach it to
    ``launcher`` and mark it restored so initialize() applies the
    post-restore fixups (a restored loader does not shuffle again)."""
    from veles_tpu_torch.snapshotter import SnapshotError, SnapshotterBase
    workflow = SnapshotterBase.import_file(path)
    if not isinstance(workflow, Workflow):
        raise SnapshotError(
            "snapshot %s holds a %s, not a Workflow" %
            (path, type(workflow).__name__))
    if launcher is not None:
        workflow.workflow = launcher
    workflow.restored_from_snapshot_ = True
    return workflow


class Workflow(Unit):
    """Container unit; nests inside a Launcher or a parent Workflow."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self._units = []
        super(Workflow, self).__init__(workflow, **kwargs)
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self.result_file = kwargs.get("result_file")

    def init_unpickled(self):
        super(Workflow, self).init_unpickled()
        self._queue_lock_ = threading.Lock()
        self._worklist_ = deque()
        self._finished_ = threading.Event()
        self._run_time_ = 0.0
        self._stop_requested_ = False
        self.restored_from_snapshot_ = False
        # stats as of the current run's start, so print_stats reports
        # per-run deltas
        self._stats_baseline_ = None

    # -- container behavior ------------------------------------------------

    def add_ref(self, unit):
        if unit not in self._units:
            self._units.append(unit)

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    @property
    def units(self):
        return list(self._units)

    @property
    def units_in_dependency_order(self):
        order = [u for u in self.start_point.dependent_units]
        rest = [u for u in self._units if u not in order]
        return order + rest

    def __getitem__(self, name):
        for unit in self._units:
            if unit.name == name:
                return unit
        raise KeyError(name)

    @property
    def workflow_mode(self):
        """"standalone": the port has no master-slave modes yet."""
        return getattr(self.workflow, "workflow_mode", "standalone")

    @property
    def launcher(self):
        parent = self.workflow
        if isinstance(parent, Workflow):
            return parent.launcher
        return parent

    # -- initialization ----------------------------------------------------

    def initialize(self, device=None, **kwargs):
        """Initialize every unit in dependency order; units raising
        AttributeError (unsatisfied demands, an input shape not known
        yet) are re-queued until a pass makes no progress, which raises
        the deadlock error naming each unit and its reason."""
        self.device = device
        if self.restored_from_snapshot_:
            # units must know they carry pickled state BEFORE their
            # initialize runs: a restored loader must not shuffle again
            # (that would tear shuffled_indices away from the pickled
            # PRNG stream and break exact resume)
            for unit in self._units:
                if unit is not self:
                    unit.restored_from_snapshot = True
        queue = deque(self.units_in_dependency_order)
        deferred_errors = {}
        while queue:
            progressed = False
            requeue = deque()
            for unit in queue:
                if unit is self:
                    continue
                try:
                    unit.initialize(device=device, **kwargs)
                    progressed = True
                except AttributeError as exc:
                    requeue.append(unit)
                    deferred_errors[unit] = exc
            if not progressed and requeue:
                lines = "; ".join(
                    "%s: %s" % (u.name, deferred_errors.get(u))
                    for u in requeue)
                raise RuntimeError(
                    "workflow initialization deadlock - unsatisfied "
                    "demands: %s" % lines)
            queue = requeue
        if self.restored_from_snapshot_:
            # units that do not remember gate state get their gates reset
            for unit in self._units:
                if not getattr(unit, "remembers_gates", True):
                    unit.gate_block = Bool(False)
        self._is_initialized_ = True
        return True

    # -- scheduling / run loop ---------------------------------------------

    def schedule(self, dst, src):
        """Queue ``dst`` for a gate check triggered by ``src``."""
        with self._queue_lock_:
            self._worklist_.append((dst, src))

    @property
    def finished(self):
        return self._finished_.is_set()

    @property
    def stop_requested(self):
        return self._stop_requested_

    def run(self):
        """Execute the graph from start_point until end_point fires."""
        self._stopped <<= False
        self._stop_requested_ = False
        self._finished_.clear()
        with self._queue_lock_:
            # residue of a stopped run would double-execute units
            self._worklist_.clear()
        for unit in self._units:
            if unit is self:
                continue
            if getattr(unit, "restartable", True):
                unit._stopped <<= False
            with unit._gate_lock_:
                for key in unit._links_from:
                    unit._links_from[key] = False
        self._stats_baseline_ = {
            "run_time": self._run_time_,
            "units": {id(u): (dict(u.timers), u.run_calls)
                      for u in self._units if u is not self},
        }
        start = time.perf_counter()
        self.event("run", "begin")
        try:
            self.start_point.run_dependent()
            while not self._finished_.is_set():
                with self._queue_lock_:
                    if not self._worklist_:
                        break
                    dst, src = self._worklist_.popleft()
                dst._check_gate_and_run(src)
            if not self._finished_.is_set():
                # drained without reaching end_point: an open-ended
                # graph is complete
                self.on_workflow_finished()
        finally:
            elapsed = time.perf_counter() - start
            self._run_time_ += elapsed
            if _tracer.active:
                _tracer.complete("%s.run" % self.name, start, elapsed,
                                 cat="workflow")
            self.event("run", "end")
        return True

    def on_workflow_finished(self):
        for unit in self._units:
            if unit is self:
                continue
            hook = getattr(unit, "on_workflow_finish", None)
            if hook is not None:
                try:
                    hook()
                except Exception:
                    self.exception("on_workflow_finish failed for %s",
                                   unit)
        self._finished_.set()
        self._stopped <<= True
        launcher = self.launcher
        if launcher is not None and self.workflow is launcher:
            on_finished = getattr(launcher, "on_workflow_finished", None)
            if on_finished is not None:
                on_finished()

    def stop(self):
        self._stop_requested_ = True
        self._stopped <<= True
        self._finished_.set()
        for unit in self._units:
            if unit is not self:
                unit.stop()

    # -- introspection / reporting ----------------------------------------

    def generate_graph(self):
        """Return the control-flow graph as Graphviz dot text."""
        lines = ["digraph %s {" % type(self).__name__]
        index = {}
        for i, unit in enumerate(self._units):
            index[id(unit)] = "u%d" % i
            shape = "rect"
            if isinstance(unit, (StartPoint, EndPoint)):
                shape = "circle"
            lines.append('  u%d [label="%s", shape=%s];' %
                         (i, unit.name, shape))
        for unit in self._units:
            for dst in unit.links_to:
                if id(dst) in index and id(unit) in index:
                    lines.append("  %s -> %s;" %
                                 (index[id(unit)], index[id(dst)]))
        lines.append("}")
        return "\n".join(lines)

    def unit_stats(self, cumulative=False):
        """[(seconds, unit, runs)] of the last run (or of all runs),
        slowest first.  A unit's seconds are the host clock around its
        ``run()``: on the card, the time to enqueue its kernels."""
        base = None if cumulative else self._stats_baseline_
        stats = []
        for unit in self._units:
            if unit is self:
                continue
            timers, calls = ({}, 0) if base is None else \
                base["units"].get(id(unit), ({}, 0))
            stats.append((unit.timers.get("run", 0.0) -
                          timers.get("run", 0.0), unit,
                          unit.run_calls - calls))
        stats.sort(key=lambda row: -row[0])
        return stats

    def print_stats(self, top_number=5, out=None, cumulative=False):
        """Report where the LAST run's time went (per-run deltas against
        the snapshot taken at ``run()`` start; ``cumulative=True`` for
        lifetime totals)."""
        out = out or sys.stdout
        base = None if cumulative else self._stats_baseline_
        timed = self.unit_stats(cumulative)
        total = sum(t for t, _, _ in timed) or 1e-12
        run_time = self._run_time_ - (base["run_time"] if base else 0.0)
        out.write("---- Workflow run time: %.3f s%s ----\n" % (
            run_time, "" if cumulative else " (this run)"))
        for elapsed, unit, runs in timed[:top_number]:
            out.write("  %6.2f%%  %8.3f s  %s (%d runs)\n" % (
                100.0 * elapsed / total, elapsed, unit.name, runs))
        for unit in self._units:
            if unit is self:
                continue
            # a unit's other timers: the input pipeline's pipeline_wait,
            # pipeline_fill and pipeline_h2d on the loader
            timers = {} if base is None else \
                base["units"].get(id(unit), ({}, 0))[0]
            extra = [(key, unit.timers[key] - timers.get(key, 0.0))
                     for key in sorted(unit.timers) if key != "run"]
            extra = [(key, value) for key, value in extra if value > 0.0]
            if extra:
                pipeline = getattr(unit, "_pipeline_", None)
                out.write("  %s stage timers (%s):\n    %s\n" % (
                    unit.name, "per-run" if pipeline is None
                    else "depth %d" % pipeline.depth,
                    ", ".join("%s %.3f s" % pair for pair in extra)))

    @property
    def checksum(self):
        """SHA1 of the defining source file and the class name: the
        snapshot manifests' source identity."""
        try:
            path = inspect.getsourcefile(type(self))
            with open(path, "rb") as fin:
                digest = hashlib.sha1(fin.read())
        except (TypeError, OSError):
            digest = hashlib.sha1()
        digest.update(type(self).__name__.encode())
        return digest.hexdigest()

    def gather_results(self):
        """Collect the metrics of every unit exposing
        ``get_metric_values`` (the loader's epochs, the decision's
        errors and best metric)."""
        results = {}
        for unit in self._units:
            getter = getattr(unit, "get_metric_values", None)
            if getter is not None:
                try:
                    results.update(getter())
                except Exception:
                    self.exception("gather_results failed for %s", unit)
        return results

    def write_results(self, file=None):
        """Write :meth:`gather_results` as JSON to ``file`` (default:
        the ``result_file`` the workflow was built with)."""
        path = file or self.result_file
        if not path:
            return
        with open(path, "w") as fout:
            json.dump(self.gather_results(), fout, indent=1, default=repr,
                      sort_keys=True)

    def package_export(self, path, precision="float32"):
        """Export the trained state for the native inference runtime
        (:mod:`veles_tpu_torch.package`)."""
        from veles_tpu_torch.package import export_workflow
        return export_workflow(self, path, precision=precision)

    @property
    def computing_power(self):
        """The device's rating (``Device.computing_power``), 0 before
        ``initialize`` gives the workflow a device."""
        device = getattr(self, "device", None)
        return device.computing_power if device is not None else 0.0

    def __getstate__(self):
        state = super(Workflow, self).__getstate__()
        state["_workflow"] = None  # the launcher never pickles
        # the JAX package's workflow fields (see units.JAX_UNIT_STATE)
        state["negotiates_on_connect"] = True
        state.setdefault("_method_timers", {})
        return state
