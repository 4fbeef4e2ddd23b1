"""Workflow — the container unit holding and executing the unit graph.

Counterpart of ``veles_tpu/workflow.py``: dependency-ordered
initialization with partial re-queue, the worklist-driven run loop
delimited by StartPoint/EndPoint, per-unit run-time statistics, Graphviz
graph generation.  The run loop is a flat worklist (no recursion, no
thread pool).

Not ported: the master-slave exchange (``generate_data_for_*``,
``do_job``, ``NoMoreJobs``), run-results gathering for the command line,
``package_export``, ``restore_workflow`` and snapshots.
"""

import sys
import threading
import time
from collections import deque

from veles_tpu_torch.plumbing import EndPoint, StartPoint
from veles_tpu_torch.units import Unit

__all__ = ["Workflow"]


class Workflow(Unit):
    """Container unit; nests inside a Launcher or a parent Workflow."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self._units = []
        super(Workflow, self).__init__(workflow, **kwargs)
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)

    def init_unpickled(self):
        super(Workflow, self).init_unpickled()
        self._queue_lock_ = threading.Lock()
        self._worklist_ = deque()
        self._finished_ = threading.Event()
        self._run_time_ = 0.0
        self._stop_requested_ = False
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
            self._run_time_ += time.perf_counter() - start
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

    @property
    def computing_power(self):
        """The device's rating (``Device.computing_power``), 0 before
        ``initialize`` gives the workflow a device."""
        device = getattr(self, "device", None)
        return device.computing_power if device is not None else 0.0

    def __getstate__(self):
        state = super(Workflow, self).__getstate__()
        state["_workflow"] = None  # the launcher never pickles
        return state
