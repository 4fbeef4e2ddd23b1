"""Unit — the node of the dataflow/control-flow graph.

Counterpart of ``veles_tpu/units.py``.  Same semantics: control links
(``link_from``), the AND gate protocol with ``gate_block`` /
``gate_skip`` / ``ignores_gate``, data links (``link_attrs`` via
LinkableAttribute), required-attribute declaration (``demand``), timed
and stop-checked ``run`` wrapping, and a registry of all unit classes.
Successors are scheduled through the owning workflow's worklist, not by
recursive calls, so long training loops cannot blow the stack.

A unit class defining ``init_parser`` / ``apply_args`` contributes its
flags to the command line (:mod:`veles_tpu_torch.cmdline`).

Each run is one measurement, read twice: the unit's ``timers["run"]``
and, while the tracer records or the flight ring is on, a span of the
unit's name (``cat="unit"``).

Every unit is :class:`~veles_tpu_torch.distributable.Distributable`:
it carries the master-slave data hooks (no-ops by default) under its
data lock, and ``is_standalone`` / ``is_master`` / ``is_slave`` read the
workflow's mode.  Not ported: the per-unit debug timing log (the span
carries the same time).
"""

import threading
import time
import uuid as uuid_module

from veles_tpu_torch.distributable import Distributable
from veles_tpu_torch.mutable import Bool, LinkableAttribute
from veles_tpu_torch.observe.trace import tracer as _tracer

__all__ = ["Unit", "UnitRegistry", "RunAfterStopError"]

#: what the JAX package's units pickle and the port's do not use: a port
#: snapshot carries these at the JAX package's defaults, so that it
#: restores and trains on there too (one snapshot format)
JAX_UNIT_STATE = {"stripped_pickle": False, "negotiates_on_connect": False,
                  "view_group": None, "timings": False, "_ran": False}


class RunAfterStopError(RuntimeError):
    """A unit was scheduled to run after its workflow FINISHED without
    any stop request — a broken control-flow link."""


class UnitRegistry(type):
    """Metaclass recording every Unit subclass."""

    units = set()
    by_name = {}

    def __init__(cls, name, bases, namespace):
        super(UnitRegistry, cls).__init__(name, bases, namespace)
        # infrastructure (Workflow, StartPoint) sets hide_from_registry
        if not namespace.get("hide_from_registry", False):
            UnitRegistry.units.add(cls)
            UnitRegistry.by_name[name] = cls
        # units contributing command-line flags (the snapshotter) join
        # the argparse registry
        if "init_parser" in namespace or "apply_args" in namespace:
            from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
            CommandLineArgumentsRegistry.classes.append(cls)


class Unit(Distributable, metaclass=UnitRegistry):
    """A graph node with control gates and linked data attributes."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        self.name = kwargs.pop("name", None)
        super(Unit, self).__init__(**kwargs)
        self._links_from = {}
        self._links_to = {}
        self._gate_block = Bool(False)
        self._gate_skip = Bool(False)
        self._ignores_gate = Bool(False)
        self._stopped = Bool(False)
        #: units whose stop() tears down resources set this False so a
        #: rerun leaves them suppressed
        self.restartable = True
        self._demanded = set()
        self.timers = {"run": 0.0}
        self.run_calls = 0
        self.id = str(uuid_module.uuid4())
        self._workflow = None
        self.workflow = workflow
        self.init_unpickled()

    def init_unpickled(self):
        super(Unit, self).init_unpickled()
        self._gate_lock_ = threading.RLock()
        self._run_lock_ = threading.RLock()
        self._is_initialized_ = False
        LinkableAttribute.reinstall(self)

    def __repr__(self):
        return "<%s \"%s\">" % (type(self).__name__, self.name or
                                hex(id(self)))

    # -- naming / ownership ------------------------------------------------

    @property
    def name(self):
        if self._name is not None:
            return self._name
        return type(self).__name__

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, value):
        if self._workflow is not None:
            self._workflow.del_ref(self)
        self._workflow = value
        if value is not None:
            value.add_ref(self)

    def detach(self):
        self.workflow = None

    @property
    def is_standalone(self):
        return self.workflow.workflow_mode == "standalone"

    @property
    def is_master(self):
        return self.workflow.workflow_mode == "master"

    @property
    def is_slave(self):
        return self.workflow.workflow_mode == "slave"

    # -- gates & links -----------------------------------------------------

    @property
    def gate_block(self):
        return self._gate_block

    @gate_block.setter
    def gate_block(self, value):
        self._gate_block = value if isinstance(value, Bool) else Bool(value)

    @property
    def gate_skip(self):
        return self._gate_skip

    @gate_skip.setter
    def gate_skip(self, value):
        self._gate_skip = value if isinstance(value, Bool) else Bool(value)

    @property
    def ignores_gate(self):
        return self._ignores_gate

    @ignores_gate.setter
    def ignores_gate(self, value):
        self._ignores_gate = value if isinstance(value, Bool) else Bool(value)

    @property
    def links_from(self):
        return self._links_from

    @property
    def links_to(self):
        return self._links_to

    def link_from(self, *units):
        """Add control dependencies: self runs after each of ``units``."""
        with self._gate_lock_:
            for unit in units:
                self._links_from[unit] = False
                unit._links_to[self] = False
        return self

    def unlink_from(self, *units):
        with self._gate_lock_:
            for unit in units:
                self._links_from.pop(unit, None)
                unit._links_to.pop(self, None)

    def unlink_all(self):
        with self._gate_lock_:
            for unit in list(self._links_from):
                self.unlink_from(unit)
            for unit in list(self._links_to):
                unit.unlink_from(self)

    def open_gate(self, src):
        """Mark ``src`` done; True when ALL incoming links have fired.
        Resets the flags on opening."""
        with self._gate_lock_:
            if bool(self._ignores_gate):
                return True
            if src in self._links_from:
                self._links_from[src] = True
            if all(self._links_from.values()):
                for key in self._links_from:
                    self._links_from[key] = False
                return True
            return False

    # -- data links --------------------------------------------------------

    def link_attrs(self, other, *names, two_way=False):
        """Alias attributes from ``other``.  Each name is either a string
        (same name both sides) or a tuple ``(mine, theirs)``."""
        for name in names:
            if isinstance(name, tuple):
                mine, theirs = name
            else:
                mine = theirs = name
            LinkableAttribute(self, mine, other, theirs, two_way=two_way)
        return self

    def demand(self, *names):
        """Declare attributes that must be set before initialize()."""
        self._demanded.update(names)

    def verify_demands(self):
        missing = []
        for name in self._demanded:
            try:
                if getattr(self, name) is None:
                    missing.append(name)
            except AttributeError:
                missing.append(name)
        return missing

    # -- lifecycle ---------------------------------------------------------

    @property
    def is_initialized(self):
        return self._is_initialized_

    def initialize(self, **kwargs):
        """Base initialize verifies demands.  Subclasses extend."""
        missing = self.verify_demands()
        if missing:
            raise AttributeError(
                "%s lacks demanded attributes: %s" % (self, missing))
        self._is_initialized_ = True
        return True

    @property
    def stopped(self):
        return bool(self._stopped)

    def stop(self):
        self._stopped <<= True

    def run(self):  # pragma: no cover - abstract
        pass

    # -- pickling ----------------------------------------------------------

    def __getstate__(self):
        state = super(Unit, self).__getstate__()
        for key, value in JAX_UNIT_STATE.items():
            state.setdefault(key, value)
        state.setdefault("_initialized", Bool(False))
        return state

    # -- execution wrapping ------------------------------------------------

    def _timed_run(self):
        if not self._is_initialized_:
            raise RuntimeError("%s.run() before initialize()" % self)
        if self.stopped or (self.workflow is not None and
                            self.workflow.stopped):
            wf = self.workflow
            if (wf is not None and
                    getattr(wf, "finished", False) and
                    not getattr(wf, "stop_requested", True)):
                raise RunAfterStopError(
                    "%s scheduled to run after the workflow finished "
                    "— check its control links" % self)
            return False
        start = time.perf_counter()
        self.run()
        elapsed = time.perf_counter() - start
        self.timers["run"] += elapsed
        self.run_calls += 1
        if _tracer.active:
            # the span and the timer are the same measurement, so
            # print_stats and the trace cannot disagree
            _tracer.complete(self.name, start, elapsed, cat="unit")
        return True

    def _check_gate_and_run(self, src):
        """Gate test + run + propagate."""
        if not self.open_gate(src):
            return
        if bool(self._gate_block):
            return
        with self._run_lock_:
            if bool(self._gate_skip):
                self.run_dependent()
                return
            if self._timed_run() is False:
                return
        self.run_dependent()

    def run_dependent(self):
        """Schedule every successor through the workflow scheduler."""
        wf = self.workflow
        if wf is None:
            for dst in list(self._links_to):
                dst._check_gate_and_run(self)
            return
        for dst in list(self._links_to):
            wf.schedule(dst, self)

    @property
    def dependent_units(self):
        """Transitive closure of links_to, including self."""
        result = []
        seen = set()
        stack = [self]
        while stack:
            unit = stack.pop()
            if id(unit) in seen:
                continue
            seen.add(id(unit))
            result.append(unit)
            stack.extend(unit._links_to)
        return result
