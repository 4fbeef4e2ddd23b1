"""Deterministic fault injection for recovery testing.

Counterpart of ``veles_tpu/chaos.py``: one seeded, deterministic
harness so the recovery paths of the checkpoint plane are exercised by
tests instead of assumed.  A :class:`FaultPlan` holds named *injection
points* with a trigger (fire on the Nth hit, with probability p, or
always) and an *action* string the site interprets.  The port wires the
training points and the snapshot writer:

==================  ==============================  ======================
point               site                            actions
==================  ==============================  ======================
``step.grad``       ``models.fused.FusedTrainer``   nan (non-finite
                    (train step) /                  gradients: the fused
                    ``models.nn_units``             step adds the poison
                    (``GradientDescentBase.run``,   to every gradient
                    once a GD unit run)             leaf, a per-unit GD
                                                    unit to its
                                                    err_output, so the
                                                    chain skips together)
``step.loss``       ``models.fused.FusedTrainer``   nan (non-finite loss,
                    (train step)                    gradients untouched)
``snapshot.write``  ``snapshotter`` (atomic write)  crash, enospc
==================  ==============================  ======================

The serve points (``serve.*``, ``freshness.publish``) wait for the serve
tier (ROADMAP.md Queue 1 item 9), the network and fleet points
(``net.*``, ``server.*``, ``client.*``, ``slave.*``, ``mesh.*``) for
the master-slave and parallel layers (items 12 and 8).

Activation: programmatic (``chaos.install(FaultPlan(...))`` /
``chaos.uninstall()``) or via ``VELES_CHAOS`` in the environment, e.g.
``VELES_CHAOS="seed=1;step.grad=nan:a4:x8"``.  Every site guards with
``if chaos.plan is not None``: a disabled harness costs one global load
per site, nothing else.

Determinism: triggers count HITS per point under a lock, and the
probability stream comes from one seeded ``random.Random``, so a given
plan against a deterministic run always fires at the same places.
"""

import errno
import os
import random
import threading

import numpy

__all__ = ["Fault", "FaultPlan", "ChaosCrash", "install", "uninstall",
           "install_from_env", "enospc", "poison_tree", "plan"]


class ChaosCrash(BaseException):
    """Simulated sudden process death (the in-process stand-in for
    ``kill -9``).  Derives from BaseException on purpose: recovery code
    that swallows ``Exception`` must NOT accidentally survive a
    simulated crash — only the test harness catches this."""


class Fault(object):
    """One armed injection: where, what, and when it fires."""

    __slots__ = ("point", "action", "nth", "probability", "times",
                 "param", "after", "hits", "fired")

    def __init__(self, point, action, nth=None, probability=None,
                 times=None, param=None, after=None):
        self.point = point
        self.action = action
        self.nth = nth                  # fire on the Nth hit (1-based)
        self.probability = probability  # else: fire with probability p
        self.times = times              # max firings (None = unlimited)
        self.param = param              # action parameter (e.g. delay s)
        self.after = after              # stay silent for the first N hits
        self.hits = 0
        self.fired = 0

    def _should_fire(self, rng):
        self.hits += 1
        if self.after is not None and self.hits <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None:
            return self.hits == self.nth
        if self.probability is not None:
            return rng.random() < self.probability
        return True  # unconditional

    def __repr__(self):
        trig = ("n%d" % self.nth if self.nth is not None else
                "p%g" % self.probability if self.probability is not None
                else "*")
        if self.after is not None:
            trig += ":a%d" % self.after
        return "<Fault %s=%s:%s hits=%d fired=%d>" % (
            self.point, self.action, trig, self.hits, self.fired)


class FaultPlan(object):
    """A seeded set of faults; ``fire(point)`` is the only hot call."""

    def __init__(self, seed=0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._faults = {}
        self._lock = threading.Lock()
        #: chronological (point, action, hit#) record of every firing
        self.log = []

    def add(self, point, action, nth=None, probability=None, times=None,
            param=None, after=None):
        fault = Fault(point, action, nth=nth, probability=probability,
                      times=times, param=param, after=after)
        self._faults.setdefault(point, []).append(fault)
        return self

    def fire(self, point):
        """Count a hit at ``point``; return the triggered :class:`Fault`
        or None.  Thread-safe and deterministic for a given hit order."""
        faults = self._faults.get(point)
        if not faults:
            return None
        with self._lock:
            for fault in faults:
                if fault._should_fire(self._rng):
                    fault.fired += 1
                    self.log.append((point, fault.action, fault.hits))
                    return fault
        return None

    def fired(self, point=None):
        """Total firings (optionally for one point) — test assertions."""
        return sum(1 for p, _, _ in self.log
                   if point is None or p == point)

    @classmethod
    def from_spec(cls, spec):
        """Parse ``"seed=42;point=action[:trigger[:param]];..."``.

        Trigger: ``nK`` = Kth hit exactly once, ``pX`` = probability X
        per hit, ``xM`` = at most M unconditional firings, ``aK`` =
        stay silent for the first K hits (composes with the others:
        ``nan:a8:x12`` fires unconditionally on hits 9-20 — the
        sustained-fault window the nan-injection tests use),
        absent/``*`` = always.  Param is a float handed to the site
        (the poison value for ``nan``)."""
        plan_seed = 0
        entries = []
        for entry in (spec or "").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                plan_seed = int(entry[5:], 0)
                continue
            entries.append(entry)
        plan = cls(seed=plan_seed)
        for entry in entries:
            if "=" not in entry:
                raise ValueError(
                    "chaos spec entry must be point=action[:trigger]"
                    ", got %r" % entry)
            point, _, rhs = entry.partition("=")
            parts = rhs.split(":")
            action = parts[0]
            nth = probability = times = param = after = None
            for token in parts[1:]:
                if not token or token == "*":
                    continue
                if token.startswith("n"):
                    nth, times = int(token[1:]), 1
                elif token.startswith("p"):
                    probability = float(token[1:])
                elif token.startswith("x"):
                    times = int(token[1:])
                elif token.startswith("a"):
                    after = int(token[1:])
                else:
                    param = float(token)
            plan.add(point.strip(), action, nth=nth,
                     probability=probability, times=times, param=param,
                     after=after)
        return plan


#: the active plan; every injection site guards on ``is not None``, so
#: a disabled harness does exactly one global load per site
plan = None


def install(new_plan):
    """Activate a plan process-wide; returns it for chaining."""
    global plan
    plan = new_plan
    return new_plan


def uninstall():
    global plan
    plan = None


def install_from_env(env="VELES_CHAOS"):
    """Activate from the environment (no-op when unset/empty)."""
    spec = os.environ.get(env)
    if spec:
        return install(FaultPlan.from_spec(spec))
    return None


def enospc():
    """The ENOSPC OSError chaos sites raise (one place, one message)."""
    return OSError(errno.ENOSPC, "No space left on device (chaos)")


def poison_tree(obj, value=float("nan")):
    """A structural copy of a payload tree with every float leaf (array
    or scalar) replaced by ``value``.  Integer arrays, strings, and
    other non-float leaves pass through unchanged, so the poisoned
    payload still parses like a real update and only its *numerics* are
    sick."""
    if isinstance(obj, dict):
        return {k: poison_tree(v, value) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(poison_tree(v, value) for v in obj)
    if isinstance(obj, numpy.ndarray) and obj.dtype.kind == "f":
        return numpy.full_like(obj, value)
    if isinstance(obj, float):
        return value
    return obj


install_from_env()
