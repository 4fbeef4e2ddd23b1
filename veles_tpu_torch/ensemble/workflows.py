"""Ensemble training and testing.

Counterpart of ``veles_tpu/ensemble/workflows.py``, with its names,
files and results.  ``--ensemble-train N:r`` trains N members, each a
workflow built by ``factory(index, seed[, train_ratio])`` (factories
that take a third positional parameter receive ``r``, the member's
share of the train set), in process or farmed as jobs over the job farm
(:mod:`veles_tpu_torch.jobfarm`).  Each member is pickled to
``member_NNN.pickle`` (written to a temporary file and moved into place,
so a speculative copy of the same job never leaves a torn file) and
listed in ``ensemble.json`` under ``models`` with the JAX package's keys
(``id``, ``seed``, ``snapshot``, ``EvaluationFitness``, ``metrics``).
``--ensemble-test`` averages the members' softmax outputs on a batch
(:meth:`EnsembleTester.predict`), in process or farmed, the batch shipped
once a worker as the farm's context.

The port's differences, each forced by the port:

- A fused member's trained state lives in its step
  (``models/fused.py``): the trainer hands it to the unit Arrays
  (``fused_trainer.sync()``, the snapshotter's export) before the member
  is pickled, so the pickle holds the trained weights.
- Members are read through the snapshotter's unpickler
  (``SnapshotterBase._load_pickle``), which maps ``veles_tpu.X`` to
  ``veles_tpu_torch.X``: the port's tester reads an ``ensemble.json`` and
  members that the JAX package wrote, and never imports ``veles_tpu``.
- The device: ``device`` (a port ``Device`` or a backend name) is
  resolved where a member runs (``-d`` / ``VELES_BACKEND``, else the
  card; the CPU only when asked for), and a farmed job carries the
  backend name, from which each worker builds its own ``Device``.
"""

import inspect
import json
import os
import pickle

import numpy
import torch

from veles_tpu_torch.logger import Logger

__all__ = ["EnsembleTrainer", "EnsembleTester"]


def _resolve(device):
    from veles_tpu_torch.launcher import _resolve_device
    return _resolve_device(device)


def _backend(device):
    """A picklable device identity for job specs: the backend name."""
    if device is None or isinstance(device, str):
        return device
    return getattr(device, "backend", None)


def _takes_ratio(factory):
    """Whether ``factory`` takes a third positional parameter (the train
    ratio): three positional parameters, or ``*args``."""
    try:
        params = inspect.signature(factory).parameters.values()
    except (TypeError, ValueError):
        return False
    positional = sum(1 for p in params
                     if p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD))
    return positional >= 3 or any(p.kind == p.VAR_POSITIONAL
                                  for p in params)


class EnsembleTrainer(Logger):
    """Train ``size`` members; pickle each and write the results JSON.

    ``farm_slaves`` > 0 farms the members as jobs: a farm master serves
    member indices and ``farm_slaves`` in-process workers train them at
    once (sharing the card), and remote hosts may join with
    :meth:`worker` against ``farm_address``.  A member's pickle lands on
    the filesystem of the worker that trained it: workers on the same
    host share ``directory``; across hosts it must be a shared mount."""

    FARM_TAG = "ensemble"

    def __init__(self, workflow_factory, size, directory,
                 train_ratio=1.0, device=None, base_seed=1000,
                 farm_slaves=0, farm_address="127.0.0.1:0"):
        super(EnsembleTrainer, self).__init__()
        self.workflow_factory = workflow_factory
        self.size = size
        self.directory = directory
        self.train_ratio = train_ratio
        self.device = device
        self.base_seed = base_seed
        self.farm_slaves = farm_slaves
        self.farm_address = farm_address
        self.results = []
        #: the farm's accounting after a farmed run (JobFarm.stats)
        self.farm_stats = None

    @property
    def results_path(self):
        return os.path.join(self.directory, "ensemble.json")

    def train_member(self, i):
        """Train member ``i`` end to end and return its results entry:
        the farmed job's body, self-contained so any worker (a thread
        here, a remote host through :meth:`worker`) runs it."""
        seed = self.base_seed + i
        device = _resolve(self.device)
        if _takes_ratio(self.workflow_factory):
            sw = self.workflow_factory(i, seed, self.train_ratio)
        else:
            sw = self.workflow_factory(i, seed)
        sw.initialize(device=device)
        sw.run()
        snapshot = os.path.join(self.directory, "member_%03d.pickle" % i)
        # a speculative backup of this job may write the same path
        tmp = "%s.%d.tmp" % (snapshot, os.getpid() ^ id(sw))
        with sw._card_hold():
            trainer = getattr(sw, "fused_trainer", None)
            if trainer is not None:
                trainer.sync()  # the trained state into the unit Arrays
            with open(tmp, "wb") as fout:
                pickle.dump(sw, fout, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, snapshot)
        best = sw.decision.best_metric
        entry = {
            "id": i,
            "seed": seed,
            "snapshot": snapshot,
            "EvaluationFitness": -(float(best) if best is not None
                                   else 1e9),
            "metrics": [None if m is None else float(m)
                        for m in sw.decision.epoch_metrics],
        }
        self.info("member %d/%d trained: metrics %s", i + 1, self.size,
                  entry["metrics"])
        return entry

    @property
    def farm_enabled(self):
        from veles_tpu_torch.jobfarm import farm_enabled
        return farm_enabled(self.farm_slaves, self.farm_address)

    def run(self):
        os.makedirs(self.directory, exist_ok=True)
        if self.farm_enabled:
            from veles_tpu_torch.jobfarm import JobFarm
            farm = JobFarm(self.FARM_TAG, device=self.device)
            self.results = farm.run(
                range(self.size), runner=self.train_member,
                address=self.farm_address, local_slaves=self.farm_slaves)
            self.farm_stats = farm.stats
        else:
            self.results = [self.train_member(i) for i in range(self.size)]
        with open(self.results_path, "w") as fout:
            json.dump({"models": self.results}, fout, indent=1,
                      sort_keys=True)
        return self.results_path

    def worker(self, address):
        """Blocking remote-worker loop: train the members the master at
        ``address`` hands out (build this trainer with the same factory
        and directory on the worker's host).  Returns the number of
        members trained."""
        from veles_tpu_torch.jobfarm import JobFarm
        os.makedirs(self.directory, exist_ok=True)
        return JobFarm(self.FARM_TAG, device=self.device).worker(
            address, self.train_member)


class EnsembleTester(Logger):
    """Load trained members; average their outputs on given data.

    ``farm_slaves`` / ``farm_address`` evaluate the members as farm jobs
    instead of in process; the workers need the member files at their
    recorded paths (the same host or a shared mount)."""

    FARM_TAG = "ensemble-test"

    def __init__(self, results_path, device=None, farm_slaves=0,
                 farm_address="127.0.0.1:0"):
        super(EnsembleTester, self).__init__()
        with open(results_path) as fin:
            self.results = json.load(fin)["models"]
        self.device = device
        self.farm_slaves = farm_slaves
        self.farm_address = farm_address
        self._members = None
        #: the farm's accounting after a farmed predict (JobFarm.stats)
        self.farm_stats = None

    @property
    def farm_enabled(self):
        from veles_tpu_torch.jobfarm import farm_enabled
        return farm_enabled(self.farm_slaves, self.farm_address)

    def _device_spec(self):
        """The picklable device identity of job specs: a worker builds
        its own Device from the backend name."""
        return _backend(self.device)

    @staticmethod
    def _load_member(snapshot, device):
        """One member from its pickle (the port's or the JAX package's),
        initialized on ``device``."""
        from veles_tpu_torch.dummy import DummyLauncher
        from veles_tpu_torch.snapshotter import SnapshotterBase
        sw = SnapshotterBase._load_pickle(snapshot)
        sw.workflow = DummyLauncher()
        sw.initialize(device=_resolve(device))
        return sw

    @staticmethod
    def _forward_outputs(sw, x):
        """One member's forward pass: the one definition the in-process
        and farmed paths both run.  Returns (B, classes) numpy."""
        from veles_tpu_torch.compiler import (build_forward, extract_state,
                                              workflow_plan)
        with sw._card_hold(), torch.no_grad():
            plans = workflow_plan(sw)
            params = [{"weights": s["weights"], "bias": s["bias"]}
                      for s in extract_state(sw)]
            dtype = next(p["weights"].dtype for p in params
                         if p["weights"] is not None)
            batch = sw.device.put(numpy.asarray(x)).to(dtype)
            return build_forward(plans)(params, batch).cpu().numpy()

    @staticmethod
    def predict_member(spec, x):
        """The farmed job's body: load one member and run its forward on
        the context-shipped batch ``x``; returns (B, classes) numpy."""
        snapshot, device_spec = spec
        sw = EnsembleTester._load_member(snapshot, device_spec)
        return EnsembleTester._forward_outputs(sw, x)

    def worker(self, address):
        """Blocking remote-worker loop for a farmed ensemble test."""
        from veles_tpu_torch.jobfarm import JobFarm
        return JobFarm(self.FARM_TAG, device=self.device).worker(
            address, self.predict_member)

    @property
    def members(self):
        if self._members is None:
            self._members = [self._load_member(entry["snapshot"],
                                               self.device)
                             for entry in self.results]
        return self._members

    def predict(self, x):
        """The members' outputs averaged: (B, classes)."""
        if self.farm_enabled:
            from veles_tpu_torch.jobfarm import JobFarm
            device_spec = self._device_spec()
            # the batch ships once a worker, as the farm's context
            farm = JobFarm(self.FARM_TAG, context=numpy.asarray(x),
                           device=self.device)
            outputs = farm.run(
                [(entry["snapshot"], device_spec)
                 for entry in self.results],
                runner=self.predict_member, address=self.farm_address,
                local_slaves=self.farm_slaves)
            self.farm_stats = farm.stats
            return numpy.mean(outputs, axis=0)
        outputs = [self._forward_outputs(sw, x) for sw in self.members]
        return numpy.mean(outputs, axis=0)

    def error_rate(self, x, labels):
        probs = self.predict(x)
        pred = probs.argmax(axis=1)
        return 100.0 * float((pred != labels).sum()) / len(labels)
