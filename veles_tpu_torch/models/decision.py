"""Decision unit — epoch bookkeeping and the stop criterion.

Counterpart of ``veles_tpu/models/decision.py``: accumulates the
evaluator's per-minibatch metrics into per-class epoch totals, tracks
the best validation error, raises ``improved`` on a new best, skips
gradient descent on non-TRAIN minibatches through the shared ``gd_skip``
Bool, and sets ``complete`` when ``fail_iterations`` epochs pass without
improvement or ``max_epochs`` is reached.

The metrics arrive as device tensors and are added up on the device;
the host reads each class's total once, when the class ends (one sync
per finished class, none per minibatch).  A non-finite metric is never
recorded as improved or best.

The divergence watchdog (``veles_tpu_torch.health``) is kept: at each
train-class end it reads the health sources' skip counters and an EMA
spike threshold, and on divergence calls the workflow's
``on_divergence`` hook.  ``StandardWorkflow`` rolls back to its last
verified snapshot there, backs off the learning rates and calls
:meth:`DecisionBase.reset_divergence`; a workflow without a snapshotter
(or without the hook) raises :class:`DivergenceError`.  The epoch
totals pickle as Python numbers (``__getstate__``).

The master-slave contract (``DecisionGD``): a slave ships its job's
error counts (``n_err``, host ints) and resets them; the master adds
them up and, when its loader's flags say the update closed a class or
an epoch, records the metric and ends the epoch as a run would,
finishing the workflow once ``complete`` is set.  Jobs carry
``complete`` to the slaves.  A slave's watchdog stays quiet: the master
owns recovery.

Telemetry, at the syncs the unit already has: each finished class
publishes its metric as the ``metric.<class>`` gauge (never a
non-finite one: heartbeat lines stay strict JSON), the train class's
health read publishes ``health.skip_count`` and
``health.consecutive_skips``, a divergence dumps the flight recorder
before recovery changes anything, and each finished epoch sets
``train.epoch``.  While the tracer or a ``torch.profiler`` records, a
run is a ``decision.run`` span, and a finished class's host reads (the
class-end sync, the health counters) a ``decision.class_end`` span
inside it.
"""

import math
import time

from veles_tpu_torch.health import (DivergenceError, EmaSpikeWatch,
                                    is_finite_metric)
from veles_tpu_torch.loader.base import CLASS_NAME, TRAIN, VALID
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.observe.flight import flight as _flight
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.units import Unit

__all__ = ["DecisionBase", "DecisionGD", "DecisionMSE", "DivergenceError",
           "EmaSpikeWatch", "is_finite_metric"]


class DecisionBase(Unit):
    """Epoch metric aggregation, stop control and divergence watchdog.

    Watchdog kwargs: ``watchdog`` (True), ``skip_budget`` (16
    consecutive skipped steps), ``spike_factor`` (10.0) /
    ``spike_floor`` (1.0) / ``ema_beta`` (0.5).
    """

    def __init__(self, workflow, **kwargs):
        super(DecisionBase, self).__init__(workflow, **kwargs)
        self.max_epochs = kwargs.get("max_epochs", None)
        self.fail_iterations = kwargs.get("fail_iterations", 100)
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.train_improved = Bool(False)
        self.gd_skip = Bool(False)
        self.diverged = Bool(False)
        self.watchdog = kwargs.get("watchdog", True)
        self.skip_budget = kwargs.get("skip_budget", 16)
        self.spike_factor = kwargs.get("spike_factor", 10.0)
        self.spike_floor = kwargs.get("spike_floor", 1.0)
        self.ema_beta = kwargs.get("ema_beta", 0.5)
        #: units exposing skip_count / consecutive_skips counters (the
        #: gds, or the fused trainer); wired by the workflow
        self.health_sources = []
        self._spike_watch = EmaSpikeWatch(
            spike_factor=self.spike_factor,
            spike_floor=self.spike_floor, beta=self.ema_beta,
            label="train metric")
        self._skips_seen = 0
        # linked from loader:
        self.minibatch_class = None
        self.last_minibatch = None
        self.epoch_ended = None
        self.epoch_number = None
        self.class_lengths = None
        self.demand("minibatch_class", "last_minibatch", "class_lengths",
                    "epoch_ended", "epoch_number")
        self.epoch_metrics = [None, None, None]
        self.best_metric = None
        self.best_epoch = 0
        self.best_train_metric = None

    def initialize(self, **kwargs):
        super(DecisionBase, self).initialize(**kwargs)
        self._reset_epoch_accumulators()
        return True

    def _reset_epoch_accumulators(self):
        raise NotImplementedError

    def _accumulate_minibatch(self):
        raise NotImplementedError

    def _epoch_class_metric(self, class_index):
        """Finished class -> scalar metric (lower is better)."""
        raise NotImplementedError

    def run(self):
        if not _tracer.live:
            self._run(False)
            return
        with _tracer.open("decision.run", cat="decision"):
            self._run(True)

    def _run(self, live):
        self.gd_skip <<= (self.minibatch_class != TRAIN)
        self._accumulate_minibatch()
        if bool(self.last_minibatch):
            start = time.perf_counter() if live else None
            self._record_class_metric(self.minibatch_class)
            self._on_class_ended(self.minibatch_class)
            if start is not None:
                _tracer.complete("decision.class_end", start,
                                 time.perf_counter() - start,
                                 cat="decision")
        if bool(self.epoch_ended):
            self._on_epoch_ended()

    def _record_class_metric(self, cls):
        """A finished class: its metric (the class-end sync) into
        ``epoch_metrics`` and, when finite, the ``metric.<class>``
        gauge."""
        metric = self._epoch_class_metric(cls)
        self.epoch_metrics[cls] = metric
        if metric is not None and is_finite_metric(metric):
            _registry.gauge("metric.%s" % CLASS_NAME[cls]).set(metric)

    @staticmethod
    def _metric_improves(metric, best):
        if not is_finite_metric(metric):
            return False
        return best is None or metric < best

    def _on_class_ended(self, cls):
        # improvement is judged on VALID when present, else on TRAIN
        judge = VALID if self.class_lengths[VALID] > 0 else TRAIN
        if cls == judge:
            metric = self.epoch_metrics[cls]
            if self._metric_improves(metric, self.best_metric):
                self.best_metric = metric
                self.best_epoch = self.epoch_number
                self.improved <<= True
            else:
                self.improved <<= False
        if cls == TRAIN:
            metric = self.epoch_metrics[TRAIN]
            better = self._metric_improves(metric,
                                           self.best_train_metric)
            if better:
                self.best_train_metric = metric
            self.train_improved <<= better
            self._check_divergence()

    # -- divergence watchdog ------------------------------------------------

    def _health_counters(self):
        """Read the health sources' counters (once per finished train
        class).  Returns (total_skips, max_consecutive_skips)."""
        total = 0
        consec = 0
        for unit in self.health_sources:
            skips = int(unit.skip_count)
            unit_consec = int(unit.consecutive_skips)
            total += skips
            consec = max(consec, unit_consec)
            hook = getattr(unit, "on_health_sync", None)
            if hook is not None:
                # rides this sync: the fused trainer's bf16 -> f32
                # gradient fall-back reacts to fresh skips here
                hook(skips=skips, consec=unit_consec)
        # the counters are host ints now: publishing them adds no sync
        _registry.gauge("health.skip_count").set(total)
        _registry.gauge("health.consecutive_skips").set(consec)
        return total, consec

    def _check_divergence(self):
        if not self.watchdog or bool(self.diverged):
            return
        if self.workflow is not None and \
                self.workflow.workflow_mode == "slave":
            return  # the master owns recovery; slaves ship metrics
        reasons = []
        total, consec = self._health_counters()
        fresh = total - self._skips_seen
        self._skips_seen = total
        if consec >= self.skip_budget:
            reasons.append(
                "%d consecutive non-finite train steps skipped "
                "(budget %d)" % (consec, self.skip_budget))
        metric = self.epoch_metrics[TRAIN]
        if metric is not None:
            if not is_finite_metric(metric):
                reasons.append("non-finite train metric %r" % (metric,))
            else:
                spike = self._spike_watch.update(metric)
                if spike is not None:
                    reasons.append(spike)
        if fresh and not reasons:
            self.warning(
                "numerics guard skipped %d non-finite train step(s) "
                "this epoch (consecutive max %d, budget %d)",
                fresh, consec, self.skip_budget)
        if reasons:
            self._trip("; ".join(reasons))

    def _trip(self, reason):
        self.diverged <<= True
        self.error("training diverged at epoch %s: %s",
                   self.epoch_number, reason)
        # the black box first: its ring holds the steps and heartbeats
        # leading into the divergence, which recovery is about to bury
        _flight.dump(reason="divergence")
        handler = getattr(self.workflow, "on_divergence", None)
        if handler is None:
            raise DivergenceError(
                "training diverged (%s) and the workflow has no "
                "on_divergence recovery hook" % reason)
        handler(reason)

    def reset_divergence(self):
        """Post-rollback reset (the workflow's recovery hook calls it
        after the counters were zeroed): the watchdog starts a fresh
        observation window."""
        self.diverged <<= False
        self._spike_watch.reset()
        self._skips_seen = 0

    def get_metric_values(self):
        return {
            "Errors": {CLASS_NAME[i]: self.epoch_metrics[i]
                       for i in range(3)},
            "Best metric": self.best_metric,
            "Best epoch": self.best_epoch,
        }

    def _on_epoch_ended(self):
        _registry.gauge("train.epoch").set(int(self.epoch_number))
        self.info("Epoch %d metrics: test %s, validation %s, train %s",
                  self.epoch_number,
                  self.epoch_metrics[0], self.epoch_metrics[1],
                  self.epoch_metrics[2])
        stop = False
        if self.max_epochs is not None and \
                self.epoch_number >= self.max_epochs:
            stop = True
        if self.best_metric is not None and \
                self.epoch_number - self.best_epoch > self.fail_iterations:
            stop = True
        if stop:
            self.complete <<= True
        self._reset_epoch_accumulators()


class DecisionGD(DecisionBase):
    """Classification: metric = error percentage from evaluator.n_err."""

    def __init__(self, workflow, **kwargs):
        super(DecisionGD, self).__init__(workflow, **kwargs)
        self.evaluator = None  # linked: needs .n_err per minibatch
        self.demand("evaluator")
        self.epoch_n_err = [0, 0, 0]

    def _reset_epoch_accumulators(self):
        self.epoch_n_err = [0, 0, 0]

    def _accumulate_minibatch(self):
        # a device add; the float() at class end is the only host read
        cls = self.minibatch_class
        self.epoch_n_err[cls] = self.epoch_n_err[cls] + self.evaluator.n_err

    def _epoch_class_metric(self, class_index):
        length = self.class_lengths[class_index]
        if length == 0:
            return None
        return float(100.0 * float(self.epoch_n_err[class_index]) / length)

    # -- the master-slave contract ----------------------------------------

    def generate_data_for_slave(self, slave=None):
        return {"complete": bool(self.complete)}

    def apply_data_from_master(self, data):
        self.complete <<= data.get("complete", False)

    def generate_data_for_master(self):
        # the payload is host ints: the job's one read of the counts
        delta = [int(v) for v in self.epoch_n_err]
        self._reset_epoch_accumulators()
        return {"n_err": delta}

    def apply_data_from_slave(self, data, slave=None):
        if not data:
            return
        for i, n in enumerate(data.get("n_err", ())):
            self.epoch_n_err[i] += n
        if bool(self.last_minibatch):
            # the class-end path of run(): the master's gauges and
            # health counters stay live while the slaves train
            self._record_class_metric(self.minibatch_class)
            self._on_class_ended(self.minibatch_class)
        if bool(self.epoch_ended):
            self._on_epoch_ended()
        if bool(self.complete) and self.workflow is not None:
            self.workflow.on_workflow_finished()

    def __getstate__(self):
        state = super(DecisionGD, self).__getstate__()
        state["epoch_n_err"] = [int(v) for v in self.epoch_n_err]
        return state


class DecisionMSE(DecisionBase):
    """Regression: metric = epoch RMSE from evaluator.mse_sum."""

    def __init__(self, workflow, **kwargs):
        super(DecisionMSE, self).__init__(workflow, **kwargs)
        self.evaluator = None  # linked: needs .mse_sum / .n_samples
        self.demand("evaluator")
        self.epoch_sse = [0.0, 0.0, 0.0]

    def _reset_epoch_accumulators(self):
        self.epoch_sse = [0.0, 0.0, 0.0]

    def _accumulate_minibatch(self):
        cls = self.minibatch_class
        self.epoch_sse[cls] = self.epoch_sse[cls] + self.evaluator.mse_sum

    def _epoch_class_metric(self, class_index):
        length = self.class_lengths[class_index]
        if length == 0:
            return None
        return math.sqrt(float(self.epoch_sse[class_index]) / length)

    def __getstate__(self):
        state = super(DecisionMSE, self).__getstate__()
        state["epoch_sse"] = [float(v) for v in self.epoch_sse]
        return state
