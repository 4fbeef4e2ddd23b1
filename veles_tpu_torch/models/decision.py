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

The divergence watchdog is kept: at each train-class end it reads the
health sources' skip counters and an EMA spike threshold, and on
divergence calls the workflow's ``on_divergence`` hook.  The port has
no snapshots yet, so that hook (or its absence) raises
:class:`DivergenceError`.  Not ported: the telemetry gauges, the
flight-recorder dump, the post-rollback reset and the result-provider
metrics of the command line.
"""

import math

from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit

__all__ = ["DecisionBase", "DecisionGD", "DecisionMSE", "DivergenceError",
           "EmaSpikeWatch", "is_finite_metric"]


class DivergenceError(RuntimeError):
    """Training diverged and no recovery path exists."""


def is_finite_metric(metric):
    """True only for a real, finite scalar metric (None and NaN fail)."""
    if metric is None:
        return False
    try:
        return math.isfinite(float(metric))
    except (TypeError, ValueError):
        return False


class EmaSpikeWatch(object):
    """A value spikes when ``value > spike_factor * max(EMA,
    spike_floor)`` and an EMA exists; a spiking value is reported and
    not folded into the EMA, a healthy one updates ``EMA = beta * EMA +
    (1 - beta) * value``."""

    def __init__(self, spike_factor=10.0, spike_floor=1.0, beta=0.5,
                 label="value"):
        self.spike_factor = float(spike_factor)
        self.spike_floor = float(spike_floor)
        self.beta = float(beta)
        self.label = label
        self.ema = None

    def observe(self, value):
        value = float(value)
        self.ema = value if self.ema is None else \
            self.beta * self.ema + (1.0 - self.beta) * value

    def update(self, value):
        """Check ``value``, then fold it in when healthy.  Returns the
        spike reason, or None."""
        value = float(value)
        threshold = self.spike_factor * max(
            self.ema if self.ema is not None else value,
            self.spike_floor)
        if self.ema is not None and value > threshold:
            return "%s spiked to %.4g (EMA %.4g, threshold %.4g)" % (
                self.label, value, self.ema, threshold)
        self.observe(value)
        return None


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
        self.gd_skip <<= (self.minibatch_class != TRAIN)
        self._accumulate_minibatch()
        if bool(self.last_minibatch):
            self.epoch_metrics[self.minibatch_class] = \
                self._epoch_class_metric(self.minibatch_class)
            self._on_class_ended(self.minibatch_class)
        if bool(self.epoch_ended):
            self._on_epoch_ended()

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
            total += int(unit.skip_count)
            consec = max(consec, int(unit.consecutive_skips))
        return total, consec

    def _check_divergence(self):
        if not self.watchdog or bool(self.diverged):
            return
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
        handler = getattr(self.workflow, "on_divergence", None)
        if handler is None:
            raise DivergenceError(
                "training diverged (%s) and the workflow has no "
                "on_divergence recovery hook" % reason)
        handler(reason)

    def _on_epoch_ended(self):
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
