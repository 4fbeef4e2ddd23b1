"""Evaluator units: loss gradients and per-minibatch metrics.

Counterpart of ``veles_tpu/models/evaluator.py``:

- ``err_output`` is the MEAN-loss gradient (divided by the current
  minibatch size), as in the JAX package;
- short (padded) minibatches are masked by ``labels >= 0`` / the
  minibatch size;
- on the device, the metrics (n_err, the confusion matrix, the
  squared-error sum) stay device tensors: the decision unit adds them
  up on the device and reads them on the host once per finished class.
  ``.item()``, ``float(t)`` or a ``map_read`` per minibatch would stall
  the host on the card's stream every minibatch;
- on the host pseudo-device (``NumpyDevice``) an evaluator takes its
  host run, as the JAX package's does: the same ``compute`` over CPU
  tensors copied from the host buffers, ``err_output`` and the
  confusion matrix written back to ``mem``, the metrics host numbers.
"""

import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_units import on_device, operand
from veles_tpu_torch.units import Unit

__all__ = ["EvaluatorBase", "EvaluatorSoftmax", "EvaluatorMSE"]


class EvaluatorBase(Unit):
    """Common plumbing: demands output + batch_size, owns err_output."""

    def __init__(self, workflow, **kwargs):
        super(EvaluatorBase, self).__init__(workflow, **kwargs)
        self.output = None          # linked from the last forward unit
        self.batch_size = None      # linked from loader.minibatch_size
        self.err_output = Array()
        self.device = None
        self.demand("output", "batch_size")

    def initialize(self, device=None, **kwargs):
        self.device = device
        return super(EvaluatorBase, self).initialize(**kwargs)

    def on_device(self):
        return on_device(self)


class EvaluatorSoftmax(EvaluatorBase):
    """Cross-entropy on softmax probabilities.

    err_output = (probs - onehot(label)) / batch_size, zero for padded
    samples; metrics: n_err (misclassifications), confusion_matrix row =
    truth, column = prediction (accumulated over the run).
    """

    def __init__(self, workflow, **kwargs):
        super(EvaluatorSoftmax, self).__init__(workflow, **kwargs)
        self.labels = None          # linked from loader.minibatch_labels
        self.n_err = 0              # per-minibatch, read by decision
        self.confusion_matrix = Array()
        self.demand("labels")

    @staticmethod
    def compute(probs, labels, batch_size, n_classes):
        """(err_output, n_err, confusion) of one minibatch."""
        valid = labels >= 0
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        onehot = torch.zeros_like(probs).scatter(1, safe[:, None], 1.0)
        err = (probs - onehot) * valid[:, None] / batch_size
        pred = torch.argmax(probs, dim=-1)
        n_err = torch.sum((pred != safe) & valid)
        confusion = torch.zeros(n_classes * n_classes, dtype=torch.int32,
                                device=probs.device).index_add(
            0, safe * n_classes + pred, valid.to(torch.int32))
        return (err.to(probs.dtype), n_err,
                confusion.reshape(n_classes, n_classes))

    def init_unpickled(self):
        super(EvaluatorSoftmax, self).init_unpickled()
        self._confusion_acc_ = None

    def run(self):
        err, n_err, confusion = EvaluatorSoftmax.compute(
            operand(self, self.output), operand(self, self.labels),
            float(self.batch_size), self.output.shape[-1])
        if not self.on_device():
            self.err_output.set_host(err)
            self.n_err = int(n_err)
            matrix = confusion.numpy()
            if self.confusion_matrix:
                self.confusion_matrix.map_read()
                matrix = self.confusion_matrix.mem + matrix
            self.confusion_matrix.set_host(matrix)
            return
        device = self.device
        self.err_output.set_device_array(err, device)
        self.n_err = n_err
        acc = self._confusion_acc_
        if acc is None and self.confusion_matrix:
            acc = self.confusion_matrix.device_array(device)
        self._confusion_acc_ = confusion if acc is None else acc + confusion
        self.confusion_matrix.set_device_array(self._confusion_acc_, device)

    def __getstate__(self):
        # snapshots carry plain numbers, not device tensors
        state = super(EvaluatorSoftmax, self).__getstate__()
        state["n_err"] = int(self.n_err)
        state.setdefault("compute_confusion", True)  # the JAX field
        return state


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared-error: err_output = 2 * (y - target) / batch
    (masked); metric: the summed per-sample mean squared error."""

    def __init__(self, workflow, **kwargs):
        super(EvaluatorMSE, self).__init__(workflow, **kwargs)
        self.target = None          # linked from loader.minibatch_targets
        self.mse_sum = 0.0
        self.n_samples = 0
        self.demand("target")

    @staticmethod
    def compute(y, target, batch_size):
        y2 = y.reshape(y.shape[0], -1)
        t2 = target.reshape(target.shape[0], -1)
        mask = (torch.arange(y2.shape[0], device=y2.device) <
                batch_size).to(y2.dtype)
        diff = (y2 - t2) * mask[:, None]
        err = (2.0 * diff / batch_size).to(y.dtype).reshape(y.shape)
        mse_sum = torch.sum(torch.mean(diff * diff, dim=1))
        return err, mse_sum

    def run(self):
        err, mse_sum = EvaluatorMSE.compute(
            operand(self, self.output), operand(self, self.target),
            float(self.batch_size))
        if self.on_device():
            self.err_output.set_device_array(err, self.device)
            self.mse_sum = mse_sum
        else:
            self.err_output.set_host(err)
            self.mse_sum = float(mse_sum)
        self.n_samples = int(self.batch_size)

    def __getstate__(self):
        state = super(EvaluatorMSE, self).__getstate__()
        state["mse_sum"] = float(self.mse_sum)
        return state
