"""Restricted Boltzmann Machine units.

Counterpart of ``veles_tpu/models/rbm.py``: a binary-binary RBM trained
with CD-k contrastive divergence.  One run is one CD step over the whole
input: up, k Gibbs alternations, down, gradient, update.  The binary
states are JAX's draws bit for bit: the step's key is ``fold_in(key(seed),
step)`` and each draw ``uniform(sub, shape) < p`` after ``key, sub =
split(key)``, all from ``veles_tpu_torch/threefry.py``.  The step
counter ``_step`` is the whole RNG state, as in the JAX package: a
snapshot carries nothing else to resume the stream.

The unit runs on its device (the card unless the CPU is asked for): the
weights and biases stay device tensors in their Arrays, each run hands
them new ones, and the reconstruction error of the last step is read to
the host only when asked for (``reconstruction_error``), as is the
held-out readout (:meth:`RBM.reconstruct_error`).  The JAX unit pins
itself to the host and copies back to numpy on every run; the port's
does so on the host pseudo-device (``NumpyDevice``), where the step
runs on CPU tensors copied from the host buffers and writes the new
weights and biases back into ``mem``.
"""

import numpy
import torch

from veles_tpu_torch import prng as prng_module
from veles_tpu_torch import threefry
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_units import adopt, operand
from veles_tpu_torch.units import Unit

__all__ = ["RBM"]


class RBM(Unit):
    def __init__(self, workflow, **kwargs):
        super(RBM, self).__init__(workflow, **kwargs)
        self.hidden_size = kwargs["hidden_size"]
        self.learning_rate = kwargs.get("learning_rate", 0.1)
        self.cd_k = kwargs.get("cd_k", 1)
        self.input = None  # linked minibatch (values in [0, 1])
        self.weights = Array()
        self.hidden_bias = Array()
        self.visible_bias = Array()
        self.prng = kwargs.get("prng", prng_module.get())
        self.device = None
        self._step = 0
        self._reconstruction_error = 0.0
        self.demand("input")

    def init_unpickled(self):
        super(RBM, self).init_unpickled()
        self._error_tensor_ = None

    def initialize(self, device=None, **kwargs):
        self.device = device
        super(RBM, self).initialize(**kwargs)
        if not self.input or self.input.sample_size == 0:
            raise AttributeError("%s: input shape unknown" % self.name)
        visible = self.input.sample_size
        if not self.weights:
            w = numpy.zeros((visible, self.hidden_size), numpy.float32)
            self.prng.fill_normal(w, 0.0, 0.01)
            self.weights.mem = w
            self.hidden_bias.mem = numpy.zeros(
                self.hidden_size, numpy.float32)
            self.visible_bias.mem = numpy.zeros(visible, numpy.float32)
        for arr in (self.weights, self.hidden_bias, self.visible_bias):
            arr.initialize(device)
        return True

    @property
    def reconstruction_error(self):
        """Mean squared v0 - vk of the last CD step (a host read of the
        card's value, made once per step when asked for)."""
        if self._error_tensor_ is not None:
            self._reconstruction_error = float(self._error_tensor_)
            self._error_tensor_ = None
        return self._reconstruction_error

    def __getstate__(self):
        state = super(RBM, self).__getstate__()
        state["_reconstruction_error"] = self.reconstruction_error
        return state

    @staticmethod
    def cd_step(key, W, hb, vb, v0, lr, cd_k):
        """One CD-k step: (W, hb, vb, mean squared error) after it.
        ``key`` is a threefry key (a pair of ints), ``lr`` a float32
        scalar."""
        def h_probs(v):
            return torch.sigmoid(v @ W + hb)

        def v_probs(h):
            return torch.sigmoid(h @ W.T + vb)

        def sample(k, p):
            return (threefry.uniform(k, p.shape, p.device) < p).to(
                torch.float32)

        lr = float(numpy.float32(lr))
        v0 = v0.reshape(v0.shape[0], -1).to(torch.float32)
        ph0 = h_probs(v0)
        key, sub = threefry.split(key)
        h = sample(sub, ph0)
        vk = v0
        for _ in range(cd_k):
            vk = v_probs(h)  # probabilities (common CD practice)
            phk = h_probs(vk)
            key, sub = threefry.split(key)
            h = sample(sub, phk)
        phk = h_probs(vk)
        batch = v0.shape[0]
        grad_w = (v0.T @ ph0 - vk.T @ phk) / batch
        grad_hb = torch.mean(ph0 - phk, dim=0)
        grad_vb = torch.mean(v0 - vk, dim=0)
        err = torch.mean((v0 - vk) ** 2)
        return (W + lr * grad_w, hb + lr * grad_hb, vb + lr * grad_vb,
                err)

    def run(self):
        self._step += 1
        key = threefry.fold_in(threefry.key(self.prng.seed_value or 0),
                               self._step)
        new_w, new_hb, new_vb, err = RBM.cd_step(
            key, operand(self, self.weights),
            operand(self, self.hidden_bias),
            operand(self, self.visible_bias), operand(self, self.input),
            self.learning_rate, self.cd_k)
        adopt(self, self.weights, new_w)
        adopt(self, self.hidden_bias, new_hb)
        adopt(self, self.visible_bias, new_vb)
        self._error_tensor_ = err

    def reconstruct_error(self, data):
        """Deterministic mean-field v -> h -> v reconstruction MSE on
        arbitrary data (the held-out quality readout; no sampling), a
        host float."""
        W = operand(self, self.weights)
        v = self.device.put(numpy.reshape(
            numpy.asarray(data, numpy.float32), (len(data), -1)))
        h = torch.sigmoid(v @ W + operand(self, self.hidden_bias))
        vr = torch.sigmoid(h @ W.T + operand(self, self.visible_bias))
        return float(torch.mean((v - vr) ** 2))
