"""Bernoulli RBM pretraining on the real handwritten digits.

Counterpart of ``examples/rbm.py``, with its sizes, hyperparameters and
seeds: CD-1 (64 hidden units, learning rate 0.1) over the 1,437 train
digits of ``veles_tpu_torch/data/digits.csv.gz``, one step an epoch for
60 epochs, drives the reconstruction error down; the readout reports
the held-out reconstruction error on the 360 validation digits.  The
RBM trains on the unit's device (the card unless ``-d cpu``), its binary
states drawn there from JAX's threefry stream.

    python -m veles_tpu_torch veles_tpu_torch/examples/rbm.py -
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import digits_arrays
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.rbm import RBM
from veles_tpu_torch.plumbing import EpochCounter, Repeater
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.workflow import Workflow

root.rbm.update({
    "hidden": 64,
    "epochs": 60,
    "learning_rate": 0.1,
    "cd_k": 1,
})


class RBMWorkflow(Workflow):
    """start -> repeater -> rbm(CD-k) -> counter -> (loop | end)."""

    def __init__(self, launcher, **kwargs):
        super(RBMWorkflow, self).__init__(launcher, **kwargs)
        cfg = root.rbm
        train_x, _, valid_x, _ = digits_arrays(360, 4)
        self.valid_x = valid_x  # already scaled to [0, 1]
        self.holdout_error = None

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.rbm = RBM(self, hidden_size=cfg.hidden,
                       learning_rate=cfg.learning_rate, cd_k=cfg.cd_k,
                       prng=RandomGenerator("rbm", seed=13))
        self.rbm.input = Array(train_x)
        self.rbm.link_from(self.repeater)

        self.counter = EpochCounter(self, int(cfg.epochs))
        self.counter.link_from(self.rbm)

        self.repeater.link_from(self.counter)
        self.end_point.link_from(self.counter)
        self.end_point.gate_block = ~self.counter.complete

    def on_workflow_finished(self):
        self.holdout_error = self.rbm.reconstruct_error(
            self.valid_x)
        self.info("RBM holdout reconstruction error: %.4f "
                  "(train-side final %.4f, %d epochs)",
                  self.holdout_error, self.rbm.reconstruction_error,
                  self.counter.passes)
        super(RBMWorkflow, self).on_workflow_finished()


def run(load, main):
    load(RBMWorkflow)
    main()
