"""Digits MLP autoencoder: the offline stand-in for the MNIST
autoencoder's quality anchor (validation RMSE 0.5478, which needs MNIST).

Counterpart of ``examples/autoencoder.py``, with its layers,
hyperparameters and seeds: each 8x8 digit of
``veles_tpu_torch/data/digits.csv.gz`` is reconstructed through
all2all_tanh 48 -> 12 -> 48 -> all2all 64 under the MSE loss, minibatch
48, at most 60 epochs.  On the card it fuses into one train step a
minibatch, the input pipeline serving ahead; each minibatch is one
``gather_minibatch`` launch.

    python -m veles_tpu_torch veles_tpu_torch/examples/autoencoder.py -
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import _SplitLoaderMSE, digits_arrays
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.models.zoo import autoencoder_layers
from veles_tpu_torch.prng import RandomGenerator

root.digits_ae.update({
    "bottleneck": 12,
    "hidden": 48,
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "minibatch_size": 48,
    "max_epochs": 60,
    "fail_iterations": 15,
})


class DigitsAELoader(_SplitLoaderMSE):
    """Reconstruction task: the targets are the inputs, laid out
    [valid | train] by the split-loader base."""

    def __init__(self, workflow, validation_count=360, seed=4,
                 **kwargs):
        super(DigitsAELoader, self).__init__(workflow, **kwargs)
        self.validation_count = validation_count
        self.split_seed = seed

    def get_arrays(self):
        return digits_arrays(self.validation_count, self.split_seed)


def build(launcher):
    cfg = root.digits_ae
    return StandardWorkflow(
        launcher,
        layers=autoencoder_layers(
            bottleneck=cfg.bottleneck, hidden=cfg.hidden,
            out_features=64, lr=cfg.learning_rate,
            moment=cfg.gradient_moment),
        loss="mse",
        loader_factory=lambda w: DigitsAELoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("digits_ae", seed=11)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
