"""Convolutional autoencoder on the real handwritten digits.

Counterpart of ``examples/conv_autoencoder.py``, with its layers,
hyperparameters and seeds: each 8x8 digit of
``veles_tpu_torch/data/digits.csv.gz`` as an (8, 8, 1) image through
conv_tanh 8 3x3 (padding 1) and avg pooling 2x2 down to a (4, 4, 8)
bottleneck, then depooling 2x2 and deconv 3x3 back to one channel,
trained under the MSE loss; minibatch 48, at most 40 epochs.  On the
card it fuses into one train step a minibatch, the input pipeline
serving ahead: each minibatch is one ``gather_minibatch`` launch and
each train step one ``conv_wgrad`` launch (the conv's weight gradient).

    python -m veles_tpu_torch veles_tpu_torch/examples/conv_autoencoder.py -
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import _SplitLoaderMSE, digits_arrays
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.conv_ae.update({
    "channels": 8,
    "learning_rate": 0.002,
    "gradient_moment": 0.5,
    "minibatch_size": 48,
    "max_epochs": 40,
    "fail_iterations": 12,
})


class DigitsImageAELoader(_SplitLoaderMSE):
    """Digits reshaped (batch, 8, 8, 1); targets are the inputs."""

    def __init__(self, workflow, validation_count=360, seed=4,
                 **kwargs):
        super(DigitsImageAELoader, self).__init__(workflow, **kwargs)
        self.validation_count = validation_count
        self.split_seed = seed

    def get_arrays(self):
        train_x, train_y, valid_x, valid_y = digits_arrays(
            self.validation_count, self.split_seed)
        return (train_x.reshape(-1, 8, 8, 1), train_y,
                valid_x.reshape(-1, 8, 8, 1), valid_y)


def build(launcher):
    cfg = root.conv_ae
    ch = cfg.channels
    hyper = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment}
    return StandardWorkflow(
        launcher,
        layers=[
            # encode: (8,8,1) -> conv tanh -> (8,8,ch) -> pool (4,4,ch)
            dict(type="conv_tanh", n_kernels=ch, kx=3, ky=3,
                 padding=1, **hyper),
            dict(type="avg_pooling", kx=2, ky=2, **hyper),
            # decode: upsample back to 8x8, deconv to one channel
            dict(type="depooling", kx=2, ky=2, **hyper),
            dict(type="deconv", n_output_channels=1, kx=3, ky=3,
                 padding=1, **hyper),
        ],
        loss="mse",
        loader_factory=lambda w: DigitsImageAELoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("conv_ae", seed=17)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
