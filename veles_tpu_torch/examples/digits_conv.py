"""Convolutional digit classification: the offline conv quality anchor.

Counterpart of ``examples/digits_conv.py``, with its layers,
hyperparameters and seeds: the 1,797 real 8x8 digits as (8, 8, 1)
images through conv 16 3x3, max pooling 2x2, conv 32 3x3, max pooling
2x2, all2all_relu 64 and softmax 10, minibatch 48, at most 60 epochs.
On the card each train step launches ``gather_minibatch`` once (the
input pipeline's worker serving it ahead), ``conv_wgrad`` twice and
``max_pool_bwd`` twice.

    python -m veles_tpu_torch veles_tpu_torch/examples/digits_conv.py -
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import DigitsLoader, digits_arrays
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.digits_conv.update({
    "minibatch_size": 48,
    "learning_rate": 0.03,
    "gradient_moment": 0.9,
    "weights_decay": 1e-4,
    "max_epochs": 60,
    "fail_iterations": 20,
})


class DigitsImageLoader(DigitsLoader):
    """Digits shaped (batch, 8, 8, 1) for the conv stack."""

    def get_arrays(self):
        train_x, train_y, valid_x, valid_y = digits_arrays(
            self.validation_count, self.split_seed)
        return (train_x.reshape(-1, 8, 8, 1), train_y,
                valid_x.reshape(-1, 8, 8, 1), valid_y)


def build(launcher):
    cfg = root.digits_conv
    hyper = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay}
    return StandardWorkflow(
        launcher,
        layers=[
            dict(type="conv_relu", n_kernels=16, kx=3, ky=3,
                 padding=1, **hyper),
            dict(type="max_pooling", kx=2, ky=2),
            dict(type="conv_relu", n_kernels=32, kx=3, ky=3,
                 padding=1, **hyper),
            dict(type="max_pooling", kx=2, ky=2),
            dict(type="all2all_relu", output_sample_shape=64, **hyper),
            dict(type="softmax", output_sample_shape=10, **hyper),
        ],
        loader_factory=lambda w: DigitsImageLoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("digits_conv", seed=5)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
