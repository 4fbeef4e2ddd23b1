"""CIFAR-10 convolutional workflow: the published quality target is
17.21 % validation error.

Counterpart of ``examples/cifar10.py``, with its layers,
hyperparameters and seeds: conv_relu 32, 32, max pooling 2x2, conv_relu
64, 64, max pooling, conv_relu 128, max pooling, all2all_relu 256,
dropout 0.5, softmax 10 (3x3 convs, padding 1; "relu" is the Znicz
softplus), minibatch 100, at most 80 epochs.  On the card it fuses into
one train step a minibatch: each minibatch is one ``gather_minibatch``
launch, each train step 5 ``conv_wgrad`` and 3 ``max_pool_bwd`` launches.

    python -m veles_tpu_torch veles_tpu_torch/examples/cifar10.py -

Needs the CIFAR-10 python batches under ``root.common.dirs.datasets``
(``cifar-10-batches-py/``); see ``veles_tpu_torch/datasets.py``.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import Cifar10Loader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.cifar.update({
    "minibatch_size": 100,
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "weights_decay": 4e-5,
    "dropout": 0.5,
    "max_epochs": 80,
    "fail_iterations": 20,
})


def _conv(n, k, act="conv_relu", stride=1, pad=1):
    cfg = root.cifar
    return {"type": act, "n_kernels": n, "kx": k, "ky": k,
            "sliding": (stride, stride), "padding": pad,
            "learning_rate": cfg.learning_rate,
            "gradient_moment": cfg.gradient_moment,
            "weights_decay": cfg.weights_decay}


def build(launcher):
    cfg = root.cifar
    dense = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay}
    return StandardWorkflow(
        launcher,
        layers=[
            _conv(32, 3), _conv(32, 3),
            {"type": "max_pooling", "kx": 2, "ky": 2},
            _conv(64, 3), _conv(64, 3),
            {"type": "max_pooling", "kx": 2, "ky": 2},
            _conv(128, 3),
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "all2all_relu", "output_sample_shape": 256, **dense},
            {"type": "dropout", "dropout_ratio": cfg.dropout},
            {"type": "softmax", "output_sample_shape": 10, **dense},
        ],
        loader_factory=lambda w: Cifar10Loader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("cifar", seed=3)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
