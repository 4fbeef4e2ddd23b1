"""STL-10 convolutional workflow: the published quality target is
35.10 % validation error.

Counterpart of ``examples/stl10.py``, with its layers, hyperparameters
and seeds: (96, 96, 3) images through four conv_relu 3x3 (32, 64, 128,
128; padding 1) each followed by max pooling 2x2 (96 -> 48 -> 24 -> 12
-> 6), all2all_relu 256, dropout 0.5 and softmax 10, minibatch 50, at
most 120 epochs.  On the card it fuses into one train step a minibatch:
each minibatch is one ``gather_minibatch`` launch, each train step 4
``conv_wgrad`` and 4 ``max_pool_bwd`` launches.

    python -m veles_tpu_torch veles_tpu_torch/examples/stl10.py -

Needs the STL-10 binary files under ``root.common.dirs.datasets``
(``stl10_binary/train_X.bin`` ...); see ``veles_tpu_torch/datasets.py``.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import Stl10Loader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.stl10.update({
    "minibatch_size": 50,
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 1e-4,
    "dropout": 0.5,
    "max_epochs": 120,
    "fail_iterations": 25,
})


def _conv(n, k, stride=1, pad=1):
    cfg = root.stl10
    return {"type": "conv_relu", "n_kernels": n, "kx": k, "ky": k,
            "sliding": (stride, stride), "padding": pad,
            "learning_rate": cfg.learning_rate,
            "gradient_moment": cfg.gradient_moment,
            "weights_decay": cfg.weights_decay}


def build(launcher):
    cfg = root.stl10
    dense = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay}
    return StandardWorkflow(
        launcher,
        layers=[
            # 96 -> 48 -> 24 -> 12 -> 6 spatial
            _conv(32, 3), {"type": "max_pooling", "kx": 2, "ky": 2},
            _conv(64, 3), {"type": "max_pooling", "kx": 2, "ky": 2},
            _conv(128, 3), {"type": "max_pooling", "kx": 2, "ky": 2},
            _conv(128, 3), {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "all2all_relu", "output_sample_shape": 256,
             **dense},
            {"type": "dropout", "dropout_ratio": cfg.dropout},
            {"type": "softmax", "output_sample_shape": 10, **dense},
        ],
        loader_factory=lambda w: Stl10Loader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("stl10", seed=6)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
