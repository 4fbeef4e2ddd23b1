"""The farm phase's ensemble members at the JAX package's quality setting,
both packages, on the CPU (slow: six trainings of 40 epochs, and six of
50).

``scripts/torch_farm_phase.py`` trains three digits_conv members at 0.8
of the train set (seeds 1000-1002) and holds each to the JAX package's
digits_conv limit (``tests/test_quality.py``: best validation error at
most 2.5 % after 40 epochs of the whole train set).  This test trains
the same members for 40 epochs, and for 50 (as many samples as that
run at 0.8 of the train set an epoch), with the JAX package's
``EnsembleTrainer`` and the port's, from the same seeds, and prints
both sets of best errors: it shows whether each setting meets the limit
in the reference itself, and that the port's members follow the
reference's within one validation sample; at 50 epochs, the phase's
setting, every member of both meets the limit.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_farm_quality.py \\
        -m slow -s
"""

import functools
import importlib
import json
import os
import sys

import pytest
import torch

from tests.torch_imports import JAX_EXAMPLES, REPO, restored_imports

MEMBERS, RATIO, BASE_SEED = 3, 0.8, 1000
#: one validation sample of the digits' 360, in percent
ONE_SAMPLE = 100.0 / 360
#: the phase's epochs, at which both packages' members meet the limit
PHASE_EPOCHS, DIGITS_LIMIT = 50, 2.5


def _jax_factory(epochs, index, seed, ratio):
    """``scripts/torch_farm_workflow.py``'s member, on the JAX package."""
    from veles_tpu.config import root
    from veles_tpu.dummy import DummyWorkflow
    from veles_tpu.models.nn_workflow import StandardWorkflow
    from veles_tpu.prng import RandomGenerator
    # imported by its bare name, as the pickle of a member names it
    module = importlib.import_module("digits_conv")
    cfg = root.digits_conv
    hyper = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay,
             "prng": RandomGenerator("farm_layers", seed=seed)}
    return StandardWorkflow(
        DummyWorkflow().workflow,
        layers=[
            dict(type="conv_relu", n_kernels=16, kx=3, ky=3, padding=1,
                 **hyper),
            dict(type="max_pooling", kx=2, ky=2),
            dict(type="conv_relu", n_kernels=32, kx=3, ky=3, padding=1,
                 **hyper),
            dict(type="max_pooling", kx=2, ky=2),
            dict(type="all2all_relu", output_sample_shape=64, **hyper),
            dict(type="softmax", output_sample_shape=10, **hyper),
        ],
        loader_factory=lambda w: module.DigitsImageLoader(
            w, minibatch_size=cfg.minibatch_size, train_ratio=ratio,
            prng=RandomGenerator("farm_loader", seed=seed)),
        decision_config=dict(max_epochs=epochs,
                             fail_iterations=cfg.fail_iterations))


def _best(results_path):
    with open(results_path) as fin:
        return [-entry["EvaluationFitness"]
                for entry in json.load(fin)["models"]]


@pytest.mark.slow
@pytest.mark.parametrize("epochs", [40, 50])
def test_members_follow_the_jax_package(epochs, tmp_path):
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.ensemble import EnsembleTrainer as JaxTrainer
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ensemble import EnsembleTrainer
    with restored_imports():
        sys.modules.pop("digits_conv", None)
        sys.path.insert(0, JAX_EXAMPLES)
        jax_best = _best(JaxTrainer(
            functools.partial(_jax_factory, epochs), size=MEMBERS,
            directory=str(tmp_path / "jax"),
            train_ratio=RATIO, device=JaxDevice(backend="cpu"),
            base_seed=BASE_SEED).run())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with restored_imports():
            sys.path.insert(0, os.path.join(REPO, "scripts"))
            import torch_farm_workflow
            saved = root.farm_workflow.epochs
            root.farm_workflow.epochs = epochs
            try:
                port_best = _best(EnsembleTrainer(
                    torch_farm_workflow.member_factory, size=MEMBERS,
                    directory=str(tmp_path / "port"), train_ratio=RATIO,
                    device=Device("cpu"), base_seed=BASE_SEED).run())
            finally:
                root.farm_workflow.epochs = saved
    finally:
        torch.set_num_threads(threads)
    print("digits_conv members, %d epochs at %.1f of the train set, "
          "seeds %d-%d: best validation error %% JAX %s, port %s" % (
              epochs, RATIO, BASE_SEED, BASE_SEED + MEMBERS - 1,
              jax_best, port_best))
    assert len(jax_best) == len(port_best) == MEMBERS
    for got, want in zip(port_best, jax_best):
        # in validation samples (the JAX package's errors are float32)
        assert abs(round(got / ONE_SAMPLE) - round(want / ONE_SAMPLE)) \
            <= 1, (port_best, jax_best)
    if epochs == PHASE_EPOCHS:
        assert max(jax_best) <= DIGITS_LIMIT, jax_best
        assert max(port_best) <= DIGITS_LIMIT, port_best
