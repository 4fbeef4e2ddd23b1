"""examples/cifar10.py's net at full width (softplus "RELU" convs 32,
32, 64, 64, 128 with max pooling, all2all_relu 256, dropout 0.5,
softmax 10; lr 0.02, moment 0.9, weight decay 4e-5, minibatch 100) per
unit in both packages, over the first 60 train minibatches of
chip_smoke.py's seeded CIFAR-10-shaped images (its ``cifar_arrays``
and ``cifar_layers``, the same seeds).

This is why chip_smoke.py's one-epoch error check trains the net's
strict-ReLU variant: on these images the example's net sits at chance
in the JAX package just as in the port.  Each step's softmax loss
agrees between the packages within 1e-5 (absolute), their summed
minibatch error counts within 3 samples, and over the last 30 steps
both packages' mean loss lies within 0.02 of ln 10 and their error
rate at or above 80 %: the loss and the error of guessing.  The JAX
package runs its stock backward (``PALLAS_BWD_ENV`` "0"): its Pallas
backward in interpret mode would take minutes a step at this width,
and tests/test_torch_gd_units.py holds the conv GD units to it."""

import math

import numpy

import chip_smoke
from test_torch_workflow import (CPU, DummyLauncher, JaxArraysLoader,
                                 JaxDevice, JaxLauncher, JaxWorkflow,
                                 StandardWorkflow, TorchArraysLoader,
                                 jax_prng, torch_prng, unit_step)

STEPS = 60
TAIL = 30


def host(array):
    array.map_read()
    return numpy.asarray(array.mem)


def train_steps(package, arrays):
    """The per-unit workflow of one package, through its validation
    minibatch and STEPS train steps; each train step's softmax loss and
    error count."""
    if package == "jax":
        workflow, launcher, rng, loader = \
            JaxWorkflow, JaxLauncher, jax_prng, JaxArraysLoader
        device = JaxDevice(backend="cpu")
    else:
        workflow, launcher, rng, loader = \
            StandardWorkflow, DummyLauncher, torch_prng, TorchArraysLoader
        device = CPU
    sw = workflow(
        launcher(), layers=chip_smoke.cifar_layers(),
        loader_factory=lambda w: loader(
            w, arrays, minibatch_size=chip_smoke.CIFAR_BATCH,
            prng=rng.RandomGenerator("cifar", seed=3),
            normalization_type="mean_disp"),
        decision_config=dict(max_epochs=1))
    rng.get().seed(chip_smoke.CIFAR_SEED)
    sw.initialize(device=device)
    assert getattr(sw, "fused_trainer", None) is None
    losses, errors = [], []
    while len(losses) < STEPS:
        unit_step(sw)
        if sw.loader.minibatch_class != 2:
            continue
        probs = host(sw.forwards[-1].output).astype(numpy.float64)
        labels = host(sw.loader.minibatch_labels)
        losses.append(-numpy.log(probs[numpy.arange(len(labels)),
                                       labels]).mean())
        errors.append(int(sw.evaluator.n_err))
    return numpy.array(losses), numpy.array(errors)


def test_example_net_sits_at_chance_in_both_packages(monkeypatch):
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", "0")
    arrays = chip_smoke.cifar_arrays(chip_smoke.CIFAR_SEED,
                                     chip_smoke.CIFAR_BATCH,
                                     STEPS * chip_smoke.CIFAR_BATCH)
    arrays = tuple(a.astype(numpy.float32) if a.dtype == numpy.uint8
                   else a for a in arrays)
    jax_losses, jax_errors = train_steps("jax", arrays)
    losses, errors = train_steps("torch", arrays)
    assert numpy.abs(losses - jax_losses).max() <= 1e-5, \
        numpy.abs(losses - jax_losses).max()
    assert abs(int(errors.sum()) - int(jax_errors.sum())) <= 3
    batch = chip_smoke.CIFAR_BATCH
    for got, err in ((jax_losses, jax_errors), (losses, errors)):
        assert abs(got[-TAIL:].mean() - math.log(10)) <= 0.02, got
        assert err[-TAIL:].sum() >= 0.8 * TAIL * batch, err
