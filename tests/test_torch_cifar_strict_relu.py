"""chip_smoke.py's CIFAR-10 epoch-check net (examples/cifar10.py's widths
with strict ReLU, the conv and all2all weights uniform in He's bound
+-sqrt(6 / fan_in): ``cifar_layers("str", CIFAR_GAIN)``) per unit in
both packages, over the first train minibatches of chip_smoke.py's
seeded CIFAR-10-shaped images (its ``cifar_arrays``, the same seeds).

At the units' default +-1/sqrt(fan_in) this net sits at ln 10 for ~400
train steps and then learns in a jump that, under cuDNN's
nondeterministic algorithms, overshoots to a dead net in some runs; at
He's bound it leaves ln 10 at once.  The first 4 steps' softmax losses
agree between the packages within 1e-5 (absolute; rounding only, before
learning amplifies it), the error counts summed over all steps within
1 % of the samples, and over the last 10 steps both packages' mean loss
lies under half of ln 10.  The JAX package runs its stock backward
(``PALLAS_BWD_ENV`` "0"), as in tests/test_torch_cifar_softplus.py."""

import math

import numpy

import chip_smoke
from test_torch_cifar_softplus import train_steps

STEPS = 40
TAIL = 10


def test_he_bound_net_leaves_chance_in_both_packages(monkeypatch):
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", "0")
    arrays = chip_smoke.cifar_arrays(chip_smoke.CIFAR_SEED,
                                     chip_smoke.CIFAR_BATCH,
                                     STEPS * chip_smoke.CIFAR_BATCH)
    arrays = tuple(a.astype(numpy.float32) if a.dtype == numpy.uint8
                   else a for a in arrays)
    layers = chip_smoke.cifar_layers("str", chip_smoke.CIFAR_GAIN)
    jax_losses, jax_errors = train_steps("jax", arrays, layers, STEPS)
    losses, errors = train_steps("torch", arrays, layers, STEPS)
    assert numpy.abs(losses - jax_losses)[:4].max() <= 1e-5, \
        numpy.abs(losses - jax_losses)
    assert abs(int(errors.sum()) - int(jax_errors.sum())) <= \
        0.01 * STEPS * chip_smoke.CIFAR_BATCH, (errors, jax_errors)
    for got in (jax_losses, losses):
        assert got[-TAIL:].mean() < 0.5 * math.log(10), got
