"""What the benchmark makes from ``--seed`` and hands to both the
program and the plain reference: weights, images, labels, the request
pool and the open-loop schedule.

Each kind of input has a seed of its own, derived from the run's seed
and the kind's name, so adding one kind moves no other.  Tensors are
drawn with a ``torch.Generator`` on the device they are used on, in one
large call each; the same seed on the same kind of device gives the
same bits, which is how the reference makes its copy again after the
program's run.
"""

import hashlib
import math

import numpy
import torch

__all__ = ["subseed", "generator", "make_params", "make_images",
           "make_labels", "schedule"]


def subseed(seed, name):
    """A 63-bit seed for input ``name`` of run ``seed`` (any int)."""
    digest = hashlib.sha256(("%d/%s" % (int(seed), name)).encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


def generator(seed, name, device):
    gen = torch.Generator(device=torch.device(device).type)
    gen.manual_seed(subseed(seed, name))
    return gen


def make_params(model, seed, device):
    """[{"weights", "bias"}] per layer (None for a layer without
    parameters) in the program's layouts: He-uniform weights,
    ``U(-b, b)`` with ``b = sqrt(6 / fan_in)``, from one draw over all
    layers; zero biases."""
    layers = model.param_layers
    total = sum(int(math.prod(l.weight_shape)) for l in layers)
    flat = torch.rand(total, generator=generator(seed, "weights", device),
                      device=device)
    flat.mul_(2.0).sub_(1.0)
    params, offset = [], 0
    for layer in model.layers:
        if not layer.has_params:
            params.append({"weights": None, "bias": None})
            continue
        n = int(math.prod(layer.weight_shape))
        w = flat[offset:offset + n].view(layer.weight_shape)
        w.mul_(math.sqrt(6.0 / layer.fan_in))
        offset += n
        params.append({"weights": w, "bias": torch.zeros(
            layer.weight_shape[-1], device=device)})
    return params


def make_images(model, seed, name, count, device):
    """(count,) + input shape float32 images, uniform in [-1, 1)."""
    x = torch.rand((count,) + model.input_shape,
                   generator=generator(seed, name, device), device=device)
    return x.mul_(2.0).sub_(1.0)


def make_labels(model, seed, name, count, device):
    """int64 labels: every class as often as ``count`` allows, in an
    order drawn from the seed (so each seed holds the same multiset,
    and the program's label mapping is the identity whenever ``count``
    reaches the class count)."""
    order = torch.randperm(count, generator=generator(seed, name, device),
                           device=device)
    return order % model.classes


def schedule(seed, rate, seconds, pool):
    """The open-loop arrivals of one run: (due seconds from the window's
    start, sorted; pool index of each request's image).

    The count is fixed, ``round(rate x seconds)``, so every seed offers
    the same work; the times are that many points drawn uniformly over
    the window from the seed (a Poisson process conditioned on its
    count)."""
    count = int(round(float(rate) * float(seconds)))
    rng = numpy.random.Generator(numpy.random.Philox(
        subseed(seed, "arrivals")))
    times = numpy.sort(rng.uniform(0.0, float(seconds), count))
    images = rng.integers(0, pool, count)
    return times, images
