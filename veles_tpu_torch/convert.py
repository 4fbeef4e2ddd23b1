"""Parameters from the JAX package to the port.

The JAX package's parameter list holds one dict per layer of host
arrays (numpy, or anything ``numpy.asarray`` takes): f32 ``weights`` /
``bias``, or the quantization pass's int8 ``weights`` with f32
``weights_scale`` and ``act_scale``.  The port uses the same keys and
the same layouts — all2all weights (fan_in, fan_out), conv weights HWIO
— so a list converts leaf by leaf, and one snapshot serves both."""

import numpy

__all__ = ["params_from_jax"]


def params_from_jax(params, device):
    """[{key: array or None}] -> [{key: tensor on ``device`` or None}],
    dtypes and shapes kept."""
    return [{key: None if leaf is None
             else device.put(numpy.asarray(leaf))
             for key, leaf in entry.items()}
            for entry in params]
