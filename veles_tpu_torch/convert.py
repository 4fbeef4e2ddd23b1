"""Parameters and training state between the JAX package and the port.

The JAX package's parameter list holds one dict per layer of host
arrays (numpy, or anything ``numpy.asarray`` takes): f32 ``weights`` /
``bias``, or the quantization pass's int8 ``weights`` with f32
``weights_scale`` and ``act_scale``; its training state adds the
solver's ``accum_weights`` / ``accum_bias`` / ``accum2_*`` leaves, with
``None`` for a leaf a layer lacks.  The port uses the same keys and the
same layouts — all2all weights (fan_in, fan_out), conv weights HWIO —
so a list converts leaf by leaf, and one snapshot serves both."""

import numpy

__all__ = ["params_from_jax", "state_from_jax", "state_to_numpy"]


def state_from_jax(state, device):
    """[{key: array or None}] -> [{key: tensor on ``device`` or None}],
    every key of every entry carried across, dtypes and shapes kept."""
    return [{key: None if leaf is None
             else device.put(numpy.asarray(leaf))
             for key, leaf in entry.items()}
            for entry in state]


#: a parameter list is a state list with fewer keys
params_from_jax = state_from_jax


def state_to_numpy(state):
    """[{key: tensor or None}] -> [{key: host numpy array or None}]."""
    return [{key: None if leaf is None else leaf.detach().cpu().numpy()
             for key, leaf in entry.items()}
            for entry in state]
