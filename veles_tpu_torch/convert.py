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

__all__ = ["params_from_jax", "state_from_jax", "state_to_numpy",
           "adopt_workflow_state", "xorshift_state_from_jax",
           "xorshift_state_to_jax"]


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


def adopt_workflow_state(sw, state):
    """Adopt a per-layer state list into a port ``StandardWorkflow``'s
    unit Arrays: entry i's ``weights`` / ``bias`` go to ``forwards[i]``,
    its ``accum_*`` / ``accum2_*`` to ``gds[i]``.  ``state`` is host
    arrays (the JAX side is ``compiler.extract_state(sw)`` mapped
    through ``numpy.asarray``); a ``None`` leaf leaves its Array as it
    is.  Works before and after ``initialize``: before, the units keep
    the adopted values instead of drawing their own; after, each Array
    uploads its new host copy at its next device read, and a fused
    trainer re-reads the Arrays."""
    from veles_tpu_torch.compiler import extract_state, state_arrays
    if len(state) != len(sw.forwards):
        raise ValueError("state has %d layers, the workflow %d" %
                         (len(state), len(sw.forwards)))
    for fwd, gd, entry in zip(sw.forwards, sw.gds, state):
        for key, arr in state_arrays(fwd, gd):
            if entry.get(key) is not None:
                arr.map_invalidate()
                arr.mem = numpy.array(entry[key])
    trainer = getattr(sw, "fused_trainer", None)
    if trainer is not None and trainer._state_ is not None:
        trainer._state_ = extract_state(sw)


def xorshift_state_from_jax(state, device):
    """A JAX xorshift state (numpy uint32 hi/lo words: (2, 2, S) for
    xorshift128+, each (16, S) array of xorshift1024*) -> the port's
    int64 tensor of the same values and layout on ``device``."""
    return device.put(numpy.asarray(state, dtype=numpy.uint32).astype(
        numpy.int64))


def xorshift_state_to_jax(state):
    """The port's int64 tensor of uint32 values -> the JAX package's
    numpy uint32 array, same layout."""
    return state.detach().cpu().numpy().astype(numpy.uint32)
