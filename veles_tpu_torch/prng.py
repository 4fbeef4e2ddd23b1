"""Reproducible host-side random number generation.

Counterpart of ``veles_tpu/prng.py``: a keyed registry of
``numpy.random.Generator`` objects over the Philox bit generator whose
state pickles with the workflow.  The same seed gives the same weight
fills and shuffles as the JAX package, bit for bit.  Device-side draws
(dropout masks) come from JAX's threefry2x32 key stream, which
``veles_tpu_torch.threefry`` ports; the JAX package's ``jax_key``
helper has no counterpart.
"""

import os
import threading

import numpy

__all__ = ["RandomGenerator", "get"]


class RandomGenerator(object):
    """A named, seedable, picklable numpy RNG."""

    def __init__(self, key, seed=None):
        self.key = key
        self._lock = threading.Lock()
        self._seed = None
        self.seed(seed if seed is not None else self._default_seed())

    @staticmethod
    def _default_seed():
        env = os.environ.get("VELES_SEED")
        if env:
            return int(env, 0)
        return 1234567890  # fixed default: reproducible out of the box

    @property
    def seed_value(self):
        return self._seed

    def seed(self, seed):
        """Reset state.  ``seed`` may be int, bytes, or ndarray."""
        if isinstance(seed, (bytes, bytearray)):
            seed = int.from_bytes(bytes(seed[:8]).ljust(8, b"\0"), "little")
        elif isinstance(seed, numpy.ndarray):
            seed = int(numpy.asarray(seed).ravel()[0])
        with self._lock:
            self._seed = int(seed) & (2 ** 64 - 1)
            self._np = numpy.random.Generator(
                numpy.random.Philox(self._seed))

    def fill(self, arr, vmin=-1.0, vmax=1.0):
        """Fill an ndarray in-place with uniforms in [vmin, vmax)."""
        with self._lock:
            arr[...] = self._np.uniform(
                vmin, vmax, size=arr.shape).astype(arr.dtype)

    def fill_normal(self, arr, mean=0.0, stddev=1.0, clip_to_sigma=None):
        with self._lock:
            sample = self._np.normal(mean, stddev, size=arr.shape)
            if clip_to_sigma is not None:
                lo = mean - clip_to_sigma * stddev
                hi = mean + clip_to_sigma * stddev
                sample = numpy.clip(sample, lo, hi)
            arr[...] = sample.astype(arr.dtype)

    def shuffle(self, arr):
        with self._lock:
            self._np.shuffle(arr)

    def permutation(self, x):
        with self._lock:
            return self._np.permutation(x)

    def __getstate__(self):
        return {"key": self.key, "seed": self._seed,
                "np_state": self._np.bit_generator.state}

    def __setstate__(self, state):
        self.key = state["key"]
        self._lock = threading.Lock()
        self._seed = state["seed"]
        self._np = numpy.random.Generator(numpy.random.Philox(self._seed))
        self._np.bit_generator.state = state["np_state"]


_registry = {}
_registry_lock = threading.Lock()


def get(key="default"):
    """Return the process-wide :class:`RandomGenerator` named ``key``."""
    with _registry_lock:
        rng = _registry.get(key)
        if rng is None:
            rng = RandomGenerator(key)
            _registry[key] = rng
        return rng
