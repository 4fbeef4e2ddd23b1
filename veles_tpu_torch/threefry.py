"""The threefry2x32 key stream of ``jax.random``, for the dropout masks.

The JAX package draws each dropout mask as ``jax.random.bernoulli(
fold_in(key, i), 1 - ratio, shape)`` (``veles_tpu/models/dropout.py``,
``veles_tpu/compiler.py``).  This module is the port's own copy of what
that takes from ``jax.random`` (``jax/_src/prng.py``, ``random.py``), so
that one seed gives the same masks, bit for bit, in both packages:

- :func:`key` is ``PRNGKey(seed)`` with x64 off: ``(0, seed & 0xffffffff)``;
- :func:`fold_in` is threefry2x32 of the key over the counter ``(0,
  data)``;
- :func:`split` is ``jax.random.split(k, num)`` under
  ``jax_threefry_partitionable``: key ``i`` is threefry2x32 of the key
  over the counter ``(0, i)``, the same hash as ``fold_in(k, i)``;
- :func:`random_bits` is ``jax.random.bits`` under
  ``jax_threefry_partitionable`` (on by default since JAX 0.5): the
  counters are each element's flat row-major index, split into its high
  and low 32-bit words, and the 32 bits are the two hash words xor-ed;
- :func:`uniform` keeps the top 23 bits as the mantissa of a float32 in
  [1, 2) and subtracts 1; :func:`bernoulli` compares it with ``p`` in
  float32.

A key is a pair of Python ints, or of int64 tensors holding uint32
words.  :func:`key` and :func:`fold_in` run on the host for int keys
(their inputs, the seed, the step and the layer index, are all known
there): deriving a key costs no launch and no sync.  A captured step
(``veles_tpu_torch/graphs.py``) reads its step key from a static device
buffer instead, as a pair of 0-d tensors, and folds the layer index in
on the device: the same integer arithmetic, so the same bits.  The bits are
computed where the mask lies, as integer torch ops on int64 tensors
holding uint32 values (adds and rotations masked to 32 bits): PyTorch's
uint32 lacks shifts on some backends.  A mask is some 160 elementwise
ops over its shape; ``jax.random`` is XLA code, not a Pallas kernel.
"""

import numpy
import torch

__all__ = ["key", "fold_in", "split", "threefry2x32", "random_bits",
           "uniform", "bernoulli"]

_MASK32 = 0xffffffff
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed):
    """``jax.random.PRNGKey(seed)`` with x64 off: (0, seed mod 2**32)."""
    return (0, int(seed) & _MASK32)


def _rotl(v, r):
    return ((v << r) & _MASK32) | (v >> (32 - r))


def threefry2x32(k, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under the key ``k``; works on Python ints and on int64
    tensors of uint32 values alike.  Returns the two output words."""
    ks = (k[0] & _MASK32, k[1] & _MASK32)
    ks = ks + (ks[0] ^ ks[1] ^ _PARITY,)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: a new key, on the host for an int
    key and int ``data``, where the key or ``data`` lies for tensors."""
    if not isinstance(data, torch.Tensor):
        data = int(data)
    return threefry2x32(k, 0, data & _MASK32)


def split(k, num=2):
    """``jax.random.split(k, num)`` for an int key: ``num`` new keys, a
    tuple of (int, int) pairs, on the host."""
    return tuple(threefry2x32(k, 0, i) for i in range(int(num)))


def random_bits(k, shape, device="cpu"):
    """``jax.random.bits(k, shape)`` (uint32) as an int64 tensor of
    uint32 values on ``device``."""
    shape = tuple(int(d) for d in shape)
    n = int(numpy.prod(shape, dtype=numpy.int64))
    count = torch.arange(n, dtype=torch.int64, device=device)
    bits0, bits1 = threefry2x32(k, count >> 32, count & _MASK32)
    return (bits0 ^ bits1).reshape(shape)


def uniform(k, shape, device="cpu"):
    """``jax.random.uniform(k, shape)``: float32 in [0, 1)."""
    bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k, p, shape, device="cpu"):
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p`` with ``p``
    rounded to float32 (a Python float is a weak float32 there).  The
    rounded ``p`` stays a host scalar: a tensor made from it on the card
    would be a copy from pageable memory, which waits for the stream."""
    return uniform(k, shape, device) < float(numpy.float32(p))
