"""Random number generation on the device.

Counterpart of ``veles_tpu/ops/random.py``: the reference's xorshift128+
and xorshift1024* generators (bit-exact against the numpy u64 oracles,
which are copied here), ``uniform_from_bits``, and
:func:`hardware_uniform`.

PyTorch has no uint64 arithmetic, so the port holds each u64 word in an
int64 tensor, where left shifts, adds and the 1024* multiply wrap modulo
2**64 as u64 arithmetic does and right shifts mask off the sign
extension.  States keep the JAX package's layouts, (2, 2, S) for
xorshift128+ and two (16, S) arrays for xorshift1024*, hi and lo 32-bit
halves, here as int64 tensors holding the uint32 values
(``veles_tpu_torch.convert.xorshift_state_from_jax`` / ``_to_jax``
carry a state across unchanged).  The generators run as plain torch ops
where the state's tensors lie (a numpy state goes to the card); JAX runs
them as ``lax.scan``, not as Pallas kernels.

:func:`hardware_uniform` replaces the Pallas kernel ``_hw_uniform_kernel``
(the TPU's hardware generator) with the hand-written Hopper kernel
``veles_tpu_torch/csrc/uniform.cu``: Philox4x32-10 keyed by the seed,
the top 24 bits of each word times 2**-24.  The TPU's bits cannot be
reproduced, so the contract is the JAX function's: deterministic per
seed, values in [0, 1) on the 2**-24 grid.  On CPU it runs the plain
version :func:`hardware_uniform_reference`, the same Philox on int64
tensors, bit-equal to the kernel.
"""

import ctypes

import numpy
import torch

from veles_tpu_torch import graphs

__all__ = ["xorshift128plus", "xorshift1024star", "uniform_from_bits",
           "hardware_uniform", "hardware_uniform_reference", "philox4x32",
           "numpy_xorshift128plus", "numpy_xorshift1024star"]

_MASK32 = 0xffffffff


# -- u64 words in int64 tensors --------------------------------------------

def _shr(x, k):
    """Logical right shift of u64 words held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _u32(x):
    """Tensor or array of uint32 values (uint32, or int32/int64 holding
    the bits) -> int64 tensor of values in [0, 2**32), where the tensor
    lies; an array goes to ``Device()``, the card."""
    if not isinstance(x, torch.Tensor):
        from veles_tpu_torch.backends import Device
        x = Device().put(numpy.asarray(x).astype(numpy.int64))
    return x.to(torch.int64) & _MASK32


def _join(hi, lo):
    return (hi << 32) | lo


def _split(words):
    return _shr(words, 32), words & _MASK32


# -- xorshift128+ ----------------------------------------------------------

def xorshift128plus(state, count):
    """Generate ``count`` u64 outputs per stream (the reference's
    constants 23/17/26).

    state: (2, 2, S) = (word, hi/lo, streams) uint32 values.  Returns
    (new_state, bits), int64 tensors of uint32 values: new_state (2, 2,
    S), bits (count, 2, S)."""
    state = _u32(state)
    x, y = _join(state[0, 0], state[0, 1]), _join(state[1, 0], state[1, 1])
    outs = []
    for _ in range(count):
        x = x ^ (x << 23)
        new = x ^ y ^ _shr(x, 17) ^ _shr(y, 26)
        outs.append(torch.stack(_split(new + y)))
        x, y = y, new
    new_state = torch.stack([torch.stack(_split(x)),
                             torch.stack(_split(y))])
    bits = torch.stack(outs) if outs else \
        torch.empty((0, 2) + tuple(state.shape[2:]), dtype=torch.int64,
                    device=state.device)
    return new_state, bits


def numpy_xorshift128plus(state, count):
    """u64 oracle with identical bitstream (host fallback)."""
    s = (state[:, 0].astype(numpy.uint64) << numpy.uint64(32)) | \
        state[:, 1].astype(numpy.uint64)
    outs = numpy.empty((count,) + s.shape[1:], dtype=numpy.uint64)
    with numpy.errstate(over="ignore"):
        for i in range(count):
            x, y = s[0], s[1]
            x = x ^ ((x << numpy.uint64(23)) & numpy.uint64(0xffffffffffffffff))
            new1 = x ^ y ^ (x >> numpy.uint64(17)) ^ (y >> numpy.uint64(26))
            outs[i] = (new1 + y) & numpy.uint64(0xffffffffffffffff)
            s = numpy.stack([y, new1])
    hi = (s >> numpy.uint64(32)).astype(numpy.uint32)
    lo = (s & numpy.uint64(0xffffffff)).astype(numpy.uint32)
    return numpy.stack([hi, lo], axis=1), outs


# -- xorshift1024* ---------------------------------------------------------

_XS1024_MULT = 1181783497276652981


def xorshift1024star(state_hi, state_lo, p, count):
    """state_hi / state_lo: (16, S) uint32 values; p: the position (0 to
    15); ``count`` outputs per stream.  Returns (state_hi, state_lo, p,
    bits): int64 tensors of uint32 values, p an int, bits (count, 2,
    S)."""
    s = _join(_u32(state_hi), _u32(state_lo)).clone()
    p = int(p)
    outs = []
    for _ in range(count):
        s0 = s[p]
        p = (p + 1) & 15
        s1 = s[p]
        s1 = s1 ^ (s1 << 31)
        new = s1 ^ s0 ^ _shr(s1, 11) ^ _shr(s0, 30)
        s[p] = new
        outs.append(torch.stack(_split(new * _XS1024_MULT)))
    hi, lo = _split(s)
    bits = torch.stack(outs) if outs else \
        torch.empty((0, 2) + tuple(s.shape[1:]), dtype=torch.int64,
                    device=s.device)
    return hi, lo, p, bits


def numpy_xorshift1024star(state, p, count):
    """u64 oracle: state uint64 (16, S)."""
    s = state.astype(numpy.uint64).copy()
    outs = numpy.empty((count,) + s.shape[1:], dtype=numpy.uint64)
    mask = numpy.uint64(0xffffffffffffffff)
    with numpy.errstate(over="ignore"):
        for i in range(count):
            s0 = s[p]
            p = (p + 1) & 15
            s1 = s[p]
            s1 = s1 ^ ((s1 << numpy.uint64(31)) & mask)
            new = s1 ^ s0 ^ (s1 >> numpy.uint64(11)) ^ \
                (s0 >> numpy.uint64(30))
            s[p] = new
            outs[i] = (new * numpy.uint64(_XS1024_MULT)) & mask
    return s, p, outs


# -- bits -> floats --------------------------------------------------------

def uniform_from_bits(hi_bits, vmin=0.0, vmax=1.0):
    """Map uint32 bits to float32 in [vmin, vmax) through the top 24 bits
    (exact in float32).  vmin and vmax are float32, as in JAX, and
    ``vmin + u * (vmax - vmin)`` is rounded once, as the fused
    multiply-add XLA makes of it: the product of two 24-bit values is
    exact in float64."""
    bits = _u32(hi_bits)
    u = (bits >> 8).to(torch.float64) * (1.0 / (1 << 24))
    vmin = torch.tensor(vmin, dtype=torch.float32, device=bits.device)
    span = torch.tensor(vmax, dtype=torch.float32, device=bits.device) - vmin
    return (vmin.double() + u * span.double()).to(torch.float32)


# -- hardware_uniform: Philox4x32-10 ---------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m):
    """(hi, lo) words of a * m for int64 tensors of uint32 values and a
    uint32 constant: the low word under int64 wrap-around, the high word
    from 16-bit limbs."""
    lo = (a * m) & _MASK32
    a0, a1 = a & 0xffff, a >> 16
    m0, m1 = m & 0xffff, m >> 16
    mid = a1 * m0 + a0 * m1 + ((a0 * m0) >> 16)
    return (a1 * m1 + (mid >> 16)) & _MASK32, lo


def philox4x32(counters, key):
    """Philox4x32-10 of ``counters``, an int64 tensor (..., 4) of uint32
    values, under ``key`` (k0, k1), two uint32 ints; returns the (..., 4)
    words."""
    c0, c1, c2, c3 = counters.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _key(seed):
    """The Philox key of a seed: the seed as int32, as the JAX kernel
    takes it (outside int32 it raises OverflowError, as JAX does), then
    its uint32 bits, and 0."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError("seed %d out of bounds for int32" % seed)
    return seed & _MASK32, 0


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(d) for d in shape)


def hardware_uniform_reference(seed, shape, device):
    """The plain PyTorch version: element 4i + j is word j of
    Philox4x32-10 of the counter (i mod 2**32, i >> 32, 0, 0) under the
    key (seed, 0), its top 24 bits times 2**-24.  ``device`` is a torch
    device."""
    shape = _shape(shape)
    n = int(numpy.prod(shape, dtype=numpy.int64))
    groups = -(-n // 4)
    i = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(i)
    words = philox4x32(torch.stack([i & _MASK32, i >> 32, zero, zero],
                                   dim=-1), _key(seed))
    top = (words.reshape(-1)[:n] >> 8).to(torch.float32)
    return (top * (1.0 / (1 << 24))).reshape(shape)


def _launch(seed, shape, device):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_uniform",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
             ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
    k0, k1 = _key(seed)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    code = fn(out.data_ptr(), out.numel(), k0, k1, device.index,
              current_stream(device))
    check_launch(code, "hardware_uniform")
    hardware_uniform.launches += 1
    return out


def hardware_uniform(seed, shape, device=None):
    """Uniform [0, 1) float32 of ``shape``, deterministic per ``seed``.

    ``device`` is a :class:`veles_tpu_torch.backends.Device`; ``None``
    means ``Device()``, the card.  There the kernel runs and adds one to
    ``hardware_uniform.launches``; ``Device(backend="cpu")`` runs
    :func:`hardware_uniform_reference`, which gives the same bits."""
    if device is None:
        from veles_tpu_torch.backends import Device
        device = Device()
    shape = _shape(shape)
    target = device.torch_device
    if target.type == "cpu":
        return hardware_uniform_reference(seed, shape, target)
    if target.type != "cuda":
        raise ValueError("hardware_uniform runs on CUDA or the CPU, got %s"
                         % target)
    return _launch(seed, shape, target)


_launch.fn = None

#: kernel launches since the last reset (a plain counter: the smoke run
#: zeroes it before driving the ops path and reads it after)
hardware_uniform.launches = 0
#: a captured graph's replays advance the counters too
graphs.register_counters(hardware_uniform)
