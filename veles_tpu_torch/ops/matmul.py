"""Tiled matrix product with precision levels 0/1/2.

Counterpart of ``veles_tpu/ops/matmul.py``.  :func:`matmul` computes
``a @ b`` for (M, K) and (K, N) float32 or bfloat16 operands with a
float32 accumulator over K-tiles of ``bk`` columns, ``bk`` being
``min(blocks[2], ceil_mult(K, 128))`` as in the JAX kernel.  Each
K-tile's partial product is folded into the accumulator by the level's
rule: level 0 adds it, level 1 adds it with Kahan compensation, level 2
with Neumaier compensation (added back at the store).  The partial
products: float32 operands at level 0 take the bf16x3 decomposition
(``a_hi b_hi + a_hi b_lo + a_lo b_hi``, each split rounded to nearest
even into bfloat16), ~5e-7 from a float64 product, but operands with
|x| >= the bfloat16 maximum (~3.39e38) or inf give non-finite output;
float32 operands at levels 1 and 2 take true float32 products; bfloat16
operands take one bfloat16 pass at every level.

On CUDA tensors :func:`matmul` launches the hand-written Hopper kernel
``veles_tpu_torch/csrc/matmul.cu`` (which replaces the Pallas kernel
``_matmul_kernel``): bf16 tensor cores for level 0 and for bfloat16
operands, SIMT float32 for levels 1 and 2.  On CPU tensors it runs the
plain version :func:`matmul_reference`.  Nothing falls back: a CUDA call
builds and launches the kernel or raises.  The kernel reads its
operands through their strides, so a transposed view costs no copy.

``blocks`` = (bm, bn, bk): only ``bk`` changes the result (the K-tile of
the fold); the kernel's output tile is its own (64 x 64), so ``bm`` and
``bn`` have no effect.  ``blocks=None`` takes ``_DEFAULT_BLOCKS``.
"""

import ctypes
import time

import numpy
import torch

from veles_tpu_torch.ops.common import ceil_mult

__all__ = ["matmul", "matmul_reference", "matmul_benchmark",
           "MATMUL_KERNEL_VERSION"]

_DEFAULT_BLOCKS = (512, 512, 512)

#: the JAX package's version of the kernel's algorithm (v2 = bf16x3
#: level-0 float32 path), which this kernel computes
MATMUL_KERNEL_VERSION = 2

#: dtype codes of csrc/matmul.cu
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _prepare(a, b, precision_level, blocks, out_dtype):
    """Checks; returns (m, k, n, bk, out_dtype)."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("matmul expects torch tensors")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("matmul expects 2-D operands")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError("shape mismatch: %s @ %s" %
                         (tuple(a.shape), tuple(b.shape)))
    if a.device != b.device:
        raise ValueError("operands on different devices: %s, %s"
                         % (a.device, b.device))
    if a.dtype not in _IN_CODES or b.dtype != a.dtype:
        raise TypeError("matmul takes float32 or bfloat16 operands of one "
                        "dtype, got %s @ %s" % (a.dtype, b.dtype))
    if precision_level not in (0, 1, 2):
        raise ValueError("precision_level must be 0, 1 or 2, got %r"
                         % (precision_level,))
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT_CODES:
        raise TypeError("matmul writes float32, bfloat16 or float16, got "
                        "%s" % out_dtype)
    bk = (blocks or _DEFAULT_BLOCKS)[2]
    if bk < 1:
        raise ValueError("blocks[2] (bk) must be positive, got %d" % bk)
    return m, k, n, min(bk, ceil_mult(k, 128)) if k else bk, out_dtype


def _partial_dot(a, b, precision_level):
    """One K-tile's product in float32: the JAX ``mxu_partial_dot``."""
    if a.dtype == torch.float32 and precision_level == 0:
        a_hi = a.to(torch.bfloat16).float()
        b_hi = b.to(torch.bfloat16).float()
        a_lo = (a - a_hi).to(torch.bfloat16).float()
        b_lo = (b - b_hi).to(torch.bfloat16).float()
        return (a_hi @ b_hi + a_hi @ b_lo) + a_lo @ b_hi
    return a.float() @ b.float()


def matmul_reference(a, b, precision_level=0, blocks=None,
                     out_dtype=None):
    """The plain PyTorch version: the same K-tiles and the same fold,
    each K-tile's product through ``torch.matmul`` in float32."""
    m, k, n, bk, out_dtype = _prepare(a, b, precision_level, blocks,
                                      out_dtype)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return acc.to(out_dtype)
    comp = torch.zeros_like(acc)
    for k0 in range(0, k, bk):
        partial = _partial_dot(a[:, k0:k0 + bk], b[k0:k0 + bk],
                               precision_level)
        if precision_level == 0:
            acc = acc + partial
        elif precision_level == 1:
            y = partial - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        else:
            t = acc + partial
            big = acc.abs() >= partial.abs()
            comp = comp + torch.where(big, (acc - t) + partial,
                                      (partial - t) + acc)
            acc = t
    if precision_level == 2:
        acc = acc + comp
    return acc.to(out_dtype)


def _launch(a, b, m, k, n, bk, precision_level, out_dtype):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_matmul",
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7 +
            [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
              a.stride(0), a.stride(1), b.stride(0), b.stride(1), bk,
              precision_level, _IN_CODES[a.dtype], _OUT_CODES[out_dtype],
              a.device.index, current_stream(a.device))
    check_launch(code, "matmul")
    matmul.launches += 1
    return out


def matmul(a, b, precision_level=0, blocks=None, out_dtype=None):
    """``a @ b``: (M, K) @ (K, N) -> (M, N) of ``out_dtype`` (default:
    ``a.dtype``), float32 or bfloat16 operands of one dtype.

    ``precision_level`` trades digits for speed: 0 (bf16x3 for float32
    operands), 1 (true float32 products, Kahan across K-tiles), 2 (adds
    Neumaier compensation).  Zero-size dimensions give zeros.  A CUDA
    call launches the kernel and adds one to ``matmul.launches`` (a
    zero-size dimension launches nothing); a CPU call runs
    :func:`matmul_reference`.  Anything else raises."""
    m, k, n, bk, out_dtype = _prepare(a, b, precision_level, blocks,
                                      out_dtype)
    if a.device.type == "cpu":
        return matmul_reference(a, b, precision_level, blocks, out_dtype)
    if a.device.type != "cuda":
        raise ValueError("matmul runs on CUDA or CPU tensors, got %s"
                         % a.device)
    return _launch(a, b, m, k, n, bk, precision_level, out_dtype)


_launch.fn = None

#: kernel launches since the last reset (a plain counter: the smoke run
#: zeroes it before driving the ops path and reads it after)
matmul.launches = 0


def _chain_slope(mm, a, repeats):
    """One (chain(repeats + 1) - chain(1)) / repeats slope sample over
    dependent ``acc = mm(acc)`` chains, each ended by a scalar fetch."""

    def chain(n):
        start = time.perf_counter()
        acc = a
        for _ in range(n):
            acc = mm(acc)
        acc[0, 0].float().item()
        return time.perf_counter() - start

    return (chain(repeats + 1) - chain(1)) / repeats


def matmul_benchmark(size=3001, dtype=torch.float32, precision_level=0,
                     repeats=10, blocks=None, samples=1, device=None):
    """Seconds per ``size``-cubed self-multiply through :func:`matmul`:
    the slope between a 1-long and an (repeats + 1)-long dependent chain,
    each ended by a scalar fetch, so the per-call host cost and the
    fetch cancel.  With ``samples`` > 1 the median of that many slopes.
    The operand is ``(RandomState(13).rand(size, size) - 0.5) * 0.01``.

    ``device`` is a :class:`veles_tpu_torch.backends.Device`; ``None``
    means ``Device()``, the card.  Returns the RAW slope, which may be
    zero or negative when noise swamps the chain delta: callers validate
    it and never clamp it."""
    if device is None:
        from veles_tpu_torch.backends import Device
        device = Device()
    host = (numpy.random.RandomState(13).rand(size, size) - 0.5) * 0.01
    a = device.put(host).to(dtype)

    def mm(x):
        return matmul(x, a, precision_level=precision_level, blocks=blocks)

    mm(a)[0, 0].float().item()  # warm-up (and the kernels' build)
    slopes = sorted(_chain_slope(mm, a, repeats) for _ in range(samples))
    mid = samples // 2
    return (slopes[mid] if samples % 2
            else (slopes[mid - 1] + slopes[mid]) / 2.0)
