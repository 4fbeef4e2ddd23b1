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
``_matmul_kernel``); on CPU tensors it runs the plain version
:func:`matmul_reference`.  Nothing falls back: a CUDA call builds and
launches the kernel or raises.  :func:`plan_matmul` picks one of the
kernel's four designs from the shape, the strides, the dtype, ``bk``
and the card's SM count (its rule is in its docstring), and
``matmul.paths`` counts the calls each design served:

- ``split_k``: tall, thin products on the bf16 tensor cores (mma.sync),
  K split across blocks in whole K-tiles when the output tiles are too
  few for the card, f32 split into bf16 hi/lo in registers;
- ``tma_wgmma``: large bf16 products, and f32 at level 0, through TMA
  and wgmma on K-major bf16 planes of a 16-byte pitch (the kernel packs
  them first: 3001-wide rows cannot be described to TMA as they are);
- ``simt``: f32 at levels 1 and 2, register-tiled 128 x 128;
- ``general``: the rest (K below one 64-deep step, a ``bk`` that is not
  a multiple of 64), operands read through any strides.

Split-K folds each split's K-tiles as above and the splits in split
order by the same rule, so results differ from an unsplit run only by
that association (within the tolerances below) and never between two
calls.

``blocks`` = (bm, bn, bk): only ``bk`` changes the result (the K-tile of
the fold); the kernel's output tiles are its own, so ``bm`` and ``bn``
have no effect.  ``blocks=None`` takes ``_DEFAULT_BLOCKS``.
"""

import ctypes
import time

import numpy
import torch

from veles_tpu_torch import graphs
from veles_tpu_torch.ops import common as _common
from veles_tpu_torch.ops.common import ceil_mult

__all__ = ["matmul", "matmul_reference", "matmul_benchmark", "plan_matmul",
           "MATMUL_KERNEL_VERSION", "PATHS"]

_DEFAULT_BLOCKS = (512, 512, 512)

#: the JAX package's version of the kernel's algorithm (v2 = bf16x3
#: level-0 float32 path), which this kernel computes
MATMUL_KERNEL_VERSION = 2

#: dtype codes of csrc/matmul.cu
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the kernel's designs, by their codes in csrc/matmul.cu
PATHS = ("general", "split_k", "tma_wgmma", "simt")
#: the fast paths' K granule: ``bk`` must be a multiple of it, so that
#: their K-steps (32, 64 and 16 deep) never straddle a K-tile
STEP = 64
#: each fast path's output tile and the blocks it keeps on one SM
_TILES = {"split_k": (32, 128), "tma_wgmma": (128, 128),
          "simt": (128, 128)}
_RESIDENT = {"split_k": 3, "tma_wgmma": 1, "simt": 1}


def _loads_as_is(row_stride, unit_stride, ptr, esize):
    """Rows of unit stride, a 16-byte pitch and a 16-byte aligned
    start: what 16-byte cp.async loads take without a packed copy."""
    return unit_stride == 1 and (row_stride * esize) % 16 == 0 and \
        ptr % 16 == 0


def plan_matmul(m, k, n, bk, precision_level, dtype, a_strides, b_strides,
                a_ptr=0, b_ptr=0, sm_count=132):
    """Which design of csrc/matmul.cu serves one (m, k) @ (k, n) call,
    with which K split, packed copies and workspace.

    Rule:

    1. ``general`` when K < 64 (below one step) or ``bk`` is not a
       multiple of 64 (a fast path's step would straddle a K-tile).
    2. ``simt`` for f32 at levels 1 and 2: A is always packed transposed
       (K, ceil_mult(m, 4)); B is packed (K, ceil_mult(n, 4)) unless its
       rows already load as they are (unit stride, 16-byte pitch and
       start).
    3. ``split_k`` when min(m, n) <= 64 (tall, thin, memory-bound): an
       operand whose rows do not load as they are (a transposed view, a
       pitch of 3001 f32) is packed with a 16-byte pitch.
    4. ``tma_wgmma`` otherwise (bf16, or f32 at level 0): both operands
       packed into K-major bf16 planes of pitch ceil_mult(K, 8) (16
       bytes), A as (m, K) and B transposed as (n, K), hi and lo for f32.
       TMA never sees an operand's own strides.

    Split-K (every design but ``general``): when the output tiles are
    fewer than the blocks the card holds at once (``_RESIDENT`` a SM x
    ``sm_count``), K-tiles are shared among ``min(K-tiles, slots //
    tiles)`` splits by :func:`~veles_tpu_torch.ops.common.split_ranges`;
    the workspace holds each split's acc (and comp at levels 1 and 2) as
    f32.

    ``a_strides`` / ``b_strides`` are element strides (row, column);
    ``a_ptr`` / ``b_ptr`` the data addresses.  Returns a dict."""
    ktiles = -(-k // bk) if k else 0
    plan = {"path": "general", "splits": 1, "pitch_a": 0, "pitch_b": 0,
            "plane_bytes": 0, "workspace_floats": 0, "ktiles": ktiles,
            "tiles": 0, "blocks": 0}
    if k < STEP or bk % STEP:
        return plan
    esize = 4 if dtype == torch.float32 else 2
    (sam, sak), (sbk, sbn) = a_strides, b_strides
    if dtype == torch.float32 and precision_level:
        path = "simt"
        pitch_a = ceil_mult(m, 4)
        pitch_b = 0 if _loads_as_is(sbk, sbn, b_ptr, 4) else ceil_mult(n, 4)
        plane_bytes = 4 * k * (pitch_a + pitch_b)
    elif min(m, n) <= 64:
        path = "split_k"
        per_chunk = 16 // esize
        pitch_a = 0 if _loads_as_is(sam, sak, a_ptr, esize) else \
            ceil_mult(k, per_chunk)
        pitch_b = 0 if _loads_as_is(sbk, sbn, b_ptr, esize) else \
            ceil_mult(n, per_chunk)
        plane_bytes = esize * (m * pitch_a + k * pitch_b)
    else:
        path = "tma_wgmma"
        pitch_a = pitch_b = ceil_mult(k, 8)
        planes = 2 if dtype == torch.float32 else 1
        plane_bytes = 2 * planes * (m + n) * pitch_a
    bm, bn = _TILES[path]
    tiles = -(-m // bm) * -(-n // bn)
    slots = _RESIDENT[path] * sm_count
    splits = max(1, min(ktiles, slots // tiles)) if tiles < slots else 1
    plan.update(path=path, splits=splits, pitch_a=pitch_a, pitch_b=pitch_b,
                plane_bytes=plane_bytes, tiles=tiles, blocks=tiles * splits,
                workspace_floats=(splits * (2 if precision_level else 1) *
                                  m * n if splits > 1 else 0))
    return plan


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


def _kernel_function():
    from veles_tpu_torch.ops.common import kernel_function, load_kernels
    if not load_kernels().veles_matmul_tma_available():
        raise RuntimeError("matmul: the CUDA driver offers no "
                           "cuTensorMapEncodeTiled (TMA needs it)")
    return kernel_function(
        "veles_matmul",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7 +
        [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2 +
        [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _launch(a, b, m, k, n, bk, precision_level, out_dtype):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            sm_count)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = _kernel_function()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    plan = plan_matmul(m, k, n, bk, precision_level, a.dtype, a.stride(),
                       b.stride(), a.data_ptr(), b.data_ptr(),
                       sm_count(a.device))
    ws = planes = None
    if plan["workspace_floats"]:
        ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                         device=a.device)
    if plan["plane_bytes"]:
        planes = torch.empty(plan["plane_bytes"], dtype=torch.uint8,
                             device=a.device)
    code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
              a.stride(0), a.stride(1), b.stride(0), b.stride(1), bk,
              precision_level, _IN_CODES[a.dtype], _OUT_CODES[out_dtype],
              PATHS.index(plan["path"]), plan["splits"],
              None if ws is None else ws.data_ptr(),
              None if planes is None else planes.data_ptr(),
              plan["pitch_a"], plan["pitch_b"], a.device.index,
              current_stream(a.device))
    check_launch(code, "matmul")
    matmul.launches += 1
    matmul.paths[plan["path"]] += 1
    return out


def matmul(a, b, precision_level=0, blocks=None, out_dtype=None):
    """``a @ b``: (M, K) @ (K, N) -> (M, N) of ``out_dtype`` (default:
    ``a.dtype``), float32 or bfloat16 operands of one dtype.

    ``precision_level`` trades digits for speed: 0 (bf16x3 for float32
    operands), 1 (true float32 products, Kahan across K-tiles), 2 (adds
    Neumaier compensation).  Zero-size dimensions give zeros.  A CUDA
    call launches the kernel and adds one to ``matmul.launches`` and to
    ``matmul.paths`` under the design that served it (a zero-size
    dimension launches nothing); a CPU call runs
    :func:`matmul_reference`.  Anything else raises.  With
    ``ops.common.DEBUG_NONFINITE`` on, a non-finite output raises
    ``FloatingPointError`` with per-operand statistics."""
    m, k, n, bk, out_dtype = _prepare(a, b, precision_level, blocks,
                                      out_dtype)
    if a.device.type == "cpu":
        out = matmul_reference(a, b, precision_level, blocks, out_dtype)
    elif a.device.type == "cuda":
        out = _launch(a, b, m, k, n, bk, precision_level, out_dtype)
    else:
        raise ValueError("matmul runs on CUDA or CPU tensors, got %s"
                         % a.device)
    if _common.DEBUG_NONFINITE:
        _common.debug_check_finite("matmul", [("output", out)],
                                   [("lhs", a), ("rhs", b)],
                                   precision_level)
    return out


_launch.fn = None

#: kernel launches since the last reset (a plain counter: the smoke run
#: zeroes it before driving the ops path and reads it after)
matmul.launches = 0
#: the same calls by the design that served them (``PATHS``)
matmul.paths = dict.fromkeys(PATHS, 0)
#: a captured graph's replays advance the counters too
graphs.register_counters(matmul)


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
