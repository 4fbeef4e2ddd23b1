"""Int8 quantized matmul + conv forward.

Counterpart of ``veles_tpu/ops/matmul_int8.py``.  :func:`matmul_int8`
computes ``f32(a @ b) * scale + bias`` with int8 operands and an exact
int32 accumulator.  On CUDA tensors it launches the hand-written Hopper
kernel ``veles_tpu_torch/csrc/matmul_int8.cu`` (which replaces the
Pallas kernel ``_matmul_int8_kernel``); on CPU tensors it runs the plain
version :func:`matmul_int8_reference`.  Nothing falls back: a CUDA call
builds and launches the kernel or raises.

The kernel runs on the int8 tensor cores, whose 8-bit B operand is
K-major, and loads whole 16-byte chunks.  So it takes the weight as
:func:`kmajor_weight` gives it, ``(N, K)`` with K padded with zeros to
a multiple of 16 (exact in int32), and ``a`` padded to the same K.
:func:`matmul_int8` makes both copies on every call;
:func:`matmul_int8_kmajor` takes a weight made once, as the serving
engine does when it uploads the quantized model (``quant.forward.
with_kmajor_weights``).  :func:`plan_int8` is the pure-Python choice of
tile and K split that the kernel is launched with; a call consults the
schedule cache (``veles_tpu_torch.tune``, family ``matmul_int8``) for a
tuned tile and split first, on either device, and an explicit
``schedule`` skips the consult.  Integer sums are exact in any order, so
a tuned schedule never changes a result.

``conv2d_int8`` lowers the conv forward onto the same product: per-tap
strided slices of the zero-padded NHWC input, tap-major (dy, then dx)
and then Cin, stack into an im2col patch matrix that matches
``w.reshape(ky * kx * Cin, Cout)`` of the HWIO weights; a zero block
pads its K to a multiple of 16 (conv1_1's 27 becomes 32).

Numerics: integer accumulation is exact under any order (split-K
included: the planner keeps every int32 sum below 2**31 for int8
operands).  The kernel's epilogue is ``__fmaf_rn(float(acc), scale[j],
bias[j])``, one rounding; the plain version computes the same
expression in float64 and rounds once to float32, so the two agree bit
for bit when the float64 sum is exact (``scale = 1``, ``bias = 0``) and
to 1 ulp otherwise.
"""

import ctypes

import torch
import torch.nn.functional as F

from veles_tpu_torch import graphs
from veles_tpu_torch.ops import common as _common
from veles_tpu_torch.ops.common import ceil_mult

__all__ = ["matmul_int8", "matmul_int8_reference", "matmul_int8_kmajor",
           "kmajor_weight", "conv2d_int8", "plan_int8"]

#: (BM, BN) output tiles of csrc/matmul_int8.cu's configurations 0, 1, 2
INT8_TILES = ((128, 64), (128, 128), (32, 128))
#: K values (bytes) a stage of the kernel holds: the unit of its K split
INT8_STEP = 64
#: the kernel's K: whole 16-byte chunks
K_ALIGN = 16


def plan_int8(m, k, n, sm_count, schedule=None):
    """The tile and K split of one (m, k) @ (k, n) int8 product.

    Rule: the tile follows the layer (32 x 128 for at most 32 rows, the
    fc layers at small batch; 128 x 64 for N <= 64, conv1_x; 128 x 128
    otherwise).  When the output has fewer tiles than the card has SMs,
    K is split into ``ceil(2 * sm_count / tiles)`` ranges of whole
    64-byte K-steps (at most one a step), each summed into its own int32
    slice; a second pass adds the slices and applies the epilogue once.
    |a|, |b| <= 128 keeps every partial and the total below 2**31 while
    K * 128 * 128 is; a longer K raises.

    ``schedule``: a validated tuned ``{"config", "splits"}``
    (``veles_tpu_torch.tune``), which replaces the rule's tile and split
    (the split at most one a K-step).  The dict carries it under
    ``"schedule"`` (None: the rule's)."""
    if k * 128 * 128 > 2 ** 31 - 1:
        raise ValueError("matmul_int8: K = %d may overflow the int32 sum"
                         % k)
    k_padded = ceil_mult(k, K_ALIGN)
    config = 2 if m <= 32 else (0 if n <= 64 else 1)
    bm, bn = INT8_TILES[config]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k_padded // INT8_STEP)
    splits = 1
    if tiles < sm_count:
        splits = max(1, min(steps, -(-2 * sm_count // tiles)))
    if schedule is not None:
        config = schedule["config"]
        bm, bn = INT8_TILES[config]
        tiles = -(-m // bm) * -(-n // bn)
        splits = max(1, min(steps, schedule["splits"]))
    return {"config": config, "tile": (bm, bn), "k_padded": k_padded,
            "steps": steps, "splits": splits, "tiles": tiles,
            "blocks": tiles * splits, "schedule": schedule,
            "workspace_ints": splits * m * n if splits > 1 else 0}


def _epilogue_args(n, scale, bias, device):
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if scale.ndim == 0:
        scale = scale.expand(n)
    if tuple(scale.shape) != (n,):
        raise ValueError("scale must be scalar or (N,)=(%d,), got %s"
                         % (n, tuple(scale.shape)))
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.float32, device=device)
    else:
        bias = torch.as_tensor(bias, dtype=torch.float32, device=device)
        if tuple(bias.shape) != (n,):
            raise ValueError("bias must be (N,)=(%d,), got %s"
                             % (n, tuple(bias.shape)))
    return scale.contiguous(), bias.contiguous()


def _check_operands(a, b):
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("matmul_int8 expects torch tensors")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("matmul_int8 expects int8 operands, got %s @ %s"
                        % (a.dtype, b.dtype))
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("matmul_int8 expects 2-D operands")
    if a.shape[1] != b.shape[0]:
        raise ValueError("shape mismatch: %s @ %s" %
                         (tuple(a.shape), tuple(b.shape)))
    if a.device != b.device:
        raise ValueError("operands on different devices: %s, %s"
                         % (a.device, b.device))


def matmul_int8_reference(a, b, scale, bias=None,
                          out_dtype=torch.float32):
    """The plain PyTorch version: the int8 product in float64 (exact,
    since ``|acc| <= 127**2 * K < 2**53``), ``float(acc)`` rounded to
    float32 as the kernel's int-to-float conversion does, then the
    epilogue in float64, rounded once to float32.  ``torch.matmul`` on
    int8 tensors would give a wrapped int8 result."""
    _check_operands(a, b)
    n = b.shape[1]
    scale, bias = _epilogue_args(n, scale, bias, a.device)
    acc = a.to(torch.float64) @ b.to(torch.float64)
    acc = acc.to(torch.float32).to(torch.float64)
    total = acc * scale.to(torch.float64) + bias.to(torch.float64)
    return total.to(torch.float32).to(out_dtype)


def kmajor_weight(w):
    """A (K, N) int8 weight, or an HWIO conv weight (read as its (ky *
    kx * Cin, Cout) reshape), as the kernel reads it: (N, Kp) contiguous,
    K padded with zeros to Kp, a multiple of 16."""
    w = w.reshape(-1, w.shape[-1])
    k = w.shape[0]
    return F.pad(w.t(), (0, ceil_mult(k, K_ALIGN) - k)).contiguous()


def _pad_k(a, k_padded):
    k = a.shape[1]
    return a if k == k_padded else F.pad(a, (0, k_padded - k))


def _aligned(x):
    """``x``, or a copy when its data does not start on 16 bytes (a view
    at an odd offset), as the kernel's 16-byte loads need."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(a, w_t, scale, bias, schedule=None):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function, sm_count)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_matmul_int8",
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 +
            [ctypes.c_int] * 3 + [ctypes.c_void_p])
    a, w_t = _aligned(a), _aligned(w_t)   # alive until the launch
    m, k = a.shape
    n = w_t.shape[0]
    plan = plan_int8(m, k, n, sm_count(a.device), schedule)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["workspace_ints"], dtype=torch.int32,
                         device=a.device)
    code = fn(a.data_ptr(), w_t.data_ptr(),
              scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
              None if ws is None else ws.data_ptr(), m, n, k,
              plan["config"], plan["splits"], a.device.index,
              current_stream(a.device))
    check_launch(code, "matmul_int8")
    matmul_int8.launches += 1
    matmul_int8.last_plan = plan
    _common.note_plan("matmul_int8", plan)
    return out


_launch.fn = None


def tuned_schedule(m, k, n, device):
    """The schedule cache's validated ``{"config", "splits"}`` for one
    (m, k) @ (k, n) product, or None (the static plan).  Host-only and
    memoized (``tune.cache.consult``)."""
    if not (m and k and n):
        return None
    from veles_tpu_torch.tune import cache, spec
    return cache.consult("matmul_int8", (m, k, n), device,
                         lambda: spec.matmul_int8_spec(m, k, n))


def matmul_int8_kmajor(a, w_t, scale, bias=None, out_dtype=torch.float32,
                       schedule=None):
    """:func:`matmul_int8` with the weight already K-major: ``w_t`` as
    :func:`kmajor_weight` gives it, (N, Kp); ``a`` (M, K) with K <= Kp
    and ``ceil_mult(K, 16) == Kp`` (padded here when shorter).  Returns
    (M, N) ``out_dtype``.  The schedule cache is consulted for the
    (M, K, N) product unless ``schedule`` is given.  A CUDA call
    launches the kernel and adds one to ``matmul_int8.launches``; a CPU
    call runs the plain version."""
    if not (isinstance(a, torch.Tensor) and isinstance(w_t, torch.Tensor)):
        raise TypeError("matmul_int8 expects torch tensors")
    if a.dtype != torch.int8 or w_t.dtype != torch.int8:
        raise TypeError("matmul_int8 expects int8 operands, got %s @ %s"
                        % (a.dtype, w_t.dtype))
    if a.ndim != 2 or w_t.ndim != 2:
        raise ValueError("matmul_int8 expects 2-D operands")
    k_padded = w_t.shape[1]
    if k_padded % K_ALIGN or ceil_mult(a.shape[1], K_ALIGN) != k_padded:
        raise ValueError("K-major weight %s does not fit %s" %
                         (tuple(w_t.shape), tuple(a.shape)))
    if a.device != w_t.device:
        raise ValueError("operands on different devices: %s, %s"
                         % (a.device, w_t.device))
    if not (a.is_contiguous() and w_t.is_contiguous()):
        raise ValueError("matmul_int8 expects contiguous operands")
    n = w_t.shape[0]
    if schedule is None:
        schedule = tuned_schedule(a.shape[0], a.shape[1], n, a.device)
    scale, bias = _epilogue_args(n, scale, bias, a.device)
    if a.device.type == "cpu":
        return matmul_int8_reference(a, w_t[:, :a.shape[1]].t(), scale,
                                     bias, out_dtype)
    if a.device.type != "cuda":
        raise ValueError("matmul_int8 runs on CUDA or CPU tensors, "
                         "got %s" % a.device)
    m = a.shape[0]
    if m == 0 or n == 0 or a.shape[1] == 0:
        return bias[None, :].expand(m, n).to(out_dtype).contiguous()
    out = _launch(_pad_k(a, k_padded), w_t, scale, bias, schedule)
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def matmul_int8(a, b, scale, bias=None, out_dtype=torch.float32,
                schedule=None):
    """``dequant(a @ b)``: a (M, K) int8, b (K, N) int8, both
    contiguous and on one device; ``scale`` a scalar or (N,) vector
    (activation scale x per-channel weight scale); ``bias`` an optional
    (N,) f32 vector added after the dequant.  Returns (M, N)
    ``out_dtype``.

    A CUDA call makes the K-major copy of ``b`` (:func:`kmajor_weight`),
    launches the kernel and adds one to ``matmul_int8.launches``; a CPU
    call runs :func:`matmul_int8_reference`.  Anything else raises.
    ``schedule``: as :func:`matmul_int8_kmajor` takes it."""
    _check_operands(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_int8 expects contiguous operands")
    n = b.shape[1]
    if schedule is None:
        schedule = tuned_schedule(a.shape[0], a.shape[1], n, a.device)
    scale, bias = _epilogue_args(n, scale, bias, a.device)
    if a.device.type == "cpu":
        return matmul_int8_reference(a, b, scale, bias, out_dtype)
    if a.device.type != "cuda":
        raise ValueError("matmul_int8 runs on CUDA or CPU tensors, "
                         "got %s" % a.device)
    return matmul_int8_kmajor(a, kmajor_weight(b), scale, bias, out_dtype,
                              schedule)


#: kernel launches since the last reset (a plain counter: the smoke
#: run zeroes it before driving the serve path and reads it after)
matmul_int8.launches = 0
#: the plan of the last launch (its ``schedule`` None under the rule)
matmul_int8.last_plan = None
#: a captured graph's replays advance the counters too
graphs.register_counters(matmul_int8)


def conv2d_int8(x, w, scale, bias=None, padding=(0, 0, 0, 0),
                sliding=(1, 1), out_dtype=torch.float32, w_kmajor=None):
    """Int8 conv forward through :func:`matmul_int8_kmajor`.

    x: (N, H, W, Cin) int8 (NHWC), w: (ky, kx, Cin, Cout) int8 (HWIO);
    ``padding`` = (left, top, right, bottom), ``sliding`` = (sx, sy) —
    the Conv layer's static config, verbatim; ``w_kmajor`` the weight
    as :func:`kmajor_weight` gives it, when the caller keeps one.
    Returns (N, OH, OW, Cout) in ``out_dtype``."""
    if x.ndim == 3:
        x = x[..., None]
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("conv2d_int8 expects int8 operands, got %s / %s"
                        % (x.dtype, w.dtype))
    n, h, w_sp, ci = x.shape
    ky, kx, ci2, cout = w.shape
    if ci != ci2:
        raise ValueError("channel mismatch: x %s vs w %s" %
                         (tuple(x.shape), tuple(w.shape)))
    left, top, right, bottom = padding
    sx, sy = sliding
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    oh = (h + top + bottom - ky) // sy + 1
    ow = (w_sp + left + right - kx) // sx + 1
    taps = []
    for dy in range(ky):
        for dx in range(kx):
            taps.append(xp[:, dy:dy + (oh - 1) * sy + 1:sy,
                           dx:dx + (ow - 1) * sx + 1:sx, :])
    k = ky * kx * ci
    if k % K_ALIGN:   # zero columns up to the kernel's K, exact in int32
        taps.append(x.new_zeros((n, oh, ow, ceil_mult(k, K_ALIGN) - k)))
    patches = torch.cat(taps, dim=-1)   # tap-major, then Cin
    patches = patches.reshape(n * oh * ow, -1)
    if w_kmajor is None:
        w_kmajor = kmajor_weight(w)
    z = matmul_int8_kmajor(patches, w_kmajor, scale, bias=bias,
                           out_dtype=out_dtype)
    return z.reshape(n, oh, ow, cout)
