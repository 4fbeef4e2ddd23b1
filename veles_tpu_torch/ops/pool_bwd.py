"""Max-pool backward: route each window's cotangent to its first max.

Counterpart of ``veles_tpu/ops/pool_bwd.py``.  :func:`max_pool_bwd`
takes the forward input x, the forward output y (the window maxima: no
recompute) and the cotangent dy, and returns dx.  Each window's
cotangent goes to the first tap, in row-major (kh, kw) window order,
whose input equals the window's max (the tie-break of XLA's
select-and-scatter); ceil-mode windows see -inf past the bottom and
right edges.  On CUDA tensors it launches the hand-written Hopper
kernel ``veles_tpu_torch/csrc/pool_bwd.cu`` (which replaces the Pallas
kernel ``_pool_bwd_kernel``); on CPU tensors it runs the plain version
:func:`max_pool_bwd_reference`, which follows the TPU kernel's
formulation step by step.  Nothing falls back: a CUDA call builds and
launches the kernel or raises.

:func:`plan_pool_bwd` picks the kernel's design per call from the
geometry alone: ``cells`` where windows are no wider than their stride
(each input in at most one window: one pass over the windows, 16-byte
channel vectors), ``overlap`` otherwise (one thread per input element,
its covering windows in the TPU kernel's tap order).
``max_pool_bwd.paths`` counts the calls each design served.  A call
consults the schedule cache (``veles_tpu_torch.tune``, family
``pool_bwd``) for a tuned design and block width first, on either
device; an explicit ``schedule`` skips the consult.  Routing is exact
under every schedule: a tuned one never changes a result.

Overlapping windows add their cotangents in the TPU kernel's tap
order, so the sums round alike; routing is exact.  The kernel is f32
only.  The JAX package's VMEM-budget fallback has no counterpart.

:func:`max_pool` is the pooling forward of ``models/pooling.py`` as a
``torch.autograd.Function`` that saves (x, y), as the JAX custom VJP
keeps its residuals, with :func:`max_pool_bwd` as its backward.
"""

import ctypes

import torch
import torch.nn.functional as F

from veles_tpu_torch import graphs
from veles_tpu_torch.ops import common as _common

__all__ = ["max_pool_bwd", "max_pool_bwd_reference", "max_pool",
           "plan_pool_bwd", "PATHS"]

#: the kernel's designs, in the order of csrc/pool_bwd.cu's ``Design``
PATHS = ("cells", "overlap")
#: most channel lanes along a block's x axis: a warp's 32 threads on
#: 32 neighbouring channel groups
_MAX_LANES_X = 32


def _check(x, y, dy, window, sliding):
    from veles_tpu_torch.models.pooling import _out_len
    if x.ndim != 4 or y.ndim != 4:
        raise ValueError("max_pool_bwd expects NHWC x and y, got %s, %s"
                         % (tuple(x.shape), tuple(y.shape)))
    ky, kx = (int(k) for k in window)
    sx, sy = (int(s) for s in sliding)
    n, h, w_sp, c = x.shape
    want = (n, _out_len(h, ky, sy), _out_len(w_sp, kx, sx), c)
    if tuple(y.shape) != want or tuple(dy.shape) != want:
        raise ValueError("y %s / dy %s do not match x %s pooled by %s / "
                         "%s (expected %s)" % (
                             tuple(y.shape), tuple(dy.shape),
                             tuple(x.shape), window, sliding, want))
    if not (x.device == y.device == dy.device):
        raise ValueError("operands on different devices: %s, %s, %s"
                         % (x.device, y.device, dy.device))
    return ky, kx, sy, sx


def max_pool_bwd_reference(x, y, dy, *, window, sliding):
    """The plain PyTorch version, step for step the TPU kernel's:
    -inf-padded x; for each tap in row-major order, select where the
    tap equals y and no earlier tap did, and add the selected
    cotangents into an f32 accumulator at the tap's strided place."""
    ky, kx, sy, sx = _check(x, y, dy, window, sliding)
    n, h, w_sp, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    span_h, span_w = (oh - 1) * sy + 1, (ow - 1) * sx + 1
    need_h, need_w = span_h - 1 + ky, span_w - 1 + kx
    xp = F.pad(x, (0, 0, 0, max(0, need_w - w_sp), 0,
                   max(0, need_h - h)), value=float("-inf"))
    dyf = dy.to(torch.float32)
    matched = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
    acc = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    for kh in range(ky):
        for kw in range(kx):
            window_rows = (slice(None), slice(kh, kh + span_h, sy),
                           slice(kw, kw + span_w, sx))
            sel = (xp[window_rows] == y) & ~matched
            matched |= sel
            acc[window_rows] += torch.where(sel, dyf, 0.0)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    rows, cols = min(h, acc.shape[1]), min(w_sp, acc.shape[2])
    out[:, :rows, :cols] = acc[:, :rows, :cols]
    return out.to(x.dtype)


def plan_pool_bwd(window, sliding, c, pointers=(), schedule=None):
    """Which design of csrc/pool_bwd.cu serves one call, and its block.

    ``window`` = (ky, kx), ``sliding`` = (sx, sy), ``c`` the channels,
    ``pointers`` the data addresses of x, y, dy and dx.  Returns a dict:
    ``design`` ("cells" where kx <= sx and ky <= sy, so that each input
    lies in at most one window; "overlap" otherwise), ``vec`` (4
    channels a thread where C % 4 == 0 and every pointer is 16-byte
    aligned, else 1) and ``lanes_x`` (channel lanes along a block's x
    axis: the next power of two of C / vec, at most 32; the block's
    other 256 / lanes_x threads take columns).  ``schedule``: a
    validated tuned ``{"design", "lanes_x"}`` (``veles_tpu_torch.tune``),
    which replaces the rule's design and lanes; the dict carries it
    under ``"schedule"`` (None: the rule's)."""
    ky, kx = (int(k) for k in window)
    sx, sy = (int(s) for s in sliding)
    design = "cells" if kx <= sx and ky <= sy else "overlap"
    vec = 4 if c % 4 == 0 and all(p % 16 == 0 for p in pointers) else 1
    lanes = max(1, c // vec)
    lanes_x = 1
    while lanes_x < min(lanes, _MAX_LANES_X):
        lanes_x *= 2
    if schedule is not None:
        design, lanes_x = schedule["design"], schedule["lanes_x"]
    return {"design": design, "vec": vec, "lanes_x": lanes_x,
            "schedule": schedule}


def _launch(x, y, dy, ky, kx, sy, sx, schedule=None):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_max_pool_bwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 +
            [ctypes.c_int] * 8 + [ctypes.c_void_p])
    n, h, w_sp, c = x.shape
    dx = torch.empty_like(x)
    plan = plan_pool_bwd((ky, kx), (sx, sy), c,
                         [t.data_ptr() for t in (x, y, dy, dx)], schedule)
    stream = current_stream(x.device)
    code = fn(x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
              n, h, w_sp, c, y.shape[1], y.shape[2], ky, kx, sy, sx,
              PATHS.index(plan["design"]), plan["vec"], plan["lanes_x"],
              x.device.index, stream)
    check_launch(code, "max_pool_bwd")
    max_pool_bwd.launches += 1
    max_pool_bwd.paths[plan["design"]] += 1
    max_pool_bwd.last_plan = plan
    _common.note_plan("pool_bwd", plan)
    return dx


_launch.fn = None


def tuned_schedule(x, y, ky, kx, sy, sx):
    """The schedule cache's validated ``{"design", "lanes_x"}`` for one
    call, or None (the static plan).  Host-only and memoized
    (``tune.cache.consult``)."""
    if not x.shape[3]:
        return None
    x_shape, out_hw = tuple(x.shape), (int(y.shape[1]), int(y.shape[2]))
    dtype = str(x.dtype)[6:]
    from veles_tpu_torch.tune import cache, spec
    return cache.consult(
        "pool_bwd", (x_shape, out_hw, ky, kx, sy, sx, dtype), x.device,
        lambda: spec.pool_bwd_spec(x_shape, out_hw, (ky, kx), (sx, sy),
                                   dtype))


def max_pool_bwd(x, y, dy, *, window, sliding, schedule=None):
    """dx (x's shape and dtype) of max pooling: x (N, H, W, C) the
    forward input, y (N, OH, OW, C) the forward output, dy its
    cotangent; ``window`` = (ky, kx), ``sliding`` = (sx, sy).

    A CUDA call launches the kernel and adds one to
    ``max_pool_bwd.launches`` and to ``max_pool_bwd.paths`` under the
    design :func:`plan_pool_bwd` chose; a CPU call runs
    :func:`max_pool_bwd_reference`.  Anything else raises.
    ``schedule``: the kernel's ``{"design", "lanes_x"}``; None consults
    the schedule cache (before the call branches on the device)."""
    ky, kx, sy, sx = _check(x, y, dy, window, sliding)
    if schedule is None:
        schedule = tuned_schedule(x, y, ky, kx, sy, sx)
    if x.device.type == "cpu":
        return max_pool_bwd_reference(x, y, dy, window=window,
                                      sliding=sliding)
    if x.device.type != "cuda":
        raise ValueError("max_pool_bwd runs on CUDA or CPU tensors, got "
                         "%s" % x.device)
    if not (x.dtype == y.dtype == torch.float32):
        raise TypeError("the max_pool_bwd kernel takes float32 x and y, "
                        "got %s, %s" % (x.dtype, y.dtype))
    return _launch(x.contiguous(), y.contiguous(),
                   dy.to(torch.float32).contiguous(), ky, kx, sy, sx,
                   schedule)


#: kernel launches since the last reset (a plain counter: the smoke
#: run zeroes it before driving the train path and reads it after)
max_pool_bwd.launches = 0
#: the same launches by the design that served them (``PATHS``)
max_pool_bwd.paths = dict.fromkeys(PATHS, 0)
#: the plan of the last launch (its ``schedule`` None under the rule)
max_pool_bwd.last_plan = None
#: a captured graph's replays advance the counters too
graphs.register_counters(max_pool_bwd)


class _MaxPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, window, sliding):
        from veles_tpu_torch.models.pooling import _pool
        y = _pool(x, window, sliding, float("-inf"), F.max_pool2d)
        ctx.save_for_backward(x, y)
        ctx.config = (window, sliding)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        window, sliding = ctx.config
        return max_pool_bwd(x, y, dy, window=window,
                            sliding=sliding), None, None


def max_pool(x, *, window, sliding):
    """Max pooling (NHWC, ceil mode) with :func:`max_pool_bwd` as its
    backward.  Where x needs no gradient (inference), this is the plain
    forward."""
    window = (int(window[0]), int(window[1]))
    sliding = (int(sliding[0]), int(sliding[1]))
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool.apply(x, window, sliding)
    from veles_tpu_torch.models.pooling import _pool
    return _pool(x, window, sliding, float("-inf"), F.max_pool2d)
