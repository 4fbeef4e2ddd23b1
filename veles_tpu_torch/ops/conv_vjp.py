"""The conv layer's backward: activation backward, wgrad and bias grad
in one kernel, dgrad as a transposed convolution.

Counterpart of ``veles_tpu/ops/conv_vjp.py``.  :func:`conv_wgrad`
computes, from the forward input x, the forward OUTPUT y and its
cotangent dy,

- ``err = act'(y, dy)``, the activation backward in closed form in
  terms of y (:data:`ACTIVATIONS`);
- ``grad_w[kh, kw, ci, co] = sum_p x_tap(kh, kw)[p, ci] * err[p, co]``;
- ``grad_b[co] = sum_p err[p, co]``.

On CUDA tensors it launches the hand-written Hopper kernel
``veles_tpu_torch/csrc/conv_wgrad.cu`` (which replaces the Pallas
kernel ``_wgrad_kernel``); on CPU tensors it runs the plain version
:func:`conv_wgrad_reference`.  Nothing falls back: a CUDA call builds
and launches the kernel or raises.  The kernel reads x through each
tap's offset, stride and zero padding itself, so it handles any tap
count; the JAX package's 32-tap limit (``MAX_FUSED_TAPS``) and its
autodiff fallback for larger kernels have no counterpart here.
:func:`plan_wgrad` picks the kernel's design (its rule is in its
docstring), and ``conv_wgrad.paths`` counts the calls each design
served: ``tc_bf16x3`` (level 0, bf16x3 on the tensor cores) or
``simt`` (levels 1 and 2, true-f32 products).

The dgrad stays a library convolution, as the JAX package leaves it to
a lax conv: :func:`conv_dgrad` is ``F.conv_transpose2d`` of err with
the forward stride, then cropped or zero-padded to the input's extent
(the lo/hi padding of the JAX lhs-dilated form).  ``Device()`` turns
TF32 off for cuDNN, so on the card it is a true-f32 convolution.

:func:`conv_act` is ``act(conv(x, w) + b)`` as a
``torch.autograd.Function``: the forward is the port's
``models/conv.py`` composition, it saves (x, w, y) as the JAX custom
VJP keeps its residuals, and its backward is :func:`fused_conv_vjp`.

Numerics, the JAX ladder (``mxu_partial_dot``): the kernel is f32 only.
Level 0 takes the bf16x3 products of the TPU kernel: each f32 operand
splits into ``hi = bf16_rn(v)`` and ``lo = bf16_rn(v - hi)``, and the
product is ``hi hi + hi lo + lo hi`` (~4e-6 normwise from float64 at
VGG16 widths); levels 1 and 2 take true-f32 products and compensate the
partial sums (Kahan, Neumaier).  The plain version sums per-tap products
in the input's dtype, through the same split at level 0 on float32
operands (``ops.matmul._partial_dot``); float64 operands bypass the
split and give a float64 reference.
"""

import ctypes

import torch
import torch.nn.functional as F

from veles_tpu_torch import graphs
from veles_tpu_torch.ops import common as _common
from veles_tpu_torch.ops.matmul import _partial_dot

__all__ = ["ACTIVATIONS", "activation_grad", "conv_wgrad",
           "conv_wgrad_reference", "conv_dgrad", "fused_conv_vjp",
           "conv_act", "plan_wgrad", "PATHS"]


# -- activation epilogues ----------------------------------------------------
# Derivatives in terms of the forward OUTPUT y, the closed forms of the
# JAX package; each product is rounded on its own, as the kernel does.

def _grad_linear(y, err):
    return err


def _grad_strict_relu(y, err):
    return err * (y > 0).to(err.dtype)


def _grad_relu_log(y, err):
    # y = log(1+exp(x))  =>  dy/dx = 1 - exp(-y)
    return err * (1.0 - torch.exp(-y))


def _tanh_constants():
    """(b / a, a * a) of y = a*tanh(b x), from the forward's own class,
    rounded to f32 once as the JAX program's weak-typed constants are."""
    from veles_tpu_torch.models.all2all import All2AllTanh
    a, b = All2AllTanh.A, All2AllTanh.B
    return b / a, a * a


def _grad_tanh(y, err):
    # y = A*tanh(B x)  =>  dy/dx = (B/A)*(A^2 - y^2)
    b_over_a, a2 = _tanh_constants()
    return err * (b_over_a * (a2 - y * y))


def _grad_sigmoid(y, err):
    return err * (y * (1.0 - y))


ACTIVATIONS = {
    "linear": _grad_linear,
    "strict_relu": _grad_strict_relu,
    "relu_log": _grad_relu_log,
    "tanh": _grad_tanh,
    "sigmoid": _grad_sigmoid,
}

#: activation codes of csrc/conv_wgrad.cu
_ACT_CODES = {"linear": 0, "strict_relu": 1, "relu_log": 2, "tanh": 3,
              "sigmoid": 4}


def activation_grad(activation, y, err):
    """err * d(activation)/dz expressed via the forward output y."""
    return ACTIVATIONS[activation](y, err)


# -- the wgrad kernel and its plain version ---------------------------------

#: the kernel's designs, by their codes in csrc/conv_wgrad.cu
PATHS = ("simt", "tc_bf16x3")
#: P rows a shared-memory stage (both designs)
STAGE = 32
#: the SIMT design's output tile (taps * Ci rows, Co columns), the blocks
#: its grid aims for per SM, and the fewest rows of P a split gets
SIMT_TILE, SIMT_BLOCKS_PER_SM, SIMT_MIN_ROWS = (64, 64), 4, 256
#: the tensor-core design's tiles: 128 rows by 64 columns (8 warps, two
#: blocks an SM) or by 128 columns (16 warps, one block an SM), each by
#: the blocks one SM holds; the waves of blocks its grid aims for, and
#: the fewest rows of P a split gets
TC_RESIDENT = {(128, 64): 2, (128, 128): 1}
TC_WAVES, TC_MIN_ROWS = 2, 512


def plan_wgrad(shape, co, ksize, level, dtype, sms):
    """(path, tile, splits, chunk): which design of csrc/conv_wgrad.cu
    serves a layer and how it cuts the contraction.  ``shape`` is (N,
    OH, OW, Ci): the output grid the contraction runs over (P = N * OH *
    OW rows) and the input's channels; ``ksize`` = (ky, kx); ``sms`` the
    card's SM count.  ``tile`` is (taps * Ci rows, Co columns) a block.

    Rule:

    1. ``path`` is ``tc_bf16x3`` for float32 at level 0 (the TPU
       kernel's bf16x3 products, on the tensor cores) and ``simt``
       otherwise (true-f32 products for levels 1 and 2).
    2. ``tc_bf16x3`` takes a (128, 128) tile where Co % 128 == 0 and
       (128, 64) otherwise: the wider tile reads x and y, dy from L2 a
       quarter less a product, and Co = 64 (VGG16's widest-P layers)
       would leave half of it empty.  ``simt`` takes (64, 64).
    3. ``simt``: P is cut into ``ceil(SIMT_BLOCKS_PER_SM * sms / tiles)``
       splits.  ``tc_bf16x3``: the tiles times the splits reach at least
       ``TC_WAVES`` waves of the blocks the card holds at once
       (``TC_RESIDENT`` an SM x ``sms``); of the split counts from there
       to four times that, the one whose last wave leaves the fewest slots
       idle (in whole percent of the blocks), the fewest splits on a
       tie.  Either way no split gets fewer than the design's
       ``*_MIN_ROWS`` rows (unless P has fewer); ``chunk`` is a multiple
       of the ``STAGE`` rows, every split gets at least one row, and the
       splits cover P."""
    n, oh, ow, ci = (int(v) for v in shape)
    p, r = n * oh * ow, int(ksize[0]) * int(ksize[1]) * ci
    co = int(co)
    if level == 0 and dtype == torch.float32:
        path = "tc_bf16x3"
        tile = (128, 128) if co % 128 == 0 else (128, 64)
        tiles = -(-r // tile[0]) * -(-co // tile[1])
        slots = TC_RESIDENT[tile] * sms
        most = max(1, min(-(-p // TC_MIN_ROWS), 65535))
        least = min(max(1, -(-TC_WAVES * slots // tiles)), most)

        def idle(splits):   # the last wave's empty slots, per block, in %
            return round(100 * (-(tiles * splits) % slots) /
                         (tiles * splits))
        splits = min(range(least, min(4 * least, most) + 1),
                     key=lambda s: (idle(s), s))
    else:
        path, tile = "simt", SIMT_TILE
        tiles = -(-r // tile[0]) * -(-co // tile[1])
        splits = -(-SIMT_BLOCKS_PER_SM * sms // tiles)
        splits = max(1, min(splits, -(-p // SIMT_MIN_ROWS), 65535))
    chunk = -(-(-(-p // splits)) // STAGE) * STAGE
    return path, tile, -(-p // chunk), chunk


def _geometry(x, y, ksize, padding, sliding):
    if x.ndim != 4 or y.ndim != 4:
        raise ValueError("conv_wgrad expects NHWC x and y, got %s, %s"
                         % (tuple(x.shape), tuple(y.shape)))
    ky, kx = (int(k) for k in ksize)
    left, top, right, bottom = (int(v) for v in padding)
    sx, sy = (int(v) for v in sliding)
    n, h, w_sp, _ = x.shape
    oh = (h + top + bottom - ky) // sy + 1
    ow = (w_sp + left + right - kx) // sx + 1
    if tuple(y.shape[:3]) != (n, oh, ow):
        raise ValueError("y %s does not match x %s under ksize %s, "
                         "padding %s, sliding %s" % (
                             tuple(y.shape), tuple(x.shape), ksize,
                             padding, sliding))
    return ky, kx, left, top, sx, sy, oh, ow


def _tap(xp, kh, kw, oh, ow, sy, sx):
    """Tap (kh, kw)'s strided slice of the padded input, (P, Ci)."""
    sl = xp[:, kh:kh + (oh - 1) * sy + 1:sy, kw:kw + (ow - 1) * sx + 1:sx]
    return sl.reshape(-1, xp.shape[-1])


def conv_wgrad_reference(x, y, dy, *, activation, ksize, padding,
                         sliding, precision_level=0):
    """The plain PyTorch version: (grad_w (ky, kx, Ci, Co), grad_b
    (Co,), err in x.dtype).  Computes in the wider of x.dtype and
    float32, so float64 operands give a float64 reference.  Each tap's
    product on float32 operands is the level's (``_partial_dot``: bf16x3
    at level 0, true f32 at levels 1 and 2); float64 operands bypass the
    split."""
    ky, kx, left, top, sx, sy, oh, ow = _geometry(x, y, ksize, padding,
                                                  sliding)
    cd = torch.promote_types(x.dtype, torch.float32)
    err_acc = activation_grad(activation, y.to(cd), dy.to(cd))
    err = err_acc.to(x.dtype)
    co = y.shape[-1]
    err2 = err.to(cd).reshape(-1, co)
    h, w_sp = x.shape[1], x.shape[2]
    need_h = (oh - 1) * sy + ky
    need_w = (ow - 1) * sx + kx
    # negative high pads crop rows no window reaches
    xp = F.pad(x.to(cd), (0, 0, left, need_w - w_sp - left,
                          top, need_h - h - top))
    if cd == torch.float32:
        def dot(a, b):
            return _partial_dot(a, b, precision_level)
    else:
        dot = torch.matmul
    grad_w = torch.stack([
        dot(_tap(xp, kh, kw, oh, ow, sy, sx).t(), err2)
        for kh in range(ky) for kw in range(kx)])
    grad_w = grad_w.reshape(ky, kx, x.shape[-1], co)
    grad_b = err_acc.sum(dim=(0, 1, 2))
    return grad_w, grad_b, err


def _launch(x, y, dy, activation, geometry, precision_level):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function, sm_count)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_conv_wgrad",
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 7 +
            [ctypes.c_int] * 6 + [ctypes.c_longlong] +
            [ctypes.c_int] * 5 + [ctypes.c_float] * 2 +
            [ctypes.c_int, ctypes.c_void_p])
    ky, kx, left, top, sx, sy, oh, ow = geometry
    n, h, w_sp, ci = x.shape
    co = y.shape[-1]
    r = ky * kx * ci
    path, tile, splits, chunk = plan_wgrad(
        (n, oh, ow, ci), co, (ky, kx), precision_level, x.dtype,
        sm_count(x.device))
    dev = x.device
    err = torch.empty_like(y)
    part_w = torch.empty((splits, r, co), dtype=torch.float32, device=dev)
    part_b = torch.empty((splits, co), dtype=torch.float32, device=dev)
    grad_w = torch.empty((ky, kx, ci, co), dtype=torch.float32,
                         device=dev)
    grad_b = torch.empty((co,), dtype=torch.float32, device=dev)
    b_over_a, a2 = _tanh_constants()
    stream = current_stream(dev)
    code = fn(x.data_ptr(), y.data_ptr(), dy.data_ptr(), err.data_ptr(),
              part_w.data_ptr(), part_b.data_ptr(), grad_w.data_ptr(),
              grad_b.data_ptr(), n, h, w_sp, ci, oh, ow, co, ky, kx, sy,
              sx, top, left, chunk, splits, _ACT_CODES[activation],
              precision_level, PATHS.index(path), tile[1], a2, b_over_a,
              dev.index, stream)
    check_launch(code, "conv_wgrad")
    conv_wgrad.launches += 1
    conv_wgrad.paths[path] += 1
    return grad_w, grad_b, err


_launch.fn = None


def conv_wgrad(x, y, dy, *, activation="linear", ksize, padding=(0, 0, 0, 0),
               sliding=(1, 1), precision_level=0):
    """(grad_w f32 (ky, kx, Ci, Co), grad_b f32 (Co,), err in x.dtype)
    of one conv layer: x (N, H, W, Ci) the forward input, y and dy
    (N, OH, OW, Co) the forward output and its cotangent; ``ksize`` =
    (ky, kx), ``padding`` = (left, top, right, bottom), ``sliding`` =
    (sx, sy).

    ``precision_level`` 0 takes the TPU kernel's bf16x3 products:
    operands with |v| at or above the bfloat16 maximum (~3.39e38), or
    inf, give non-finite output, as the JAX level 0 does.  Levels 1 and
    2 take true-f32 products with compensated sums.

    A CUDA call takes float32 operands, launches the kernel (the design
    :func:`plan_wgrad` picks) and adds one to ``conv_wgrad.launches``
    and to ``conv_wgrad.paths[design]``; a CPU call runs
    :func:`conv_wgrad_reference` at the same level.  Anything else
    raises.  With ``ops.common.DEBUG_NONFINITE`` on, a non-finite output
    raises ``FloatingPointError`` with per-operand statistics."""
    if activation not in _ACT_CODES:
        raise ValueError("unknown activation %r (known: %s)" % (
            activation, ", ".join(sorted(_ACT_CODES))))
    if precision_level not in (0, 1, 2):
        raise ValueError("precision_level must be 0, 1 or 2, got %r"
                         % (precision_level,))
    geometry = _geometry(x, y, ksize, padding, sliding)
    if tuple(dy.shape) != tuple(y.shape):
        raise ValueError("dy %s does not match y %s" % (
            tuple(dy.shape), tuple(y.shape)))
    if not (x.device == y.device == dy.device):
        raise ValueError("operands on different devices: %s, %s, %s"
                         % (x.device, y.device, dy.device))
    if x.device.type == "cpu":
        out = conv_wgrad_reference(x, y, dy, activation=activation,
                                   ksize=ksize, padding=padding,
                                   sliding=sliding,
                                   precision_level=precision_level)
    elif x.device.type != "cuda":
        raise ValueError("conv_wgrad runs on CUDA or CPU tensors, got %s"
                         % x.device)
    elif not (x.dtype == y.dtype == dy.dtype == torch.float32):
        raise TypeError("the conv_wgrad kernel takes float32 operands, "
                        "got %s, %s, %s" % (x.dtype, y.dtype, dy.dtype))
    else:
        out = _launch(x.contiguous(), y.contiguous(), dy.contiguous(),
                      activation, geometry, precision_level)
    if _common.DEBUG_NONFINITE:
        _common.debug_check_finite(
            "conv_wgrad", zip(("grad_w", "grad_b", "err"), out),
            [("x", x), ("y", y), ("dy", dy)], precision_level)
    return out


#: kernel launches since the last reset, in all and by design (plain
#: counters: the smoke run zeroes them before driving the train path and
#: reads them after)
conv_wgrad.launches = 0
conv_wgrad.paths = dict.fromkeys(PATHS, 0)
#: a captured graph's replays advance the counters too
graphs.register_counters(conv_wgrad)


# -- dgrad and the whole VJP -------------------------------------------------


def conv_dgrad(err, w, x_shape, padding, sliding):
    """dX of the conv: the transposed convolution of err (N, OH, OW,
    Co) with the HWIO weights at the forward stride, then cropped or
    zero-padded to the input's (H, W) — the lo/hi padding
    ``ky - 1 - top`` / ``h + top - (oh - 1) * sy - 1`` of the JAX
    lhs-dilated form.  Returns NHWC in err's dtype."""
    ky, kx = int(w.shape[0]), int(w.shape[1])
    left, top, _right, _bottom = padding
    sx, sy = sliding
    h, w_sp = int(x_shape[1]), int(x_shape[2])
    oh, ow = err.shape[1], err.shape[2]
    full = F.conv_transpose2d(
        err.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
        stride=(sy, sx))
    full_h, full_w = (oh - 1) * sy + ky, (ow - 1) * sx + kx
    dx = full.permute(0, 2, 3, 1)
    return F.pad(dx, (0, 0, -left, w_sp + left - full_w,
                      -top, h + top - full_h)).contiguous()


def fused_conv_vjp(x, w, y, err_output, *, activation="linear",
                   padding=(0, 0, 0, 0), sliding=(1, 1),
                   include_bias=True, need_err_input=True,
                   precision_level=0):
    """The conv backward: (err_input, grad_w, grad_b).  ``x``/``w``/``y``
    are the forward operands and OUTPUT (activation included),
    ``err_output`` the incoming cotangent.  grad_w/grad_b come back f32;
    err_input in x.dtype, or None when not needed (the first layer's
    input needs none)."""
    grad_w, grad_b, err = conv_wgrad(
        x, y, err_output, activation=activation,
        ksize=(w.shape[0], w.shape[1]), padding=padding, sliding=sliding,
        precision_level=precision_level)
    err_input = (conv_dgrad(err, w, x.shape, padding, sliding)
                 if need_err_input else None)
    return err_input, grad_w, (grad_b if include_bias else None)


# -- the autograd.Function ---------------------------------------------------


def _forward(x, w, b, activation, padding, sliding):
    """act(conv(x, w) + b): the ``models/conv.py`` composition."""
    from veles_tpu_torch.models.conv import conv2d, forward_activation
    z = conv2d(x.to(torch.float32), w, padding, sliding)
    if b is not None:
        z = z + b
    return forward_activation(activation)(z).to(x.dtype)


class _ConvAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, activation, padding, sliding,
                precision_level):
        y = _forward(x, w, b, activation, padding, sliding)
        ctx.save_for_backward(x, w, y)
        ctx.config = (activation, padding, sliding, precision_level,
                      None if b is None else b.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        activation, padding, sliding, precision_level, b_dtype = ctx.config
        err_input, grad_w, grad_b = fused_conv_vjp(
            x, w, y, dy, activation=activation, padding=padding,
            sliding=sliding, include_bias=b_dtype is not None,
            need_err_input=ctx.needs_input_grad[0],
            precision_level=precision_level)
        return (err_input, grad_w.to(w.dtype),
                None if grad_b is None else grad_b.to(b_dtype),
                None, None, None, None)


def conv_act(x, w, b, *, activation, padding, sliding, precision_level=0):
    """act(conv(x, w) + b) with the fused backward attached; ``b`` may
    be None.  Where no operand needs a gradient (inference), this is
    the plain forward."""
    padding = tuple(int(v) for v in padding)
    sliding = tuple(int(v) for v in sliding)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _ConvAct.apply(x, w, b, activation, padding, sliding,
                              precision_level)
    return _forward(x, w, b, activation, padding, sliding)
