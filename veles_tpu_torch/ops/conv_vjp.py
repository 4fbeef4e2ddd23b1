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

The dgrad stays a library convolution, as the JAX package leaves it to
a lax conv: :func:`conv_dgrad` is ``F.conv_transpose2d`` of err with
the forward stride, then cropped or zero-padded to the input's extent
(the lo/hi padding of the JAX lhs-dilated form).  ``Device()`` turns
TF32 off for cuDNN, so on the card it is a true-f32 convolution.

:func:`conv_act` is ``act(conv(x, w) + b)`` as a
``torch.autograd.Function``: the forward is the port's
``models/conv.py`` composition, it saves (x, w, y) as the JAX custom
VJP keeps its residuals, and its backward is :func:`fused_conv_vjp`.

Numerics: the kernel is f32 only.  Level 0 sums true-f32 FMA products;
levels 1 and 2 compensate the partial sums (Kahan, Neumaier).  The
plain version sums per-tap products with ``torch.matmul`` in the input's
dtype (float64 inputs give a float64 reference).
"""

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "activation_grad", "conv_wgrad",
           "conv_wgrad_reference", "conv_dgrad", "fused_conv_vjp",
           "conv_act", "split_plan"]


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

#: shapes of csrc/conv_wgrad.cu: output tile (rows, cols), P rows a stage
TILE_R, TILE_C, STAGE = 64, 64, 32
#: blocks aimed for per SM when the contraction is split over P, and the
#: fewest rows of P a split gets
BLOCKS_PER_SM, MIN_SPLIT_ROWS = 4, 256


def split_plan(p, r, co, sms):
    """(splits, chunk): how the wgrad kernel cuts its contraction over
    P rows so that the grid fills ``sms`` SMs.  ``chunk`` is a
    multiple of the stage, and every split gets at least one row."""
    tiles = -(-co // TILE_C) * -(-r // TILE_R)
    splits = -(-BLOCKS_PER_SM * sms // tiles)
    splits = max(1, min(splits, -(-p // MIN_SPLIT_ROWS), 65535))
    chunk = -(-(-(-p // splits)) // STAGE) * STAGE
    return -(-p // chunk), chunk


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
                         sliding):
    """The plain PyTorch version: (grad_w (ky, kx, Ci, Co), grad_b
    (Co,), err in x.dtype).  Computes in the wider of x.dtype and
    float32, so float64 operands give a float64 reference."""
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
    grad_w = torch.stack([
        _tap(xp, kh, kw, oh, ow, sy, sx).t() @ err2
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
            [ctypes.c_int] * 3 + [ctypes.c_float] * 2 +
            [ctypes.c_int, ctypes.c_void_p])
    ky, kx, left, top, sx, sy, oh, ow = geometry
    n, h, w_sp, ci = x.shape
    co = y.shape[-1]
    p, r = n * oh * ow, ky * kx * ci
    splits, chunk = split_plan(p, r, co, sm_count(x.device))
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
              precision_level, a2, b_over_a, dev.index, stream)
    check_launch(code, "conv_wgrad")
    conv_wgrad.launches += 1
    return grad_w, grad_b, err


_launch.fn = None


def conv_wgrad(x, y, dy, *, activation="linear", ksize, padding=(0, 0, 0, 0),
               sliding=(1, 1), precision_level=0):
    """(grad_w f32 (ky, kx, Ci, Co), grad_b f32 (Co,), err in x.dtype)
    of one conv layer: x (N, H, W, Ci) the forward input, y and dy
    (N, OH, OW, Co) the forward output and its cotangent; ``ksize`` =
    (ky, kx), ``padding`` = (left, top, right, bottom), ``sliding`` =
    (sx, sy).

    A CUDA call launches the kernel and adds one to
    ``conv_wgrad.launches``; a CPU call runs
    :func:`conv_wgrad_reference`.  Anything else raises."""
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
        return conv_wgrad_reference(x, y, dy, activation=activation,
                                    ksize=ksize, padding=padding,
                                    sliding=sliding)
    if x.device.type != "cuda":
        raise ValueError("conv_wgrad runs on CUDA or CPU tensors, got %s"
                         % x.device)
    if not (x.dtype == y.dtype == dy.dtype == torch.float32):
        raise TypeError("the conv_wgrad kernel takes float32 operands, "
                        "got %s, %s, %s" % (x.dtype, y.dtype, dy.dtype))
    return _launch(x.contiguous(), y.contiguous(), dy.contiguous(),
                   activation, geometry, precision_level)


#: kernel launches since the last reset (a plain counter: the smoke
#: run zeroes it before driving the train path and reads it after)
conv_wgrad.launches = 0


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
