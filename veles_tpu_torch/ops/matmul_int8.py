"""Int8 quantized matmul + conv forward.

Counterpart of ``veles_tpu/ops/matmul_int8.py``.  :func:`matmul_int8`
computes ``f32(a @ b) * scale + bias`` with int8 operands and an exact
int32 accumulator.  On CUDA tensors it launches the hand-written Hopper
kernel ``veles_tpu_torch/csrc/matmul_int8.cu`` (which replaces the
Pallas kernel ``_matmul_int8_kernel``); on CPU tensors it runs the plain
version :func:`matmul_int8_reference`.  Nothing falls back: a CUDA call
builds and launches the kernel or raises.

``conv2d_int8`` lowers the conv forward onto the same product: per-tap
strided slices of the zero-padded NHWC input, tap-major (dy, then dx)
and then Cin, stack into an im2col patch matrix that matches
``w.reshape(ky * kx * Cin, Cout)`` of the HWIO weights.

Numerics: integer accumulation is exact under any order.  The kernel's
epilogue is ``__fmaf_rn(float(acc), scale[j], bias[j])``, one rounding;
the plain version computes the same expression in float64 and rounds
once to float32, so the two agree bit for bit when the float64 sum is
exact (``scale = 1``, ``bias = 0``) and to 1 ulp otherwise.
"""

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["matmul_int8", "matmul_int8_reference", "conv2d_int8"]


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


def _launch(a, b, scale, bias):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_matmul_int8",
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 +
            [ctypes.c_int, ctypes.c_void_p])
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = current_stream(a.device)
    code = fn(a.data_ptr(), b.data_ptr(), scale.data_ptr(),
              bias.data_ptr(), out.data_ptr(), m, n, k,
              a.device.index, stream)
    check_launch(code, "matmul_int8")
    matmul_int8.launches += 1
    return out


_launch.fn = None


def matmul_int8(a, b, scale, bias=None, out_dtype=torch.float32):
    """``dequant(a @ b)``: a (M, K) int8, b (K, N) int8, both
    contiguous and on one device; ``scale`` a scalar or (N,) vector
    (activation scale x per-channel weight scale); ``bias`` an optional
    (N,) f32 vector added after the dequant.  Returns (M, N)
    ``out_dtype``.

    A CUDA call launches the kernel and adds one to
    ``matmul_int8.launches``; a CPU call runs
    :func:`matmul_int8_reference`.  Anything else raises."""
    _check_operands(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_int8 expects contiguous operands")
    n = b.shape[1]
    scale, bias = _epilogue_args(n, scale, bias, a.device)
    if a.device.type == "cpu":
        return matmul_int8_reference(a, b, scale, bias, out_dtype)
    if a.device.type != "cuda":
        raise ValueError("matmul_int8 runs on CUDA or CPU tensors, "
                         "got %s" % a.device)
    m, k = a.shape
    if m == 0 or n == 0 or k == 0:
        return bias[None, :].expand(m, n).to(out_dtype).contiguous()
    out = _launch(a, b, scale, bias)
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: kernel launches since the last reset (a plain counter: the smoke
#: run zeroes it before driving the serve path and reads it after)
matmul_int8.launches = 0


def conv2d_int8(x, w, scale, bias=None, padding=(0, 0, 0, 0),
                sliding=(1, 1), out_dtype=torch.float32):
    """Int8 conv forward through :func:`matmul_int8`.

    x: (N, H, W, Cin) int8 (NHWC), w: (ky, kx, Cin, Cout) int8 (HWIO);
    ``padding`` = (left, top, right, bottom), ``sliding`` = (sx, sy) —
    the Conv layer's static config, verbatim.  Returns (N, OH, OW,
    Cout) in ``out_dtype``."""
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
    patches = torch.cat(taps, dim=-1)   # tap-major, then Cin
    patches = patches.reshape(n * oh * ow, ky * kx * ci)
    z = matmul_int8(patches, w.reshape(ky * kx * ci, cout).contiguous(),
                    scale, bias=bias, out_dtype=out_dtype)
    return z.reshape(n, oh, ow, cout)
