"""Mean/dispersion normalization: ``out = (x - mean) * rdisp``.

Counterpart of ``veles_tpu/ops/normalize.py``.
:func:`mean_disp_normalize` casts a (B, F...) uint8, int8, int32,
float32, bfloat16 or float16 tensor to float32 and applies the float32
``mean`` and ``rdisp`` of its F features, broadcast over the samples: a
subtraction and a product, each rounded (no fused multiply-add), as the
JAX kernel and the host normalizer of float32 data compute them.  On CUDA
tensors
it launches the hand-written Hopper kernel
``veles_tpu_torch/csrc/normalize.cu`` (which replaces the Pallas kernel
``_normalize_kernel``); on CPU tensors it runs the plain version
:func:`mean_disp_normalize_reference`.  Nothing falls back: a CUDA call
builds and launches the kernel or raises.

``mean`` and ``rdisp`` may come in any float dtype (the host
normalizer's are float64); they are cast to float32 first, as the JAX
package's ``device.put`` does with x64 off.  The TPU kernel pads the
batch and the features to its (bm, 128) tiles; the CUDA kernel masks
the edges instead and needs no padding.
"""

import ctypes

import torch

from veles_tpu_torch import graphs

__all__ = ["mean_disp_normalize", "mean_disp_normalize_reference"]

#: input dtype codes of csrc/normalize.cu
_CODES = {torch.uint8: 0, torch.int8: 1, torch.int32: 2,
          torch.float32: 3, torch.bfloat16: 4, torch.float16: 5}


def _prepare(x, mean, rdisp):
    if not all(isinstance(t, torch.Tensor) for t in (x, mean, rdisp)):
        raise TypeError("mean_disp_normalize expects torch tensors")
    if x.ndim < 1:
        raise ValueError("x must have a batch axis, got a scalar")
    width = x.shape[1:].numel()
    mean = mean.reshape(-1).to(torch.float32)
    rdisp = rdisp.reshape(-1).to(torch.float32)
    if mean.numel() != width or rdisp.numel() != width:
        raise ValueError("mean / rdisp have %d / %d elements for %d "
                         "features" % (mean.numel(), rdisp.numel(), width))
    if not (x.device == mean.device == rdisp.device):
        raise ValueError("x, mean and rdisp on different devices: %s, %s, "
                         "%s" % (x.device, mean.device, rdisp.device))
    return mean, rdisp


def mean_disp_normalize_reference(x, mean, rdisp):
    """The plain PyTorch version: cast to f32, subtract, multiply."""
    mean, rdisp = _prepare(x, mean, rdisp)
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    return ((flat - mean) * rdisp).reshape(x.shape)


def _launch(x, mean, rdisp):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_mean_disp_normalize",
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 +
            [ctypes.c_int] * 2 + [ctypes.c_void_p])
    batch = x.shape[0]
    width = mean.numel()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    code = fn(x.data_ptr(), mean.data_ptr(), rdisp.data_ptr(),
              out.data_ptr(), batch, width, _CODES[x.dtype],
              x.device.index, current_stream(x.device))
    check_launch(code, "mean_disp_normalize")
    mean_disp_normalize.launches += 1
    return out


def mean_disp_normalize(x, mean, rdisp):
    """(B, F...) x, (F,) mean, (F,) rdisp -> (B, F...) float32.

    A CUDA call launches the kernel and adds one to
    ``mean_disp_normalize.launches``; a CPU call runs
    :func:`mean_disp_normalize_reference`.  Anything else raises."""
    mean, rdisp = _prepare(x, mean, rdisp)
    if x.device.type == "cpu":
        return mean_disp_normalize_reference(x, mean, rdisp)
    if x.device.type != "cuda":
        raise ValueError("mean_disp_normalize runs on CUDA or CPU tensors, "
                         "got %s" % x.device)
    if x.dtype not in _CODES:
        raise TypeError("the normalize kernel takes uint8, int8, int32, "
                        "float32, bfloat16 or float16 input, got %s"
                        % x.dtype)
    if not x.is_contiguous():
        raise ValueError("mean_disp_normalize expects a contiguous x")
    return _launch(x, mean.contiguous(), rdisp.contiguous())


_launch.fn = None

#: kernel launches since the last reset (a plain counter: the smoke run
#: zeroes it before driving the unit graph and reads it after)
mean_disp_normalize.launches = 0
#: a captured graph's replays advance the counters too
graphs.register_counters(mean_disp_normalize)
