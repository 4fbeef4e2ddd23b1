"""Concatenate tensors along the feature axis, with a cast.

Counterpart of ``veles_tpu/ops/join.py``.  :func:`join` flattens N
(B, ...) inputs to (B, F_i) and writes them side by side into one
(B, sum F_i) tensor of ``out_dtype`` (default: the first input's).  On
CUDA tensors it launches the hand-written Hopper kernel
``veles_tpu_torch/csrc/join.cu`` (which replaces the Pallas kernel
``_make_join_kernel``); on CPU tensors it runs the plain version
:func:`join_reference`, ``torch.cat`` of the cast inputs.  Nothing falls
back: a CUDA call builds and launches the kernel or raises.

The kernel takes uint8, int8, int32, float32, bfloat16 and float16
inputs.  To a float output any of them casts (integers and bf16/f16
widen exactly, int32 and f32 round to nearest even); to an integer
output only an integer input of no greater width does.  One launch takes
up to 16 inputs; a longer list takes one launch per 16, each writing its
own columns.
"""

import ctypes

import torch

from veles_tpu_torch import graphs

__all__ = ["join", "join_reference", "MAX_INPUTS"]

#: dtype codes of csrc/join.cu
_CODES = {torch.uint8: 0, torch.int8: 1, torch.int32: 2,
          torch.float32: 3, torch.bfloat16: 4, torch.float16: 5}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

#: table entries one kernel launch takes (csrc/join.cu MAX_INPUTS)
MAX_INPUTS = 16


def _flatten(arrays):
    if not arrays:
        raise ValueError("join needs at least one input")
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        raise TypeError("join expects torch tensors")
    batch = arrays[0].shape[0]
    for i, a in enumerate(arrays):
        if a.shape[0] != batch:
            raise ValueError("join: input %d has batch %d, expected %d" %
                             (i, a.shape[0], batch))
        if a.device != arrays[0].device:
            raise ValueError("join: input %d on %s, input 0 on %s" %
                             (i, a.device, arrays[0].device))
    return [a.reshape(batch, -1) for a in arrays]


def join_reference(*arrays, out_dtype=None):
    """The plain PyTorch version: cast each input, then ``torch.cat``."""
    flats = _flatten(arrays)
    out_dtype = out_dtype or flats[0].dtype
    return torch.cat([f.to(out_dtype) for f in flats], dim=1)


def _castable(src, dst):
    if src not in _CODES or dst not in _CODES:
        return False
    if dst in _FLOATS:
        return True
    return src not in _FLOATS and src.itemsize <= dst.itemsize and (
        src == dst or dst == torch.int32 or
        (src == torch.uint8) == (dst == torch.uint8))


def _launch(flats, out_dtype):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_join",
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] +
            [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 +
            [ctypes.c_void_p])
    device = flats[0].device
    batch = flats[0].shape[0]
    widths = [f.shape[1] for f in flats]
    total = sum(widths)
    out = torch.empty((batch, total), dtype=out_dtype, device=device)
    if batch == 0 or total == 0:
        return out
    stream = current_stream(device)
    offset = 0
    for start in range(0, len(flats), MAX_INPUTS):
        part = flats[start:start + MAX_INPUTS]
        n = len(part)
        srcs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in part])
        part_widths = (ctypes.c_longlong * n)(*[f.shape[1] for f in part])
        offsets = []
        for f in part:
            offsets.append(offset)
            offset += f.shape[1]
        code = fn(srcs, part_widths, (ctypes.c_longlong * n)(*offsets),
                  (ctypes.c_int * n)(*[_CODES[f.dtype] for f in part]), n,
                  out.data_ptr(), batch, total, _CODES[out_dtype],
                  device.index, stream)
        check_launch(code, "join")
        join.launches += 1
    return out


_launch.fn = None


def join(*arrays, out_dtype=None):
    """Concatenate (B, ...) tensors -> (B, sum F_i) along axis 1.

    A CUDA call launches the kernel (one launch per 16 inputs) and adds
    one to ``join.launches`` per launch; a CPU call runs
    :func:`join_reference`.  Anything else raises."""
    flats = _flatten(arrays)
    out_dtype = out_dtype or flats[0].dtype
    device = flats[0].device
    if device.type == "cpu":
        return join_reference(*flats, out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError("join runs on CUDA or CPU tensors, got %s"
                         % device)
    for i, f in enumerate(flats):
        if not _castable(f.dtype, out_dtype):
            raise TypeError("the join kernel cannot cast input %d from %s "
                            "to %s" % (i, f.dtype, out_dtype))
        if not f.is_contiguous():
            raise ValueError("join expects contiguous inputs (input %d "
                             "is not)" % i)
    return _launch(flats, out_dtype)


#: kernel launches since the last reset (a plain counter: the smoke run
#: zeroes it before driving the unit graph and reads it after)
join.launches = 0
#: a captured graph's replays advance the counters too
graphs.register_counters(join)
