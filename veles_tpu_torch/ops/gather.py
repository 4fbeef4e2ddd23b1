"""Minibatch gather from a device-resident dataset.

Counterpart of ``veles_tpu/ops/gather.py``.  :func:`gather_minibatch`
computes ``out[i] = cast(dataset[indices[i]])``.  On CUDA tensors it
launches the hand-written Hopper kernel ``veles_tpu_torch/csrc/gather.cu``
(which replaces the Pallas kernel ``_gather_kernel``); on CPU tensors it
runs the plain version :func:`gather_minibatch_reference`.  Nothing
falls back: a CUDA call builds and launches the kernel or raises.

The port has no 128-lane rule: every row width takes the kernel, where
the JAX package sends unaligned widths to ``jnp.take``.  An index
outside [0, N) is clamped to the nearest row by the kernel and by the
plain version alike, so a bad index never reads outside the dataset.

The kernel copies rows of uint8, int8, int32 or float32 as they are, or
widens them to float32; any other pair of dtypes raises on the card.
It reads int32 and int64 indices as they are.  :func:`plan_gather`
picks its path per call: ``vec4`` (4 elements a thread a step) where
the row width is a multiple of 4 and both bases are aligned to 4
elements, ``scalar`` otherwise; ``gather_minibatch.paths`` counts the
calls each path served.
"""

import ctypes

import torch

from veles_tpu_torch import graphs

__all__ = ["gather_minibatch", "gather_minibatch_reference",
           "gather_labels", "plan_gather", "PATHS"]

#: dtype codes of csrc/gather.cu
_CODES = {torch.uint8: 0, torch.int8: 1, torch.int32: 2,
          torch.float32: 3}
#: the kernel's paths, in the order of csrc/gather.cu's ``Path``
PATHS = ("vec4", "scalar")


def _check(dataset, indices):
    if not (isinstance(dataset, torch.Tensor) and
            isinstance(indices, torch.Tensor)):
        raise TypeError("gather_minibatch expects torch tensors")
    if indices.ndim != 1 or indices.dtype not in (torch.int32,
                                                  torch.int64):
        raise ValueError("indices must be a 1-D int32/int64 tensor, got "
                         "%s %s" % (tuple(indices.shape), indices.dtype))
    if dataset.ndim < 1 or dataset.shape[0] == 0:
        raise ValueError("dataset must have at least one row, got %s"
                         % (tuple(dataset.shape),))
    if dataset.device != indices.device:
        raise ValueError("dataset and indices on different devices: %s, "
                         "%s" % (dataset.device, indices.device))


def gather_minibatch_reference(dataset, indices, out_dtype=None,
                               out=None):
    """The plain PyTorch version: clamp the indices into [0, N), take
    the rows, cast (into ``out`` when given)."""
    _check(dataset, indices)
    out_dtype = out_dtype or dataset.dtype
    idx = indices.clamp(0, dataset.shape[0] - 1)
    rows = dataset.index_select(0, idx).to(out_dtype)
    return rows if out is None else out.copy_(rows)


def plan_gather(width, in_itemsize, out_itemsize, src_ptr=0, dst_ptr=0):
    """The path of csrc/gather.cu that serves one gather of rows of
    ``width`` elements, ``in_itemsize`` bytes each in the dataset and
    ``out_itemsize`` in the output: ``vec4`` (4 elements a thread a
    step) where the width is a multiple of 4 and both base pointers are
    aligned to 4 elements, ``scalar`` (one) otherwise."""
    vec = width % 4 == 0 and src_ptr % (4 * in_itemsize) == 0 and \
        dst_ptr % (4 * out_itemsize) == 0
    return "vec4" if vec else "scalar"


def _launch(dataset, idx, out_dtype, out=None):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_gather_rows",
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 +
            [ctypes.c_int] * 5 + [ctypes.c_void_p])
    n = dataset.shape[0]
    width = dataset.numel() // n
    batch = idx.shape[0]
    if out is None:
        out = torch.empty((batch,) + tuple(dataset.shape[1:]),
                          dtype=out_dtype, device=dataset.device)
    path = plan_gather(width, dataset.element_size(), out.element_size(),
                       dataset.data_ptr(), out.data_ptr())
    stream = current_stream(dataset.device)
    code = fn(dataset.data_ptr(), idx.data_ptr(), out.data_ptr(), n, batch,
              width, _CODES[dataset.dtype], _CODES[out_dtype],
              idx.element_size(), PATHS.index(path),
              dataset.device.index, stream)
    check_launch(code, "gather_minibatch")
    gather_minibatch.launches += 1
    gather_minibatch.paths[path] += 1
    return out


_launch.fn = None


def gather_minibatch(dataset, indices, out_dtype=None, out=None):
    """Gather rows: (N, F...) x (B,) -> (B, F...) in ``out_dtype``
    (default: the dataset's), into ``out`` when given (a contiguous
    tensor of that shape and dtype on the dataset's device: a captured
    step's static input).

    A CUDA call launches the kernel (and nothing else: int64 indices
    go to it as they are) and adds one to ``gather_minibatch.launches``
    and to ``gather_minibatch.paths``; a CPU call runs
    :func:`gather_minibatch_reference`.  Anything else raises."""
    _check(dataset, indices)
    out_dtype = out_dtype or dataset.dtype
    if out is not None:
        shape = (indices.shape[0],) + tuple(dataset.shape[1:])
        if tuple(out.shape) != shape or out.dtype != out_dtype or \
                out.device != dataset.device or not out.is_contiguous():
            raise ValueError(
                "gather_minibatch: out must be a contiguous %s %s tensor "
                "on %s, got %s %s on %s" % (shape, out_dtype,
                                            dataset.device,
                                            tuple(out.shape), out.dtype,
                                            out.device))
    if dataset.device.type == "cpu":
        return gather_minibatch_reference(dataset, indices, out_dtype, out)
    if dataset.device.type != "cuda":
        raise ValueError("gather_minibatch runs on CUDA or CPU tensors, "
                         "got %s" % dataset.device)
    return _kernel(dataset, indices, out_dtype, out)


def _kernel(dataset, indices, out_dtype, out=None):
    """The card path after the device check: refuse what the kernel
    does not take, then launch it."""
    if dataset.dtype not in _CODES or out_dtype not in (
            dataset.dtype, torch.float32):
        raise TypeError("the gather kernel copies uint8/int8/int32/"
                        "float32 rows as they are or widens them to "
                        "float32; got %s -> %s" % (dataset.dtype,
                                                   out_dtype))
    if not dataset.is_contiguous():
        raise ValueError("gather_minibatch expects a contiguous dataset")
    return _launch(dataset, indices.contiguous(), out_dtype, out)


#: kernel launches since the last reset (a plain counter: the smoke
#: run zeroes it before driving the train path and reads it after)
gather_minibatch.launches = 0
#: the same launches by the path that served them (``PATHS``)
gather_minibatch.paths = dict.fromkeys(PATHS, 0)
#: a captured graph's replays advance the counters too
graphs.register_counters(gather_minibatch)


def gather_labels(labels, indices, out=None):
    """Label gather: labels are small, ``index_select`` serves (the JAX
    package uses ``jnp.take`` here too), into ``out`` when given.
    Indices are clamped as in :func:`gather_minibatch`."""
    idx = indices.clamp(0, labels.shape[0] - 1).to(torch.int64)
    if out is None:
        return labels.index_select(0, idx)
    return torch.index_select(labels, 0, idx, out=out)
