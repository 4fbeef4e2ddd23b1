"""Matrix column and row sums.

Counterpart of ``veles_tpu/ops/reduce.py``: :func:`reduce_cols` maps
(M, N) to its (1, N) column sums, :func:`reduce_rows` to its (M, 1) row
sums, each accumulated in float32 and returned in ``x.dtype``.  On CUDA
tensors (float32, bfloat16 or float16) they launch the hand-written
Hopper kernel ``veles_tpu_torch/csrc/reduce.cu`` (which replaces the
Pallas kernels ``_reduce_cols_kernel`` and ``_reduce_rows_kernel``); on
CPU tensors they run the plain versions, which sum blocks of ``block``
rows (or columns) into a float32 accumulator in block order, as the JAX
kernels do.  Nothing falls back: a CUDA call builds and launches the
kernel or raises.

The kernel takes its sums in two passes (partials of row or column
chunks into a float32 scratch, then the chunks in order), the chunks
chosen here to fill the card; ``block`` has no effect on it.
"""

import ctypes

import torch

from veles_tpu_torch.ops.common import ceil_mult

__all__ = ["reduce_cols", "reduce_rows", "reduce_cols_reference",
           "reduce_rows_reference"]

#: dtype codes of csrc/reduce.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: threads of a kernel block (csrc/reduce.cu THREADS)
_THREADS = 256
#: the least rows (columns) a chunk of the column (row) sums takes
_MIN_ROWS, _MIN_COLS = 64, 1024
_MAX_CHUNKS = 65535


def _check(x, block):
    if not isinstance(x, torch.Tensor):
        raise TypeError("reduce expects a torch tensor")
    if x.ndim != 2:
        raise ValueError("reduce expects a 2-D tensor, got %d-D" % x.ndim)
    if block < 1:
        raise ValueError("block must be positive, got %d" % block)


def reduce_cols_reference(x, block=512):
    """The plain PyTorch version: float32 sums of blocks of ``block``
    rows, added in block order."""
    _check(x, block)
    m, n = x.shape
    acc = torch.zeros((1, n), dtype=torch.float32, device=x.device)
    bm = min(block, ceil_mult(m, 8)) or 1
    for i in range(0, m, bm):
        acc += x[i:i + bm].sum(dim=0, keepdim=True, dtype=torch.float32)
    return acc.to(x.dtype)


def reduce_rows_reference(x, block=512):
    """The plain PyTorch version: float32 sums of blocks of ``block``
    columns, added in block order."""
    _check(x, block)
    m, n = x.shape
    acc = torch.zeros((m, 1), dtype=torch.float32, device=x.device)
    bn = min(block, ceil_mult(n, 128)) or 1
    for j in range(0, n, bn):
        acc += x[:, j:j + bn].sum(dim=1, keepdim=True, dtype=torch.float32)
    return acc.to(x.dtype)


def _chunks(others, length, least, device):
    """Chunks to cut the reduced axis into: enough blocks to keep ~4 an
    SM in flight, each chunk at least ``least`` long."""
    from veles_tpu_torch.ops.common import sm_count
    want = -(-4 * sm_count(device) // max(others, 1))
    return max(1, min(want, -(-length // least), _MAX_CHUNKS))


def _launch(x, rows, counter):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_reduce",
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 +
            [ctypes.c_int] * 4 + [ctypes.c_void_p])
    m, n = x.shape
    if rows:
        out = torch.empty((m, 1), dtype=x.dtype, device=x.device)
        chunks = _chunks(m, n, _MIN_COLS, x.device)
        partial = torch.empty((m, chunks), dtype=torch.float32,
                              device=x.device)
    else:
        out = torch.empty((1, n), dtype=x.dtype, device=x.device)
        chunks = _chunks(-(-n // _THREADS), m, _MIN_ROWS, x.device)
        partial = torch.empty((chunks, n), dtype=torch.float32,
                              device=x.device)
    if m == 0 or n == 0:
        return out.zero_()
    code = fn(x.data_ptr(), partial.data_ptr(), out.data_ptr(), m, n,
              chunks, int(rows), _CODES[x.dtype], x.device.index,
              current_stream(x.device))
    check_launch(code, "reduce_rows" if rows else "reduce_cols")
    counter.launches += 1
    return out


def _dispatch(x, block, rows):
    _check(x, block)
    fn = reduce_rows if rows else reduce_cols
    if x.device.type == "cpu":
        plain = reduce_rows_reference if rows else reduce_cols_reference
        return plain(x, block)
    if x.device.type != "cuda":
        raise ValueError("reduce runs on CUDA or CPU tensors, got %s"
                         % x.device)
    if x.dtype not in _CODES:
        raise TypeError("the reduce kernel takes float32, bfloat16 or "
                        "float16 input, got %s" % x.dtype)
    if not x.is_contiguous():
        raise ValueError("reduce expects a contiguous x")
    return _launch(x, rows, fn)


def reduce_cols(x, block=512):
    """Column sums: (M, N) -> (1, N) in ``x.dtype``.  A CUDA call
    launches the kernel and adds one to ``reduce_cols.launches``; a CPU
    call runs :func:`reduce_cols_reference`.  Anything else raises."""
    return _dispatch(x, block, rows=False)


def reduce_rows(x, block=512):
    """Row sums: (M, N) -> (M, 1) in ``x.dtype``.  A CUDA call launches
    the kernel and adds one to ``reduce_rows.launches``; a CPU call runs
    :func:`reduce_rows_reference`.  Anything else raises."""
    return _dispatch(x, block, rows=True)


_launch.fn = None

#: kernel launches since the last reset (plain counters: the smoke run
#: zeroes them before driving the ops path and reads them after)
reduce_cols.launches = 0
reduce_rows.launches = 0
