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

Each call is one launch.  The column sums take the design that
:func:`plan_reduce_cols` chooses: a block sums a tile of columns (a
lane loads 16 bytes of a row, 4 f32 or 8 bf16/f16 columns; 32 lanes'
columns where the rows start on 16-byte boundaries, else 31, read from
the boundary before them) over a chunk of rows, "whole_col" (one
chunk: the block writes its tile) or, when the
tiles are too few to fill the card, "split_col" (blocks share a tile;
the last to finish, found by a per-tile ticket, adds the partials in
chunk order and sets its ticket back to 0).  The row sums take the
design that :func:`plan_reduce_rows` chooses: "whole_row" (a warp, a
few warps or a block sums a row and writes it) or, for few long rows,
"split" (blocks share a row, with a per-row ticket).  Row and column
launches share one ticket array per (device, stream), allocated and
zeroed once.  ``block`` has no effect on the kernel.
"""

import ctypes

import torch

from veles_tpu_torch import graphs
from veles_tpu_torch.ops.common import ceil_mult

__all__ = ["reduce_cols", "reduce_rows", "reduce_cols_reference",
           "reduce_rows_reference", "plan_reduce_cols", "plan_reduce_rows"]

#: dtype codes of csrc/reduce.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: threads of a kernel block (csrc/reduce.cu THREADS)
_THREADS = 256
#: the least rows (columns) a chunk of the column (row) sums takes (the
#: column sums: two rounds of a block's 8 warps with 8 rows in flight)
_MIN_ROWS, _MIN_COLS = 128, 1024
_MAX_CHUNKS = 65535
#: 16-byte loads a lane of the row sums keeps in flight
#: (csrc/reduce.cu UNROLL_ROWS)
_ROW_LOADS = 8


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


def _chunks(others, length, least, sms):
    """Chunks to cut the reduced axis into: enough blocks to keep ~4 an
    SM in flight, each chunk at least ``least`` long."""
    want = -(-4 * sms // max(others, 1))
    return max(1, min(want, -(-length // least), _MAX_CHUNKS))


def plan_reduce_cols(m, n, itemsize, sms, ptr=0):
    """(design, columns a block, chunks) of the column-sum kernel for an
    (m, n) input of ``itemsize``-byte elements at address ``ptr`` on a
    card of ``sms`` SMs.

    A lane reads a 16-byte word a row (4 f32 or 8 bf16/f16 columns). A
    block takes a tile of 32 lanes' columns when every row starts on a
    16-byte boundary, else of 31 (its warps read 32 words from the
    boundary before the tile, each at its rows' own skew).  The rows
    are split over blocks ("split_col") into as many chunks as give ~2
    blocks an SM, each at least ``_MIN_ROWS`` rows (on an H100, 2 beat
    1, 3 and 4 at 3001^2 and 60000 x 784 f32, and came within 1.5 % of
    1 at 4096^2 bf16); that splits only while
    the tiles are at most sms, so the tickets, one a tile, need at most
    4 * sms entries.  Else a block sums its tile's columns whole
    ("whole_col")."""
    lanes = 31 if (n * itemsize) % 16 or ptr % 16 else 32
    tile = lanes * (16 // itemsize)
    tiles = -(-n // tile)
    chunks = max(1, min(2 * sms // tiles, -(-m // _MIN_ROWS), _MAX_CHUNKS))
    return ("split_col" if chunks > 1 else "whole_col"), tile, chunks


def plan_reduce_rows(m, n, itemsize, sms):
    """(design, rows a block, chunks) of the row-sum kernel for an (m, n)
    input of ``itemsize``-byte elements on a card of ``sms`` SMs.

    A row is split over blocks ("split", one row a block) when there are
    too few rows to keep ~4 blocks an SM in flight and each chunk still
    gets ``_MIN_COLS`` columns (m < 4 * sms, so the tickets need 4 * sms
    entries); else a group of 1, 2, 4 or 8 warps sums each row
    ("whole_row"): as few warps as give each lane at most one round of
    ``_ROW_LOADS`` 16-byte loads, and more while the rows are too few
    to give each SM ~2 warps and each lane still gets a load."""
    chunks = _chunks(m, n, _MIN_COLS, sms)
    if chunks > 1:
        return "split", 1, chunks
    loads = -(-n // (16 // itemsize))
    most = _THREADS // 32
    warps = 1
    while warps < most and warps * 32 * _ROW_LOADS < loads:
        warps *= 2
    while warps < most and m * warps < 2 * sms and warps * 32 < loads:
        warps *= 2
    return "whole_row", most // warps, 1


#: (device index, stream handle) -> int32 tickets of the split row and
#: column sums, zeroed once; every launch leaves them zeroed
_TICKETS = {}


def _tickets(device, stream):
    """The tickets of (device, stream), made on first use.  A capture
    makes them for its stream beforehand (``graphs.register_stream_cache``
    below): made inside one, they would live in its pool and outlive the
    graph, so that raises."""
    from veles_tpu_torch.ops.common import sm_count
    key = (device.index, stream)
    tickets = _TICKETS.get(key)
    if tickets is None:
        if device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("reduce: no tickets for stream %#x; a "
                               "capture makes them before it starts"
                               % stream)
        tickets = _TICKETS[key] = torch.zeros(
            4 * sm_count(device), dtype=torch.int32, device=device)
    return tickets


def _launch(x, rows, counter):
    from veles_tpu_torch.ops.common import (check_launch, current_stream,
                                            kernel_function, sm_count)
    fn = _launch.fn
    if fn is None:
        fn = _launch.fn = kernel_function(
            "veles_reduce",
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 +
            [ctypes.c_int] * 5 + [ctypes.c_void_p])
    m, n = x.shape
    if m == 0 or n == 0:
        return torch.zeros((m, 1) if rows else (1, n), dtype=x.dtype,
                           device=x.device)
    stream = current_stream(x.device)
    sms = sm_count(x.device)
    partial = tickets = None
    if rows:
        out = torch.empty((m, 1), dtype=x.dtype, device=x.device)
        path, per_block, chunks = plan_reduce_rows(m, n, x.element_size(),
                                                   sms)
        layout = per_block.bit_length() - 1
        scratch = (m, chunks)
    else:
        out = torch.empty((1, n), dtype=x.dtype, device=x.device)
        path, tile, chunks = plan_reduce_cols(m, n, x.element_size(), sms,
                                              x.data_ptr())
        layout = tile * x.element_size() // 16
        scratch = (chunks, ceil_mult(n, tile))
    if chunks > 1:
        partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, stream)
    code = fn(x.data_ptr(), _ptr(partial), _ptr(tickets), out.data_ptr(),
              m, n, chunks, int(rows), layout, _CODES[x.dtype],
              x.device.index, stream)
    check_launch(code, "reduce_rows" if rows else "reduce_cols")
    counter.launches += 1
    counter.paths[path] += 1
    return out


def _ptr(tensor):
    return None if tensor is None else tensor.data_ptr()


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
    launches the kernel and adds one to ``reduce_cols.launches`` and to
    the design it took in ``reduce_cols.paths``; a CPU call runs
    :func:`reduce_cols_reference`.  Anything else raises."""
    return _dispatch(x, block, rows=False)


def reduce_rows(x, block=512):
    """Row sums: (M, N) -> (M, 1) in ``x.dtype``.  A CUDA call launches
    the kernel and adds one to ``reduce_rows.launches`` and to the
    design it took in ``reduce_rows.paths``; a CPU call runs
    :func:`reduce_rows_reference`.  Anything else raises."""
    return _dispatch(x, block, rows=True)


_launch.fn = None

#: kernel launches since the last reset (plain counters: the smoke run
#: zeroes them before driving the ops path and reads them after)
reduce_cols.launches = 0
reduce_rows.launches = 0
#: launches by design (plan_reduce_cols, plan_reduce_rows)
reduce_cols.paths = {"whole_col": 0, "split_col": 0}
reduce_rows.paths = {"whole_row": 0, "split": 0}
#: a captured graph's replays advance the counters too
graphs.register_counters(reduce_cols, reduce_rows)
graphs.register_stream_cache(_tickets)
