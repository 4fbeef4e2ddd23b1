"""The port's column and row sums (veles_tpu_torch/ops/reduce.py) against
the JAX package's (veles_tpu/ops/reduce.py).

On the CPU ``reduce_cols`` / ``reduce_rows`` run their plain PyTorch
versions (float32 sums of ``block``-row or -column blocks, added in block
order); the JAX ops run their Pallas kernels in interpret mode on the
same seeded inputs, at several ``block`` values.  float32 sums agree
within rtol 1e-5 (the two sum a block in different orders); bfloat16
sums within 1 bf16 ulp.  The ``cuda`` tests hold the CUDA kernel
against the plain version and a float64 sum on a card and skip where
there is none."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import common
from veles_tpu_torch.ops import reduce as reduce_module
from veles_tpu_torch.ops.reduce import (plan_reduce_cols, plan_reduce_rows,
                                        reduce_cols, reduce_cols_reference,
                                        reduce_rows, reduce_rows_reference)

SHAPES = [(300, 70), (100, 500), (1, 1), (7, 3), (33, 129), (1030, 9)]
BLOCKS = [8, 64, 512]


def _operand(shape, seed):
    return numpy.random.RandomState(seed).rand(*shape).astype(numpy.float32)


def _jax(name):
    from veles_tpu.ops import reduce as jax_reduce
    return getattr(jax_reduce, name)


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(numpy.int64)
    return numpy.asarray(x).view(numpy.int16).astype(numpy.int64)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["reduce_cols", "reduce_rows"])
def test_f32_matches_jax(name, shape, block):
    import jax.numpy as jnp
    x = _operand(shape, shape[0] * 7 + block)
    port = reduce_cols if name == "reduce_cols" else reduce_rows
    got = port(torch.from_numpy(x), block=block)
    want = numpy.asarray(_jax(name)(jnp.asarray(x), block=block))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    axis = 0 if name == "reduce_cols" else 1
    oracle = x.astype(numpy.float64).sum(axis=axis, keepdims=True)
    numpy.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5)


@pytest.mark.parametrize("block", [8, 512])
@pytest.mark.parametrize("shape", [(300, 70), (33, 129)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["reduce_cols", "reduce_rows"])
def test_bf16_within_one_ulp_of_jax(name, shape, block):
    import jax.numpy as jnp
    x = _operand(shape, 5)
    port = reduce_cols if name == "reduce_cols" else reduce_rows
    got = port(torch.from_numpy(x).to(torch.bfloat16), block=block)
    want = _jax(name)(jnp.asarray(x).astype(jnp.bfloat16), block=block)
    assert got.dtype == torch.bfloat16
    assert numpy.abs(_bf16_bits(got) - _bf16_bits(want)).max() <= 1


def test_plain_versions_sum_in_block_order():
    """Blocks of ``block`` rows (columns) are summed, then added in order
    into a float32 accumulator: one row at a time, 2**24 absorbs each 1;
    two at a time, the 1s meet first and survive."""
    x = torch.tensor([[2.0 ** 24], [0.0], [1.0], [1.0]])
    assert reduce_cols_reference(x, block=1).item() == 2.0 ** 24
    assert reduce_cols_reference(x, block=2).item() == 2.0 ** 24 + 2
    assert reduce_rows_reference(x.t(), block=1).item() == 2.0 ** 24
    assert reduce_rows_reference(x.t(), block=2).item() == 2.0 ** 24 + 2


def test_errors():
    with pytest.raises(ValueError):
        reduce_cols(torch.ones(3))
    with pytest.raises(ValueError):
        reduce_rows(torch.ones(3, 4), block=0)
    with pytest.raises(TypeError):
        reduce_rows(numpy.ones((3, 4)))


@pytest.mark.parametrize("shape", [(0, 5), (5, 0)])
def test_empty(shape):
    assert not reduce_cols(torch.ones(shape)).any()
    assert tuple(reduce_cols(torch.ones(shape)).shape) == (1, shape[1])
    assert tuple(reduce_rows(torch.ones(shape)).shape) == (shape[0], 1)


@pytest.mark.parametrize("shape,itemsize,want", [
    ((3001, 3001), 4, ("whole_row", 2, 1)),
    ((4096, 4096), 2, ("whole_row", 4, 1)),
    ((32, 25088), 4, ("split", 1, 17)),
    ((32, 25088), 2, ("split", 1, 17)),
    ((100, 784), 4, ("whole_row", 2, 1)),
    ((100, 784), 2, ("whole_row", 2, 1)),
    ((33, 129), 4, ("whole_row", 4, 1)),
    ((33, 129), 2, ("whole_row", 8, 1)),
    ((60000, 784), 4, ("whole_row", 8, 1)),
    ((1, 1), 4, ("whole_row", 8, 1)),
    ((1, 10 ** 7), 4, ("split", 1, 528)),
    ((527, 2048), 4, ("split", 1, 2)),
    ((528, 2048), 4, ("whole_row", 4, 1))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plan_reduce_rows(shape, itemsize, want):
    """Split rows only while fewer than 4 blocks an SM would run (so
    fewer rows than the 4 * 132 tickets), each chunk at least 1,024
    wide; else as few warps a row as give a lane one round of <= 8
    16-byte loads, more while rows * warps < 2 * 132 and each lane
    still loads."""
    assert plan_reduce_rows(*shape, itemsize, 132) == want


@pytest.mark.parametrize("shape,itemsize,want", [
    ((3001, 3001), 4, ("split_col", 124, 10)),
    ((60000, 784), 4, ("split_col", 128, 37)),
    ((4096, 4096), 2, ("split_col", 256, 16)),
    ((32, 25088), 4, ("whole_col", 128, 1)),
    ((100, 784), 4, ("whole_col", 128, 1)),
    ((100, 784), 2, ("whole_col", 256, 1)),
    ((33, 129), 4, ("whole_col", 124, 1)),
    ((7, 3), 4, ("whole_col", 124, 1)),
    ((1, 1), 4, ("whole_col", 124, 1)),
    ((4, 10 ** 6), 4, ("whole_col", 128, 1)),
    ((10 ** 6, 4), 4, ("split_col", 128, 264)),
    ((10 ** 6, 3), 2, ("split_col", 248, 264)),
    ((256, 16896), 4, ("split_col", 128, 2)),
    ((256, 16900), 4, ("whole_col", 128, 1))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plan_reduce_cols(shape, itemsize, want):
    """Tiles of 32 lanes of 16 bytes where the rows start on 16-byte
    boundaries, else of 31 (rows of 3,001, 129 or 3 f32, or a base off
    the boundary); rows split into as many chunks as give ~2 blocks an
    SM (132 SMs), each at least 128 rows, so only while the tiles are at
    most 132 and a split takes at most 4 * 132 tickets, one a tile."""
    got = plan_reduce_cols(*shape, itemsize, 132)
    assert got == want
    design, tile, chunks = got
    tiles = -(-shape[1] // tile)
    assert tiles * chunks <= 2 * 132 or chunks == 1
    if design == "split_col":
        assert tiles <= 4 * 132 and chunks > 1
        assert shape[0] // chunks >= 128
    assert plan_reduce_cols(*shape, itemsize, 132, ptr=4)[1] == \
        31 * 16 // itemsize


@pytest.mark.parametrize("shape,path", [((32, 25088), "split"),
                                        ((3001, 3001), "whole_row"),
                                        ((33, 129), "whole_row"),
                                        ((1000, 784), "split_col"),
                                        ((32, 25088), "whole_col"),
                                        ((33, 129), "whole_col")])
def test_design_reaches_the_kernel(monkeypatch, shape, path):
    """The C entry gets the plan: a split design a scratch, the
    stream's tickets (zeroed once, kept, shared by row and column sums)
    and one row a block (rows) or the lanes a tile (columns); a whole
    design no scratch and no tickets.  The path counts."""
    from test_torch_gather import patch_recording_launch
    calls = patch_recording_launch(monkeypatch)
    monkeypatch.setattr(common, "sm_count", lambda d: 132)
    monkeypatch.setattr(reduce_module._launch, "fn", None)
    monkeypatch.setattr(reduce_module, "_TICKETS", {})
    rows = path in reduce_rows.paths
    kernel = reduce_rows if rows else reduce_cols
    x = torch.zeros(shape)
    before, paths = kernel.launches, dict(kernel.paths)
    for _ in range(2):
        reduce_module._launch(x, rows, kernel)
    assert kernel.launches == before + 2
    assert kernel.paths[path] == paths[path] + 2
    (_, partial, tickets, _, m, n, chunks_arg, rows_arg, layout, code,
     _, stream) = calls[0]
    assert (m, n, rows_arg, code, stream) == (*shape, int(rows), 0, 0)
    if rows:
        design, per_block, chunks = plan_reduce_rows(*shape, 4, 132)
        assert 1 << layout == per_block
    else:
        design, tile, chunks = plan_reduce_cols(*shape, 4, 132,
                                                x.data_ptr())
        assert layout * 4 == tile
    assert (design, chunks_arg) == (path, chunks)
    if path.startswith("split"):
        assert partial is not None and tickets is not None
        assert list(reduce_module._TICKETS) == [(None, 0)]
        held = reduce_module._TICKETS[(None, 0)]
        assert held.dtype == torch.int32 and held.numel() == 4 * 132
        assert tickets == calls[1][2] == held.data_ptr()
        # the other kind's split takes the same array
        other = torch.zeros((1000, 8) if rows else (4, 4096))
        reduce_module._launch(other, not rows,
                              reduce_cols if rows else reduce_rows)
        assert calls[2][6] > 1 and calls[2][2] == held.data_ptr()
        assert list(reduce_module._TICKETS) == [(None, 0)]
    else:
        assert partial is None and tickets is None
        assert reduce_module._TICKETS == {}


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _max_rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", SHAPES + [(60000, 784), (32, 25088),
                                            (3001, 3001), (100, 784)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["reduce_cols", "reduce_rows"])
def test_cuda_kernel_matches_plain_version(cuda_card, name, shape, dtype,
                                           offset):
    """offset 1: x a view one element into its storage, off the 16-byte
    boundary (the column sums' one-column lanes)."""
    m, n = shape
    flat = torch.from_numpy(_operand((m * n + offset,), 3)).to(cuda_card)
    x = flat.to(getattr(torch, dtype))[offset:].view(shape)
    port = reduce_cols if name == "reduce_cols" else reduce_rows
    plain = reduce_cols_reference if name == "reduce_cols" else \
        reduce_rows_reference
    before = port.launches
    got, again, want = port(x), port(x), plain(x)
    torch.cuda.synchronize()
    assert port.launches == before + 2
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, again)
    exact = x.double().sum(dim=0 if name == "reduce_cols" else 1,
                           keepdim=True)
    if dtype == "float32":
        assert _max_rel(got, exact) <= 1e-5
        assert _max_rel(got, want) <= 1e-5
    else:
        rounded = exact.to(x.dtype)
        bits = torch.int16
        assert (got.view(bits).long() -
                rounded.view(bits).long()).abs().max().item() <= 1


@pytest.mark.cuda
def test_cuda_rejects_other_dtypes(cuda_card):
    with pytest.raises(TypeError):
        reduce_cols(torch.ones(3, 4, dtype=torch.float64, device=cuda_card))
    with pytest.raises(ValueError):
        reduce_rows(torch.ones(4, 3, device=cuda_card).t())


def _card_operand(card, shape, dtype, offset=0):
    """A seeded (m, n) operand on the card, ``offset`` elements into its
    storage (the rows then start off a 16-byte boundary)."""
    m, n = shape
    flat = torch.from_numpy(_operand((m * n + offset,), m + n)).to(card)
    return flat.to(getattr(torch, dtype))[offset:].view(shape)


def _assert_sums(got, x):
    exact = x.double().sum(dim=1, keepdim=True)
    if x.dtype == torch.float32:
        assert _max_rel(got, exact) <= 1e-5
        assert _max_rel(got, reduce_rows_reference(x)) <= 1e-5
    else:
        bits = torch.int16
        assert (got.view(bits).long() -
                exact.to(x.dtype).view(bits).long()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape,path", [
    ((3001, 3001), "whole_row"), ((32, 25088), "split"),
    ((1, 100003), "split"), ((1, 1), "whole_row"), ((1, 7), "whole_row"),
    ((5, 3001), "split"), ((200, 129), "whole_row"),
    ((100, 784), "whole_row"), ((700, 2050), "whole_row")],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_cuda_row_designs(cuda_card, shape, path, dtype, offset):
    """Both designs, one row, widths that are not multiples of 4 or 8
    and rows starting off 16-byte boundaries: f32 within 1e-5 of float64
    and of the plain version, bf16/f16 within 1 ulp of float64, the same
    bits twice, one launch a call on the design planned."""
    x = _card_operand(cuda_card, shape, dtype, offset)
    before, paths = reduce_rows.launches, dict(reduce_rows.paths)
    got, again = reduce_rows(x), reduce_rows(x)
    torch.cuda.synchronize()
    assert reduce_rows.launches == before + 2
    assert reduce_rows.paths[path] == paths[path] + 2
    assert got.dtype == x.dtype and tuple(got.shape) == (shape[0], 1)
    assert torch.equal(got, again)
    _assert_sums(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [
    (3001, 3001), (60000, 784), (4096, 4096), (32, 25088), (100, 784),
    (33, 129), (7, 3), (1, 1), (5, 10 ** 5), (10 ** 5, 8), (300, 1031)],
    ids=lambda s: "x".join(map(str, s)))
def test_cuda_col_designs(cuda_card, shape, dtype, offset):
    """Both designs and both tiles (32 lanes, or 31 at their warps'
    skews), tiles cut by the width, rows fewer than the warps, and views
    off the 16-byte boundary: f32 within 1e-5 of float64 and of the
    plain version, bf16/f16 within 1 ulp of float64, the same bits
    twice, one launch a call on the design and tile planned, the
    tickets left at zero."""
    x = _card_operand(cuda_card, shape, dtype, offset)
    path, tile, _ = plan_reduce_cols(
        *shape, x.element_size(), common.sm_count(cuda_card), x.data_ptr())
    lanes = tile * x.element_size() // 16
    assert (lanes == 31) == (offset == 1 or shape[1] * x.element_size() % 16
                             != 0)
    before, paths = reduce_cols.launches, dict(reduce_cols.paths)
    got, again = reduce_cols(x), reduce_cols(x)
    torch.cuda.synchronize()
    assert reduce_cols.launches == before + 2
    assert reduce_cols.paths[path] == paths[path] + 2
    assert got.dtype == x.dtype and tuple(got.shape) == (1, shape[1])
    assert torch.equal(got, again)
    exact = x.double().sum(dim=0, keepdim=True)
    if x.dtype == torch.float32:
        assert _max_rel(got, exact) <= 1e-5
        assert _max_rel(got, reduce_cols_reference(x)) <= 1e-5
    else:
        bits = torch.int16
        assert (got.view(bits).long() -
                exact.to(x.dtype).view(bits).long()).abs().max().item() <= 1
    stream = torch.cuda.current_stream(cuda_card).cuda_stream
    held = reduce_module._TICKETS.get((cuda_card.index, stream))
    assert held is None or not held.any()


@pytest.mark.cuda
def test_cuda_tickets_stay_zero(cuda_card):
    """The split design leaves its tickets at zero, on the default stream
    and on a second stream, which gets tickets of its own."""
    x = _card_operand(cuda_card, (32, 25088), "float32")
    got = reduce_rows(x)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_card).cuda_stream
    held = reduce_module._TICKETS[(cuda_card.index, stream)]
    assert not held.any()
    side = torch.cuda.Stream(cuda_card)
    side.wait_stream(torch.cuda.current_stream(cuda_card))
    with torch.cuda.stream(side):
        again = reduce_rows(x)
    torch.cuda.synchronize()
    other = reduce_module._TICKETS[(cuda_card.index, side.cuda_stream)]
    assert other.data_ptr() != held.data_ptr()
    assert not other.any() and not held.any()
    assert torch.equal(got, again)
    _assert_sums(got, x)
