"""The port's int8 matmul and conv (veles_tpu_torch/ops/matmul_int8.py)
against the JAX package's Pallas kernel, run in interpret mode on the
CPU as tests/test_quant.py runs it.

On CPU tensors the port's wrapper runs its plain version, so these
tests hold the plain version to the reference.  Contract: with scale 1
and bias 0 the f32 output is the exact int32 sum (|acc| < 2**24 at
these shapes), so the two agree bit for bit; with random per-column
scale and bias they agree to 1 ulp (the JAX epilogue is one FMA, the
port's plain version rounds a float64 epilogue once).  The CUDA kernel
itself is held to the plain version on the card (the ``cuda`` test
below and ``chip_smoke.py``)."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops.matmul_int8 import (conv2d_int8, matmul_int8,
                                             matmul_int8_reference)

pytestmark = pytest.mark.quant

#: the shapes and tiles of tests/test_quant.py's bit-exactness test
SHAPES = [(37, 91, 53, (64, 128, 128)),
          (300, 500, 260, (64, 128, 128)),
          (8, 1024, 128, (32, 128, 128)),
          (129, 257, 385, None)]


def _ulp(got, want):
    got = numpy.ascontiguousarray(got, numpy.float32).view(numpy.int32)
    want = numpy.ascontiguousarray(want, numpy.float32).view(numpy.int32)
    return int(numpy.abs(got.astype(numpy.int64) - want).max())


def _operands(rng, m, k, n):
    a = rng.randint(-127, 128, (m, k)).astype(numpy.int8)
    b = rng.randint(-127, 128, (k, n)).astype(numpy.int8)
    scale = (rng.rand(n) * 0.01).astype(numpy.float32)
    bias = rng.randn(n).astype(numpy.float32)
    return a, b, scale, bias


@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
def test_int32_sum_bit_exact_vs_jax_kernel(m, k, n, blocks):
    from veles_tpu.ops.matmul_int8 import matmul_int8 as jax_matmul_int8
    a, b, _, _ = _operands(numpy.random.RandomState(3), m, k, n)
    assert k * 127 * 127 < 2 ** 24
    want = numpy.asarray(jax_matmul_int8(a, b, numpy.float32(1.0),
                                         blocks=blocks))
    got = matmul_int8(torch.from_numpy(a), torch.from_numpy(b), 1.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert (got.numpy() == want).all()
    exact = a.astype(numpy.int64) @ b.astype(numpy.int64)
    assert (got.numpy() == exact).all()


@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
def test_epilogue_within_one_ulp_of_jax_kernel(m, k, n, blocks):
    from veles_tpu.ops.matmul_int8 import matmul_int8 as jax_matmul_int8
    a, b, scale, bias = _operands(numpy.random.RandomState(4), m, k, n)
    want = numpy.asarray(jax_matmul_int8(a, b, scale, bias,
                                         blocks=blocks))
    got = matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(scale), torch.from_numpy(bias))
    assert _ulp(got.numpy(), want) <= 1


def test_scalar_scale_no_bias_within_one_ulp():
    """The other epilogue arity: a scalar scale and no bias."""
    from veles_tpu.ops.matmul_int8 import matmul_int8 as jax_matmul_int8
    a, b, _, _ = _operands(numpy.random.RandomState(5), 40, 200, 70)
    want = numpy.asarray(jax_matmul_int8(a, b, numpy.float32(0.005),
                                         blocks=(32, 128, 128)))
    got = matmul_int8(torch.from_numpy(a), torch.from_numpy(b), 0.005)
    assert _ulp(got.numpy(), want) <= 1


@pytest.mark.parametrize("padding,sliding", [
    ((0, 0, 0, 0), (1, 1)),
    ((1, 1, 1, 1), (2, 2)),
    ((2, 1, 0, 1), (1, 2)),
    ((0, 2, 1, 0), (2, 1)),
])
def test_conv2d_int8_within_one_ulp_of_jax(padding, sliding):
    """Asymmetric padding, strides (sx, sy) of both orders: the im2col
    order (tap-major, then Cin) must match the HWIO weight reshape."""
    from veles_tpu.ops.matmul_int8 import conv2d_int8 as jax_conv2d_int8
    rng = numpy.random.RandomState(7)
    x = rng.randint(-127, 128, (2, 9, 11, 3)).astype(numpy.int8)
    w = rng.randint(-127, 128, (3, 3, 3, 5)).astype(numpy.int8)
    scale = (rng.rand(5) * 0.01).astype(numpy.float32)
    bias = rng.randn(5).astype(numpy.float32)
    want = numpy.asarray(jax_conv2d_int8(x, w, scale, bias,
                                         padding=padding,
                                         sliding=sliding))
    got = conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(scale), torch.from_numpy(bias),
                      padding=padding, sliding=sliding)
    assert tuple(got.shape) == want.shape
    assert _ulp(got.numpy(), want) <= 1


def test_plain_version_does_not_count_launches():
    before = matmul_int8.launches
    a = torch.ones((4, 8), dtype=torch.int8)
    matmul_int8(a, a.t().contiguous(), 1.0)
    assert matmul_int8.launches == before


def test_plain_version_casts_before_the_product():
    """torch.matmul on int8 would wrap: 127 * 127 * 64 overflows int8
    and int16 alike."""
    a = torch.full((2, 64), 127, dtype=torch.int8)
    b = torch.full((64, 3), 127, dtype=torch.int8)
    out = matmul_int8_reference(a, b, 1.0)
    assert (out == 127 * 127 * 64).all()


@pytest.mark.parametrize("case", ["float_a", "float_b", "int16_b"])
def test_wrapper_refuses_non_int8(case):
    a = torch.zeros((4, 4), dtype=torch.int8)
    b = torch.zeros((4, 4), dtype=torch.int8)
    if case == "float_a":
        a = a.float()
    elif case == "float_b":
        b = b.float()
    else:
        b = b.to(torch.int16)
    with pytest.raises(TypeError):
        matmul_int8(a, b, 1.0)


@pytest.mark.parametrize("case", ["scale_shape", "bias_shape", "one_d",
                                  "k_mismatch", "non_contiguous"])
def test_wrapper_refuses_bad_shapes(case):
    a = torch.zeros((4, 6), dtype=torch.int8)
    b = torch.zeros((6, 5), dtype=torch.int8)
    scale, bias = torch.ones(5), None
    if case == "scale_shape":
        scale = torch.ones(4)
    elif case == "bias_shape":
        bias = torch.zeros(3)
    elif case == "one_d":
        a = torch.zeros(6, dtype=torch.int8)
    elif case == "k_mismatch":
        b = torch.zeros((5, 5), dtype=torch.int8)
    else:
        b = torch.zeros((5, 6), dtype=torch.int8).t()
    with pytest.raises(ValueError):
        matmul_int8(a, b, scale, bias)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_card, m, k, n, blocks):
    a, b, scale, bias = _operands(numpy.random.RandomState(8), m, k, n)
    a, b, scale, bias = (torch.from_numpy(t).to(cuda_card)
                         for t in (a, b, scale, bias))
    before = matmul_int8.launches
    exact = matmul_int8(a, b, 1.0)
    assert torch.equal(exact, matmul_int8_reference(a, b, 1.0))
    got = matmul_int8(a, b, scale, bias)
    want = matmul_int8_reference(a, b, scale, bias)
    assert matmul_int8.launches == before + 2
    assert _ulp(got.cpu().numpy(), want.cpu().numpy()) <= 1
