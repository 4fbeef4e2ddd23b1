"""The port's max-pool backward (veles_tpu_torch/ops/pool_bwd.py)
against the JAX package's ``max_pool_bwd``, whose Pallas kernel runs in
interpret mode on the CPU.

On CPU tensors the port's wrapper runs its plain version, so these
tests hold the plain version to the reference.  Routing compares values
exactly, so it is bit-exact: with representable cotangents (small
integers, whose sums are exact) the outputs are bit-equal for every
case, overlapping windows, ties and ceil-mode tails included; with
random cotangents they are bit-equal where windows do not overlap and
within 1e-6 elsewhere.  The CUDA kernel itself is held to the plain
version on the card by the ``cuda`` tests below and ``chip_smoke.py``."""

import numpy
import pytest
import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import pool_bwd
from veles_tpu_torch.ops.pool_bwd import (max_pool, max_pool_bwd,
                                          max_pool_bwd_reference)

#: tests/test_pallas_bwd.py:224-231, plus AlexNet's 3x3/2 at 13x13
CASES = [
    ((2, 8, 8, 3), (2, 2), (2, 2), False),     # VGG-style non-overlap
    ((2, 9, 9, 3), (3, 3), (2, 2), True),      # AlexNet overlap + ceil
    ((1, 5, 5, 2), (2, 2), (2, 2), False),     # odd input, ceil tail
    ((2, 6, 6, 130), (2, 2), (2, 2), False),   # channels past one lane
    ((1, 4, 4, 1), (4, 4), (4, 4), False),     # window == input
    ((2, 7, 7, 5), (3, 3), (1, 1), True),      # dense overlap
    ((1, 13, 13, 6), (3, 3), (2, 2), True),    # AlexNet pool geometry
    ((1, 7, 4, 2), (3, 2), (3, 1), True),      # (kx, ky) != (sx, sy)
]
IDS = ["vgg", "alexnet_ceil", "odd_ceil", "130_channels", "whole",
       "dense", "alexnet_13", "rect"]


def _forward(x, window, sliding):
    """y from the port's forward (bit-equal to the JAX one, see
    tests/test_torch_models.py)."""
    from veles_tpu_torch.models.pooling import _pool
    return _pool(torch.from_numpy(x), window, sliding, float("-inf"),
                 F.max_pool2d).contiguous().numpy()


def _jax(x, y, dy, window, sliding):
    from veles_tpu.ops.pool_bwd import max_pool_bwd as jax_pool_bwd
    return numpy.asarray(jax_pool_bwd(x, y, dy, window=window,
                                      sliding=sliding))


def _port(x, y, dy, window, sliding):
    return max_pool_bwd(*(torch.from_numpy(numpy.array(t))
                          for t in (x, y, dy)),
                        window=window, sliding=sliding).numpy()


@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_bit_exact_on_representable_cotangents(shape, window, sliding,
                                               overlap):
    rng = numpy.random.RandomState(11)
    x = rng.randn(*shape).astype(numpy.float32)
    y = _forward(x, window, sliding)
    dy = rng.randint(-8, 9, y.shape).astype(numpy.float32) / 4
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    assert got.shape == x.shape and got.dtype == numpy.float32
    assert (got == want).all()


@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_random_cotangents(shape, window, sliding, overlap):
    rng = numpy.random.RandomState(12)
    x = rng.randn(*shape).astype(numpy.float32)
    y = _forward(x, window, sliding)
    dy = rng.randn(*y.shape).astype(numpy.float32)
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    if overlap:
        numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (got == want).all()


@pytest.mark.parametrize("window,sliding", [((3, 3), (2, 2)),
                                            ((2, 2), (2, 2))])
def test_ties_route_to_the_first_match(window, sliding):
    """All-equal and all-zero (ReLU) windows: first-match routing in
    row-major window order, as XLA's select-and-scatter."""
    rng = numpy.random.RandomState(2)
    x = numpy.ones((1, 6, 6, 2), numpy.float32)
    x[0, :, :3] = 0.0
    y = _forward(x, window, sliding)
    dy = rng.randint(-8, 9, y.shape).astype(numpy.float32) / 4
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    assert (got == want).all()


def test_autograd_function_matches_torch_autograd():
    """max_pool's gradient (the select-and-scatter backward) against
    torch autograd of the plain forward, on inputs without ties."""
    from veles_tpu_torch.models.pooling import _pool
    rng = numpy.random.RandomState(3)
    x0 = torch.from_numpy(rng.randn(2, 9, 8, 3).astype(numpy.float32))
    grads = []
    for fused in (True, False):
        x = x0.clone().requires_grad_(True)
        if fused:
            y = max_pool(x, window=(2, 2), sliding=(2, 2))
        else:
            y = _pool(x, (2, 2), (2, 2), float("-inf"), F.max_pool2d)
        (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
         ).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def test_plain_version_does_not_count_launches():
    x = torch.zeros(1, 4, 4, 2)
    y = torch.zeros(1, 2, 2, 2)
    before = max_pool_bwd.launches
    max_pool_bwd(x, y, y, window=(2, 2), sliding=(2, 2))
    assert max_pool_bwd.launches == before


@pytest.mark.parametrize("case", ["y_shape", "dy_shape", "rank"])
def test_wrapper_refuses_bad_shapes(case):
    x = torch.zeros(1, 4, 4, 2)
    y = dy = torch.zeros(1, 2, 2, 2)
    if case == "y_shape":
        y = torch.zeros(1, 3, 2, 2)
    elif case == "dy_shape":
        dy = torch.zeros(1, 2, 2, 3)
    else:
        x = torch.zeros(4, 4, 2)
    with pytest.raises(ValueError):
        max_pool_bwd(x, y, dy, window=(2, 2), sliding=(2, 2))


def test_failed_build_raises(monkeypatch, tmp_path):
    from test_torch_gather import patch_failing_build
    patch_failing_build(monkeypatch, tmp_path)
    monkeypatch.setattr(pool_bwd._launch, "fn", None)
    x, y = torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 2)
    before = max_pool_bwd.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pool_bwd._launch(x, y, y, 2, 2, 2, 2)
    assert max_pool_bwd.launches == before


def test_failed_launch_raises(monkeypatch):
    from test_torch_gather import FakeLibrary, patch_failing_launch
    patch_failing_launch(monkeypatch)
    monkeypatch.setattr(pool_bwd._launch, "fn", None)
    x, y = torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 2)
    before, calls = max_pool_bwd.launches, FakeLibrary.calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pool_bwd._launch(x, y, y, 2, 2, 2, 2)
    assert FakeLibrary.calls == calls + 1
    assert max_pool_bwd.launches == before


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version(cuda_card, shape, window,
                                           sliding, overlap):
    rng = numpy.random.RandomState(13)
    x = rng.randn(*shape).astype(numpy.float32)
    x[..., :1] = numpy.maximum(x[..., :1], 0.0)   # ReLU ties
    y = _forward(x, window, sliding)
    dy = rng.randn(*y.shape).astype(numpy.float32)
    x, y, dy = (torch.from_numpy(t).to(cuda_card) for t in (x, y, dy))
    before = max_pool_bwd.launches
    got = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    again = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    assert max_pool_bwd.launches == before + 2
    want = max_pool_bwd_reference(x, y, dy, window=window,
                                  sliding=sliding)
    assert torch.equal(got, again) and torch.equal(got, want)
