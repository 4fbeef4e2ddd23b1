"""The port's minibatch gather (veles_tpu_torch/ops/gather.py) against
the JAX package's ``gather_minibatch``, whose Pallas kernel runs in
interpret mode on the CPU for lane-aligned widths (256) and whose
``jnp.take`` path serves the others (784).

On CPU tensors the port's wrapper runs its plain version, so these
tests hold the plain version to the reference: a gather and a cast are
exact, so the two agree bit for bit.  Out-of-range indices are clamped
into [0, N) by the kernel and the plain version alike (the JAX package
defines no such case); a test pins it.  The CUDA kernel itself is held
to the plain version on the card by the ``cuda`` tests below and
``chip_smoke.py``."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import common, gather
from veles_tpu_torch.ops.gather import (gather_labels, gather_minibatch,
                                        gather_minibatch_reference)

DTYPES = {"f32": (numpy.float32, torch.float32),
          "u8": (numpy.uint8, torch.uint8),
          "i32": (numpy.int32, torch.int32)}


def _dataset(rng, n, width, dtype):
    if dtype == numpy.float32:
        return rng.randn(n, width).astype(dtype)
    return rng.randint(0, 200, (n, width)).astype(dtype)


@pytest.mark.parametrize("width", [256, 784])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_gather_bit_equal_to_jax(width, dtype):
    from veles_tpu.ops.gather import gather_minibatch as jax_gather
    np_dtype, _ = DTYPES[dtype]
    rng = numpy.random.RandomState(0)
    data = _dataset(rng, 40, width, np_dtype)
    idx = rng.randint(0, 40, 16).astype(numpy.int32)
    want = numpy.asarray(jax_gather(data, idx, out_dtype=numpy.float32))
    got = gather_minibatch(torch.from_numpy(data), torch.from_numpy(idx),
                           torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.numpy() == want).all()


def test_sample_shape_kept_and_default_dtype():
    from veles_tpu.ops.gather import gather_minibatch as jax_gather
    rng = numpy.random.RandomState(1)
    data = rng.randn(12, 4, 8, 4).astype(numpy.float32)
    idx = numpy.array([3, 0, 11, 3, 7], numpy.int32)
    want = numpy.asarray(jax_gather(data, idx))
    got = gather_minibatch(torch.from_numpy(data), torch.from_numpy(idx))
    assert tuple(got.shape) == (5, 4, 8, 4) and got.dtype == torch.float32
    assert (got.numpy() == want).all()


def test_labels_match_jax():
    from veles_tpu.ops.gather import gather_labels as jax_labels
    rng = numpy.random.RandomState(2)
    labels = rng.randint(0, 10, 30).astype(numpy.int32)
    idx = rng.randint(0, 30, 9).astype(numpy.int32)
    want = numpy.asarray(jax_labels(labels, idx))
    got = gather_labels(torch.from_numpy(labels), torch.from_numpy(idx))
    assert (got.numpy() == want).all()


def test_out_of_range_indices_are_clamped():
    """An index outside [0, N) takes the nearest row: it never reads
    outside the dataset."""
    data = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    idx = torch.tensor([-7, -1, 0, 4, 5, 99], dtype=torch.int32)
    got = gather_minibatch(data, idx)
    want = data[[0, 0, 0, 4, 4, 4]]
    assert torch.equal(got, want)
    huge = torch.tensor([2 ** 40, -2 ** 40], dtype=torch.int64)
    assert torch.equal(gather_minibatch(data, huge), data[[4, 0]])
    assert torch.equal(gather_labels(torch.arange(5), idx),
                       torch.tensor([0, 0, 0, 4, 4, 4]))


def test_int64_indices_equal_int32():
    rng = numpy.random.RandomState(3)
    data = torch.from_numpy(rng.randn(20, 7).astype(numpy.float32))
    idx = torch.from_numpy(rng.randint(0, 20, 11))
    assert torch.equal(gather_minibatch(data, idx),
                       gather_minibatch(data, idx.to(torch.int32)))


def test_plain_version_does_not_count_launches():
    before = gather_minibatch.launches
    gather_minibatch(torch.zeros(4, 3), torch.tensor([1, 2]))
    assert gather_minibatch.launches == before


@pytest.mark.parametrize("case", ["two_d_indices", "float_indices",
                                  "empty_dataset"])
def test_wrapper_refuses_bad_operands(case):
    data, idx = torch.zeros(4, 3), torch.tensor([0, 1])
    if case == "two_d_indices":
        idx = idx[None]
    elif case == "float_indices":
        idx = idx.float()
    else:
        data = torch.zeros(0, 3)
    with pytest.raises(ValueError):
        gather_minibatch(data, idx)


def patch_failing_build(monkeypatch, tmp_path):
    """No library is built yet and nvcc fails."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(common, "_nvcc", no_nvcc)
    monkeypatch.setattr(common, "_library", None)
    monkeypatch.setattr(common, "BUILD_DIR", str(tmp_path))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A CUDA call builds the kernels or raises: no quiet fallback."""
    patch_failing_build(monkeypatch, tmp_path)
    monkeypatch.setattr(gather._launch, "fn", None)
    before = gather_minibatch.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        gather._launch(torch.zeros(4, 3), torch.tensor([1], dtype=torch.int32),
                       torch.float32)
    assert gather_minibatch.launches == before


class FakeLibrary(object):
    """Stands in for the built library: every kernel entry point
    reports a CUDA error."""

    calls = 0

    @staticmethod
    def veles_error_string(code):
        return b"an illegal memory access was encountered"

    def __getattr__(self, name):
        def entry(*args):
            FakeLibrary.calls += 1
            return 700
        return entry


def patch_failing_launch(monkeypatch):
    fake = FakeLibrary()
    monkeypatch.setattr(common, "load_kernels", lambda: fake)
    monkeypatch.setattr(common, "current_stream", lambda device: 0)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)


def test_failed_launch_raises(monkeypatch):
    patch_failing_launch(monkeypatch)
    monkeypatch.setattr(gather._launch, "fn", None)
    before, calls = gather_minibatch.launches, FakeLibrary.calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        gather._launch(torch.zeros(4, 3), torch.tensor([1], dtype=torch.int32),
                       torch.float32)
    assert FakeLibrary.calls == calls + 1
    assert gather_minibatch.launches == before


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [784, 783, 256, 5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_plain_version(cuda_card, width, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    rng = numpy.random.RandomState(4)
    data = torch.from_numpy(_dataset(rng, 33, width, np_dtype)).to(cuda_card)
    idx = torch.from_numpy(numpy.concatenate([
        rng.randint(0, 33, 20), [-5, 33, 1000]]).astype(numpy.int32)).to(
            cuda_card)
    for out_dtype in {t_dtype, torch.float32}:
        before = gather_minibatch.launches
        got = gather_minibatch(data, idx, out_dtype)
        again = gather_minibatch(data, idx, out_dtype)
        assert gather_minibatch.launches == before + 2
        want = gather_minibatch_reference(data, idx, out_dtype)
        assert torch.equal(got, want) and torch.equal(got, again)
