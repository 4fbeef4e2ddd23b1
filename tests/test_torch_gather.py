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


def patch_recording_launch(monkeypatch):
    """Every kernel entry point records its arguments and succeeds;
    returns the list of recorded argument tuples."""
    calls = []

    class Recording(object):
        def __getattr__(self, name):
            def entry(*args):
                calls.append(args)
                return 0
            return entry

    monkeypatch.setattr(common, "load_kernels", lambda: Recording())
    monkeypatch.setattr(common, "current_stream", lambda device: 0)
    return calls


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_indices_reach_the_kernel_as_they_are(monkeypatch, dtype):
    """The card path hands the kernel the caller's index tensor itself,
    int32 or int64, with its width: no clamp or cast runs on the host
    (each would make a new tensor, and launch on the card)."""
    calls = patch_recording_launch(monkeypatch)
    monkeypatch.setattr(gather._launch, "fn", None)
    data = torch.zeros(40, 784, dtype=torch.uint8)
    idx = torch.tensor([3, -1, 39, 2 ** 31 + 5], dtype=torch.int64).to(
        dtype)
    before = gather_minibatch.launches
    out = gather._kernel(data, idx, torch.float32)
    assert gather_minibatch.launches == before + 1 and len(calls) == 1
    args = calls[0]
    assert args[1] == idx.data_ptr()
    assert args[3:6] == (40, 4, 784)
    assert args[6:10] == (0, 3, idx.element_size(),
                          gather.PATHS.index("vec4"))
    assert args[2] == out.data_ptr() and out.dtype == torch.float32


@pytest.mark.parametrize("width,sizes,src,dst,path", [
    (784, (1, 4), 0, 0, "vec4"),            # MNIST uint8 -> f32
    (150528, (4, 4), 0, 0, "vec4"),         # VGG16 image, f32
    (150528, (1, 4), 0, 0, "vec4"),         # VGG16 image, uint8
    (784, (1, 4), 788, 256, "vec4"),        # a row-offset view
    (784, (1, 1), 2, 0, "scalar"),          # base 2 bytes off
    (784, (4, 4), 4, 0, "scalar"),          # base 4 bytes off
    (8192, (4, 4), 0, 8, "scalar"),         # output 8 bytes off
    (3, (4, 4), 0, 0, "scalar"),            # 12-byte rows
    (1, (1, 1), 0, 0, "scalar"),
])
def test_plan_gather(width, sizes, src, dst, path):
    assert gather.plan_gather(width, sizes[0], sizes[1], src, dst) == path


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


#: every dtype pair the kernel takes: (dataset, output)
PAIRS = [(torch.uint8, torch.uint8), (torch.uint8, torch.float32),
         (torch.int8, torch.int8), (torch.int8, torch.float32),
         (torch.int32, torch.int32), (torch.int32, torch.float32),
         (torch.float32, torch.float32)]
PAIR_IDS = ["u8", "u8_f32", "i8", "i8_f32", "i32", "i32_f32", "f32"]


def _card_dataset(n, width, dtype, device, offset=0):
    """A seeded (n, width) dataset on the card; ``offset`` elements past
    the start of its storage (an unaligned base when offset * itemsize
    is not a multiple of 16)."""
    gen = torch.Generator(device=device).manual_seed(width + offset)
    if dtype == torch.float32:
        flat = torch.randn(offset + n * width, generator=gen, device=device)
    else:
        low = -128 if dtype == torch.int8 else (
            -2 ** 31 if dtype == torch.int32 else 0)
        high = 128 if dtype == torch.int8 else (
            2 ** 31 - 1 if dtype == torch.int32 else 256)
        flat = torch.randint(low, high, (offset + n * width,),
                             generator=gen, device=device, dtype=dtype)
    return flat[offset:].view(n, width)


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("width", [1, 3, 784, 150528])
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_every_pair_width_and_index_type(cuda_card, pair, width,
                                              index_dtype):
    """Bit-equal to the plain version and the same bits twice, with
    out-of-range indices, at batch 1 and 8, int32 and int64 indices."""
    in_dtype, out_dtype = pair
    data = _card_dataset(9, width, in_dtype, cuda_card)
    for idx in ([4], [0, 8, -3, 9, 2 ** 40 if index_dtype == torch.int64
                      else 2 ** 31 - 1, 5, 5, 1]):
        idx = torch.tensor(idx, dtype=index_dtype, device=cuda_card)
        before = gather_minibatch.launches
        got = gather_minibatch(data, idx, out_dtype)
        again = gather_minibatch(data, idx, out_dtype)
        assert gather_minibatch.launches == before + 2
        want = gather_minibatch_reference(data, idx, out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 16])
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_unaligned_base_and_batch_4096(cuda_card, pair, offset):
    """A dataset view that starts ``offset`` elements into its storage
    (off 4 elements at 1, which takes the scalar path; on them at 16),
    gathered into a 4,096-row batch."""
    in_dtype, out_dtype = pair
    data = _card_dataset(50, 784, in_dtype, cuda_card, offset)
    gen = torch.Generator(device=cuda_card).manual_seed(offset)
    idx = torch.randint(-2, 52, (4096,), generator=gen, device=cuda_card)
    want_path = "vec4" if data.data_ptr() % (4 * data.element_size()) \
        == 0 else "scalar"
    before = dict(gather_minibatch.paths)
    got = gather_minibatch(data, idx, out_dtype)
    assert gather_minibatch.paths[want_path] == before[want_path] + 1
    want = gather_minibatch_reference(data, idx, out_dtype)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_int64_gather_is_one_kernel(cuda_card):
    """The profiler sees one kernel on the card for an int64 gather."""
    from torch.profiler import ProfilerActivity, profile
    data = _card_dataset(64, 784, torch.uint8, cuda_card)
    idx = torch.arange(32, device=cuda_card, dtype=torch.int64)
    gather_minibatch(data, idx, torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gather_minibatch(data, idx, torch.float32)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and "gather" in e.name]
    others = [e.name for e in prof.events()
              if e.device_type.name == "CUDA" and "gather" not in e.name
              and "Memcpy" not in e.name and "Memset" not in e.name]
    assert len(kernels) == 1 and not others, (kernels, others)
