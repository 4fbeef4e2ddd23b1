"""The port's service units and their kernels (veles_tpu_torch:
service_units, ops/join.py, ops/normalize.py) against the JAX package's.

``join`` and ``mean_disp_normalize`` on the CPU run their plain PyTorch
versions; the JAX ops run their Pallas kernels in interpret mode on the
same seeded inputs, and the results must be bit-equal: 1, 2 and 5
inputs, uint8, float32 and bfloat16 inputs, widths 1, 7 and 129, casts
to float32, bfloat16 and the inputs' own dtype.  The four units mirror
``tests/test_service_units.py``.  The ``cuda`` tests hold the CUDA
kernels against the plain versions on a card (bit-equal, and the same
bits twice); they skip where there is none.  The JAX package is imported
inside the tests that use it, so the ``cuda`` tests also run where only
the port is installed."""

import numpy
import pytest
import torch

from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyUnit, DummyWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.normalization import MeanDispersionNormalizer
from veles_tpu_torch.ops.join import join, join_reference
from veles_tpu_torch.ops.normalize import (mean_disp_normalize,
                                           mean_disp_normalize_reference)
from veles_tpu_torch.service_units import (Avatar, InputJoiner,
                                           MeanDispNormalizer, Shell)

CPU = Device(backend="cpu")
DTYPES = {"uint8": torch.uint8, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _operand(rng, shape, dtype):
    """A seeded torch tensor and the host float32/uint8 array it was
    made from (bf16 rounds from one float32 draw)."""
    if dtype == "uint8":
        host = rng.randint(0, 256, shape).astype(numpy.uint8)
        return torch.from_numpy(host), host
    host = (rng.randn(*shape) * 4).astype(numpy.float32)
    return torch.from_numpy(host).to(DTYPES[dtype]), host


def _jax_operand(host, dtype):
    """The same values as a jax array (bf16 rounded from the same
    float32 draw, to nearest even on both sides)."""
    import jax.numpy as jnp
    return jnp.asarray(host).astype(getattr(jnp, dtype))


def _bits(tensor):
    """A tensor's bytes (bf16 widened exactly to float32 first)."""
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    return tensor.contiguous().numpy().tobytes()


def _jax_bits(array):
    import jax.numpy as jnp
    if array.dtype == jnp.bfloat16:
        array = array.astype(jnp.float32)
    return numpy.asarray(array).tobytes()


@pytest.mark.parametrize("out", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("width", [1, 7, 129])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_inputs", [1, 2, 5])
def test_join_matches_jax(n_inputs, dtype, width, out):
    import jax.numpy as jnp
    from veles_tpu.ops.join import join as jax_join
    rng = numpy.random.RandomState(n_inputs * 1000 + width)
    pairs = [_operand(rng, (6, width + i), dtype) for i in range(n_inputs)]
    got = join(*[t for t, _ in pairs],
               out_dtype=DTYPES[out] if out else None)
    want = jax_join(*[_jax_operand(h, dtype) for _, h in pairs],
                    out_dtype=getattr(jnp, out) if out else None)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _bits(got) == _jax_bits(want)


def test_join_mixed_dtypes_and_sample_shapes():
    """(B, 4, 2) uint8 + (B, 3) f32 + (B, 1) bf16 -> f32, as the JAX
    kernel (flattened per sample)."""
    import jax.numpy as jnp
    from veles_tpu.ops.join import join as jax_join
    rng = numpy.random.RandomState(5)
    dtypes = ("uint8", "float32", "bfloat16")
    pairs = [_operand(rng, shape, dtype) for shape, dtype in
             zip(((4, 4, 2), (4, 3), (4, 1)), dtypes)]
    got = join(*[t for t, _ in pairs], out_dtype=torch.float32)
    want = jax_join(*[_jax_operand(h, d) for (_, h), d in
                      zip(pairs, dtypes)], out_dtype=jnp.float32)
    assert tuple(got.shape) == (4, 12)
    assert _bits(got) == _jax_bits(want)


def test_join_rejects_mismatched_batches():
    with pytest.raises(ValueError, match="batch"):
        join(torch.zeros(3, 2), torch.zeros(4, 2))


@pytest.mark.parametrize("batch", [1, 9])
@pytest.mark.parametrize("width", [1, 7, 129])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_normalize_matches_jax(dtype, width, batch):
    import jax.numpy as jnp
    from veles_tpu.ops.normalize import mean_disp_normalize as jax_normalize
    rng = numpy.random.RandomState(width + batch)
    x_t, host = _operand(rng, (batch, width), dtype)
    x_j = _jax_operand(host, dtype)
    # float64 coefficients, as the host normalizer makes them: both
    # sides cast to float32 before the kernel
    mean = rng.randn(width) * 10
    rdisp = 1.0 / (rng.rand(width) * 50 + 0.5)
    got = mean_disp_normalize(x_t, torch.from_numpy(mean),
                              torch.from_numpy(rdisp))
    want = jax_normalize(x_j, jnp.asarray(mean.astype(numpy.float32)),
                         jnp.asarray(rdisp.astype(numpy.float32)))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _bits(got) == _jax_bits(want)


def test_normalize_keeps_the_sample_shape():
    x = torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4)
    mean = torch.full((12,), 3.0)
    rdisp = torch.full((12,), 0.5)
    out = mean_disp_normalize(x, mean, rdisp)
    assert out.shape == (2, 3, 4)
    assert torch.equal(out, (x.float() - 3.0) * 0.5)
    with pytest.raises(ValueError, match="features"):
        mean_disp_normalize(x, mean[:5], rdisp)


def test_input_joiner_unit_matches_jax():
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
    from veles_tpu.memory import Array as JaxArray
    from veles_tpu.service_units import InputJoiner as JaxJoiner
    rng = numpy.random.RandomState(0)
    a = rng.rand(6, 4).astype(numpy.float32)
    b = rng.rand(6, 3).astype(numpy.float32)
    joiner = InputJoiner(DummyWorkflow(), inputs=[Array(a), Array(b)])
    joiner.initialize(device=CPU)
    joiner.run()
    jj = JaxJoiner(JaxWorkflow(), inputs=[JaxArray(a), JaxArray(b)])
    jj.initialize(device=JaxDevice(backend="cpu"))
    jj.run()
    jj.output.map_read()
    assert joiner.output[:].tobytes() == \
        numpy.asarray(jj.output.mem, numpy.float32).tobytes()
    assert numpy.array_equal(joiner.output[:],
                             numpy.concatenate([a, b], axis=1))


def test_mean_disp_normalizer_unit_matches_jax():
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
    from veles_tpu.memory import Array as JaxArray
    from veles_tpu.service_units import MeanDispNormalizer as JaxNormalizer
    rng = numpy.random.RandomState(1)
    data = (rng.rand(8, 5) * 10).astype(numpy.float32)
    norm = MeanDispersionNormalizer()
    norm.analyze(data)
    unit = MeanDispNormalizer(DummyWorkflow())
    unit.input = Array(data)
    unit.mean = norm.mean          # float64, as a user would pass them
    unit.rdisp = norm.rdisp
    unit.initialize(device=CPU)
    unit.run()
    ju = JaxNormalizer(JaxWorkflow())
    ju.input = JaxArray(data)
    ju.mean = norm.mean
    ju.rdisp = norm.rdisp
    ju.initialize(device=JaxDevice(backend="cpu"))
    ju.run()
    ju.output.map_read()
    assert unit.output[:].tobytes() == \
        numpy.asarray(ju.output.mem, numpy.float32).tobytes()
    # the host normalizer of float32 data computes the same bits
    host = data.copy()
    norm.normalize(host)
    assert unit.output[:].tobytes() == host.tobytes()


def test_mean_disp_normalizer_reuploads_changed_coefficients():
    unit = MeanDispNormalizer(DummyWorkflow())
    unit.input = Array(numpy.ones((2, 3), numpy.uint8))
    unit.mean = numpy.zeros(3)
    unit.rdisp = numpy.ones(3)
    unit.initialize(device=CPU)
    unit.run()
    assert numpy.array_equal(unit.output[:], numpy.ones((2, 3)))
    unit.mean[:] = 1.0                       # changed in place
    unit.run()
    assert numpy.array_equal(unit.output[:], numpy.zeros((2, 3)))
    unit.rdisp = numpy.full(3, 2.0)          # rebound
    unit.mean[:] = 0.0
    unit.run()
    assert numpy.array_equal(unit.output[:], numpy.full((2, 3), 2.0))


def test_avatar_clones():
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Array(numpy.ones(4, numpy.float32)))
    avatar = Avatar(wf).clone(src, "output")
    avatar.initialize(device=CPU)
    avatar.run()
    assert numpy.array_equal(avatar.output[:], numpy.ones(4))
    # mutating the clone leaves the source untouched
    avatar.output.map_write()
    avatar.output.mem[:] = 7
    assert numpy.array_equal(src.output[:], numpy.ones(4))


def test_avatar_shares_device_tensors_without_writes():
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Array())
    src.output.set_device_array(torch.arange(3.0), CPU)
    avatar = Avatar(wf).clone(src, "output")
    avatar.initialize(device=CPU)
    avatar.run()
    assert avatar.output.devmem is src.output.devmem
    avatar.output.map_write()
    avatar.output.mem[:] = -1
    assert torch.equal(src.output.devmem, torch.arange(3.0))
    assert numpy.array_equal(avatar.output.devmem.numpy(), [-1, -1, -1])


def test_shell_noop_without_tty():
    shell = Shell(DummyWorkflow())
    shell.initialize()
    shell.run()  # stdin is not a tty under pytest: must not block


def _launchers():
    """(module launcher, public wrapper, call) of the two kernels."""
    from veles_tpu_torch.ops import join as join_module
    from veles_tpu_torch.ops import normalize as normalize_module
    x = torch.zeros(3, 4, dtype=torch.uint8)
    coeff = torch.ones(4)
    return [
        (join_module._launch, join,
         lambda: join_module._launch([x.float(), coeff.reshape(1, 4)
                                      .expand(3, 4).contiguous()],
                                     torch.float32)),
        (normalize_module._launch, mean_disp_normalize,
         lambda: normalize_module._launch(x, coeff, coeff)),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["join", "normalize"])
def test_failed_build_raises(monkeypatch, tmp_path, which):
    """A CUDA call builds the kernels or raises: no quiet fallback."""
    from test_torch_gather import patch_failing_build
    patch_failing_build(monkeypatch, tmp_path)
    launcher, wrapper, call = _launchers()[which]
    monkeypatch.setattr(launcher, "fn", None)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert wrapper.launches == before


@pytest.mark.parametrize("which", [0, 1], ids=["join", "normalize"])
def test_failed_launch_raises(monkeypatch, which):
    from test_torch_gather import FakeLibrary, patch_failing_launch
    patch_failing_launch(monkeypatch)
    launcher, wrapper, call = _launchers()[which]
    monkeypatch.setattr(launcher, "fn", None)
    before, calls = wrapper.launches, FakeLibrary.calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert FakeLibrary.calls == calls + 1
    assert wrapper.launches == before


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("widths", [(1,), (7, 129), (100, 100),
                                    (784, 100, 10), tuple(range(1, 21))])
def test_cuda_join_matches_plain_version(cuda_card, widths, dtype, out):
    rng = numpy.random.RandomState(len(widths))
    parts = [_operand(rng, (37, w), dtype)[0].to(cuda_card)
             for w in widths]
    before = join.launches
    got = join(*parts, out_dtype=out)
    again = join(*parts, out_dtype=out)
    want = join_reference(*parts, out_dtype=out)
    torch.cuda.synchronize()
    assert join.launches - before == 2 * (-(-len(widths) // 16))
    assert got.dtype == want.dtype
    assert _bits(got.cpu()) == _bits(want.cpu()) == _bits(again.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 784), (4096, 3072), (3, 7),
                                   (65, 1), (9, 129)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_normalize_matches_plain_version(cuda_card, shape, dtype):
    rng = numpy.random.RandomState(shape[1])
    x = _operand(rng, shape, dtype)[0].to(cuda_card)
    mean = torch.from_numpy(rng.randn(shape[1]) * 10).to(cuda_card)
    rdisp = torch.from_numpy(1.0 / (rng.rand(shape[1]) + 0.1)).to(
        cuda_card)
    before = mean_disp_normalize.launches
    got = mean_disp_normalize(x, mean, rdisp)
    again = mean_disp_normalize(x, mean, rdisp)
    want = mean_disp_normalize_reference(x, mean, rdisp)
    torch.cuda.synchronize()
    assert mean_disp_normalize.launches - before == 2
    assert _bits(got.cpu()) == _bits(want.cpu()) == _bits(again.cpu())


def _card_parts(device, widths, dtypes, batch=37, seed=0):
    """Seeded (batch, w) inputs on the card, one dtype each (by name)."""
    rng = numpy.random.RandomState(seed)
    parts = []
    for w, dtype in zip(widths, dtypes):
        if dtype in ("int8", "int32"):
            host = rng.randint(-128, 128, (batch, w))
            parts.append(torch.from_numpy(host).to(getattr(torch, dtype)))
        elif dtype == "float16":
            parts.append(torch.from_numpy(
                rng.randn(batch, w).astype(numpy.float32)).half())
        else:
            parts.append(_operand(rng, (batch, w), dtype)[0])
    return [p.to(device) for p in parts]


def _join_is_plain(parts, out, launches):
    before = join.launches
    got = join(*parts, out_dtype=out)
    again = join(*parts, out_dtype=out)
    want = join_reference(*parts, out_dtype=out)
    torch.cuda.synchronize()
    assert join.launches - before == 2 * launches
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _bits(got.cpu()) == _bits(want.cpu()) == _bits(again.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 4096])
@pytest.mark.parametrize("widths", [(3, 5, 2), (1, 1, 1, 1, 1),
                                    (6, 4, 10, 7), (784, 100, 10),
                                    (8, 0, 4)],
                         ids=["odd", "ones", "mixed", "mnist", "empty"])
def test_cuda_join_rows_not_a_multiple_of_4(cuda_card, widths, batch):
    """The flat design where 4-element groups cross inputs and rows (row
    widths 10, 5, 27, 894 and 12 with an empty input), each input in its
    own dtype, to float32: bit-equal to the plain version, twice."""
    dtypes = ["uint8", "float32", "bfloat16", "float16", "int32"]
    parts = _card_parts(cuda_card, widths,
                        [dtypes[i % len(dtypes)] for i in range(len(widths))],
                        batch)
    _join_is_plain(parts, torch.float32, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_cuda_join_17_inputs(cuda_card, out):
    """17 inputs take two launches, each writing its own column window
    (16 inputs, then 1); widths 1 to 17 with an empty one, in turns of
    uint8, float32 and bfloat16."""
    widths = [w if w != 9 else 0 for w in range(1, 18)]
    dtypes = ["uint8", "float32", "bfloat16"] * 6
    parts = _card_parts(cuda_card, widths, dtypes[:17])
    _join_is_plain(parts, out, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes,out", [
    (("uint8", "int8", "int32"), torch.int32),
    (("int32", "int32"), torch.int32),
    (("uint8", "uint8"), torch.uint8),
    (("int8", "int8", "int8"), torch.int8)],
    ids=["widen", "int32", "uint8", "int8"])
@pytest.mark.parametrize("widths", [(4, 8, 12), (3, 6, 1)],
                         ids=["aligned", "ragged"])
def test_cuda_join_int_outputs(cuda_card, dtypes, out, widths):
    parts = _card_parts(cuda_card, widths[:len(dtypes)], dtypes)
    _join_is_plain(parts, out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
def test_cuda_join_unaligned_pointers(cuda_card, dtype):
    """Inputs that start one element past an aligned address (contiguous
    views into a larger buffer): widths that are multiples of 4 still
    take element loads there, and the output stays bit-equal."""
    parts = []
    for i, part in enumerate(_card_parts(cuda_card, (8, 100, 4),
                                         [dtype] * 3)):
        buf = torch.empty(part.numel() + 1, dtype=part.dtype,
                          device=cuda_card)
        view = buf[1:].view(part.shape) if i != 1 else buf[:-1].view(
            part.shape)
        view.copy_(part)
        parts.append(view)
    assert parts[0].data_ptr() % (4 * parts[0].element_size()) != 0
    _join_is_plain(parts, torch.float32, 1)


#: every input dtype the normalize kernel takes
NORMALIZE_DTYPES = ["uint8", "int8", "int32", "float32", "bfloat16",
                    "float16"]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda o: "offset%d" % o)
@pytest.mark.parametrize("shape", [(100, 784), (37, 100), (9, 129),
                                   (1, 16), (300, 48), (5, 3)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", NORMALIZE_DTYPES)
def test_cuda_normalize_every_dtype_width_and_alignment(cuda_card, dtype,
                                                        shape, offset):
    """Both designs of the kernel (4-element groups, one element)
    against the plain version, bit for bit: widths that are and are not
    multiples of 16 and 4, and x, mean and rdisp starting ``offset``
    elements into their storage (views the wrapper takes as they are),
    so the pointers rule the one-element design in."""
    batch, width = shape
    base = _card_parts(cuda_card, [batch * width + offset], [dtype],
                       batch=1, seed=width + offset)[0].reshape(-1)
    x = base[offset:].view(shape)
    rng = numpy.random.RandomState(width)
    coeffs = torch.from_numpy(numpy.stack([
        rng.randn(width + offset) * 10,
        1.0 / (rng.rand(width + offset) + 0.1)]).astype(numpy.float32))
    coeffs = coeffs.to(cuda_card)
    mean, rdisp = coeffs[0, offset:], coeffs[1, offset:]
    before = mean_disp_normalize.launches
    got = mean_disp_normalize(x, mean, rdisp)
    again = mean_disp_normalize(x, mean, rdisp)
    want = mean_disp_normalize_reference(x, mean, rdisp)
    torch.cuda.synchronize()
    assert mean_disp_normalize.launches - before == 2
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _bits(got.cpu()) == _bits(want.cpu()) == _bits(again.cpu())
