"""The port's threefry2x32 key stream (veles_tpu_torch/threefry.py) and
dropout masks against ``jax.random`` and the JAX package's
``DropoutForward.make_mask``, bit for bit, on the CPU.

The bits are those of the JAX version the reference runs under, where
``jax_threefry_partitionable`` is on (the counters are each element's
flat index as two 32-bit words, the bits the two hash words xor-ed);
:func:`test_jax_draws_partitionable_bits` fails with a clear message if
an upgrade turns it off.  The ``cuda`` test holds the bits drawn on a
card against the CPU's and skips where there is none."""

import numpy
import pytest
import torch

from veles_tpu_torch import threefry

SEEDS = [0, 1, 2 ** 31 - 1]
SHAPES = [(), (0,), (7, 3), (32, 4096), (3, 5, 11)]


def shape_ids(shape):
    return "x".join(map(str, shape)) or "scalar"


def _pair(jax_key):
    return tuple(int(v) for v in numpy.asarray(jax_key))


def _chain(seed, data):
    """The JAX key and the port's after folding ``data`` in, in order."""
    import jax
    jk, pk = jax.random.PRNGKey(seed), threefry.key(seed)
    for d in data:
        jk, pk = jax.random.fold_in(jk, d), threefry.fold_in(pk, d)
    return jk, pk


def test_jax_draws_partitionable_bits():
    import jax
    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is off under JAX %s: the reference's "
        "masks then come from the original counter layout, which "
        "veles_tpu_torch.threefry does not implement" % jax.__version__)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_prng_key(seed):
    import jax
    assert threefry.key(seed) == _pair(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [(0,), (1, 2, 3), (7, 2 ** 32 - 1, 12345),
                                  tuple(range(20))],
                         ids=["zero", "steps", "extremes", "twenty"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_chains_match_jax(seed, data):
    jk, pk = _chain(seed, data)
    assert pk == _pair(jk)
    assert all(0 <= word < 2 ** 32 for word in pk)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_ids)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    import jax
    jk, pk = _chain(seed, (seed % 5, 3))
    want = numpy.asarray(jax.random.bits(jk, shape))
    got = threefry.random_bits(pk, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    assert numpy.array_equal(got.numpy(), want.astype(numpy.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=shape_ids)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    import jax
    jk, pk = _chain(seed, (11,))
    want = numpy.asarray(jax.random.uniform(jk, shape))
    got = threefry.uniform(pk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("p", [0.5, 1.0 - 0.3, 0.9])
@pytest.mark.parametrize("shape", SHAPES, ids=shape_ids)
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_matches_jax(seed, shape, p):
    import jax
    jk, pk = _chain(seed, (2,))
    want = numpy.asarray(jax.random.bernoulli(jk, p, shape))
    got = threefry.bernoulli(pk, p, shape)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert numpy.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ratio", [0.5, 0.3, 0.1])
@pytest.mark.parametrize("shape", [(32, 4096), (5, 7, 3)], ids=shape_ids)
def test_dropout_masks_equal_jax(shape, ratio):
    """The port's DropoutForward.make_mask draws the JAX package's mask
    (values 0 and 1 / (1 - ratio)) bit for bit."""
    from veles_tpu.models.dropout import DropoutForward as JaxDropout
    from veles_tpu_torch.models.dropout import DropoutForward
    jk, pk = _chain(4, (9, 1))
    want = numpy.asarray(JaxDropout.make_mask(jk, shape, ratio,
                                              numpy.float32))
    got = DropoutForward.make_mask(pk, shape, ratio, torch.float32,
                                   torch.device("cpu"))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert set(numpy.unique(want)) == {0.0, numpy.float32(1.0 / (1 - ratio))}


def test_threefry_on_ints_and_tensors_agree():
    """The hash runs on host ints (keys) and int64 tensors (bits) alike."""
    k = threefry.key(99)
    x0 = torch.tensor([0, 1, 2 ** 32 - 1, 5])
    x1 = torch.tensor([0, 2 ** 31, 7, 2 ** 32 - 1])
    t0, t1 = threefry.threefry2x32(k, x0, x1)
    for i in range(4):
        h0, h1 = threefry.threefry2x32(k, int(x0[i]), int(x1[i]))
        assert (int(t0[i]), int(t1[i])) == (h0, h1)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(4096, 4096), (3, 25088)],
                         ids=shape_ids)
def test_cuda_bits_equal_the_cpu(cuda_card, shape):
    k = threefry.fold_in(threefry.key(7), 3)
    got = threefry.random_bits(k, shape, cuda_card)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), threefry.random_bits(k, shape))
    assert torch.equal(threefry.bernoulli(k, 0.5, shape, cuda_card).cpu(),
                       threefry.bernoulli(k, 0.5, shape))
    assert threefry.uniform(k, shape, cuda_card).cpu().numpy().tobytes() \
        == threefry.uniform(k, shape).numpy().tobytes()


def _tensor_key(key):
    """A key as a captured step reads it: two 0-d int64 tensors (the
    static device buffer's words)."""
    words = torch.tensor(list(key), dtype=torch.int64)
    return words[0], words[1]


@pytest.mark.parametrize("layer", [0, 3, 17])
@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_fold_in_equals_host_key(seed, layer):
    """fold_in over a tensor key (and over tensor data) gives the host
    key's words, and JAX's."""
    step_key = threefry.fold_in(threefry.key(seed), 5)
    jk, _ = _chain(seed, (5, layer))
    for data in (layer, torch.tensor(layer, dtype=torch.int64)):
        got = threefry.fold_in(_tensor_key(step_key), data)
        assert (int(got[0]), int(got[1])) == \
            threefry.fold_in(step_key, layer) == _pair(jk)


@pytest.mark.parametrize("shape", [(7, 3), (32, 4096), (3, 5, 11)],
                         ids=shape_ids)
@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_masks_equal_host_key_masks_and_jax(seed, shape):
    """A mask drawn from a tensor key folded on the device equals the
    host key's mask and ``jax.random.bernoulli(fold_in(key, i))`` bit
    for bit."""
    import jax
    from veles_tpu_torch.models.dropout import DropoutForward
    step_key = threefry.fold_in(threefry.key(seed), 2)
    jk, _ = _chain(seed, (2, 4))
    cpu = torch.device("cpu")
    host = DropoutForward.make_mask(threefry.fold_in(step_key, 4), shape,
                                    0.3, torch.float32, cpu)
    device = DropoutForward.make_mask(
        threefry.fold_in(_tensor_key(step_key), 4), shape, 0.3,
        torch.float32, cpu)
    assert torch.equal(host, device)
    keep = numpy.asarray(jax.random.bernoulli(jk, 0.7, shape))
    assert numpy.array_equal(device.numpy() > 0, keep)
