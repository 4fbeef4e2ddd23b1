"""The port's random numbers (veles_tpu_torch/ops/random.py, and the state
conversion in veles_tpu_torch/convert.py) against the JAX package's
(veles_tpu/ops/random.py).

``xorshift128plus``, ``xorshift1024star`` and ``uniform_from_bits`` are
bit-equal to JAX's and to the numpy u64 oracles on the cases of
``tests/test_ops.py``.  ``hardware_uniform`` cannot match the TPU's
hardware bits, nor JAX's CPU path (threefry): it is held to the JAX
function's contract (deterministic per seed, values in [0, 1), here on
the 2**-24 grid) and to the uniform distribution, by a Kolmogorov-Smirnov
test that JAX's CPU ``hardware_uniform`` passes too.  Its plain Philox
matches a pure-Python Philox4x32-10 written here and the published
known-answer vectors (Random123).  The ``cuda`` tests hold the CUDA
kernel bit-equal to the plain version on a card and skip where there is
none."""

import numpy
import pytest
import torch

from veles_tpu_torch.backends import Device
from veles_tpu_torch.convert import (xorshift_state_from_jax,
                                     xorshift_state_to_jax)
from veles_tpu_torch.ops import random as prandom

CPU = Device(backend="cpu")
RS = numpy.random.RandomState(42)
GRID = 2.0 ** -24

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xffffffff


def _philox_python(counter, key):
    """Philox4x32-10 on Python integers."""
    c = list(counter)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        p0, p1 = _M0 * c[0], _M1 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & _MASK, p1 & _MASK,
             ((p0 >> 32) ^ c[3] ^ k1) & _MASK, p0 & _MASK]
    return c


KAT = [  # Random123 kat_vectors, philox4x32 10 rounds
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((_MASK,) * 4, (_MASK, _MASK),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,words", KAT)
def test_philox_known_answers(counter, key, words):
    assert tuple(_philox_python(counter, key)) == words
    got = prandom.philox4x32(torch.tensor([counter], dtype=torch.int64),
                             key)
    assert tuple(got[0].tolist()) == words


def test_plain_philox_matches_python_on_64_counters():
    rng = numpy.random.RandomState(3)
    counters = rng.randint(0, 2 ** 32, (64, 4), dtype=numpy.int64)
    counters[:8] = numpy.arange(32).reshape(8, 4)
    key = (int(rng.randint(0, 2 ** 32, dtype=numpy.int64)), 0x12345678)
    got = prandom.philox4x32(torch.from_numpy(counters), key).tolist()
    want = [_philox_python([int(v) for v in row], key) for row in counters]
    assert got == want


def test_hardware_uniform_layout():
    """Element 4i + j is word j of counter (i, 0, 0, 0) under (seed, 0)."""
    u = prandom.hardware_uniform(-5, (3, 7), device=CPU).reshape(-1)
    for e in range(21):
        word = _philox_python((e // 4, 0, 0, 0), ((-5) & _MASK, 0))[e % 4]
        assert u[e].item() == (word >> 8) * GRID


@pytest.mark.parametrize("shape", [(64, 128), (7, 129), (1,), 5])
def test_hardware_uniform_contract(shape):
    u = prandom.hardware_uniform(7, shape, device=CPU)
    want_shape = (shape,) if isinstance(shape, int) else shape
    assert u.dtype == torch.float32 and tuple(u.shape) == want_shape
    assert bool((u >= 0).all()) and bool((u < 1).all())
    assert torch.equal(torch.floor(u / GRID) * GRID, u)
    assert torch.equal(u, prandom.hardware_uniform(7, shape, device=CPU))


def test_hardware_uniform_seeds_differ():
    a = prandom.hardware_uniform(7, (64, 128), device=CPU)
    b = prandom.hardware_uniform(8, (64, 128), device=CPU)
    assert (a != b).float().mean().item() > 0.99


def test_hardware_uniform_seed_is_int32():
    prandom.hardware_uniform(2 ** 31 - 1, (4,), device=CPU)
    prandom.hardware_uniform(-2 ** 31, (4,), device=CPU)
    with pytest.raises(OverflowError):
        prandom.hardware_uniform(2 ** 31, (4,), device=CPU)


def test_hardware_uniform_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: Device() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prandom.hardware_uniform(1, (4,))


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_hardware_uniform_distribution(impl):
    """Kolmogorov-Smirnov against U(0, 1) on 2**16 samples, for the port
    and for JAX's CPU hardware_uniform alike; the mean within 3e-3 of
    0.5 (5 sigma)."""
    from scipy import stats
    if impl == "port":
        u = prandom.hardware_uniform(11, (256, 256), device=CPU).numpy()
    else:
        from veles_tpu.ops import random as jrandom
        u = numpy.asarray(jrandom.hardware_uniform(11, (256, 256)))
    assert stats.kstest(u.ravel(), "uniform").pvalue > 1e-4
    assert abs(u.mean() - 0.5) < 3e-3


def _u64(bits):
    bits = numpy.asarray(bits).astype(numpy.uint64)
    return (bits[:, 0] << numpy.uint64(32)) | bits[:, 1]


def _xs128_state():
    hi = RS.randint(0, 2 ** 31, (2, 4)).astype(numpy.uint32)
    lo = RS.randint(0, 2 ** 31, (2, 4)).astype(numpy.uint32)
    state = numpy.stack([hi, lo], axis=1)
    state[0, 0, 0] = 0xfffffff0   # a word with the top bit set
    return state


def test_xorshift128plus_bit_exact():
    import jax.numpy as jnp
    from veles_tpu.ops import random as jrandom
    state = _xs128_state()
    new_state, bits = prandom.xorshift128plus(torch.from_numpy(
        state.astype(numpy.int64)), 16)
    jstate, jbits = jrandom.xorshift128plus(jnp.asarray(state), 16)
    _, oracle = prandom.numpy_xorshift128plus(state, 16)
    numpy.testing.assert_array_equal(_u64(bits.numpy()), oracle)
    numpy.testing.assert_array_equal(bits.numpy(), numpy.asarray(jbits))
    numpy.testing.assert_array_equal(new_state.numpy(),
                                     numpy.asarray(jstate))


def test_xorshift128plus_state_carries_across():
    """A JAX state continues in the port and comes back: two runs of 8
    equal one of 16."""
    import jax.numpy as jnp
    from veles_tpu.ops import random as jrandom
    state = _xs128_state()
    jstate, _ = jrandom.xorshift128plus(jnp.asarray(state), 8)
    port_state = xorshift_state_from_jax(numpy.asarray(jstate), CPU)
    port_state, bits = prandom.xorshift128plus(port_state, 8)
    _, oracle = prandom.numpy_xorshift128plus(state, 16)
    numpy.testing.assert_array_equal(_u64(bits.numpy()), oracle[8:])
    back = xorshift_state_to_jax(port_state)
    assert back.dtype == numpy.uint32
    jback, _ = jrandom.xorshift128plus(jnp.asarray(state), 16)
    numpy.testing.assert_array_equal(back, numpy.asarray(jback))


def test_xorshift1024star_bit_exact():
    import jax.numpy as jnp
    from veles_tpu.ops import random as jrandom
    state64 = RS.randint(1, 2 ** 62, (16, 3)).astype(numpy.uint64)
    state64[5, 1] |= numpy.uint64(1) << numpy.uint64(63)
    hi = (state64 >> numpy.uint64(32)).astype(numpy.uint32)
    lo = (state64 & numpy.uint64(0xffffffff)).astype(numpy.uint32)
    for p in (0, 13):
        phi, plo, pp, bits = prandom.xorshift1024star(
            xorshift_state_from_jax(hi, CPU),
            xorshift_state_from_jax(lo, CPU), p, 12)
        jhi, jlo, jp, jbits = jrandom.xorshift1024star(
            jnp.asarray(hi), jnp.asarray(lo), jnp.int32(p), 12)
        s, op, oracle = prandom.numpy_xorshift1024star(state64, p, 12)
        numpy.testing.assert_array_equal(_u64(bits.numpy()), oracle)
        numpy.testing.assert_array_equal(bits.numpy(), numpy.asarray(jbits))
        numpy.testing.assert_array_equal(xorshift_state_to_jax(phi),
                                         numpy.asarray(jhi))
        numpy.testing.assert_array_equal(xorshift_state_to_jax(plo),
                                         numpy.asarray(jlo))
        assert pp == int(jp) == op


@pytest.mark.parametrize("vmin,vmax", [(0.0, 1.0), (-2.0, 3.0),
                                       (0.1, 0.7)])
def test_uniform_from_bits_bit_equal(vmin, vmax):
    import jax.numpy as jnp
    from veles_tpu.ops import random as jrandom
    bits = RS.randint(0, 2 ** 32, (1000,), dtype=numpy.int64).astype(
        numpy.uint32)
    got = prandom.uniform_from_bits(
        torch.from_numpy(bits.astype(numpy.int64)), vmin, vmax)
    want = jrandom.uniform_from_bits(jnp.asarray(bits), vmin, vmax)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == numpy.asarray(want).tobytes()
    assert bool((got >= vmin).all()) and bool((got < vmax).all())


def test_arrays_go_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: Device() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prandom.uniform_from_bits(numpy.zeros(4, numpy.uint32))


def test_uint32_bit_patterns_in_int32():
    bits = numpy.array([0, 0x80000000, 0xffffffff, 0x12345678],
                       numpy.uint32)
    got = prandom.uniform_from_bits(torch.from_numpy(bits.view(numpy.int32)))
    want = (bits >> 8).astype(numpy.float32) * numpy.float32(2.0 ** -24)
    numpy.testing.assert_array_equal(got.numpy(), want)


def test_numpy_oracles_are_the_jax_ones():
    from veles_tpu.ops import random as jrandom
    state = _xs128_state()
    for a, b in zip(prandom.numpy_xorshift128plus(state, 5),
                    jrandom.numpy_xorshift128plus(state, 5)):
        numpy.testing.assert_array_equal(a, b)
    s64 = RS.randint(1, 2 ** 62, (16, 2)).astype(numpy.uint64)
    got = prandom.numpy_xorshift1024star(s64, 3, 5)
    want = jrandom.numpy_xorshift1024star(s64, 3, 5)
    assert got[1] == want[1]
    numpy.testing.assert_array_equal(got[2], want[2])


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return Device()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4096), (7, 129), (1,), (4097,),
                                   (1023, 3)])
@pytest.mark.parametrize("seed", [0, -3, 2 ** 31 - 1])
def test_cuda_kernel_bit_equal_to_plain(cuda_card, shape, seed):
    before = prandom.hardware_uniform.launches
    got = prandom.hardware_uniform(seed, shape, device=cuda_card)
    again = prandom.hardware_uniform(seed, shape, device=cuda_card)
    want = prandom.hardware_uniform_reference(seed, shape,
                                              cuda_card.torch_device)
    torch.cuda.synchronize()
    assert prandom.hardware_uniform.launches == before + 2
    assert got.is_cuda and tuple(got.shape) == shape
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got.cpu(), prandom.hardware_uniform(
        seed, shape, device=CPU))


@pytest.mark.cuda
def test_cuda_xorshift_on_the_card(cuda_card):
    state = _xs128_state()
    _, bits = prandom.xorshift128plus(
        xorshift_state_from_jax(state, cuda_card), 16)
    _, oracle = prandom.numpy_xorshift128plus(state, 16)
    numpy.testing.assert_array_equal(_u64(bits.cpu().numpy()), oracle)
