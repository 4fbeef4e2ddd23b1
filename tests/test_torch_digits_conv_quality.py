"""The offline conv classification anchor on the port:
``veles_tpu_torch/examples/digits_conv.py`` (the counterpart of
``examples/digits_conv.py``: conv 16, max pooling, conv 32, max pooling,
all2all_relu 64, softmax 10) over the vendored digits, on the CPU.

- The initial weights equal the JAX package's ``examples/digits_conv.py``
  bit for bit.
- Per unit (the CPU default; the GD units through ``conv_wgrad`` and
  ``max_pool_bwd``'s plain versions) and fused with the input pipeline,
  the best validation error is at most 2.5 % (tests/test_quality.py's
  limit; QUALITY.json: 1.67 % for the JAX package on the CPU).
"""

import numpy
import pytest
import torch

from tests.torch_imports import jax_example
from veles_tpu_torch import prng
from veles_tpu_torch.launcher import Launcher

LIMIT = 2.5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the runs' operations are small, one thread
    takes them about as fast as eight, and the other cores stay with
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(fuse):
    from veles_tpu_torch.examples import digits_conv
    launcher = Launcher()
    sw = digits_conv.build(launcher)
    if fuse:
        sw.fuse(pipeline=True)
    prng.get().seed(1234567890)
    launcher.initialize(device="cpu")
    return launcher, sw


def test_digits_conv_initial_weights_equal_jax():
    import veles_tpu.prng as jax_prng
    from veles_tpu.compiler import extract_state as jax_extract
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch.compiler import extract_state
    from veles_tpu_torch.convert import state_to_numpy
    jax_digits_conv = jax_example("digits_conv")
    jlauncher = JaxLauncher()
    jsw = jax_digits_conv.build(jlauncher)
    jax_prng.get().seed(1234567890)
    jlauncher.initialize(device="cpu")
    _, tsw = _build(False)
    want = [{k: None if v is None else numpy.asarray(v)
             for k, v in e.items()} for e in jax_extract(jsw)]
    got = state_to_numpy(extract_state(tsw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for key in ("weights", "bias"):
            if w[key] is None:
                assert g[key] is None
                continue
            assert g[key].shape == w[key].shape
            assert g[key].tobytes() == w[key].tobytes()
    tsw.loader.run()
    jsw.loader.run()
    assert numpy.array(tsw.loader.minibatch_data[:]).tobytes() == \
        numpy.array(jsw.loader.minibatch_data[:]).tobytes()


@pytest.mark.parametrize("fuse", [False, True], ids=["per-unit", "fused"])
def test_digits_conv_quality(fuse):
    launcher, sw = _build(fuse)
    launcher.run()
    best = sw.decision.best_metric
    assert best is not None and best <= LIMIT, best
