"""The offline real-data anchor on the port: ``veles_tpu_torch/examples/
digits.py`` (the counterpart of ``examples/digits.py``) over the
vendored digits, on the CPU.

- Per unit (the CPU default) and fused with the input pipeline, the
  best validation error is at most 2.5 % (tests/test_quality.py's limit;
  QUALITY.json: 1.39 % for the JAX package on the CPU).
- The port's first epoch per unit agrees with the JAX package's
  ``examples/digits.py`` per unit: every leaf within max-rel 1e-4 (the
  workflow tests' epoch limit) and the error counts within 1 sample.
- ``python -m veles_tpu_torch veles_tpu_torch/examples/digits.py - -d
  cpu`` trains to the same limit and writes its results.
"""

import json
import os
import subprocess
import sys

import numpy
import pytest
import torch

from tests.torch_imports import jax_example
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _build(fuse, max_epochs=None):
    from veles_tpu_torch.examples import digits
    saved = root.digits.max_epochs
    if max_epochs is not None:
        root.digits.max_epochs = max_epochs
    try:
        launcher = Launcher()
        sw = digits.build(launcher)
    finally:
        root.digits.max_epochs = saved
    if fuse:
        sw.fuse(pipeline=True)
    prng.get().seed(1234567890)
    launcher.initialize(device="cpu")
    return launcher, sw


@pytest.mark.parametrize("fuse", [False, True], ids=["per-unit", "fused"])
def test_digits_quality(fuse):
    launcher, sw = _build(fuse)
    launcher.run()
    best = sw.decision.best_metric
    assert best is not None and best <= LIMIT, best
    if fuse:
        assert sw.fused_trainer.prefetcher is not None
        assert sw.fused_trainer.prefetcher.stats["applied"] == \
            sw.fused_trainer.run_calls


def test_digits_first_epoch_matches_jax():
    import veles_tpu.prng as jax_prng
    from veles_tpu.compiler import extract_state as jax_extract
    from veles_tpu.config import root as jax_root
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch.compiler import extract_state
    from veles_tpu_torch.convert import state_to_numpy
    jax_digits = jax_example("digits")
    saved = jax_root.digits.max_epochs
    jax_root.digits.max_epochs = 1
    try:
        jlauncher = JaxLauncher()
        jsw = jax_digits.build(jlauncher)
        jax_prng.get().seed(1234567890)
        jlauncher.initialize(device="cpu")
    finally:
        jax_root.digits.max_epochs = saved
    launcher, tsw = _build(False, max_epochs=1)
    want0 = [{k: None if v is None else numpy.asarray(v)
              for k, v in e.items()} for e in jax_extract(jsw)]
    got0 = state_to_numpy(extract_state(tsw))
    for g, w in zip(got0, want0):
        assert g["weights"].tobytes() == w["weights"].tobytes()
    jlauncher.run()
    launcher.run()
    want = [{k: None if v is None else numpy.asarray(v, numpy.float64)
             for k, v in e.items()} for e in jax_extract(jsw)]
    got = state_to_numpy(extract_state(tsw))
    for g, w in zip(got, want):
        for key in ("weights", "bias"):
            rel = numpy.abs(g[key] - w[key]).max() / \
                numpy.abs(w[key]).max()
            assert rel <= 1e-4, (key, rel)
    for cls in (1, 2):
        n = tsw.decision.class_lengths[cls]
        errs = [round(d.epoch_metrics[cls] * n / 100.0)
                for d in (tsw.decision, jsw.decision)]
        assert abs(errs[0] - errs[1]) <= 1, errs


def test_digits_through_the_command_line(tmp_path):
    result = tmp_path / "result.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("VELES_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join(REPO, "veles_tpu_torch", "examples", "digits.py"),
         "-", "-d", "cpu", "--result-file", str(result)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    results = json.loads(result.read_text())
    assert results["Total epochs"] >= results["Best epoch"] >= 1
    assert results["Best metric"] <= LIMIT, results
