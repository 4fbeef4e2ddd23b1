"""``veles_tpu_torch/examples/sequence.py`` (the counterpart of
``examples/sequence.py``: an LSTM over the rows of the vendored digits)
against the JAX package's example, on the CPU.

- The same seeds draw the same initial weights bit for bit.
- Three epochs, the port per unit and fused with the input pipeline,
  the JAX package per unit: every epoch's validation and train error
  within rel 1e-4 of JAX's (the error counts agree), every leaf within
  max-rel 1e-4.
- ``python -m veles_tpu_torch veles_tpu_torch/examples/sequence.py - -d
  cpu`` trains through the command line.

The quality limit (best validation error under 5 %, the bound of JAX's
``test_lstm_sequence_classification``) is held on the card by
``chip_smoke.py``'s ``sequence:`` phase.
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
from veles_tpu_torch.compiler import extract_state
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import state_to_numpy
from veles_tpu_torch.launcher import Launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the runs' operations are small, and the
    other cores stay with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build_port(fuse, epochs):
    from veles_tpu_torch.examples import sequence
    saved = root.sequence.max_epochs
    root.sequence.max_epochs = epochs
    try:
        launcher = Launcher()
        sw = sequence.build(launcher)
    finally:
        root.sequence.max_epochs = saved
    if fuse:
        sw.fuse(pipeline=True)
    prng.get().seed(1234567890)
    launcher.initialize(device="cpu")
    return launcher, sw


def _build_jax(epochs):
    import veles_tpu.prng as jax_prng
    from veles_tpu.config import root as jax_root
    from veles_tpu.launcher import Launcher as JaxLauncher
    jax_sequence = jax_example("sequence")
    saved = jax_root.sequence.max_epochs
    jax_root.sequence.max_epochs = epochs
    try:
        launcher = JaxLauncher()
        sw = jax_sequence.build(launcher)
        jax_prng.get().seed(1234567890)
        launcher.initialize(device="cpu")
    finally:
        jax_root.sequence.max_epochs = saved
    return launcher, sw


def _jax_state(sw):
    from veles_tpu.compiler import extract_state as jax_extract
    return [{k: None if v is None else numpy.asarray(v, numpy.float64)
             for k, v in e.items()} for e in jax_extract(sw)]


def _epoch_metrics(sw):
    """(validation, train) error of each epoch."""
    record = []
    dec = sw.decision
    inner = dec._on_epoch_ended

    def hook():
        record.append((dec.epoch_metrics[1], dec.epoch_metrics[2]))
        inner()
    dec._on_epoch_ended = hook
    return record


@pytest.fixture(scope="module")
def jax_run():
    launcher, sw = _build_jax(EPOCHS)
    initial = _jax_state(sw)
    metrics = _epoch_metrics(sw)
    launcher.run()
    return initial, metrics, _jax_state(sw), sw.decision.class_lengths


@pytest.mark.parametrize("fuse", [False, True], ids=["per-unit", "fused"])
def test_three_epochs_match_jax(jax_run, fuse):
    initial, want_metrics, want_state, lengths = jax_run
    launcher, sw = _build_port(fuse, EPOCHS)
    for got, want in zip(state_to_numpy(extract_state(sw)), initial):
        assert got["weights"].tobytes() == \
            want["weights"].astype(numpy.float32).tobytes()
    metrics = _epoch_metrics(sw)
    launcher.run()
    assert sw.decision.epoch_number == EPOCHS
    assert len(metrics) == len(want_metrics) == EPOCHS + 1
    for got, want in zip(metrics, want_metrics):
        for cls, (g, w) in enumerate(zip(got, want), start=1):
            if w is None:
                assert g is None
                continue
            assert g == pytest.approx(w, rel=1e-4)
            assert round(g * lengths[cls] / 100.0) == \
                round(w * lengths[cls] / 100.0)
    for got, want in zip(state_to_numpy(extract_state(sw)), want_state):
        for key in ("weights", "bias"):
            rel = numpy.abs(got[key] - want[key]).max() / \
                numpy.abs(want[key]).max()
            assert rel <= 1e-4, (key, rel)
    if fuse:
        assert sw.fused_trainer.prefetcher is not None
    sw.stop()


def test_sequence_through_the_command_line(tmp_path):
    result = tmp_path / "result.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("VELES_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join(REPO, "veles_tpu_torch", "examples", "sequence.py"),
         "-", "-d", "cpu", "--result-file", str(result),
         "root.sequence.max_epochs=2"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    results = json.loads(result.read_text())
    assert results["Total epochs"] == 2
    assert results["Best metric"] < 90.0, results
