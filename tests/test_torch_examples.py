"""The port's example workflows (veles_tpu_torch/examples/) against the JAX
package's (examples/), on the CPU, at the examples' own widths.

- autoencoder, conv_autoencoder, transformer, mnist, mnist_autoencoder,
  cifar10 and stl10: the port builds the same layer plan and draws the
  same initial leaves, bit for bit (the dataset-gated four on small
  seeded arrays of their canonical sample shapes: the weights depend on
  the shapes only).
- The three digits workflows: the first epoch per unit agrees with the
  JAX package's per unit, every leaf within max-rel 1e-4 (the workflow
  tests' epoch limit) and the epoch metrics within 1 sample (errors) or
  1e-4 rel (RMSE); the transformer with 1 block, its JAX attention on
  the stock reference that a CPU run takes (the port's plain level-0
  attention is bf16x3, ~3e-6 from it).  Largest readings: autoencoder
  3.1e-5 (a momentum bias), conv_autoencoder 3.3e-6, transformer
  2.2e-6.
- digits_turbo, run as ``--backend cpu --epochs 30``: best validation
  error under 4.0 % (tests/test_epoch.py's limit).
- The dataset-gated four take one fused evaluation step and one training
  step each on a canonical-shaped seeded drop with a finite loss
  (tests/test_quality.py's rehearsal contract); the STL-10 drop (0.4 GB
  of pixels, 1.4 GB as float32) carries ``slow``, as the JAX rehearsal
  does.  Nothing is downloaded: the drop is written first
  (``chip_smoke``'s writers, which the smoke's examples phase uses).
"""

import copy
import importlib
import os
import subprocess
import sys

import numpy
import pytest
import torch

import chip_smoke
from tests.torch_imports import jax_example, restored_imports
from veles_tpu_torch import prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (example, its config node)
DIGITS = [("autoencoder", "digits_ae"), ("conv_autoencoder", "conv_ae"),
          ("transformer", "transformer")]
GATED = ["mnist", "mnist_autoencoder", "cifar10", "stl10"]
#: the canonical (train, validation) counts and sample shapes
CANONICAL = {"mnist": ((60000, 10000), (784,)),
             "cifar10": ((50000, 10000), (32, 32, 3)),
             "stl10": ((5000, 8000), (96, 96, 3))}
SEED = 1234567890
#: the workflow files ``python -m veles_tpu_torch <file> -`` runs
WORKFLOWS = ["autoencoder", "conv_autoencoder", "transformer", "kohonen",
             "rbm"] + GATED


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the runs' operations are small, one thread
    takes them about as fast as eight, and the other cores stay with
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _modules(name):
    """(the JAX example module, the port's)."""
    return (jax_example(name),
            importlib.import_module("veles_tpu_torch.examples." + name))


def _small_arrays(name, rng):
    """(train_x, train_y, valid_x, valid_y) at the canonical sample shape
    of ``name``'s dataset, 100 train and 50 validation samples."""
    shape = CANONICAL[name][1]
    return (rng.rand(100, *shape).astype(numpy.float32),
            rng.randint(0, 10, 100).astype(numpy.int32),
            rng.rand(50, *shape).astype(numpy.float32),
            rng.randint(0, 10, 50).astype(numpy.int32))


def _patch_arrays(monkeypatch, name, modules):
    """Point both packages' loaders of ``name`` at small seeded arrays."""
    import veles_tpu.datasets as jax_datasets
    import veles_tpu_torch.datasets as datasets
    dataset = "mnist" if name.startswith("mnist") else name
    arrays = _small_arrays(dataset, numpy.random.RandomState(3))
    for module in (jax_datasets, datasets) + tuple(modules):
        if hasattr(module, dataset + "_arrays"):
            monkeypatch.setattr(module, dataset + "_arrays",
                                lambda *a, **k: arrays)


def _epochs(node, epochs):
    """Set ``root.<node>``'s epoch limit in both packages; returns a
    function that puts the old ones back."""
    from veles_tpu.config import root as jax_root
    key = "max_epochs"
    saved = [(r, getattr(r, node).get(key)) for r in (jax_root, root)]
    for r, _ in saved:
        getattr(r, node).update({key: epochs})

    def restore():
        for r, value in saved:
            getattr(r, node).update({key: value})
    return restore


def _build_both(name):
    """Both packages' workflows of ``name``, initialized on the CPU from
    the same global seed: ((jax launcher, sw), (port launcher, sw))."""
    from veles_tpu.launcher import Launcher as JaxLauncher
    import veles_tpu.prng as jax_prng
    jax_module, module = _modules(name)
    jlauncher = JaxLauncher()
    jsw = jax_module.build(jlauncher)
    jax_prng.get().seed(SEED)
    jlauncher.initialize(device="cpu")
    launcher = Launcher()
    sw = module.build(launcher)
    prng.get().seed(SEED)
    launcher.initialize(device="cpu")
    return (jlauncher, jsw), (launcher, sw)


def _states(jsw, sw):
    from veles_tpu.compiler import extract_state as jax_extract
    from veles_tpu_torch.compiler import extract_state
    from veles_tpu_torch.convert import state_to_numpy
    want = [{k: None if v is None else numpy.asarray(v)
             for k, v in e.items()} for e in jax_extract(jsw)]
    return want, state_to_numpy(extract_state(sw))


@pytest.mark.parametrize("name", [n for n, _ in DIGITS] + GATED)
def test_layer_plan_and_initial_leaves_equal_jax(name, monkeypatch):
    jax_module, module = _modules(name)
    if name in GATED:
        _patch_arrays(monkeypatch, name, (jax_module, module))
    (_, jsw), (_, sw) = _build_both(name)
    assert [type(f).__name__ for f in sw.forwards] == \
        [type(f).__name__ for f in jsw.forwards]
    assert [f.MAPPING for f in sw.forwards] == \
        [f.MAPPING for f in jsw.forwards]
    assert [type(g).__name__ for g in sw.gds] == \
        [type(g).__name__ for g in jsw.gds]
    assert tuple(sw.forwards[-1].output.shape) == \
        tuple(jsw.forwards[-1].output.shape)
    want, got = _states(jsw, sw)
    assert len(got) == len(want)
    leaves = 0
    for g, w in zip(got, want):
        assert sorted(k for k, v in g.items() if v is not None) == \
            sorted(k for k, v in w.items() if v is not None)
        for key, value in w.items():
            if value is None:
                continue
            assert g[key].shape == value.shape, key
            assert g[key].dtype == value.dtype, key
            assert g[key].tobytes() == value.tobytes(), key
            leaves += 1
    assert leaves >= 2 * len([f for f in sw.forwards if f.weights])


@pytest.mark.parametrize("name,node", DIGITS,
                         ids=[n for n, _ in DIGITS])
def test_first_epoch_per_unit_matches_jax(name, node):
    from veles_tpu.config import root as jax_root
    _modules(name)
    restore = _epochs(node, 1)
    blocks = [(r, getattr(r, node).get("blocks")) for r in (jax_root, root)]
    if name == "transformer":
        for r, _ in blocks:
            r.transformer.blocks = 1
    try:
        (jlauncher, jsw), (launcher, sw) = _build_both(name)
    finally:
        restore()
        for r, value in blocks:
            if value is not None:
                getattr(r, node).blocks = value
    want0, got0 = _states(jsw, sw)
    for g, w in zip(got0, want0):
        if w["weights"] is not None:
            assert g["weights"].tobytes() == w["weights"].tobytes()
    jlauncher.run()
    launcher.run()
    want, got = _states(jsw, sw)
    for g, w in zip(got, want):
        for key, value in w.items():
            if value is None:
                continue
            value = value.astype(numpy.float64)
            rel = numpy.abs(g[key] - value).max() / \
                max(numpy.abs(value).max(), 1e-30)
            assert rel <= 1e-4, (key, rel)
    assert sw.decision.epoch_number == jsw.decision.epoch_number == 1
    for cls in (1, 2):
        ours, theirs = (d.epoch_metrics[cls]
                        for d in (sw.decision, jsw.decision))
        if sw.loss == "mse":
            assert abs(ours - theirs) <= 1e-4 * abs(theirs), (cls, ours,
                                                              theirs)
        else:
            n = sw.decision.class_lengths[cls]
            errs = [round(m * n / 100.0) for m in (ours, theirs)]
            assert abs(errs[0] - errs[1]) <= 1, errs


def test_digits_turbo_reaches_anchor_quality(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("VELES_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "veles_tpu_torch", "examples",
                                      "digits_turbo.py"),
         "--backend", "cpu", "--epochs", "30"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-1500:]
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("epoch ") for line in lines) == 30
    last = [line for line in lines
            if line.startswith("best validation error")][-1]
    err = float(last.split()[3].rstrip("%"))
    assert err < 4.0, last


def test_digits_turbo_takes_the_card_unless_asked(monkeypatch):
    """Without ``--backend`` the example asks for the card, which raises
    on a host without one; ``auto`` is not a choice."""
    module = importlib.import_module("veles_tpu_torch.examples.digits_turbo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--epochs", "1"])
    with pytest.raises(SystemExit):
        module.main(["--backend", "auto"])


@pytest.mark.parametrize("name", WORKFLOWS)
def test_workflow_takes_the_card_unless_asked(name, monkeypatch):
    """``python -m veles_tpu_torch <example> -`` without ``-d`` asks for
    the card and, on a host without one, raises before any data is read
    or any unit runs.  (The test suite's ``VELES_BACKEND=cpu`` is
    dropped, and the engine's backend put back to the default it gives a
    fresh process.)"""
    from veles_tpu_torch.__main__ import Main
    saved = copy.deepcopy(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    main = Main()
    try:
        root.common.engine.backend = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"), \
                restored_imports():
            main.run([os.path.join(REPO, "veles_tpu_torch", "examples",
                                   name + ".py"), "-"])
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved.__dict__)


def test_in_process_cli_leaves_the_imports_as_they_were(monkeypatch):
    """The command line run in this process on the port's kohonen.py
    imports it as ``kohonen`` from the port's examples directory, put
    first on the path; ``restored_imports`` puts the path back and drops
    the module, so ``import kohonen`` with the repo's ``examples/``
    first is the JAX package's file again (tests/test_zoo.py's import)."""
    from veles_tpu_torch.__main__ import Main
    port_file = os.path.join(REPO, "veles_tpu_torch", "examples",
                             "kohonen.py")
    path = list(sys.path)
    cached = sys.modules.get("kohonen")
    saved = copy.deepcopy(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    seen = {}
    try:
        root.common.engine.backend = "cuda"
        with restored_imports():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Main().run([port_file, "-"])
            seen["path0"] = sys.path[0]
            seen["module"] = sys.modules["kohonen"].__file__
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved.__dict__)
    # the leak the helper repairs
    assert seen == {"path0": os.path.dirname(port_file),
                    "module": port_file}
    assert sys.path == path
    assert sys.modules.get("kohonen") is cached
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        module = importlib.import_module("kohonen")
    finally:
        sys.path[:] = path
        if cached is None:
            sys.modules.pop("kohonen", None)
    assert module.__file__ == os.path.join(REPO, "examples", "kohonen.py")


@pytest.mark.parametrize("name,check", [
    ("kohonen", "SOM validation purity"),
    ("rbm", "RBM holdout reconstruction error")])
def test_unsupervised_examples_through_the_command_line(name, check,
                                                        tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("VELES_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch",
         os.path.join(REPO, "veles_tpu_torch", "examples", name + ".py"),
         "-", "-d", "cpu", "root.%s.epochs=5" % name],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stderr.splitlines() if check in l][-1]
    assert "5 epochs" in line, line


#: the canonical-shaped seeded drop each dataset-gated example reads
WRITERS = {"mnist": chip_smoke.write_mnist_drop,
           "mnist_autoencoder": chip_smoke.write_mnist_drop,
           "cifar10": chip_smoke.write_cifar10_drop,
           "stl10": chip_smoke.write_stl10_drop}


@pytest.mark.parametrize("name", [
    "mnist", "mnist_autoencoder", "cifar10",
    pytest.param("stl10", marks=pytest.mark.slow)])
def test_dataset_gated_example_steps_on_a_seeded_drop(name, tmp_path):
    from veles_tpu_torch.loader.base import TRAIN
    WRITERS[name](str(tmp_path), numpy.random.RandomState(0))
    module = importlib.import_module("veles_tpu_torch.examples." + name)
    saved = root.common.dirs.datasets
    root.common.dirs.datasets = str(tmp_path)
    sw = None
    try:
        launcher = Launcher()
        sw = module.build(launcher)
        sw.fuse()
        prng.get().seed(SEED)
        sw.initialize(device=Device("cpu"))
        train, valid = CANONICAL["mnist" if name.startswith("mnist")
                                 else name][0]
        assert list(sw.loader.class_lengths) == [0, valid, train]
        # one evaluation step on the first served minibatch (the
        # validation class comes first), then the train step on it
        sw.loader.run()
        sw.fused_trainer.run()
        sw.loader.minibatch_class = TRAIN
        sw.fused_trainer.run()
        loss = float(sw.fused_trainer.last_loss)
        assert numpy.isfinite(loss), (name, loss)
    finally:
        root.common.dirs.datasets = saved
        if sw is not None:
            sw.stop()
