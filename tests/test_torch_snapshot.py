"""The port's snapshots (veles_tpu_torch/snapshotter.py, workflow.py's
restore_workflow, package.py) against the JAX package's, on the CPU.

- The counterparts of tests/test_snapshot.py: run gating (interval,
  time interval, skip, disable), the codecs and the extensionless
  sniff, damaged files (zero bytes, a truncated gz, a truncated plain
  pickle), manifest verification, legacy snapshots without a manifest,
  retention, ``resolve_resume``, a failed sqlite record and a failed
  ``_current`` flip, and a fallback that never crosses workflows.  The
  file-level cases run the same bytes through both packages'
  ``SnapshotterBase`` and assert the same outcome.
- One format for both packages, on the CLI blobs workflow of
  tests/test_cli.py: a JAX-written snapshot restores in the port and its
  next 2 epochs agree with JAX's continued run within 1e-4 (max-rel,
  every leaf); a port-written snapshot holds no ``torch`` object,
  unpickles in the JAX package through a find_class that maps the
  module paths, and trains on there within 1e-4 of the port's run.
- A class with no counterpart in the port, or a JAX object, raises
  SnapshotError naming it.
- ``export_workflow`` writes byte-identical tar members in both
  packages for the same weights.
- Raw state snapshots, the publish directory, and the ``snapshot.write``
  chaos point (a crash leaves only a ``.tmp``; ENOSPC keeps training).
"""

import contextlib
import gzip
import importlib
import io
import os
import pickle
import sys
import tarfile
import textwrap
import time

import numpy
import pytest
import torch

from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.snapshotter import (
    MANIFEST_SUFFIX, SnapshotError, Snapshotter, SnapshotterBase,
    latest_state_snapshot, load_state_snapshot, publish_snapshot,
    read_latest, write_state_snapshot)
from veles_tpu_torch.workflow import restore_workflow

CPU = Device(backend="cpu")
#: the workflow tests' epoch limit (tests/test_torch_workflow.py)
EPOCH_TOL = 1e-4



def _jax_snapshotter():
    """The JAX package's snapshotter, imported in the test that needs it
    (the card's machine has no JAX: its ``cuda`` tests import none)."""
    import veles_tpu.snapshotter
    return veles_tpu.snapshotter


def _package(name):
    """(SnapshotterBase, SnapshotError) of one package."""
    module = _jax_snapshotter() if name == "jax" else None
    if module is None:
        return SnapshotterBase, SnapshotError
    return module.SnapshotterBase, module.SnapshotError


class Blobs(FullBatchLoader):
    """tests/test_models.py's BlobsLoader on the port: 4 Gaussian
    blobs, learnable to ~0 error."""

    def load_data(self):
        self.class_lengths[:] = [0, 64, 256]
        self._calc_class_end_offsets()
        self.create_originals((16,))
        rng = numpy.random.RandomState(99)
        centers = rng.randn(4, 16) * 2.0
        for i in range(self.total_samples):
            label = i % 4
            self.original_data.mem[i] = centers[label] + rng.randn(16) * 0.3
            self.original_labels[i] = label


def _build(max_epochs, fuse=False, run=False):
    sw = StandardWorkflow(
        DummyWorkflow().workflow,
        layers=[
            {"type": "all2all_tanh", "output_sample_shape": 32,
             "learning_rate": 0.05, "gradient_moment": 0.9},
            {"type": "softmax", "output_sample_shape": 4,
             "learning_rate": 0.05, "gradient_moment": 0.9},
        ],
        loader_factory=lambda w: Blobs(
            w, minibatch_size=64, prng=RandomGenerator("snap", seed=9)),
        decision_config=dict(max_epochs=max_epochs))
    if fuse:
        sw.fuse()
    sw.initialize(device=CPU)
    if run:
        sw.run()
    return sw


def _host(arr):
    arr.map_read()
    return numpy.array(arr.mem)


def _model_state(sw):
    """Every leaf of the model: weights and bias of the forwards, the
    solver accumulators of the gds."""
    state = {}
    for i, (fwd, gd) in enumerate(zip(sw.forwards, sw.gds)):
        for name in ("weights", "bias"):
            state["%s%d" % (name, i)] = _host(getattr(fwd, name))
        for name in ("accum_weights", "accum_bias"):
            state["%s%d" % (name, i)] = _host(getattr(gd, name))
    return state


def _max_rel(got, want):
    worst = 0.0
    for key, leaf in want.items():
        diff = numpy.abs(numpy.asarray(got[key], numpy.float64) - leaf)
        worst = max(worst, float(diff.max() /
                                 max(numpy.abs(leaf).max(), 1e-30)))
    return worst


# -- whole-workflow round trips -------------------------------------------


def test_snapshot_resume_continues_training():
    sw = _build(max_epochs=2, run=True)
    assert bool(sw.decision.complete)
    epoch_before = sw.decision.epoch_number
    weights_before = _host(sw.forwards[0].weights)

    restored = pickle.loads(pickle.dumps(sw,
                                         protocol=pickle.HIGHEST_PROTOCOL))
    restored.workflow = DummyLauncher()
    restored.restored_from_snapshot_ = True
    restored.decision.max_epochs = 4
    restored.decision.complete <<= False
    restored.initialize(device=CPU)
    numpy.testing.assert_array_equal(_host(restored.forwards[0].weights),
                                     weights_before)
    assert restored.loader.epoch_number == epoch_before
    restored.run()
    assert bool(restored.decision.complete)
    assert restored.decision.epoch_number >= 4
    assert restored.decision.epoch_metrics[1] < 5.0


def test_snapshotter_unit_writes_and_imports(tmp_path):
    sw = _build(max_epochs=1, run=True)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="t",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    snap.run()
    assert snap.destination and os.path.exists(snap.destination)
    assert os.path.islink(os.path.join(str(tmp_path), "t_current"))
    assert snap.last_export["bytes"] > 0
    restored = SnapshotterBase.import_file(snap.destination)
    assert type(restored).__name__ == "StandardWorkflow"
    restored.workflow = DummyLauncher()
    restored.initialize(device=CPU)
    numpy.testing.assert_array_equal(_host(restored.forwards[0].weights),
                                     _host(sw.forwards[0].weights))


@pytest.mark.parametrize("codec", ["", "gz", "bz2", "xz"])
def test_snapshotter_codecs(tmp_path, codec):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path),
                       prefix="c%s" % (codec or "raw"), interval=1,
                       time_interval=0, compression=codec)
    snap.initialize()
    snap.export()
    assert snap.destination.endswith(".pickle" + ("." + codec if codec
                                                  else ""))
    restored = SnapshotterBase.import_file(snap.destination)
    numpy.testing.assert_array_equal(_host(restored.forwards[1].weights),
                                     _host(sw.forwards[1].weights))


@pytest.mark.parametrize("fuse", [False, True], ids=["per_unit", "fused"])
def test_port_snapshot_holds_no_torch_object(tmp_path, fuse):
    """Every tensor of the run (weights on the device, the metrics the
    decision adds up, the skip counters) leaves the pickle as numpy
    arrays and Python numbers: an unpickler that refuses ``torch.*``
    reads it whole."""
    sw = _build(max_epochs=1, fuse=fuse, run=True)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="nt",
                       interval=1, time_interval=0, compression="")
    snap.initialize()
    snap.export()
    restored = _refuse_torch_load(snap.destination)
    numpy.testing.assert_array_equal(
        restored.forwards[0].weights.mem, _host(sw.forwards[0].weights))
    # mid-epoch, with the decision's totals and the counters on the
    # device: 2 validation and 2 train minibatches
    from test_torch_workflow import fused_step, unit_step
    for _ in range(4):
        (fused_step if fuse else unit_step)(sw)
    assert isinstance(sw.decision.epoch_n_err[2], torch.Tensor)
    blob = pickle.dumps(sw, protocol=pickle.HIGHEST_PROTOCOL)
    restored = _RefuseTorch(io.BytesIO(blob)).load()
    assert restored.decision.epoch_n_err == [
        int(v) for v in sw.decision.epoch_n_err]


@pytest.mark.cuda
def test_cuda_port_snapshot_taken_on_the_card_holds_no_torch_object(
        tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sw = StandardWorkflow(
        DummyLauncher(), layers=[
            {"type": "all2all_tanh", "output_sample_shape": 32},
            {"type": "softmax", "output_sample_shape": 4}],
        loader_factory=lambda w: Blobs(
            w, minibatch_size=64, prng=RandomGenerator("snap", seed=9)),
        decision_config=dict(max_epochs=1))
    sw.initialize(device=Device())
    sw.run()
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="card",
                       interval=1, time_interval=0, compression="")
    snap.initialize()
    snap.export()
    restored = _refuse_torch_load(snap.destination)
    numpy.testing.assert_array_equal(
        restored.forwards[0].weights.mem, _host(sw.forwards[0].weights))


class _RefuseTorch(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "torch":
            raise pickle.UnpicklingError(
                "torch object %s.%s in a snapshot" % (module, name))
        return super(_RefuseTorch, self).find_class(module, name)


def _refuse_torch_load(path):
    with open(path, "rb") as fin:
        return _RefuseTorch(fin).load()


# -- run gating (interval / time_interval / skip / disable) ----------------


class _RecordingSnapshotter(SnapshotterBase):
    """Counts exports without paying for a real workflow pickle."""

    def __init__(self, *args, **kwargs):
        super(_RecordingSnapshotter, self).__init__(*args, **kwargs)
        self.exports = 0

    def export(self):
        self.exports += 1
        self.destination = os.path.join(
            self.directory, "%s_fake%d" % (self.prefix, self.exports))


def _recording(tmp_path, **kwargs):
    snap = _RecordingSnapshotter(DummyWorkflow(), directory=str(tmp_path),
                                 **kwargs)
    snap.initialize()
    return snap


def test_run_gating_interval(tmp_path):
    snap = _recording(tmp_path, interval=2, time_interval=0)
    snap.run()
    assert snap.exports == 0, "counter 1 is not a multiple of 2"
    snap.run()
    assert snap.exports == 1
    snap.run()
    snap.run()
    assert snap.exports == 2


def test_run_gating_time_interval_first_snapshot_exempt(tmp_path):
    snap = _recording(tmp_path, interval=1, time_interval=3600)
    snap.run()
    assert snap.exports == 1, "first snapshot must ignore time_interval"
    snap.run()
    assert snap.exports == 1, "repeat within time_interval throttled"


def test_run_gating_skip_bool(tmp_path):
    snap = _recording(tmp_path, interval=1, time_interval=0)
    snap.skip <<= True
    snap.run()
    snap.run()
    assert snap.exports == 0
    snap.skip <<= False
    snap.run()
    assert snap.exports == 1


def test_run_gating_disable_config(tmp_path):
    snap = _recording(tmp_path, interval=1, time_interval=0)
    root.common.disable.update({"snapshotting": True})
    try:
        snap.run()
        assert snap.exports == 0
    finally:
        root.common.disable.update({"snapshotting": False})
    snap.run()
    assert snap.exports == 1


# -- import_file on damaged files: both packages, same bytes --------------


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_import_file_zero_byte(tmp_path, package):
    base, error = _package(package)
    path = tmp_path / "empty.pickle"
    path.write_bytes(b"")
    with pytest.raises(error) as err:
        base.import_file(str(path))
    assert "no usable snapshot" in str(err.value)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_import_file_truncated_gz(tmp_path, package):
    base, error = _package(package)
    blob = gzip.compress(pickle.dumps({"k": list(range(1000))}))
    path = tmp_path / "cut.pickle.gz"
    path.write_bytes(blob[:len(blob) // 2])  # valid magic, torn body
    with pytest.raises(error):
        base.import_file(str(path))


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_import_file_truncated_plain_pickle(tmp_path, package):
    base, error = _package(package)
    path = tmp_path / "cut.pickle"
    path.write_bytes(pickle.dumps({"k": 1})[:-3])
    with pytest.raises(error):
        base.import_file(str(path))


@pytest.mark.parametrize("codec", ["gz", "bz2", "xz"])
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_import_file_sniffs_extensionless(tmp_path, package, codec):
    """The _current symlink carries no extension: the codec comes from
    the magic bytes."""
    import bz2
    import lzma
    compress = {"gz": gzip.compress, "bz2": bz2.compress,
                "xz": lzma.compress}[codec]
    path = tmp_path / "no_extension"
    path.write_bytes(compress(pickle.dumps({"ok": 42})))
    assert _package(package)[0].import_file(str(path)) == {"ok": 42}


# -- manifest / atomicity / retention -------------------------------------


def test_export_writes_verified_manifest(tmp_path):
    sw = _build(max_epochs=1, run=True)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="m",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    snap.export()
    dest = snap.destination
    assert os.path.exists(dest + MANIFEST_SUFFIX)
    assert not os.path.exists(dest + ".tmp"), "tmp residue after export"
    ok, manifest = SnapshotterBase.verify_snapshot(dest)
    assert ok is True
    assert manifest["nbytes"] == os.path.getsize(dest)
    assert manifest["codec"] == "gz"
    assert manifest["workflow"] == "StandardWorkflow"
    assert manifest["checksum"] == sw.checksum
    assert manifest["epoch"] == sw.decision.epoch_number
    ok, _ = SnapshotterBase.verify_snapshot(
        os.path.join(str(tmp_path), "m_current"))
    assert ok is True
    # the JAX package verifies the port's manifest the same way
    assert _jax_snapshotter().SnapshotterBase.verify_snapshot(dest)[0] is True


def test_verify_snapshot_detects_truncation_and_corruption(tmp_path):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="v",
                       interval=1, time_interval=0, compression="")
    snap.initialize()
    snap.export()
    dest = snap.destination
    original = open(dest, "rb").read()
    with open(dest, "wb") as fout:
        fout.write(original[:-10])
    ok, reason = SnapshotterBase.verify_snapshot(dest)
    assert ok is False and "size mismatch" in reason
    with open(dest, "wb") as fout:
        fout.write(original[:-1] + bytes([original[-1] ^ 0xFF]))
    ok, reason = SnapshotterBase.verify_snapshot(dest)
    assert ok is False and "sha256" in reason
    with open(dest, "wb") as fout:
        fout.write(original)
    assert SnapshotterBase.verify_snapshot(dest)[0] is True


def test_legacy_snapshot_without_manifest_still_imports(tmp_path):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="l",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    snap.export()
    os.remove(snap.destination + MANIFEST_SUFFIX)
    ok, reason = SnapshotterBase.verify_snapshot(snap.destination)
    assert ok is None and reason == "no manifest"
    assert SnapshotterBase.import_file(snap.destination) is not None


def test_retention_keeps_newest_and_current(tmp_path):
    sw = _build(max_epochs=1, run=True)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="r",
                       interval=1, time_interval=0, compression="gz",
                       keep=2)
    snap.initialize()
    for i in range(5):
        snap.suffix = "e%d" % i
        snap.export()
        time.sleep(0.02)  # distinct mtimes for the retention sort
    pickles = sorted(f for f in os.listdir(str(tmp_path))
                     if ".pickle" in f and not f.endswith(MANIFEST_SUFFIX)
                     and not f.endswith(".tmp"))
    assert len(pickles) <= 3  # keep=2, + the best-by-metric may stay
    assert any("e4" in f for f in pickles), "newest must survive"
    assert any("e3" in f for f in pickles)
    target = os.path.realpath(os.path.join(str(tmp_path), "r_current"))
    assert os.path.exists(target), "_current target must never be pruned"
    manifests = [f for f in os.listdir(str(tmp_path))
                 if f.endswith(MANIFEST_SUFFIX)]
    assert len(manifests) == len(pickles)


def test_resolve_resume(tmp_path):
    assert SnapshotterBase.resolve_resume("") is None
    assert SnapshotterBase.resolve_resume(
        "auto", directory=str(tmp_path / "missing")) is None
    with pytest.raises(SnapshotError):
        SnapshotterBase.resolve_resume(str(tmp_path / "nope.pickle"))
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="a",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    snap.suffix = "one"
    snap.export()
    resolved = SnapshotterBase.resolve_resume("auto",
                                              directory=str(tmp_path))
    assert resolved == os.path.realpath(
        os.path.join(str(tmp_path), "a_current"))
    assert SnapshotterBase.resolve_resume(snap.destination) == \
        snap.destination
    # the JAX package resolves the port's directory to the same file
    assert _jax_snapshotter().SnapshotterBase.resolve_resume(
        "auto", directory=str(tmp_path)) == resolved


def test_record_in_db_failure_warns_not_raises(tmp_path, caplog):
    sw = _build(max_epochs=1)
    bad_db = os.path.join(str(tmp_path), "no_such_dir", "snap.sqlite")
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="db",
                       interval=1, time_interval=0, compression="gz",
                       db_path=bad_db)
    snap.initialize()
    snap.export()  # must not raise
    assert snap.destination and os.path.exists(snap.destination)
    assert any("snapshot db record failed" in r.message
               for r in caplog.records)


def test_record_in_db_writes_history(tmp_path):
    import sqlite3
    sw = _build(max_epochs=1, run=True)
    db = str(tmp_path / "snap.sqlite")
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="h",
                       interval=1, time_interval=0, compression="",
                       db_path=db)
    snap.initialize()
    snap.export()
    snap.export()
    with sqlite3.connect(db) as conn:
        rows = conn.execute("SELECT workflow, destination, epoch, "
                            "best_metric FROM snapshots").fetchall()
    assert len(rows) == 2
    assert rows[1][0] == "StandardWorkflow"
    assert rows[1][1] == snap.destination
    assert rows[1][2] == sw.decision.epoch_number
    assert rows[1][3] == sw.decision.best_metric


def test_failed_current_link_flip_warns(tmp_path, monkeypatch, caplog):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="ln",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()

    def broken_symlink(*args, **kwargs):
        raise OSError("symlinks unavailable")

    monkeypatch.setattr(os, "symlink", broken_symlink)
    snap.export()  # must not raise
    assert snap.destination and os.path.exists(snap.destination)
    assert any("failed to update snapshot link" in r.message
               for r in caplog.records)


class OtherWorkflow(StandardWorkflow):
    """A second model snapshotting into the same directory."""

    hide_from_registry = True


def test_fallback_never_crosses_workflows(tmp_path, caplog):
    sw = _build(max_epochs=1)
    mine = Snapshotter(sw, directory=str(tmp_path), prefix="mine",
                       interval=1, time_interval=0, compression="gz")
    mine.initialize()
    mine.suffix = "old"
    mine.export()
    my_old = mine.destination
    time.sleep(0.02)
    mine.suffix = "new"
    mine.export()
    my_new = mine.destination

    time.sleep(0.02)
    other_sw = _build(max_epochs=1)
    object.__setattr__(other_sw, "__class__", OtherWorkflow)
    other = Snapshotter(other_sw, directory=str(tmp_path),
                        prefix="other", interval=1, time_interval=0,
                        compression="gz")
    other.initialize()
    other.export()  # newest file in the directory, wrong workflow

    with open(my_new, "r+b") as fout:  # corrupt my newest
        fout.seek(os.path.getsize(my_new) // 2)
        byte = fout.read(1)
        fout.seek(-1, os.SEEK_CUR)
        fout.write(bytes([byte[0] ^ 0xFF]))

    restored = SnapshotterBase.import_file(
        os.path.join(str(tmp_path), "mine_current"))
    assert type(restored).__name__ == "StandardWorkflow", \
        "fell back to a different workflow's snapshot"
    assert any(os.path.basename(my_old) in r.message and
               "previous-good" in r.message for r in caplog.records)


# -- one format for both packages ------------------------------------------

#: tests/test_cli.py's CliBlobs, written for one package; the snapshot
#: names the class ``cli_blobs.CliBlobs``, and each side imports its own
_CLI_BLOBS = textwrap.dedent('''
    import numpy
    from {loader} import FullBatchLoader


    class CliBlobs(FullBatchLoader):
        def load_data(self):
            self.class_lengths[:] = [0, 32, 96]
            self._calc_class_end_offsets()
            self.create_originals((8,))
            rng = numpy.random.RandomState(1)
            centers = rng.randn(3, 8) * 2
            for i in range(self.total_samples):
                label = i % 3
                self.original_data.mem[i] = (
                    centers[label] + rng.randn(8) * 0.2)
                self.original_labels[i] = label
''')

_CLI_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": 3,
     "learning_rate": 0.05, "gradient_moment": 0.9},
]


@contextlib.contextmanager
def _cli_blobs(tmp_path, package, name="cli_blobs", text=_CLI_BLOBS):
    """The module ``name`` (by default ``cli_blobs``) importable as
    ``package``'s version of the loader while the block runs."""
    loader = {"jax": "veles_tpu.loader",
              "torch": "veles_tpu_torch.loader.fullbatch"}[package]
    directory = tmp_path / package
    directory.mkdir(exist_ok=True)
    (directory / (name + ".py")).write_text(text.format(loader=loader))
    sys.modules.pop(name, None)
    sys.path.insert(0, str(directory))
    try:
        yield importlib.import_module(name)
    finally:
        sys.path.remove(str(directory))
        sys.modules.pop(name, None)


def _jax_cli_workflow(module, max_epochs):
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
    from veles_tpu.prng import RandomGenerator as JaxRandom
    import veles_tpu.prng as jax_prng
    jax_prng.get().seed(7)
    sw = JaxWorkflow(
        JaxLauncher(), layers=[dict(s) for s in _CLI_LAYERS],
        loader_factory=lambda w: module.CliBlobs(
            w, minibatch_size=32, prng=JaxRandom("cli", seed=4)),
        decision_config=dict(max_epochs=max_epochs))
    sw.initialize(device=JaxDevice(backend="cpu"))
    return sw


def _torch_cli_workflow(module, max_epochs):
    import veles_tpu_torch.prng as torch_prng
    torch_prng.get().seed(7)
    sw = StandardWorkflow(
        DummyLauncher(), layers=[dict(s) for s in _CLI_LAYERS],
        loader_factory=lambda w: module.CliBlobs(
            w, minibatch_size=32, prng=RandomGenerator("cli", seed=4)),
        decision_config=dict(max_epochs=max_epochs))
    sw.initialize(device=CPU)
    return sw


def _train_on(sw, epochs):
    sw.decision.max_epochs = epochs
    sw.decision.complete <<= False
    sw.run()


def test_jax_snapshot_restores_in_the_port_and_trains_on(tmp_path):
    with _cli_blobs(tmp_path, "jax") as module:
        jsw = _jax_cli_workflow(module, max_epochs=2)
        jsw.run()
        snap = _jax_snapshotter().Snapshotter(
            jsw, directory=str(tmp_path), prefix="jax", interval=1,
            time_interval=0)
        snap.initialize()
        snap.export()
        snapshot_state = _model_state(jsw)
        _train_on(jsw, 4)
    with _cli_blobs(tmp_path, "torch"):
        tsw = restore_workflow(snap.destination, DummyLauncher())
        assert isinstance(tsw, StandardWorkflow)
        assert type(tsw.loader).__module__ == "cli_blobs"
        assert isinstance(tsw.loader, FullBatchLoader)
        tsw.initialize(device=CPU)
        assert _max_rel(_model_state(tsw), snapshot_state) == 0.0
        assert tsw.loader.epoch_number == 2
        _train_on(tsw, 4)
    assert tsw.decision.epoch_number == jsw.decision.epoch_number == 4
    assert _max_rel(_model_state(tsw), _model_state(jsw)) <= EPOCH_TOL
    assert tsw.decision.epoch_metrics == jsw.decision.epoch_metrics


class _PortToJax(pickle.Unpickler):
    """The JAX side's reader of a port snapshot: module paths mapped as
    strings, ``torch`` refused."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "torch":
            raise pickle.UnpicklingError("torch object %s.%s" % (module,
                                                                 name))
        if top == "veles_tpu_torch":
            module = "veles_tpu" + module[len(top):]
        return super(_PortToJax, self).find_class(module, name)


def test_port_snapshot_loads_in_jax_and_trains_on(tmp_path):
    with _cli_blobs(tmp_path, "torch") as module:
        tsw = _torch_cli_workflow(module, max_epochs=2)
        tsw.run()
        snap = Snapshotter(tsw, directory=str(tmp_path), prefix="port",
                           interval=1, time_interval=0, compression="gz")
        snap.initialize()
        snap.export()
        snapshot_state = _model_state(tsw)
        _train_on(tsw, 4)
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
    with _cli_blobs(tmp_path, "jax"):
        with gzip.open(snap.destination) as fin:
            jsw = _PortToJax(fin).load()
        assert isinstance(jsw, JaxWorkflow)
        jsw.workflow = JaxLauncher()
        jsw.restored_from_snapshot_ = True
        jsw.initialize(device=JaxDevice(backend="cpu"))
        assert _max_rel(_model_state(jsw), snapshot_state) == 0.0
        assert jsw.loader.epoch_number == 2
        _train_on(jsw, 4)
    assert jsw.decision.epoch_number == tsw.decision.epoch_number == 4
    assert _max_rel(_model_state(jsw), _model_state(tsw)) <= EPOCH_TOL


def _pickle_naming(module, name):
    """A protocol-2 pickle of one global ``module.name``."""
    return b"\x80\x02c" + ("%s\n%s\n" % (module, name)).encode() + b"."


@pytest.mark.parametrize("module,name", [
    # the port keeps this module's functions in observe/introspect.py
    ("veles_tpu.observe.xla_introspect", "CompileWatcher"),
    ("veles_tpu.models.nn_workflow", "NoSuchWorkflow"),
    ("jax._src.array", "ArrayImpl"),
])
def test_class_without_counterpart_raises_naming_it(tmp_path, module,
                                                     name):
    path = tmp_path / "foreign.pickle"
    path.write_bytes(_pickle_naming(module, name))
    with pytest.raises(SnapshotError) as err:
        SnapshotterBase.import_file(str(path))
    assert "%s.%s" % (module, name) in str(err.value)


def test_jax_devices_map_to_the_port_device(tmp_path):
    for name in ("CPUDevice", "TPUDevice"):
        path = tmp_path / ("%s.pickle" % name)
        path.write_bytes(b"\x80\x02cveles_tpu.backends\n" + name.encode() +
                         b"\n)\x81}b.")
        device = SnapshotterBase.import_file(str(path))
        assert isinstance(device, Device) and device.backend == "cpu"


def _package_members(path):
    with tarfile.open(path) as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


def _workflow_class(base):
    """One class name and source file for both packages: the package's
    ``checksum`` hashes them."""

    class BlobsNet(base):
        hide_from_registry = True

    return BlobsNet


@pytest.mark.parametrize("precision", ["float32", "float16"])
def test_package_export_tar_members_byte_identical(tmp_path, precision):
    from test_torch_workflow import JaxWorkflow, blobs, build_jax, \
        build_torch
    import veles_tpu.package as jax_package
    import veles_tpu_torch.package as torch_package
    arrays = blobs()
    jsw = build_jax(arrays)
    jsw.__class__ = _workflow_class(JaxWorkflow)
    tsw = build_torch(arrays)
    tsw.__class__ = _workflow_class(StandardWorkflow)
    jpath = jax_package.export_workflow(jsw, str(tmp_path / "jax.tar"),
                                        precision=precision)
    tpath = tsw.package_export(str(tmp_path / "torch.tar"),
                               precision=precision)
    want, got = _package_members(jpath), _package_members(tpath)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert torch_package.UNIT_UUIDS == jax_package.UNIT_UUIDS


# -- raw state snapshots, the publish directory, chaos ---------------------


def test_state_snapshot_round_trip(tmp_path):
    state = {"w": numpy.arange(12, dtype=numpy.float32).reshape(3, 4),
             "step": 7}
    assert latest_state_snapshot(str(tmp_path)) is None
    manifest = write_state_snapshot(str(tmp_path / "s1.pickle"), state,
                                    workflow_name="mesh", epoch=3)
    assert manifest["epoch"] == 3 and manifest["workflow"] == "mesh"
    time.sleep(0.02)
    write_state_snapshot(str(tmp_path / "s2.pickle"), dict(state, step=8))
    newest = latest_state_snapshot(str(tmp_path))
    assert newest == str(tmp_path / "s2.pickle")
    assert load_state_snapshot(newest)["step"] == 8
    # the JAX package reads the port's state snapshot
    assert _jax_snapshotter().load_state_snapshot(newest)["step"] == 8
    with open(newest, "r+b") as fout:
        fout.seek(-2, os.SEEK_END)
        fout.write(b"\x00\x00")
    with pytest.raises(SnapshotError):
        load_state_snapshot(newest)


def test_publish_snapshot_and_latest_pointer(tmp_path):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path / "train"), prefix="p",
                       interval=1, time_interval=0, compression="gz",
                       publish_dir=str(tmp_path / "pub"), publish_keep=2)
    snap.initialize()
    for _ in range(3):
        snap.export()
    latest = read_latest(str(tmp_path / "pub"))
    assert latest["ordinal"] == 3
    published = os.path.join(str(tmp_path / "pub"), latest["snapshot"])
    assert SnapshotterBase.verify_snapshot(published)[0] is True
    kept = [f for f in os.listdir(str(tmp_path / "pub"))
            if f[0].isdigit() and not f.endswith(MANIFEST_SUFFIX)]
    assert len(kept) == 2
    assert _jax_snapshotter().read_latest(str(tmp_path / "pub")) == latest
    unverifiable = tmp_path / "bare.pickle"
    unverifiable.write_bytes(pickle.dumps(1))
    with pytest.raises(SnapshotError):
        publish_snapshot(str(unverifiable), str(tmp_path / "pub"))


def test_chaos_crash_mid_write_leaves_no_torn_snapshot(tmp_path):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="cr",
                       interval=1, time_interval=0, compression="")
    snap.initialize()
    snap.export()
    good = snap.destination
    chaos.install(chaos.FaultPlan().add("snapshot.write", "crash", nth=1))
    try:
        with pytest.raises(chaos.ChaosCrash):
            snap.export()
    finally:
        chaos.uninstall()
    residue = [f for f in os.listdir(str(tmp_path)) if f.endswith(".tmp")]
    assert residue, "the crash leaves its half-written .tmp"
    assert os.path.realpath(os.path.join(str(tmp_path), "cr_current")) == \
        os.path.realpath(good)
    assert SnapshotterBase.resolve_resume("auto", str(tmp_path)) == \
        os.path.realpath(good)


def test_chaos_enospc_keeps_training(tmp_path):
    sw = _build(max_epochs=1)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="sp",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    chaos.install(chaos.FaultPlan.from_spec("snapshot.write=enospc:n1"))
    try:
        snap.export()  # logs, keeps the previous state, does not raise
    finally:
        chaos.uninstall()
    assert snap.destination is None
    assert not [f for f in os.listdir(str(tmp_path)) if ".pickle" in f]
    snap.export()
    assert SnapshotterBase.verify_snapshot(snap.destination)[0] is True


def test_checksum_and_results():
    sw = _build(max_epochs=2, run=True)
    assert sw.checksum == _build(max_epochs=1).checksum
    assert len(sw.checksum) == 40
    results = sw.gather_results()
    assert results["Total epochs"] == 2
    assert results["Best metric"] == sw.decision.best_metric
    assert set(results["Errors"]) == {"test", "validation", "train"}
    out = io.StringIO()
    sw.print_stats(out=out)
    assert "Workflow run time" in out.getvalue()


# -- a per-unit convnet with dropout, both directions ----------------------

#: 6x6x2 images of 3 classes for the per-unit convnet below
_CONV_BLOBS = textwrap.dedent('''
    import numpy
    from {loader} import FullBatchLoader


    class ConvBlobs(FullBatchLoader):
        def load_data(self):
            self.class_lengths[:] = [0, 24, 72]
            self._calc_class_end_offsets()
            self.create_originals((6, 6, 2))
            rng = numpy.random.RandomState(3)
            centers = rng.randn(3, 6, 6, 2)
            for i in range(self.total_samples):
                label = i % 3
                self.original_data.mem[i] = (
                    centers[label] + rng.randn(6, 6, 2) * 0.3)
                self.original_labels[i] = label
''')

_CONV_LAYERS = [
    {"type": "conv_relu", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "dropout", "dropout_ratio": 0.3},
    {"type": "softmax", "output_sample_shape": 3,
     "learning_rate": 0.05, "gradient_moment": 0.9},
]


def _conv_workflow(package, module, max_epochs):
    """The per-unit convnet over ``module.ConvBlobs`` in one package."""
    if package == "jax":
        from veles_tpu.backends import Device as JaxDevice
        from veles_tpu.dummy import DummyLauncher as launcher
        from veles_tpu.models.nn_workflow import StandardWorkflow as wf
        import veles_tpu.prng as rng
        device = JaxDevice(backend="cpu")
    else:
        import veles_tpu_torch.prng as rng
        launcher, wf, device = DummyLauncher, StandardWorkflow, CPU
    rng.get().seed(7)
    sw = wf(launcher(), layers=[dict(s) for s in _CONV_LAYERS],
            loader_factory=lambda w: module.ConvBlobs(
                w, minibatch_size=24, prng=rng.RandomGenerator("conv",
                                                               seed=4)),
            decision_config=dict(max_epochs=max_epochs))
    sw.initialize(device=device)
    return sw


def _conv_state(sw):
    """The parametrized layers' leaves (the pooling and dropout layers
    have none) and the dropout unit's step count."""
    state = {k: v for k, v in _model_state(sw).items()
             if v.dtype != object and v.size}
    return state, sw.forwards[2]._step


@pytest.fixture
def _jax_pallas(monkeypatch):
    """The JAX conv backward at the port's level 0 (its Pallas kernel in
    interpret mode)."""
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", "1")


def test_per_unit_convnet_port_snapshot_trains_on_in_jax(tmp_path,
                                                         _jax_pallas):
    """A port per-unit convnet with dropout, 2 epochs, snapshotted; JAX
    reads the snapshot (the same leaves and dropout step) and its next 2
    per-unit epochs agree with the port's within 1e-4."""
    with _cli_blobs(tmp_path, "torch", "conv_blobs", _CONV_BLOBS) as module:
        tsw = _conv_workflow("torch", module, 2)
        tsw.run()
        snap = Snapshotter(tsw, directory=str(tmp_path), prefix="conv",
                           interval=1, time_interval=0, compression="gz")
        snap.initialize()
        snap.export()
        snapshot_state, snapshot_step = _conv_state(tsw)
        _train_on(tsw, 4)
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    with _cli_blobs(tmp_path, "jax", "conv_blobs", _CONV_BLOBS):
        with gzip.open(snap.destination) as fin:
            jsw = _PortToJax(fin).load()
        jsw.workflow = JaxLauncher()
        jsw.restored_from_snapshot_ = True
        jsw.initialize(device=JaxDevice(backend="cpu"))
        state, step = _conv_state(jsw)
        assert _max_rel(state, snapshot_state) == 0.0
        assert step == snapshot_step > 0
        _train_on(jsw, 4)
    assert jsw.decision.epoch_number == tsw.decision.epoch_number == 4
    assert _conv_state(jsw)[1] == _conv_state(tsw)[1]
    assert _max_rel(_conv_state(jsw)[0], _conv_state(tsw)[0]) <= EPOCH_TOL


def test_per_unit_convnet_jax_snapshot_trains_on_in_the_port(tmp_path,
                                                             _jax_pallas):
    with _cli_blobs(tmp_path, "jax", "conv_blobs", _CONV_BLOBS) as module:
        jsw = _conv_workflow("jax", module, 2)
        jsw.run()
        snap = _jax_snapshotter().Snapshotter(
            jsw, directory=str(tmp_path), prefix="jaxconv", interval=1,
            time_interval=0)
        snap.initialize()
        snap.export()
        snapshot_state, snapshot_step = _conv_state(jsw)
        _train_on(jsw, 4)
    with _cli_blobs(tmp_path, "torch", "conv_blobs", _CONV_BLOBS):
        tsw = restore_workflow(snap.destination, DummyLauncher())
        tsw.initialize(device=CPU)
        state, step = _conv_state(tsw)
        assert _max_rel(state, snapshot_state) == 0.0
        assert step == snapshot_step > 0
        assert getattr(tsw, "fused_trainer", None) is None
        _train_on(tsw, 4)
    assert tsw.decision.epoch_number == jsw.decision.epoch_number == 4
    assert _conv_state(tsw)[1] == _conv_state(jsw)[1]
    assert _max_rel(_conv_state(tsw)[0], _conv_state(jsw)[0]) <= EPOCH_TOL
