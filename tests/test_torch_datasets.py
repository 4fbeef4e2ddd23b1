"""The port's datasets module (veles_tpu_torch/datasets.py) against the
JAX package's, on the CPU, on files the tests write (the counterparts of
tests/test_quality.py's dataset tests; nothing is downloaded):

- ``load_idx`` parses the same bytes to the same arrays;
- a wrong MNIST drop and a truncated CIFAR-10 or STL-10 drop fail the
  self check in both packages; an empty directory reports every dataset
  missing; ``mnist_arrays`` reads the OpenML npz cache;
- ``ingest`` stages a drop and ``python -m veles_tpu_torch.datasets
  ingest`` reports it, as the JAX package's does;
- ``digits_arrays`` reads the vendored ``digits.csv.gz`` and equals the
  JAX package's (scikit-learn's) split bit for bit; ``digits_data``
  equals ``sklearn.datasets.load_digits``;
- the loaders serve the same minibatches as the JAX package's.
"""

import gzip
import json
import os
import pickle
import struct
import subprocess
import sys

import numpy
import pytest

import veles_tpu.datasets as jax_datasets
import veles_tpu.prng as jax_prng
import veles_tpu_torch.datasets as datasets
import veles_tpu_torch.prng as torch_prng
from veles_tpu.backends import Device as JaxDevice
from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyWorkflow

from chip_smoke import write_mnist_drop
from test_torch_loaders import assert_same_serves

CPU = Device(backend="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_idx(path, arr, dtype_code=0x08):
    raw = struct.pack(">HBB", 0, dtype_code, arr.ndim)
    raw += struct.pack(">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
    path.write_bytes(gzip.compress(raw) if str(path).endswith(".gz")
                     else raw)


def test_load_idx_roundtrip(tmp_path):
    arr = numpy.arange(24, dtype=numpy.uint8).reshape(2, 3, 4)
    raw = struct.pack(">HBB", 0, 0x08, 3)
    raw += struct.pack(">III", 2, 3, 4) + arr.tobytes()
    (tmp_path / "t.idx").write_bytes(raw)
    (tmp_path / "t.idx.gz").write_bytes(gzip.compress(raw))
    arr32 = numpy.array([[1, -2], [300000, 4]], dtype=">i4")
    (tmp_path / "t32.idx").write_bytes(
        struct.pack(">HBB", 0, 0x0C, 2) + struct.pack(">II", 2, 2) +
        arr32.tobytes())
    for name, want in (("t.idx", arr), ("t.idx.gz", arr), ("t32.idx", arr32)):
        path = str(tmp_path / name)
        got = datasets.load_idx(path)
        numpy.testing.assert_array_equal(got, want)
        ref = jax_datasets.load_idx(path)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    (tmp_path / "bad.idx").write_bytes(b"\x01\x00\x08\x01" + b"\0" * 8)
    with pytest.raises(ValueError, match="bad idx magic"):
        datasets.load_idx(str(tmp_path / "bad.idx"))


@pytest.mark.parametrize("module", [datasets, jax_datasets],
                         ids=["port", "jax"])
def test_mnist_selfcheck_rejects_wrong_drop(tmp_path, module):
    wrong = numpy.zeros((5, 28, 28), numpy.uint8)
    labels = numpy.zeros(5, numpy.uint8)
    for key, filename in module.MNIST_FILES.items():
        _write_idx(tmp_path / filename,
                   wrong if key.endswith("images") else labels)
    with pytest.raises(module.DatasetNotFound, match="self-check failed"):
        module.mnist_arrays(str(tmp_path), download=False)


@pytest.mark.parametrize("module", [datasets, jax_datasets],
                         ids=["port", "jax"])
def test_cifar_selfcheck_rejects_truncated_drop(tmp_path, module):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    batch = {b"data": numpy.zeros((7, 3072), numpy.uint8),
             b"labels": [0] * 7}
    for name in ["data_batch_%d" % i for i in range(1, 6)] + [
            "test_batch"]:
        with open(base / name, "wb") as fout:
            pickle.dump(batch, fout)
    with pytest.raises(module.DatasetNotFound, match="self-check failed"):
        module.cifar10_arrays(str(tmp_path), download=False)


@pytest.mark.parametrize("module", [datasets, jax_datasets],
                         ids=["port", "jax"])
def test_stl10_selfcheck_rejects_truncated_drop(tmp_path, module):
    base = tmp_path / "stl10_binary"
    base.mkdir()
    for name in ("train_X.bin", "train_y.bin", "test_X.bin", "test_y.bin"):
        (base / name).write_bytes(b"\0" * 1000)
    with pytest.raises(module.DatasetNotFound, match="self-check failed"):
        module.stl10_arrays(str(tmp_path), download=False)


def test_selfcheck_reports_missing_when_no_drop(tmp_path):
    report = datasets.selfcheck(str(tmp_path))
    want = jax_datasets.selfcheck(str(tmp_path))
    for name in ("mnist", "cifar10", "stl10"):
        assert report[name]["status"] == want[name]["status"] == "missing"


def test_mnist_reads_the_openml_cache(tmp_path):
    rng = numpy.random.RandomState(1)
    arrays = dict(
        train_x=rng.rand(60000, 784).astype(numpy.float32),
        train_y=rng.randint(0, 10, 60000).astype(numpy.int32),
        test_x=rng.rand(10000, 784).astype(numpy.float32),
        test_y=rng.randint(0, 10, 10000).astype(numpy.int32))
    numpy.savez(str(tmp_path / "mnist_openml.npz"), **arrays)
    got = datasets.mnist_arrays(str(tmp_path), download=False)
    want = jax_datasets.mnist_arrays(str(tmp_path), download=False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert datasets.selfcheck(str(tmp_path))["mnist"]["source"] == "openml"


def test_ingest_stages_drop_and_selfchecks(tmp_path):
    drop = tmp_path / "drop" / "nested"
    drop.mkdir(parents=True)
    write_mnist_drop(drop, numpy.random.RandomState(2))
    cdir = drop / "cifar-10-batches-py"
    cdir.mkdir()
    batch = {b"data": numpy.zeros((10000, 3072), numpy.uint8),
             b"labels": [0] * 10000}
    for name in ["data_batch_%d" % i for i in range(1, 6)] + [
            "test_batch"]:
        with open(cdir / name, "wb") as fout:
            pickle.dump(batch, fout)
    reports = []
    for module, cache in ((datasets, "port"), (jax_datasets, "jax")):
        (tmp_path / cache).mkdir()
        reports.append(module.ingest(str(tmp_path / "drop"),
                                     str(tmp_path / cache)))
    report, want = reports
    assert report["mnist"]["status"] == "ok"
    assert report["cifar10"]["status"] == "ok"
    assert report["stl10"]["status"] == "missing"
    assert len(report["cifar10"]["files"]) == 6
    assert len(report["ingested"]["files"]) == 10
    for name in ("mnist", "cifar10"):
        assert report[name]["files"] == want[name]["files"]
    tx, ty, vx, vy = datasets.mnist_arrays(str(tmp_path / "port"),
                                           download=False)
    assert tx.shape == (60000, 784) and vx.shape == (10000, 784)
    ref = jax_datasets.mnist_arrays(str(tmp_path / "jax"), download=False)
    for g, w in zip((tx, ty, vx, vy), ref):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_ingest_cli_command(tmp_path):
    drop = tmp_path / "drop"
    drop.mkdir()
    cache = tmp_path / "cache"
    cache.mkdir()
    write_mnist_drop(drop)
    env = dict(os.environ, VELES_BACKEND="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.datasets", "ingest",
         str(drop), "--data-dir", str(cache)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-1500:]
    report = json.loads(proc.stdout)
    assert report["mnist"]["status"] == "ok"
    assert report["mnist"]["source"] == "idx"
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.datasets", "selfcheck",
         "--data-dir", str(tmp_path / "empty")],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["mnist"]["status"] == "missing"


def test_digits_arrays_equal_jax_bit_for_bit():
    got = datasets.digits_arrays()
    want = jax_datasets.digits_arrays()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    tx, ty, vx, vy = got
    assert tx.shape == (1437, 64) and vx.shape == (360, 64)
    assert tx.dtype == numpy.float32 and ty.dtype == numpy.int32
    assert 0.0 <= tx.min() and tx.max() <= 1.0
    assert set(numpy.unique(vy)) <= set(range(10))
    for g, w in zip(datasets.digits_arrays(100, 7),
                    jax_datasets.digits_arrays(100, 7)):
        assert g.tobytes() == w.tobytes()


def test_digits_data_is_sklearns():
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    bunch = sklearn_datasets.load_digits()
    data, target = datasets.digits_data()
    assert data.dtype == bunch.data.dtype
    assert data.tobytes() == bunch.data.tobytes()
    numpy.testing.assert_array_equal(target, bunch.target)


def test_vendored_digits_file():
    """The copy of scikit-learn's digits.csv.gz the port reads: 1,797
    rows of 64 pixels in 0..16 and a digit."""
    assert os.path.getsize(datasets.DIGITS_FILE) == 57523
    data, target = datasets.digits_data()
    assert data.shape == (1797, 64) and target.shape == (1797,)
    assert data.min() == 0 and data.max() == 16
    assert sorted(set(target.tolist())) == list(range(10))


def test_digits_loader_contract():
    jl = jax_datasets.DigitsLoader(
        JaxWorkflow().workflow, minibatch_size=48,
        prng=jax_prng.RandomGenerator("digits", seed=2))
    tl = datasets.DigitsLoader(
        DummyWorkflow().workflow, minibatch_size=48,
        prng=torch_prng.RandomGenerator("digits", seed=2))
    jl.initialize(device=JaxDevice(backend="cpu"))
    tl.initialize(device=CPU)
    assert tl.class_lengths == [0, 360, 1437]
    assert tl.shape == (64,)
    assert tl.labels_mapping == jl.labels_mapping
    assert_same_serves(jl, tl, 40)


def test_split_loader_mse_targets_are_inputs():
    class DigitsMSE(datasets._SplitLoaderMSE):
        def get_arrays(self):
            return datasets.digits_arrays(100, 3)

    loader = DigitsMSE(DummyWorkflow().workflow, minibatch_size=20,
                       prng=torch_prng.RandomGenerator("mse", seed=1))
    loader.initialize(device=CPU)
    assert not loader.has_labels
    loader.run()
    data = numpy.array(loader.minibatch_data[:])
    targets = numpy.array(loader.minibatch_targets[:])
    assert data.tobytes() == targets.tobytes()


@pytest.mark.parametrize("name,args", [
    ("MnistLoader", ("mnist_arrays",)),
    ("Cifar10Loader", ("cifar10_arrays",)),
    ("Stl10Loader", ("stl10_arrays",))])
def test_dataset_loaders_read_their_arrays(monkeypatch, name, args):
    """Each dataset loader lays its arrays out [validation | train]
    (their readers stubbed with small seeded arrays)."""
    rng = numpy.random.RandomState(4)
    arrays = (rng.rand(30, 6).astype(numpy.float32),
              rng.randint(0, 10, 30).astype(numpy.int32),
              rng.rand(10, 6).astype(numpy.float32),
              rng.randint(0, 10, 10).astype(numpy.int32))
    monkeypatch.setattr(datasets, args[0],
                        lambda data_dir=None, download=True: arrays)
    loader = getattr(datasets, name)(
        DummyWorkflow().workflow, minibatch_size=8,
        prng=torch_prng.RandomGenerator(name, seed=1))
    loader.initialize(device=CPU)
    assert loader.class_lengths == [0, 10, 30]
    data = numpy.array(loader.original_data[:])
    assert data.tobytes() == numpy.concatenate(
        [arrays[2], arrays[0]]).tobytes()
