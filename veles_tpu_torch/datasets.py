"""Real datasets: MNIST, CIFAR-10 and STL-10 (cached on disk), and the
offline real-data anchor, the UCI optical digits.

Counterpart of ``veles_tpu/datasets.py``, with the same parsers, self
checks, cache layout and loaders:

- :func:`load_idx` and :func:`mnist_arrays` read the idx files (or the
  OpenML npz cache) under ``root.common.dirs.datasets`` (``VELES_DATA``),
  :func:`cifar10_arrays` the python batches, :func:`stl10_arrays` the
  binary files, each downloading first when ``download`` is true and
  the network allows;
- :func:`digits_arrays` reads ``veles_tpu_torch/data/digits.csv.gz``, a
  copy of the file scikit-learn ships (the UCI optical recognition of
  handwritten digits set, CC BY 4.0, as bundled by scikit-learn under
  BSD-3-Clause): 1,797 8x8 digits, parsed as ``load_digits`` parses it,
  so the quality path runs on real data with no network and no
  scikit-learn;
- :func:`selfcheck`, :func:`ingest` and ``python -m
  veles_tpu_torch.datasets {ingest,selfcheck,fetch}`` validate and stage
  a data drop.

The loaders (:class:`MnistLoader`, :class:`DigitsLoader`,
:class:`Cifar10Loader`, :class:`Stl10Loader`) are ``FullBatchLoader``
subclasses laid out [validation | train]: on the card each minibatch is
one ``gather_minibatch`` launch.
"""

import gzip
import os
import pickle
import struct

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader, \
    FullBatchLoaderMSE

__all__ = ["DatasetNotFound", "load_idx", "mnist_arrays", "MnistLoader",
           "digits_arrays", "digits_data", "DigitsLoader", "cifar10_arrays",
           "Cifar10Loader", "stl10_arrays", "Stl10Loader", "selfcheck"]

MNIST_URLS = [
    # canonical mirrors of the Yann LeCun idx files
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
]
MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}
CIFAR10_URLS = [
    "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
    "https://ossci-datasets.s3.amazonaws.com/cifar-10-python.tar.gz",
]
STL10_URLS = [
    "https://cs.stanford.edu/~acoates/stl10/stl10_binary.tar.gz",
    "http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz",
]


class DatasetNotFound(Exception):
    """Raised when a dataset is neither cached nor downloadable."""


def _datasets_dir():
    path = root.common.dirs.get("datasets")
    os.makedirs(path, exist_ok=True)
    return path


def load_idx(path):
    """Parse one idx file (optionally .gz): big-endian magic + dims."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fin:
        raw = fin.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", raw[:4])
    if zeros != 0:
        raise ValueError("bad idx magic in %s" % path)
    dtypes = {0x08: numpy.uint8, 0x09: numpy.int8, 0x0B: numpy.int16,
              0x0C: numpy.int32, 0x0D: numpy.float32, 0x0E: numpy.float64}
    dtype = numpy.dtype(dtypes[dtype_code]).newbyteorder(">")
    shape = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
    data = numpy.frombuffer(raw, dtype, offset=4 + 4 * ndim)
    return data.reshape(shape)


def _fetch(filename, data_dir, download=True):
    """Return the local path for *filename*, downloading if needed
    (atomically — a partial file would later fail as a confusing
    gzip error instead of engaging the openml fallback)."""
    for candidate in (os.path.join(data_dir, filename),
                      os.path.join(data_dir, "mnist", filename)):
        if os.path.exists(candidate):
            return candidate
        raw = candidate[:-3] if candidate.endswith(".gz") else None
        if raw and os.path.exists(raw):
            return raw
    target = os.path.join(data_dir, filename)
    if download:
        for base in MNIST_URLS:
            if not _download_file(base + filename, target):
                continue
            try:
                load_idx(target)  # a mirror's HTTP-200 error page
            except Exception:    # must not poison the cache forever
                try:
                    os.remove(target)
                except OSError:
                    pass
                continue
            return target
    raise DatasetNotFound(
        "MNIST file %s not found under %s and %s; place the idx files "
        "there or set $VELES_DATA" % (
            filename, data_dir,
            "download failed" if download
            else "downloads are disabled for validation"))


def mnist_arrays(data_dir=None, download=True):
    """(train_x f32 [60000,784] in [0,1], train_y i32, test_x, test_y).

    Self-checks the drop (shapes, label range, file checksums) so a
    future data drop immediately yields the reference-parity runs or
    fails with a clear message.  Source order: cached/downloaded idx
    files, then sklearn's ``fetch_openml("mnist_784")`` mirror (cached
    as mnist_openml.npz once it succeeds).  ``download=False``
    restricts to what is already cached (selfcheck/ingest use it so
    validating never triggers multi-hundred-MB transfers)."""
    data_dir = data_dir or _datasets_dir()
    try:
        raw, paths = _load_mnist_raw(data_dir, download)
    except DatasetNotFound as idx_err:
        return _mnist_openml(data_dir, idx_err, download)
    _verify_mnist(raw, paths)
    out = {key: (arr.astype(numpy.float32) / 255.0
                 if key.endswith("images")
                 else arr.astype(numpy.int32))
           for key, arr in raw.items()}
    return (out["train_images"], out["train_labels"],
            out["test_images"], out["test_labels"])


_OPENML_NPZ = "mnist_openml.npz"


def _load_openml_npz(npz):
    """Validated cache read; None when absent/corrupt (a truncated
    write must re-fetch, not crash MNIST forever)."""
    if not os.path.exists(npz):
        return None
    try:
        z = numpy.load(npz)
        arrays = (z["train_x"], z["train_y"], z["test_x"], z["test_y"])
        if arrays[0].shape != (60000, 784) or \
                arrays[2].shape != (10000, 784) or \
                arrays[1].shape != (60000,) or \
                arrays[3].shape != (10000,):
            raise ValueError("wrong shapes")
        for labels in (arrays[1], arrays[3]):
            if not numpy.issubdtype(labels.dtype, numpy.integer) or \
                    labels.min() < 0 or labels.max() > 9:
                raise ValueError("bad labels")
        return arrays
    except Exception:
        try:
            os.remove(npz)
        except OSError:
            pass
        return None


def _mnist_openml(data_dir, idx_err, download=True):
    """openml.org fallback for MNIST: a different host than the idx
    mirrors, so one blocked CDN doesn't kill the parity run.  The
    70k x 784 matrix preserves the canonical train/test order (first
    60k = train)."""
    npz = os.path.join(data_dir, _OPENML_NPZ)
    cached = _load_openml_npz(npz)
    if cached is not None:
        return cached
    if not download:
        raise idx_err
    try:
        from sklearn.datasets import fetch_openml
        bunch = fetch_openml("mnist_784", version=1, as_frame=False)
        x = numpy.asarray(bunch.data, numpy.float32) / 255.0
        y = numpy.asarray(bunch.target, numpy.int32)
    except Exception as openml_err:
        raise DatasetNotFound(
            "%s; openml fallback also failed: %r" % (idx_err,
                                                     openml_err))
    if x.shape != (70000, 784) or not (0 <= y.min() and y.max() <= 9):
        raise DatasetNotFound(
            "MNIST openml fallback self-check failed: data %s, label "
            "range [%s, %s]" % (x.shape, y.min(), y.max()))
    arrays = (x[:60000], y[:60000], x[60000:], y[60000:])
    tmp = npz + ".part.npz"
    try:
        os.makedirs(data_dir, exist_ok=True)
        numpy.savez_compressed(
            tmp, train_x=arrays[0], train_y=arrays[1],
            test_x=arrays[2], test_y=arrays[3])
        os.replace(tmp, npz)  # atomic: a killed write must not poison
    except OSError:
        pass  # cache write failure must not discard the fetched data
    return arrays


#: widely-published md5s of the canonical MNIST gz files (torchvision
#: ships the same values); a drop whose checksum mismatches gets a
#: warning, not a failure — users may legitimately drop re-compressed
#: or uncompressed copies
MNIST_MD5 = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}


def _load_mnist_raw(data_dir, download=True):
    """Fetch + parse the four idx files; shared by mnist_arrays and
    selfcheck so what is validated is exactly what training loads.
    Returns ({key: raw uint8 array, images flattened}, [paths])."""
    out = {}
    paths = []
    for key, filename in MNIST_FILES.items():
        path = _fetch(filename, data_dir, download)
        paths.append(path)
        arr = load_idx(path)
        if key.endswith("images"):
            arr = arr.reshape(arr.shape[0], -1)
        out[key] = arr
    return out, paths


def _verify_mnist(out, paths, checksums=False):
    """Structural self-check: a wrong/truncated drop must fail HERE
    with a clear message, not as a confusing shape error mid-training.
    Returns a provenance report; file md5s only when ``checksums``
    (they cost a full re-read of ~11 MB — selfcheck wants them, the
    per-training-run load path does not)."""
    expect = {"train_images": (60000, 784), "train_labels": (60000,),
              "test_images": (10000, 784), "test_labels": (10000,)}
    for key, shape in expect.items():
        if out[key].shape != shape:
            raise DatasetNotFound(
                "MNIST self-check failed: %s has shape %s, expected %s "
                "— the dropped files are not the canonical idx set"
                % (key, out[key].shape, shape))
    for key in ("train_labels", "test_labels"):
        if not (0 <= out[key].min() and out[key].max() <= 9):
            raise DatasetNotFound(
                "MNIST self-check failed: %s range [%d, %d] outside "
                "0..9" % (key, out[key].min(), out[key].max()))
    report = {"shapes_ok": True}
    if checksums:
        report["files"] = {}
        for path in paths:
            digest = _md5_file(path)
            name = os.path.basename(path)
            known = MNIST_MD5.get(name)
            report["files"][name] = {
                "md5": digest,
                "canonical": (None if known is None
                              else digest == known)}
    return report


#: scikit-learn's digits.csv.gz, copied into the package
DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "digits.csv.gz")


def digits_data():
    """(data float64 (1797, 64) of 0..16, target int (1797,)) as
    scikit-learn's ``load_digits`` reads its file: ``numpy.loadtxt`` of
    the gzip text, comma-separated, the last column the target."""
    with gzip.open(DIGITS_FILE, "rt", encoding="utf-8") as fin:
        data = numpy.loadtxt(fin, delimiter=",")
    return data[:, :-1], data[:, -1].astype(int, copy=False)


def digits_arrays(validation_count=360, seed=4):
    """Real handwritten digits, split deterministically: (train_x,
    train_y, valid_x, valid_y).

    1,797 8x8 grayscale digits, features scaled to [0, 1]."""
    data, target = digits_data()
    x = (data / 16.0).astype(numpy.float32)
    y = target.astype(numpy.int32)
    rng = numpy.random.RandomState(seed)
    order = rng.permutation(len(x))
    x, y = x[order], y[order]
    return (x[validation_count:], y[validation_count:],
            x[:validation_count], y[:validation_count])


def _find_cifar_dir(data_dir):
    """Resolve the CIFAR-10 batches directory or raise DatasetNotFound
    (single source of truth for the layout probe — loader and
    selfcheck must agree on what counts as a drop)."""
    for sub in ("cifar-10-batches-py", "cifar10", "."):
        base = os.path.join(data_dir, sub)
        if os.path.exists(os.path.join(base, "data_batch_1")):
            return base
    raise DatasetNotFound(
        "CIFAR-10 python batches not found under %s" % data_dir)


def _download_file(url, target, timeout=60):
    """Stream one URL to ``target`` (atomic rename); True on success."""
    import urllib.request
    tmp = target + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                open(tmp, "wb") as fout:
            while True:
                block = resp.read(1 << 20)
                if not block:
                    break
                fout.write(block)
        os.replace(tmp, target)
        return True
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _extract_tar(tar_path, data_dir):
    """Extract with the data filter; a corrupt archive raises
    DatasetNotFound rather than a bare tarfile error."""
    import tarfile
    try:
        with tarfile.open(tar_path) as tar:
            tar.extractall(data_dir, filter="data")
    except (tarfile.TarError, OSError, EOFError) as exc:
        raise DatasetNotFound(
            "cannot extract %s: %r" % (tar_path, exc))


def _maybe_download_tarball(urls, filename, data_dir):
    """Try each mirror for ``filename``; extract on success.  Returns
    True when a tarball was fetched + extracted (re-probe the layout
    then).  Quiet failure — the caller reports the authoritative
    DatasetNotFound.  A saved file that is not a tarball (a mirror's
    HTTP-200 error page) is deleted, not left to poison every later
    run."""
    import tarfile
    target = os.path.join(data_dir, filename)
    if os.path.exists(target) and tarfile.is_tarfile(target):
        _extract_tar(target, data_dir)
        return True
    for url in urls:
        if not _download_file(url, target):
            continue
        if not tarfile.is_tarfile(target):
            try:
                os.remove(target)
            except OSError:
                pass
            continue
        _extract_tar(target, data_dir)
        return True
    return False


def cifar10_arrays(data_dir=None, download=True):
    """(train_x f32 [50000,32,32,3] in [0,1], train_y, test_x, test_y)
    from the python-pickle CIFAR-10 batches (downloaded from the
    canonical/ossci mirrors when absent, the network allows, and
    ``download`` is True)."""
    data_dir = data_dir or _datasets_dir()
    try:
        base = _find_cifar_dir(data_dir)
    except DatasetNotFound:
        if not download or not _maybe_download_tarball(
                CIFAR10_URLS, "cifar-10-python.tar.gz", data_dir):
            raise
        base = _find_cifar_dir(data_dir)

    def read_batch(name):
        with open(os.path.join(base, name), "rb") as fin:
            batch = pickle.load(fin, encoding="bytes")
        data = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return (data.astype(numpy.float32) / 255.0,
                numpy.array(batch[b"labels"], numpy.int32))

    xs, ys = zip(*[read_batch("data_batch_%d" % i) for i in range(1, 6)])
    test_x, test_y = read_batch("test_batch")
    train_x, train_y = numpy.concatenate(xs), numpy.concatenate(ys)
    for what, arr, shape in (
            ("train images", train_x, (50000, 32, 32, 3)),
            ("train labels", train_y, (50000,)),
            ("test images", test_x, (10000, 32, 32, 3)),
            ("test labels", test_y, (10000,))):
        if arr.shape != shape:
            raise DatasetNotFound(
                "CIFAR-10 self-check failed: %s shape %s, expected %s "
                "— the dropped batches are not the canonical python "
                "set" % (what, arr.shape, shape))
    if not (0 <= train_y.min() and train_y.max() <= 9):
        raise DatasetNotFound(
            "CIFAR-10 self-check failed: label range [%d, %d] outside "
            "0..9" % (train_y.min(), train_y.max()))
    return (train_x, train_y, test_x, test_y)


def _find_stl10_dir(data_dir):
    for sub in ("stl10_binary", "stl10", "."):
        base = os.path.join(data_dir, sub)
        if os.path.exists(os.path.join(base, "train_X.bin")):
            return base
    raise DatasetNotFound(
        "STL-10 binary files not found under %s" % data_dir)


def stl10_arrays(data_dir=None, download=True):
    """(train_x f32 [5000,96,96,3] in [0,1], train_y i32 0..9, test_x
    [8000,...], test_y) from the STL-10 binary files (train_X.bin /
    train_y.bin / test_X.bin / test_y.bin).

    Reference quality target: 35.10 % conv validation error
    (manualrst_veles_algorithms.rst:51).  STL-10 images are stored
    channel-major and column-major within each channel."""
    data_dir = data_dir or _datasets_dir()
    try:
        base = _find_stl10_dir(data_dir)
    except DatasetNotFound:
        if not download or not _maybe_download_tarball(
                STL10_URLS, "stl10_binary.tar.gz", data_dir):
            raise
        base = _find_stl10_dir(data_dir)

    def read_split(x_name, y_name, count, what):
        x = numpy.fromfile(os.path.join(base, x_name), numpy.uint8)
        if x.size != count * 3 * 96 * 96:
            raise DatasetNotFound(
                "STL-10 self-check failed: %s holds %d bytes, expected "
                "%d (%d images) — not the canonical binary file"
                % (what, x.size, count * 3 * 96 * 96, count))
        x = x.reshape(count, 3, 96, 96).transpose(0, 3, 2, 1)
        x = (x.astype(numpy.float32) / 255.0)
        y = numpy.fromfile(os.path.join(base, y_name), numpy.uint8)
        if y.shape != (count,):
            raise DatasetNotFound(
                "STL-10 self-check failed: labels %s shape %s, "
                "expected (%d,)" % (what, y.shape, count))
        if not (1 <= y.min() and y.max() <= 10):
            raise DatasetNotFound(
                "STL-10 self-check failed: label range [%d, %d] "
                "outside 1..10" % (y.min(), y.max()))
        return x, (y.astype(numpy.int32) - 1)  # 1-indexed on disk

    train_x, train_y = read_split("train_X.bin", "train_y.bin",
                                  5000, "train")
    test_x, test_y = read_split("test_X.bin", "test_y.bin",
                                8000, "test")
    return train_x, train_y, test_x, test_y


def _md5_file(path, chunk=1 << 20):
    """Chunked md5 — dataset binaries run to hundreds of MB; reading
    them whole just to hash doubles peak memory for nothing."""
    import hashlib
    digest = hashlib.md5()
    with open(path, "rb") as fin:
        while True:
            block = fin.read(chunk)
            if not block:
                return digest.hexdigest()
            digest.update(block)


def selfcheck(data_dir=None):
    """Validate whatever datasets are present; report per dataset.

    {name: {"status": "ok"|"missing", ...provenance...}} — run after a
    data drop to confirm the reference-parity runs (1.48 % MNIST /
    17.21 % CIFAR-10) will start with zero code changes:

        python -m veles_tpu_torch.datasets selfcheck
    """
    report = {}
    data_dir = data_dir or _datasets_dir()
    # download=False everywhere: validation must never trigger
    # multi-hundred-MB transfers (the fetch CLI command is the
    # explicit download path)
    try:
        raw, paths = _load_mnist_raw(data_dir, download=False)
        row = _verify_mnist(raw, paths, checksums=True)
        row["status"] = "ok"
        row["source"] = "idx"
        report["mnist"] = row
    except DatasetNotFound as exc:
        npz = os.path.join(data_dir, _OPENML_NPZ)
        if _load_openml_npz(npz) is not None:
            report["mnist"] = {"status": "ok", "source": "openml",
                               "md5": _md5_file(npz)}
        else:
            report["mnist"] = {"status": "missing", "detail": str(exc)}
    try:
        cifar10_arrays(data_dir, download=False)
        base = _find_cifar_dir(data_dir)
        files = {}
        for i in list(range(1, 6)) + ["test"]:
            name = ("data_batch_%d" % i if isinstance(i, int)
                    else "test_batch")
            files[name] = _md5_file(os.path.join(base, name))
        report["cifar10"] = {"status": "ok", "shapes_ok": True,
                             "files": files}
    except DatasetNotFound as exc:
        report["cifar10"] = {"status": "missing", "detail": str(exc)}
    try:
        stl10_arrays(data_dir, download=False)
        base = _find_stl10_dir(data_dir)
        files = {name: _md5_file(os.path.join(base, name))
                 for name in ("train_X.bin", "train_y.bin",
                              "test_X.bin", "test_y.bin")}
        report["stl10"] = {"status": "ok", "shapes_ok": True,
                           "files": files}
    except DatasetNotFound as exc:
        report["stl10"] = {"status": "missing", "detail": str(exc)}
    return report


def _ingest_table():
    """artifact name -> (dataset, destination subdir under the cache);
    everything the one-command ingest recognizes in a drop dir."""
    table = {_OPENML_NPZ: ("mnist", "")}
    for name in MNIST_FILES.values():
        table[name] = ("mnist", "")
        table[name[:-3]] = ("mnist", "")            # uncompressed idx
    for name in ["data_batch_%d" % i for i in range(1, 6)] + [
            "test_batch", "batches.meta"]:
        table[name] = ("cifar10", "cifar-10-batches-py")
    for name in ("train_X.bin", "train_y.bin", "test_X.bin",
                 "test_y.bin", "unlabeled_X.bin", "class_names.txt"):
        table[name] = ("stl10", "stl10_binary")
    return table


_INGEST_FILES = _ingest_table()
_INGEST_TARBALLS = {
    "cifar-10-python.tar.gz": "cifar10",
    "stl10_binary.tar.gz": "stl10",
}


def ingest(source_dir, data_dir=None):
    """One-command data drop: scan ``source_dir`` recursively for
    canonical dataset artifacts (MNIST idx files, CIFAR-10 python
    batches or tarball, STL-10 binaries or tarball), stage them into
    the dataset cache, and return the checksummed :func:`selfcheck`
    report — anyone with the files can produce the reference-parity
    QUALITY rows with zero code changes:

        python -m veles_tpu_torch.datasets ingest <dir-with-the-files>
    """
    import shutil
    data_dir = data_dir or _datasets_dir()
    staged = []
    for dirpath, _dirnames, filenames in os.walk(source_dir):
        for fname in filenames:
            src = os.path.join(dirpath, fname)
            try:
                if fname in _INGEST_TARBALLS:
                    _extract_tar(src, data_dir)
                    staged.append((fname, "extracted"))
                elif fname in _INGEST_FILES:
                    _dataset, sub = _INGEST_FILES[fname]
                    dest_dir = os.path.join(data_dir, sub) if sub \
                        else data_dir
                    dest = os.path.join(dest_dir, fname)
                    if os.path.exists(dest) and \
                            os.path.samefile(src, dest):
                        # ingesting the cache dir itself (a plausible
                        # "validate what I have" run): nothing to copy
                        staged.append((fname, "already in cache"))
                        continue
                    os.makedirs(dest_dir, exist_ok=True)
                    shutil.copy2(src, dest)
                    staged.append((fname, "copied"))
            except (DatasetNotFound, OSError, shutil.Error) as exc:
                # a bad artifact lands in the report, not as a crash
                # with files half-staged
                staged.append((fname, "FAILED: %r" % exc))
    report = selfcheck(data_dir)
    report["ingested"] = {
        "source": os.path.abspath(source_dir),
        "data_dir": data_dir,
        "files": ["%s (%s)" % pair for pair in sorted(staged)],
    }
    return report


def _main(argv=None):
    """``python -m veles_tpu_torch.datasets {ingest,selfcheck,fetch}``."""
    import argparse
    import json as _json
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.datasets",
        description="dataset drop/ingest utilities (MNIST, CIFAR-10, "
                    "STL-10)")
    sub = parser.add_subparsers(dest="command", required=True)
    p_ing = sub.add_parser(
        "ingest", help="stage canonical dataset files from a directory "
                       "into the cache, then selfcheck")
    p_ing.add_argument("source", help="directory holding the files")
    p_ing.add_argument("--data-dir", default=None)
    p_chk = sub.add_parser(
        "selfcheck", help="validate + checksum whatever is cached")
    p_chk.add_argument("--data-dir", default=None)
    p_fet = sub.add_parser(
        "fetch", help="attempt mirror downloads of all three datasets, "
                      "then selfcheck")
    p_fet.add_argument("--data-dir", default=None)
    args = parser.parse_args(argv)
    data_dir = args.data_dir or _datasets_dir()
    if args.command == "ingest":
        report = ingest(args.source, data_dir)
    elif args.command == "fetch":
        for fn in (mnist_arrays, cifar10_arrays, stl10_arrays):
            try:
                fn(data_dir)
            except DatasetNotFound:
                pass
        report = selfcheck(data_dir)
    else:
        report = selfcheck(data_dir)
    print(_json.dumps(report, indent=1, sort_keys=True))
    statuses = [row.get("status") for name, row in report.items()
                if name in ("mnist", "cifar10", "stl10")]
    return 0 if "ok" in statuses else 1


class _SplitLoader(FullBatchLoader):
    """FullBatch loader over prebuilt (train, valid) arrays, laid out
    [valid | train] to match the loader class-window contract.
    Subclasses implement get_arrays() from picklable state so snapshots
    restore cleanly (the dataset is re-read, not pickled)."""

    def get_arrays(self):
        """-> (train_x, train_y, valid_x, valid_y)"""
        raise NotImplementedError

    WITH_LABELS = True

    def load_data(self):
        train_x, train_y, valid_x, valid_y = self.get_arrays()
        self.original_data = numpy.concatenate([valid_x, train_x])
        if self.WITH_LABELS:
            self.original_labels = numpy.concatenate(
                [valid_y, train_y])
        self.class_lengths[0] = 0
        self.class_lengths[1] = len(valid_x)
        self.class_lengths[2] = len(train_x)


class _SplitLoaderMSE(FullBatchLoaderMSE, _SplitLoader):
    """_SplitLoader layout with reconstruction targets == inputs (the
    autoencoder feed); one copy of the [valid|train] class-window
    contract for both label and MSE variants.  Labels are skipped —
    a reconstruction task would otherwise pay per-step label gathers
    it never reads."""

    WITH_LABELS = False

    def load_data(self):
        super(_SplitLoaderMSE, self).load_data()
        self.original_targets = numpy.array(self.original_data.mem,
                                            copy=True)


class MnistLoader(_SplitLoader):
    """MNIST-784 through the device-resident FullBatch path; the 10k
    test set serves as the validation class."""

    def __init__(self, workflow, data_dir=None, **kwargs):
        super(MnistLoader, self).__init__(workflow, **kwargs)
        self.data_dir = data_dir

    def get_arrays(self):
        return mnist_arrays(self.data_dir)


class DigitsLoader(_SplitLoader):
    """The offline real-data anchor: the 1,797 handwritten digits of
    :data:`DIGITS_FILE`."""

    def __init__(self, workflow, validation_count=360, seed=4, **kwargs):
        super(DigitsLoader, self).__init__(workflow, **kwargs)
        self.validation_count = validation_count
        self.split_seed = seed

    def get_arrays(self):
        return digits_arrays(self.validation_count, self.split_seed)


class Cifar10Loader(_SplitLoader):
    """CIFAR-10 (32x32x3) with the 10k test batch as validation."""

    def __init__(self, workflow, data_dir=None, **kwargs):
        super(Cifar10Loader, self).__init__(workflow, **kwargs)
        self.data_dir = data_dir

    def get_arrays(self):
        return cifar10_arrays(self.data_dir)


class Stl10Loader(_SplitLoader):
    """STL-10 (96x96x3) with the 8k test split as validation."""

    def __init__(self, workflow, data_dir=None, **kwargs):
        super(Stl10Loader, self).__init__(workflow, **kwargs)
        self.data_dir = data_dir

    def get_arrays(self):
        return stl10_arrays(self.data_dir)


if __name__ == "__main__":
    raise SystemExit(_main())
