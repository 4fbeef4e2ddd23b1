"""The port's loader family (veles_tpu_torch/loader: pickles, hdf5,
audio, colorspace, image, saver, feeds, hdfs; veles_tpu_torch/downloader)
against the JAX package's, on the CPU, on files the tests write:
tests/test_loaders_extra.py, tests/test_image_loader.py and the WebHDFS
and audio parts of tests/test_service_depth.py, each run in both
packages on the same files with the same seeds.

Each loader pair holds the same class lengths and labels mapping, the
same originals bit for bit, and serves the same minibatches (data,
labels, indices, class, size) bit for bit.  The numpy color-space
conversions equal the JAX package's bit for bit and cv2's within 1
level.  A stream the port's MinibatchesSaver wrote replays in both
packages.  The WebHDFS loader reads a fake namenode on 127.0.0.1.  A
loader built on FullBatchLoader serves through the input pipeline as
it serves in sequence.
"""

import gzip
import http.server
import json
import os
import pickle
import tarfile
import threading
import wave

import numpy
import pytest

import veles_tpu.prng as jax_prng
import veles_tpu_torch.prng as torch_prng
from veles_tpu.backends import Device as JaxDevice
from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyWorkflow

CPU = Device(backend="cpu")


def _modules(name):
    """(JAX module, port module) of ``loader.<name>``."""
    import importlib
    return (importlib.import_module("veles_tpu.loader." + name),
            importlib.import_module("veles_tpu_torch.loader." + name))


def _pair(name, cls, seed=3, device=True, **kwargs):
    """The JAX and port loaders ``cls`` of ``loader.<name>``, built with
    the same arguments and seeds and initialized on the CPU."""
    jmod, tmod = _modules(name)
    jl = getattr(jmod, cls)(JaxWorkflow().workflow,
                            prng=jax_prng.RandomGenerator(cls, seed=seed),
                            **kwargs)
    tl = getattr(tmod, cls)(DummyWorkflow().workflow,
                            prng=torch_prng.RandomGenerator(cls, seed=seed),
                            **kwargs)
    jl.initialize(device=JaxDevice(backend="cpu") if device else None)
    tl.initialize(device=CPU if device else None)
    return jl, tl


def _host(arr):
    return numpy.array(arr[:])


def assert_same_originals(jl, tl):
    assert jl.class_lengths == tl.class_lengths
    assert jl.labels_mapping == tl.labels_mapping
    want, got = _host(jl.original_data), _host(tl.original_data)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def assert_same_serves(jl, tl, serves):
    for _ in range(serves):
        jl.run()
        tl.run()
        assert (jl.minibatch_class, jl.minibatch_size) == \
            (tl.minibatch_class, tl.minibatch_size)
        for name in ("minibatch_data", "minibatch_labels",
                     "minibatch_indices"):
            want, got = getattr(jl, name), getattr(tl, name)
            if not want:
                assert not got, name
                continue
            want, got = _host(want), _host(got)
            assert got.dtype == want.dtype, name
            assert got.tobytes() == want.tobytes(), name


# -- images ----------------------------------------------------------------


def _write_images(root_dir, split, classes=2, per_class=6):
    import cv2
    rng = numpy.random.RandomState(0)
    for label in range(classes):
        d = os.path.join(root_dir, split, "class%d" % label)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            img = (rng.rand(12, 12, 3) * 255).astype(numpy.uint8)
            img[:, :, label] = 255
            cv2.imwrite(os.path.join(d, "img%02d.png" % i), img)


def _write_tree(base, classes=("circle", "square"), per_class=6, size=16):
    import cv2
    rng = numpy.random.RandomState(0)
    for cls in classes:
        cdir = base / cls
        cdir.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            img = (rng.rand(size, size, 3) * 60).astype(numpy.uint8)
            if cls == "circle":
                cv2.circle(img, (size // 2, size // 2), size // 3,
                           (255, 255, 255), -1)
            else:
                cv2.rectangle(img, (3, 3), (size - 4, size - 4),
                              (255, 255, 255), -1)
            assert cv2.imwrite(str(cdir / ("img%02d.png" % i)), img)
    return base


def _augmentations(**kwargs):
    jmod, tmod = _modules("image")
    return (jmod.ImageAugmentation(
                prng=jax_prng.RandomGenerator("aug", seed=1), **kwargs),
            tmod.ImageAugmentation(
                prng=torch_prng.RandomGenerator("aug", seed=1), **kwargs))


def test_file_image_loader_and_augmentation(tmp_path):
    pytest.importorskip("cv2")
    _write_images(str(tmp_path), "train", per_class=8)
    _write_images(str(tmp_path), "valid", per_class=4)
    jaug, taug = _augmentations(scale=(8, 8))
    jl, tl = _pair("image", "FileImageLoader", device=False,
                   minibatch_size=8,
                   validation_dir=os.path.join(str(tmp_path), "valid"),
                   train_dir=os.path.join(str(tmp_path), "train"),
                   augmentation=None)
    for loader, aug in ((jl, jaug), (tl, taug)):
        loader.augmentation = aug
        loader.initialize(device=None)
    assert tl.class_lengths == [0, 8, 16]
    assert tl.shape == (8, 8, 3)
    assert tl.unique_labels_count == 2
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 4)
    assert tl.minibatch_data.mem.max() <= 1.0


def test_augmentation_ops():
    pytest.importorskip("cv2")
    img = numpy.zeros((10, 10, 3), numpy.uint8)
    img[:, :5] = 255
    rng = numpy.random.RandomState(5)
    noisy = (rng.rand(20, 16, 3) * 255).astype(numpy.uint8)
    for kwargs, check in (
            (dict(mirror="always"),
             lambda out: out[:, :5].sum() == 0 and out[:, 5:].sum() > 0),
            (dict(crop=(4, 4)), lambda out: out.shape == (4, 4, 3)),
            (dict(color_space="GRAY"), lambda out: out.ndim == 2)):
        jaug, taug = _augmentations(**kwargs)
        got, want = taug.apply(img), jaug.apply(img)
        assert check(got)
        assert got.tobytes() == want.tobytes()
    jaug, taug = _augmentations(scale=(9, 7), rotations=(0, 15, -15),
                                mirror=True, crop=(5, 5))
    for _ in range(6):
        assert taug.apply(noisy).tobytes() == jaug.apply(noisy).tobytes()


def test_scan_and_file_loader_real_pngs(tmp_path):
    pytest.importorskip("cv2")
    from veles_tpu_torch.loader.image import scan_image_tree
    train = _write_tree(tmp_path / "train")
    valid = _write_tree(tmp_path / "valid", per_class=2)
    assert len(scan_image_tree(str(train))) == 12
    jl, tl = _pair("image", "FileImageLoader", train_dir=str(train),
                   validation_dir=str(valid), minibatch_size=4)
    assert tl.class_lengths[1] == 4 and tl.class_lengths[2] == 12
    assert tl.shape == (16, 16, 3)
    assert sorted(tl.labels_mapping) == ["circle", "square"]
    assert _host(tl.original_data).max() > 0.9
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 6)


def test_augmentation_path_real_files(tmp_path):
    pytest.importorskip("cv2")
    train = _write_tree(tmp_path / "train", size=24)
    jaug, taug = _augmentations(scale=(12, 12), color_space="GRAY")
    jl, tl = _pair("image", "FileImageLoader", device=False,
                   train_dir=str(train), minibatch_size=4)
    for loader, aug in ((jl, jaug), (tl, taug)):
        loader.augmentation = aug
        loader.initialize(device=None)
    assert tl.shape == (12, 12, 1)
    assert_same_originals(jl, tl)


def test_distortion_composition_inflates_train(tmp_path):
    pytest.importorskip("cv2")
    from veles_tpu_torch.loader.image import distortion_stages
    train = _write_tree(tmp_path / "train", per_class=3)
    valid = _write_tree(tmp_path / "valid", per_class=2)
    assert distortion_stages(True, (0, 15)) == [
        (False, 0), (True, 0), (False, 15), (True, 15)]
    jl, tl = _pair("image", "FileImageLoader", train_dir=str(train),
                   validation_dir=str(valid), mirror=True, rotations=(0, 15),
                   minibatch_size=4)
    assert tl.samples_inflation == 4
    assert tl.class_lengths[2] == 6 * 4 and tl.class_lengths[1] == 4
    data = _host(tl.original_data)
    numpy.testing.assert_allclose(data[4][:, ::-1], data[5], atol=1e-6)
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 5)


def test_colorspace_matches_jax_and_cv2():
    cv2 = pytest.importorskip("cv2")
    jcs, tcs = _modules("colorspace")
    rng = numpy.random.RandomState(3)
    u8 = (rng.rand(9, 11, 3) * 255).astype(numpy.uint8)
    f32 = rng.rand(7, 5, 3).astype(numpy.float32)
    gray = (rng.rand(4, 4) * 255).astype(numpy.uint8)
    for img, src in ((u8, "BGR"), (f32, "RGB"), (gray, "GRAY")):
        for dst in tcs.SPACES:
            got, want = tcs.convert(img, src, dst), jcs.convert(img, src, dst)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for dst, code in (("RGB", cv2.COLOR_BGR2RGB),
                      ("GRAY", cv2.COLOR_BGR2GRAY),
                      ("YCR_CB", cv2.COLOR_BGR2YCrCb)):
        ours = tcs.convert(u8, "BGR", dst)
        want = cv2.cvtColor(u8, code)
        assert ours.shape == want.shape
        assert numpy.abs(ours.astype(int) - want.astype(int)).max() <= 1
    ours = tcs.convert(u8, "BGR", "HSV")
    want = cv2.cvtColor(u8, cv2.COLOR_BGR2HSV)
    dh = numpy.abs(ours[..., 0].astype(int) - want[..., 0].astype(int))
    assert numpy.minimum(dh, 180 - dh).max() <= 1
    assert numpy.abs(ours[..., 1:].astype(int)
                     - want[..., 1:].astype(int)).max() <= 1
    for space in ("HSV", "YCR_CB", "BGR"):
        back = tcs.convert(tcs.convert(f32, "RGB", space), space, "RGB")
        numpy.testing.assert_allclose(back, f32, atol=1e-5)
    assert tcs.channels("GREY") == 1 and tcs.channels("ycrcb") == 3


def test_loader_color_tree_roundtrips_in_two_spaces(tmp_path):
    pytest.importorskip("cv2")
    from veles_tpu_torch.loader import colorspace
    train = _write_tree(tmp_path / "train")

    def load(space):
        jl, tl = _pair("image", "FileImageLoader", train_dir=str(train),
                       color_space=space, minibatch_size=4)
        assert_same_originals(jl, tl)
        return _host(tl.original_data)

    rgb, hsv = load("RGB"), load("HSV")
    assert rgb.shape == hsv.shape and not numpy.allclose(rgb, hsv)
    for i in range(len(rgb)):
        back = colorspace.convert(
            (hsv[i] * 255).round().astype(numpy.uint8), "HSV", "RGB")
        numpy.testing.assert_allclose(back / 255.0, rgb[i], atol=0.04)


def test_image_mse_class_targets(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from veles_tpu_torch.loader.image import scan_image_tree
    train = _write_tree(tmp_path / "train")
    targets = tmp_path / "targets"
    targets.mkdir()
    for name, value in (("circle", 200), ("square", 60)):
        assert cv2.imwrite(str(targets / ("%s.png" % name)),
                           numpy.full((16, 16, 3), value, numpy.uint8))
    jl, tl = _pair("image", "FullBatchImageLoaderMSE",
                   train_paths=scan_image_tree(str(train)),
                   class_target_paths={
                       "circle": str(targets / "circle.png"),
                       "square": str(targets / "square.png")},
                   minibatch_size=4)
    got = _host(tl.original_targets)
    assert got.shape == (12, 16, 16, 3)
    idx = tl.original_labels.index("circle")
    numpy.testing.assert_allclose(got[idx], 200 / 255.0, atol=1e-2)
    assert got.tobytes() == _host(jl.original_targets).tobytes()
    assert_same_originals(jl, tl)


def test_image_mse_per_sample_targets(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from veles_tpu_torch.loader.image import scan_image_tree
    train = _write_tree(tmp_path / "train", classes=("circle",),
                        per_class=4)
    tdir = tmp_path / "targets"
    tdir.mkdir()
    for path, _label in scan_image_tree(str(train)):
        assert cv2.imwrite(str(tdir / os.path.basename(path)),
                           255 - cv2.imread(path))
    jl, tl = _pair("image", "FileImageLoaderMSE", train_dir=str(train),
                   target_dir=str(tdir), mirror=True, minibatch_size=2)
    data, targets = _host(tl.original_data), _host(tl.original_targets)
    assert targets.shape == data.shape
    numpy.testing.assert_allclose(targets, 1.0 - data, atol=2e-2)
    assert targets.tobytes() == _host(jl.original_targets).tobytes()
    assert_same_originals(jl, tl)


# -- HDF5, pickles ---------------------------------------------------------


def test_hdf5_loader(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = numpy.random.RandomState(1)
    for split, n in (("train", 32), ("valid", 16)):
        with h5py.File(str(tmp_path / ("%s.h5" % split)), "w") as f:
            f["data"] = rng.rand(n, 6).astype(numpy.float32)
            f["labels"] = (numpy.arange(n) % 3).astype(numpy.int64)
    jl, tl = _pair("hdf5", "FullBatchHDF5Loader", minibatch_size=16,
                   validation_path=str(tmp_path / "valid.h5"),
                   train_path=str(tmp_path / "train.h5"))
    assert tl.class_lengths == [0, 16, 32]
    assert tl.unique_labels_count == 3
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 6)


def _write_pickles(tmp_path):
    rng = numpy.random.RandomState(2)
    train = {"data": rng.rand(20, 4).astype(numpy.float32),
             "labels": list(numpy.arange(20) % 2)}
    valid = (rng.rand(6, 4).astype(numpy.float32), [0, 1, 1, 0, 1, 0])
    for name, obj in (("train", train), ("valid", valid)):
        with open(str(tmp_path / ("%s.pickle" % name)), "wb") as f:
            pickle.dump(obj, f)
    return train


def test_pickles_loader(tmp_path):
    train = _write_pickles(tmp_path)
    jl, tl = _pair("pickles", "PicklesLoader", minibatch_size=10,
                   train_path=str(tmp_path / "train.pickle"),
                   validation_path=str(tmp_path / "valid.pickle"))
    assert tl.class_lengths == [0, 6, 20]
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 7)
    tl.run()
    size = tl.minibatch_size
    numpy.testing.assert_array_equal(
        _host(tl.minibatch_data)[:size],
        train["data"][_host(tl.minibatch_indices)[:size] - 6])


def test_pickles_loader_through_the_pipeline(tmp_path):
    """A loader built on FullBatchLoader trains fused with the input
    pipeline as it trains in sequence, bit for bit."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.pickles import PicklesLoader
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    _write_pickles(tmp_path)
    runs = []
    for pipeline in (False, True):
        torch_prng.get().seed(7)
        sw = StandardWorkflow(
            DummyLauncher(),
            layers=[dict(type="all2all_tanh", output_sample_shape=8,
                         learning_rate=0.1),
                    dict(type="softmax", output_sample_shape=2,
                         learning_rate=0.1)],
            loader_factory=lambda w: PicklesLoader(
                w, minibatch_size=4,
                train_path=str(tmp_path / "train.pickle"),
                validation_path=str(tmp_path / "valid.pickle"),
                prng=torch_prng.RandomGenerator("pk", seed=4)),
            decision_config=dict(max_epochs=3))
        sw.fuse(pipeline=pipeline)
        sw.initialize(device=CPU)
        sw.run()
        sw.fused_trainer.sync()
        runs.append((sw.decision.epoch_metrics,
                     [_host(f.weights).tobytes() for f in sw.forwards]))
    assert runs[0] == runs[1]


# -- saved minibatch streams --------------------------------------------------


def test_minibatch_saver_and_replay(tmp_path):
    """The port's saver records 6 serves; the port's and the JAX
    package's MinibatchesLoader replay them."""
    from test_torch_pipeline_input import Blobs
    from veles_tpu_torch.loader.saver import MinibatchesSaver
    loader = Blobs(DummyWorkflow().workflow, minibatch_size=64,
                   prng=torch_prng.RandomGenerator("sv", seed=5))
    loader.initialize(device=CPU)
    saver = MinibatchesSaver(DummyWorkflow().workflow,
                             path=str(tmp_path / "mb.gz"))
    saver.loader = loader
    saver.initialize()
    served = []
    for _ in range(6):
        loader.run()
        saver.run()
        served.append(_host(loader.minibatch_data)[:loader.minibatch_size])
    saver.close()
    assert saver.records == 6
    jl, tl = _pair("saver", "MinibatchesLoader", device=False,
                   path=str(tmp_path / "mb.gz"))
    assert tl.class_lengths == loader.class_lengths
    assert tl.labels_mapping == loader.labels_mapping
    for i in range(6):
        jl.run()
        tl.run()
        got = _host(tl.minibatch_data)[:tl.minibatch_size]
        assert got.tobytes() == served[i].tobytes()
        assert got.tobytes() == \
            _host(jl.minibatch_data)[:jl.minibatch_size].tobytes()


# -- feeds -----------------------------------------------------------------


def test_queue_loader_feeds():
    jmod, tmod = _modules("feeds")
    loaders = [cls.InteractiveLoader(wf, sample_shape=(4,), minibatch_size=1,
                                     prng=rng.RandomGenerator("q", seed=7))
               for cls, wf, rng in ((jmod, JaxWorkflow().workflow, jax_prng),
                                    (tmod, DummyWorkflow().workflow,
                                     torch_prng))]
    seen = []
    for loader in loaders:
        loader.initialize(device=None)
        assert loader.testing and loader.class_lengths == [1, 0, 0]
        served = []
        for sample in ([1.0, 2.0, 3.0, 4.0], [5, 6, 7, 8]):
            loader.feed(sample)
            loader.run()
            numpy.testing.assert_array_equal(loader.minibatch_data.mem[0],
                                             sample)
            assert loader.minibatch_size == 1
            served.append((loader.minibatch_class, loader.minibatch_offset,
                           bool(loader.last_minibatch),
                           bool(loader.epoch_ended), loader.epoch_number,
                           loader.minibatch_data.mem.tobytes()))
        seen.append(served)
    assert seen[0] == seen[1]
    assert loaders[0].get_metric_values() == loaders[1].get_metric_values()


def test_zmq_loader_roundtrip():
    zmq = pytest.importorskip("zmq")
    from veles_tpu_torch.loader.feeds import ZeroMQLoader
    loader = ZeroMQLoader(DummyWorkflow().workflow, sample_shape=(3,),
                          minibatch_size=1,
                          prng=torch_prng.RandomGenerator("z", seed=8))
    loader.initialize(device=None)
    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.connect(loader.endpoint)
    try:
        sock.send(pickle.dumps(numpy.array([9.0, 8.0, 7.0])))
        loader.run()
        numpy.testing.assert_array_equal(loader.minibatch_data.mem[0],
                                         [9, 8, 7])
        assert sock.recv() == b"ok"
    finally:
        sock.close(0)
        loader.stop()


def test_ensemble_loader(tmp_path):
    results = {"models": [
        {"id": 0, "snapshot": "a.pickle", "EvaluationFitness": -1.0},
        {"id": 1, "snapshot": "b.pickle", "EvaluationFitness": -2.0},
    ]}
    path = str(tmp_path / "ens.json")
    with open(path, "w") as f:
        json.dump(results, f)
    jl, tl = _pair("feeds", "EnsembleLoader", device=False,
                   results_path=path, minibatch_size=1)
    assert tl.class_lengths == [2, 0, 0]
    for _ in range(3):
        jl.run()
        tl.run()
        assert tl.current_model == jl.current_model
    assert tl.current_model["snapshot"] == "a.pickle"


# -- downloader -------------------------------------------------------------


def test_downloader_file_url(tmp_path):
    """A file:// archive unpacks, a satisfied target never fetches, and
    the unpacked pickles serve as the JAX package's do."""
    from veles_tpu_torch.downloader import Downloader
    payload = tmp_path / "payload"
    payload.mkdir()
    (payload / "dataset.txt").write_text("hello")
    _write_pickles(payload)
    archive = str(tmp_path / "ds.tar")
    with tarfile.open(archive, "w") as tar:
        for name in ("dataset.txt", "train.pickle"):
            tar.add(str(payload / name), arcname=name)
    target = str(tmp_path / "out")
    wf = DummyWorkflow().workflow
    dl = Downloader(wf, url="file://" + archive, directory=target,
                    files=["dataset.txt", "train.pickle"])
    dl.initialize()
    assert (tmp_path / "out" / "dataset.txt").read_text() == "hello"
    Downloader(wf, url="file:///nonexistent", directory=target,
               files=["dataset.txt"]).initialize()
    with pytest.raises(RuntimeError, match="download of"):
        Downloader(wf, url="file:///nonexistent/ds.tar",
                   directory=str(tmp_path / "none"),
                   files=["dataset.txt"]).initialize()
    jl, tl = _pair("pickles", "PicklesLoader", minibatch_size=8,
                   train_path=os.path.join(target, "train.pickle"))
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 4)


# -- WebHDFS ----------------------------------------------------------------


class _FakeWebHdfs(http.server.BaseHTTPRequestHandler):
    """Speaks just enough WebHDFS v1 for the loader
    (tests/test_service_depth.py's fake)."""

    files = {
        "/data/a.txt": b"0.1 0.2 0\n0.3 0.4 1\n",
        "/data/b.txt": b"0.5 0.6 2\n0.7 0.8 0\n0.9 1.0 1\n",
        "/data/skip.csv": b"9 9 9\n",
    }

    def log_message(self, *args):
        pass

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse
        parsed = urlparse(self.path)
        op = parse_qs(parsed.query).get("op", [""])[0]
        path = parsed.path[len("/webhdfs/v1"):]
        if op == "LISTSTATUS":
            statuses = [
                {"pathSuffix": name.rsplit("/", 1)[1], "type": "FILE",
                 "length": len(data)}
                for name, data in sorted(self.files.items())
                if name.startswith(path + "/")]
            body = json.dumps(
                {"FileStatuses": {"FileStatus": statuses}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)
        elif op == "OPEN" and path in self.files:
            self.send_response(200)
            self.end_headers()
            self.wfile.write(self.files[path])
        else:
            self.send_response(404)
            self.end_headers()


@pytest.fixture
def webhdfs():
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _FakeWebHdfs)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % httpd.server_port
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_hdfs_text_loader(webhdfs):
    from veles_tpu_torch.loader import WebHdfsClient
    assert WebHdfsClient(webhdfs).list_files("/data", ".txt") == [
        "/data/a.txt", "/data/b.txt"]
    jl, tl = _pair("hdfs", "HdfsTextLoader", hdfs_url=webhdfs,
                   hdfs_path="/data", suffix=".txt", validation_ratio=0.4,
                   minibatch_size=2)
    assert tl.class_lengths == [0, 2, 3]
    assert tl.shape == (2,)
    assert _host(tl.original_data).shape == (5, 2)
    assert sorted(tl.labels_mapping) == [0, 1, 2]
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 6)


# -- audio ------------------------------------------------------------------


def _write_wav(path, freq, rate=8000, seconds=0.5):
    t = numpy.arange(int(rate * seconds)) / rate
    tone = (numpy.sin(2 * numpy.pi * freq * t) * 0.5 *
            32767).astype(numpy.int16)
    with wave.open(str(path), "wb") as wav:
        wav.setnchannels(1)
        wav.setsampwidth(2)
        wav.setframerate(rate)
        wav.writeframes(tone.tobytes())


def test_audio_loader_real_wavs(tmp_path):
    jaudio, taudio = _modules("audio")
    for cls, freq in (("low", 200), ("high", 1200)):
        cdir = tmp_path / "train" / cls
        cdir.mkdir(parents=True)
        for i in range(2):
            _write_wav(cdir / ("t%d.wav" % i), freq + i * 10)
    path = str(tmp_path / "train" / "low" / "t0.wav")
    data, rate = taudio.read_audio(path)
    want, want_rate = jaudio.read_audio(path)
    assert rate == want_rate == 8000 and data.tobytes() == want.tobytes()
    assert abs(float(numpy.abs(data).max()) - 0.5) < 0.01
    jl, tl = _pair("audio", "AudioFileLoader",
                   train_dir=str(tmp_path / "train"), window_frames=1024,
                   minibatch_size=4)
    assert tl.class_lengths[2] == 12
    assert tl.shape == (1024,)
    assert sorted(tl.labels_mapping) == ["high", "low"]
    assert_same_originals(jl, tl)
    assert_same_serves(jl, tl, 4)


def test_saver_stream_is_gzip_pickles(tmp_path):
    """The stream format: a gzip of pickles, a header then one record a
    minibatch, as the JAX package writes it."""
    from test_torch_pipeline_input import Blobs
    from veles_tpu_torch.loader.saver import MinibatchesSaver
    loader = Blobs(DummyWorkflow().workflow, minibatch_size=32,
                   prng=torch_prng.RandomGenerator("sv", seed=5))
    loader.initialize(device=CPU)
    saver = MinibatchesSaver(DummyWorkflow().workflow,
                             path=str(tmp_path / "mb.gz"))
    saver.loader = loader
    saver.initialize()
    loader.run()
    saver.run()
    saver.close()
    with gzip.open(str(tmp_path / "mb.gz"), "rb") as fin:
        header = pickle.load(fin)
        record = pickle.load(fin)
        with pytest.raises(EOFError):
            pickle.load(fin)
    assert header["class_lengths"] == [0, 64, 256]
    assert header["max_minibatch_size"] == 32
    assert record["size"] == 32 and record["data"].shape == (32, 16)
    assert record["labels"].tolist() == \
        _host(loader.minibatch_labels)[:32].tolist()
