"""The port's FullBatchLoader (veles_tpu_torch/loader) against the JAX
package's, on the CPU: over two epochs the same ``shuffled_indices``,
the same class, size, offset and end-of-class flags at every serve, and
bit-equal minibatches (data, labels, indices), for float32 and uint8
data, with ragged class tails (zeroed rows, ``-1`` labels), with and
without the mean/dispersion normalizer, through the device path (the
gather) and the host path."""

import numpy
import pytest

import veles_tpu.loader.fullbatch as jax_fullbatch
import veles_tpu.prng as jax_prng
import veles_tpu_torch.loader.fullbatch as torch_fullbatch
import veles_tpu_torch.prng as torch_prng
from veles_tpu.backends import Device as JaxDevice
from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyWorkflow


def _arrays(dtype, n_valid, n_train, shape=(5, 3), classes=4, seed=0):
    rng = numpy.random.RandomState(seed)
    n = n_valid + n_train
    if dtype == numpy.uint8:
        x = rng.randint(0, 256, (n,) + shape).astype(numpy.uint8)
    else:
        x = (rng.randn(n, *shape) * 3).astype(numpy.float32)
    y = rng.randint(0, classes, n).astype(numpy.int32)
    return x[:n_valid], y[:n_valid], x[n_valid:], y[n_valid:]


def loader_class(base):
    """A FullBatchLoader over prebuilt arrays laid out [valid | train]
    (the JAX package's split-loader layout), for either package."""

    class ArraysLoader(base):
        def __init__(self, workflow, arrays, **kwargs):
            super(ArraysLoader, self).__init__(workflow, **kwargs)
            self.arrays = arrays

        def load_data(self):
            valid_x, valid_y, train_x, train_y = self.arrays
            self.original_data = numpy.concatenate([valid_x, train_x])
            self.original_labels = numpy.concatenate([valid_y, train_y])
            self.class_lengths[0] = 0
            self.class_lengths[1] = len(valid_x)
            self.class_lengths[2] = len(train_x)

    return ArraysLoader


JaxArraysLoader = loader_class(jax_fullbatch.FullBatchLoader)
TorchArraysLoader = loader_class(torch_fullbatch.FullBatchLoader)


def _snapshot(loader):
    return {
        "class": loader.minibatch_class, "size": loader.minibatch_size,
        "offset": loader.minibatch_offset, "epoch": loader.epoch_number,
        "last": bool(loader.last_minibatch),
        "epoch_ended": bool(loader.epoch_ended),
        "train_ended": bool(loader.train_ended),
        "data": numpy.array(loader.minibatch_data[:]),
        "labels": numpy.array(loader.minibatch_labels[:]),
        "indices": numpy.array(loader.minibatch_indices[:]),
        "shuffled": numpy.array(loader.shuffled_indices[:]),
    }


def _pair(dtype, n_valid, n_train, batch, seed=3, **kwargs):
    arrays = _arrays(dtype, n_valid, n_train)
    jl = JaxArraysLoader(JaxWorkflow(), arrays, minibatch_size=batch,
                         dtype=dtype,
                         prng=jax_prng.RandomGenerator("ld", seed=seed),
                         **kwargs)
    tl = TorchArraysLoader(DummyWorkflow(), arrays, minibatch_size=batch,
                           dtype=dtype,
                           prng=torch_prng.RandomGenerator("ld", seed=seed),
                           **kwargs)
    jl.initialize(device=JaxDevice(backend="cpu"))
    tl.initialize(device=Device(backend="cpu"))
    return jl, tl


def _serves_per_epoch(n_valid, n_train, batch):
    return -(-n_valid // batch) + -(-n_train // batch)


CASES = [
    # dtype, n_valid, n_train, minibatch, extra loader kwargs
    (numpy.float32, 23, 61, 10, {}),
    (numpy.uint8, 23, 61, 10, {}),
    (numpy.float32, 20, 40, 10, {}),
    (numpy.float32, 17, 45, 8, {"normalization_type": "mean_disp"}),
    (numpy.uint8, 9, 30, 7, {"on_device": False}),
]


@pytest.mark.parametrize("dtype,n_valid,n_train,batch,kwargs", CASES,
                         ids=["f32-ragged", "uint8-ragged", "f32-even",
                              "f32-mean_disp", "uint8-host-path"])
def test_two_epochs_serve_alike(dtype, n_valid, n_train, batch, kwargs):
    jl, tl = _pair(dtype, n_valid, n_train, batch, **kwargs)
    assert numpy.array_equal(jl.shuffled_indices.mem,
                             tl.shuffled_indices.mem)
    assert jl.class_lengths == tl.class_lengths
    assert jl.labels_mapping == tl.labels_mapping
    serves = 2 * _serves_per_epoch(n_valid, n_train, batch)
    short = 0
    for _ in range(serves):
        jl.run()
        tl.run()
        js, ts = _snapshot(jl), _snapshot(tl)
        for key in js:
            if isinstance(js[key], numpy.ndarray):
                assert js[key].dtype == ts[key].dtype, key
                assert js[key].tobytes() == ts[key].tobytes(), key
            else:
                assert js[key] == ts[key], key
        if ts["size"] < batch:
            short += 1
            assert (ts["labels"][ts["size"]:] == -1).all()
            assert (ts["data"][ts["size"]:] == 0).all()
            assert (ts["indices"][ts["size"]:] == -1).all()
    assert tl.epoch_number == 2
    if n_valid % batch or n_train % batch:
        assert short > 0


def test_epoch_flags_sequence():
    """The flags a decision gates on, over one epoch (validation served
    first, train last): last_minibatch at each class end, epoch_ended at
    the validation class end, train_ended at the last train
    minibatch."""
    _, tl = _pair(numpy.float32, 20, 40, 10)
    flags = []
    for _ in range(_serves_per_epoch(20, 40, 10)):
        tl.run()
        flags.append((tl.minibatch_class, bool(tl.last_minibatch),
                      bool(tl.epoch_ended), bool(tl.train_ended)))
    assert flags == [(1, False, False, False), (1, True, True, False),
                     (2, False, False, False), (2, False, False, False),
                     (2, False, False, False), (2, True, False, True)]


def test_device_path_gathers_on_the_device():
    """The device path adopts the gathered tensor: the minibatch's host
    copy is stale metadata until a read, and the loader never uploads
    a minibatch."""
    _, tl = _pair(numpy.uint8, 10, 20, 10)
    tl.run()
    assert tl.minibatch_data._devmem_ is not None
    assert tl.minibatch_data._devmem_.dtype.is_floating_point is False
    assert tl.minibatch_data.devmem.shape == (10, 5, 3)
