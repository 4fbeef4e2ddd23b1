"""FullBatchLoader — the whole dataset resident on the device.

Counterpart of ``veles_tpu/loader/fullbatch.py``: ``create_originals``
host allocation, validation re-split by ratio, normalization applied
ONCE to the original dataset at initialize, minibatches taken by the
shuffled index window, zeroed rows and ``-1`` labels past a short
minibatch's end, labels mapped to ints up front.

Device path: the originals (and the mapped labels) are copied to the
device once at initialize.  Each serve slices its index window out of
the device copy of ``shuffled_indices`` (uploaded once per shuffle, so a
minibatch costs no host-to-device copy and no host sync) and gathers
the rows with :func:`veles_tpu_torch.ops.gather.gather_minibatch` — the
``gather_minibatch`` kernel on the card — with ``out=`` into one device
buffer the loader keeps (and the labels likewise): the minibatch Arrays
hold those buffers, rewritten in place each serve
(``Array.set_device_array`` again after each), so a captured train step
reads them as its static inputs and copies nothing
(:attr:`FullBatchLoader.static_minibatch`).  With the input pipeline
attached (``veles_tpu_torch/pipeline_input.py``) the worker serves ahead
while a step reads the minibatch before, so each of its slots has its
own buffers (the slot ``stage_begin`` chose), and the step copies its
minibatch into its static input.  With ``on_device=False`` the host path
copies rows into ``minibatch_data.mem`` instead, and consumers upload
each minibatch.  While the tracer or a ``torch.profiler`` records, the
device path's serve is a ``loader.gather`` span (host time: the index
window, the gathers' launches and the tail's masking).
"""

import time

import numpy
import torch

from veles_tpu_torch.loader.base import (
    Loader, LoaderError, LoaderMSEMixin, TRAIN, VALID)
from veles_tpu_torch.memory import Array
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.ops.gather import gather_labels, gather_minibatch

__all__ = ["FullBatchLoader", "FullBatchLoaderMSE"]

_TORCH_DTYPES = {numpy.dtype(numpy.float32): torch.float32,
                 numpy.dtype(numpy.uint8): torch.uint8,
                 numpy.dtype(numpy.int8): torch.int8,
                 numpy.dtype(numpy.int32): torch.int32}


class FullBatchLoader(Loader):
    """Dataset in one Array; minibatches gathered on the device."""

    def __init__(self, workflow, **kwargs):
        super(FullBatchLoader, self).__init__(workflow, **kwargs)
        self.validation_ratio = kwargs.get("validation_ratio", None)
        self.on_device = kwargs.get("on_device", True)
        self.original_data = Array()
        self.original_labels = []
        self.device = None
        self.dtype = numpy.dtype(kwargs.get("dtype", numpy.float32))

    @staticmethod
    def _coerce_array(value):
        """Accept ``loader.original_data = ndarray`` as well as a
        prepared Array."""
        if isinstance(value, Array):
            return value
        arr = Array()
        if value is not None:
            arr.mem = numpy.ascontiguousarray(value)
        return arr

    @property
    def original_data(self):
        return self._original_data

    @original_data.setter
    def original_data(self, value):
        self._original_data = self._coerce_array(value)

    @property
    def original_labels(self):
        return self._original_labels

    @original_labels.setter
    def original_labels(self, value):
        if isinstance(value, numpy.ndarray):
            value = value.tolist()
        self._original_labels = [] if value is None else value

    def init_unpickled(self):
        super(FullBatchLoader, self).init_unpickled()
        # rebuilt from original_labels by _map_original_labels()
        self._mapped_original_labels_ = Array()
        # the device minibatch buffers, made at the first device serve:
        # {(role, slot): tensor}, slot None without a pipeline
        self._outs_ = {}

    @property
    def static_minibatch(self):
        """True when the device minibatch (data, labels, targets) is
        served in place, into the same buffers every time (no pipeline
        attached)."""
        return self._use_device_path() and self._pipeline_ is None

    def _out(self, role, source, dtype):
        """The device buffer this serve gathers ``role`` ("data",
        "labels", "targets") into: one without a pipeline, one a staging
        slot with it."""
        slot = (None if self._pipeline_ is None
                else self.minibatch_data.stage_slot)
        out = self._outs_.get((role, slot))
        if out is None:
            out = self._outs_[(role, slot)] = torch.empty(
                (self.max_minibatch_size,) + tuple(source.shape[1:]),
                dtype=dtype, device=source.device)
        return out

    @property
    def shape(self):
        if not self.original_data:
            raise LoaderError("load_data() has not created original_data")
        return self.original_data.shape[1:]

    def create_originals(self, dshape, labels=True):
        """Allocate original_data (+labels) for load_data() to fill."""
        self.original_data.mem = numpy.zeros(
            (self.total_samples,) + tuple(dshape), self.dtype)
        if labels:
            self._mapped_original_labels_.mem = numpy.zeros(
                self.total_samples, Loader.LABEL_DTYPE)
            self.original_labels[:] = [None] * self.total_samples

    def initialize(self, device=None, **kwargs):
        self.device = device
        result = super(FullBatchLoader, self).initialize(**kwargs)
        self.analyze_original_dataset()
        self._map_original_labels()
        if self._use_device_path():
            if self.dtype not in _TORCH_DTYPES:
                raise LoaderError(
                    "the device path serves float32, uint8, int8 or "
                    "int32 data, not %s" % self.dtype)
            if self.original_data.dtype != self.dtype:
                self.original_data.mem = self.original_data.mem.astype(
                    self.dtype)
            # one upload; every serve gathers from here
            self.original_data.initialize(self.device)
            self.original_data.unmap()
            if self.has_labels:
                self._mapped_original_labels_.initialize(self.device)
                self._mapped_original_labels_.unmap()
            self.shuffled_indices.initialize(self.device)
        return result

    def _use_device_path(self):
        return (self.on_device and self.device is not None and
                self.device.exists)

    def create_minibatch_data(self):
        self.minibatch_data.mem = numpy.zeros(
            (self.max_minibatch_size,) + self.shape, self.dtype)

    # -- analysis (once, on the originals) ----------------------------------

    def analyze_dataset(self):
        pass  # replaced by analyze_original_dataset after initialize

    def normalize_minibatch(self):
        pass  # the originals are already normalized

    def analyze_original_dataset(self):
        if self.class_lengths[TRAIN] > 0:
            self.normalizer.analyze(
                self.original_data.mem[self.class_end_offsets[VALID]:])
        elif not self.normalizer.initialized:
            raise LoaderError(
                "no train samples and the normalizer is uninitialized")
        self.normalizer.normalize(self.original_data.mem)

    def _map_original_labels(self):
        if not self.original_labels or all(
                l is None for l in self.original_labels):
            self.original_labels = []
            return
        if not self.labels_mapping:
            uniques = sorted(set(self.original_labels))
            self.labels_mapping.update(
                (lbl, i) for i, lbl in enumerate(uniques))
        self._mapped_original_labels_.mem = numpy.array(
            [self.labels_mapping[raw] for raw in self.original_labels],
            Loader.LABEL_DTYPE)
        self.minibatch_labels.mem = numpy.zeros(
            self.max_minibatch_size, Loader.LABEL_DTYPE)

    def _build_labels_mapping_if_needed(self):
        self._map_original_labels()

    # -- validation re-split ------------------------------------------------

    def resize_validation(self, ratio=None):
        """Move a random train slice into validation (index rearrange)."""
        ratio = self.validation_ratio if ratio is None else ratio
        if ratio is None:
            return
        if ratio <= 0:
            self.class_lengths[TRAIN] += self.class_lengths[VALID]
            self.class_lengths[VALID] = 0
            self._calc_class_end_offsets()
            return
        total = self.class_lengths[VALID] + self.class_lengths[TRAIN]
        want_valid = int(numpy.round(ratio * total))
        offset = self.class_end_offsets[VALID] - self.class_lengths[VALID]
        window = numpy.arange(offset, offset + total)
        self.prng.shuffle(window)
        order = numpy.concatenate([
            numpy.sort(window[:want_valid]),
            numpy.sort(window[want_valid:])])
        self.original_data.map_write()
        self.original_data.mem[offset:offset + total] = \
            self.original_data.mem[order]
        if self.original_labels:
            self.original_labels[offset:offset + total] = [
                self.original_labels[i] for i in order]
        self.class_lengths[VALID] = want_valid
        self.class_lengths[TRAIN] = total - want_valid
        self._calc_class_end_offsets()

    # -- serving -------------------------------------------------------------

    def _device_window(self, start_offset, count):
        """The (max_minibatch_size,) int32 device index window: this
        minibatch's slice of the device copy of shuffled_indices, zeros
        past ``count`` (row 0 is gathered there and zeroed after)."""
        order = self.shuffled_indices.devmem
        if order.is_cuda:
            # the pipeline's worker reads it on its own stream and frees
            # it at an epoch's new order: its block waits for that
            # stream, wherever it was made
            order.record_stream(torch.cuda.current_stream(order.device))
        window = order[start_offset:start_offset + count]
        pad = self.max_minibatch_size - count
        if pad:
            window = torch.cat([window, torch.zeros(
                pad, dtype=window.dtype, device=window.device)])
        return window

    def fill_indices(self, start_offset, count):
        if not self._use_device_path():
            return super(FullBatchLoader, self).fill_indices(
                start_offset, count)
        start = time.perf_counter() if _tracer.live else None
        self._gather(start_offset, count)
        if start is not None:
            _tracer.complete("loader.gather", start,
                             time.perf_counter() - start, cat="loader",
                             args={"rows": count})
        return True

    def _gather(self, start_offset, count):
        """The device path of :meth:`fill_indices`."""
        self.shuffled_indices.map_read()
        self.minibatch_indices.mem[:count] = \
            self.shuffled_indices.mem[start_offset:start_offset + count]
        self.minibatch_indices.mem[count:] = -1
        idx = self._device_window(start_offset, count)
        original = self.original_data.devmem
        dtype = _TORCH_DTYPES[self.dtype]
        data = gather_minibatch(original, idx, dtype,
                                out=self._out("data", original, dtype))
        if count < self.max_minibatch_size:
            self._zero_tail(data, count)
        self.minibatch_data.set_device_array(data, self.device)
        if self.has_labels:
            mapped = self._mapped_original_labels_.devmem
            labels = gather_labels(mapped, idx, out=self._out(
                "labels", mapped, mapped.dtype))
            if count < self.max_minibatch_size:
                self._mask_tail_labels(labels, count)
            self.minibatch_labels.set_device_array(labels, self.device)

    @staticmethod
    def _zero_tail(data, count):
        """Zero the rows past ``count`` in place (times 0, as the
        reference masks them)."""
        mask = torch.arange(data.shape[0], device=data.device) < count
        return data.mul_(mask.to(data.dtype).reshape(
            (-1,) + (1,) * (data.ndim - 1)))

    @staticmethod
    def _mask_tail_labels(labels, count):
        """Label -1 past ``count``, in place."""
        rows = torch.arange(labels.shape[0], device=labels.device)
        return labels.masked_fill_(rows >= count, -1)

    def fill_minibatch(self):
        idx = self.minibatch_indices.mem[:self.minibatch_size]
        self.minibatch_data.map_write()
        self.original_data.map_read()
        self.minibatch_data.mem[:self.minibatch_size] = \
            self.original_data.mem[idx]
        if self.has_labels:
            self._mapped_original_labels_.map_read()
            self.minibatch_labels.map_write()
            self.minibatch_labels.mem[:self.minibatch_size] = \
                self._mapped_original_labels_.mem[idx]

    def map_minibatch_labels(self):
        pass  # labels were mapped once in _map_original_labels


class FullBatchLoaderMSE(LoaderMSEMixin, FullBatchLoader):
    """FullBatch variant serving (data, target) pairs."""

    def __init__(self, workflow, **kwargs):
        super(FullBatchLoaderMSE, self).__init__(workflow, **kwargs)
        self.original_targets = Array()

    @property
    def original_targets(self):
        return self._original_targets

    @original_targets.setter
    def original_targets(self, value):
        self._original_targets = self._coerce_array(value)

    def create_minibatch_data(self):
        super(FullBatchLoaderMSE, self).create_minibatch_data()
        self.minibatch_targets.mem = numpy.zeros(
            (self.max_minibatch_size,) + self.original_targets.shape[1:],
            self.dtype)

    def initialize(self, device=None, **kwargs):
        result = super(FullBatchLoaderMSE, self).initialize(
            device=device, **kwargs)
        if self.class_lengths[TRAIN] > 0:
            self.target_normalizer.analyze(self.original_targets.mem)
        self.target_normalizer.normalize(self.original_targets.mem)
        if self._use_device_path():
            if self.original_targets.dtype != self.dtype:
                self.original_targets.mem = \
                    self.original_targets.mem.astype(self.dtype)
            self.original_targets.initialize(self.device)
            self.original_targets.unmap()
        return result

    def fill_indices(self, start_offset, count):
        if not super(FullBatchLoaderMSE, self).fill_indices(
                start_offset, count):
            return False
        idx = self._device_window(start_offset, count)
        original = self.original_targets.devmem
        dtype = _TORCH_DTYPES[self.dtype]
        targets = gather_minibatch(original, idx, dtype,
                                   out=self._out("targets", original, dtype))
        if count < self.max_minibatch_size:
            self._zero_tail(targets, count)
        self.minibatch_targets.set_device_array(targets, self.device)
        return True

    def fill_minibatch(self):
        super(FullBatchLoaderMSE, self).fill_minibatch()
        idx = self.minibatch_indices.mem[:self.minibatch_size]
        self.original_targets.map_read()
        self.minibatch_targets.map_write()
        self.minibatch_targets.mem[:self.minibatch_size] = \
            self.original_targets.mem[idx]
