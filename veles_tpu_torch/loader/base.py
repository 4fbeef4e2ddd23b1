"""Loader — the minibatch server contract.

Counterpart of ``veles_tpu/loader/base.py``.  Same semantics:

- the TEST(0) / VALIDATION(1) / TRAIN(2) class triple with
  ``class_lengths`` / ``class_end_offsets`` and per-epoch iteration
  test -> validation -> train;
- per-epoch TRAIN shuffling bounded by ``shuffle_limit``, driven by the
  keyed reproducible PRNG (the same draws as the JAX package);
- ``Bool`` flags ``last_minibatch`` / ``epoch_ended`` / ``train_ended`` /
  ``test_ended`` that downstream decision units gate on;
- label -> int mapping built during dataset analysis;
- normalizer hookup through ``normalization_type`` /
  ``normalization_parameters``.

Subclasses implement ``load_data`` / ``create_minibatch_data`` /
``fill_minibatch`` as in the JAX package.  Not ported: the
master-slave window protocol with its pending/failed minibatch
bookkeeping, the input pipeline's thread-private serve shadow, the
``testing`` mode and ``train_ratio`` (every train sample serves), and
the result-provider metrics of the command line.
"""

import time

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.normalization import (NormalizerRegistry,
                                           StatelessNormalizer)
from veles_tpu_torch.units import Unit

__all__ = ["Loader", "LoaderMSEMixin", "LoaderError",
           "TEST", "VALID", "TRAIN", "CLASS_NAME"]

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAME = ["test", "validation", "train"]


class LoaderError(Exception):
    pass


class Loader(Unit):
    """Serves minibatches; see the module docstring for the contract."""

    LABEL_DTYPE = numpy.int32
    INDEX_DTYPE = numpy.int32

    def __init__(self, workflow, **kwargs):
        super(Loader, self).__init__(workflow, **kwargs)
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        self.train_ended = Bool(False)
        self.test_ended = Bool(False)
        self.shuffle_limit = kwargs.get(
            "shuffle_limit", numpy.iinfo(numpy.uint32).max)
        self._max_minibatch_size = int(kwargs.get("minibatch_size", 100))
        if self._max_minibatch_size < 1:
            raise ValueError("minibatch_size must be positive")
        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]
        self.epoch_number = 0
        self.samples_served = 0
        self.global_offset = 0
        self.minibatch_class = 0
        self.minibatch_size = 0
        self.minibatch_data = Array(shallow_pickle=True)
        self.minibatch_indices = Array(shallow_pickle=True)
        self.minibatch_labels = Array(shallow_pickle=True)
        self.raw_minibatch_labels = []
        self.shuffled_indices = Array()
        self.labels_mapping = {}
        self._normalization_type = kwargs.get("normalization_type", "none")
        self._normalization_parameters = kwargs.get(
            "normalization_parameters", {})
        self._normalizer = None
        self.prng = kwargs.get("prng", prng.get())

    def init_unpickled(self):
        super(Loader, self).init_unpickled()
        self._minibatch_offset_ = 0
        self._serve_log_time_ = time.time()

    # -- the ILoader contract ---------------------------------------------

    def load_data(self):
        """Populate class_lengths (and any backing storage)."""
        raise NotImplementedError

    def create_minibatch_data(self):
        """Allocate minibatch_data for max_minibatch_size samples."""
        raise NotImplementedError

    def fill_minibatch(self):
        """Fill minibatch_data[:minibatch_size] (and raw labels) according
        to minibatch_indices."""
        raise NotImplementedError

    # -- derived quantities -------------------------------------------------

    @property
    def has_labels(self):
        return len(self.labels_mapping) > 0

    @property
    def reversed_labels_mapping(self):
        return {v: k for k, v in self.labels_mapping.items()}

    @property
    def unique_labels_count(self):
        return len(self.labels_mapping)

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    @property
    def max_minibatch_size(self):
        return self._max_minibatch_size

    @property
    def minibatch_offset(self):
        return self._minibatch_offset_

    @minibatch_offset.setter
    def minibatch_offset(self, value):
        self._minibatch_offset_ = value
        self._update_flags()

    @property
    def shape(self):
        return self.minibatch_data.shape[1:]

    @property
    def normalizer(self):
        if self._normalizer is None:
            self._normalizer = NormalizerRegistry.get(
                self._normalization_type, **self._normalization_parameters)
        return self._normalizer

    @property
    def normalization_type(self):
        return self._normalization_type

    @normalization_type.setter
    def normalization_type(self, value):
        self._normalization_type = value
        self._normalizer = None

    # -- lifecycle ----------------------------------------------------------

    def initialize(self, **kwargs):
        super(Loader, self).initialize(**kwargs)
        self.load_data()
        self._calc_class_end_offsets()
        self._max_minibatch_size = min(
            self._max_minibatch_size, max(self.class_lengths))
        self.info(
            "Samples: test %d, validation %d, train %d; minibatch %d",
            self.class_lengths[TEST], self.class_lengths[VALID],
            self.class_lengths[TRAIN], self.max_minibatch_size)
        self.minibatch_indices.mem = numpy.zeros(
            self.max_minibatch_size, self.INDEX_DTYPE)
        self.minibatch_labels.reset()
        self.raw_minibatch_labels = [None] * self.max_minibatch_size
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise LoaderError(
                "create_minibatch_data() must set minibatch_data")
        self.analyze_dataset()
        if self.has_labels:
            self.minibatch_labels.mem = numpy.zeros(
                self.max_minibatch_size, self.LABEL_DTYPE)
        self.shuffle()
        return True

    def run(self):
        self.serve_next_minibatch()
        self._on_successful_serve()

    # -- serving ------------------------------------------------------------

    def shuffle(self):
        """Shuffle the TRAIN window of shuffled_indices."""
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=self.INDEX_DTYPE)
        if self.shuffle_limit <= 0 or self.class_lengths[TRAIN] == 0:
            return
        self.shuffle_limit -= 1
        self.shuffled_indices.map_write()
        self.prng.shuffle(
            self.shuffled_indices.mem[self.class_end_offsets[VALID]:])

    def serve_next_minibatch(self):
        offset, size = self._advance_global_offset()
        self.minibatch_size = size
        self.minibatch_offset = offset
        if self.fill_indices(offset - size, size):
            return  # the device path filled everything already
        self.fill_minibatch()
        self.normalize_minibatch()
        self.map_minibatch_labels()
        if size < self.max_minibatch_size:
            self.minibatch_data[size:] = 0.0
            if self.has_labels:
                self.minibatch_labels[size:] = -1
            self.minibatch_indices[size:] = -1

    def fill_indices(self, start_offset, count):
        """Default host path: copy the indices window.  Returns True when
        a device path already produced the whole minibatch."""
        for arr in (self.minibatch_data, self.minibatch_labels,
                    self.minibatch_indices):
            arr.map_invalidate()
        self.shuffled_indices.map_read()
        self.minibatch_indices.mem[:count] = \
            self.shuffled_indices.mem[start_offset:start_offset + count]
        return False

    def normalize_minibatch(self):
        self.normalizer.normalize(
            self.minibatch_data.mem[:self.minibatch_size])

    def map_minibatch_labels(self):
        if not self.has_labels:
            return
        self.minibatch_labels.map_write()
        for i, raw in enumerate(
                self.raw_minibatch_labels[:self.minibatch_size]):
            self.minibatch_labels[i] = self.labels_mapping[raw]

    def analyze_dataset(self):
        """One pass over TRAIN building normalizer stats + labels
        mapping."""
        if self.class_lengths[TRAIN] == 0:
            if not self.normalizer.initialized:
                raise LoaderError(
                    "no train samples and the normalizer is uninitialized")
            return
        if isinstance(self.normalizer, StatelessNormalizer):
            self.normalizer.analyze(self.minibatch_data.mem)
            self._build_labels_mapping_if_needed()
            return
        raw_labels = set()

        def callback():
            self.normalizer.analyze(
                self.minibatch_data.mem[:self.minibatch_size])
            raw_labels.update(
                l for l in self.raw_minibatch_labels[:self.minibatch_size]
                if l is not None)

        self._iterate_class(TRAIN, callback)
        if raw_labels and not self.labels_mapping:
            for i, lbl in enumerate(sorted(raw_labels)):
                self.labels_mapping[lbl] = i

    def _build_labels_mapping_if_needed(self):
        """Hook for subclasses that can derive labels without iteration."""

    def _iterate_class(self, class_index, callback):
        """Serve every minibatch of one class through fill_minibatch."""
        size = self.class_lengths[class_index]
        start = self.class_end_offsets[class_index] - size
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=self.INDEX_DTYPE)
        for offset in range(start, start + size, self.max_minibatch_size):
            count = min(self.max_minibatch_size, start + size - offset)
            self.minibatch_size = count
            self.minibatch_indices.mem[:count] = \
                self.shuffled_indices.mem[offset:offset + count]
            self.fill_minibatch()
            callback()

    def _class_ended(self):
        for offset in self.class_end_offsets:
            if self.global_offset == offset:
                return True
            if self.global_offset < offset:
                return False
        raise LoaderError("global_offset out of bounds")

    def class_index_by_sample_index(self, index):
        for class_index, class_offset in enumerate(self.class_end_offsets):
            if index < class_offset:
                return class_index, class_offset - index
        raise LoaderError("sample index %d out of bounds" % index)

    def _calc_class_end_offsets(self):
        total = 0
        for i, n in enumerate(self.class_lengths):
            total += int(n)
            self.class_end_offsets[i] = total
        if total == 0:
            raise LoaderError("there is no data to serve")

    def _update_flags(self):
        last_mb = self._class_ended()
        self.last_minibatch <<= last_mb
        self.epoch_ended <<= last_mb and (
            self.minibatch_class == VALID or
            (self.minibatch_class == TEST and
             self.class_lengths[TRAIN] == self.class_lengths[VALID] == 0) or
            (self.minibatch_class == TRAIN and
             self.class_lengths[VALID] == 0))

    def _advance_global_offset(self):
        if self.global_offset >= self.total_samples:
            self.global_offset = 0
            self.shuffle()
        self.minibatch_class, remainder = self.class_index_by_sample_index(
            self.global_offset)
        size = min(remainder, self.max_minibatch_size)
        self.global_offset += size
        self.train_ended <<= self.global_offset >= self.total_samples
        self.test_ended <<= self.global_offset >= self.class_end_offsets[TEST]
        return self.global_offset, size

    def _on_successful_serve(self):
        self.samples_served += self.minibatch_size
        if self.samples_served > 0:
            num, den = divmod(self.samples_served, self.total_samples)
            self.epoch_number = num
            now = time.time()
            if now - self._serve_log_time_ >= 10:
                self._serve_log_time_ = now
                self.info("Served %d samples (%d epochs, %.1f%%)",
                          self.samples_served, num,
                          100.0 * den / self.total_samples)


class LoaderMSEMixin(object):
    """Adds regression targets to the contract."""

    def __init__(self, workflow, **kwargs):
        super(LoaderMSEMixin, self).__init__(workflow, **kwargs)
        self.minibatch_targets = Array(shallow_pickle=True)
        self.targets_shape = None
        self.target_normalization_type = kwargs.get(
            "target_normalization_type", "none")
        self.target_normalization_parameters = kwargs.get(
            "target_normalization_parameters", {})
        self._target_normalizer = None

    @property
    def target_normalizer(self):
        if self._target_normalizer is None:
            self._target_normalizer = NormalizerRegistry.get(
                self.target_normalization_type,
                **self.target_normalization_parameters)
        return self._target_normalizer
