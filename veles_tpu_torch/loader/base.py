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
``fill_minibatch`` as in the JAX package.

Snapshots: the loader pickles its position (``global_offset``, the
epoch and class counters), ``shuffled_indices`` and its PRNG stream, so
a restored loader serves exactly the minibatches the original would
have served next: its ``initialize`` does not shuffle again.  It also
reads the JAX package's loader state (``_minibatch_class`` /
``_epoch_number`` there).

The serve-record window (``veles_tpu/loader/base.py``): every serve
appends ``(offset, size, class, global_offset)`` to
``pending_minibatches_[None]``; a synchronous run retires its record at
the next serve, the input pipeline (``veles_tpu_torch/pipeline_input.py``)
when the graph consumes the minibatch.  ``serve_next_minibatch`` replays
``failed_minibatches`` first, newest first.  A pickle taken while the
loader runs moves the pending records into ``failed_minibatches``
(newest first, so the replay keeps the serve order), except a
synchronous run's consumed one; with a pipeline attached it waits for
the worker's serve in progress (``Prefetcher.quiescent``) and copies the
worker-owned ``shuffled_indices`` and PRNG at that moment.  While the
pipeline's worker serves ahead, the public serving fields (minibatch
class, size, offset, epoch number and the four end-of-class flags) go
to its thread-private :class:`ServeShadow`; the graph thread applies
each minibatch's snapshot of them when it consumes the minibatch.
``testing`` mode serves the test class only, unshuffled.

``train_ratio`` (default 1.0) serves only that share of the train
class: ``effective_total_samples`` and ``effective_class_end_offsets``
end the epoch early.

The master-slave exchange over the same window, keyed by slave id: a
master's ``generate_data_for_slave`` serves the next minibatch into
``pending_minibatches_[slave.id]`` without filling it (the slave fills
its own) and ships ``(indices, class, size, offset, epoch)``; the slave's
``apply_data_from_master`` patches its ``shuffled_indices`` window and
its own serve takes that window.  The master's
``apply_data_from_slave`` retires the slave's newest record and sets
the flags against the global offset as of that record's serve
(``_flags_global_offset_``), so an async slave's served-ahead jobs
close their classes where they were served.  ``drop_slave`` requeues a
dead slave's records into ``failed_minibatches``;
``unserved_remainder`` and ``apply_reshard`` feed the Server's
reshards.  A pickle taken on a master moves every slave's records into
``failed_minibatches`` too.
"""

import copy
import threading
import time
from collections import defaultdict

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


class ServeShadow(object):
    """The input pipeline worker's private view of a loader's public
    serving fields: what it serves ahead lands here, keyed on its
    thread, and the graph thread keeps seeing the fields of the
    minibatch it consumes."""

    __slots__ = ("thread", "values")

    #: the public flags routed through the shadow
    FLAGS = ("last_minibatch", "epoch_ended", "train_ended", "test_ended")

    def __init__(self, loader, thread):
        self.thread = thread
        self.values = {
            "minibatch_class": loader.minibatch_class,
            "minibatch_size": loader.minibatch_size,
            "minibatch_offset": loader.minibatch_offset,
            "epoch_number": loader.epoch_number,
        }
        for name in self.FLAGS:
            self.values[name] = bool(getattr(loader, name))


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
        self.testing = kwargs.get("testing", False)
        self.shuffle_limit = kwargs.get(
            "shuffle_limit", numpy.iinfo(numpy.uint32).max)
        if self.testing:
            self.shuffle_limit = 0
        self._max_minibatch_size = int(kwargs.get("minibatch_size", 100))
        if self._max_minibatch_size < 1:
            raise ValueError("minibatch_size must be positive")
        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]
        self.train_ratio = kwargs.get("train_ratio", 1.0)
        self.epoch_number = 0
        self.samples_served = 0
        self.global_offset = 0
        self.minibatch_class = 0
        self.minibatch_data = Array(shallow_pickle=True)
        self.minibatch_indices = Array(shallow_pickle=True)
        self.minibatch_labels = Array(shallow_pickle=True)
        self.raw_minibatch_labels = []
        self.shuffled_indices = Array()
        self.labels_mapping = {}
        self.failed_minibatches = []
        self._total_failed = 0
        self.has_data_for_slave = True
        #: the advisory window hint of the last reshard push
        #: (apply_reshard); None until a master pushed one
        self.fleet_share = None
        self.fleet_epoch = None
        self._normalization_type = kwargs.get("normalization_type", "none")
        self._normalization_parameters = kwargs.get(
            "normalization_parameters", {})
        self._normalizer = None
        self.prng = kwargs.get("prng", prng.get())

    def init_unpickled(self):
        super(Loader, self).init_unpickled()
        self._minibatch_offset_ = 0
        self._minibatch_size_ = 0
        self.pending_minibatches_ = defaultdict(list)
        self._serve_log_time_ = time.time()
        # a slave's update sets the flags against the global offset as
        # of that job's serve (an async slave's master served ahead);
        # None: the live offset
        self._flags_global_offset_ = None
        # the input pipeline's hookup, transient: a restored loader
        # serves synchronously until a FusedTrainer attaches a new
        # Prefetcher at initialize
        self._serve_shadow_ = None
        self._pipeline_ = None

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
    def effective_total_samples(self):
        return self.total_samples - int(
            (1.0 - self.train_ratio) * self.class_lengths[TRAIN])

    @property
    def effective_class_end_offsets(self):
        offsets = list(self.class_end_offsets)
        offsets[TRAIN] -= int(
            (1.0 - self.train_ratio) * self.class_lengths[TRAIN])
        return offsets

    @property
    def max_minibatch_size(self):
        return self._max_minibatch_size

    @property
    def pending_minibatches_count(self):
        return sum(len(v) for v in self.pending_minibatches_.values())

    @property
    def total_failed(self):
        return self._total_failed

    # -- serving fields, routed to the pipeline worker's shadow ------------

    def _shadow_for_current_thread(self):
        shadow = self._serve_shadow_
        if shadow is not None and \
                threading.current_thread() is shadow.thread:
            return shadow
        return None

    def _set_flag(self, name, value):
        """Write a public Bool flag; the pipeline worker's write lands in
        its shadow, applied when its minibatch is consumed."""
        shadow = self._shadow_for_current_thread()
        if shadow is not None:
            shadow.values[name] = bool(value)
        else:
            flag = getattr(self, name)
            flag <<= value

    def _serving_field(name, backing, after_set=None):
        """A public serving field over ``backing``, read and written in
        the worker's shadow on the worker's thread."""
        def get(self):
            shadow = self._shadow_for_current_thread()
            if shadow is not None:
                return shadow.values[name]
            return getattr(self, backing)

        def put(self, value):
            shadow = self._shadow_for_current_thread()
            if shadow is not None:
                shadow.values[name] = value
            else:
                setattr(self, backing, value)
            if after_set is not None:
                after_set(self)
        return property(get, put)

    minibatch_size = _serving_field("minibatch_size", "_minibatch_size_")
    minibatch_class = _serving_field("minibatch_class", "_minibatch_class")
    epoch_number = _serving_field("epoch_number", "_epoch_number")
    minibatch_offset = _serving_field(
        "minibatch_offset", "_minibatch_offset_",
        after_set=lambda self: self._update_flags())
    del _serving_field

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
        if self.testing:
            self.global_offset = 0
            del self.failed_minibatches[:]
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
        if self.testing:
            self.shuffled_indices.reset()
        if not getattr(self, "restored_from_snapshot", False) or \
                self.testing:
            # a restored loader keeps its pickled order and PRNG stream
            self.shuffle()
        return True

    def run(self):
        pipeline = self._pipeline_
        if pipeline is not None:
            pipeline.step()
            return
        self.pending_minibatches_.pop(None, None)
        self.serve_next_minibatch(None)
        self._on_successful_serve()

    def stop(self):
        pipeline = self._pipeline_
        if pipeline is not None:
            pipeline.shutdown()
        super(Loader, self).stop()

    def on_workflow_finish(self):
        """The end of a run: join the pipeline's worker (the next run
        starts a new one)."""
        pipeline = self._pipeline_
        if pipeline is not None:
            pipeline.shutdown()

    def get_metric_names(self):
        if not self.testing:
            return {"Total epochs"}
        return {"Labels"} if self.has_labels else set()

    def get_metric_values(self):
        if not self.testing:
            return {"Total epochs": self.epoch_number}
        if self.has_labels:
            return {"Labels": self.reversed_labels_mapping}
        return {}

    # -- the master-slave exchange ------------------------------------------

    def generate_data_for_master(self):
        return True

    def generate_data_for_slave(self, slave):
        self.serve_next_minibatch(slave.id)
        data = {
            "indices": numpy.array(
                self.minibatch_indices.mem[:self.minibatch_size]),
            "minibatch_class": self.minibatch_class,
            "minibatch_size": self.minibatch_size,
            "minibatch_offset": self.minibatch_offset,
            "epoch_number": self.epoch_number,
        }
        self.has_data_for_slave = (
            not self._class_ended() or len(self.failed_minibatches) > 0)
        return data

    def apply_data_from_master(self, data):
        for attr in ("minibatch_class", "minibatch_size",
                     "minibatch_offset", "epoch_number"):
            setattr(self, attr, data[attr])
        self.last_minibatch <<= False
        self.epoch_ended <<= False
        self.train_ended <<= False
        indices = data["indices"]
        if indices.size != self.minibatch_size:
            raise LoaderError("minibatch size mismatch from master")
        start = self.minibatch_offset - self.minibatch_size
        if start < 0 or self.minibatch_offset > len(self.shuffled_indices):
            raise LoaderError("minibatch offset out of range from master")
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=self.INDEX_DTYPE)
        self.shuffled_indices.map_write()
        self.shuffled_indices.mem[start:self.minibatch_offset] = indices

    def apply_data_from_slave(self, data, slave):
        if slave is None:
            return
        try:
            job = self.pending_minibatches_[slave.id].pop()
        except (KeyError, IndexError):
            raise LoaderError(
                "no pending minibatch for slave %s" % slave.id)
        offset, size, mb_class, global_snapshot = job
        self.minibatch_class = mb_class
        self._flags_global_offset_ = global_snapshot
        try:
            self.minibatch_offset, self.minibatch_size = offset, size
            self._on_successful_serve()
        finally:
            self._flags_global_offset_ = None
        if not self.has_data_for_slave:
            self.has_data_for_slave = bool(self.last_minibatch)

    def drop_slave(self, slave):
        if slave.id in self.pending_minibatches_:
            self._total_failed += 1
            self.failed_minibatches.extend(
                self.pending_minibatches_.pop(slave.id))
            self.has_data_for_slave = True
            self.info("Jobs failed: %d, pending: %d",
                      len(self.failed_minibatches),
                      self.pending_minibatches_count)

    def unserved_remainder(self):
        """Samples of the current epoch not applied yet: the class-window
        total less this epoch's applied progress.  Reserved but unapplied
        minibatches count as unserved, so a reshard after a drop
        repartitions exactly what the requeue put back."""
        total = self.effective_total_samples
        if not total:
            return None
        return total - self.samples_served % total

    def apply_reshard(self, info):
        """A slave's window hint from a master's reshard push: its
        power-weighted share of the epoch's unserved remainder and the
        membership epoch of that split.  Advisory beside the per-job
        window of ``apply_data_from_master``."""
        self.fleet_share = info.get("share")
        self.fleet_epoch = info.get("epoch")
        self.debug("reshard hint: share %s of %s at membership "
                   "epoch %s", self.fleet_share, info.get("remaining"),
                   self.fleet_epoch)

    # -- pickling: pending -> failed ------------------------------------------

    def __getstate__(self):
        pipeline = self._pipeline_
        if pipeline is not None:
            # no half-applied serve: the worker changes the window and
            # the index order between these reads
            with pipeline.quiescent():
                return self._getstate_quiesced()
        return self._getstate_quiesced()

    def _getstate_quiesced(self):
        state = super(Loader, self).__getstate__()
        if not self.stopped:
            failed = list(state.get("failed_minibatches", []))
            for key, records in self.pending_minibatches_.items():
                if key is None and self._pipeline_ is None:
                    # a synchronous run retires its record at the next
                    # serve, but a snapshot comes after the graph
                    # consumed the minibatch: requeueing it would serve
                    # it twice on resume
                    continue
                # newest first: the replay pops the newest first, so
                # the serve order is kept
                failed.extend(reversed(records))
            state["failed_minibatches"] = failed
        if self._pipeline_ is not None:
            # pickle writes the state after the lock is released, while
            # the worker serves on: an epoch's shuffle would tear these
            state["shuffled_indices"] = copy.deepcopy(self.shuffled_indices)
            state["prng"] = copy.deepcopy(self.prng)
        # the JAX package's loader pickles the data event's state too
        state["has_data_for_slave"] = self.has_data_for_slave
        return state

    def __setstate__(self, state):
        # the serving fields are properties over these backing names (the
        # JAX package's); earlier port snapshots hold the plain names
        for legacy, backing in (("minibatch_class", "_minibatch_class"),
                                ("epoch_number", "_epoch_number")):
            if legacy in state and backing not in state:
                state[backing] = state.pop(legacy)
        state.pop("minibatch_size", None)
        has_data = state.pop("has_data_for_slave", True)
        state.setdefault("testing", False)
        state.setdefault("failed_minibatches", [])
        super(Loader, self).__setstate__(state)
        self.has_data_for_slave = has_data

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

    def serve_next_minibatch(self, slave_id=None):
        """Serve the next minibatch: the newest failed record first, else
        the next window; its record goes to
        ``pending_minibatches_[slave_id]``."""
        try:
            minibatch_def = self.failed_minibatches.pop()
            offset, size = minibatch_def[0], minibatch_def[1]
            self.minibatch_class = minibatch_def[2]
        except IndexError:
            offset, size = self._advance_global_offset()
            minibatch_def = (offset, size, self.minibatch_class,
                             self.global_offset)
        self.pending_minibatches_[slave_id].append(minibatch_def)
        self.minibatch_offset, self.minibatch_size = offset, size
        if self.is_master:
            # the slave fills its own minibatch from the window it gets
            self.shuffled_indices.map_read()
            self.minibatch_indices.map_write()
            self.minibatch_indices.mem[:size] = \
                self.shuffled_indices.mem[offset - size:offset]
            return
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
        current = (self._flags_global_offset_
                   if self._flags_global_offset_ is not None
                   else self.global_offset)
        for offset in self.effective_class_end_offsets:
            if current == offset:
                return True
            if current < offset:
                return False
        raise LoaderError("global_offset out of bounds")

    def class_index_by_sample_index(self, index):
        for class_index, class_offset in enumerate(
                self.effective_class_end_offsets):
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
        if self.is_slave:
            return  # set by apply_data_from_master
        if self._flags_global_offset_ is not None:
            # a slave's update: its own serve-time offset says whether
            # it closed its class
            last_mb = self._class_ended() and not self.failed_minibatches
        else:
            last_mb = (self._class_ended() and
                       (not self.pending_minibatches_count or
                        not self.is_master) and
                       not self.failed_minibatches)
        self._set_flag("last_minibatch", last_mb)
        self._set_flag("epoch_ended", last_mb and (
            self.minibatch_class == VALID or
            (self.minibatch_class == TEST and
             self.class_lengths[TRAIN] == self.class_lengths[VALID] == 0) or
            (self.minibatch_class == TEST and self.testing) or
            (self.minibatch_class == TRAIN and
             self.class_lengths[VALID] == 0)))

    def _advance_global_offset(self):
        if self.is_slave:
            return self.minibatch_offset, self.minibatch_size
        if self.global_offset >= self.effective_total_samples:
            self.global_offset = 0
            self.shuffle()
        self.minibatch_class, remainder = self.class_index_by_sample_index(
            self.global_offset)
        size = min(remainder, self.max_minibatch_size)
        self.global_offset += size
        self._set_flag("train_ended",
                       self.global_offset >= self.effective_total_samples)
        self._set_flag("test_ended",
                       self.global_offset >= self.class_end_offsets[TEST])
        return self.global_offset, size

    def _on_successful_serve(self):
        self.samples_served += self.minibatch_size
        if not self.is_slave and self.samples_served > 0:
            num, den = divmod(self.samples_served,
                              self.effective_total_samples)
            self.epoch_number = num
            now = time.time()
            if now - self._serve_log_time_ >= 10:
                self._serve_log_time_ = now
                self.info(
                    "Served %d samples (%d epochs, %.1f%%); failed %d, "
                    "pending %d", self.samples_served, num,
                    100.0 * den / self.effective_total_samples,
                    len(self.failed_minibatches),
                    self.pending_minibatches_count)


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
