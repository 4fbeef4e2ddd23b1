"""Minibatch stream saver and replayer.

Counterpart of ``veles_tpu/loader/saver.py``: :class:`MinibatchesSaver`
writes every served minibatch into a compressed stream so expensive
preprocessing runs once; :class:`MinibatchesLoader` replays the stream
as a loader.  Stream format: gzip-framed pickles, one record per
minibatch, after a header record with the class lengths, the minibatch
size and the labels mapping.  The saver reads a device minibatch back
to the host; the replay serves through the host path.
"""

import gzip
import pickle

import numpy

from veles_tpu_torch.loader.base import Loader
from veles_tpu_torch.units import Unit

__all__ = ["MinibatchesSaver", "MinibatchesLoader"]


class MinibatchesSaver(Unit):
    """Link after a loader; writes each served minibatch."""

    def __init__(self, workflow, **kwargs):
        super(MinibatchesSaver, self).__init__(workflow, **kwargs)
        self.path = kwargs.get("path", "minibatches.dat.gz")
        self.loader = None  # linked
        self._file = None
        self.records = 0
        self.demand("loader")

    def initialize(self, **kwargs):
        super(MinibatchesSaver, self).initialize(**kwargs)
        self._file = gzip.open(self.path, "wb", compresslevel=1)
        header = {
            "class_lengths": list(self.loader.class_lengths),
            "max_minibatch_size": self.loader.max_minibatch_size,
            "labels_mapping": dict(self.loader.labels_mapping),
        }
        pickle.dump(header, self._file, protocol=pickle.HIGHEST_PROTOCOL)
        return True

    def run(self):
        loader = self.loader
        loader.minibatch_data.map_read()
        record = {
            "data": numpy.array(
                loader.minibatch_data.mem[:loader.minibatch_size]),
            "class": loader.minibatch_class,
            "size": loader.minibatch_size,
            "indices": numpy.array(
                loader.minibatch_indices.mem[:loader.minibatch_size]),
        }
        if loader.has_labels:
            loader.minibatch_labels.map_read()
            record["labels"] = numpy.array(
                loader.minibatch_labels.mem[:loader.minibatch_size])
        pickle.dump(record, self._file, protocol=pickle.HIGHEST_PROTOCOL)
        self.records += 1

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class MinibatchesLoader(Loader):
    """Replays a saved stream; epochs loop over the recorded sequence."""

    def __init__(self, workflow, **kwargs):
        super(MinibatchesLoader, self).__init__(workflow, **kwargs)
        self.path = kwargs.get("path", "minibatches.dat.gz")
        self.records = []
        self._cursor = 0

    def load_data(self):
        with gzip.open(self.path, "rb") as fin:
            header = pickle.load(fin)
            while True:
                try:
                    self.records.append(pickle.load(fin))
                except EOFError:
                    break
        self.class_lengths[:] = header["class_lengths"]
        self._max_minibatch_size = header["max_minibatch_size"]
        self.labels_mapping.update(header["labels_mapping"])
        self._calc_class_end_offsets()

    def create_minibatch_data(self):
        first = self.records[0]
        self.minibatch_data.mem = numpy.zeros(
            (self.max_minibatch_size,) + first["data"].shape[1:],
            first["data"].dtype)

    def analyze_dataset(self):
        self.normalizer.analyze(self.records[0]["data"])

    def fill_indices(self, start_offset, count):
        record = self.records[self._cursor % len(self.records)]
        self._cursor += 1
        size = record["size"]
        self.minibatch_size = size
        self.minibatch_data.map_invalidate()
        self.minibatch_data.mem[:size] = record["data"]
        self.minibatch_indices.map_invalidate()
        self.minibatch_indices.mem[:size] = record["indices"]
        if "labels" in record:
            if not self.minibatch_labels:
                self.minibatch_labels.mem = numpy.zeros(
                    self.max_minibatch_size, Loader.LABEL_DTYPE)
            self.minibatch_labels.map_invalidate()
            self.minibatch_labels.mem[:size] = record["labels"]
        return True

    def fill_minibatch(self):
        pass
