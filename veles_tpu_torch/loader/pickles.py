"""Pickled-array dataset loader.

Counterpart of ``veles_tpu/loader/pickles.py``: each split is a pickle
file holding an array, a (data, labels) tuple or a {"data": ...,
"labels": ...} dict.  A ``FullBatchLoader``: on the card each minibatch
is one ``gather_minibatch`` launch."""

import pickle

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader

__all__ = ["PicklesLoader"]


def _unpack(obj):
    if isinstance(obj, dict):
        return numpy.asarray(obj["data"]), obj.get("labels")
    if isinstance(obj, tuple) and len(obj) == 2:
        return numpy.asarray(obj[0]), obj[1]
    return numpy.asarray(obj), None


class PicklesLoader(FullBatchLoader):
    def __init__(self, workflow, **kwargs):
        super(PicklesLoader, self).__init__(workflow, **kwargs)
        self.paths = (kwargs.get("test_path"),
                      kwargs.get("validation_path"),
                      kwargs.get("train_path"))

    def load_data(self):
        datas, labels = [], []
        for i, path in enumerate(self.paths):
            if not path:
                self.class_lengths[i] = 0
                datas.append(None)
                labels.append(None)
                continue
            with open(path, "rb") as fin:
                data, lbl = _unpack(pickle.load(fin))
            self.class_lengths[i] = len(data)
            datas.append(data)
            labels.append(lbl)
        self._calc_class_end_offsets()
        shape = next(d for d in datas if d is not None).shape[1:]
        has_labels = any(l is not None for l in labels)
        self.create_originals(shape, labels=has_labels)
        offset = 0
        for data, lbl in zip(datas, labels):
            if data is None:
                continue
            self.original_data.mem[offset:offset + len(data)] = data
            if has_labels:
                for j in range(len(data)):
                    self.original_labels[offset + j] = (
                        lbl[j] if lbl is not None else -1)
            offset += len(data)
