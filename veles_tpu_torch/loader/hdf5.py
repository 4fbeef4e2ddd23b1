"""HDF5 dataset loader.

Counterpart of ``veles_tpu/loader/hdf5.py``.  Schema: each split file
holds datasets ``data`` (N, ...) and ``labels`` (N,); pass any of
test_path / validation_path / train_path.  ``h5py`` is imported when
the data loads.
"""

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader

__all__ = ["FullBatchHDF5Loader"]


class FullBatchHDF5Loader(FullBatchLoader):
    def __init__(self, workflow, **kwargs):
        super(FullBatchHDF5Loader, self).__init__(workflow, **kwargs)
        self.paths = (kwargs.get("test_path"),
                      kwargs.get("validation_path"),
                      kwargs.get("train_path"))

    def load_data(self):
        import h5py
        datas, labels = [], []
        for i, path in enumerate(self.paths):
            if not path:
                self.class_lengths[i] = 0
                datas.append(None)
                labels.append(None)
                continue
            with h5py.File(path, "r") as fin:
                data = numpy.asarray(fin["data"])
                lbl = (numpy.asarray(fin["labels"])
                       if "labels" in fin else None)
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
                    raw = lbl[j] if lbl is not None else -1
                    self.original_labels[offset + j] = (
                        raw.item() if hasattr(raw, "item") else raw)
            offset += len(data)
