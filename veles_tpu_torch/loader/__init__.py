"""Minibatch loaders; counterpart of ``veles_tpu/loader``: the
TEST/VALID/TRAIN contract of :mod:`.base`, the device-resident
:mod:`.fullbatch` loader, whose minibatches come from the
``gather_minibatch`` kernel, and the loaders built on them (files,
pickles, HDF5, audio, images, WebHDFS, saved streams, queue feeds)."""

from veles_tpu_torch.loader.base import (  # noqa: F401
    Loader, LoaderMSEMixin, LoaderError, TEST, VALID, TRAIN, CLASS_NAME)
from veles_tpu_torch.loader.fullbatch import (  # noqa: F401
    FullBatchLoader, FullBatchLoaderMSE)
from veles_tpu_torch.loader.audio import AudioFileLoader  # noqa: F401
from veles_tpu_torch.loader.hdfs import (  # noqa: F401
    HdfsTextLoader, WebHdfsClient)
