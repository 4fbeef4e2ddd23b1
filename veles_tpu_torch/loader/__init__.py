"""Minibatch loaders; counterpart of ``veles_tpu/loader``: the
TEST/VALID/TRAIN contract of :mod:`.base` and the device-resident
:mod:`.fullbatch` loader, whose minibatches come from the
``gather_minibatch`` kernel."""

from veles_tpu_torch.loader.base import (  # noqa: F401
    Loader, LoaderMSEMixin, LoaderError, TEST, VALID, TRAIN, CLASS_NAME)
from veles_tpu_torch.loader.fullbatch import (  # noqa: F401
    FullBatchLoader, FullBatchLoaderMSE)
