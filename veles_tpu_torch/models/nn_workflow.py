"""Layer-type mapping: the forward half of
``veles_tpu/models/nn_workflow.py``.  A layer spec's ``type`` names a
forward class by its shared ``MAPPING``; the training workflow and the
gradient-descent mapping are not ported yet."""

from veles_tpu_torch.models import (all2all, conv, dropout, pooling,
                                    transformer)
from veles_tpu_torch.models.nn_units import ForwardBase

__all__ = ["forward_mapping"]


def forward_mapping():
    """{MAPPING name: forward class} over the ported layer families."""
    mapping = {}
    for module in (all2all, conv, pooling, dropout, transformer):
        for name in dir(module):
            cls = getattr(module, name)
            if isinstance(cls, type) and issubclass(cls, ForwardBase) \
                    and getattr(cls, "MAPPING", None):
                mapping[cls.MAPPING] = cls
    return mapping
