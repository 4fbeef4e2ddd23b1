"""Base of the forward layer classes.

Counterpart of ``veles_tpu/models/nn_units.py``'s ``ForwardBase``.  The
port has no unit graph yet: a forward class is a namespace holding its
``MAPPING`` name (the layer-spec ``type``) and a pure ``apply(params,
x, **static)`` over torch tensors, which is all the compiler walk and
the serve engine need."""

__all__ = ["ForwardBase"]


class ForwardBase(object):
    """A forward layer: ``apply(params, x, **static) -> y``."""

    MAPPING = None
