"""Logging mixin: the part of ``veles_tpu.logger.Logger`` that the
serve engine and the batcher use — a named standard-library logger and
the ``info`` and ``exception`` methods.  Event tracing is not ported."""

import logging

__all__ = ["Logger"]


class Logger(object):
    """Mixin giving every object a named logger."""

    def __init__(self, **kwargs):
        logger_name = kwargs.pop("logger_name", type(self).__name__)
        super(Logger, self).__init__()
        self._logger_ = logging.getLogger(logger_name)

    def info(self, msg, *args):
        self._logger_.info(msg, *args)

    def exception(self, msg="Exception", *args):
        self._logger_.exception(msg, *args)
