"""Logging mixin: the part of ``veles_tpu.logger.Logger`` that the
port's units, the serve engine and the batcher use — a named
standard-library logger and its level methods.  Event tracing is not
ported."""

import logging

__all__ = ["Logger"]


class Logger(object):
    """Mixin giving every object a named logger."""

    def __init__(self, **kwargs):
        logger_name = kwargs.pop("logger_name", type(self).__name__)
        super(Logger, self).__init__()
        self._logger_ = logging.getLogger(logger_name)

    def init_unpickled(self):
        parent = super(Logger, self)
        if hasattr(parent, "init_unpickled"):
            parent.init_unpickled()
        self._logger_ = logging.getLogger(type(self).__name__)

    @property
    def logger(self):
        return self._logger_

    def debug(self, msg, *args):
        self._logger_.debug(msg, *args)

    def info(self, msg, *args):
        self._logger_.info(msg, *args)

    def warning(self, msg, *args):
        self._logger_.warning(msg, *args)

    def error(self, msg, *args):
        self._logger_.error(msg, *args)

    def exception(self, msg="Exception", *args):
        self._logger_.exception(msg, *args)
