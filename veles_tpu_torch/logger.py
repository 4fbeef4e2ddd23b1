"""Logging mixin, the console and file log setup, and structured event
records.

Counterpart of ``veles_tpu/logger.py``: a named standard-library logger
and its level methods on every object, :func:`setup_logging` /
:func:`set_file_logging` for the command line's console and ``-f``
file, and :meth:`Logger.event` records (name, kind=begin|end|single,
timestamp, session, attrs) written as JSON lines to the file
:func:`set_event_file` names (``--event-file``) and handed to every hook
:func:`add_event_hook` registered (the web-status reporter forwards them
to the dashboard's event log, ``veles_tpu_torch/web_status.py``).
"""

import datetime
import json
import logging
import os
import sys
import threading
import time
import uuid

__all__ = ["Logger", "setup_logging", "set_file_logging", "set_event_file",
           "add_event_hook", "remove_event_hook"]

_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[41m",  # red background
}
_RESET = "\033[0m"

#: session id grouping all events of this process
session_id = uuid.uuid4().hex

_event_lock = threading.Lock()
_event_file = None


class ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super(ColorFormatter, self).format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return "%s%s%s" % (color, msg, _RESET) if color else msg
        return msg


def setup_logging(level=logging.INFO):
    """Install the root console handler once."""
    logger = logging.getLogger()
    if getattr(setup_logging, "_done", False):
        logger.setLevel(level)
        return
    setup_logging._done = True
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(ColorFormatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
    logger.addHandler(handler)


def set_file_logging(path, level=logging.DEBUG):
    """Duplicate all log records into ``path`` (the ``-f`` flag)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    handler.setLevel(level)
    logging.getLogger().addHandler(handler)
    return handler


_event_hooks = []


def add_event_hook(fn):
    """Register an observer called with every event record.  Hooks must
    be fast or enqueue: they run on the thread that emits the event."""
    _event_hooks.append(fn)


def remove_event_hook(fn):
    try:
        _event_hooks.remove(fn)
    except ValueError:
        pass


def set_event_file(path):
    """Route :meth:`Logger.event` records to a JSON-lines file (None
    closes the sink)."""
    global _event_file
    with _event_lock:
        if _event_file is not None:
            _event_file.close()
        if path is None:
            _event_file = None
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            _event_file = open(path, "a")


class Logger(object):
    """Mixin giving every object a named logger and event records."""

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

    def event(self, name, kind, **attrs):
        """Write a structured record and hand it to the hooks; ``kind``
        is ``"begin"``, ``"end"`` or ``"single"``.  Costs two global
        loads when no event file and no hook is set."""
        if kind not in ("begin", "end", "single"):
            raise ValueError("kind must be begin|end|single, got %r" % kind)
        if _event_file is None and not _event_hooks:
            return
        record = {
            "session": session_id,
            "instance": type(self).__name__,
            "name": name,
            "kind": kind,
            "time": time.time(),
            "iso": datetime.datetime.now().isoformat(),
        }
        record.update(attrs)
        with _event_lock:
            if _event_file is not None:
                _event_file.write(json.dumps(record, default=repr) + "\n")
                _event_file.flush()
        for hook in list(_event_hooks):
            try:
                hook(record)
            except Exception:
                pass  # an observer never breaks the code it observes
