"""Thread pool for units' host work, and the SIGINT escalation.

Counterpart of ``veles_tpu/thread_pool.py``, on ``concurrent.futures``:
worker callbacks (``callInThread``), failure routing (``errback``, the
first failure kept in :attr:`ThreadPool.failure`), ``wait_idle``, pause /
resume, idempotent shutdown with registered callbacks, ``reset`` and the
``threadsafe`` decorator.  SIGINT escalation: the first ^C calls
:attr:`ThreadPool.sigint_hook` (the launcher sets it to its graceful
stop for the length of a run), the second shuts every pool down and
raises ``KeyboardInterrupt``.  The handler is installed by the first
pool made on the main thread, or by :meth:`ThreadPool.install_sigint`
(the launcher calls it at the start of a run).  Nothing here touches a
device.
"""

import functools
import signal
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

from veles_tpu_torch.logger import Logger

__all__ = ["ThreadPool"]


class ThreadPool(Logger):
    pools = []
    _sigint_installed = False
    _sigint_lock = threading.Lock()
    sigint_hook = None  # set by Workflow/Launcher for graceful stop

    def __init__(self, minthreads=2, maxthreads=32, name="pool", **kwargs):
        super(ThreadPool, self).__init__(**kwargs)
        self.name = name
        self._executor = ThreadPoolExecutor(
            max_workers=maxthreads, thread_name_prefix=name)
        self._paused = threading.Event()
        self._paused.set()  # set == running
        self.failure = None
        self._failure_lock = threading.Lock()
        self._shutdown_callbacks = []
        self._shutting_down = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        ThreadPool.pools.append(self)
        self.install_sigint()

    @classmethod
    def install_sigint(cls):
        """Install the escalating SIGINT handler once a process (a
        no-op off the main thread)."""
        with cls._sigint_lock:
            if cls._sigint_installed:
                return
            if threading.current_thread() is not threading.main_thread():
                return
            try:
                prev = signal.getsignal(signal.SIGINT)

                def handler(signum, frame):
                    if cls.sigint_hook is not None:
                        hook, cls.sigint_hook = cls.sigint_hook, None
                        sys.stderr.write(
                            "\n^C: requesting graceful stop "
                            "(press again to force)\n")
                        hook()
                        return
                    for pool in list(cls.pools):
                        pool.shutdown(False)
                    if callable(prev):
                        prev(signum, frame)
                    else:
                        raise KeyboardInterrupt()

                signal.signal(signal.SIGINT, handler)
                cls._sigint_installed = True
            except ValueError:  # not the main thread
                pass

    # -- task submission ---------------------------------------------------

    def callInThread(self, fn, *args, **kwargs):
        """Submit ``fn``; exceptions route to :meth:`errback`."""
        if self._shutting_down:
            return None
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()
        future = self._executor.submit(
            self._run_task, fn, args, kwargs)
        return future

    def _run_task(self, fn, args, kwargs):
        self._paused.wait()
        try:
            return fn(*args, **kwargs)
        except BaseException:  # noqa: B036 - all failures route to errback
            self.errback(sys.exc_info())
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.set()

    def errback(self, exc_info):
        """Record the first failure; workflows poll :attr:`failure`."""
        with self._failure_lock:
            if self.failure is None:
                self.failure = exc_info
        self.error("worker failure: %s", exc_info[1])

    def wait_idle(self, timeout=None):
        return self._idle.wait(timeout)

    # -- pause / resume ----------------------------------------------------

    def pause(self):
        self._paused.clear()

    def resume(self):
        self._paused.set()

    @property
    def paused(self):
        return not self._paused.is_set()

    # -- shutdown ----------------------------------------------------------

    def register_on_shutdown(self, callback):
        self._shutdown_callbacks.append(callback)

    def shutdown(self, wait=True):
        if self._shutting_down:
            return
        self._shutting_down = True
        self._paused.set()
        for callback in self._shutdown_callbacks:
            try:
                callback()
            except Exception:
                self.exception("shutdown callback failed")
        self._executor.shutdown(wait=wait, cancel_futures=not wait)
        if self in ThreadPool.pools:
            ThreadPool.pools.remove(self)

    @staticmethod
    def reset():
        for pool in list(ThreadPool.pools):
            pool.shutdown(False)


def threadsafe(fn):
    """Decorator serialising calls on a per-object lock ``_ts_lock_``."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        lock = getattr(self, "_ts_lock_", None)
        if lock is None:
            lock = threading.RLock()
            self._ts_lock_ = lock
        with lock:
            return fn(self, *args, **kwargs)
    return wrapped
