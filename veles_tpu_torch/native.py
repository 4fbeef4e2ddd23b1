"""ctypes bridge and on-demand build of the native inference runtime.

Counterpart of ``veles_tpu/native.py``: a package exported by
``Workflow.package_export`` (:mod:`veles_tpu_torch.package`) is loaded
and run on the host by the C++ runtime in ``native/src/`` (the greedy
strip-packing arena planner and the batch-sharding thread-pool engine),
the counterpart of the reference's libVeles.  The runtime is host code;
no device is touched.

The JAX package builds the library with cmake; the port compiles the
same sources with the flags of ``native/CMakeLists.txt`` (``g++ -O2
-std=c++17 -fPIC -pthread``, one ``g++`` a source, all started
together, then one link) and needs no cmake.  The library lands at
first use in ``veles_tpu_torch/build/native_<digest>/``, the digest
being :func:`source_digest` (the sources' names and contents and the
flags), under an exclusive ``fcntl.flock`` from the check to the link,
as the kernel build takes one (``ops/common.py``), so processes that
start together build once.  A failed build raises ``RuntimeError`` with
the compiler's output.
"""

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy

__all__ = ["NativeWorkflow", "build_native", "native_available",
           "source_digest"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_ROOT, "native", "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
#: the sources of native/CMakeLists.txt's library, in its order
SOURCES = ("tar.cc", "json.cc", "npy.cc", "units.cc", "memory_optimizer.cc",
           "engine.cc", "workflow.cc", "capi.cc")
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")
LIB_NAME = "libveles_tpu_native.so"

_digest = None
_build_lock = threading.Lock()
_lib = None


def source_digest():
    """The build's cache key: a hash of every source and header under
    ``native/src`` (names and contents) and of the compile flags,
    computed once, at first use."""
    global _digest
    if _digest is None:
        import hashlib
        digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
        for filename in sorted(os.listdir(NATIVE_SRC)):
            if filename.endswith((".cc", ".h")):
                digest.update(filename.encode())
                with open(os.path.join(NATIVE_SRC, filename), "rb") as fin:
                    digest.update(fin.read())
        _digest = digest.hexdigest()[:16]
    return _digest


def _lib_path():
    build_dir = os.path.join(BUILD_DIR, "native_%s" % source_digest())
    return build_dir, os.path.join(build_dir, LIB_NAME)


def _compile(build_dir):
    """One g++ a source, all at once, then the link; raises on the
    first failure with its output."""
    procs = []
    for source in SOURCES:
        obj = os.path.join(build_dir, source[:-3] + ".o")
        cmd = [CXX] + list(CXXFLAGS) + [
            "-c", os.path.join(NATIVE_SRC, source), "-o", obj]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append("%s\n%s" % (" ".join(cmd),
                                        out.decode(errors="replace")))
    if failures:
        raise RuntimeError("native build failed:\n" + "\n".join(failures))
    tmp = os.path.join(build_dir, LIB_NAME + ".%d.tmp" % os.getpid())
    cmd = [CXX] + list(CXXFLAGS) + ["-shared", "-o", tmp] + \
        [obj for _, obj, _ in procs]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError("native link failed: %s\n%s" % (
            " ".join(cmd), proc.stdout.decode(errors="replace")))
    os.replace(tmp, os.path.join(build_dir, LIB_NAME))


def build_native(force=False):
    """Build (or rebuild) the shared library; returns its path."""
    with _build_lock:
        build_dir, lib_path = _lib_path()
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if force or not os.path.exists(lib_path):
                    _compile(build_dir)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        return lib_path


def native_available():
    try:
        _load_lib()
        return True
    except Exception:
        return False


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    lib = ctypes.CDLL(path)
    lib.veles_workflow_load.restype = ctypes.c_void_p
    lib.veles_workflow_load.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.veles_workflow_destroy.argtypes = [ctypes.c_void_p]
    lib.veles_workflow_input_size.restype = ctypes.c_longlong
    lib.veles_workflow_input_size.argtypes = [ctypes.c_void_p]
    lib.veles_workflow_output_size.restype = ctypes.c_longlong
    lib.veles_workflow_output_size.argtypes = [ctypes.c_void_p]
    lib.veles_workflow_unit_count.restype = ctypes.c_longlong
    lib.veles_workflow_unit_count.argtypes = [ctypes.c_void_p]
    lib.veles_workflow_arena_size.restype = ctypes.c_longlong
    lib.veles_workflow_arena_size.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
    lib.veles_workflow_run.restype = ctypes.c_int
    lib.veles_workflow_run.argtypes = [
        ctypes.c_void_p,
        numpy.ctypeslib.ndpointer(numpy.float32, flags="C_CONTIGUOUS"),
        numpy.ctypeslib.ndpointer(numpy.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


class NativeWorkflow(object):
    """Loads a package and runs batched inference natively."""

    def __init__(self, package_path):
        self._lib = _load_lib()
        err = ctypes.create_string_buffer(1024)
        self._handle = self._lib.veles_workflow_load(
            package_path.encode(), err, len(err))
        if not self._handle:
            raise RuntimeError(
                "native load failed: %s" % err.value.decode())

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.veles_workflow_destroy(handle)
            self._handle = None

    @property
    def input_size(self):
        return int(self._lib.veles_workflow_input_size(self._handle))

    @property
    def output_size(self):
        return int(self._lib.veles_workflow_output_size(self._handle))

    @property
    def unit_count(self):
        return int(self._lib.veles_workflow_unit_count(self._handle))

    def arena_size(self, batch):
        size = int(self._lib.veles_workflow_arena_size(
            self._handle, batch))
        if size < 0:
            raise RuntimeError("arena planning failed")
        return size

    def run(self, batch_data):
        """batch_data: (B, *input_shape) float array -> (B, output_size)."""
        x = numpy.ascontiguousarray(batch_data, numpy.float32)
        batch = x.shape[0]
        if x.size != batch * self.input_size:
            raise ValueError(
                "expected %d floats/sample, got %d" %
                (self.input_size, x.size // max(batch, 1)))
        out = numpy.zeros((batch, self.output_size), numpy.float32)
        err = ctypes.create_string_buffer(1024)
        rc = self._lib.veles_workflow_run(
            self._handle, x.reshape(-1), out.reshape(-1), batch, err,
            len(err))
        if rc != 0:
            raise RuntimeError("native run failed: %s" %
                               err.value.decode())
        return out
