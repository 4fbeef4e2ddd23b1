"""The kernel builder and the launch check shared by the wrappers.

The builder compiles every ``veles_tpu_torch/csrc/*.cu`` with ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C
interface, under ``veles_tpu_torch/build/``, and loads it with
``ctypes``.  The sources compile in parallel, one ``nvcc`` each, and
are then linked.  The library's file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
is loaded as built.  A failed build raises; nothing falls back.

Nothing here runs at import: the first wrapper that launches a kernel
on a CUDA tensor calls :func:`kernel_function`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["kernel_function", "check_launch", "load_kernels",
           "empty_kernel", "current_stream", "sm_count", "ceil_mult",
           "split_ranges", "build_info",
           "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS"]

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what the last :func:`load_kernels` did: library path, build seconds
#: (0 when it loaded an existing build) and nvcc's output
build_info = {}

_lock = threading.Lock()
_library = None


def _nvcc():
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (looked at CUDA_HOME, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "veles_tpu_torch cannot be built")


def _sources():
    names = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cu"))
    if not names:
        raise RuntimeError("no CUDA sources under %s" % CSRC_DIR)
    return [os.path.join(CSRC_DIR, n) for n in names]


def _digest():
    """Hash of the flags and of every file under csrc (sources and any
    header they include)."""
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        digest.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as fin:
            digest.update(fin.read())
    return digest.hexdigest()[:16]


def _build(sources, lib_path, tag):
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in sources:
        obj = os.path.join(BUILD_DIR, "%s_%s.o" % (
            os.path.splitext(os.path.basename(src))[0], tag))
        cmd = [nvcc] + list(NVCC_FLAGS) + ["-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append("== %s\n%s" % (os.path.basename(src),
                                  out.decode(errors="replace")))
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError("nvcc failed on %s:\n%s" %
                           (", ".join(failed), "\n".join(log)))
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    link = subprocess.run(
        [nvcc] + list(NVCC_FLAGS[:2]) + ["-shared", "-o", tmp] +
        [obj for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log.append("== link\n%s" % link.stdout.decode(errors="replace"))
    if link.returncode != 0:
        raise RuntimeError("linking the CUDA kernels failed:\n%s" %
                           "\n".join(log))
    os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        os.remove(obj)
    return "\n".join(log)


def load_kernels():
    """Build (when the sources changed) and load the kernel library;
    returns the ``ctypes.CDLL``.  Raises if nvcc is missing or fails."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        sources = _sources()
        tag = _digest()
        lib_path = os.path.join(BUILD_DIR, "libveles_kernels_%s.so" % tag)
        start = time.perf_counter()
        log = ""
        if not os.path.exists(lib_path):
            log = _build(sources, lib_path, tag)
        seconds = time.perf_counter() - start
        _library = ctypes.CDLL(lib_path)
        _library.veles_error_string.argtypes = [ctypes.c_int]
        _library.veles_error_string.restype = ctypes.c_char_p
        build_info.update(path=lib_path, seconds=seconds,
                          built=bool(log), log=log)
        return _library


def kernel_function(name, argtypes):
    """The library's C function ``name`` with its argument types set
    (pointers and the stream as ``c_void_p``, sizes as ``c_longlong``);
    it returns a ``cudaError_t`` as int."""
    fn = getattr(load_kernels(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(code, name):
    """Raise when a kernel's C entry point returned a CUDA error."""
    if code != 0:
        message = load_kernels().veles_error_string(code)
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            name, code, message.decode(errors="replace")))


def empty_kernel(device):
    """Launch the library's empty kernel (one warp that does nothing) on
    ``device``'s current stream: its device time is the launch floor,
    the least time any kernel takes on the card's clock."""
    fn = empty_kernel.fn
    if fn is None:
        fn = empty_kernel.fn = kernel_function(
            "veles_empty", [ctypes.c_int, ctypes.c_void_p])
    device = torch.device(device)
    check_launch(fn(device.index or 0, current_stream(device)),
                 "empty_kernel")


empty_kernel.fn = None


def current_stream(device):
    """The raw handle of ``device``'s current CUDA stream, which a
    kernel's C entry point launches on."""
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device):
    """Streaming multiprocessors of the card ``device`` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ceil_mult(value, mult):
    """Round ``value`` up to the next multiple of ``mult``."""
    rem = value % mult
    return value if rem == 0 else value + mult - rem


def split_ranges(units, splits):
    """Split s of ``splits`` takes units [s * units // splits, (s + 1) *
    units // splits): whole units, in order, each once, the splits
    differing by at most one unit (``gemm::split_range`` of
    ``csrc/gemm_sm90.cuh``)."""
    return [(units * s // splits, units * (s + 1) // splits)
            for s in range(splits)]
