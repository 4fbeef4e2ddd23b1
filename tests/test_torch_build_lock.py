"""The kernel build under several processes (``ops/common.py``): two
processes that build into one directory at once both finish, and one
library remains.  ``nvcc`` is a stub script that writes its ``-o`` file
after a pause, so without the build lock the two builds overlap and one
process's clean-up removes the other's objects before its link."""

import os
import stat
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = """#!/bin/sh
out=""
prev=""
for arg in "$@"; do
    if [ "$prev" = "-o" ]; then out="$arg"; fi
    prev="$arg"
done
sleep 0.3
for arg in "$@"; do
    case "$arg" in
        *.o) if [ "$arg" != "$out" ] && [ ! -f "$arg" ]; then
                 echo "missing object $arg" >&2; exit 1; fi ;;
    esac
done
echo built > "$out"
"""

BUILD = """
import sys
from veles_tpu_torch.ops import common
common.BUILD_DIR = sys.argv[1]
sources = common._sources()
tag = common._digest()
lib = common.os.path.join(common.BUILD_DIR, "libveles_kernels_%s.so" % tag)
print(repr(common._build(sources, lib, tag)[:20]))
"""


def test_two_processes_build_at_once(tmp_path):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    build = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    deadline = time.monotonic() + 120
    outputs = []
    for proc in procs:
        try:
            out, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise AssertionError("a build did not finish in 120 s")
        assert proc.returncode == 0, err
        outputs.append(out.strip())
    files = sorted(os.listdir(build))
    libs = [f for f in files if f.startswith("libveles_kernels_")]
    assert len(libs) == 1 and libs[0].endswith(".so"), files
    assert set(files) == {libs[0], "build.lock"}, files
    # one process built (nvcc's log), the other found the library
    assert sorted(o == "''" for o in outputs) == [False, True], outputs
