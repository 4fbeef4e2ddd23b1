"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the program.  Top-level module names
are compared whole: the port's name begins with the JAX package's."""

import os
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
{body}
tops = {{name.split(".")[0] for name in list(sys.modules)}}
print(",".join(sorted(tops)))
"""


def loaded_tops(body, tmp_path=None):
    code = PROBE.format(root=ROOT, tests=os.path.join(ROOT, "portbench",
                                                      "tests"), body=body)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path or
                                                                ROOT),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(proc.stdout.strip().splitlines()[-1].split(","))


def test_a_harness_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    body = """
import time, conftest
from portbench.bench import Bench
from portbench.harness import run_cell
root = conftest.make_root({path!r})
bench = Bench(root)
for w in ("tiny.train", "tiny.serve_int8"):
    run_cell(bench, w, 6000000001, 0.3, 1, "cpu", time.perf_counter())
import portbench.control, portbench.run
""".format(path=str(tmp_path))
    tops = loaded_tops(body)
    assert "veles_tpu_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "veles_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    body = """
from portbench import (check, counts, inputs, model, reference,
                       threefry, trace)
"""
    tops = loaded_tops(body)
    assert "torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "veles_tpu",
                       "veles_tpu_torch"}


def test_the_reference_modules_import_no_program_by_text():
    for name in ("reference", "check", "counts", "inputs", "model",
                 "threefry", "trace"):
        with open(os.path.join(ROOT, "portbench", name + ".py")) as fin:
            text = fin.read()
        assert "veles_tpu" not in text.replace("veles_tpu_torch/", ""), name
        assert "import jax" not in text and "from jax" not in text
