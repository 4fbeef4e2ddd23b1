"""The port imports neither JAX nor the JAX package: in a fresh
interpreter, importing veles_tpu_torch and every module of the ported
slice leaves no ``jax``/``jax.*`` or ``veles_tpu``/``veles_tpu.*``
entry in ``sys.modules`` (``veles_tpu_torch`` itself shares the
``veles_tpu`` prefix, so the check matches whole package names)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "veles_tpu_torch",
    "veles_tpu_torch.__main__",
    "veles_tpu_torch.backends",
    "veles_tpu_torch.chaos",
    "veles_tpu_torch.cmdline",
    "veles_tpu_torch.compiler",
    "veles_tpu_torch.config",
    "veles_tpu_torch.convert",
    "veles_tpu_torch.distributable",
    "veles_tpu_torch.dummy",
    "veles_tpu_torch.graphs",
    "veles_tpu_torch.health",
    "veles_tpu_torch.launcher",
    "veles_tpu_torch.loader",
    "veles_tpu_torch.loader.base",
    "veles_tpu_torch.loader.fullbatch",
    "veles_tpu_torch.logger",
    "veles_tpu_torch.memory",
    "veles_tpu_torch.models",
    "veles_tpu_torch.models.activation",
    "veles_tpu_torch.models.all2all",
    "veles_tpu_torch.models.conv",
    "veles_tpu_torch.models.decision",
    "veles_tpu_torch.models.deconv",
    "veles_tpu_torch.models.dropout",
    "veles_tpu_torch.models.evaluator",
    "veles_tpu_torch.models.fused",
    "veles_tpu_torch.models.gd",
    "veles_tpu_torch.models.gd_conv",
    "veles_tpu_torch.models.gd_pooling",
    "veles_tpu_torch.models.lr_adjust",
    "veles_tpu_torch.models.nn_units",
    "veles_tpu_torch.models.nn_workflow",
    "veles_tpu_torch.models.pooling",
    "veles_tpu_torch.models.transformer",
    "veles_tpu_torch.models.zoo",
    "veles_tpu_torch.mutable",
    "veles_tpu_torch.normalization",
    "veles_tpu_torch.ops",
    "veles_tpu_torch.ops.attention",
    "veles_tpu_torch.ops.benchmark",
    "veles_tpu_torch.ops.blas",
    "veles_tpu_torch.ops.common",
    "veles_tpu_torch.ops.conv_vjp",
    "veles_tpu_torch.ops.gather",
    "veles_tpu_torch.ops.join",
    "veles_tpu_torch.ops.matmul",
    "veles_tpu_torch.ops.matmul_int8",
    "veles_tpu_torch.ops.normalize",
    "veles_tpu_torch.ops.pool_bwd",
    "veles_tpu_torch.ops.random",
    "veles_tpu_torch.ops.reduce",
    "veles_tpu_torch.package",
    "veles_tpu_torch.plumbing",
    "veles_tpu_torch.prng",
    "veles_tpu_torch.quant",
    "veles_tpu_torch.quant.forward",
    "veles_tpu_torch.quant.ptq",
    "veles_tpu_torch.serve",
    "veles_tpu_torch.serve.batcher",
    "veles_tpu_torch.serve.engine",
    "veles_tpu_torch.service_units",
    "veles_tpu_torch.snapshotter",
    "veles_tpu_torch.threefry",
    "veles_tpu_torch.units",
    "veles_tpu_torch.workflow",
]

_PROBE = """
import importlib, json, sys
for name in %r:
    importlib.import_module(name)
print(json.dumps(sorted(sys.modules)))
"""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "veles_tpu")


def test_forbidden_prefix_rule():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("veles_tpu") and _forbidden("veles_tpu.ops.common")
    assert not _forbidden("veles_tpu_torch")
    assert not _forbidden("veles_tpu_torch.ops.common")


@pytest.mark.parametrize("modules", [MODULES, ["chip_smoke"]],
                         ids=["package", "chip_smoke"])
def test_port_imports_no_jax(modules):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE % (modules,)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(modules) <= set(loaded)
    bad = [name for name in loaded if _forbidden(name)]
    assert not bad, bad


def test_every_module_of_the_package_is_probed():
    found = []
    pkg = os.path.join(ROOT, "veles_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for fname in files:
            if fname.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fname), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                found.append(mod[:-len(".__init__")]
                             if mod.endswith(".__init__") else mod)
    assert sorted(found) == sorted(MODULES)
