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
    "veles_tpu_torch.client",
    "veles_tpu_torch.cmdline",
    "veles_tpu_torch.compiler",
    "veles_tpu_torch.config",
    "veles_tpu_torch.convert",
    "veles_tpu_torch.datasets",
    "veles_tpu_torch.distributable",
    "veles_tpu_torch.downloader",
    "veles_tpu_torch.dummy",
    "veles_tpu_torch.elastic",
    "veles_tpu_torch.ensemble",
    "veles_tpu_torch.ensemble.workflows",
    "veles_tpu_torch.examples",
    "veles_tpu_torch.examples.autoencoder",
    "veles_tpu_torch.examples.cifar10",
    "veles_tpu_torch.examples.conv_autoencoder",
    "veles_tpu_torch.examples.digits",
    "veles_tpu_torch.examples.digits_conv",
    "veles_tpu_torch.examples.digits_turbo",
    "veles_tpu_torch.examples.kohonen",
    "veles_tpu_torch.examples.mnist",
    "veles_tpu_torch.examples.mnist_autoencoder",
    "veles_tpu_torch.examples.rbm",
    "veles_tpu_torch.examples.sequence",
    "veles_tpu_torch.examples.stl10",
    "veles_tpu_torch.examples.transformer",
    "veles_tpu_torch.forge",
    "veles_tpu_torch.forge.__main__",
    "veles_tpu_torch.forge.client",
    "veles_tpu_torch.forge.server",
    "veles_tpu_torch.frontend",
    "veles_tpu_torch.genetics",
    "veles_tpu_torch.genetics.config",
    "veles_tpu_torch.genetics.core",
    "veles_tpu_torch.genetics.optimizer",
    "veles_tpu_torch.graphics_client",
    "veles_tpu_torch.graphics_server",
    "veles_tpu_torch.graphs",
    "veles_tpu_torch.health",
    "veles_tpu_torch.http_util",
    "veles_tpu_torch.jobfarm",
    "veles_tpu_torch.launcher",
    "veles_tpu_torch.loader",
    "veles_tpu_torch.loader.audio",
    "veles_tpu_torch.loader.base",
    "veles_tpu_torch.loader.colorspace",
    "veles_tpu_torch.loader.feeds",
    "veles_tpu_torch.loader.fullbatch",
    "veles_tpu_torch.loader.hdf5",
    "veles_tpu_torch.loader.hdfs",
    "veles_tpu_torch.loader.image",
    "veles_tpu_torch.loader.pickles",
    "veles_tpu_torch.loader.saver",
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
    "veles_tpu_torch.models.kohonen",
    "veles_tpu_torch.models.lr_adjust",
    "veles_tpu_torch.models.nn_units",
    "veles_tpu_torch.models.nn_workflow",
    "veles_tpu_torch.models.pooling",
    "veles_tpu_torch.models.rbm",
    "veles_tpu_torch.models.rnn",
    "veles_tpu_torch.models.transformer",
    "veles_tpu_torch.models.zoo",
    "veles_tpu_torch.mutable",
    "veles_tpu_torch.native",
    "veles_tpu_torch.network_common",
    "veles_tpu_torch.normalization",
    "veles_tpu_torch.observe",
    "veles_tpu_torch.observe.__main__",
    "veles_tpu_torch.observe.alerts",
    "veles_tpu_torch.observe.baseline",
    "veles_tpu_torch.observe.cluster",
    "veles_tpu_torch.observe.flight",
    "veles_tpu_torch.observe.introspect",
    "veles_tpu_torch.observe.merge",
    "veles_tpu_torch.observe.metrics",
    "veles_tpu_torch.observe.profile",
    "veles_tpu_torch.observe.requests",
    "veles_tpu_torch.observe.summary",
    "veles_tpu_torch.observe.timeseries",
    "veles_tpu_torch.observe.trace",
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
    "veles_tpu_torch.parallel",
    "veles_tpu_torch.parallel.analysis",
    "veles_tpu_torch.parallel.api",
    "veles_tpu_torch.parallel.bucketed",
    "veles_tpu_torch.parallel.collectives",
    "veles_tpu_torch.parallel.mesh",
    "veles_tpu_torch.parallel.moe",
    "veles_tpu_torch.parallel.pipeline",
    "veles_tpu_torch.parallel.ring",
    "veles_tpu_torch.parallel.tensor",
    "veles_tpu_torch.pipeline_input",
    "veles_tpu_torch.plotter",
    "veles_tpu_torch.plotting_units",
    "veles_tpu_torch.plumbing",
    "veles_tpu_torch.prng",
    "veles_tpu_torch.publishing",
    "veles_tpu_torch.publishing.backends",
    "veles_tpu_torch.publishing.publisher",
    "veles_tpu_torch.quant",
    "veles_tpu_torch.quant.forward",
    "veles_tpu_torch.quant.ptq",
    "veles_tpu_torch.restful_api",
    "veles_tpu_torch.serve",
    "veles_tpu_torch.serve.__main__",
    "veles_tpu_torch.serve.batcher",
    "veles_tpu_torch.serve.engine",
    "veles_tpu_torch.serve.fleet",
    "veles_tpu_torch.serve.freshness",
    "veles_tpu_torch.serve.qos",
    "veles_tpu_torch.serve.router",
    "veles_tpu_torch.serve.service",
    "veles_tpu_torch.serve.transport",
    "veles_tpu_torch.server",
    "veles_tpu_torch.service_units",
    "veles_tpu_torch.snapshotter",
    "veles_tpu_torch.thread_pool",
    "veles_tpu_torch.threefry",
    "veles_tpu_torch.tune",
    "veles_tpu_torch.tune.__main__",
    "veles_tpu_torch.tune.autotune",
    "veles_tpu_torch.tune.cache",
    "veles_tpu_torch.tune.costmodel",
    "veles_tpu_torch.tune.measure",
    "veles_tpu_torch.tune.spec",
    "veles_tpu_torch.tune.walk",
    "veles_tpu_torch.units",
    "veles_tpu_torch.web_status",
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


#: the master-slave layer's, the job farm's, the services' and the host
#: pseudo-device's scripts (imported as modules of the ``scripts``
#: namespace package)
SCRIPTS = ["scripts.torch_elastic_soak", "scripts.torch_distributed_phase",
           "scripts.torch_farm_phase", "scripts.torch_farm_workflow",
           "scripts.torch_services_phase", "scripts.torch_numpy_phase"]


@pytest.mark.parametrize("modules", [MODULES, ["chip_smoke"], SCRIPTS],
                         ids=["package", "chip_smoke", "scripts"])
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
