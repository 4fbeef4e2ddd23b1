"""The controls of ``correct`` at the cells' own sizes, on the card: the
reference put in the program's place one precision below the
configuration's (TF32 for float32, 4 bits for int8), or a training step
that leaves out half of each minibatch, fails at least one of the
cell's limits.  Run on the card:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import pytest
import torch

from conftest import ROOT
from portbench.bench import Bench
from portbench.control import MODES, control

CASES = [("vgg16.train.b64", "tf32"), ("vgg16.train.b64", "half_batch"),
         ("alexnet.train.b128", "tf32"), ("alexnet.train.b128", "half_batch"),
         ("vgg16.serve_f32.poisson", "tf32"),
         ("vgg16.serve_int8.poisson", "int4")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' "
                    "own sizes")
    return "cuda"


def test_every_cell_has_a_control():
    bench = Bench(ROOT)
    for w in bench.spec["workloads"]:
        kind = bench.traffic(w["traffic"])["kind"]
        assert any(name == w["name"] and mode in MODES[kind]
                   for name, mode in CASES), w["name"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,mode", CASES)
def test_the_control_fails_a_limit(card, workload, mode):
    out = control(Bench(ROOT), workload, 9000000001, mode, card)
    assert not out["correct"], out["checks"]
