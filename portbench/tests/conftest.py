"""Fixtures of the harness's tests: a benchmark root of tiny cells
(a small conv net on the CPU), built in a temporary directory from the
real readers and the real code."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "name": "tiny", "source": "a small conv net for the harness's tests",
    "program": {}, "input_shape": [12, 12, 3], "classes": 10,
    "precision": "float32", "reduced": [],
    "solver": {"name": "momentum", "learning_rate": 0.01,
               "gradient_moment": 0.9, "weights_decay": 0.0},
    "layers": [
        {"type": "conv", "filters": 8, "kernel": 3, "stride": 1, "pad": 1,
         "act": "relu"},
        {"type": "maxpool", "kernel": 2, "stride": 2},
        {"type": "conv", "filters": 16, "kernel": 3, "stride": 1, "pad": 1,
         "act": "relu"},
        {"type": "maxpool", "kernel": 3, "stride": 2},
        {"type": "fc", "units": 32, "act": "relu"},
        {"type": "dropout", "ratio": 0.5},
        {"type": "fc", "units": 10, "act": "softmax"}]}

TRAFFIC = {
    "train.tiny": {"kind": "train", "batch": 4, "samples": 20,
                   "warmup_steps": 1},
    "serve_f32.tiny": {"kind": "serve", "precision": "float32",
                       "rate_per_s": 40, "arrivals": "poisson", "pool": 8,
                       "ladder": [1, 4], "max_delay_ms": 2, "max_queue": 64,
                       "calibration_images": 8,
                       "calibration_percentile": 99.9},
    "serve_int8.tiny": {"kind": "serve", "precision": "int8",
                        "rate_per_s": 40, "arrivals": "poisson", "pool": 8,
                        "ladder": [1, 4], "max_delay_ms": 2,
                        "max_queue": 64, "calibration_images": 8,
                        "calibration_percentile": 99.9},
}

LIMITS = {"tiny.train": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                         "change_gap": 1e-3},
          "tiny.serve_f32": {"logp_gap": 1e-3},
          "tiny.serve_int8": {"logp_gap": 1e-2}}


def make_root(path):
    """A checkout-like root: BENCHMARK.json of the tiny cells and
    portbench/{configs,traffic,limits} beside the real metrics."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fin:
        real = json.load(fin)
    bench = os.path.join(path, "portbench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub))
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"),
                    os.path.join(bench, "metrics"))
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as fout:
        json.dump(TINY, fout)
    for name, traffic in TRAFFIC.items():
        with open(os.path.join(bench, "traffic", name + ".json"),
                  "w") as fout:
            json.dump(traffic, fout)
    for name, limits in LIMITS.items():
        with open(os.path.join(bench, "limits", name + ".json"),
                  "w") as fout:
            json.dump({"limits": limits}, fout)
    workloads = [{"name": "tiny." + t.split(".")[0], "config": "tiny",
                  "traffic": t, "chips": 1, "why": "tiny"} for t in TRAFFIC]
    train = [w["name"] for w in workloads if w["traffic"].startswith("train")]
    serve = [w["name"] for w in workloads if w["traffic"].startswith("serve")]
    spec = dict(real, configs=[{"name": "tiny", "source": "tests",
                                "file": "portbench/configs/tiny.json",
                                "reduced": [], "why": "tests"}],
                workloads=workloads)
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = train if m["name"].startswith("train") \
                else serve
    for m in spec["per_layer"]:
        m["workloads"] = train if m["moves"].startswith("train") else serve
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fout:
        json.dump(spec, fout)
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
