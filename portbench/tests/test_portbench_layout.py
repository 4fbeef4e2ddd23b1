"""BENCHMARK.json against the contract's shape, and the layout that
later cells extend by adding files: a configuration, a traffic mix, a
metric and a limit added as new files are found by name."""

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import inputs
from portbench.bench import Bench
from portbench.model import Model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


def test_benchmark_json_keys_names_and_units(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_cell_has_its_files_and_metrics(bench):
    for w in bench.spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        model = bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert traffic["kind"] in ("train", "serve")
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in layer:
            assert callable(bench.reader(m["name"]))
        assert bench.limits(w["name"]), w["name"]
        assert model.zoo_specs()


@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_zoo_source_equals_the_table(name, bench):
    from portbench.train import program_specs
    model = bench.config(name)
    assert program_specs(model) is not None  # raises on a mismatch


def test_added_files_are_found_by_name(tiny_root):
    bench_dir = os.path.join(tiny_root, "portbench")
    with open(os.path.join(bench_dir, "configs", "tiny.json")) as fin:
        config = json.load(fin)
    config["name"] = "tiny_wide"
    config["layers"][0]["filters"] = 12
    with open(os.path.join(bench_dir, "configs", "tiny_wide.json"),
              "w") as fout:
        json.dump(config, fout)
    with open(os.path.join(bench_dir, "traffic", "train.wide.json"),
              "w") as fout:
        json.dump({"kind": "train", "batch": 2, "samples": 10}, fout)
    with open(os.path.join(bench_dir, "metrics", "steps_seen.train.py"),
              "w") as fout:
        fout.write("def read(ctx):\n    return float(ctx.steps)\n")
    with open(os.path.join(bench_dir, "limits", "tiny_wide.train.json"),
              "w") as fout:
        json.dump({"limits": {"loss_gap": 1e-4}}, fout)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fin:
        spec = json.load(fin)
    spec["configs"].append({"name": "tiny_wide", "source": "tests",
                            "file": "portbench/configs/tiny_wide.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny_wide.train",
                              "config": "tiny_wide",
                              "traffic": "train.wide", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("tiny_wide.train")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "train step",
                              "moves": "train_images_per_s"})
    with open(path, "w") as fout:
        json.dump(spec, fout)
    bench = Bench(tiny_root)
    model = bench.config(bench.workload("tiny_wide.train")["config"])
    assert model.layers[0].out_shape == (12, 12, 12)
    assert bench.traffic("train.wide")["batch"] == 2
    assert bench.limits("tiny_wide.train") == {"loss_gap": 1e-4}
    names = [m["name"] for m in bench.per_layer("tiny_wide.train")]
    assert "steps_seen.train" in names and "mfu.train" not in names
    assert "steps_seen.train" in [m["name"] for m in
                                  bench.per_layer("tiny.train")]

    class Ctx(object):
        steps = 7
    assert bench.reader("steps_seen.train")(Ctx()) == 7.0


def test_open_loop_schedule_is_the_seeds():
    a = inputs.schedule(4000000001, 50.0, 10.0, 1024)
    b = inputs.schedule(4000000001, 50.0, 10.0, 1024)
    c = inputs.schedule(4000000002, 50.0, 10.0, 1024)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert len(a[0]) == len(c[0]) == 500
    assert not (a[0] == c[0]).all()
    assert (a[0] >= 0).all() and (a[0] < 10.0).all()
    assert (a[0][1:] >= a[0][:-1]).all()


def test_labels_hold_every_class_and_inputs_repeat():
    model = Model(json.load(open(os.path.join(
        ROOT, "portbench", "configs", "alexnet.json"))))
    labels = inputs.make_labels(model, 11, "l", 2048, "cpu")
    assert sorted(set(labels.tolist())) == list(range(1000))
    assert (labels == inputs.make_labels(model, 11, "l", 2048, "cpu")).all()
    assert inputs.subseed(11, "a") != inputs.subseed(11, "b")
    assert inputs.subseed(2 ** 40, "a") < 2 ** 63


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "vgg16.train.b64", "--seed", "5000000001",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
