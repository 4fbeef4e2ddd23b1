"""The port's command line (veles_tpu_torch/__main__.py, launcher.py,
cmdline.py, the package's ``run``) on the CPU, on the blobs workflow of
tests/test_cli.py (8 -> all2all_tanh 16 -> softmax 3) rebuilt on the
port.

- ``python -m veles_tpu_torch wf.py - -d cpu`` trains and writes the
  result file; ``--dump-graph``, ``--dry-run``, ``--dump-unit-attributes``,
  ``--event-file`` and ``key=value`` overrides work.
- Exact resume: a run of 5 epochs with ``--snapshot-dir`` snapshots at
  each improved epoch; ``-w`` on the epoch-1 snapshot runs on to the
  end, and the final weights and ``Best metric`` equal the
  uninterrupted run's bit for bit.  ``--resume auto`` does the same
  from the ``_current`` target.
- Without ``-d`` (and without ``VELES_BACKEND``) the launcher asks for
  the card: where there is none the run raises and trains nothing on
  the CPU.  ``-d auto`` and ``-d tpu`` are refused.
- ``--optimize GENS:POP``, ``--ensemble-train N`` then a farmed
  ``--ensemble-test`` run through ``-d cpu`` (tests/test_cli.py's
  counterparts); a farmed ``--optimize`` crowns the in-process run's
  best; without ``-d`` each meta mode asks for the card and raises
  ``no CUDA device`` before a socket opens.
- ``--frontend`` and ``-b`` raise NotImplementedError naming ROADMAP.md
  Queue 1 item 12.4.
- The JAX package's CLI flags of the ported slice are all there.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap

import numpy
import pytest
import torch

from tests.torch_imports import restored_imports
from veles_tpu_torch.config import root

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WF = textwrap.dedent('''
    import numpy
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.config import root


    class CliBlobs(FullBatchLoader):
        def load_data(self):
            self.class_lengths[:] = [0, 32, 96]
            self._calc_class_end_offsets()
            self.create_originals((8,))
            rng = numpy.random.RandomState(1)
            centers = rng.randn(3, 8) * 2
            for i in range(self.total_samples):
                label = i % 3
                self.original_data.mem[i] = (
                    centers[label] + rng.randn(8) * 0.2)
                self.original_labels[i] = label


    def build(launcher):
        return StandardWorkflow(
            launcher,
            layers=[
                {"type": "all2all_tanh", "output_sample_shape": 16,
                 "learning_rate": 0.05, "gradient_moment": 0.9},
                {"type": "softmax", "output_sample_shape": 3,
                 "learning_rate": 0.05, "gradient_moment": 0.9},
            ],
            loader_factory=lambda w: CliBlobs(
                w, minibatch_size=32,
                prng=RandomGenerator("cli", seed=4)),
            decision_config=dict(
                max_epochs=root.cli_test.get("max_epochs", 2)),
            result_file=root.common.get("result_file"),
        )


    def run(load, main):
        workflow, _ = load(build)
        main()
        out = root.cli_test.get("weights_out")
        if out:
            leaves = {}
            for i, fwd in enumerate(workflow.forwards):
                for name in ("weights", "bias"):
                    arr = getattr(fwd, name)
                    arr.map_read()
                    leaves["%s%d" % (name, i)] = arr.mem
            numpy.savez(out, **leaves)


    # --optimize hooks
    def tunable_spec():
        from veles_tpu_torch.genetics import Tune
        return {"x": Tune(0.0, -1.0, 1.0)}


    def fitness(spec):
        return -(spec["x"] - 0.5) ** 2


    # --ensemble-train / --ensemble-test hooks
    def member_factory(member, seed):
        from veles_tpu_torch.dummy import DummyWorkflow
        wf = DummyWorkflow()
        return build(wf.workflow)


    def ensemble_test_data():
        from veles_tpu_torch.dummy import DummyWorkflow
        wf = DummyWorkflow()
        loader = CliBlobs(wf, minibatch_size=32,
                          prng=RandomGenerator("etd", seed=9))
        loader.initialize(device=None)
        x = loader.original_data.mem[:32]
        labels = numpy.array(
            [loader.labels_mapping[loader.original_labels[i]]
             for i in range(32)])
        return x, labels
''')


@pytest.fixture(scope="module")
def wf_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "torch_cli_workflow.py"
    path.write_text(_WF)
    return str(path)


def _run_cli(*args, env_drop=(), timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for name in ("VELES_BACKEND",) + tuple(env_drop):
        env.pop(name, None)
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch"] + list(args),
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


@pytest.fixture
def in_process(monkeypatch):
    """``Main().run`` in this process, with the config tree and the
    process-wide PRNG put back afterwards."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    saved = copy.deepcopy(root)
    state = prng.get().__getstate__()
    monkeypatch.delenv("VELES_BACKEND", raising=False)

    def run(*argv):
        main = Main()
        with restored_imports():
            code = main.run(list(argv))
        return code, main

    yield run
    root.__dict__.clear()
    root.__dict__.update(saved.__dict__)
    prng.get().__setstate__(state)


def test_cli_trains_and_writes_results(wf_file, tmp_path):
    result_file = str(tmp_path / "results.json")
    proc = _run_cli(wf_file, "-", "-d", "cpu", "--result-file", result_file,
                    "root.cli_test.max_epochs=3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    results = json.loads(open(result_file).read())
    assert results["Total epochs"] == 3
    assert results["Best metric"] is not None
    assert set(results["Errors"]) == {"test", "validation", "train"}
    assert "Workflow run time" in proc.stdout


def test_cli_dump_graph(in_process, wf_file, tmp_path):
    dot = str(tmp_path / "graph.dot")
    code, _ = in_process(wf_file, "-", "-d", "cpu", "--dump-graph", dot)
    assert code == 0
    text = open(dot).read()
    assert "digraph" in text and "CliBlobs" in text


@pytest.mark.parametrize("stage", ["load", "init"])
def test_cli_dry_run(in_process, wf_file, stage):
    code, main = in_process(wf_file, "-", "-d", "cpu", "--dry-run", stage)
    assert code == 0
    workflow = getattr(main, "workflow", None)
    if stage == "load":
        assert workflow is None  # stops before the workflow is built
    else:
        assert workflow.is_initialized
        assert workflow.loader.run_calls == 0


def test_cli_overrides_and_config_file(in_process, wf_file, tmp_path):
    config = tmp_path / "config.py"
    config.write_text("root.cli_test.max_epochs = 1\n")
    code, main = in_process(wf_file, str(config), "-d", "cpu")
    assert code == 0 and main.workflow.loader.epoch_number == 1
    # an override wins over the config file
    code, main = in_process(wf_file, str(config), "-d", "cpu",
                            "root.cli_test.max_epochs=2")
    assert code == 0 and main.workflow.loader.epoch_number == 2


def test_cli_dump_unit_attributes_and_event_file(in_process, wf_file,
                                                 tmp_path, capsys):
    events = str(tmp_path / "events.jsonl")
    code, _ = in_process(wf_file, "-", "-d", "cpu", "--event-file", events,
                         "--dump-unit-attributes")
    assert code == 0
    out = capsys.readouterr().out
    assert "CliBlobs" in out and "class_lengths" in out
    runs = [line for line in out.splitlines() if " run_calls " in line]
    assert runs and all(line.rstrip().endswith(" 0") for line in runs)
    code, _ = in_process(wf_file, "-", "-d", "cpu", "--event-file", events,
                         "root.cli_test.max_epochs=1")
    from veles_tpu_torch.logger import set_event_file
    set_event_file(None)
    records = [json.loads(line) for line in open(events)]
    assert [(r["name"], r["kind"]) for r in records] == \
        [("run", "begin"), ("run", "end")]


def _snapshot_epochs(directory):
    found = {}
    for name in os.listdir(directory):
        if name.endswith(".manifest"):
            with open(os.path.join(directory, name)) as fin:
                found[json.load(fin)["epoch"]] = os.path.join(
                    directory, name[:-len(".manifest")])
    return found


def test_cli_exact_resume_from_an_epoch_snapshot(wf_file, tmp_path):
    snaps = str(tmp_path / "snaps")
    whole = _run_cli(wf_file, "-", "-d", "cpu", "--snapshot-dir", snaps,
                     "--snapshot-time-interval", "0",
                     "--result-file", str(tmp_path / "r1.json"),
                     "root.cli_test.max_epochs=5",
                     "root.cli_test.weights_out='%s'" % (tmp_path / "w1.npz"))
    assert whole.returncode == 0, whole.stderr[-2000:]
    epochs = _snapshot_epochs(snaps)
    assert 1 in epochs, sorted(epochs)
    resumed = _run_cli(wf_file, "-", "-d", "cpu", "-w", epochs[1],
                       "--result-file", str(tmp_path / "r2.json"),
                       "root.cli_test.weights_out='%s'" %
                       (tmp_path / "w2.npz"))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    r1 = json.loads((tmp_path / "r1.json").read_text())
    r2 = json.loads((tmp_path / "r2.json").read_text())
    assert r2["Total epochs"] == r1["Total epochs"] == 5
    assert r2["Best metric"] == r1["Best metric"]
    w1, w2 = numpy.load(tmp_path / "w1.npz"), numpy.load(tmp_path / "w2.npz")
    assert sorted(w1.files) == sorted(w2.files) == \
        ["bias0", "bias1", "weights0", "weights1"]
    for name in w1.files:
        assert w1[name].tobytes() == w2[name].tobytes(), name


def test_resume_auto_from_the_current_snapshot(in_process, wf_file,
                                               tmp_path):
    snaps = str(tmp_path / "snaps")
    code, first = in_process(wf_file, "-", "-d", "cpu", "--snapshot-dir",
                             snaps, "--snapshot-time-interval", "0",
                             "root.cli_test.max_epochs=3")
    assert code == 0
    want = []
    for fwd in first.workflow.forwards:
        fwd.weights.map_read()
        want.append(numpy.array(fwd.weights.mem))
    epochs = _snapshot_epochs(snaps)
    assert max(epochs) < 3, "the blobs stop improving after epoch 1"
    code, second = in_process(wf_file, "-", "-d", "cpu", "--snapshot-dir",
                              snaps, "--resume", "auto")
    assert code == 0
    workflow = second.workflow
    assert workflow.restored_from_snapshot_
    assert workflow.loader.epoch_number == 3
    for fwd, weights in zip(workflow.forwards, want):
        fwd.weights.map_read()
        assert fwd.weights.mem.tobytes() == weights.tobytes()


def test_cli_without_device_asks_for_the_card(wf_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("with a card, no -d means the card")
    result_file = tmp_path / "results.json"
    proc = _run_cli(wf_file, "-", "--result-file", str(result_file))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not result_file.exists(), "trained on the CPU"
    assert "Epoch" not in proc.stderr


@pytest.mark.parametrize("backend", ["auto", "tpu"])
def test_jax_backends_are_refused(in_process, wf_file, backend):
    with pytest.raises(ValueError) as err:
        in_process(wf_file, "-", "-d", backend)
    assert "cuda" in str(err.value) and "cpu" in str(err.value)


@pytest.mark.parametrize("argv", [["--frontend"], ["-b"]],
                         ids=["frontend", "background"])
def test_unported_modes_raise(in_process, wf_file, argv):
    with pytest.raises(NotImplementedError) as err:
        in_process(wf_file, "-", "-d", "cpu", *argv)
    assert "Queue 1 item 12.4" in str(err.value)


def test_cli_ensemble_train_then_farmed_test(wf_file, tmp_path):
    """tests/test_cli.py's two-phase ensemble flow on the port:
    ``--ensemble-train`` then ``--ensemble-test`` with the members
    evaluated by two farm workers."""
    ens_dir = str(tmp_path / "ens")
    proc = _run_cli(wf_file, "-", "-d", "cpu", "--ensemble-train", "2",
                    "--ensemble-dir", ens_dir, "root.cli_test.max_epochs=2")
    assert proc.returncode == 0, proc.stderr[-2000:]
    results = os.path.join(ens_dir, "ensemble.json")
    assert os.path.exists(results)
    assert "ensemble results -> %s" % results in proc.stdout
    result_file = str(tmp_path / "enstest.json")
    proc = _run_cli(wf_file, "-", "-d", "cpu", "--ensemble-test", results,
                    "--farm-slaves", "2", "--result-file", result_file)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loaded 2 ensemble members" in proc.stdout
    assert "ensemble error rate" in proc.stdout
    report = json.load(open(result_file))
    assert report["members"] == 2 and report["samples"] == 32
    assert 0.0 <= report["ensemble_error_pct"] <= 100.0


def test_cli_optimize(wf_file, tmp_path):
    result_file = str(tmp_path / "opt.json")
    proc = _run_cli(wf_file, "-", "-d", "cpu", "--optimize", "4:10",
                    "--result-file", result_file)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "best fitness" in proc.stdout
    best = json.load(open(result_file))
    assert abs(best["spec"]["x"] - 0.5) < 0.3
    assert best["fitness"] == -(best["spec"]["x"] - 0.5) ** 2


def test_cli_farmed_optimize_equals_in_process(in_process, wf_file,
                                               tmp_path):
    """``--optimize`` with two farm workers crowns the in-process run's
    best, from the same state of the GA's stream (``genetics``)."""
    from veles_tpu_torch import prng
    stream = prng.get("genetics").__getstate__()
    bests = []
    for farm in ([], ["--farm-slaves", "2"]):
        prng.get("genetics").__setstate__(stream)
        result_file = str(tmp_path / ("opt%d.json" % len(farm)))
        code, main = in_process(wf_file, "-", "-d", "cpu",
                                "--optimize", "3:6", "--result-file",
                                result_file, *farm)
        assert code == 0
        bests.append((json.load(open(result_file)),
                      main.optimizer.history))
    assert bests[0] == bests[1]


@pytest.mark.parametrize("argv", [["--optimize", "2:4"],
                                  ["--ensemble-train", "2"],
                                  ["--ensemble-test", "results.json"]],
                         ids=["optimize", "ensemble_train", "ensemble_test"])
def test_meta_modes_take_the_card_unless_asked(in_process, wf_file, argv,
                                               monkeypatch, tmp_path):
    """Without ``-d`` (and ``VELES_BACKEND``) each meta mode asks for
    the card and raises before it trains, binds or reads anything."""
    import veles_tpu_torch.server as server_module

    def no_socket(*args, **kwargs):
        raise AssertionError("a socket before the device check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(server_module, "Server", no_socket)
    root.common.engine.backend = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        in_process(wf_file, "-", "--farm-slaves", "2", "--ensemble-dir",
                   str(tmp_path / "ens"), *argv)
    assert not os.path.exists(str(tmp_path / "ens"))


def test_parser_has_the_slices_flags():
    import veles_tpu.cmdline as jax_cmdline
    from veles_tpu_torch.__main__ import Main
    parser = Main().init_parser()
    ours = {a.dest for a in parser._actions}
    jax_flags = {a.dest for a in jax_cmdline.build_parser()._actions}
    slice_flags = {"snapshot_dir", "snapshot_interval",
                   "snapshot_time_interval", "snapshot_compress",
                   "disable_snapshotting", "snapshot_db", "snapshot_keep",
                   "rollback_budget", "publish_dir", "publish_keep",
                   "resume"}
    assert slice_flags <= jax_flags
    assert slice_flags <= ours
    assert {"workflow", "config", "overrides", "random_seed", "device",
            "snapshot", "log_file", "event_file", "verbose",
            "result_file", "dry_run", "dump_graph",
            "dump_unit_attributes", "no_fuse", "sync_run", "optimize",
            "ensemble_train", "ensemble_test", "ensemble_dir",
            "farm_slaves", "farm_address", "frontend", "background",
            "web_status"} <= ours
    from veles_tpu.__main__ import Main as JaxMain
    meta = {"optimize", "ensemble_train", "ensemble_test", "ensemble_dir",
            "farm_slaves", "farm_address", "web_status"}
    defaults = {a.dest: a.default for a in parser._actions}
    jax_defaults = {a.dest: a.default
                    for a in JaxMain().init_parser()._actions}
    assert {k: defaults[k] for k in meta} == \
        {k: jax_defaults[k] for k in meta}


def test_package_run_and_callable_module(monkeypatch):
    import veles_tpu_torch
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from test_torch_snapshot import Blobs
    from veles_tpu_torch.prng import RandomGenerator

    def build(launcher, **kwargs):
        return StandardWorkflow(
            launcher, layers=[{"type": "softmax", "output_sample_shape": 4}],
            loader_factory=lambda w: Blobs(
                w, minibatch_size=64, prng=RandomGenerator("run", seed=2)),
            decision_config=dict(max_epochs=1), **kwargs)

    workflow = veles_tpu_torch.run(build, device="cpu")
    assert workflow.loader.epoch_number == 1
    workflow = veles_tpu_torch(build, device="cpu")
    assert bool(workflow.decision.complete)
    with pytest.raises(NotImplementedError):
        veles_tpu_torch.load_plugins()
