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
- ``--frontend``: the composer page lists the port's flags, ``/run``
  refuses a missing token and anything but ``-m veles_tpu_torch`` (``-m
  veles_tpu`` too), runs ``--help`` and a ``-d cpu`` training to exit 0,
  and ``python -m veles_tpu_torch --frontend 0`` serves until ^C; a
  composed run without ``-d`` ends with ``no CUDA device`` where there
  is no card.
- ``-b -d cpu`` detaches at once and its daemon writes a log and a
  result file equal to a foreground run's (one intra-op thread each);
  the double fork comes before anything touches CUDA; ``-b`` without
  ``-d`` on a host with no card logs ``no CUDA device``.
- Plugin discovery imports packages marked ``.veles_tpu_torch`` (their
  units register), never one marked only ``.veles_tpu``, warns on one
  that fails to import, and scans ``sys.path`` once a process.
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


def _run_cli(*args, env_drop=(), env_set=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT, **(env_set or {}))
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
    assert isinstance(veles_tpu_torch.load_plugins(), list)


# -- the web composer ----------------------------------------------------------


def _composer():
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.frontend import FrontendServer
    server = FrontendServer(Main().init_parser())
    server.start_background()
    return server


def _compose(base, argv, token):
    import urllib.request
    req = urllib.request.Request(
        base + "/run", data=json.dumps({"argv": argv,
                                        "token": token}).encode())
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _status_after_run(base, timeout=180):
    import time
    import urllib.request
    deadline = time.time() + timeout
    while True:
        status = json.loads(urllib.request.urlopen(
            base + "/status", timeout=30).read())
        if not status["running"] or time.time() > deadline:
            return status
        time.sleep(0.2)


def test_frontend_composer_serves_and_launches(wf_file, tmp_path):
    """tests/test_cli.py's composer case on the port's parser."""
    import urllib.request
    server = _composer()
    base = "http://127.0.0.1:%d" % server.port
    try:
        page = urllib.request.urlopen(base + "/").read().decode()
        for flag in ("--snapshot", "--sync-run", "--ensemble-train",
                     "--web-status", "--snapshot-dir", "--background"):
            assert flag in page, flag
        assert '"-m", "veles_tpu_torch"' in page
        token = page.split('TOKEN = "')[1].split('"')[0]
        assert "error" in _compose(base, ["-m", "veles_tpu_torch",
                                          "--help"], "x")
        assert "error" in _compose(base, ["-c", "print('pwned')"], token)
        assert "error" in _compose(base, ["-m", "veles_tpu", "--help"],
                                   token)
        assert "pid" in _compose(base, ["-m", "veles_tpu_torch", "--help"],
                                 token)
        assert _status_after_run(base)["returncode"] == 0
        result_file = str(tmp_path / "composed.json")
        started = _compose(base, ["-m", "veles_tpu_torch", wf_file, "-",
                                  "-d", "cpu", "--result-file",
                                  result_file], token)
        assert "pid" in started
        again = _compose(base, ["-m", "veles_tpu_torch", "--help"], token)
        assert "already active" in again.get("error", "") or \
            "pid" in again  # the run may have ended already
        status = _status_after_run(base)
        assert status["returncode"] == 0, status
        assert json.load(open(result_file))["Total epochs"] == 2
    finally:
        server.stop()


def test_frontend_composed_run_asks_for_the_card(wf_file, tmp_path,
                                                 capfd):
    """A composed run without ``-d`` takes the card: on a host with none
    it ends with ``no CUDA device`` and trains nothing."""
    import urllib.request
    if torch.cuda.is_available():
        pytest.skip("with a card, no -d means the card")
    server = _composer()
    base = "http://127.0.0.1:%d" % server.port
    old = os.environ.pop("VELES_BACKEND", None)
    try:
        page = urllib.request.urlopen(base + "/").read().decode()
        token = page.split('TOKEN = "')[1].split('"')[0]
        result_file = str(tmp_path / "composed.json")
        assert "pid" in _compose(base, ["-m", "veles_tpu_torch", wf_file,
                                        "-", "--result-file", result_file],
                                 token)
        status = _status_after_run(base)
    finally:
        if old is not None:
            os.environ["VELES_BACKEND"] = old
        server.stop()
    assert status["returncode"] != 0
    assert "no CUDA device" in capfd.readouterr().err
    assert not os.path.exists(result_file)


def test_frontend_command_line_serves_until_interrupted():
    import signal
    import urllib.request
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--frontend", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("composer on http://127.0.0.1:"), line
        url = line.split()[2]
        assert "--frontend" not in urllib.request.urlopen(
            url, timeout=30).read().decode().split("<form")[1]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


# -- the daemon mode -----------------------------------------------------------


def _wait_for(path, timeout=180):
    import time
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path) and os.path.getsize(path):
            time.sleep(0.5)  # the daemon finishes its write
            return True
        time.sleep(0.2)
    return False


def test_background_run_equals_foreground(wf_file, tmp_path):
    import time
    env = {"OMP_NUM_THREADS": "1"}
    fg = str(tmp_path / "fg.json")
    proc = _run_cli(wf_file, "-", "-d", "cpu", "--result-file", fg,
                    env_set=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    bg, log = str(tmp_path / "bg.json"), str(tmp_path / "bg.log")
    start = time.time()
    proc = _run_cli(wf_file, "-", "-d", "cpu", "-b", "--log-file", log,
                    "--result-file", bg, env_set=env)
    detached = time.time() - start
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _wait_for(bg), open(log).read()[-3000:] \
        if os.path.exists(log) else "no log"
    assert json.load(open(bg)) == json.load(open(fg))
    text = open(log).read()
    assert "Epoch 2 metrics" in text and "session finished" in text
    assert detached < 60


def test_background_forks_before_cuda(in_process, wf_file, monkeypatch):
    """The double fork comes first: nothing has initialized CUDA or asked
    for a device when ``os.fork`` is called."""
    seen = {"available": 0}
    real_available = torch.cuda.is_available

    def available():
        seen["available"] += 1
        return real_available()

    class Forked(Exception):
        pass

    def fork():
        seen["fork"] = (torch.cuda.is_initialized(), seen["available"])
        return 1  # the parent's side: it leaves at once

    def leave(code):
        raise Forked(code)

    monkeypatch.setattr(torch.cuda, "is_available", available)
    monkeypatch.setattr(os, "fork", fork)
    monkeypatch.setattr(os, "_exit", leave)
    with pytest.raises(Forked):
        in_process(wf_file, "-", "-b")
    assert seen["fork"] == (False, 0)


def test_background_without_a_card_logs_it(wf_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("with a card, no -d means the card")
    log, result = str(tmp_path / "bg.log"), str(tmp_path / "bg.json")
    proc = _run_cli(wf_file, "-", "-b", "--log-file", log,
                    "--result-file", result)
    assert proc.returncode == 0
    assert _wait_for(log)
    import time
    deadline = time.time() + 120
    while "no CUDA device" not in open(log).read() and \
            time.time() < deadline:
        time.sleep(0.2)
    assert "no CUDA device" in open(log).read()
    assert not os.path.exists(result)


# -- plugin discovery ----------------------------------------------------------


def test_plugin_discovery(tmp_path, caplog):
    """tests/test_cli.py's case with the port's marker."""
    import veles_tpu_torch
    from veles_tpu_torch.units import UnitRegistry
    for name, marker, body in (
            ("torch_demo_plugin", ".veles_tpu_torch", textwrap.dedent("""
                from veles_tpu_torch.units import Unit

                class TorchDemoPluginUnit(Unit):
                    def run(self):
                        pass
            """)),
            ("jax_only_plugin", ".veles_tpu", "raise ImportError('jax')\n"),
            ("broken_plugin", ".veles_tpu_torch", "1 / 0\n")):
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / marker).write_text("")
        (pkg / "__init__.py").write_text(body)
    (tmp_path / "not_a_plugin").mkdir()
    sys.path.insert(0, str(tmp_path))
    try:
        mods = veles_tpu_torch.load_plugins(paths=[str(tmp_path)])
        assert [m.__name__ for m in mods] == ["torch_demo_plugin"]
        assert any(cls.__name__ == "TorchDemoPluginUnit"
                   for cls in UnitRegistry.units)
        assert "jax_only_plugin" not in sys.modules
        assert "broken_plugin" in caplog.text
        saved = veles_tpu_torch.load_plugins._loaded
        veles_tpu_torch.load_plugins._loaded = None
        try:
            first = veles_tpu_torch.load_plugins()
            assert "torch_demo_plugin" in [m.__name__ for m in first]
            assert veles_tpu_torch.load_plugins() is first
        finally:
            veles_tpu_torch.load_plugins._loaded = saved
    finally:
        sys.path.remove(str(tmp_path))
        for name in ("torch_demo_plugin", "jax_only_plugin",
                     "broken_plugin"):
            sys.modules.pop(name, None)
