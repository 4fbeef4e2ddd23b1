"""Run ``chip_smoke.py``'s farm phase alone on the card.

    python3 scripts/torch_farm_phase.py [--out PATH]

Builds the kernels, holds kernels 1, 2, 12 and 13 at the farm's shapes
against their plain versions from a job farm's worker thread
(:func:`farm_kernel_checks`), then runs :func:`farm_phase` over the
workflow module ``scripts/torch_farm_workflow.py`` (digits_conv at its
full width):

(a) ``python -m veles_tpu_torch <module> - --ensemble-train 3:0.8
    --farm-slaves 2`` in a child process on the card, 50 epochs (a
    member sees 0.8 of the train set an epoch: the samples of the JAX
    package's 40-epoch digits_conv quality run): each member's best
    validation error at most 2.5 % (that run's limit), each pickle's
    weights equal to the state its
    run trained, and member 0 trained again alone in this process
    equal to the farmed member 0 bit for bit;
(b) ``--ensemble-test`` on (a)'s members, farmed in a child process and
    through ``EnsembleTester`` here, farmed and in process: equal
    probabilities, the ensemble's error no worse than its worst
    member's;
(c) a remote-only farm here and ``EnsembleTrainer.worker`` processes
    (this script's ``--worker``): the first is sent SIGKILL in the
    middle of a member's training, the member is requeued, a second
    worker finishes the batch, and the members equal a fault-free run's;
(d) ``--optimize 2:4 --farm-slaves 2`` in this process (the GA's
    fitness runs in the farm's threads, their launches counted): every
    chromosome evaluated, the best the population's maximum, one
    training a distinct genome, the best spec trained again alone
    giving the same fitness bit for bit;
(e) ``python -m veles_tpu_torch.tune --model convnet --farm-slaves 0
    --farm-address 127.0.0.1:PORT --max-specs 3`` with ``python -m
    veles_tpu_torch.tune --worker`` processes joining its farms: every
    candidate evaluated in a worker process, every persisted winner
    measured and held against its plain version at its schedule
    (``chip_smoke.check_schedules``);
(f) digits_conv through the command line with ``--web-status`` at a
    ``WebStatusServer`` here: periodic posts and the final one, the
    result file's epochs and metrics, the run's events, the pages.

Prints the phase's summary as one JSON line (``farm: {...}``) and, with
``--out``, writes it there.  Needs a CUDA card.  ``--device cpu
--epochs N`` runs the same legs on the CPU at N epochs (a rehearsal: no
kernel checks, no quality limit, no number of the card).
"""

import argparse
import copy
import glob
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
WORKFLOW = os.path.join(SCRIPTS, "torch_farm_workflow.py")
DIGITS_CONV = os.path.join(ROOT, "veles_tpu_torch", "examples",
                           "digits_conv.py")

#: the JAX package's digits_conv quality run and limit
#: (tests/test_quality.py): 40 epochs of the train set, best validation
#: error <= 2.5 %.  A member sees a RATIO share of the train set an
#: epoch, so it trains 40 / RATIO epochs: as many samples as that run.
MEMBERS, RATIO, FARM_SLAVES = 3, 0.8, 2
QUALITY_EPOCHS = 40
EPOCHS = int(round(QUALITY_EPOCHS / RATIO))
DIGITS_LIMIT = 2.5
FITNESS_EPOCHS = 10
KILL_EPOCHS = 40
KILL_AFTER_S = 0.5
WEB_EPOCHS = 10
WEB_INTERVAL_S = 0.25
TUNE_SPECS = 3
#: the tuner's GA (generations, population): long enough a spec that a
#: worker process started beside the master joins its farms
TUNE_GA = (6, 10)
#: the probabilities of a farmed and an in-process ensemble test
TEST_LIMIT = 1e-6
#: seconds the whole phase may take before it dumps its stacks and ends
PHASE_LIMIT_S = 600


def log(*args):
    print(*args, flush=True)


def workflow_module():
    """``scripts/torch_farm_workflow.py``, imported as the command line
    imports it (its bare name, ``scripts/`` on the path), so members
    pickled by a child process load here."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import torch_farm_workflow
    return torch_farm_workflow


def farm_counters():
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    from veles_tpu_torch.ops.gather import gather_minibatch
    from veles_tpu_torch.ops.matmul import matmul
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd
    return (gather_minibatch, matmul, conv_wgrad, max_pool_bwd)


def _counted(fn):
    """(fn(), {kernel: launches}) with the counters read from 0 around
    the call (process-wide: every farm thread adds into them)."""
    import torch
    counters = farm_counters()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for wrapper in counters:
        wrapper.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in counters}


def _env():
    # a child sent SIGABRT prints every thread's stack (faulthandler)
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONFAULTHANDLER="1")
    for name in ("VELES_BACKEND", "VELES_CHAOS"):  # the card unless -d cpu
        env.pop(name, None)
    return env


def _communicate(proc, timeout, what):
    """(stdout, stderr) of ``proc``; past ``timeout`` it is sent SIGABRT
    and the phase fails with its threads' stacks."""
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGABRT)
        _, err = proc.communicate(timeout=60)
        raise AssertionError("farm %s: no end after %d s; its threads:\n%s"
                             % (what, timeout, err[-8000:]))


def _run(argv, device, timeout, what):
    cpu = ["-d", "cpu"] if device.backend == "cpu" else []
    start = time.perf_counter()
    proc = subprocess.Popen(argv + cpu, env=_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    out, err = _communicate(proc, timeout, what)
    if proc.returncode != 0:
        raise AssertionError("farm %s: rc %d\n%s" % (
            what, proc.returncode, err[-3000:]))
    return subprocess.CompletedProcess(argv, 0, out, err), \
        time.perf_counter() - start


def _cli(args, device, timeout, what, workflow=WORKFLOW):
    return _run([sys.executable, "-m", "veles_tpu_torch", workflow, "-"] +
                list(args), device, timeout, what)


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _leaves(sw):
    """The layers' weights and biases of a workflow's unit Arrays."""
    out = []
    for fwd in sw.forwards:
        for arr in (fwd.weights, fwd.bias):
            if arr:
                arr.map_read()
                out.append(arr.mem.copy())
    return out


def _live_leaves(state):
    """The weights and biases of a trained state list, as numpy."""
    from veles_tpu_torch.convert import state_to_numpy
    return [entry[key] for entry in state_to_numpy(state)
            for key in ("weights", "bias") if entry.get(key) is not None]


def _equal(got, want):
    return len(got) == len(want) and all(
        a.shape == b.shape and a.tobytes() == b.tobytes()
        for a, b in zip(got, want))


def _load(path):
    with open(path, "rb") as fin:
        return pickle.load(fin)


def _member_errors(tester, x, labels):
    """Each member's error (%) on ``x`` with its pickled weights."""
    return [100.0 * float((tester._forward_outputs(sw, x).argmax(1) !=
                           labels).sum()) / len(labels)
            for sw in tester.members]


# -- the legs -----------------------------------------------------------------


def ensemble_train(device, directory, epochs, quality):
    """(a): the ensemble trained by the command line in a child process,
    then member 0 again alone here."""
    tw = workflow_module()
    ens_dir = os.path.join(directory, "ensemble")
    state_dir = os.path.join(directory, "live")
    os.makedirs(state_dir)
    proc, wall = _cli(
        ["--ensemble-train", "%d:%s" % (MEMBERS, RATIO), "--farm-slaves",
         str(FARM_SLAVES), "--ensemble-dir", ens_dir,
         "root.farm_workflow.epochs=%d" % epochs,
         "root.farm_workflow.state_dir=%s" % state_dir],
        device, 420, "(a) --ensemble-train")
    results_path = os.path.join(ens_dir, "ensemble.json")
    if "ensemble results -> %s" % results_path not in proc.stdout:
        raise AssertionError("farm (a): %s" % proc.stdout[-2000:])
    with open(results_path) as fin:
        models = json.load(fin)["models"]
    errors = [-m["EvaluationFitness"] for m in models]
    pickled_equal = []
    for m in models:
        live = dict(__import__("numpy").load(os.path.join(
            state_dir, "member_%03d.live.npz" % m["id"])))
        want = [live["%s%d" % (key, i)] for i in range(len(live))
                for key in ("weights", "bias") if "%s%d" % (key, i) in live]
        pickled_equal.append(_equal(_leaves(_load(m["snapshot"])), want))
    # member 0 again, alone, in this process
    from veles_tpu_torch.config import root
    root.farm_workflow.epochs = epochs
    t0 = time.perf_counter()
    lone = tw.member_factory(0, models[0]["seed"], RATIO)
    lone.initialize(device=device)
    lone.run()
    lone_s = time.perf_counter() - t0
    trainer = getattr(lone, "fused_trainer", None)
    lone_state = _live_leaves(trainer._state_) if trainer is not None \
        else _leaves(lone)
    lone_equal = _equal(_leaves(_load(models[0]["snapshot"])), lone_state)
    lone_metrics = [None if v is None else float(v)
                    for v in lone.decision.epoch_metrics]
    out = {"wall_s": wall, "member_best_errors": errors,
           "members": len(models), "pickles_hold_trained_state":
           pickled_equal, "member0_alone_bit_identical": lone_equal,
           "member0_alone_metrics_equal":
           lone_metrics == models[0]["metrics"], "member0_alone_s": lone_s,
           "results": results_path}
    if not all(pickled_equal) or not lone_equal or \
            not out["member0_alone_metrics_equal"] or \
            (quality and max(errors) > DIGITS_LIMIT):
        raise AssertionError("farm (a): %s" % json.dumps(out))
    return out


def ensemble_test(device, directory, results_path):
    """(b): the farmed test in a child process and here, farmed and in
    process."""
    from veles_tpu_torch.ensemble import EnsembleTester
    tw = workflow_module()
    report = os.path.join(directory, "enstest.json")
    proc, wall = _cli(["--ensemble-test", results_path, "--farm-slaves",
                       str(FARM_SLAVES), "--result-file", report],
                      device, 300, "(b) --ensemble-test")
    with open(report) as fin:
        cli = json.load(fin)
    x, labels = tw.ensemble_test_data()
    farmed_tester = EnsembleTester(results_path, device=device,
                                   farm_slaves=FARM_SLAVES)
    farmed, launches = _counted(lambda: farmed_tester.predict(x))
    tester = EnsembleTester(results_path, device=device)
    inproc = tester.predict(x)
    import numpy
    diff = float(numpy.abs(farmed - inproc).max())
    err = 100.0 * float((inproc.argmax(1) != labels).sum()) / len(labels)
    members = _member_errors(tester, x, labels)
    out = {"wall_s": wall, "ensemble_error_pct": err,
           "cli_ensemble_error_pct": cli["ensemble_error_pct"],
           "samples": cli["samples"], "member_errors_pct": members,
           "farmed_vs_in_process_max_abs": diff,
           "bit_equal": farmed.tobytes() == inproc.tobytes(),
           "farm": farmed_tester.farm_stats, "launches": launches}
    if diff > TEST_LIMIT or cli["ensemble_error_pct"] != err or \
            cli["members"] != MEMBERS or err > max(members):
        raise AssertionError("farm (b): %s" % json.dumps(out))
    return out, launches


def _worker(address, directory, state_dir, epochs, device):
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", address,
           "--directory", directory, "--state-dir", state_dir,
           "--epochs", str(epochs), "--device", device.backend]
    return subprocess.Popen(cmd, env=_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait_for(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError("farm: timed out waiting for %s" % what)


def killed_worker(device, directory, epochs):
    """(c): a remote-only farm; its first worker process is killed in
    the middle of a member, a second one finishes the batch."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ensemble import EnsembleTrainer
    tw = workflow_module()
    root.farm_workflow.epochs = epochs
    t0 = time.perf_counter()
    reference = EnsembleTrainer(
        tw.member_factory, size=2, directory=os.path.join(directory, "ref"),
        train_ratio=RATIO, device=device)
    reference.run()
    reference_s = time.perf_counter() - t0
    address = "127.0.0.1:%d" % free_port()
    farm_dir = os.path.join(directory, "farmed")
    state_dir = os.path.join(directory, "live")
    os.makedirs(state_dir)
    master = EnsembleTrainer(tw.member_factory, size=2, directory=farm_dir,
                             train_ratio=RATIO, device=device,
                             farm_address=address)
    failure = []

    def serve():
        try:
            master.run()
        except Exception as exc:  # reported below
            failure.append(exc)

    t0 = time.perf_counter()
    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    first = _worker(address, farm_dir, state_dir, epochs, device)
    try:
        _wait_for(lambda: glob.glob(os.path.join(
            state_dir, "member_*.started.%d" % first.pid)), 180,
            "the first worker's member")
        time.sleep(KILL_AFTER_S)
        if glob.glob(os.path.join(state_dir, "member_*.live.npz")):
            raise AssertionError("farm (c): the member ended before the "
                                 "kill; raise KILL_EPOCHS")
        first.send_signal(signal.SIGKILL)
    finally:
        first.wait(60)
    second = _worker(address, farm_dir, state_dir, epochs, device)
    try:
        thread.join(420)
        out2, err2 = _communicate(second, 120, "(c) the second worker")
    finally:
        if second.poll() is None:
            second.kill()
            second.wait(30)
    wall = time.perf_counter() - t0
    if failure or thread.is_alive() or second.returncode != 0:
        raise AssertionError("farm (c): master %r, second worker rc %s\n%s"
                             % (failure, second.returncode, err2[-2000:]))
    equal = [
        mine["metrics"] == ref["metrics"] and
        _equal(_leaves(_load(mine["snapshot"])),
               _leaves(_load(ref["snapshot"])))
        for mine, ref in zip(master.results, reference.results)]
    out = {"wall_s": wall, "fault_free_s": reference_s,
           "killed_pid_rc": first.returncode, "farm": master.farm_stats,
           "second_worker": out2.strip().splitlines()[-1:],
           "equal_to_fault_free": equal}
    if master.farm_stats["requeued"] < 1 or not all(equal) or \
            first.returncode != -signal.SIGKILL:
        raise AssertionError("farm (c): %s" % json.dumps(out))
    return out


def optimize(device, directory, fitness_epochs):
    """(d): ``--optimize 2:4 --farm-slaves 2`` in this process."""
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    tw = workflow_module()
    report = os.path.join(directory, "optimize.json")
    trainings = os.path.join(directory, "fitness.jsonl")
    argv = [WORKFLOW, "-", "--optimize", "2:4", "--farm-slaves",
            str(FARM_SLAVES), "--result-file", report,
            "root.farm_workflow.fitness_epochs=%d" % fitness_epochs,
            "root.farm_workflow.log=%s" % trainings]
    if device.backend == "cpu":
        argv += ["-d", "cpu"]
    saved = copy.deepcopy(root)
    main = Main()
    t0 = time.perf_counter()
    try:
        code, launches = _counted(lambda: main.run(argv))
        wall = time.perf_counter() - t0
        with open(report) as fin:
            best = json.load(fin)
        with open(trainings) as fin:
            runs = [json.loads(line) for line in fin]
        # the best spec again, alone, under the run's configuration
        root.farm_workflow.log = ""
        t0 = time.perf_counter()
        again = tw.fitness(best["spec"])
        alone_s = time.perf_counter() - t0
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved.__dict__)
    opt = main.optimizer
    fits = [c.fitness for c in opt.population.chromosomes]
    genomes = {tuple(sorted(r["spec"].items())) for r in runs}
    out = {"wall_s": wall, "trainings": len(runs),
           "distinct_genomes": len(genomes),
           "memoized_genomes": len(opt._fitness_memo),
           "speculated": opt.farm_stats["speculated"],
           "requeued": opt.farm_stats["requeued"],
           "handshake_ratings": opt.farm_stats["power_ratings"],
           "best_fitness": best["fitness"], "best_spec": best["spec"],
           "population_fitness": fits, "best_alone": again,
           "best_alone_s": alone_s,
           "threads": sorted({r["thread"] for r in runs}),
           "launches": launches}
    if code != 0 or None in fits or best["fitness"] != max(fits) or \
            len(runs) != len(genomes) or \
            len(genomes) != len(opt._fitness_memo) or \
            again != best["fitness"] or (
                device.backend == "cuda" and (
                    launches["conv_wgrad"] != launches["max_pool_bwd"] or
                    min(launches.values()) < 1)):
        raise AssertionError("farm (d): %s" % json.dumps(out))
    return out, launches


def _tune_specs(batch=64, seed=13):
    """The specs ``python -m veles_tpu_torch.tune --model convnet`` walks,
    walked here."""
    import torch
    from veles_tpu_torch.models.zoo import build_plans_and_state
    from veles_tpu_torch.tune.__main__ import _model
    from veles_tpu_torch.tune.walk import collect_specs
    layer_specs, input_shape = _model("convnet", 100)
    plans, state, _ = build_plans_and_state(layer_specs, input_shape,
                                            seed=seed)
    return collect_specs(plans, state, batch, input_shape, loss="softmax",
                         dtype="float32", precision_level=0, ops=None,
                         device=torch.device("cuda", 0), seed=seed)


class _Logged(object):
    """A child process whose output lines threads collect as they come:
    ``lines`` its stderr, ``out`` its stdout."""

    def __init__(self, cmd, env):
        self.proc = subprocess.Popen(cmd, env=env, cwd=ROOT,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.lines, self.out = [], []
        self._readers = [threading.Thread(target=self._read, args=pair,
                                          daemon=True)
                         for pair in ((self.proc.stderr, self.lines),
                                      (self.proc.stdout, self.out))]
        for reader in self._readers:
            reader.start()

    @staticmethod
    def _read(stream, lines):
        for line in stream:
            lines.append(line)

    def saw(self, text, lines=None):
        return any(text in line for line in (
            self.lines if lines is None else lines))

    def finish(self, timeout, what):
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.send_signal(signal.SIGABRT)
            self.proc.wait(60)
            for reader in self._readers:
                reader.join(10)
            raise AssertionError("farm %s: no end after %d s; its "
                                 "threads:\n%s" % (what, timeout, "".join(
                                     self.lines)[-8000:]))
        for reader in self._readers:
            reader.join(10)
        return "".join(self.out)


def tune(device, directory, smoke):
    """(e): the farmed tuner, remote-only, with ``--worker`` processes.
    Each spec's GA binds its own farm at the address, and a worker leaves
    when that farm shuts down: the first worker starts once the master
    has walked its specs, a worker that left is followed by another
    while the master tunes, and one still trying the address when the
    master ends is stopped.  (With ``--farm-slaves 1`` the master's
    local worker takes a spec's candidates on the card in under a second,
    before a worker process has rated itself: a worker process got none
    in three runs.)"""
    address = "127.0.0.1:%d" % free_port()
    env = _env()
    env["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    cpu = ["-d", "cpu"] if device.backend == "cpu" else []
    receipt_path = os.path.join(directory, "TUNE.json")
    worker_cmd = [sys.executable, "-m", "veles_tpu_torch.tune", "--worker",
                  address] + cpu
    t0 = time.perf_counter()
    master = _Logged(
        [sys.executable, "-m", "veles_tpu_torch.tune", "--model", "convnet",
         "--farm-slaves", "0", "--farm-address", address, "--max-specs",
         str(TUNE_SPECS), "--generations", str(TUNE_GA[0]),
         "--population", str(TUNE_GA[1]), "--out", receipt_path] + cpu,
        env)
    # the first farm binds right after the master's walk (its "walked"
    # line): a worker started before it could give up waiting
    _wait_for(lambda: master.saw("walked", master.out) or
              master.proc.poll() is not None, 300, "the tune master's walk")
    workers = [_Logged(worker_cmd, env)]
    evaluated, joined = [], []

    def record(worker):
        out = worker.finish(420, "(e) a tune worker")
        done = [int(line.split()[3]) for line in out.splitlines()
                if line.startswith("tune: worker evaluated")]
        evaluated.append(done[-1] if done else 0)
        # a worker ends cleanly only once a master stopped it; one that
        # found no farm says it gave up
        joined.append(worker.proc.returncode == 0 and not any(
            worker.saw(text) for text in ("giving up", "protocol failure")))

    try:
        deadline = time.monotonic() + 420
        while master.proc.poll() is None and time.monotonic() < deadline:
            if workers[-1].proc.poll() is not None:
                record(workers[-1])
                workers.append(_Logged(worker_cmd, env))
            time.sleep(0.1)
        master.finish(60, "(e) the tune master")
        # a worker in a session gets the master's stop at once; one
        # still trying the address has no farm left to join
        try:
            workers[-1].proc.wait(5)
        except subprocess.TimeoutExpired:
            workers[-1].proc.kill()
        record(workers[-1])
    finally:
        for proc in [w.proc for w in workers] + [master.proc]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    wall = time.perf_counter() - t0
    m_err = "".join(master.lines)
    master = master.proc
    if master.returncode != 0:
        raise AssertionError("farm (e): tune rc %d\n%s" % (
            master.returncode, m_err[-3000:]))
    with open(receipt_path) as fin:
        receipt = json.load(fin)
    from veles_tpu_torch.tune.autotune import PENALTY
    rows = receipt["specs"]
    checks = {}
    if device.backend == "cuda":
        import torch
        from veles_tpu_torch.tune import spec as tspec
        gen = torch.Generator(device="cuda").manual_seed(24)
        walked = {(s["op"], tuple(s["shape"])): s for s in _tune_specs()}
        limits = tspec.card_limits(torch.device("cuda", 0))
        for row in rows:
            if row.get("schedule") is None:
                continue
            spec = walked[(row["op"], tuple(row["shape"]))]
            rule = tspec.family_for(row["op"]).default(spec, limits)
            with smoke._uncounted():
                checks["%s %s" % (row["op"], tuple(row["shape"]))] = \
                    smoke.check_schedules(row["op"], spec, rule,
                                          {"winner": row["schedule"]}, gen)
            if row["op"] == "conv_vjp":
                checks["%s %s" % (row["op"], tuple(row["shape"]))][
                    "activation"] = spec["raw"]["activation"]
    out = {"wall_s": wall, "evals": receipt["evals"],
           "counts": receipt["counts"],
           "device_kind": receipt["device_kind"],
           "worker_runs": len(workers), "worker_joined": joined,
           "worker_evaluated": evaluated,
           "winners": [(r["op"], r["shape"], r.get("schedule"),
                        r.get("fitness"), r["source"]) for r in rows],
           "plain_max_rel": checks}
    measured = all(r["source"] in ("ga", "untunable") and
                   (r.get("schedule") is None or
                    PENALTY < r["fitness"] < 0) for r in rows)
    failed = [w for w, ok in zip(workers, joined) if not ok][:-1]
    out["worker_errors"] = ["".join(w.lines)[-1500:] for w in failed]
    # every candidate the master dispatched ran in a worker process
    if receipt["evals"] < 1 or not measured or \
            sum(evaluated) != receipt["evals"]:
        raise AssertionError("farm (e): %s" % json.dumps(out))
    return out


def web_status(device, directory, epochs):
    """(f): digits_conv through the command line, reporting to a
    ``WebStatusServer`` here."""
    from veles_tpu_torch.web_status import WebStatusServer
    server = WebStatusServer()
    server.start_background()
    try:
        base = "http://127.0.0.1:%d" % server.port
        result_file = os.path.join(directory, "digits_conv.json")
        _, wall = _cli(["--web-status", base, "--result-file", result_file,
                        "root.digits_conv.max_epochs=%d" % epochs,
                        "root.common.web.notification_interval=%s" %
                        WEB_INTERVAL_S], device, 300, "(f) --web-status",
                       workflow=DIGITS_CONV)
        sessions = server.store.list_sessions()
        if len(sessions) != 1:
            raise AssertionError("farm (f): sessions %s" % sessions)
        final = sessions[0]
        sid = final["id"]
        history = server.store.get_history(sid)
        events = [json.loads(text) for _, text in
                  server.store.get_events(sid)]
        pages = {}
        for path in ("/", "/session/%s" % urllib.request.quote(sid),
                     "/static/live.js", "/session/%s.json" % sid):
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                pages[path] = resp.status
    finally:
        server.stop()
    with open(result_file) as fin:
        result = json.load(fin)
    errors = result["Errors"]
    out = {"wall_s": wall, "posts": len(history), "epoch": final["epoch"],
           "metrics": final["metrics"], "result_epochs":
           result["Total epochs"], "result_errors": errors,
           "events": sorted({"%s %s" % (e["name"], e["kind"])
                             for e in events}),
           "pages": pages, "mode": final["mode"],
           "health": final["health"]}
    if len(history) < 3 or final["epoch"] != epochs or \
            result["Total epochs"] != epochs or \
            final["metrics"] != [errors["test"], errors["validation"],
                                 errors["train"]] or \
            "run end" not in out["events"] or \
            set(pages.values()) != {200}:
        raise AssertionError("farm (f): %s" % json.dumps(out))
    return out


def farm_phase(device, directory, smoke=None, epochs=EPOCHS,
               fitness_epochs=FITNESS_EPOCHS, kill_epochs=KILL_EPOCHS,
               web_epochs=WEB_EPOCHS):
    """The farm phase.  Returns ({kernel: launches}, summary): the
    launches of the legs whose farm threads run in this process ((b)'s
    farmed test and (d)'s GA), counted from 0 around each."""
    import faulthandler
    quality = device.backend == "cuda"
    seconds, summary = {}, {}
    launches = {}
    # a leg of this process that never ends prints every thread's stack
    # and ends the process instead of holding the card to its limit
    faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        leg_dir = os.path.join(directory, name)
        os.makedirs(leg_dir)
        result = fn(device, leg_dir, *args)
        seconds[name] = time.perf_counter() - t0
        if isinstance(result, tuple):
            result, counted = result
            for key, value in counted.items():
                launches[key] = launches.get(key, 0) + value
        summary[name] = result
        log("farm %s: %s" % (name, json.dumps(result)))
        return result

    try:
        trained = leg("train", ensemble_train, epochs, quality)
        leg("test", ensemble_test, trained["results"])
        leg("kill", killed_worker, kill_epochs)
        leg("optimize", optimize, fitness_epochs)
        leg("tune", tune, smoke)
        leg("web", web_status, web_epochs)
    finally:
        faulthandler.cancel_dump_traceback_later()
    summary["seconds"] = seconds
    summary["launches"] = launches
    return launches, summary


def farm_kernel_checks(smoke):
    """Kernels 1, 2, 12 and 13 at the farm's shapes, held against their
    plain versions from a job farm's worker thread (where the members and
    fitness runs launch them): the digits_conv minibatch gather (48 of
    1,797 8x8x1 f32), the handshake rating's 256^3 f32 product, the two
    convs' weight gradients and the two pools' backward (batch 48).
    Returns (gathers, matmuls, wgrads, pools) records."""
    import torch
    from veles_tpu_torch.jobfarm import JobFarm
    jobs = [("gather", "digits_conv minibatch from a farm thread, 48 of "
             "1,797", 1797, (8, 8, 1), 48),
            ("matmul", "handshake rating from a farm thread, 256^3", 256),
            ("wgrad", "digits_conv conv1 from a farm thread, batch 48",
             (48, 8, 8, 1), 16),
            ("wgrad", "digits_conv conv2 from a farm thread, batch 48",
             (48, 4, 4, 16), 32),
            ("pool", "digits_conv pool1 from a farm thread, batch 48",
             (48, 8, 8, 16)),
            ("pool", "digits_conv pool2 from a farm thread, batch 48",
             (48, 4, 4, 32))]

    def check(job):
        gen = torch.Generator(device="cuda").manual_seed(24)
        kind, what = job[0], job[1]
        if kind == "gather":
            return smoke.check_gather(what, job[2], job[3], job[4],
                                      torch.float32, gen)
        if kind == "matmul":
            return smoke.check_matmul(what, job[2], job[2], job[2], 0,
                                      torch.float32, torch.float32, gen)
        if kind == "wgrad":
            return smoke.check_wgrad(what, job[2], job[3], (3, 3),
                                     (1, 1, 1, 1), (1, 1), "relu_log", gen)
        return smoke.check_pool(what, job[2], (2, 2), (2, 2), gen)

    records = JobFarm("farm-kernel-checks").run(
        jobs, runner=check, local_slaves=1)
    by_kind = {}
    for job, rec in zip(jobs, records):
        by_kind.setdefault(job[0], []).append(rec)
    return (by_kind["gather"], by_kind["matmul"], by_kind["wgrad"],
            by_kind["pool"])


def worker_main(args):
    """``--worker``: one ``EnsembleTrainer.worker`` of leg (c)."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ensemble import EnsembleTrainer
    tw = workflow_module()
    root.farm_workflow.epochs = args.epochs
    root.farm_workflow.state_dir = args.state_dir
    trainer = EnsembleTrainer(tw.member_factory, size=2,
                              directory=args.directory, train_ratio=RATIO,
                              device=args.device)
    done = trainer.worker(args.worker)
    print("farm worker: trained %d member(s)" % done, flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None,
                        help="also write the summary to this file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--worker", default=None, metavar="HOST:PORT")
    parser.add_argument("--directory", default=None)
    parser.add_argument("--state-dir", default="")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    if args.worker:
        return worker_main(args)
    import chip_smoke
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    device = Device(args.device)
    directory = tempfile.mkdtemp(prefix="farm_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    summary = {}
    try:
        if args.device == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                text=True, check=True).stdout.strip()
            print("%s; python %s, torch %s, cuda %s" % (
                smi, sys.version.split()[0], torch.__version__,
                torch.version.cuda), flush=True)
            start = time.perf_counter()
            common.load_kernels()
            print("build %.1f s" % (time.perf_counter() - start), flush=True)
            start = time.perf_counter()
            gathers, matmuls, wgrads, pools = farm_kernel_checks(chip_smoke)
            summary.update(kernel_checks_s=time.perf_counter() - start,
                           gather_minibatch=gathers, matmul=matmuls,
                           conv_wgrad=wgrads, max_pool_bwd=pools, card=smi)
        # a rehearsal's member in leg (c) runs long enough to be killed
        small = {} if args.device == "cuda" else dict(
            epochs=args.epochs, fitness_epochs=args.epochs,
            kill_epochs=max(args.epochs, 10), web_epochs=args.epochs)
        start = time.perf_counter()
        _, phase = farm_phase(device, os.path.join(directory, "legs"),
                              chip_smoke, **small)
        summary.update(phase)
        summary["phase_s"] = time.perf_counter() - start
    finally:
        import shutil
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            fout.write(text)
    print("farm: " + text, flush=True)


if __name__ == "__main__":
    main()
