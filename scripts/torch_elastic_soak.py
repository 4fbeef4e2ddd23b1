"""Preemption soak of the port's master-slave layer: SIGKILL real slave
processes on a seeded schedule and prove the elasticity contract with
a receipt.

    python3 scripts/torch_elastic_soak.py --out chiprun_out/soak.json \
        [--preempts 2] [--max-epochs 3] [--seed 42] [-d cpu]

The workflow is ``veles_tpu_torch/examples/digits_conv.py`` (the conv
and pooling stack on the vendored digits), its epochs cut to
``--max-epochs``.  The master runs in this process through ``python -m
veles_tpu_torch``'s ``Main`` with ``-l 127.0.0.1:PORT``, ``-r`` and
``--trace``; each slave is a subprocess ``python -m veles_tpu_torch
<digits_conv.py> - -m 127.0.0.1:PORT`` (with ``-d`` only when ``-d`` is
given here: the card by default), armed through ``VELES_CHAOS`` with
``slave.preempt=kill:aK:x1`` (SIGKILL itself before its (K+1)-th job)
and ``--trace`` (so its spans ship to the master).
The script waits out a seeded ``slave.rejoin_after`` delay and spawns
the next slave until ``--preempts`` SIGKILLs landed; a clean slave then
finishes the run.  The receipt (the keys of the JAX package's
``scripts/elastic_soak.py``):

- ``bit_identical``: the soaked master's final weights and
  ``epoch_metrics`` equal a fault-free run's (one clean subprocess
  slave) bit for bit;
- ``throughput``: the soak's wall time less the fault-free run's stays
  under the injected rejoin delays plus a respawn allowance a preempt;
- ``kill_during_reshard``: in this process, a slave dies on its third
  job and the reshard push at its rejoin severs the connection
  (``server.reshard=kill``); as many updates apply as without faults
  and the weights are bit-identical: nothing applied twice or lost;
- ``merged_trace``: the soaked master's ``<trace>.merged.json`` holds
  the slaves' ``slave.job`` spans on tracks of their own.

The module is also what the chip smoke's ``distributed:`` phase
imports (:func:`make_workflow`, :func:`run_pair`, :func:`first_job`,
:func:`job_update`).  ``--job-update JOB OUT`` runs one job of a pickled
payload on a fresh slave and writes the packed update, so that two
processes can be held to the same bits.
"""

import argparse
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy  # noqa: E402

WORKFLOW = os.path.join(REPO, "veles_tpu_torch", "examples",
                        "digits_conv.py")
#: the layer-init seed of every master (``-r`` of the command line)
INIT_SEED = 1234
#: per-preempt respawn allowance of the throughput bound: a process
#: start, the torch import, reaching the card, loading the built
#: kernels, the workflow's build and the reconnect backoff
RESPAWN_ALLOWANCE_S = 30.0


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def make_workflow(mode, device, max_epochs):
    """digits_conv's workflow in ``mode`` under a stand-in launcher,
    initialized on ``device``, the layer init seeded ``INIT_SEED``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.examples import digits_conv
    root.digits_conv.update({"max_epochs": max_epochs})
    launcher = DummyLauncher()
    launcher.workflow_mode = mode
    sw = digits_conv.build(launcher)
    prng.get().seed(INIT_SEED)
    sw.initialize(device=device)
    return sw


def master_state(sw):
    """The master's final weights and accumulators (host copies)."""
    out = []
    for unit in list(sw.forwards) + [gd for gd in sw.gds if gd]:
        for name in ("weights", "bias", "accum_weights", "accum_bias"):
            arr = getattr(unit, name, None)
            if arr is not None and arr:
                arr.map_read()
                out.append(numpy.array(arr.mem))
    return out


def metrics(sw):
    return [None if m is None else float(m)
            for m in sw.decision.epoch_metrics]


def run_pair(device, max_epochs, plan=None, **server_kwargs):
    """An in-process master and one slave of digits_conv on ``device``,
    with ``plan`` installed in the port's chaos while the slave runs.
    Returns (master workflow, server, client, wall seconds)."""
    from veles_tpu_torch import chaos
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.server import Server
    master = make_workflow("master", device, max_epochs)
    slave = make_workflow("slave", device, max_epochs)
    server = Server("127.0.0.1:0", master, **server_kwargs)
    master.workflow.on_workflow_finished = server.on_workflow_finished
    server.start_background()
    if not server.wait_listening(10):
        raise RuntimeError("master did not bind: %s" % server.bind_error)
    client = Client("127.0.0.1:%d" % server.port, slave)
    t0 = time.perf_counter()
    if plan is not None:
        chaos.install(plan)
    try:
        client.run()
    finally:
        if plan is not None:
            chaos.uninstall()
    if not server._done.wait(120):
        raise RuntimeError("the master never finished")
    wall = time.perf_counter() - t0
    if not bool(master.decision.complete):
        raise RuntimeError("the master's workflow did not complete")
    return master, server, client, wall


def first_job(device, max_epochs, job_class=2):
    """The payload of a fresh master's first job of ``job_class`` (2:
    train), the jobs before it served and retired."""
    from veles_tpu_torch.server import SlaveDescription
    master = make_workflow("master", device, max_epochs)
    slave = SlaveDescription("probe", "probe", 0, 1.0)
    while True:
        job = master.generate_data_for_slave(slave)
        if master.loader.minibatch_class == job_class:
            return job
        master.loader.apply_data_from_slave(None, slave)


def job_update(device, max_epochs, job):
    """A fresh slave's packed update for ``job``."""
    from veles_tpu_torch.network_common import pack_payload
    slave = make_workflow("slave", device, max_epochs)
    out = {}
    slave.do_job(job, None, lambda update: out.update(update=update))
    return pack_payload(out["update"])


class MasterThread(object):
    """The master through ``Main`` (``-l``, ``-r``, ``--trace``) on a
    thread of this process."""

    def __init__(self, port, max_epochs, trace, device_args):
        from veles_tpu_torch.__main__ import Main
        self.main = Main()
        self.argv = [WORKFLOW, "-", "-l", "127.0.0.1:%d" % port,
                     "-r", str(INIT_SEED), "--trace", trace,
                     "root.digits_conv.max_epochs=%d" % max_epochs
                     ] + device_args
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="soak-master")

    def _run(self):
        from veles_tpu_torch.observe.trace import tracer
        # an in-process Client of an earlier run named this process's
        # tracer after itself; the master's track is named by its mode
        tracer.label = None
        try:
            self.main.run(self.argv)
        except BaseException as exc:  # reported by join()
            self.error = exc

    def start(self):
        self.thread.start()
        return self

    def done(self):
        return not self.thread.is_alive()

    def join(self, timeout):
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("the master did not finish in %.0f s"
                               % timeout)
        if self.error is not None:
            raise self.error
        return self.main.workflow


def spawn_slave(port, max_epochs, chaos_spec, device_args, log_path):
    """A slave process; its ``--trace`` turns its tracer on, so its
    spans ship to the master in chunks with its updates."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("VELES_CHAOS", None)
    if chaos_spec:
        env["VELES_CHAOS"] = chaos_spec
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", WORKFLOW, "-",
             "-m", "127.0.0.1:%d" % port, "--trace",
             os.path.splitext(log_path)[0] + ".trace.json",
             "root.digits_conv.max_epochs=%d" % max_epochs] + device_args,
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)


def _stop(child):
    if child is not None and child.poll() is None:
        child.terminate()
        try:
            child.wait(15)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()


def _wait_listening(port, master, timeout=180.0):
    """Until the master accepts connections (its workflow is built and
    initialized first)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if master.done():
            master.join(0)
            raise RuntimeError("the master ended before listening")
        try:
            with socket.create_connection(("127.0.0.1", port), 0.5):
                return
        except OSError:
            time.sleep(0.1)
    raise RuntimeError("the master never listened on %d" % port)


def run_fault_free(max_epochs, device_args, workdir):
    """The reference leg: the master and ONE clean subprocess slave."""
    port = free_port()
    trace = os.path.join(workdir, "fault_free.trace.json")
    master = MasterThread(port, max_epochs, trace, device_args).start()
    _wait_listening(port, master)
    t0 = time.perf_counter()
    child = spawn_slave(port, max_epochs, None, device_args,
                        os.path.join(workdir, "slave_fault_free.log"))
    try:
        sw = master.join(1200)
    finally:
        _stop(child)
    wall = time.perf_counter() - t0
    server = sw.workflow._agent
    return {
        "wall_s": wall,
        "updates_applied": server.updates_applied,
        "jobs_dispatched": server.jobs_dispatched,
        "state": master_state(sw),
        "metrics": metrics(sw),
    }


def run_soak(seed, max_epochs, target_preempts, device_args, workdir,
             max_incarnations=40):
    """The soak leg: slaves SIGKILL themselves on the seeded schedule
    until ``target_preempts`` preempts landed; a clean one finishes."""
    from veles_tpu_torch.chaos import FaultPlan
    rng = random.Random(seed)
    rejoin_plan = FaultPlan(seed=seed)
    for k in range(1, max_incarnations + 1):
        rejoin_plan.add("slave.rejoin_after", "delay", nth=k,
                        param=round(rng.uniform(0.2, 1.0), 3))
    kill_after = [rng.randint(2, 6) for _ in range(max_incarnations)]
    port = free_port()
    trace = os.path.join(workdir, "soak.trace.json")
    master = MasterThread(port, max_epochs, trace, device_args).start()
    _wait_listening(port, master)
    events = []
    preempts = rejoins = incarnation = 0
    delay_total = 0.0
    child = None
    t0 = time.perf_counter()
    try:
        while not master.done():
            if incarnation >= max_incarnations:
                raise RuntimeError("the soak never converged (%d slaves)"
                                   % incarnation)
            spec = None  # the clean tail finishes the run
            if preempts < target_preempts:
                spec = "seed=%d;slave.preempt=kill:a%d:x1" % (
                    seed + incarnation, kill_after[incarnation])
            child = spawn_slave(port, max_epochs, spec, device_args,
                                os.path.join(workdir, "slave_%d.log"
                                             % incarnation))
            incarnation += 1
            while child.poll() is None and not master.done():
                time.sleep(0.1)
            if master.done():
                break
            if child.returncode == -signal.SIGKILL:
                preempts += 1
                events.append({"event": "preempt",
                               "incarnation": incarnation,
                               "after_jobs": kill_after[incarnation - 1]})
            else:
                events.append({"event": "exit", "incarnation": incarnation,
                               "rc": child.returncode})
            fault = rejoin_plan.fire("slave.rejoin_after")
            delay = fault.param if fault is not None else 0.5
            delay_total += delay
            time.sleep(delay)
            rejoins += 1
            events.append({"event": "rejoin", "incarnation": incarnation,
                           "delay_s": delay})
        sw = master.join(600)
    finally:
        _stop(child)
    wall = time.perf_counter() - t0
    server = sw.workflow._agent
    return {
        "wall_s": wall,
        "preempts": preempts,
        "rejoins": rejoins,
        "slaves_started": incarnation,
        "events": events,
        "rejoin_delay_total_s": delay_total,
        "updates_applied": server.updates_applied,
        "jobs_dispatched": server.jobs_dispatched,
        "reshards": server.reshards,
        "membership_epoch": server.fleet.membership_epoch,
        "stale_updates": server.stale_updates,
        "duplicates_dropped": server.duplicates_dropped,
        "requeued_minibatches": sw.loader.total_failed,
        "state": master_state(sw),
        "metrics": metrics(sw),
        "trace": trace,
    }


def merged_trace_summary(trace):
    """The slaves' spans in the soaked master's merged trace."""
    with open(trace + ".merged.json") as fin:
        doc = json.load(fin)
    names = {}
    for event in doc["traceEvents"]:
        if event.get("ph") == "M" and event.get("name") == "process_name":
            names[event["pid"]] = (event.get("args") or {}).get("name", "")
    slave_pids = {pid for pid, name in names.items()
                  if str(name).startswith("slave:")}
    spans = [e for e in doc["traceEvents"]
             if e.get("name") == "slave.job" and e.get("ph") == "X"
             and e.get("pid") in slave_pids]
    return {"path": trace + ".merged.json", "slave_tracks":
            len(slave_pids), "slave_spans": len(spans),
            "tracks": sorted(str(name) for name in names.values()),
            "trace_id": (doc.get("otherData") or {}).get("trace_id")}


def run_kill_during_reshard(device, max_epochs):
    """The in-process exactly-once case: the slave dies on its third
    job, and the reshard push at its rejoin severs the connection."""
    from veles_tpu_torch.chaos import FaultPlan
    ref, ref_server, _, _ = run_pair(device, max_epochs)
    plan = (FaultPlan(seed=7)
            .add("client.job", "die", nth=3)
            .add("server.reshard", "kill", nth=2))
    sw, server, client, _ = run_pair(device, max_epochs, plan)
    identical = all(numpy.array_equal(a, b) for a, b in zip(
        master_state(ref), master_state(sw)))
    return {
        "reshard_kills_fired": plan.fired("server.reshard"),
        "sessions": client.sessions_established,
        "updates_applied_fault_free": ref_server.updates_applied,
        "updates_applied": server.updates_applied,
        "double_applies": max(
            0, server.updates_applied - ref_server.updates_applied),
        "stale_updates": server.stale_updates,
        "bit_identical": bool(identical and metrics(ref) == metrics(sw)),
    }


def soak(seed=42, preempts=2, max_epochs=3, device=None, workdir=None):
    """The whole receipt (a dict); ``device`` None is the card."""
    import tempfile

    from veles_tpu_torch.backends import Device
    device_args = [] if device is None else ["-d", device]
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="torch_elastic_soak_")
    os.makedirs(workdir, exist_ok=True)
    t_start = time.perf_counter()
    ref = run_fault_free(max_epochs, device_args, workdir)
    leg = run_soak(seed, max_epochs, preempts, device_args, workdir)
    merged = merged_trace_summary(leg.pop("trace"))
    krr = run_kill_during_reshard(
        Device() if device is None else Device(device),
        min(max_epochs, 2))
    identical = all(numpy.array_equal(a, b) for a, b in zip(
        ref.pop("state"), leg.pop("state")))
    overhead = leg["wall_s"] - ref["wall_s"]
    bound = leg["rejoin_delay_total_s"] + \
        leg["preempts"] * RESPAWN_ALLOWANCE_S
    receipt = {
        "schema": "elastic-soak-v1",
        "generated_unix": int(time.time()),
        "platform": "cpu" if device == "cpu" else "cuda",
        "seed": seed,
        "config": {
            "workflow": "veles_tpu_torch/examples/digits_conv.py",
            "max_epochs": max_epochs, "minibatch": 48,
            "train_samples": 1437, "validation_samples": 360,
            "layers": "conv_relu(16, 3x3) + max_pooling(2x2) + "
                      "conv_relu(32, 3x3) + max_pooling(2x2) + "
                      "all2all_relu(64) + softmax(10), momentum 0.9 "
                      "(solver accumulators ship with every job)",
        },
        "fault_free": ref,
        "soak": leg,
        "events_total": leg["preempts"] + leg["rejoins"],
        "bit_identical": bool(identical and
                              ref["metrics"] == leg["metrics"]),
        "throughput": {
            "overhead_s": overhead, "bound_s": bound,
            "loss_pct": 100.0 * overhead / max(leg["wall_s"], 1e-9),
            "within_bound": bool(overhead <= bound),
        },
        "kill_during_reshard": krr,
        "merged_trace": merged,
        "seconds": time.perf_counter() - t_start,
    }
    if own:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return receipt


def receipt_ok(receipt, preempts):
    krr = receipt["kill_during_reshard"]
    return bool(receipt["bit_identical"]
                and receipt["soak"]["preempts"] >= preempts
                and receipt["throughput"]["within_bound"]
                and krr["double_applies"] == 0 and krr["bit_identical"]
                and krr["reshard_kills_fired"] == 1
                and receipt["merged_trace"]["slave_spans"] > 0)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SIGKILL preemption soak of the port's master-slave "
                    "layer -> a JSON receipt")
    parser.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "torch_elastic_soak.json"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--preempts", type=int, default=2)
    parser.add_argument("--max-epochs", type=int, default=3)
    parser.add_argument("-d", "--device", default=None,
                        help="cpu, or the card (cuda) when not given")
    parser.add_argument("--workdir", default=None,
                        help="where the traces and slave logs go (a "
                             "temporary directory, removed, by default)")
    parser.add_argument("--job-update", nargs=2, metavar=("JOB", "OUT"),
                        help="run the pickled job JOB on a fresh slave "
                             "and write its packed update to OUT")
    args = parser.parse_args(argv)
    if args.job_update:
        import pickle

        from veles_tpu_torch.backends import Device
        with open(args.job_update[0], "rb") as fin:
            job = pickle.load(fin)
        raw = job_update(Device() if args.device is None
                         else Device(args.device), args.max_epochs, job)
        with open(args.job_update[1], "wb") as fout:
            fout.write(raw)
        return 0
    receipt = soak(args.seed, args.preempts, args.max_epochs, args.device,
                   args.workdir)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        json.dump(receipt, fout, indent=1, sort_keys=True)
        fout.write("\n")
    ok = receipt_ok(receipt, args.preempts)
    print("soak: bit_identical=%s, %d preempts, %d reshards, overhead "
          "%.1f s (bound %.1f s), kill-during-reshard double applies %d, "
          "%d slave spans merged -> %s" % (
              receipt["bit_identical"], receipt["soak"]["preempts"],
              receipt["soak"]["reshards"],
              receipt["throughput"]["overhead_s"],
              receipt["throughput"]["bound_s"],
              receipt["kill_during_reshard"]["double_applies"],
              receipt["merged_trace"]["slave_spans"], args.out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
