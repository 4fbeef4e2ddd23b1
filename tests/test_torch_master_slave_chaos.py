"""Faults injected into the port's master-slave layer, and its launcher
modes, on the CPU.

- The counterparts of tests/test_chaos.py's control-plane tests: a slave
  killed mid-batch (``client.job=die`` on its 3rd job) leaves the
  master's weights and ``epoch_metrics`` bit-identical to the
  fault-free run; a master-side connection kill (``server.serve=kill``)
  requeues and the slave reconnects; a corrupted frame fails the HMAC
  check before unpickling, and on the wire (``net.recv:slave``) forces
  a reconnect; a poisoned update (``net.update=nan``) is quarantined
  (drop, TTL blacklist, requeue, a flight dump) and the run finishes
  with finite weights.
- ``Workflow.apply_update_validated`` raises ``PoisonedUpdate`` before
  the poisoned part applies, and a master on the ``inline`` path
  quarantines the sender as the prewalk does (tests/test_health.py).
- tests/test_observe_cluster.py's two-node run: the slave's spans are
  stitched under the master's trace id into one merged trace.
- The launcher: ``-l`` and ``-m`` take the card unless ``-d cpu`` asks
  for the CPU (without a card, the device they ask for raises), and
  ``python -m veles_tpu_torch <workflow> - -d cpu -l`` / ``-m`` train a
  master and a slave as two processes; the master's ``--trace`` writes
  ``<trace>.merged.json`` with the slave's spans.
"""

import asyncio
import copy
import json
import os
import subprocess
import sys
import time

import numpy
import pytest
import torch

from tests.torch_master_slave import (  # noqa: F401
    build, port_net_isolated, start_server, weights)
from tests.torch_imports import restored_imports
from veles_tpu_torch import chaos
from veles_tpu_torch.chaos import FaultPlan
from veles_tpu_torch.client import Client
from veles_tpu_torch.config import root
from veles_tpu_torch.network_common import (
    ProtocolError, pack_payload, read_frame, write_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.chaos
def test_slave_killed_mid_batch_bit_identical():
    master_ref = build("master", "chaos_net_m")
    slave_ref = build("slave", "chaos_net_s")
    server_ref, _ = start_server(master_ref)
    Client("127.0.0.1:%d" % server_ref.port, slave_ref).run()
    assert server_ref._done.wait(30)
    assert bool(master_ref.decision.complete)
    ref_weights = weights(master_ref)
    ref_metrics = list(master_ref.decision.epoch_metrics)

    master = build("master", "chaos_net_m")
    slave = build("slave", "chaos_net_s")
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    plan = chaos.install(FaultPlan().add("client.job", "die", nth=3))
    try:
        client.run()
    finally:
        chaos.uninstall()
    assert server._done.wait(30)
    assert plan.fired("client.job") == 1
    assert client.sessions_established == 2
    assert master.loader.total_failed >= 1
    assert bool(master.decision.complete)
    assert list(master.decision.epoch_metrics) == ref_metrics
    for got, want in zip(weights(master), ref_weights):
        numpy.testing.assert_array_equal(got, want)


@pytest.mark.chaos
def test_server_side_conn_kill_requeues_and_recovers():
    master = build("master", "chaos_kill_m")
    slave = build("slave", "chaos_kill_s")
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    plan = chaos.install(FaultPlan().add("server.serve", "kill", nth=4))
    try:
        client.run()
    finally:
        chaos.uninstall()
    assert server._done.wait(30)
    assert plan.fired("server.serve") == 1
    assert client.sessions_established >= 2
    assert master.loader.total_failed >= 1
    assert bool(master.decision.complete)
    assert numpy.isfinite(weights(master)[0]).all()


@pytest.mark.chaos
def test_corrupted_frame_rejected_before_unpickling():
    secret = b"sesame"

    class _Writer(object):
        def __init__(self):
            self.data = b""

        def write(self, blob):
            self.data += blob

    writer = _Writer()
    write_frame(writer, {"type": "update", "job_id": "j1"},
                pack_payload({"x": 1}), secret)
    blob = bytearray(writer.data)
    blob[-20] ^= 0xFF  # inside the payload / MAC tail

    async def read_corrupt():
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(blob))
        reader.feed_eof()
        return await read_frame(reader, secret)

    with pytest.raises(ProtocolError):
        asyncio.run(read_corrupt())


@pytest.mark.chaos
def test_corrupted_frame_on_wire_connection_retried():
    master = build("master", "chaos_corrupt_m")
    slave = build("slave", "chaos_corrupt_s")
    server, _ = start_server(master, secret=b"sesame")
    client = Client("127.0.0.1:%d" % server.port, slave, secret=b"sesame")
    plan = chaos.install(
        FaultPlan().add("net.recv:slave", "corrupt", nth=5))
    try:
        client.run()
    finally:
        chaos.uninstall()
    assert server._done.wait(30)
    assert plan.fired("net.recv:slave") == 1
    assert client.sessions_established >= 2
    assert client.jobs_done > 0
    assert bool(master.decision.complete)


@pytest.mark.chaos
@pytest.mark.health
def test_poisoned_slave_update_quarantined_and_run_finishes(tmp_path):
    master = build("master", "chaos_poison_m")
    slave = build("slave", "chaos_poison_s")
    server, _ = start_server(master, blacklist_ttl=0.6)
    client = Client("127.0.0.1:%d" % server.port, slave)
    plan = chaos.install(FaultPlan().add("net.update", "nan", nth=2))
    try:
        client.run()
    finally:
        chaos.uninstall()
    assert server._done.wait(30)
    assert plan.fired("net.update") == 1
    assert server.quarantined == 1
    assert master.loader.total_failed >= 1
    assert client.sessions_established >= 2
    assert bool(master.decision.complete)
    for w in weights(master):
        assert numpy.isfinite(w).all()
    assert master.decision.epoch_metrics[1] is not None
    assert numpy.isfinite(master.decision.epoch_metrics[1])
    assert list(tmp_path.glob("veles_flight.quarantine.*.json"))


@pytest.mark.health
def test_apply_update_validated_raises_before_the_poisoned_part():
    from veles_tpu.health import PoisonedUpdate as JaxPoisoned
    from veles_tpu_torch.health import PoisonedUpdate
    from veles_tpu_torch.server import SlaveDescription
    master = build("master", "val_m")
    slave = SlaveDescription("s1", "m1", 0, 1.0)
    job = master.generate_data_for_slave(slave)
    assert job is not False
    update = [None] * len(job)
    units = master._distributed_units()
    index = units.index(master.forwards[1])
    update[index] = {"weights": numpy.full(
        master.forwards[1].weights.shape, numpy.nan, numpy.float32)}
    before = weights(master)
    with pytest.raises(PoisonedUpdate) as err:
        master.apply_update_validated(update, slave)
    assert str(err.value) == str(JaxPoisoned(master.forwards[1]))
    for got, want in zip(weights(master), before):
        numpy.testing.assert_array_equal(got, want)


@pytest.mark.health
def test_inline_validation_quarantines_like_prewalk():
    master = build("master", "inline_m")
    master.update_validation = "inline"
    slave = build("slave", "inline_s")
    server, _ = start_server(master, blacklist_ttl=0.6)
    client = Client("127.0.0.1:%d" % server.port, slave)
    plan = chaos.install(FaultPlan().add("net.update", "nan", nth=3))
    try:
        client.run()
    finally:
        chaos.uninstall()
    assert server._done.wait(30)
    assert server.quarantined == 1
    assert bool(master.decision.complete)
    for w in weights(master):
        assert numpy.isfinite(w).all()


@pytest.mark.chaos
@pytest.mark.observe
def test_two_node_chaos_run_merged_trace_and_quarantine_dump(tmp_path):
    """An in-process master and slave with a poisoned update: a flight
    dump at the quarantine, and a merged trace where one job id links
    the master's proto.job_out and proto.update_in with the slave's
    job span on separate process tracks under the run's trace id."""
    from veles_tpu_torch.observe.flight import flight, validate_flight
    from veles_tpu_torch.observe.merge import merge_run
    from veles_tpu_torch.observe.metrics import registry
    from veles_tpu_torch.observe.trace import tracer, validate_trace
    registry.reset()
    old_base, flight.base_path = flight.base_path, \
        str(tmp_path / "flight")
    old_label = tracer.label
    tracer.start()
    tracer.label = "master"
    try:
        master = build("master", "obsc_m")
        slave = build("slave", "obsc_s")
        server, _ = start_server(master, blacklist_ttl=0.6)
        client = Client("127.0.0.1:%d" % server.port, slave,
                        trace_scope="threads")
        plan = chaos.install(FaultPlan().add("net.update", "nan", nth=2))
        try:
            client.run()
        finally:
            chaos.uninstall()
        assert server._done.wait(30)
        assert plan.fired("net.update") == 1
    finally:
        tracer.stop()
        flight.base_path = old_base
    try:
        assert server.quarantined == 1
        assert bool(master.decision.complete)
        assert client.trace_id == server.trace_id
        assert client.clock_offset is not None
        assert abs(client.clock_offset) < 1.0
        assert client.trace_chunks_sent > 0
        dumps = sorted(tmp_path.glob("flight.quarantine.*.json"))
        assert dumps
        with open(str(dumps[0])) as fin:
            fdoc = json.load(fin)
        validate_flight(fdoc)
        assert fdoc["reason"] == "quarantine"
        assert any(e["kind"] == "instant" and
                   e["name"] == "proto.quarantine"
                   for e in fdoc["events"])
        trace_path = str(tmp_path / "master.json")
        tracer.save(trace_path)
        with open(trace_path) as fin:
            master_doc = json.load(fin)
        assert server.trace_collector.keys()
        merged = merge_run(master_doc, server.trace_collector,
                           trace_id=server.trace_id)
        validate_trace(merged)
        assert merged["otherData"]["trace_id"] == server.trace_id
        procs = {(e.get("args") or {}).get("name")
                 for e in merged["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
        assert "master" in procs
        assert any(name.startswith("slave:") for name in procs)
        events = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
        stamps = [e["ts"] for e in events]
        assert stamps == sorted(stamps)

        def jobs_of(name, ph):
            return {(e.get("args") or {}).get("job"): e["pid"]
                    for e in events
                    if e["name"] == name and e.get("ph") == ph}

        job_out = jobs_of("proto.job_out", "i")
        slave_spans = jobs_of("slave.job", "X")
        update_in = jobs_of("proto.update_in", "i")
        stitched = set(job_out) & set(slave_spans) & set(update_in)
        assert stitched
        for job in stitched:
            assert job_out[job] != slave_spans[job]
            assert job_out[job] == update_in[job]
        slave_traced = [e for e in events if e["name"] == "proto.job_in"]
        assert slave_traced
        assert all((e["args"] or {}).get("trace") ==
                   server.trace_id[:8] for e in slave_traced)
        # the distributed methods are spans of their own
        assert any(e["name"] == "apply_data_from_slave" and
                   e.get("cat") == "distributed" for e in events)
    finally:
        tracer.label = old_label


# -- the launcher's modes ----------------------------------------------------


@pytest.mark.parametrize("flag", ["-l", "-m"])
def test_master_and_slave_take_the_card_unless_asked(flag, monkeypatch):
    """``-l`` / ``-m`` without ``-d`` ask for the card and, on a host
    without one, raise before any unit runs or any socket opens.  (The
    suite's ``VELES_BACKEND=cpu`` is dropped and the engine's backend
    put back to a fresh process's default.)"""
    from veles_tpu_torch.__main__ import Main
    # the workflow's config defaults, in the tree that is put back
    import veles_tpu_torch.examples.digits_conv  # noqa: F401
    saved = copy.deepcopy(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    try:
        root.common.engine.backend = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"), \
                restored_imports():
            Main().run([os.path.join(REPO, "veles_tpu_torch", "examples",
                                     "digits_conv.py"), "-", flag,
                        "127.0.0.1:1"])
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved.__dict__)


@pytest.mark.parametrize("mode", ["master", "slave"])
def test_launcher_modes_on_the_cpu_when_asked(mode):
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from tests.torch_master_slave import LAYERS, Blobs
    address = {"master": "listen_address", "slave": "master_address"}
    launcher = Launcher(**{address[mode]: "127.0.0.1:1"})
    assert launcher.workflow_mode == mode
    assert getattr(launcher, "is_" + mode)
    assert not launcher.is_standalone
    StandardWorkflow(launcher, layers=[dict(s) for s in LAYERS],
                     loader_factory=lambda w: Blobs(w, minibatch_size=64))
    launcher.initialize(device="cpu")
    assert launcher.device.backend == "cpu"
    agent = type(launcher._agent).__name__
    assert agent == {"master": "Server", "slave": "Client"}[mode]
    # a master and a slave keep the per-unit graph (their unit states
    # are zipped in order)
    assert getattr(launcher.workflow, "fused_trainer", None) is None


CLI_WORKFLOW = '''"""Blobs through the master-slave command line (a test workflow)."""
import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator


class CliMsBlobs(FullBatchLoader):
    def load_data(self):
        self.class_lengths[:] = [0, 64, 256]
        self._calc_class_end_offsets()
        self.create_originals((16,))
        rng = numpy.random.RandomState(99)
        centers = rng.randn(4, 16) * 2.0
        for i in range(self.total_samples):
            self.original_data.mem[i] = centers[i % 4] + rng.randn(16) * 0.3
            self.original_labels[i] = i % 4


def run(load, main):
    load(StandardWorkflow, layers=[
        {"type": "all2all_tanh", "output_sample_shape": 32,
         "learning_rate": 0.05, "gradient_moment": 0.9},
        {"type": "softmax", "output_sample_shape": 4,
         "learning_rate": 0.05, "gradient_moment": 0.9}],
        loader_factory=lambda w: CliMsBlobs(
            w, minibatch_size=64, prng=RandomGenerator("cli_ms", seed=7)),
        decision_config={"max_epochs": 3})
    main()
'''


@pytest.mark.observe
def test_master_and_slave_processes_through_the_command_line(tmp_path):
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    wf = tmp_path / "cli_ms_workflow.py"
    wf.write_text(CLI_WORKFLOW)
    trace = str(tmp_path / "master.json")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("VELES_BACKEND", None)
    env.pop("VELES_CHAOS", None)
    common = [sys.executable, "-m", "veles_tpu_torch", str(wf), "-",
              "-d", "cpu"]
    master = subprocess.Popen(
        common + ["-l", "127.0.0.1:%d" % port, "--trace", trace,
                  "--result-file", str(tmp_path / "result.json")],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    slave = None
    try:
        deadline = time.time() + 120
        while True:
            try:
                with socket.create_connection(("127.0.0.1", port), 0.5):
                    break
            except OSError:
                assert master.poll() is None, master.stdout.read()
                assert time.time() < deadline, "the master never listened"
                time.sleep(0.1)
        slave = subprocess.run(
            common + ["-m", "127.0.0.1:%d" % port, "--trace",
                      str(tmp_path / "slave.json")],
            env=env, cwd=str(tmp_path), capture_output=True, text=True,
            timeout=300)
        out, _ = master.communicate(timeout=120)
    finally:
        if master.poll() is None:
            master.kill()
            master.communicate()
    assert slave.returncode == 0, slave.stderr[-3000:]
    assert master.returncode == 0, out[-3000:]
    assert "master mode" in out and "slave mode" in slave.stderr
    assert "distributed methods" in out
    with open(str(tmp_path / "result.json")) as fin:
        result = json.load(fin)
    assert result["Total epochs"] == 3
    assert result["Errors"]["validation"] < 15.0
    with open(trace + ".merged.json") as fin:
        merged = json.load(fin)
    names = {e["pid"]: (e.get("args") or {}).get("name")
             for e in merged["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    slave_pids = {pid for pid, name in names.items()
                  if str(name).startswith("slave:")}
    assert slave_pids
    assert any(e.get("name") == "slave.job" and e.get("pid") in slave_pids
               for e in merged["traceEvents"])
