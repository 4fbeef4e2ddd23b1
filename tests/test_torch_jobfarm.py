"""The port's job farm (veles_tpu_torch/jobfarm.py) on the CPU, against
the JAX package's (veles_tpu/jobfarm.py).

- The counterparts of tests/test_jobfarm.py's 13 tests: results in job
  order over two local workers, a raised job failing the batch, a
  remote-style worker, persistent batches, a remote worker surviving
  between batches, the watchdog's speculation rescuing a wedged job,
  the batch timeout, the bind failure, and the master adapter's
  speculation threshold, epoch stamps, requeue and surviving backups.
- The farm's checksum for a tag is the JAX package's, and a job frame,
  a context frame and a result frame pickle (``pack_payload``) to the
  JAX package's bytes for the same jobs.
- While a farm's local workers run, the card counts as shared and a
  workflow on it holds ``graphs.shared()`` around each unit; a training
  alone, a remote-only farm and the CPU take no hold.
- A farm with local workers, and a worker, resolve their device before
  any socket opens: without a card and without the CPU asked for they
  raise ``no CUDA device``.

The suite's ``VELES_BACKEND=cpu`` puts the workers on the CPU.
"""

import threading
import time

import pytest
import torch

from tests.torch_master_slave import port_net_isolated  # noqa: F401
from veles_tpu_torch.jobfarm import (FarmJobError, JobFarm, _FarmMaster,
                                     _FarmSlave, _UNSET, farm_enabled)
from veles_tpu_torch.network_common import pack_payload
from veles_tpu_torch.server import SlaveDescription


def test_farm_two_local_slaves_all_results_in_order():
    seen = []
    lock = threading.Lock()

    def runner(spec):
        with lock:
            seen.append(spec)
        return spec * spec

    farm = JobFarm("sq")
    results = farm.run(range(10), runner=runner, local_slaves=2,
                       timeout=60)
    assert results == [i * i for i in range(10)]
    assert sorted(set(seen)) == list(range(10))
    assert farm.stats["served"] >= 10 and farm.stats["batches"] == 1
    # a worker that joins after the batch ended has not rated itself
    assert 1 <= len(farm.stats["power_ratings"]) <= 2


def test_farm_runner_error_fails_loudly():
    def runner(spec):
        if spec == 3:
            raise ValueError("boom")
        return spec

    with pytest.raises(FarmJobError, match=r"job 3.*boom"):
        JobFarm("errs").run(range(5), runner=runner, local_slaves=2,
                            timeout=60)


def test_farm_remote_style_worker_joins():
    """No local workers: a worker connects the way a remote host does
    (same tag, the address learned from the bound server)."""
    def start_worker(server):
        threading.Thread(
            target=JobFarm("remote").worker,
            args=("127.0.0.1:%d" % server.port, lambda s: s + 1),
            daemon=True).start()

    results = JobFarm("remote").run(range(6), on_listening=start_worker,
                                    timeout=60)
    assert results == [1, 2, 3, 4, 5, 6]


def test_farm_persistent_batches_reuse_workers():
    """start / submit / submit / shutdown: one server, several batches
    (the GA's generation pattern)."""
    farm = JobFarm("persist").start(runner=lambda s: s * 2, local_slaves=2)
    try:
        assert farm.submit(range(5), timeout=60) == [0, 2, 4, 6, 8]
        assert farm.submit(range(3), timeout=60) == [0, 2, 4]
        assert farm.submit([], timeout=60) == []
    finally:
        farm.shutdown()
    assert farm.stats["batches"] == 2


def test_remote_worker_survives_between_batches():
    """A remote-style worker connected once serves every batch."""
    farm = JobFarm("persist2").start()
    jobs_done = {}

    def work():
        jobs_done["n"] = JobFarm("persist2").worker(farm.address,
                                                    lambda s: s + 1)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    try:
        assert farm.submit(range(4), timeout=60) == [1, 2, 3, 4]
        assert farm.submit(range(4, 8), timeout=60) == [5, 6, 7, 8]
    finally:
        farm.shutdown()
    thread.join(10)
    assert not thread.is_alive()
    assert jobs_done["n"] == 8


def test_watchdog_speculation_rescues_wedged_job():
    """Workers park passively, so the server's watchdog tick re-checks
    the straggler threshold: a wedged job's backup copy reaches the
    parked idle worker with no update traffic to release it."""
    calls = {"slow": 0}
    lock = threading.Lock()
    wedge = threading.Event()

    def runner(spec):
        if spec == "slow":
            with lock:
                calls["slow"] += 1
                first = calls["slow"] == 1
            if first:
                wedge.wait(30)  # wedged until the test releases it
            return "rescued"
        return spec

    farm = JobFarm("wedge", speculation_factor=1.0,
                   min_speculation_s=0.6).start(runner=runner,
                                                local_slaves=2)
    try:
        res = farm.submit(["a", "b", "slow"], timeout=15)
    finally:
        wedge.set()
        farm.shutdown()
    assert res == ["a", "b", "rescued"]
    assert calls["slow"] == 2  # the backup copy ran
    assert farm.stats["speculated"] >= 1


def test_farm_timeout_reports_unfinished():
    with pytest.raises(FarmJobError, match="2/2 jobs unfinished"):
        JobFarm("idle").run([1, 2], timeout=0.5)  # nobody works


def test_farm_bind_failure_raises_instead_of_hanging():
    farm = JobFarm("bind1").start()
    try:
        with pytest.raises(RuntimeError, match="failed to bind"):
            JobFarm("bind2").start(address="127.0.0.1:%d" %
                                   farm.server.port)
    finally:
        farm.shutdown()


def _slave(sid):
    return SlaveDescription(sid, "mid", 0, 1.0)


def _master(jobs, **kwargs):
    m = _FarmMaster("c", **kwargs)
    m.reset(jobs)
    return m


def test_master_speculates_only_past_straggler_threshold():
    m = _master(["a", "b"], speculation_factor=2.0, min_speculation_s=2.0)
    e = m.epoch
    s1, s2 = _slave("s1"), _slave("s2")
    assert m.generate_data_for_slave(s1) == (e, 0, "a")
    assert m.generate_data_for_slave(s2) == (e, 1, "b")
    m.apply_data_from_slave((e, 1, ("ok", "B")), s2)
    # completed durations exist but job 0 only just started: no copy
    m._durations.clear()
    m._durations.append(1.0)
    assert m.generate_data_for_slave(s2) is False
    # once it straggles past the threshold, an idle worker shadows it
    m._outstanding[0][s1.id] = time.perf_counter() - 100.0
    assert m.generate_data_for_slave(s2) == (e, 0, "a")
    # never a second copy for the same worker
    assert m.generate_data_for_slave(s2) is False
    # the first result wins; the straggler's late duplicate is ignored
    m.apply_data_from_slave((e, 0, ("ok", "from_s2")), s2)
    assert m.done.is_set()
    m.apply_data_from_slave((e, 0, ("ok", "late")), s1)
    assert m.results == [("ok", "from_s2"), ("ok", "B")]
    assert (m.served, m.speculated, m.requeued) == (3, 1, 0)


def test_master_ignores_stale_epoch_updates():
    """A duplicate from an earlier batch never lands in the current
    batch's slot."""
    m = _master(["a"])
    s1 = _slave("s1")
    old = m.epoch
    assert m.generate_data_for_slave(s1) == (old, 0, "a")
    m.apply_data_from_slave((old, 0, ("ok", "old")), s1)
    m.reset(["a2"])
    assert m.generate_data_for_slave(s1) == (old + 1, 0, "a2")
    m.apply_data_from_slave((old, 0, ("ok", "stale")), s1)
    assert not m.done.is_set()
    assert m.results == [_UNSET]
    m.apply_data_from_slave((old + 1, 0, ("ok", "fresh")), s1)
    assert m.results == [("ok", "fresh")]


def test_master_never_speculates_without_completed_durations():
    m = _master(["a", "b"])
    e = m.epoch
    s1, s2 = _slave("s1"), _slave("s2")
    m.generate_data_for_slave(s1)
    m._outstanding[0][s1.id] = time.perf_counter() - 1e6
    # no completed job yet: no credible mean, no backup copies
    assert m.generate_data_for_slave(s2) == (e, 1, "b")
    assert m.generate_data_for_slave(s2) is False


def test_master_requeues_when_every_copy_dies():
    m = _master(["a"])
    e = m.epoch
    s1, s2 = _slave("s1"), _slave("s2")
    assert m.generate_data_for_slave(s1) == (e, 0, "a")
    m.drop_slave(s1)
    assert not m.done.is_set() and m.requeued == 1
    # the orphaned job goes to the next requester
    assert m.generate_data_for_slave(s2) == (e, 0, "a")
    m.apply_data_from_slave((e, 0, ("ok", 1)), s2)
    assert m.done.is_set()


def test_master_keeps_job_with_surviving_backup():
    m = _master(["a"], speculation_factor=2.0, min_speculation_s=2.0)
    e = m.epoch
    s1, s2 = _slave("s1"), _slave("s2")
    m.generate_data_for_slave(s1)
    m._durations.append(0.001)
    m._outstanding[0][s1.id] = time.perf_counter() - 100.0
    assert m.generate_data_for_slave(s2) == (e, 0, "a")  # backup copy
    m.drop_slave(s1)
    assert not m._pending  # not requeued: s2 still runs its copy
    m.apply_data_from_slave((e, 0, ("ok", 1)), s2)
    assert m.done.is_set()


# -- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("tag", ["genetics", "ensemble", "ensemble-test",
                                 "sq", "веles"])
def test_checksum_is_jax(tag):
    from veles_tpu import jobfarm as jax_jobfarm
    assert JobFarm(tag).checksum == jax_jobfarm.JobFarm(tag).checksum


def test_job_and_result_frames_are_jax_bytes():
    """The master's job frames (two batches, a speculative copy, a
    requeued job), its context frame, and a worker's result frames
    pickle to the JAX package's bytes."""
    import numpy
    from veles_tpu import jobfarm as jax_jobfarm
    from veles_tpu.network_common import pack_payload as jax_pack
    from veles_tpu.server import SlaveDescription as JaxSlave
    rng = numpy.random.RandomState(5)
    context = rng.rand(4, 3).astype(numpy.float32)
    jobs = [("member_000.pickle", "cpu"), {"x": 0.25, "y": -1.5}, 7]
    port = _FarmMaster("c", min_speculation_s=0.0, context=context)
    jax = jax_jobfarm._FarmMaster("c", min_speculation_s=0.0,
                                  context=context)
    assert pack_payload(port.generate_initial_data_for_slave(None)) == \
        jax_pack(jax.generate_initial_data_for_slave(None))
    frames = []
    for master, slave in ((port, _slave), (jax, lambda sid: JaxSlave(
            sid, "mid", 0, 1.0))):
        out = []
        for batch in (jobs, jobs[::-1]):
            master.reset(batch)
            a, b = slave("a"), slave("b")
            out.append(master.generate_data_for_slave(a))
            out.append(master.generate_data_for_slave(b))
            master.drop_slave(a)                          # requeue
            out.append(master.generate_data_for_slave(b))
            out.append(master.generate_data_for_slave(a))
            master.apply_data_from_slave(
                (master.epoch, 0, ("ok", 1.0)), b)
            master._durations.append(0.0)
            out.append(master.generate_data_for_slave(b))  # a backup
            for i in range(len(batch)):
                master.apply_data_from_slave((master.epoch, i, ("ok", i)),
                                             a)
        frames.append([pack_payload(f) for f in out])
    assert frames[0] == frames[1]
    results = []
    for cls in (_FarmSlave, jax_jobfarm._FarmSlave):
        sent = []
        worker = cls("c", lambda spec, ctx=None: (
            spec, None if ctx is None else ctx.sum()))
        worker.do_job((3, 1, {"x": 0.5}), None, sent.append)
        worker.apply_initial_data_from_master(("ctx", context))
        worker.do_job((3, 2, "member"), None, sent.append)
        failing = cls("c", lambda spec: 1 / 0)
        failing.do_job((4, 0, None), None, sent.append)
        results.append([pack_payload(u) for u in sent])
    assert results[0] == results[1]


# -- the device ---------------------------------------------------------------


def test_farm_enabled_is_the_jax_rule():
    from veles_tpu.jobfarm import farm_enabled as jax_rule
    for args in ((0, "127.0.0.1:0"), (2, "127.0.0.1:0"),
                 (0, "127.0.0.1:8270"), (1, "0.0.0.0:9")):
        assert farm_enabled(*args) == jax_rule(*args)


@pytest.mark.parametrize("role", ["master", "worker"])
def test_farm_takes_the_card_unless_asked(role, monkeypatch):
    """Without ``-d`` and ``VELES_BACKEND`` a farm with local workers,
    and a worker, ask for the card and raise before a Server or Client
    exists; with the CPU asked for they run there."""
    import veles_tpu_torch.client as client_module
    import veles_tpu_torch.server as server_module
    from veles_tpu_torch.config import root

    def no_socket(*args, **kwargs):
        raise AssertionError("a socket before the device check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    monkeypatch.setitem(root.common.engine.__dict__, "backend", "cuda")
    with monkeypatch.context() as patched:
        patched.setattr(server_module, "Server", no_socket)
        patched.setattr(client_module, "Client", no_socket)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            if role == "master":
                JobFarm("card").start(runner=abs, local_slaves=1)
            else:
                JobFarm("card").worker("127.0.0.1:1", abs)
    farm = JobFarm("card", device="cpu")
    assert farm.run([-3], runner=abs, local_slaves=1, timeout=60) == [3]


def test_local_workers_share_the_card_and_workflows_then_hold():
    import contextlib
    import types
    from veles_tpu_torch import graphs
    from veles_tpu_torch.workflow import Workflow
    on_card = types.SimpleNamespace(device=types.SimpleNamespace(
        backend="cuda"))
    on_cpu = types.SimpleNamespace(device=types.SimpleNamespace(
        backend="cpu"))

    def holds():
        hold = Workflow._card_hold(on_card)
        if isinstance(hold, contextlib.nullcontext):
            return False
        with hold:
            return graphs._SHARED_COUNT[0] >= 1

    assert not graphs.card_shared() and not holds()
    seen = JobFarm("share").run(
        range(4), runner=lambda s: (graphs.card_shared(), holds(),
                                    isinstance(Workflow._card_hold(on_cpu),
                                               contextlib.nullcontext)),
        local_slaves=2, timeout=60)
    assert seen == [(True, True, True)] * 4
    assert not graphs.card_shared() and not holds()
    # a remote-only farm: its workers are other processes
    remote = JobFarm("share_remote").start()
    try:
        assert not graphs.card_shared()
    finally:
        remote.shutdown()
    assert graphs._SHARED_COUNT[0] == 0
