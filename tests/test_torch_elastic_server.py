"""The port's elastic fleet in the master-slave layer
(veles_tpu_torch/server.py, client.py, elastic.py, the workflow's and
the loader's reshard hooks) on the CPU: the counterparts of
tests/test_elastic.py's server, workflow and loader tests.

Membership epochs and reshard pushes, drop + requeue + replay, the
drop-vs-apply race (the requeue deferred while an update applies), the
shutdown drain of in-flight applies, speculative backups (first result
wins, the loser dropped as a duplicate; the owner parked while its job
is speculated; the ``inf`` off-switch; a poisoned backup with a dropped
owner; a failed apply of a speculated copy), the seeded three-cycle
preempt/rejoin smoke and the kill-during-reshard case (both
bit-identical to the fault-free run), the reshard hooks of the
workflow and the loader, the reshard-hook failure's sever and rejoin,
the ``mesh_epoch`` stamp, and the GD units' solver-state deltas.  The
subprocess soak (``scripts/torch_elastic_soak.py``: SIGKILLed slave
processes respawned on a seeded schedule) is marked ``slow``, as the
JAX package's is.  The job farm's tests are tests/test_torch_jobfarm.py.
"""

import asyncio
import math
import threading
import time
from collections import deque

import numpy
import pytest

from tests.torch_master_slave import (  # noqa: F401
    build, port_net_isolated, start_server, weights)
from veles_tpu_torch import chaos, elastic
from veles_tpu_torch.chaos import FaultPlan
from veles_tpu_torch.client import Client
from veles_tpu_torch.elastic import fleet_snapshot
from veles_tpu_torch.network_common import pack_payload
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.server import Server

pytestmark = pytest.mark.elastic


class _IdleWorkflow(object):
    checksum = "idle"

    def generate_initial_data_for_slave(self, slave):
        return None

    def generate_data_for_slave(self, slave):
        return False

    def apply_data_from_slave(self, update, slave):
        return True

    def drop_slave(self, slave):
        pass


def test_timeout_threshold_degenerate_samples():
    server = Server("127.0.0.1:0", _IdleWorkflow(), job_timeout=7.0)
    # under 4 samples there is no credible sigma: the floor rules
    assert server._timeout_threshold() == 7.0
    server._all_job_times.extend([0.1, 0.1, 0.1])
    assert server._timeout_threshold() == 7.0
    # constant samples (sigma 0): mean + 3*0 < floor -> still 7
    server._all_job_times.append(0.1)
    assert server._timeout_threshold() == 7.0
    # a genuine spread lifts the threshold above the floor
    server._all_job_times.extend([30.0, 30.0, 30.0, 30.0])
    assert server._timeout_threshold() > 7.0
    assert math.isfinite(server._timeout_threshold())


def test_server_speculation_threshold_uses_fleet_powers():
    server = Server("127.0.0.1:0", _IdleWorkflow(),
                    speculation_factor=2.0, min_speculation_s=0.5)
    # degenerate fleet powers must not blow up the server's bar
    server.fleet.join("a", 0.0)
    server.fleet.join("b", -1.0)
    t = elastic.speculation_threshold(
        1.0, server.speculation_factor, server.min_speculation_s,
        owner_power=0.0, fleet_powers=server.fleet.powers())
    assert math.isfinite(t) and t == pytest.approx(2.0)




class _StubMaster(object):
    """Minimal master-side workflow contract with explicit job/requeue
    bookkeeping, so tests can assert EXACTLY what applied vs requeued."""

    checksum = "elastic-stub"
    update_validation = "prewalk"

    def __init__(self, jobs, remainder=None):
        self._lock = threading.Lock()
        self.pending = deque(jobs)
        self.outstanding = {}        # slave id -> [jobs]
        self.applied = []            # (job, slave id)
        self.drops = []
        self.events = []             # ordered apply/drop audit trail
        self.remainder = remainder
        self.apply_gate = None       # optional: blocks applies
        self.apply_started = threading.Event()

    def generate_initial_data_for_slave(self, slave):
        return None

    def generate_data_for_slave(self, slave):
        with self._lock:
            if not self.pending:
                return False
            job = self.pending.popleft()
            self.outstanding.setdefault(slave.id, []).append(job)
            return job

    def apply_data_from_slave(self, update, slave):
        self.apply_started.set()
        if self.apply_gate is not None:
            # generous window: the gate is a DETERMINISTIC handoff (the
            # test opens it once its assertions ran), so a long timeout
            # costs nothing when healthy but keeps full-suite load from
            # expiring the wedge mid-sequence (the PR 12/13 flake)
            assert self.apply_gate.wait(60), "apply gate never opened"
        with self._lock:
            job = update[1]
            jobs = self.outstanding.get(slave.id, [])
            if job in jobs:
                jobs.remove(job)
            self.applied.append((job, slave.id))
            self.events.append(("apply", job))
        return True

    def drop_slave(self, slave):
        with self._lock:
            self.drops.append(slave.id)
            self.events.append(("drop", slave.id))
            # requeue whatever is STILL outstanding for that slave
            for job in self.outstanding.pop(slave.id, []):
                self.pending.appendleft(job)

    def unserved_remainder(self):
        if self.remainder is not None:
            return self.remainder
        with self._lock:
            return len(self.pending) + sum(
                len(v) for v in self.outstanding.values())


class _StubSlave(object):
    """Client-side stub: returns each job payload as its result.
    Jobs in ``slow_on`` straggle — until ``gate`` is set when one is
    given (a PURE event wedge, no wall-clock cap: every gated test
    releases it in its ``finally``, so the owner can never un-wedge
    on its own under full-suite load and race the assertions — the
    last PR-9-era timing window, closed like the PR 14 deflakes),
    else for ``slow_s`` seconds."""

    checksum = "elastic-stub"

    def __init__(self, slow_on=(), slow_s=2.0, gate=None):
        self.slow_on = set(slow_on)
        self.slow_s = slow_s
        self.gate = gate
        self.reshards = []

    def apply_initial_data_from_master(self, data):
        pass

    def apply_reshard(self, info):
        self.reshards.append(dict(info))

    def do_job(self, data, update, callback):
        if data in self.slow_on:
            if self.gate is not None:
                self.gate.wait()
            else:
                time.sleep(self.slow_s)
        callback(("done", data))


class _PowerClient(Client):
    """Client reporting a FIXED power rating (deterministic shares)."""

    def __init__(self, *args, power=1.0, **kwargs):
        super(_PowerClient, self).__init__(*args, **kwargs)
        self._fixed_power = power

    @property
    def computing_power(self):
        return self._fixed_power


def _wait_for(predicate, timeout=30.0, what="condition"):
    # every caller waits on a DETERMINISTIC handoff (a push the server
    # already scheduled, a flag another thread must set), so a wide
    # default costs nothing when healthy; the old 10 s bound was the
    # PR 11/12 reshard-race flake — reshard pushes ride an executor
    # hop + the event loop, and full-suite load on a small host
    # stretched that past 10 s while solo runs land in ~0.1 s
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out waiting for " + what)


def _stub_server(master, **kwargs):
    server = Server("127.0.0.1:0", master, **kwargs)
    thread = server.start_background()
    assert server.wait_listening(10)
    return server, thread


def test_membership_epochs_and_reshard_push():
    master = _StubMaster([], remainder=100)
    server, _ = _stub_server(master)
    wf1, wf2 = _StubSlave(), _StubSlave()
    c1 = _PowerClient("127.0.0.1:%d" % server.port, wf1, power=3.0)
    c2 = _PowerClient("127.0.0.1:%d" % server.port, wf2, power=1.0)
    t1 = c1.start_background()
    t2 = None
    try:
        _wait_for(lambda: c1.member_epoch == 1, what="first join")
        # the join push hands the whole remainder to the only member
        _wait_for(lambda: wf1.reshards
                  and wf1.reshards[-1]["share"] == 100,
                  what="solo share push")
        t2 = c2.start_background()
        _wait_for(lambda: c2.member_epoch == 2, what="second join")
        # the second join REPARTITIONS without restarting anything:
        # power-weighted 3:1 split of the same remainder, both slaves
        # told, membership epoch bumped exactly once
        _wait_for(lambda: wf1.reshards
                  and wf1.reshards[-1]["epoch"] == 2,
                  what="repartition push to slave 1")
        _wait_for(lambda: wf2.reshards
                  and wf2.reshards[-1]["epoch"] == 2,
                  what="repartition push to slave 2")
        assert wf1.reshards[-1]["share"] == 75
        assert wf2.reshards[-1]["share"] == 25
        assert wf1.reshards[-1]["fleet"] == 2
        assert server.fleet.membership_epoch == 2
        assert server.reshards == 2
        # the fleet block dashboards/heartbeats read is live
        snap = fleet_snapshot()
        assert snap["membership_epoch"] == 2
        assert snap["live"] == 2
        assert _registry.peek("elastic.membership_epoch").value == 2
    finally:
        server.stop()
        server._done.wait(10)
        t1.join(10)
        if t2 is not None:
            t2.join(10)


def test_drop_requeues_reshards_and_replays():
    """A slave dying mid-run: requeue + leave-reshard + replay on
    rejoin — final weights bit-identical to the fault-free run."""
    master_ref = build("master", "elastic_drop_m")
    slave_ref = build("slave", "elastic_drop_s")
    server_ref, _ = start_server(master_ref)
    client_ref = Client("127.0.0.1:%d" % server_ref.port, slave_ref)
    client_ref.run()
    # wide deterministic windows (the soak smoke's discipline): both
    # runs end by event; the fault-free 10 s bound was the OTHER half
    # of the PR 11/12 reshard-race flake — the die/rejoin backoff plus
    # the rejoin's reshard push stretch under full-suite load while
    # solo runs finish in ~2 s
    assert server_ref._done.wait(60)
    ref_weights = weights(master_ref)

    master = build("master", "elastic_drop_m")
    slave = build("slave", "elastic_drop_s")
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    plan = chaos.install(FaultPlan().add("client.job", "die", nth=2))
    try:
        client.run()
    finally:
        chaos.uninstall()
    assert server._done.wait(90)
    assert plan.fired("client.job") == 1
    assert client.sessions_established == 2
    # join, leave, rejoin: three membership changes, three reshards
    assert server.reshards >= 3
    assert server.fleet.membership_epoch >= 3
    assert master.loader.total_failed >= 1, "the job must requeue"
    assert server.stale_updates == 0, \
        "a die-before-job death leaves no in-flight update to reject"
    for got, want in zip(weights(master), ref_weights):
        numpy.testing.assert_array_equal(got, want)


# -- the requeue race (satellite audit) -----------------------------------


def test_drop_during_apply_defers_requeue_never_doubles():
    """Regression for the drop-vs-apply race: a slave dropped AFTER its
    update was received but BEFORE check_and_apply completes must not
    have that job both requeued and applied.  The drop's requeue is
    deferred until the in-flight apply finishes; the applied job is
    then NOT among the requeued ones."""
    master = _StubMaster(["j1"])
    master.apply_gate = threading.Event()
    server, _ = _stub_server(master)
    wf = _StubSlave()
    client = Client("127.0.0.1:%d" % server.port, wf)
    thread = client.start_background()
    try:
        # the update for j1 arrives and its apply BLOCKS mid-flight
        # (deterministic handoff; wide window, same discipline as the
        # apply gate above)
        assert master.apply_started.wait(60)
        conn = list(server.slaves.values())[0]
        # the slave is dropped while the apply is still on the executor
        server._loop.call_soon_threadsafe(server._drop, conn, "test")
        # _drop flips conn.dropped BEFORE it registers the deferral
        # (the flag is the stale-update fence and must come first) —
        # wait on the deferral itself, the state the assertions read,
        # not the flag; the sleep is then purely the negative window
        # for a wrong requeue to surface
        _wait_for(lambda: conn.slave.id in server._deferred_drops,
                  what="deferred drop registered")
        assert conn.dropped
        time.sleep(0.3)
        assert master.drops == [], \
            "requeue must be DEFERRED while the update is mid-apply"
        assert server.drops_deferred == 1
        assert server._deferred_drops[conn.slave.id][1] == "test"
        # release the apply: it completes, THEN the drop finishes
        master.apply_gate.set()
        _wait_for(lambda: master.drops, what="deferred drop")
        assert master.events[0] == ("apply", "j1"), \
            "the in-flight apply must win the race"
        assert master.events[1][0] == "drop"
        assert master.applied == [("j1", conn.slave.id)]
        assert list(master.pending) == [], \
            "the APPLIED job must not also be requeued"
        # any further update from the departed slave is STALE: rejected
        # before validation, never applied
        fut = asyncio.run_coroutine_threadsafe(
            server._dispatch({"type": "update", "job_id": "whatever",
                              "codec": "none"},
                             pack_payload(("done", "j1")),
                             conn, None, None),
            server._loop)
        fut.result(10)
        assert server.stale_updates == 1
        assert master.applied == [("j1", conn.slave.id)], \
            "the stale update must never reach the workflow"
        assert _registry.peek("elastic.stale_updates").value >= 1
    finally:
        master.apply_gate.set()
        server.stop()
        server._done.wait(10)
        thread.join(10)


def test_stop_during_apply_drains_bookkeeping_before_done():
    """Regression for the server-side lost-update race behind the
    kill-during-reshard flake: a workflow that completes INSIDE
    check_and_apply (the decision latching ``complete`` on the
    executor thread) schedules the stop via call_soon_threadsafe
    BEFORE the executor future's own continuation, so _main could
    return — and asyncio.run cancel the _apply_update coroutine —
    after the weights mutated but before the bookkeeping
    (updates_applied, the ack, deferred drops) ran.  The teardown now
    drains ``_applying`` first: _done must not fire while an apply is
    mid-executor, and the counter must reflect every update the
    workflow actually absorbed."""
    master = _StubMaster(["j1"])
    master.apply_gate = threading.Event()
    server, thread = _stub_server(master)
    wf = _StubSlave()
    client = Client("127.0.0.1:%d" % server.port, wf)
    cthread = client.start_background()
    try:
        # j1's update arrives and its apply wedges on the executor
        assert master.apply_started.wait(60)
        # the stop lands while the apply is still in flight — the
        # exact scheduling the completion-inside-apply race produces
        server.stop()
        assert not server._done.wait(0.5), \
            "teardown must drain the in-flight apply, not bail"
        assert server.updates_applied == 0
        master.apply_gate.set()
        assert server._done.wait(30)
        assert master.applied and master.applied[0][0] == "j1", \
            "the wedged apply must have reached the workflow"
        assert server.updates_applied == 1, \
            "an apply that mutated the workflow must be counted"
    finally:
        master.apply_gate.set()
        server.stop()
        server._done.wait(10)
        thread.join(10)
        cthread.join(10)


# -- speculative backup dispatch (lifted from the jobfarm) ----------------


def test_server_speculation_first_result_wins():
    """The straggler path end-to-end: slave A wedges on its job, idle
    slave B is handed a backup copy of the SAME stamped job, B's
    result applies under A's reservation, and A's late duplicate is
    dropped before validation — applied exactly once.

    A's wedge is an EVENT (released only after the backup's result
    applied), not a wall-clock sleep: the old 2.5 s nap could expire
    under full-suite load before the watchdog crossed the speculation
    threshold, letting the owner win its own race and the
    ``speculated == 1`` wait time out (the PR 12/13 flake)."""
    wedge = threading.Event()
    master = _StubMaster(["seed", "slow"])
    server, _ = _stub_server(master, speculation_factor=1.0,
                             min_speculation_s=0.2)
    wf_a = _StubSlave(slow_on=("slow",), gate=wedge)
    wf_b = _StubSlave()
    ca = Client("127.0.0.1:%d" % server.port, wf_a)
    ta = ca.start_background()
    tb = None
    try:
        # A alone: completes "seed" (seeding the duration stats) and
        # wedges on "slow"
        _wait_for(lambda: len(master.applied) == 1, what="seed job")
        _wait_for(lambda: not master.pending
                  and master.outstanding.get(ca.sid), what="slow out")
        a_sid = ca.sid
        cb = Client("127.0.0.1:%d" % server.port, wf_b)
        tb = cb.start_background()
        # B idles at the sync point until the straggler crosses the
        # threshold; the watchdog tick re-evaluates and dispatches the
        # backup copy
        _wait_for(lambda: server.speculated == 1, timeout=30,
                  what="speculative dispatch")
        _wait_for(lambda: len(master.applied) == 2, timeout=30,
                  what="backup result")
        # B won, but the apply retired the OWNER's reservation
        assert master.applied[1] == ("slow", a_sid)
        # release the owner: its late duplicate is dropped before
        # validation
        wedge.set()
        _wait_for(lambda: server.duplicates_dropped == 1, timeout=30,
                  what="duplicate drop")
        assert len(master.applied) == 2, "never applied twice"
        assert _registry.peek("elastic.speculative_jobs").value >= 1
        assert server.stale_updates == 0
    finally:
        wedge.set()
        server.stop()
        server._done.wait(10)
        ta.join(10)
        if tb is not None:
            tb.join(10)


def test_owner_drop_during_backup_apply_defers_requeue():
    """Regression for the speculated flavor of the requeue race: the
    straggling OWNER is dropped while its backup's winning update —
    which applies under the owner's reservation — is mid-apply.  The
    drop must defer on the APPLY TARGET (not the sender's conn), so
    the job is applied once and never also requeued."""
    wedge = threading.Event()
    master = _StubMaster(["seed", "slow"])
    server, _ = _stub_server(master, speculation_factor=1.0,
                             min_speculation_s=0.2)
    wf_a = _StubSlave(slow_on=("slow",), gate=wedge)
    wf_b = _StubSlave()
    ca = Client("127.0.0.1:%d" % server.port, wf_a)
    ta = ca.start_background()
    tb = None
    try:
        _wait_for(lambda: len(master.applied) == 1, what="seed job")
        _wait_for(lambda: master.outstanding.get(ca.sid),
                  what="slow job out")
        a_sid = ca.sid
        a_conn = server.slaves[a_sid]
        # gate the NEXT apply (the backup's result) mid-flight
        master.apply_started.clear()
        master.apply_gate = threading.Event()
        cb = Client("127.0.0.1:%d" % server.port, wf_b)
        tb = cb.start_background()
        _wait_for(lambda: server.speculated == 1, timeout=15,
                  what="speculative dispatch")
        assert master.apply_started.wait(15), "backup result mid-apply"
        # drop the OWNER while the backup's update is applying under
        # the owner's reservation
        server._loop.call_soon_threadsafe(server._drop, a_conn,
                                          "owner-timeout")
        # same discipline as the drop-during-apply test above: the
        # dropped flag precedes the deferral registration, so wait on
        # the registration the assertions read
        _wait_for(lambda: a_sid in server._deferred_drops,
                  what="deferred owner drop registered")
        assert a_conn.dropped
        time.sleep(0.3)
        assert master.drops == [], \
            "the owner's requeue must defer on the apply target"
        assert server.drops_deferred == 1
        master.apply_gate.set()
        _wait_for(lambda: master.drops == [a_sid],
                  what="deferred owner drop")
        slow_apply = master.events.index(("apply", "slow"))
        assert master.events.index(("drop", a_sid)) > slow_apply, \
            "the winning apply must complete before the drop requeues"
        assert master.applied.count(("slow", a_sid)) == 1
        assert list(master.pending) == [], \
            "the applied job must not also be requeued"
    finally:
        wedge.set()
        if master.apply_gate is not None:
            master.apply_gate.set()
        server.stop()
        server._done.wait(10)
        ta.join(10)
        if tb is not None:
            tb.join(10)


def test_speculated_owner_request_parks_until_resolution():
    """An async (pipelining) owner asking for MORE work while its job
    is speculated — or while the backup's winning result is mid-apply
    under its reservation — must be PARKED, not served: a second
    reservation under the owner would be retired by the wrong result
    (the loader pops reservations LIFO per slave)."""
    wedge = threading.Event()
    master = _StubMaster(["seed", "slow"])
    server, _ = _stub_server(master, speculation_factor=1.0,
                             min_speculation_s=0.2)
    wf_a = _StubSlave(slow_on=("slow",), gate=wedge)
    wf_b = _StubSlave()
    ca = Client("127.0.0.1:%d" % server.port, wf_a, async_slave=True)
    ta = ca.start_background()
    tb = None
    try:
        _wait_for(lambda: len(master.applied) == 1, what="seed job")
        _wait_for(lambda: master.outstanding.get(ca.sid) == ["slow"],
                  what="slow out alone")
        # hold the NEXT apply (the backup's winning result) open so
        # both windows — speculated-unresolved and mid-apply — exist
        master.apply_started.clear()
        master.apply_gate = threading.Event()
        cb = Client("127.0.0.1:%d" % server.port, wf_b)
        tb = cb.start_background()
        _wait_for(lambda: server.speculated == 1, timeout=15,
                  what="speculative dispatch")
        # fresh work appears while the owner's job is speculated /
        # mid-apply; the parked-requester retry ticks at 0.5 s and
        # must NOT hand it to the owner
        master.pending.append("next")
        assert master.apply_started.wait(15), "backup result mid-apply"
        time.sleep(1.2)
        assert master.outstanding.get(ca.sid) == ["slow"], \
            "owner must not get a second reservation while its job " \
            "is speculated or mid-apply"
        master.apply_gate.set()
        _wait_for(lambda: ("apply", "slow") in master.events,
                  what="backup result applied")
        # resolution releases the parked owner — "next" may go to the
        # (still wedged) owner or to the idle backup; release the
        # wedge so it applies either way
        wedge.set()
        _wait_for(lambda: ("apply", "next") in master.events,
                  what="fresh work flows again after resolution")
        assert master.applied.count(("slow", ca.sid)) == 1
        _wait_for(lambda: server.duplicates_dropped == 1,
                  what="owner's late slow result dropped as duplicate")
    finally:
        wedge.set()
        if master.apply_gate is not None:
            master.apply_gate.set()
        server.stop()
        server._done.wait(10)
        ta.join(10)
        if tb is not None:
            tb.join(10)


def test_speculation_off_switch_inf_factor():
    """``--speculation-factor inf`` is the off-switch: nothing ever
    speculates, and the job stamps — which stay, the exactly-once
    duplicate/stale fences key on them — stop caching payloads, so
    the master does not retain a copy of every in-flight job."""
    wedge = threading.Event()
    master = _StubMaster(["seed", "slow"])
    server, _ = _stub_server(master,
                             speculation_factor=float("inf"),
                             min_speculation_s=0.0)
    wf_a = _StubSlave(slow_on=("slow",), gate=wedge)
    wf_b = _StubSlave()
    ca = Client("127.0.0.1:%d" % server.port, wf_a)
    ta = ca.start_background()
    tb = None
    try:
        _wait_for(lambda: len(master.applied) == 1, what="seed job")
        _wait_for(lambda: master.outstanding.get(ca.sid) == ["slow"],
                  what="slow job out")
        # the stamp lands on the event loop AFTER the executor-side
        # reservation the line above observes — wait for it
        _wait_for(lambda: server._inflight, what="job stamp")
        assert all(job.data is None
                   for job in server._inflight.values()), \
            "no payloads retained with speculation off"
        cb = Client("127.0.0.1:%d" % server.port, wf_b)
        tb = cb.start_background()
        time.sleep(1.5)  # several idle watchdog ticks
        assert server.speculated == 0, "inf factor never speculates"
        wedge.set()
        _wait_for(lambda: ("apply", "slow") in master.events,
                  what="owner's own result applies")
        assert master.applied.count(("slow", ca.sid)) == 1
    finally:
        wedge.set()
        server.stop()
        server._done.wait(10)
        ta.join(10)
        if tb is not None:
            tb.join(10)


class _PoisonSlave(_StubSlave):
    """Returns a structurally-valid but NaN update for every job —
    the finiteness quarantine must catch it before apply."""

    def do_job(self, data, update, callback):
        callback(numpy.array([float("nan")]))


def test_poisoned_backup_with_dropped_owner_not_reinstated(monkeypatch):
    """A poisoned speculative backup normally REINSTATES the job stamp
    (the owner's healthy copy is still running) — but NOT when the
    owner itself was dropped while the poisoned apply was in flight:
    its reservation was already requeued by the deferred drop, so
    reinstating would leave a phantom in-flight job with a departed
    owner, racing the legitimately requeued minibatch."""
    from veles_tpu_torch import health
    wedge = threading.Event()
    poison_gate = threading.Event()
    real_all_finite = health.all_finite

    def gated_all_finite(obj):
        ok = real_all_finite(obj)
        if not ok:
            # hold the poisoned validation open so the owner's drop
            # deterministically lands inside the apply window.  The
            # window is generous on purpose: it starts ticking the
            # moment the backup's NaN update arrives, while the test
            # thread is still polling for the speculation/apply flags
            # — under full-suite load a short timeout expired mid-
            # sequence and the quarantine beat the deferred drop (the
            # PR 13 flake)
            assert poison_gate.wait(120), "poison gate never opened"
        return ok

    monkeypatch.setattr(health, "all_finite", gated_all_finite)
    master = _StubMaster(["seed", "slow"])
    server, _ = _stub_server(master, speculation_factor=1.0,
                             min_speculation_s=0.2)
    wf_a = _StubSlave(slow_on=("slow",), gate=wedge)
    wf_b = _PoisonSlave()
    ca = Client("127.0.0.1:%d" % server.port, wf_a)
    ta = ca.start_background()
    tb = None
    try:
        _wait_for(lambda: len(master.applied) == 1, what="seed job")
        _wait_for(lambda: master.outstanding.get(ca.sid) == ["slow"],
                  what="slow job out")
        a_sid = ca.sid
        a_conn = server.slaves[a_sid]
        cb = Client("127.0.0.1:%d" % server.port, wf_b)
        tb = cb.start_background()
        _wait_for(lambda: server.speculated == 1, timeout=30,
                  what="speculative dispatch")
        # the poisoned validation is now (about to be) wedged on the
        # executor under the OWNER's reservation; drop the owner
        _wait_for(lambda: server._applying.get(a_sid), timeout=30,
                  what="poisoned apply in flight")
        server._loop.call_soon_threadsafe(server._drop, a_conn,
                                          "owner-timeout")
        # wait for the COUNTER, not the dropped flag: _drop sets
        # conn.dropped several statements (including a log call)
        # before it bumps drops_deferred, all on the loop thread —
        # under full-suite load the test thread can observe the flag
        # and read the counter inside that window.  The deferral
        # itself is guaranteed (the apply is wedged on poison_gate),
        # so waiting loses no strictness: an immediate drop would
        # never bump the counter and still fails here.
        _wait_for(lambda: a_conn.dropped, timeout=30,
                  what="owner drop flag")
        _wait_for(lambda: server.drops_deferred == 1, timeout=30,
                  what="deferred-drop counter")
        assert server.drops_deferred == 1
        poison_gate.set()
        _wait_for(lambda: a_sid in master.drops, timeout=30,
                  what="deferred owner drop")
        _wait_for(lambda: server.quarantined == 1, timeout=30,
                  what="poisoned sender quarantined")
        assert server._inflight == {}, \
            "no phantom stamp for the departed owner"
        assert list(master.pending) == ["slow"], \
            "the owner's work requeued exactly once"
        assert master.applied == [("seed", a_sid)], \
            "the poisoned update never applied"
    finally:
        wedge.set()
        poison_gate.set()
        server.stop()
        server._done.wait(10)
        ta.join(10)
        if tb is not None:
            tb.join(10)


def test_failed_apply_of_speculated_copy_does_not_orphan_job():
    """Exactly-once in the applied-ZERO-times direction: when the
    first-arriving copy of a speculated job dies in a transient
    master-side apply exception, the stamp must be reinstated so a
    surviving copy's good result still applies — not dropped as a
    duplicate, which would leave the owner's reservation never
    retired and the job silently lost."""
    wedge = threading.Event()
    master = _StubMaster(["seed", "slow"])
    armed = {"fail": True}
    real_apply = master.apply_data_from_slave

    def flaky_apply(update, slave):
        if update[1] == "slow" and armed["fail"]:
            armed["fail"] = False
            raise RuntimeError("transient apply failure")
        return real_apply(update, slave)

    master.apply_data_from_slave = flaky_apply
    server, _ = _stub_server(master, speculation_factor=1.0,
                             min_speculation_s=0.2)
    wf_a = _StubSlave(slow_on=("slow",), gate=wedge)
    wf_b = _StubSlave()
    ca = Client("127.0.0.1:%d" % server.port, wf_a)
    ta = ca.start_background()
    tb = None
    try:
        _wait_for(lambda: len(master.applied) == 1, what="seed job")
        _wait_for(lambda: master.outstanding.get(ca.sid) == ["slow"],
                  what="slow job out")
        cb = Client("127.0.0.1:%d" % server.port, wf_b)
        tb = cb.start_background()
        # >=: the failed copy's job re-speculates within milliseconds,
        # so the counter can pass 1 between two polls
        _wait_for(lambda: server.speculated >= 1, timeout=15,
                  what="speculative dispatch")
        # the backup's result arrives first and its apply RAISES; a
        # surviving copy (the owner's, or a re-speculated backup) must
        # then land the job exactly once
        _wait_for(lambda: not armed["fail"], timeout=15,
                  what="transient apply failure")
        wedge.set()
        _wait_for(lambda: ("apply", "slow") in master.events,
                  timeout=15, what="surviving copy applies")
        assert master.applied.count(("slow", ca.sid)) == 1, \
            "the job applies exactly once, under the owner"
        assert server.updates_applied == 2, "seed + slow"
    finally:
        wedge.set()
        server.stop()
        server._done.wait(10)
        ta.join(10)
        if tb is not None:
            tb.join(10)




# -- seeded preempt/rejoin soak smoke (tier-1) ----------------------------


@pytest.mark.chaos
def test_soak_smoke_three_preempt_rejoin_cycles_bit_identical():
    """The 60 s smoke variant of the preemption soak
    (scripts/elastic_soak.py runs the hour-scale SIGKILL version under
    ``slow``): three seeded die/rejoin cycles while training — every
    death requeues, every rejoin reshards at a bumped membership
    epoch, and the final master weights are bit-identical to the
    fault-free run."""
    master_ref = build("master", "elastic_soak_m",
                        max_epochs=4)
    slave_ref = build("slave", "elastic_soak_s",
                       max_epochs=4)
    server_ref, _ = start_server(master_ref)
    client_ref = Client("127.0.0.1:%d" % server_ref.port, slave_ref)
    client_ref.run()
    assert server_ref._done.wait(60)
    ref_weights = weights(master_ref)
    ref_metrics = list(master_ref.decision.epoch_metrics)

    master = build("master", "elastic_soak_m",
                    max_epochs=4)
    slave = build("slave", "elastic_soak_s", max_epochs=4)
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    plan = chaos.install(
        FaultPlan(seed=11)
        .add("client.job", "die", nth=2)
        .add("client.job", "die", nth=6)
        .add("client.job", "die", nth=11))
    try:
        client.run()
    finally:
        chaos.uninstall()
    # wide deterministic window: the run ends by event; under full-
    # suite load the fault-free 15 s bound tripped (PR 12's reshard-
    # race flake) while solo runs finish in ~3 s
    assert server._done.wait(90)

    assert plan.fired("client.job") == 3, "three seeded preemptions"
    assert client.sessions_established == 4, "three rejoins"
    assert bool(master.decision.complete)
    # 4 joins + 3 mid-run leaves = 7 membership changes, 7 reshards
    assert server.reshards >= 7
    assert server.fleet.membership_epoch >= 7
    assert master.loader.total_failed >= 3
    assert list(master.decision.epoch_metrics) == ref_metrics
    for got, want in zip(weights(master), ref_weights):
        numpy.testing.assert_array_equal(got, want)
    snap = fleet_snapshot()
    assert snap["membership_epoch"] >= 7


@pytest.mark.chaos
def test_kill_during_reshard_never_double_applies():
    """Acceptance: a slave connection severed DURING a reshard push
    (the rejoin reshard after a mid-run death).  Its requeued work
    replays after the next rejoin; no update is double-applied —
    final weights bit-identical to the fault-free run."""
    master_ref = build("master", "elastic_krr_m")
    slave_ref = build("slave", "elastic_krr_s")
    server_ref, _ = start_server(master_ref)
    client_ref = Client("127.0.0.1:%d" % server_ref.port, slave_ref)
    client_ref.run()
    assert server_ref._done.wait(60)
    ref_weights = weights(master_ref)
    ref_applied = server_ref.updates_applied

    master = build("master", "elastic_krr_m")
    slave = build("slave", "elastic_krr_s")
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    # die on job 3 -> rejoin -> the JOIN reshard push (2nd hit of the
    # per-slave push point) kills the conn mid-push -> rejoin again
    plan = chaos.install(
        FaultPlan(seed=7)
        .add("client.job", "die", nth=3)
        .add("server.reshard", "kill", nth=2))
    try:
        client.run()
    finally:
        chaos.uninstall()
    # wide deterministic window (see the soak smoke above): the rejoin
    # backoff after the mid-reshard kill stretches under suite load
    assert server._done.wait(90)

    assert plan.fired("server.reshard") == 1, \
        "the kill-during-reshard must actually fire"
    assert client.sessions_established >= 3
    assert bool(master.decision.complete)
    assert server.updates_applied == ref_applied, \
        "same number of applies as fault-free: nothing doubled, " \
        "nothing lost"
    for got, want in zip(weights(master), ref_weights):
        numpy.testing.assert_array_equal(got, want)

# -- the SIGKILL subprocess soak (slow tier) ------------------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_preemption_soak_sigkill_subprocess_receipt(tmp_path):
    """scripts/torch_elastic_soak.py SIGKILLs real slave subprocesses
    (``python -m veles_tpu_torch ... -m``) on a seeded
    ``slave.preempt`` schedule, respawns them after seeded
    ``slave.rejoin_after`` delays, and the soaked master ends
    bit-identical to the fault-free run; the kill-during-reshard case
    double-applies nothing."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "soak.json"
    proc = subprocess.run(
        [sys.executable,
         os.path.join(repo, "scripts", "torch_elastic_soak.py"),
         "--out", str(out), "--seed", "42", "--preempts", "3",
         "--max-epochs", "4", "-d", "cpu", "--workdir", str(tmp_path)],
        cwd=repo, timeout=1200, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    receipt = json.loads(out.read_text())
    assert receipt["bit_identical"] is True
    assert receipt["events_total"] >= 6
    assert receipt["soak"]["preempts"] >= 3
    assert receipt["soak"]["reshards"] >= 6
    assert receipt["throughput"]["within_bound"] is True
    assert receipt["kill_during_reshard"]["double_applies"] == 0
    assert receipt["kill_during_reshard"]["bit_identical"] is True
    assert receipt["merged_trace"]["slave_spans"] > 0


# -- reshard plumbing through workflow + loader ---------------------------


def test_workflow_forwards_reshard_to_loader():
    sw = build("slave", "elastic_plumb")
    info = {"epoch": 5, "share": 128, "fleet": 3, "remaining": 320}
    sw.apply_reshard(info)
    assert sw.fleet_info_ == info
    assert sw.loader.fleet_share == 128
    assert sw.loader.fleet_epoch == 5


def test_loader_unserved_remainder_tracks_epoch_progress():
    sw = build("standalone", "elastic_remainder",
                max_epochs=1)
    loader = sw.loader
    total = loader.effective_total_samples
    # before anything is served: the whole class window is unserved
    assert loader.unserved_remainder() == total
    assert sw.unserved_remainder() == total
    sw.run()
    # after a run the loader sits mid-epoch (the completion cycle
    # serves into the next epoch before end_point): still a sane,
    # positive remainder within the class window
    assert 0 < loader.unserved_remainder() <= total
    # mid-epoch arithmetic (no serving needed: pure accounting)
    loader.samples_served = total + 70
    assert loader.unserved_remainder() == total - 70


# -- reshard-failure rejoin + mesh-epoch stamping -------------------------


class _HookFailSlave(_StubSlave):
    """apply_reshard raises on the FIRST push only — the stale-
    elasticity-state shape the sever-and-rejoin contract covers."""

    def __init__(self, *args, **kwargs):
        super(_HookFailSlave, self).__init__(*args, **kwargs)
        self.failures_left = 1

    def apply_reshard(self, info):
        if self.failures_left:
            self.failures_left -= 1
            raise RuntimeError("loader cannot adopt the new window")
        super(_HookFailSlave, self).apply_reshard(info)


def test_reshard_hook_failure_severs_and_rejoins_at_fresh_epoch():
    """Regression for the log-and-continue swallow: a failed
    ``apply_reshard`` hook leaves the slave on stale elasticity state,
    so the client must sever the session and rejoin at a fresh
    membership epoch — counted in ``elastic.reshard_failures``."""
    before = _registry.counter("elastic.reshard_failures").value
    master = _StubMaster([], remainder=100)
    server, _ = _stub_server(master)
    wf = _HookFailSlave()
    client = Client("127.0.0.1:%d" % server.port, wf)
    thread = client.start_background()
    try:
        # first join push fails the hook -> sever -> reconnect; the
        # rejoin bumps the epoch past the leave and the replayed push
        # lands on a hook that now works
        _wait_for(lambda: wf.reshards, what="post-rejoin reshard push")
        _wait_for(lambda: client.sessions_established >= 2,
                  what="fresh handshake after the sever")
        assert wf.failures_left == 0
        assert _registry.counter("elastic.reshard_failures").value \
            == before + 1
        # join(1) + leave(2) + rejoin(3): the recorded epoch is FRESH
        assert wf.reshards[-1]["epoch"] >= 3
        assert client.member_epoch >= 3
    finally:
        server.stop()
        server._done.wait(10)
        thread.join(10)


def test_reshard_frame_carries_mesh_epoch():
    """A master training through a MeshManager stamps its device-mesh
    epoch into reshard frames so slaves can correlate membership churn
    with the train-state reshard it produced."""

    class _MeshStub(object):
        mesh_epoch = 7

    master = _StubMaster([], remainder=100)
    server, _ = _stub_server(master)
    server.mesh_manager = _MeshStub()
    wf = _StubSlave()
    client = Client("127.0.0.1:%d" % server.port, wf)
    thread = client.start_background()
    try:
        _wait_for(lambda: wf.reshards, what="join reshard push")
        assert wf.reshards[-1]["mesh_epoch"] == 7
        assert client.mesh_epoch == 7
    finally:
        server.stop()
        server._done.wait(10)
        thread.join(10)




# -- solver-state delta shipping (momentum through respawn) ---------------


def test_gd_units_ship_solver_state_deltas():
    """The PR-9 caveat closed: gd units ship canonical solver
    accumulators with each job and merge the slave's accumulator
    deltas additively — the same master-slave contract params ride —
    so a respawned slave replays momentum runs bit-faithfully
    (receipted at soak scale in ELASTIC.json)."""
    master = build("master", "elastic_accum_m")
    slave = build("slave", "elastic_accum_s")
    gd_m, gd_s = master.gds[0], slave.gds[0]
    gd_m.accum_weights.map_invalidate()
    gd_m.accum_weights.mem[:] = 0.25
    payload = gd_m.generate_data_for_slave()
    assert numpy.all(payload["accum_weights"] == 0.25)
    assert "accum_bias" in payload

    gd_s.apply_data_from_master(payload)
    gd_s.accum_weights.map_read()
    assert numpy.all(gd_s.accum_weights.mem == 0.25)
    # the slave trains: its accums move; the delta is what ships back
    gd_s.accum_weights.map_write()
    gd_s.accum_weights.mem += 1.0
    delta = gd_s.generate_data_for_master()
    assert numpy.allclose(delta["accum_weights"], 1.0)
    assert numpy.allclose(delta["accum_bias"], 0.0)

    gd_m.apply_data_from_slave(delta)
    gd_m.accum_weights.map_read()
    assert numpy.allclose(gd_m.accum_weights.mem, 1.25)


# -- snapshots of a master; slaves never restore -----------------------------


def test_master_pickle_requeues_every_slaves_records_like_jax():
    """A master's loader pickled mid-run moves each slave's served but
    unapplied records into ``failed_minibatches`` (newest first), as the
    JAX package's does, so a restored master serves them again."""
    from tests.test_torch_network import _jax_build
    from veles_tpu.server import SlaveDescription as JaxSlave
    from veles_tpu_torch.server import SlaveDescription
    jax_master = _jax_build("master", "pickle_m")
    port_master = build("master", "pickle_m")
    for sid in ("s1", "s1", "s2"):
        jax_master.generate_data_for_slave(JaxSlave(sid, sid, 0, 1.0))
        port_master.generate_data_for_slave(
            SlaveDescription(sid, sid, 0, 1.0))
    want = jax_master.loader.__getstate__()["failed_minibatches"]
    got = port_master.loader.__getstate__()["failed_minibatches"]
    assert len(got) == 3
    assert [tuple(int(v) for v in r) for r in got] == \
        [tuple(int(v) for v in r) for r in want]
    # the live loader keeps its records: a pickle does not requeue them
    assert port_master.loader.pending_minibatches_count == 3


def test_slave_never_restores_a_snapshot(monkeypatch):
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.snapshotter import SnapshotterBase
    calls = []
    monkeypatch.setattr(SnapshotterBase, "resolve_resume",
                        staticmethod(lambda spec: calls.append(spec)))
    saved = root.common.snapshot.get("resume")
    root.common.snapshot.update({"resume": "auto"})
    try:
        Launcher(master_address="127.0.0.1:1")._maybe_resume()
        assert calls == []
        launcher = Launcher(listen_address="127.0.0.1:1")
        launcher._maybe_resume()  # a master restores
        assert calls == ["auto"]
    finally:
        root.common.snapshot.update({"resume": saved or ""})
