#!/usr/bin/env python3
"""The multi-host serve tier on the card: a host kill, the rejoin and
the hedge A/B, with serve hosts as subprocesses.

    python3 scripts/torch_fleet_soak.py [--fast] [--tenants] [--out PATH]
    python3 scripts/torch_fleet_soak.py --host --spec SPEC --host-id ID \\
        [--ladder 1,8] [-d cuda]

Counterpart of ``scripts/fleet_soak.py``.  The driver builds VGG16
(config "D", seed 0, 224x224x3, 1,000 classes), calibrates and
quantizes it to int8 on 64 seeded samples, exports the spec once
(``freshness.export_model_spec``) and runs an in-process ``FleetRouter``
over two host subprocesses on the card, each started in ``--host``
mode: the exported spec loaded (manifest-verified), its ladder captured,
then a batcher behind ``BinaryTransportServer(host_meta=...)`` on a
port of its own, announced by the serve command's line
``FLEET_HOST_READY port=... host_id=... digest=... new_compiles=...
kernel_builds=... captures=...``.  At SIGTERM a host prints
``FLEET_HOST_STOPPED host_id=... launches={...}``: the kernel launches
it served, graph replays included.  Every host is armed with seeded
``serve.host.stall`` on a share of its frames (``VELES_CHAOS``; the
stall size and share are ``scripts/fleet_soak.py``'s).

The legs, every answer held bit for bit against the in-process
``engine.infer`` of the same spec:

- **correctness**, one request at a time: the 64 seeded samples twice
  as singles (rung 1), then 100 blocks of 8 rows (rung 8), each
  request's latency on the host clock;
- **kill**: 8 closed-loop clients, hedging off; after a seeded count of
  answers one host is sent SIGKILL while it holds a stalled request
  (which no sibling copy can answer); none may fail, the
  requeues rise, the membership epoch rises at the leave; the host
  restarts, its hello must read ``kernel_builds`` 0 and one capture a
  rung, and the epoch rises again at the rejoin;
- **lose_race**: a hedging router with chaos ``serve.hedge.lose_race``:
  the duplicate fence drops at least one late result, none is answered
  twice;
- **hedge A/B**: the same closed loop with hedging off, then on;
- the telemetry polls' clock offsets, the rollup buckets and the
  router's alerts.

``--fast`` is ``chip_smoke.py``'s ``fleet:`` profile (6 s kill window, 4
s legs); the full profile runs 20 s and 10 s.  ``--tenants`` adds the
QoS flood: a best-effort storm and interactive clients through a
``max_inflight``-bounded front with per-class hedge budgets.  The
receipt is printed (and written to ``--out``) with the card's name and
power limit.  Needs a CUDA card.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy  # noqa: E402

SHAPE = (224, 224, 3)
LADDER = (1, 8)
#: each host's stall: 5 % of its frames park 150 ms (scripts/fleet_soak.py)
STALL = "seed=%d;serve.host.stall=stall:p0.05:0.15"
#: blocks of 8 rows sent one at a time in the correctness leg
BLOCKS = 100
#: the front's counters each leg reports the change of
COUNTERS = ("serve.fleet.requests", "serve.fleet.failed",
            "serve.fleet.requeues", "serve.fleet.cascades",
            "serve.hedge.fired", "serve.hedge.wins",
            "serve.hedge.duplicates_dropped", "serve.fleet.shed",
            "serve.hedge.budget_exhausted",
            "serve.tenant.interactive.shed", "serve.tenant.batch.shed",
            "serve.tenant.best_effort.shed")


# -- the host -----------------------------------------------------------------


def host_main(args):
    """One serve host: the exported spec on the card as a pool of one
    replica, behind the serve command's fleet-host listener
    (``serve.__main__._fleet_host_main``: the READY line, SIGTERM, the
    launch line)."""
    from veles_tpu_torch.serve import ReplicaPool
    from veles_tpu_torch.serve.__main__ import _fleet_host_main
    from veles_tpu_torch.serve.freshness import SPEC_KEYS
    from veles_tpu_torch.snapshotter import SnapshotterBase
    spec = SnapshotterBase.import_file(args.spec, fallback=False)
    if not isinstance(spec, dict) or not SPEC_KEYS <= set(spec):
        raise SystemExit("%s is not an exported model spec" % args.spec)
    pool = ReplicaPool(spec["plans"], spec["params"], spec["sample_shape"],
                       replicas=1, backend=args.device,
                       ladder=tuple(int(b) for b in args.ladder.split(",")),
                       max_delay_s=args.max_delay_ms / 1e3, max_queue=4096)
    receipt = pool.compile()
    args.transport_port, args.tenant_quota = 0, None
    return _fleet_host_main(args, pool, receipt)


def parse_fields(line):
    """``key=value`` fields of a READY or STOPPED line."""
    fields = {}
    for item in line.split()[1:]:
        key, _, value = item.partition("=")
        fields[key] = value
    return fields


class HostProc(object):
    """A serve-host subprocess: ``--host`` of this script, or any
    command that prints the READY line (``python -m
    veles_tpu_torch.serve --fleet-host``)."""

    def __init__(self, host_id, argv, chaos_spec=None, log_dir=None,
                 series_interval_s=0.5):
        env = dict(os.environ, PYTHONPATH=ROOT,
                   VELES_SERIES_INTERVAL_S=str(series_interval_s))
        env.pop("VELES_CHAOS", None)
        env.pop("VELES_BACKEND", None)
        if chaos_spec:
            env["VELES_CHAOS"] = chaos_spec
        self.host_id = host_id
        self.ready = None
        self.stopped = None
        self.lines = []
        self._ready_event = threading.Event()
        log_dir = log_dir or tempfile.gettempdir()
        self.log_path = os.path.join(log_dir, "host_%s_%d.log"
                                     % (host_id, int(time.time() * 1e3)))
        self._log = open(self.log_path, "w")
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE, stderr=self._log,
            text=True, cwd=ROOT)
        self._reader = threading.Thread(target=self._read,
                                        name="host-%s-stdout" % host_id)
        self._reader.start()

    @classmethod
    def soak_host(cls, host_id, spec, ladder=LADDER, device="cuda",
                  **kwargs):
        argv = [sys.executable, os.path.abspath(__file__), "--host",
                "--spec", spec, "--host-id", host_id, "--ladder",
                ",".join(str(b) for b in ladder), "-d", device]
        return cls(host_id, argv, **kwargs)

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("FLEET_HOST_READY") and self.ready is None:
                self.ready = parse_fields(line)
                self.ready["start_s"] = time.perf_counter() - self.started
                self._ready_event.set()
            elif line.startswith("FLEET_HOST_STOPPED"):
                fields = parse_fields(line)
                self.stopped = json.loads(line.split("launches=", 1)[1])
                self.stopped_id = fields.get("host_id")
        self._ready_event.set()

    def wait_ready(self, timeout=300.0):
        """The READY fields; raises with the host's log tail when it
        died or timed out first."""
        self._ready_event.wait(timeout)
        if self.ready is None:
            self.kill()
            with open(self.log_path) as fin:
                tail = fin.read()[-4000:]
            raise RuntimeError("host %s never came up (exit %s):\n%s"
                               % (self.host_id, self.proc.poll(), tail))
        return self.ready

    @property
    def address(self):
        return "127.0.0.1:%s" % self.ready["port"]

    def kill(self):
        """SIGKILL (a host death mid-stream), wait, close."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._close()

    def stop(self, timeout=60.0):
        """SIGTERM, wait; returns the launches the host reported (None
        when it reported none)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._close()
        return self.stopped

    def _close(self):
        self._reader.join(30)
        if not self._log.closed:
            self._log.close()


# -- the driver ---------------------------------------------------------------


def closed_loop(router, x, want, clients, duration_s, on_ok=None,
                slo_class=None, stop_early=None):
    """``clients`` threads sending single samples back to back through
    the router for ``duration_s``; every answer held bit for bit against
    ``want``.  Returns latencies (ms), failures, mismatches, sent."""
    stop_at = time.perf_counter() + duration_s
    out = {"latencies_ms": [], "failures": [], "mismatches": 0,
           "sent": 0, "answered": 0}
    lock = threading.Lock()

    def client(k):
        n = 0
        while time.perf_counter() < stop_at and \
                not (stop_early is not None and stop_early.is_set()):
            idx = (k * 131 + n) % len(x)
            n += 1
            t0 = time.perf_counter()
            with lock:
                out["sent"] += 1
            try:
                got = router.infer(x[idx], timeout=60.0,
                                   slo_class=slo_class)
            except Exception as exc:  # every failure counts
                with lock:
                    out["failures"].append("%s: %s"
                                           % (type(exc).__name__, exc))
                continue
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                out["answered"] += 1
                out["latencies_ms"].append(ms)
                if not (got == want[idx]).all():
                    out["mismatches"] += 1
            if on_ok is not None:
                on_ok()

    threads = [threading.Thread(target=client, args=(k,),
                                name="fleet-client-%d" % k)
               for k in range(clients)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(duration_s + 120)
    if any(thread.is_alive() for thread in threads):
        raise RuntimeError("a fleet client did not finish")
    return out


def stalled_copies(router, host_id, age_s=0.06):
    """The router's copies on ``host_id`` sent at least ``age_s`` ago:
    past any unstalled service time, so parked in the host's
    ``serve.host.stall`` (reads the router's wire map under its lock)."""
    now = time.perf_counter()
    with router._lock:
        return sum(1 for copy in router._wire.values()
                   if copy.host_id == host_id and
                   now - copy.sent_at >= age_s)


def percentiles(times_ms):
    if not times_ms:
        return {"n": 0}
    return {"n": len(times_ms),
            "p50": float(numpy.percentile(times_ms, 50)),
            "p95": float(numpy.percentile(times_ms, 95)),
            "p99": float(numpy.percentile(times_ms, 99)),
            "max": float(numpy.max(times_ms))}


def counters():
    from veles_tpu_torch.observe.metrics import registry
    return {name: registry.counter(name).value for name in COUNTERS}


def delta(before):
    return {k: v - before[k] for k, v in counters().items()
            if v != before[k]}


def _leg(result, moved):
    return {"requests": result["answered"], "sent": result["sent"],
            "failed": len(result["failures"]),
            "failed_detail": result["failures"][:3],
            "mismatched": result["mismatches"],
            "latency_ms": percentiles(result["latencies_ms"]),
            "counters": moved}


def _router(**kwargs):
    from veles_tpu_torch.serve import FleetRouter
    kwargs.setdefault("hedge_factor", 2.0)
    kwargs.setdefault("hedge_floor_s", 0.05)
    kwargs.setdefault("hedge_tick_s", 0.01)
    return FleetRouter(**kwargs).start()


def run_soak(spec_path, x, want, fast=False, seed=11, ladder=LADDER,
             clients=8, log=print, log_dir=None, device="cuda"):
    """The kill, rejoin, lose_race and hedge A/B legs over two host
    subprocesses of ``spec_path``; ``want`` is the in-process
    ``engine.infer(x)``.  Returns the receipt (its ``checks`` the hard
    conditions)."""
    from veles_tpu_torch import chaos
    from veles_tpu_torch.observe.timeseries import fleet_summary
    kill_s, leg_s, race_s = (6.0, 4.0, 2.0) if fast else (20.0, 10.0, 5.0)
    kill_after = 40 if fast else 150
    receipt = {"mode": "fast" if fast else "full", "seed": seed,
               "ladder": list(ladder), "clients": clients,
               "straggler_chaos": STALL % seed +
               " (per host, seed + 100 (i + 1))"}

    def host(i):
        return HostProc.soak_host("h%d" % i, spec_path, ladder, device,
                                  chaos_spec=STALL % (seed + 100 * (i + 1)),
                                  log_dir=log_dir)

    t0 = time.perf_counter()
    hosts = [host(0), host(1)]
    killed, routers = [], []
    try:
        ready = [h.wait_ready() for h in hosts]
        receipt["host_start_s"] = [r["start_s"] for r in ready]
        receipt["hosts_ready_s"] = time.perf_counter() - t0
        receipt["ready"] = [{k: v for k, v in r.items() if k != "port"}
                            for r in ready]
        log("fleet: hosts ready %s" % json.dumps(receipt["ready"]))
        # hedging off on the main router: a request stalled on the host
        # that dies has no sibling copy, so the kill provably orphans it
        router = _router(hedge=False, telemetry_interval_s=0.5)
        routers.append(router)
        for h in hosts:
            router.add_host(address=h.address, host_id=h.host_id)

        # -- correctness, one request at a time: every sample twice as a
        # single (rung 1), then blocks of 8 rows (rung 8) ----------------
        t0 = time.perf_counter()
        equal, rung_ms = True, {"1": [], "8": []}
        for i in range(2 * len(x)):
            start = time.perf_counter()
            got = router.infer(x[i % len(x)], timeout=120.0)
            rung_ms["1"].append((time.perf_counter() - start) * 1e3)
            equal = equal and bool((got == want[i % len(x)]).all())
        for i in range(BLOCKS):
            rows = slice(8 * (i % (len(x) // 8)), 8 * (i % (len(x) // 8) + 1))
            start = time.perf_counter()
            got = router.infer_block(x[rows], timeout=120.0)
            rung_ms["8"].append((time.perf_counter() - start) * 1e3)
            equal = equal and bool((got == want[rows]).all())
        receipt["correctness"] = {
            "answers": 2 * len(x) + BLOCKS, "bit_equal": equal,
            "rung_ms": {k: percentiles(v) for k, v in rung_ms.items()},
            "seconds": time.perf_counter() - t0}

        # -- kill h0 mid-stream, restart it, rejoin --------------------------
        state = {"answers": 0, "killed": None, "thread": None,
                 "epoch_before": router.fleet.membership_epoch}
        lock = threading.Lock()

        def rejoin():
            t_rejoin = time.perf_counter()
            new = host(0)
            hosts[0] = new
            try:
                fields = new.wait_ready()
                router.add_host(address=new.address, host_id="h0")
            except Exception as exc:
                state["rejoin_error"] = repr(exc)
                return
            state["rejoin"] = {
                "kernel_builds": int(fields["kernel_builds"]),
                "captures": int(fields["captures"]),
                "new_compiles": int(fields["new_compiles"]),
                "digest": fields["digest"],
                "start_s": fields["start_s"],
                "rejoin_s": time.perf_counter() - t_rejoin,
                "epoch": router.fleet.membership_epoch,
                "hello": router.compile_receipt["hosts"].get("h0")}

        def on_ok():
            with lock:
                state["answers"] += 1
                if state["answers"] != kill_after:
                    return
            # mid-stream: pull the trigger once h0 holds a stalled
            # request (a reply already written but not yet read would
            # resolve after the kill and orphan nothing)
            deadline = time.monotonic() + 5.0
            while not stalled_copies(router, "h0") and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            state["stalled_at_kill"] = stalled_copies(router, "h0")
            state["inflight_at_kill"] = router.snapshot()["hosts"].get(
                "h0", {}).get("inflight")
            state["killed"] = time.perf_counter()
            killed.append(hosts[0])
            hosts[0].kill()
            deadline = time.monotonic() + 30
            while router.snapshot()["hosts_live"] > 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            state["epoch_at_leave"] = router.fleet.membership_epoch
            state["thread"] = threading.Thread(target=rejoin,
                                               name="fleet-rejoin")
            state["thread"].start()

        before = counters()
        result = closed_loop(router, x, want, clients, kill_s,
                             on_ok=on_ok)
        if state["thread"] is not None:
            state["thread"].join(300)
        kill = _leg(result, delta(before))
        kill.update(
            host_killed=state["killed"] is not None,
            inflight_at_kill=state.get("inflight_at_kill"),
            stalled_at_kill=state.get("stalled_at_kill"),
            epoch_before=state["epoch_before"],
            epoch_at_leave=state.get("epoch_at_leave"),
            rejoin=state.get("rejoin"),
            rejoin_error=state.get("rejoin_error"))
        receipt["kill"] = kill

        # -- the duplicate fence under serve.hedge.lose_race, on a hedging
        # router of its own over the same hosts ------------------------------
        race = _router(hedge_floor_s=0.03, hedge_tick_s=0.005,
                       telemetry_interval_s=0)
        routers.append(race)
        for h in hosts:
            race.add_host(address=h.address, host_id=h.host_id)
        for row in x[:race.hedge_warmup]:  # the hedge's evidence
            race.infer(row, timeout=120.0)
        chaos.install(chaos.FaultPlan(seed=seed).add(
            "serve.hedge.lose_race", "skip"))
        try:
            before = counters()
            result = closed_loop(race, x, want, clients, race_s)
            deadline = time.monotonic() + 5.0
            while not delta(before).get("serve.hedge.duplicates_dropped") \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            chaos.uninstall()
            race.stop()
        receipt["lose_race"] = _leg(result, delta(before))

        # -- telemetry: offsets, rollup, alerts ------------------------------
        time.sleep(1.2)  # one more poll round after the traffic
        cells = router.fleet_rollup()
        summary = fleet_summary(cells)
        receipt["telemetry"] = {
            "offsets_s": {h: router.telemetry.offset(h)
                          for h in ("h0", "h1")},
            "rollup_buckets": len(cells),
            "hosts_in_rollup": sorted({h for c in cells
                                       for h in c.get("hosts", ())}),
            "requests_in_rollup": summary.get("counters", {}).get(
                "serve.requests", {}).get("delta"),
            "alerts": router.alerts.snapshot(),
            "snapshot": router.snapshot()["telemetry"]}
        receipt["fleet"] = {k: v for k, v in router.snapshot().items()
                            if k not in ("telemetry", "alerts")}
        router.stop()

        # -- the hedge A/B ---------------------------------------------------
        legs = {}
        for name, hedge in (("off", False), ("on", True)):
            router = _router(hedge=hedge, hedge_floor_s=0.03,
                             hedge_tick_s=0.005, telemetry_interval_s=0)
            routers.append(router)
            for h in hosts:
                router.add_host(address=h.address, host_id=h.host_id)
            for row in x[:router.hedge_warmup]:  # the hedge's evidence
                router.infer(row, timeout=120.0)
            before = counters()
            legs[name] = _leg(closed_loop(router, x, want, clients, leg_s),
                              delta(before))
            router.stop()
        p99 = {k: legs[k]["latency_ms"].get("p99") for k in legs}
        receipt["hedge_ab"] = {
            "off": legs["off"], "on": legs["on"],
            "hedges_fired": legs["on"]["counters"].get(
                "serve.hedge.fired", 0),
            "hedge_wins": legs["on"]["counters"].get("serve.hedge.wins", 0),
            "duplicates_dropped": legs["on"]["counters"].get(
                "serve.hedge.duplicates_dropped", 0),
            "p99_cut_pct": (100.0 * (p99["off"] - p99["on"]) / p99["off"]
                            if p99["off"] and p99["on"] else None)}
    finally:
        for router in routers:
            router.stop()
        stops = {}
        for h in hosts:
            stops[h.host_id] = h.stop()
        for h in killed:
            h.kill()
    receipt["launches"] = stops
    receipt["launches_killed_host"] = "lost: the first h0 was sent SIGKILL"
    rejoin = receipt["kill"].get("rejoin") or {}
    race = receipt["lose_race"]
    receipt["checks"] = checks = {
        "same_digest": len({r["digest"] for r in receipt["ready"]}) == 1,
        "kernel_builds_0": all(int(r["kernel_builds"]) == 0
                               for r in receipt["ready"]),
        "captures_per_rung": all(int(r["captures"]) == len(ladder)
                                 for r in receipt["ready"]),
        "bit_equal": receipt["correctness"]["bit_equal"] and
        all(leg["mismatched"] == 0 for leg in (
            receipt["kill"], race, legs["off"], legs["on"])),
        "zero_failed": all(leg["failed"] == 0 for leg in (
            receipt["kill"], race, legs["off"], legs["on"])),
        "host_killed_mid_stream": receipt["kill"]["host_killed"] and
        bool(receipt["kill"]["stalled_at_kill"]),
        "requeued": receipt["kill"]["counters"].get(
            "serve.fleet.requeues", 0) >= 1,
        "epoch_rose_at_leave": receipt["kill"]["epoch_at_leave"] ==
        receipt["kill"]["epoch_before"] + 1,
        "rejoined_kernel_builds_0": rejoin.get("kernel_builds") == 0,
        "rejoined_after_captures": rejoin.get("captures") == len(ladder)
        and (rejoin.get("hello") or {}).get("captures") == len(ladder),
        "epoch_rose_at_rejoin": rejoin.get("epoch") ==
        receipt["kill"]["epoch_before"] + 2,
        "duplicate_dropped": race["counters"].get(
            "serve.hedge.duplicates_dropped", 0) >= 1,
        "answered_once": race["requests"] + race["failed"] == race["sent"],
        "host_launches_reported": all(
            (stops.get(h) or {}).get("matmul_int8", 0) > 0
            for h in ("h0", "h1")),
    }
    receipt["passed"] = all(checks.values())
    return receipt


def run_tenant_soak(spec_path, x, want, fast=False, seed=11,
                    ladder=LADDER, log_dir=None, device="cuda"):
    """The QoS flood: interactive clients beside a 3x best-effort storm
    through a ``max_inflight``-bounded front with per-class hedge
    budgets, both hosts stalling.  Interactive must shed nothing and
    fail nothing."""
    from veles_tpu_torch.serve import HedgeBudget
    duration = 6.0 if fast else 20.0
    clients = 3 if fast else 4
    hosts = [HostProc.soak_host("q%d" % i, spec_path, ladder, device,
                                chaos_spec=STALL % (seed + 100 * (i + 1)),
                                log_dir=log_dir) for i in range(2)]
    router = None
    try:
        for h in hosts:
            h.wait_ready()
        router = _router(hedge_budget=HedgeBudget(),
                         max_inflight=4 * clients, telemetry_interval_s=0)
        for h in hosts:
            router.add_host(address=h.address, host_id=h.host_id)
        stop = threading.Event()
        flood = {}

        def storm():
            flood["best_effort"] = closed_loop(
                router, x, want, 3 * clients, duration,
                slo_class="best_effort", stop_early=stop)

        storm_thread = threading.Thread(target=storm, name="fleet-storm")
        before = counters()
        storm_thread.start()
        try:
            interactive = closed_loop(router, x, want, clients, duration,
                                      slo_class="interactive")
        finally:
            stop.set()
            storm_thread.join(duration + 180)
        moved = delta(before)
    finally:
        if router is not None:
            router.stop()
        launches = {h.host_id: h.stop() for h in hosts}
    return {"clients_interactive": clients, "clients_best_effort":
            3 * clients, "duration_s": duration,
            "interactive": _leg(interactive, {}),
            "best_effort": _leg(flood["best_effort"], {}),
            "counters": moved, "launches": launches,
            "passed": moved.get("serve.tenant.interactive.shed", 0) == 0
            and not interactive["failures"]
            and interactive["mismatches"] == 0}


def build_vgg16_int8(device, seed=0):
    """VGG16 (config "D") from ``seed``, calibrated on 64 seeded samples
    and quantized to int8, as ``chip_smoke.py``'s serve phase does:
    (plans, qparams)."""
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.quant import quantize_model_spec
    plans, state, _ = build_plans_and_state(vgg_layers(config="D"), SHAPE,
                                            seed=seed)
    params = [{"weights": s["weights"], "bias": s["bias"]} for s in state]
    del state
    calib = numpy.random.RandomState(1).uniform(
        -1, 1, (64,) + SHAPE).astype(numpy.float32)
    qparams, _ = quantize_model_spec(plans, params, calib, device=device)
    return plans, qparams


def seeded_inputs(n, seed):
    """Inputs on a 1/128 grid (``chip_smoke._tier_inputs``)."""
    rng = numpy.random.RandomState(seed)
    return (rng.randint(-128, 129, (n,) + SHAPE) /
            numpy.float32(128)).astype(numpy.float32)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--host", action="store_true",
                        help="run one serve host (the driver spawns it)")
    parser.add_argument("--spec", help="--host: the exported model spec")
    parser.add_argument("--host-id", default="h0")
    parser.add_argument("--ladder", default="1,8")
    parser.add_argument("-d", "--device", default="cuda",
                        choices=("cuda", "cpu"))
    parser.add_argument("--max-delay-ms", type=float, default=2.0)
    parser.add_argument("--duration", type=float, default=None,
                        help="--host: serve N seconds, then stop")
    parser.add_argument("--fast", action="store_true",
                        help="the smoke's profile (short legs)")
    parser.add_argument("--tenants", action="store_true",
                        help="also run the QoS flood")
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--out", help="also write the receipt here")
    args = parser.parse_args()
    if args.host:
        if not args.spec:
            parser.error("--host needs --spec")
        return host_main(args)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    from veles_tpu_torch.serve import AOTEngine, export_model_spec
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    common.load_kernels()  # the hosts then load the built library
    build_s = time.perf_counter() - t0
    device = Device()
    plans, qparams = build_vgg16_int8(device)
    x = seeded_inputs(64, 5)
    with tempfile.TemporaryDirectory() as workdir:
        spec = export_model_spec(os.path.join(workdir, "vgg16_int8.pickle"),
                                 plans, qparams, SHAPE)
        engine = AOTEngine(plans, qparams, SHAPE, ladder=LADDER,
                           device=device)
        engine.compile()
        want = engine.infer(x)
        del engine
        torch.cuda.empty_cache()
        result = {"card": torch.cuda.get_device_name(0),
                  "nvidia_smi": smi, "build_s": build_s}
        result["soak"] = run_soak(spec, x, want, fast=args.fast,
                                  seed=args.seed, log_dir=workdir)
        if args.tenants:
            result["tenants"] = run_tenant_soak(
                spec, x, want, fast=args.fast, seed=args.seed,
                log_dir=workdir)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            fout.write(text)
    print(smi)
    print(text)
    ok = result["soak"]["passed"] and \
        result.get("tenants", {}).get("passed", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
