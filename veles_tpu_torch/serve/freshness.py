"""Train-to-serve freshness loop: watch, verify, canary, promote.

Counterpart of ``veles_tpu/serve/freshness.py``.
The trainer's snapshotter publishes every manifest-verified snapshot
into a watched directory (:func:`veles_tpu_torch.snapshotter.
publish_snapshot`: an atomic ``LATEST`` pointer, export-ordinal
ordered), and this module carries the model the rest of the way, or
pulls a bad one back out:

- :class:`SnapshotWatcher` polls the publish directory (or is pushed
  through ``POST /publish`` -> :meth:`~SnapshotWatcher.notify`) and
  verifies the manifest before unpickling, so a truncated, torn or
  tampered publish is rejected at the watcher.  A half-written snapshot
  is skipped and retried with bounded backoff; only one that stays
  invalid past ``invalid_ttl_s`` is counted
  ``serve.freshness.poisoned_rejected`` and rejected for good.  A
  publish of either package is served (``SnapshotterBase.import_file``
  maps the JAX package's classes to the port's).
- :class:`CanaryComparator` judges the candidate on mirrored traffic
  with the divergence watchdog's EMA spike rule
  (:class:`veles_tpu_torch.health.EmaSpikeWatch`) on canary-vs-baseline
  latency, an output-divergence bound and a non-finite-output tripwire.
- :class:`FreshnessController` runs the loop: finite-gate the params,
  capture the candidate's engine in the background, enter the pool's
  :class:`~veles_tpu_torch.serve.router.CanaryCutover`, mirror a seeded
  slice of traffic to the canary (shadows are never returned to clients
  nor counted as served), then promote pool-wide or roll back to the
  last good digest (swap-backs only, no new capture).

The watcher also merges a trainer-published ``schedule_bank.json``
(``snapshotter.publish_schedule_bank``) into the kernel schedule cache
(``veles_tpu_torch.tune``) whenever its bytes change and its manifest
verifies; a bank caught mid-replace is retried at the next poll.  A
merged schedule serves from the next reload's captures: rungs already
captured keep the schedules they captured with.

One tier up, :class:`FleetCanaryController` judges a candidate on ONE
host of a :class:`~veles_tpu_torch.serve.fleet.FleetRouter` fleet
(mirrored shadow traffic), staged through each host's
:class:`LocalHostControl`, then promotes host by host or reverts.  The
canary transitions mark ``serve.canary`` tracer instants, and a
poisoned candidate dumps the flight recorder.
"""

import collections
import os
import pickle
import random
import threading
import time

import numpy

from veles_tpu_torch import chaos
from veles_tpu_torch.health import EmaSpikeWatch, all_finite
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe.flight import flight as _flight
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.snapshotter import SnapshotterBase, read_latest

__all__ = ["CanaryComparator", "FleetCanaryController",
           "FreshnessController", "LocalHostControl", "ModelCandidate",
           "SnapshotWatcher", "export_model_spec", "BANK_FILE_NAME"]

#: the schedule bank a trainer may publish beside its snapshots
BANK_FILE_NAME = "schedule_bank.json"

#: keys a published "model spec" pickle must carry (the lightweight
#: alternative to a whole-workflow snapshot: what the serve fleet
#: actually needs, nothing else)
SPEC_KEYS = frozenset(("plans", "params", "sample_shape"))


def export_model_spec(path, plans, params, sample_shape):
    """Write a *model spec* snapshot — ``{"plans", "params",
    "sample_shape"}`` — with the snapshotter's crash-consistency
    contract (tmp -> fsync -> ``os.replace``) and a sidecar manifest,
    so it is publishable via :func:`snapshotter.publish_snapshot` and
    verifiable by the watcher exactly like a whole-workflow snapshot.

    This is the soak/test-sized publish format; real trainers publish
    their workflow snapshots via ``Snapshotter(publish_dir=...)``.
    Honors the ``snapshot.write`` chaos point (``crash`` dies with a
    half-written ``.tmp`` and no final file — the torn-export case the
    loop must survive)."""
    payload = pickle.dumps(
        {"plans": list(plans), "params": [dict(p) for p in params],
         "sample_shape": tuple(sample_shape)},
        protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fout:
        fault = chaos.plan.fire("snapshot.write") \
            if chaos.plan is not None else None
        if fault is not None and fault.action == "crash":
            fout.write(payload[:max(1, len(payload) // 2)])
            fout.flush()
            raise chaos.ChaosCrash("simulated crash mid-spec-export")
        fout.write(payload)
        fout.flush()
        os.fsync(fout.fileno())
    os.replace(tmp, path)
    SnapshotterBase.write_manifest(path, workflow_name="ModelSpec")
    return path


class ModelCandidate(object):
    """One verified, loaded publish: what the controller judges."""

    __slots__ = ("ordinal", "path", "sha256", "plans", "params",
                 "sample_shape")

    def __init__(self, ordinal, path, sha256, plans, params,
                 sample_shape):
        self.ordinal = ordinal
        self.path = path
        self.sha256 = sha256
        self.plans = plans
        self.params = params
        self.sample_shape = sample_shape


class SnapshotWatcher(Logger):
    """Poll (or be pushed) the publish directory; hand VERIFIED
    candidates to a callback.

    Failure discipline: a half-written snapshot or
    transient manifest mismatch — a publisher mid-copy, an NFS rename
    still settling — is skipped and retried with bounded exponential
    backoff, logged at debug so a poll tick never warn-spams; only an
    ordinal that stays invalid past ``invalid_ttl_s`` is escalated:
    ONE warning, ``serve.freshness.
    poisoned_rejected`` + permanent rejection of that ordinal (a newer
    publish supersedes it the moment it lands)."""

    def __init__(self, watch_dir, callback=None, poll_s=0.25,
                 invalid_ttl_s=10.0, max_backoff_s=2.0,
                 default_sample_shape=None, **kwargs):
        super(SnapshotWatcher, self).__init__(**kwargs)
        self.watch_dir = watch_dir
        self.callback = callback
        self.poll_s = float(poll_s)
        self.invalid_ttl_s = float(invalid_ttl_s)
        self.max_backoff_s = float(max_backoff_s)
        self.default_sample_shape = default_sample_shape
        self.last_ordinal = 0
        self._rejected = set()
        self._pending = None  # {"ordinal", "first_bad", "backoff",
        #                        "next_try"}: the skip-and-retry state
        self._bank_stamp = None  # (mtime_ns, size) of the last bank read
        self._bank_pending = None  # the last unverified bank noted
        self._thread = None
        self._stop_ = False
        self._wake = threading.Event()
        self._m_poisoned = _registry.counter(
            "serve.freshness.poisoned_rejected")

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop_ = False
        self._thread = threading.Thread(target=self._loop,
                                        name="freshness-watcher")
        self._thread.start()
        return self

    def stop(self):
        self._stop_ = True
        thread, self._thread = self._thread, None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=30)

    def notify(self, path=None):
        """Push-mode hand-off (``POST /publish``): wake the poll loop
        now instead of waiting out the interval.  ``path`` is advisory
        — the loop still reads LATEST and verifies; a push can never
        bypass the manifest check."""
        if path is not None:
            self.debug("publish push for %s", path)
        self._wake.set()

    def _loop(self):
        while not self._stop_:
            self._wake.wait(timeout=self.poll_s)
            self._wake.clear()
            if self._stop_:
                break
            try:
                self.poll_once()
            except Exception:
                self.exception("freshness watcher poll failed")

    # -- the verify-before-unpickle pickup ----------------------------------

    def poll_once(self):
        """One pickup attempt; returns the accepted
        :class:`ModelCandidate` or None.  Public so push handlers and
        tests can drive the watcher synchronously."""
        self._maybe_merge_bank()
        latest = read_latest(self.watch_dir)
        if latest is None:
            return None
        try:
            ordinal = int(latest.get("ordinal", 0))
        except (TypeError, ValueError):
            return None
        if ordinal <= self.last_ordinal or ordinal in self._rejected:
            return None
        now = time.monotonic()
        pend = self._pending
        if pend is not None and pend["ordinal"] == ordinal and \
                now < pend["next_try"]:
            return None  # inside the backoff window: not even a stat
        path = os.path.join(self.watch_dir, str(latest["snapshot"]))
        ok, detail = SnapshotterBase.verify_snapshot(path)
        cand = None
        if ok is True:
            try:
                cand = self._load(ordinal, path, latest)
            except Exception as exc:
                ok, detail = False, "load failed: %s: %s" % (
                    type(exc).__name__, exc)
        else:
            detail = "manifest: %s" % (detail,)
        if cand is None:
            self._note_invalid(ordinal, path, detail)
            return None
        self.info("publish #%d verified: %s", ordinal, path)
        if self.callback is not None:
            try:
                self.callback(cand)
            except Exception as exc:
                # a TRANSIENT cycle failure (e.g. the candidate warm-up
                # hit RESOURCE_EXHAUSTED) must not consume the ordinal:
                # leave last_ordinal alone and retry with backoff.  The
                # publish itself VERIFIED — escalate=False keeps the
                # TTL from branding a healthy model "poisoned"; it
                # simply keeps retrying at the max backoff until the
                # failure clears or a newer publish supersedes it
                self.exception("freshness cycle for publish #%d failed",
                               ordinal)
                self._note_invalid(ordinal, path,
                                   "cycle failed: %s: %s" %
                                   (type(exc).__name__, exc),
                                   escalate=False)
                return None
        self._pending = None
        self.last_ordinal = ordinal
        return cand

    def _load(self, ordinal, path, latest):
        # verify_snapshot passed above; import_file re-checks the
        # manifest BEFORE unpickling and never cascades to siblings —
        # this publish stands or falls alone
        restored = SnapshotterBase.import_file(path, fallback=False)
        if isinstance(restored, dict) and SPEC_KEYS <= set(restored):
            plans = list(restored["plans"])
            params = [dict(p) for p in restored["params"]]
            shape = tuple(restored["sample_shape"])
        else:
            from veles_tpu_torch.serve.router import ReplicaPool
            try:
                plans, params, shape = ReplicaPool._workflow_spec(
                    restored)
            except ValueError:
                if self.default_sample_shape is None:
                    raise
                plans, params, shape = ReplicaPool._workflow_spec(
                    restored, self.default_sample_shape)
        return ModelCandidate(ordinal, path, latest.get("sha256"),
                              plans, params, shape)

    def _maybe_merge_bank(self):
        """Merge the trainer-published schedule bank
        (:data:`BANK_FILE_NAME` beside the snapshots) into the local
        schedule cache whenever its bytes change: one host's tuning
        serves every replica.  Verified against its manifest BEFORE
        parsing, as snapshots are; a mismatch mid-replace is retried at
        the next poll.  Returns the merge counts dict or None."""
        bank_path = os.path.join(self.watch_dir, BANK_FILE_NAME)
        try:
            stat = os.stat(bank_path)
        except OSError:
            return None
        stamp = (stat.st_mtime_ns, stat.st_size)
        if stamp == self._bank_stamp:
            return None
        ok, detail = SnapshotterBase.verify_snapshot(bank_path)
        if ok is not True:
            # the publisher mid-replace (manifest flipped, bank not
            # yet): leave the stamp unset so that the next poll retries;
            # noted once a version of the file
            if stamp != self._bank_pending:
                self._bank_pending = stamp
                self.debug("%s not (yet) valid (%s); retrying at each "
                           "poll", bank_path, detail)
            return None
        from veles_tpu_torch.tune.cache import cache_for
        try:
            counts = cache_for().merge_bank(bank_path)
        except Exception as exc:
            # consume the stamp: a structurally broken bank must not
            # warn at every poll; the next publish supersedes it
            self._bank_stamp = stamp
            self.warning(
                "schedule bank merge from %s failed (%s: %s); serving "
                "continues on current schedules", bank_path,
                type(exc).__name__, exc)
            return None
        self._bank_stamp = stamp
        self.info(
            "schedule bank merged from %s: %d adopted, %d kept, "
            "%d stale, %d invalid of %d", bank_path,
            counts["adopted"], counts["kept"], counts["stale"],
            counts["invalid"], counts["total"])
        return counts

    def _note_invalid(self, ordinal, path, detail, escalate=True):
        """Record a failed pickup and arm the retry backoff.
        ``escalate=False`` marks a failure that happened AFTER the
        publish verified (a transient controller/cycle failure): it
        retries forever at the max backoff instead of TTL-escalating —
        a healthy model must never be branded poisoned because the
        serve side had a bad minute."""
        now = time.monotonic()
        pend = self._pending
        if pend is None or pend["ordinal"] != ordinal:
            pend = self._pending = {
                "ordinal": ordinal, "first_bad": now,
                "backoff": self.poll_s, "next_try": now + self.poll_s,
                "escalate": escalate}
            # debug, not warning: a publisher mid-copy is NORMAL; the
            # escalation below owns the loud path
            self.debug("publish #%d not (yet) valid (%s); retrying "
                       "with backoff", ordinal, detail)
            return
        pend["escalate"] = pend.get("escalate", True) and escalate
        pend["backoff"] = min(pend["backoff"] * 2, self.max_backoff_s)
        pend["next_try"] = now + pend["backoff"]
        if now - pend["first_bad"] >= self.invalid_ttl_s and \
                not pend["escalate"]:
            if not pend.get("warned"):
                pend["warned"] = True
                self.warning(
                    "publish #%d verified but its freshness cycle "
                    "keeps failing (%.1fs so far: %s); retrying every "
                    "%.1fs until it clears or a newer publish lands",
                    ordinal, now - pend["first_bad"], detail,
                    pend["backoff"])
            return
        if now - pend["first_bad"] >= self.invalid_ttl_s:
            self.warning(
                "publish #%d at %s stayed invalid for %.1fs (%s): "
                "rejecting as poisoned; a newer publish supersedes it",
                ordinal, path, now - pend["first_bad"], detail)
            self._m_poisoned.inc()
            _tracer.instant("serve.canary", cat="serve",
                            phase="poisoned", ordinal=ordinal,
                            reason=str(detail))
            _flight.dump(reason="freshness-poisoned")
            self._rejected.add(ordinal)
            self._pending = None


class CanaryComparator(object):
    """Judge a canary on mirrored (primary, shadow) result pairs.

    Three tripwires, strictest first:

    - **non-finite canary output** — instant rollback verdict (the
      NaN-params snapshot dies here if it somehow
      passed the finite gate);
    - **output divergence** — ``max|primary - shadow|`` above
      ``divergence_limit`` counts a breach (outputs legitimately
      differ between model versions; a *bound* catches "this model
      answers a different question", e.g. weights scaled 50x);
    - **latency** — the live fleet's per-request latencies prime an
      EMA baseline (:meth:`EmaSpikeWatch.observe`) and each shadow
      latency is spike-checked against it — the divergence watchdog's
      discipline pointed at canary-vs-baseline tails.

    ``breach_budget`` breaches -> ``rolled_back``; ``min_mirrors``
    clean pairs -> ``promote``.  One-shot: the verdict latches."""

    def __init__(self, min_mirrors=8, divergence_limit=0.5,
                 latency_spike_factor=10.0, latency_floor_s=0.05,
                 beta=0.5, breach_budget=3):
        self.min_mirrors = int(min_mirrors)
        self.divergence_limit = float(divergence_limit)
        self.breach_budget = int(breach_budget)
        self._lat_watch = EmaSpikeWatch(
            spike_factor=latency_spike_factor,
            spike_floor=latency_floor_s, beta=beta,
            label="canary latency")
        self.pairs = 0
        self.breaches = 0
        self.max_divergence = 0.0
        self.reasons = []
        self.verdict = None

    def add(self, primary_out, shadow_out, primary_latency=None,
            shadow_latency=None):
        """Feed one mirrored pair; returns the latched verdict
        (``"promote"`` / ``"rolled_back"``) or None while undecided."""
        if self.verdict is not None:
            return self.verdict
        if not all_finite(primary_out):
            # a sick BASELINE row is no evidence about the candidate —
            # and NaN would poison the divergence math into silent
            # no-ops (NaN > limit is False forever)
            return None
        self.pairs += 1
        if not all_finite(shadow_out):
            self.reasons.append("non-finite canary output")
            self.verdict = "rolled_back"
            return self.verdict
        div = float(numpy.max(numpy.abs(
            numpy.asarray(primary_out, numpy.float64) -
            numpy.asarray(shadow_out, numpy.float64))))
        self.max_divergence = max(self.max_divergence, div)
        if div > self.divergence_limit:
            self.breaches += 1
            self.reasons.append(
                "output divergence %.4g > %.4g" %
                (div, self.divergence_limit))
        if primary_latency is not None:
            self._lat_watch.observe(primary_latency)
        if shadow_latency is not None:
            spike = self._lat_watch.update(shadow_latency)
            if spike is not None:
                self.breaches += 1
                self.reasons.append(spike)
        if self.breaches >= self.breach_budget:
            self.verdict = "rolled_back"
        elif self.pairs >= self.min_mirrors and self.breaches == 0:
            self.verdict = "promote"
        return self.verdict

    def reason(self):
        return "; ".join(self.reasons[-self.breach_budget:]) \
            or "unspecified"


class FreshnessController(Logger):
    """The loop: watcher pickup -> finite gate -> background AOT warm
    -> canary -> mirrored verdict -> promote or auto-rollback.

    Runs entirely on the watcher thread (one cycle at a time — a
    publish that lands mid-cycle is simply picked up next, newest
    wins).  The controller owns policy; the fleet mechanics live in
    :class:`veles_tpu_torch.serve.router.CanaryCutover`."""

    def __init__(self, pool, watch_dir, poll_s=0.25,
                 invalid_ttl_s=10.0, mirror_fraction=0.25,
                 min_mirrors=8, divergence_limit=0.5,
                 latency_spike_factor=10.0, latency_floor_s=0.05,
                 breach_budget=3, verdict_timeout_s=30.0,
                 probe_idle_s=0.25, finite_gate=True, canary=True,
                 seed=0, **kwargs):
        super(FreshnessController, self).__init__(**kwargs)
        self.pool = pool
        self.mirror_fraction = float(mirror_fraction)
        self.verdict_timeout_s = float(verdict_timeout_s)
        self.probe_idle_s = float(probe_idle_s)
        self.finite_gate = bool(finite_gate)
        self.canary = bool(canary)
        self._comparator_kwargs = dict(
            min_mirrors=min_mirrors, divergence_limit=divergence_limit,
            latency_spike_factor=latency_spike_factor,
            latency_floor_s=latency_floor_s,
            breach_budget=breach_budget)
        self._rng = random.Random(seed)
        self._pairs = collections.deque()
        self._last_good_value = None
        self.history = []
        self.watcher = SnapshotWatcher(
            watch_dir, callback=self._on_candidate, poll_s=poll_s,
            invalid_ttl_s=invalid_ttl_s,
            default_sample_shape=pool.engine.sample_shape)
        self._m_candidates = _registry.counter(
            "serve.freshness.candidates")
        self._m_poisoned = _registry.counter(
            "serve.freshness.poisoned_rejected")

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        from veles_tpu_torch.serve.engine import value_digest
        if self._last_good_value is None:
            self._last_good_value = value_digest(self.pool.engine.params)
        self.watcher.start()
        return self

    def stop(self):
        self.watcher.stop()
        self.pool.mirror_hook = None

    def notify(self, path=None):
        self.watcher.notify(path)

    # -- one cycle (watcher thread) -----------------------------------------

    def _record(self, cand, verdict, receipt=None, reason=None,
                comparator=None):
        entry = {
            "ordinal": cand.ordinal, "verdict": verdict,
            "snapshot": cand.path,
        }
        if reason:
            entry["reason"] = reason
        if receipt is not None:
            entry["digest"] = receipt.get("digest")
            entry["new_compiles"] = receipt.get("new_compiles")
        if comparator is not None:
            entry["mirrors"] = comparator.pairs
            entry["max_divergence"] = round(
                comparator.max_divergence, 6)
        self.history.append(entry)
        return entry

    def _on_candidate(self, cand):
        from veles_tpu_torch.serve.engine import AOTEngine, value_digest
        pool = self.pool
        self._m_candidates.inc()
        if pool.cutover.state != "idle":
            # cannot happen from the single watcher thread, but a
            # manually driven cutover must not be trampled — and the
            # ordinal must NOT be consumed: raising routes this
            # through the watcher's non-escalating retry, so the
            # publish is picked up once the cutover settles (a
            # silently skipped FINAL publish would never be served)
            raise RuntimeError(
                "cutover busy (%s); candidate #%d will be retried" %
                (pool.cutover.state, cand.ordinal))
        if self.finite_gate and not all_finite(cand.params):
            # first line of defense: NaN/Inf params never even warm —
            # the canary exists for the failures a static check CANNOT
            # see, not the ones it can
            self._m_poisoned.inc()
            _tracer.instant("serve.canary", cat="serve",
                            phase="poisoned", ordinal=cand.ordinal,
                            reason="non-finite params")
            _flight.dump(reason="freshness-poisoned")
            self.warning("candidate #%d REJECTED: non-finite params "
                         "(never warmed, never served)", cand.ordinal)
            self._record(cand, "poisoned", reason="non-finite params")
            return
        value = value_digest(cand.params)
        if value == self._last_good_value:
            self._record(cand, "skipped", reason="already serving")
            return
        live = pool._live()
        shape_changed = tuple(cand.sample_shape) != \
            tuple(pool.engine.sample_shape)
        if not self.canary or len(live) < 2 or shape_changed:
            # verified direct reload — still manifest- and
            # finite-gated, just without the mirrored judgment — for a
            # single-replica fleet, --no-canary, or a candidate whose
            # INPUT shape changed: live traffic cannot drive such a
            # canary at all (every mirrored sample would be refused),
            # so pretending to judge it would only warn-spam for the
            # whole verdict window and roll back a possibly-good model
            if shape_changed:
                self.warning(
                    "candidate #%d changes the sample shape %s -> %s: "
                    "canary judgment impossible on live traffic, "
                    "cutting over via verified direct reload",
                    cand.ordinal, pool.engine.sample_shape,
                    cand.sample_shape)
            receipt = pool.reload(cand.params, plans=cand.plans,
                                  sample_shape=cand.sample_shape)
            self._last_good_value = value
            self._record(cand, "reloaded", receipt=receipt,
                         reason="sample shape changed"
                         if shape_changed else None)
            return
        start = time.perf_counter()
        target = live[-1]  # CanaryCutover.begin's pick
        with _tracer.span("serve.canary.warm", cat="serve",
                          ordinal=cand.ordinal):
            engine = AOTEngine(cand.plans, cand.params,
                               cand.sample_shape, device=target.device,
                               **pool._engine_kwargs)
            engine.compile()
        pool.cutover.begin(engine)
        comparator = CanaryComparator(**self._comparator_kwargs)
        self._pairs.clear()
        pool.mirror_hook = self._mirror
        try:
            verdict = self._judge(comparator)
        except Exception:
            # an unexpected judging failure must not strand the fleet
            # in canary state: restore, then let the watcher's retry
            # discipline re-attempt the publish
            pool.cutover.rollback(reason="freshness cycle failed")
            raise
        finally:
            pool.mirror_hook = None
        if verdict == "promote":
            receipt = pool.cutover.promote()
            self._last_good_value = value
        else:
            receipt = pool.cutover.rollback(reason=comparator.reason())
        entry = self._record(cand, receipt["verdict"], receipt=receipt,
                             reason=comparator.reason()
                             if verdict != "promote" else None,
                             comparator=comparator)
        entry["seconds"] = round(time.perf_counter() - start, 4)

    def _mirror(self, sample, primary_req):
        """The router's per-submit hook while a canary is live: mirror
        a seeded slice of traffic.  The primary request is already
        queued and is NEVER touched — mirroring cannot change, delay,
        or fail what the client receives."""
        if self._rng.random() >= self.mirror_fraction:
            return
        shadow = self.pool.cutover.shadow(
            numpy.array(sample, copy=True),
            trace=getattr(primary_req, "trace", None))
        if shadow is not None:
            self._pairs.append((primary_req, shadow))

    def _probe(self):
        """Synthesize one mirrored pair without client traffic: the
        SAME seeded sample shadow-submitted to a live replica (the
        baseline) and to the canary.  Both legs are shadow requests —
        excluded from served counters, invisible to clients — so an
        idle fleet can still judge a candidate on real evidence
        instead of timing out into a verdict nobody earned."""
        pool = self.pool
        live = pool._live()
        if not live:
            return None
        engine = pool.engine
        x = numpy.asarray(
            self._probe_rng.rand(*engine.sample_shape), engine.dtype)
        primary = live[0].batcher.submit_shadow(x)
        shadow = pool.cutover.shadow(numpy.array(x, copy=True))
        if primary is None or shadow is None:
            return None
        return primary, shadow

    def _judge(self, comparator):
        """Drain mirrored pairs into the comparator until it latches a
        verdict or the window times out.  When no client traffic
        mirrors for ``probe_idle_s``, the controller self-probes
        (:meth:`_probe`) — a quiet fleet must not wedge the pipeline
        OR promote/reject a candidate on zero evidence.  At timeout a
        clean window promotes, a window with breaches rolls back."""
        self._probe_rng = numpy.random.RandomState(
            self._rng.randrange(1 << 31))
        deadline = time.monotonic() + self.verdict_timeout_s
        idle_since = time.monotonic()
        while time.monotonic() < deadline:
            try:
                primary, shadow = self._pairs.popleft()
            except IndexError:
                if time.monotonic() - idle_since >= self.probe_idle_s:
                    idle_since = time.monotonic()
                    pair = self._probe()
                    if pair is not None:
                        self._pairs.append(pair)
                        continue
                time.sleep(0.01)
                continue
            idle_since = time.monotonic()
            if not (primary.done.wait(5.0) and shadow.done.wait(5.0)):
                continue  # a stalled pair is no evidence either way
            if primary.error is not None or shadow.error is not None:
                continue
            verdict = comparator.add(
                primary.result, shadow.result,
                primary_latency=primary.latency,
                shadow_latency=shadow.latency)
            if verdict is not None:
                return verdict
        if comparator.breaches == 0 and \
                comparator.pairs >= comparator.min_mirrors:
            # the comparator would have latched on the next add();
            # closing the window a hair early must not flip the verdict
            self.info("canary verdict window closed clean after %d "
                      "mirror(s): promoting", comparator.pairs)
            return "promote"
        # with self-probing, starving below min_mirrors means shadows
        # are being DROPPED (overloaded/wedged canary) — thin evidence
        # is itself evidence against the candidate; never promote past
        # the operator's min_mirrors bar on less
        comparator.reasons.append(
            "verdict timeout (%d/%d mirrors, %d breaches)" %
            (comparator.pairs, comparator.min_mirrors,
             comparator.breaches))
        return "rolled_back"

    # -- observability ------------------------------------------------------

    def snapshot(self):
        """Plain-data loop state for /healthz and the dashboard."""
        out = {
            "state": self.pool.cutover.state,
            "watch_dir": self.watcher.watch_dir,
            "last_ordinal": self.watcher.last_ordinal,
            "cycles": len(self.history),
            "last_good_value": self._last_good_value,
        }
        for name, short in (
                ("serve.freshness.published", "published"),
                ("serve.freshness.candidates", "candidates"),
                ("serve.freshness.promotions", "promotions"),
                ("serve.freshness.rollbacks", "rollbacks"),
                ("serve.freshness.poisoned_rejected",
                 "poisoned_rejected")):
            metric = _registry.peek(name)
            if metric is not None and metric.value is not None:
                out[short] = metric.value
        if self.history:
            out["last_cycle"] = self.history[-1]
        return out


def _swap_receipt(engines):
    """What the engines behind a host have paid so far: the captures of
    their graph owners and the process's kernel-library builds (the
    counterpart of the reference's backend compile counter)."""
    from veles_tpu_torch.serve.engine import _kernel_builds
    captures = sum(engine.graphs.receipt["captures"]
                   for engine in engines if engine.graphs is not None)
    return captures, _kernel_builds()


class LocalHostControl(object):
    """Stage/revert control over ONE serve host's engines: the
    in-process handle the fleet canary controller drives.

    ``stage(params)`` swaps a same-architecture candidate into every
    engine behind the host's pool through
    :meth:`~veles_tpu_torch.serve.engine.AOTEngine.swap_params` (the
    digest-checked copy into the captured graphs' static buffers),
    saving the previous params once so ``revert()`` restores them
    exactly.  Its receipt is the delta of the engines' own receipts
    around the swap: ``captures`` and ``kernel_builds``, and
    ``new_compiles`` their sum, which is 0 by construction and checked
    (a swap that captured or built would raise).  In a fleet each host
    runs one of these beside its transport server; tests drive them
    directly over socketpair hosts."""

    def __init__(self, pool):
        self.pool = pool
        self._saved = None

    def _engines(self):
        replicas = getattr(self.pool, "replicas", None)
        if replicas is not None:
            return [rep.engine for rep in replicas]
        return [self.pool.engine]

    def _swap(self, params):
        engines = self._engines()
        captures, builds = _swap_receipt(engines)
        digest = None
        for engine in engines:
            digest = engine.swap_params(params)
        captures_after, builds_after = _swap_receipt(engines)
        receipt = {"captures": captures_after - captures,
                   "kernel_builds": builds_after - builds}
        receipt["new_compiles"] = receipt["captures"] + \
            receipt["kernel_builds"]
        if receipt["new_compiles"]:
            raise RuntimeError(
                "a same-architecture swap compiled %r: swap_params must "
                "only copy into the captured buffers" % (receipt,))
        receipt["digest"] = digest
        return receipt

    def stage(self, params):
        """Swap ``params`` into every engine; returns ``{"digest",
        "new_compiles", "captures", "kernel_builds"}``.  Raises
        ``ValueError`` (from swap_params) when the candidate is a
        different architecture: staging is swap-only, never a new
        capture."""
        if self._saved is None:
            self._saved = [dict(p) for p in self._engines()[0].params]
        return self._swap(params)

    def revert(self):
        """Restore the params saved by the first :meth:`stage`;
        returns the swap receipt or None when nothing was staged."""
        if self._saved is None:
            return None
        saved, self._saved = self._saved, None
        return self.stage_params_quietly(saved)

    def stage_params_quietly(self, params):
        receipt = self._swap(params)
        self._saved = None
        return receipt


class FleetCanaryController(Logger):
    """Fleet-level canary: judge a candidate on ONE host's live
    traffic slice, then promote host-by-host or roll the whole fleet
    back.

    The freshness loop's discipline lifted one tier up: where
    :class:`FreshnessController` canaries a candidate on one REPLICA
    of a single-host pool, this controller canaries it on one HOST of
    a :class:`~veles_tpu_torch.serve.fleet.FleetRouter` fleet —

    - finite-gate the candidate (:func:`veles_tpu_torch.health.all_finite`);
    - ``begin_canary_slice`` pulls the canary host from rotation and
      mirrors a seeded fraction of live single-sample traffic to it;
    - drain the host's previously-assigned inflight work, then
      ``stage`` the candidate via the host's
      :class:`LocalHostControl` — a zero-new-compile buffer swap;
    - judge real mirrored (primary, shadow) pairs through
      :class:`CanaryComparator` (output divergence bound + the
      :class:`~veles_tpu_torch.health.EmaSpikeWatch` latency spike
      discipline + the non-finite tripwire);
    - **promote**: stage every sibling host in order (the rolling
      fleet-wide swap), then end the slice — the canary host returns
      to rotation already serving the candidate;
    - **rollback**: revert the canary host FIRST, then end the slice —
      a bad candidate never serves a primary request on ANY host.

    A timed-out or evidence-starved verdict rolls back: thin evidence
    is evidence against the candidate (the single-host loop's rule).
    Counters: ``serve.fleet.canary.{promotions,rollbacks}`` (mirrors
    are counted by the router as it sends them)."""

    def __init__(self, router, controls, mirror_fraction=0.25,
                 min_mirrors=8, divergence_limit=0.5,
                 latency_spike_factor=10.0, latency_floor_s=0.05,
                 breach_budget=3, verdict_timeout_s=30.0,
                 drain_timeout_s=10.0, finite_gate=True, seed=0,
                 **kwargs):
        super(FleetCanaryController, self).__init__(**kwargs)
        self.router = router
        #: ``{host_id: LocalHostControl-like}`` — stage/revert handles
        #: for every host in the fleet (duck-typed: anything with
        #: ``stage(params)`` / ``revert()``)
        self.controls = dict(controls)
        self.mirror_fraction = float(mirror_fraction)
        self.verdict_timeout_s = float(verdict_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.finite_gate = bool(finite_gate)
        self.seed = int(seed)
        self._comparator_kwargs = dict(
            min_mirrors=min_mirrors, divergence_limit=divergence_limit,
            latency_spike_factor=latency_spike_factor,
            latency_floor_s=latency_floor_s,
            breach_budget=breach_budget)
        self.history = []
        self._m_promotions = _registry.counter(
            "serve.fleet.canary.promotions")
        self._m_rollbacks = _registry.counter(
            "serve.fleet.canary.rollbacks")

    def run(self, params, canary_host):
        """One full fleet-canary cycle for ``params`` judged on
        ``canary_host``; returns the receipt dict (``verdict`` is
        ``"promote"`` / ``"rolled_back"`` / ``"poisoned"``)."""
        start = time.perf_counter()
        receipt = {"canary_host": canary_host, "new_compiles": 0}
        if self.finite_gate and not all_finite(params):
            self._m_rollbacks.inc()
            _tracer.instant("serve.canary", cat="serve",
                            phase="poisoned", host=canary_host,
                            reason="non-finite params")
            _flight.dump(reason="fleet-canary-poisoned")
            self.warning("fleet candidate REJECTED: non-finite params "
                         "(never staged, never mirrored)")
            receipt.update(verdict="poisoned",
                           reason="non-finite params")
            self.history.append(receipt)
            return receipt
        control = self.controls[canary_host]
        comparator = CanaryComparator(**self._comparator_kwargs)
        verdict_ready = threading.Event()

        def on_pair(primary_out, shadow_out, p_lat, s_lat):
            if comparator.add(primary_out, shadow_out,
                              primary_latency=p_lat,
                              shadow_latency=s_lat) is not None:
                verdict_ready.set()

        slice_ = self.router.begin_canary_slice(
            canary_host, fraction=self.mirror_fraction,
            seed=self.seed, on_pair=on_pair)
        _tracer.instant("serve.canary", cat="serve", phase="begin",
                        host=canary_host, tier="fleet")
        try:
            # drain: old-model inflight work must finish before the
            # swap so mirrored judging only ever sees candidate output
            deadline = time.monotonic() + self.drain_timeout_s
            while self.router.host_inflight(canary_host) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            stage = control.stage(params)
            receipt["new_compiles"] += stage.get("new_compiles") or 0
            receipt["digest"] = stage.get("digest")
            # arm mirroring only now: every judged pair compares
            # CANDIDATE output against the live fleet, never a stale
            # pre-stage shadow
            slice_.armed = True
            verdict_ready.wait(self.verdict_timeout_s)
            verdict = comparator.verdict
            if verdict is None:
                if comparator.breaches == 0 and \
                        comparator.pairs >= comparator.min_mirrors:
                    verdict = "promote"
                else:
                    comparator.reasons.append(
                        "verdict timeout (%d/%d mirrors, %d breaches)"
                        % (comparator.pairs, comparator.min_mirrors,
                           comparator.breaches))
                    verdict = "rolled_back"
            if slice_.link_down:
                comparator.reasons.append(
                    "canary host link died mid-judgment")
                verdict = "rolled_back"
        except Exception:
            # an unexpected staging/judging failure must not strand
            # the fleet mid-canary: revert, restore routing, re-raise
            try:
                control.revert()
            finally:
                self.router.end_canary_slice()
            raise
        if verdict == "promote":
            # rolling fleet-wide promotion: siblings first (each a
            # zero-new-compile swap), the canary host re-enters
            # rotation LAST — already serving the candidate
            for host_id, sibling in self.controls.items():
                if host_id == canary_host:
                    continue
                rec = sibling.stage(params)
                receipt["new_compiles"] += rec.get("new_compiles") or 0
            self._m_promotions.inc()
        else:
            # rollback: revert the canary BEFORE it re-enters rotation
            # — the bad candidate never answers a primary request
            control.revert()
            self._m_rollbacks.inc()
            receipt["reason"] = comparator.reason()
        stats = self.router.end_canary_slice()
        _tracer.instant("serve.canary", cat="serve", phase=verdict,
                        host=canary_host, tier="fleet",
                        mirrors=comparator.pairs)
        receipt.update(
            verdict=verdict, mirrors=comparator.pairs,
            max_divergence=round(comparator.max_divergence, 6),
            slice=stats, seconds=round(time.perf_counter() - start, 4))
        self.history.append(receipt)
        self.info("fleet canary on %s: %s (%d mirrored pairs, %d new "
                  "compiles)", canary_host, verdict, comparator.pairs,
                  receipt["new_compiles"])
        return receipt
