"""Elastic-fleet bookkeeping: membership epochs, power-weighted
partition of an epoch's unserved sample space, consistent-hash shard
ownership and the shared straggler-speculation threshold math.

Counterpart of ``veles_tpu/elastic.py``, whole: the module is pure
Python, so the port keeps its own copy and every function returns what
the JAX package's returns on the same arguments, bit for bit
(``tests/test_torch_elastic.py``).  Its users in the port are the
elastic mesh (``parallel/mesh.py``'s ``MeshManager``, which moves ZeRO-1
shards by :func:`shard_owners` and :func:`movement_plan`) and the
master-slave ``Server`` (``veles_tpu_torch/server.py``: its
:class:`FleetView`, the reshard pushes of :func:`power_shares` and the
speculative backups of :func:`speculation_threshold`), and the job farm
(``veles_tpu_torch/jobfarm.py``: its backup copies of a straggling job
by :func:`speculation_threshold` over :func:`fleet_mean_power`).

- :class:`FleetView` — the master's view of live membership.  Every
  join and leave bumps a **membership epoch**; the Server stamps jobs
  and rejects updates from departed members (docs/distributed.md,
  "Elasticity contract"), so a preempted chip's late duplicate can
  never double-apply work that was requeued at drop time.
- :func:`power_shares` — largest-remainder apportionment of the
  epoch's *unserved remainder* among live slaves weighted by their
  reported computing power.
- :func:`shard_owners` / :func:`movement_plan` — rendezvous-hash
  ownership of logical state shards, rebalanced with minimal moves.
- :func:`speculation_threshold` — the straggler bar: once an in-flight
  job is older than ``factor x`` the mean completed duration
  (power-corrected, floored), an idle peer shadows it and the first
  result wins.

All power inputs are **degenerate-safe**: a zero, negative or
non-finite rating (a failed benchmark, a corrupt handshake) is
neutralized to the baseline 1.0 before any division, so the threshold
and partition math never divide by a sick fleet aggregate.
"""

import hashlib
import math

__all__ = ["FleetView", "effective_power", "fleet_mean_power",
           "power_shares", "speculation_threshold", "fleet_snapshot",
           "shard_owners", "movement_plan", "POWER_SCALE_BOUND"]

#: Bound on the power correction applied to the speculation threshold:
#: a chip rated 100x slower than the fleet mean must still be
#: speculated *eventually* — unbounded runway would turn one absurd
#: rating into a job that is never shadowed.
POWER_SCALE_BOUND = 8.0


def effective_power(power):
    """A slave's power rating, sanitized for use in ratios.

    Zero, negative, non-finite, or non-numeric ratings (the client
    reports 1.0 on a failed benchmark, but a corrupt handshake can
    ship anything) collapse to the neutral 1.0 — the same weight the
    client itself falls back to — so fleet aggregates stay positive
    and every division downstream is safe.
    """
    try:
        value = float(power)
    except (TypeError, ValueError):
        return 1.0
    if not math.isfinite(value) or value <= 0.0:
        return 1.0
    return value


def power_shares(total, powers):
    """Apportion ``total`` work units among members by power.

    ``powers`` maps member key -> reported power rating.  Returns
    {key: integer share}, shares summing exactly to ``total``
    (largest-remainder method: floors first, then the biggest
    fractional parts pick up the leftover units; ties broken by key so
    the split is deterministic).  Empty fleet or unknown/negative
    total -> {} (nothing to partition).
    """
    if not powers or total is None or total < 0:
        return {}
    total = int(total)
    eff = {key: effective_power(p) for key, p in powers.items()}
    aggregate = sum(eff.values())  # > 0: effective_power is positive
    exact = {key: total * p / aggregate for key, p in eff.items()}
    shares = {key: int(exact[key]) for key in eff}
    leftover = total - sum(shares.values())
    for key in sorted(eff, key=lambda k: (shares[k] - exact[k],
                                          str(k)))[:leftover]:
        shares[key] += 1
    return shares


def _hrw(shard, member):
    """Rendezvous (highest-random-weight) score of ``member`` for
    ``shard`` — a keyed 64-bit hash, so each shard ranks the member
    set in an order that is stable across processes and independent of
    which OTHER members exist (the property that makes membership
    churn move only the affected shards)."""
    digest = hashlib.blake2b(
        ("%s|%s" % (shard, member)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


def shard_owners(n_shards, members, previous=None):
    """Consistent-hash assignment of ``n_shards`` logical state shards
    to ``members`` (hashable keys), balanced to exact quotas.

    Rendezvous hashing gives every shard a preference order over the
    member set; the assignment is then rebalanced so each member owns
    ``floor(n_shards/len(members))`` or one more — the uneven remainder
    lands on the members the shard space prefers.  With ``previous``
    (the pre-churn ``{shard: member}`` map) the rebalance is
    *minimal-move*: a shard keeps its old owner unless that owner left
    or sits over quota, so one leave moves ~n_shards/N shards (the
    departed member's) and one join moves ~n_shards/N' (one shed per
    over-quota member), never a full reshuffle.  Deterministic for a
    given (n_shards, member set, previous).  Returns {shard: member}.
    """
    keys = sorted(set(members), key=str)
    if not keys:
        raise ValueError("shard_owners: empty member set")
    n = len(keys)
    base, extra = divmod(int(n_shards), n)
    # quota: the members ranked highest by the whole shard space get
    # the remainder — deterministic in the member set alone, so the
    # same fleet always computes the same quotas
    rank = sorted(keys, key=lambda m: (-_hrw("quota", m), str(m)))
    quota = {m: base + (1 if rank.index(m) < extra else 0)
             for m in keys}
    held = {m: [] for m in keys}
    pool = []
    for shard in range(int(n_shards)):
        owner = (previous or {}).get(shard)
        if owner in quota:
            held[owner].append(shard)
        else:
            pool.append(shard)
    # over-quota members shed the shards that prefer them LEAST —
    # those are exactly the shards most likely to prefer the joiner
    for m in keys:
        if len(held[m]) > quota[m]:
            held[m].sort(key=lambda s: (-_hrw(s, m), s))
            pool.extend(held[m][quota[m]:])
            held[m] = held[m][:quota[m]]
    # the pool (new/orphaned/shed shards) lands by preference order,
    # respecting quotas; ties broken by shard id for determinism
    for shard in sorted(pool):
        prefs = sorted(keys, key=lambda m: (-_hrw(shard, m), str(m)))
        for m in prefs:
            if len(held[m]) < quota[m]:
                held[m].append(shard)
                break
    owners = {}
    for m, shards in held.items():
        for shard in shards:
            owners[shard] = m
    return owners


def movement_plan(previous, owners):
    """The shards a reshard actually moves: those whose owner changed
    between ``previous`` and ``owners`` (both ``{shard: member}``).
    New shards (absent from ``previous``) count as moved — they must
    be materialized on their owner either way.  The ``changed_fraction``
    against the full shard count is the receipt the consistent-hash
    claim is audited by (a full gather would move fraction 1.0)."""
    moved = sorted(s for s in owners
                   if previous is None or previous.get(s) != owners[s])
    total = max(len(owners), 1)
    return {
        "moved": moved,
        "n_moved": len(moved),
        "n_shards": len(owners),
        "changed_fraction": len(moved) / float(total),
    }


def fleet_mean_power(fleet_powers):
    """Mean sanitized power of a fleet (> 0 by construction), or None
    for an empty fleet.  Hoist this out of per-job speculation loops:
    only the owner's power varies job-to-job, so the fleet pass need
    not be repeated per candidate."""
    fleet = [effective_power(p) for p in fleet_powers]
    if not fleet:
        return None
    return sum(fleet) / len(fleet)


def speculation_threshold(mean_duration, factor, floor,
                          owner_power=None, fleet_powers=(),
                          mean_power=None):
    """Age (seconds) past which an in-flight job counts as straggling.

    ``factor x mean_duration`` is the MapReduce backup-task bar the
    jobfarm pioneered here; ``floor`` keeps millisecond-scale jobs
    from speculating their whole tail.  When the fleet reports power
    ratings, the bar is *power-corrected*: a job on a chip rated below
    the fleet mean gets proportionally more runway (and a fast chip
    less), bounded by :data:`POWER_SCALE_BOUND` so one absurd rating
    cannot make a job unspeculatable.  All aggregates are
    degenerate-safe (zero/negative/single-member fleets included) via
    :func:`effective_power`.  Callers looping over candidate jobs
    should hoist :func:`fleet_mean_power` and pass ``mean_power``
    (``fleet_powers`` is then ignored).
    """
    try:
        mean = float(mean_duration)
    except (TypeError, ValueError):
        mean = 0.0
    if not math.isfinite(mean) or mean < 0.0:
        mean = 0.0
    if mean_power is None:
        mean_power = fleet_mean_power(fleet_powers)
    scale = 1.0
    if mean_power is not None:
        scale = mean_power / effective_power(owner_power)
        scale = min(max(scale, 1.0 / POWER_SCALE_BOUND),
                    POWER_SCALE_BOUND)
    return max(float(factor) * mean * scale, float(floor))


class FleetView(object):
    """The master's live-membership ledger.

    Every :meth:`join` and :meth:`leave` bumps ``membership_epoch`` —
    the monotonically increasing counter the Server stamps on jobs and
    reshard pushes.  An update arriving from a slave that left at
    epoch E is *stale* with respect to every epoch > E: its work was
    requeued when it left, so the Server drops the duplicate instead
    of applying it (the exactly-once half of the elasticity contract).

    Besides the static power ratings the handshake reports, the view
    can track **measured throughput** per member as an EMA
    (:meth:`observe_throughput`): the serve fleet weights its routing
    and hedging by what hosts actually deliver, not what they claimed
    at join time (``shares(..., by="throughput")`` is the matching
    share mode).  Every observation is sanitized exactly like
    :func:`effective_power` — a member reporting zero/negative/NaN
    throughput contributes the neutral 1.0, never a sick aggregate —
    and an unobserved (cold-start) member reads 1.0 until its first
    real sample lands.
    """

    def __init__(self, throughput_alpha=0.2):
        self.membership_epoch = 0
        self.members = {}  # sid -> reported power rating
        #: EMA smoothing for measured throughput: weight of the NEWEST
        #: observation (0 < alpha <= 1; 1 = no smoothing)
        self.throughput_alpha = min(max(float(throughput_alpha),
                                        1e-6), 1.0)
        self._throughput = {}  # sid -> sanitized EMA

    def __len__(self):
        return len(self.members)

    def join(self, sid, power):
        """Admit ``sid``; returns the new membership epoch."""
        self.members[sid] = power
        self.membership_epoch += 1
        return self.membership_epoch

    def leave(self, sid):
        """Retire ``sid``; returns the (possibly bumped) epoch.  An
        unknown sid does not bump — a double drop is not a membership
        change.  The throughput EMA is forgotten with the member: a
        rejoin restarts cold (its old rate is stale evidence)."""
        if sid in self.members:
            del self.members[sid]
            self._throughput.pop(sid, None)
            self.membership_epoch += 1
        return self.membership_epoch

    def observe_throughput(self, sid, rate):
        """Fold one measured throughput sample (e.g. rows/second) into
        ``sid``'s EMA; returns the new EMA.  The FIRST observation
        seeds the EMA directly (no bias toward the neutral baseline);
        each later one decays in with ``throughput_alpha``.  Sick
        samples (zero/negative/NaN/garbage) are neutralized to 1.0
        BEFORE the fold, mirroring :func:`effective_power`, so one
        corrupt report can dent the EMA but never poison it."""
        rate = effective_power(rate)
        prev = self._throughput.get(sid)
        if prev is None:
            ema = rate
        else:
            alpha = self.throughput_alpha
            ema = alpha * rate + (1.0 - alpha) * prev
        self._throughput[sid] = ema
        return ema

    def throughput(self, sid, default=1.0):
        """``sid``'s throughput EMA, or ``default`` before any
        observation (cold start) / for unknown members.  The neutral
        1.0 keeps aggregates safe; callers that can substitute a
        better prior (the serve router uses the fleet mean so a cold
        host competes for traffic instead of starving against
        measured absolute rates) pass ``default=None`` and handle the
        miss themselves."""
        return self._throughput.get(sid, default)

    def throughputs(self):
        """Per-member throughput EMAs for the live fleet (cold members
        at the neutral 1.0) — threshold/aggregate inputs."""
        return [self.throughput(sid) for sid in self.members]

    def shares(self, remaining, by="power"):
        """Split of ``remaining`` work units across the live fleet
        ({} when the remainder is unknown): ``by="power"`` weights by
        the static reported ratings, ``by="throughput"`` by the
        measured EMAs (the serve tier's mode)."""
        if by == "throughput":
            weights = {sid: self.throughput(sid)
                       for sid in self.members}
            return power_shares(remaining, weights)
        return power_shares(remaining, self.members)

    def powers(self):
        """The live fleet's raw power ratings (threshold inputs)."""
        return list(self.members.values())


#: Fleet keys surfaced to dashboards: registry name -> short name
#: (the elastic mirror of observe.metrics._HEALTH_KEYS).
_FLEET_KEYS = (
    ("elastic.membership_epoch", "membership_epoch"),
    ("elastic.fleet_live", "live"),
    ("elastic.speculative_inflight", "speculative_inflight"),
    ("elastic.reshards", "reshards"),
    ("elastic.speculative_jobs", "speculative_jobs"),
    ("elastic.duplicates_dropped", "duplicates_dropped"),
    ("elastic.stale_updates", "stale_updates"),
    ("elastic.drops_deferred", "drops_deferred"),
    ("server.blacklist_size", "blacklisted"),
    ("server.quarantined", "quarantined"),
)


def fleet_snapshot(reg=None):
    """The elastic-fleet counters as a flat dict for the web-status
    fleet column and post-mortems: membership epoch, live/blacklisted/
    quarantined counts, speculation and exactly-once accounting.  Only
    metrics a server actually published appear ({} on slaves and
    standalone runs)."""
    from veles_tpu_torch.observe.metrics import snapshot_keys
    return snapshot_keys(_FLEET_KEYS, reg)
