"""Multi-tenant QoS primitives for the serve tier.

Counterpart of ``veles_tpu/serve/qos.py``, whole: the token buckets,
quotas, jitter and hedge budgets are plain Python, equal to the JAX
package's draw for draw.

The serve stack (docs/serving.md "Multi-tenant QoS") labels every
request with a tenant id and an SLO class — ``interactive`` /
``batch`` / ``best_effort`` — and degrades *selectively* instead of
uniformly:

- **Admission control**: a :class:`TokenBucket` quota per tenant
  (rate + burst, CLI/config-driven via :class:`TenantQuota`) rejects
  over-quota traffic at the service front / binary transport with a
  per-class 503 ``retry_after`` before the request ever reaches a
  queue.
- **Class-ordered shedding**: when a queue bound trips, the batcher
  and fleet front evict ``best_effort`` work first, then ``batch``;
  ``interactive`` is shed only when the queue is saturated with
  interactive work itself (:data:`SHED_ORDER` is the contract).
- **Per-class hedge budgets**: :class:`HedgeBudget` caps how fast each
  class may fire hedges so bulk traffic cannot burn the hedge capacity
  interactive traffic needs — an exhausted budget routes normally, it
  never fails the request.
- **Retry de-stampeding**: :class:`RetryJitter` gives every overload
  rejection a deterministic, seeded, per-class jitter so synchronized
  clients with the same rejection do not re-stampede the queue at the
  same instant.

Un-labelled legacy traffic keeps working unchanged: ``None`` / unknown
class names normalize to :data:`DEFAULT_CLASS` (``batch``).

Per-class accounting rides ``serve.tenant.<class>.{requests,shed,
latency_s}`` (served counters are bumped at the batcher — the serving
edge — so a fleet front and its hosts never double-count in-process)
and ``serve.hedge.budget_exhausted``; all of it surfaces through
``serve_snapshot`` / heartbeats / the web status page.
"""

import hashlib
import threading
import time

from veles_tpu_torch.observe.metrics import registry as _registry

__all__ = [
    "SLO_CLASSES", "DEFAULT_CLASS", "SHED_ORDER", "normalize_class",
    "class_rank", "TokenBucket", "TenantQuota", "parse_quota_spec",
    "RetryJitter", "HedgeBudget", "note_request", "note_shed",
    "note_latency", "tenant_snapshot", "DEFAULT_SLO_BUDGETS_S",
    "slo_budget_s", "burn_rule_specs",
]

#: SLO classes, most- to least-important.  The taxonomy mirrors the
#: datacenter reality in "In-Datacenter Performance Analysis of a TPU":
#: latency-bounded interactive inference coexisting with bulk work.
SLO_CLASSES = ("interactive", "batch", "best_effort")

#: Un-labelled legacy traffic lands here — the middle class: it is
#: never preferred over interactive, but a best-effort storm is shed
#: before it.
DEFAULT_CLASS = "batch"

#: Shedding order contract: evict left-to-right.  ``interactive`` is
#: last — it is shed only when the queue is saturated with interactive
#: work itself (the "interactive starves last" invariant).
SHED_ORDER = ("best_effort", "batch", "interactive")

_RANK = {name: rank for rank, name in enumerate(SHED_ORDER)}


def normalize_class(name):
    """Map a wire-level class label to a canonical SLO class.

    ``None``, unknown names and case/punctuation variants all fold to
    :data:`DEFAULT_CLASS` so un-labelled legacy clients keep working
    unchanged.
    """
    if not name:
        return DEFAULT_CLASS
    canon = str(name).strip().lower().replace("-", "_")
    return canon if canon in _RANK else DEFAULT_CLASS


def class_rank(name):
    """Importance rank (higher = shed later): best_effort=0 < batch=1
    < interactive=2.  Unknown names rank as :data:`DEFAULT_CLASS`."""
    return _RANK[normalize_class(name)]


class TokenBucket(object):
    """Classic token bucket: ``rate`` tokens/second refill, capacity
    ``burst``.  Starts full.  The clock is injectable so quota math is
    deterministic under test.

    ``rate <= 0`` means the bucket never refills — whatever ``burst``
    grants is all a caller ever gets (used for "no hedges for this
    class" budgets).
    """

    def __init__(self, rate, burst=None, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill(self):
        now = self._clock()
        elapsed = now - self._stamp
        self._stamp = now
        if elapsed > 0 and self.rate > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)

    def try_take(self, n=1.0):
        """Take ``n`` tokens if available; never blocks."""
        with self._lock:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def time_until(self, n=1.0):
        """Seconds until ``n`` tokens will be available (0 if already
        are; ``inf`` when the bucket can never grant ``n``)."""
        with self._lock:
            self._refill()
            deficit = n - self._tokens
            if deficit <= 0:
                return 0.0
            if self.rate <= 0 or n > self.burst:
                return float("inf")
            return deficit / self.rate

    @property
    def tokens(self):
        with self._lock:
            self._refill()
            return self._tokens


def parse_quota_spec(spec):
    """Parse the CLI quota spec ``"tenant=rate[:burst],..."`` into a
    ``{tenant: (rate, burst)}`` dict.  ``*`` names the default quota
    applied to any tenant not listed.  Example::

        acme=100:200,free_tier=5,*=50

    means tenant ``acme`` gets 100 req/s with a burst of 200, the
    ``free_tier`` tenant 5 req/s (burst = rate), and everyone else 50.
    """
    quotas = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("quota spec entry %r: expected tenant=rate[:burst]"
                             % part)
        tenant, _, rhs = part.partition("=")
        rate, _, burst = rhs.partition(":")
        quotas[tenant.strip()] = (
            float(rate), float(burst) if burst else None)
    return quotas


class TenantQuota(object):
    """Per-tenant admission quota: one :class:`TokenBucket` per tenant.

    ``quotas`` maps tenant id -> ``(rate, burst)``; the ``*`` entry is
    the default applied (per tenant, each with its own bucket) to any
    tenant not listed.  Tenants with no entry and no default are
    unlimited — quota is opt-in, legacy traffic is never rejected by a
    quota nobody configured.  ``None``/missing tenant ids share one
    anonymous bucket under the default quota.
    """

    def __init__(self, quotas=None, clock=time.monotonic):
        quotas = dict(quotas or {})
        self._default = quotas.pop("*", None)
        self._spec = quotas
        self._clock = clock
        self._buckets = {}
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec, clock=time.monotonic):
        """Build from the CLI spec string (see :func:`parse_quota_spec`)."""
        return cls(parse_quota_spec(spec), clock=clock)

    def _bucket(self, tenant):
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                quota = self._spec.get(tenant, self._default)
                if quota is None:
                    return None
                rate, burst = quota
                bucket = TokenBucket(rate, burst, clock=self._clock)
                self._buckets[tenant] = bucket
            return bucket

    def admit(self, tenant, cost=1.0):
        """Charge ``cost`` tokens to ``tenant``'s bucket.  Returns
        ``None`` when admitted, else the seconds-until-refill hint the
        rejection's ``retry_after`` should be based on."""
        bucket = self._bucket(tenant if tenant else "*anonymous*")
        if bucket is None:
            return None
        if bucket.try_take(cost):
            return None
        wait = bucket.time_until(cost)
        return wait if wait != float("inf") else 1.0


class RetryJitter(object):
    """Deterministic seeded per-class jitter for overload ``retry_after``.

    Synchronized clients that hit the same rejection must not sleep
    the same interval and re-stampede the queue at the same instant —
    so each rejection of a class stretches the base estimate by a
    pseudo-random factor in ``[1, 1 + spread]`` drawn from
    ``sha256(seed, class, per-class rejection counter)``.  Same seed +
    same rejection sequence = same jitters (replayable under test);
    consecutive rejections of one class get distinct values.
    """

    def __init__(self, seed=0, spread=0.5):
        self.seed = int(seed)
        self.spread = float(spread)
        self._counters = {}
        self._lock = threading.Lock()

    def apply(self, base, slo_class=None):
        cls = normalize_class(slo_class)
        with self._lock:
            n = self._counters.get(cls, 0)
            self._counters[cls] = n + 1
        digest = hashlib.sha256(
            ("%d:%s:%d" % (self.seed, cls, n)).encode()).digest()
        frac = int.from_bytes(digest[:8], "big") / float(1 << 64)
        return float(base) * (1.0 + frac * self.spread)


#: Default per-class end-to-end latency budgets in SECONDS, measured
#: from the ORIGINAL front-door arrival (requeues/hedges never restart
#: the clock).  This is the tail-exemplar trigger (observe/requests.py):
#: a non-shadow request past its class budget keeps its full segment
#: timeline in the bounded exemplar ring, dumped with the flight
#: recorder on ``serve.slo_violation``.  Deliberately loose defaults —
#: deployments with real SLOs pass their own dict to ``slo_budget_s``.
DEFAULT_SLO_BUDGETS_S = {
    "interactive": 0.100,
    "batch": 1.0,
    "best_effort": 5.0,
}


def slo_budget_s(slo_class, budgets=None):
    """The class's end-to-end latency budget in seconds (None when the
    class has no budget configured)."""
    budgets = DEFAULT_SLO_BUDGETS_S if budgets is None else budgets
    return budgets.get(normalize_class(slo_class))


def burn_rule_specs(budgets=None, objective=0.99, fast_buckets=3,
                    slow_buckets=12, factor=2.0, min_count=20,
                    scope="tenant"):
    """Declarative multi-window burn-rate rule specs, one per class
    with a configured budget — the bridge from the QoS budget table
    to the alert plane (``observe/alerts.py`` ``rule_from_spec``): each
    watches the class's
    ``serve.<scope>.<class>.latency_s`` digest series and fires only
    when the fast AND slow windows both burn
    the ``1 - objective`` error budget at >= ``factor``.

    ``scope="tenant"`` (default) watches the HOST batcher's serving-
    edge histograms (``note_latency``); ``scope="fleet"`` watches the
    fleet front's end-to-end histograms — the ones that see transport
    stalls and straggler tails the serving edge never measures (a
    stalled frame parks BEFORE the batcher clock starts)."""
    budgets = DEFAULT_SLO_BUDGETS_S if budgets is None else budgets
    specs = []
    for cls in SLO_CLASSES:
        budget = budgets.get(cls)
        if budget is None:
            continue
        name = ("slo_burn.%s" % cls if scope == "tenant"
                else "slo_burn.%s.%s" % (scope, cls))
        specs.append({
            "name": name, "kind": "burn_rate",
            "hist": "serve.%s.%s.latency_s" % (scope, cls),
            "budget_s": float(budget), "objective": objective,
            "fast_buckets": fast_buckets,
            "slow_buckets": slow_buckets, "factor": factor,
            "min_count": min_count})
    return specs


#: Default per-class hedge budgets (tokens/second, burst).  Interactive
#: gets the lion's share — hedging exists to protect ITS tail; bulk
#: classes get a trickle so a stuck host still unwedges batch work
#: without burning the capacity interactive needs.
DEFAULT_HEDGE_BUDGETS = {
    "interactive": (20.0, 40.0),
    "batch": (5.0, 10.0),
    "best_effort": (1.0, 2.0),
}


class HedgeBudget(object):
    """Per-class token buckets gating hedge sends in the FleetRouter.

    ``try_take(cls)`` is asked right before a hedge would fire; a
    ``False`` answer means the class's budget is exhausted — the
    caller routes normally (the primary copy stands, the request NEVER
    fails because of budget) and ``serve.hedge.budget_exhausted``
    records the suppression.
    """

    def __init__(self, budgets=None, clock=time.monotonic):
        budgets = dict(DEFAULT_HEDGE_BUDGETS, **(budgets or {}))
        self._buckets = {
            normalize_class(cls): TokenBucket(rate, burst, clock=clock)
            for cls, (rate, burst) in budgets.items()}
        self._m_exhausted = _registry.counter("serve.hedge.budget_exhausted")

    def try_take(self, slo_class):
        bucket = self._buckets[normalize_class(slo_class)]
        if bucket.try_take(1.0):
            return True
        self._m_exhausted.inc()
        return False


# -- per-class accounting -----------------------------------------------------


def note_request(slo_class, rows=1, reg=None):
    """Count ``rows`` served samples for the class.  Callers must skip
    shadow/mirror traffic — mirrored evidence never counts as served."""
    reg = reg or _registry
    reg.counter("serve.tenant.%s.requests" % normalize_class(slo_class)).inc(rows)


def note_shed(slo_class, reg=None):
    """Count one shed (queue eviction, bound rejection, or over-quota
    admission reject) attributed to the class that LOST the capacity."""
    reg = reg or _registry
    reg.counter("serve.tenant.%s.shed" % normalize_class(slo_class)).inc()


def note_latency(slo_class, seconds, reg=None):
    reg = reg or _registry
    reg.histogram("serve.tenant.%s.latency_s" % normalize_class(slo_class),
                  ).observe(float(seconds))


def tenant_snapshot(reg=None):
    """Per-class block for ``serve_snapshot``: requests/shed counts and
    latency percentiles for every class that saw traffic."""
    from veles_tpu_torch.observe.metrics import percentiles
    reg = reg or _registry
    out = {}
    for cls in SLO_CLASSES:
        block = {}
        for suffix in ("requests", "shed"):
            metric = reg.peek("serve.tenant.%s.%s" % (cls, suffix))
            if metric is not None and metric.value:
                block[suffix] = metric.value
        hist = reg.peek("serve.tenant.%s.latency_s" % cls)
        if hist is not None and hist.count:
            window = hist.window_values()
            if window:
                pcts = percentiles(window, (50, 99))
                block["latency_ms"] = {
                    "p50": round(pcts["p50"] * 1e3, 3),
                    "p99": round(pcts["p99"] * 1e3, 3),
                }
        if block:
            out[cls] = block
    return out
