"""The learned schedule cost model.

Counterpart of ``veles_tpu/tune/costmodel.py``, a copy but for the
features that read the port's genes (``_grid_flops``).  A small
regressor trained on the measurement sidecar (``tune/cache.py``,
``measurements.jsonl``) ranks a generation's candidates FIRST and only
the top slice is launched and timed.

Design constraints, in order:

- **Deterministic.**  The model is gradient-boosted depth-1 stumps
  over hand-built features, fit by exhaustive scan over quantile
  thresholds in fixed feature order with first-wins tie-breaking —
  same triples in, same stumps out, same ranking out, on every host.
  No RNG anywhere.
- **Pure numpy.**  No new dependencies; the module imports in
  milliseconds and launches nothing.
- **Honest about its own error.**  ``validate()`` runs
  leave-one-spec-out: every distinct spec digest with enough rows is
  held out in turn, the model refit on the rest, and the held-out
  ranking scored by Spearman correlation against the measured slopes.
  ``train_for`` refuses to hand back a model when training data is
  thin (< ``MIN_TRIPLES`` rows for the family) or the validation
  error exceeds ``TRUST_ERROR`` — the tuner then falls back to
  measured fitness, which is always correct, just slower.

The model predicts ``log(slope seconds)``; only RANK matters to the
tuner (predicted seconds are never persisted, never published — cache
entries stay measured-only).
"""

import json

import numpy

from veles_tpu_torch.tune import cache as _cache
from veles_tpu_torch.tune.spec import family_for

__all__ = ["CostModel", "featurize", "train_for", "spearman",
           "MIN_TRIPLES", "TRUST_ERROR"]

#: below this many current-version triples for a family the model is
#: not trained at all (thin-data fallback to measured fitness)
MIN_TRIPLES = 32

#: trust threshold on the leave-one-spec-out validation ERROR
#: (1 - mean held-out Spearman): above it the tuner ignores the model
TRUST_ERROR = 0.5

#: minimum distinct measured schedules a held-out spec needs for its
#: ranking to be scorable
_MIN_GROUP = 3

#: leave-one-spec-out refits are O(groups * fit); cap the held-out
#: groups (largest first, digest-ordered ties) so validation stays
#: cheap on long measurement histories
_MAX_GROUPS = 8


def _log2(value):
    return float(numpy.log2(max(float(value), 1.0)))


def _ceil_div(a, b):
    return -(-int(a) // max(int(b), 1))


def _grid_flops(op, shape, schedule):
    """(blocks, flops per block) of one (family, key shape, schedule):
    the two features tile dims alone cannot express, from the port's
    genes.  Unknown families get a gene-product proxy."""
    if op == "matmul":
        m, k, n = shape
        grid = _ceil_div(m, 128) * _ceil_div(n, 128) * schedule["splits"]
        return grid, 2.0 * m * n * k / max(grid, 1)
    if op == "matmul_int8":
        from veles_tpu_torch.ops.matmul_int8 import INT8_TILES
        m, k, n = shape
        bm, bn = INT8_TILES[schedule["config"]]
        grid = _ceil_div(m, bm) * _ceil_div(n, bn) * schedule["splits"]
        return grid, 2.0 * bm * bn * k / schedule["splits"]
    if op == "conv_vjp":
        taps, p, ci, co = shape
        rows, cols = schedule["tile"]
        chunk = schedule["chunk"]
        grid = (_ceil_div(taps * ci, rows) * _ceil_div(co, cols)
                * _ceil_div(p, chunk))
        return grid, 2.0 * rows * cols * chunk
    if op == "attention":
        b, t, dh = shape
        items = b * _ceil_div(t, 64)
        grid = schedule["grid"] or items
        return grid, 4.0 * t * t * dh * b / max(grid, 1)
    if op == "pool_bwd":
        c = shape[3]
        lanes_x = schedule["lanes_x"]
        return _ceil_div(c, lanes_x), float(lanes_x)
    tiles = 1.0
    for value in family_for(op).genes_of(schedule).values():
        tiles *= max(float(value), 1.0)
    return 1, tiles


def featurize(spec, schedule):
    """The hand-built feature vector for one (spec, schedule): log2 of
    every key dim and gene, the family's footprint (bytes the call
    moves), the blocks, the flops a block, the arithmetic intensity
    (flops per footprint byte) and a total-traffic proxy.  Fixed length
    per family (models are per-family, so lengths never mix)."""
    op = spec["op"]
    family = family_for(op)
    shape = [int(s) for s in spec["shape"]]
    genes = family.genes_of(schedule)
    tiles = [int(genes[name]) for name in sorted(genes)]
    foot = float(family.footprint(spec, schedule))
    grid, flops = _grid_flops(op, shape, schedule)
    feats = ([_log2(s) for s in shape]
             + [_log2(t) for t in tiles]
             + [_log2(foot), _log2(grid), _log2(flops),
                _log2(max(flops, 1.0) / max(foot, 1.0) + 1.0),
                _log2(foot * max(grid, 1))])
    return numpy.asarray(feats, numpy.float64)


def spearman(a, b):
    """Spearman rank correlation (average ranks for ties); 0.0 when
    either side has no rank variance."""
    ra = _ranks(numpy.asarray(a, numpy.float64))
    rb = _ranks(numpy.asarray(b, numpy.float64))
    sa, sb = ra.std(), rb.std()
    if sa == 0.0 or sb == 0.0:
        return 0.0
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean()
                 / (sa * sb))


def _ranks(values):
    order = numpy.argsort(values, kind="stable")
    ranks = numpy.empty(len(values), numpy.float64)
    ranks[order] = numpy.arange(len(values), dtype=numpy.float64)
    # average ties so duplicate slopes do not fabricate an ordering
    for value in numpy.unique(values):
        mask = values == value
        if mask.sum() > 1:
            ranks[mask] = ranks[mask].mean()
    return ranks


def _spec_of(payload):
    """A featurize()-able spec dict from a measurement row's digest
    payload (the payload IS the key coordinates, flattened)."""
    return {"op": payload["op"], "shape": list(payload["shape"]),
            "dtype": payload.get("dtype", "float32"),
            "precision_level": payload.get("precision_level", 0)}


def _fit_boost(X, y, rounds, learning_rate, max_thresholds):
    """Deterministic least-squares gradient boosting with depth-1
    stumps.  Candidate thresholds are midpoints of each feature's
    unique values, quantile-subsampled to ``max_thresholds``; the best
    split per round is chosen by SSE gain with first-wins ties (lowest
    feature index, then lowest threshold index)."""
    n, d = X.shape
    base = float(y.mean())
    pred = numpy.full(n, base, numpy.float64)
    thresholds = []
    for j in range(d):
        vals = numpy.unique(X[:, j])
        if len(vals) < 2:
            thresholds.append(numpy.empty(0, numpy.float64))
            continue
        mids = (vals[1:] + vals[:-1]) / 2.0
        if len(mids) > max_thresholds:
            idx = numpy.unique(numpy.linspace(
                0, len(mids) - 1, max_thresholds).round().astype(int))
            mids = mids[idx]
        thresholds.append(mids)
    stumps = []
    for _ in range(rounds):
        resid = y - pred
        total = resid.sum()
        best = None   # (gain, j, threshold, left_mean, right_mean)
        for j in range(d):
            ts = thresholds[j]
            if not len(ts):
                continue
            left = X[None, :, j] <= ts[:, None]      # (T, n)
            nl = left.sum(axis=1)
            sl = (left * resid[None, :]).sum(axis=1)
            nr = n - nl
            sr = total - sl
            valid = (nl > 0) & (nr > 0)
            gain = numpy.where(
                valid,
                sl ** 2 / numpy.maximum(nl, 1)
                + sr ** 2 / numpy.maximum(nr, 1),
                -numpy.inf)
            ti = int(numpy.argmax(gain))
            if not numpy.isfinite(gain[ti]):
                continue
            if best is None or gain[ti] > best[0] + 1e-12:
                best = (float(gain[ti]), j, float(ts[ti]),
                        float(sl[ti] / nl[ti]),
                        float(sr[ti] / nr[ti]))
        if best is None:
            break
        _, j, t, lv, rv = best
        lv *= learning_rate
        rv *= learning_rate
        stumps.append((j, t, lv, rv))
        pred += numpy.where(X[:, j] <= t, lv, rv)
    return base, stumps


class CostModel(object):
    """One family's learned slope regressor.

    ``fit(rows)`` takes measurement-log rows (``{"digest", "payload",
    "schedule", "slope"}``); ``predict_seconds``/``predict_rank``
    score candidate schedules for one spec; ``validate()`` is the
    leave-one-spec-out audit the trust gate runs."""

    def __init__(self, op, rounds=120, learning_rate=0.1,
                 max_thresholds=32):
        self.op = op
        self.rounds = int(rounds)
        self.learning_rate = float(learning_rate)
        self.max_thresholds = int(max_thresholds)
        self.base = 0.0
        self.stumps = []
        self._rows = []

    # -- training ------------------------------------------------------------

    def _design(self, rows):
        X = numpy.stack([featurize(_spec_of(row["payload"]),
                                   row["schedule"]) for row in rows])
        y = numpy.log(numpy.maximum(
            numpy.asarray([row["slope"] for row in rows],
                          numpy.float64), 1e-12))
        return X, y

    def fit(self, rows):
        rows = list(rows)
        if not rows:
            raise ValueError("cost model needs at least one triple")
        self._rows = rows
        X, y = self._design(rows)
        self.base, self.stumps = _fit_boost(
            X, y, self.rounds, self.learning_rate,
            self.max_thresholds)
        return self

    # -- prediction ----------------------------------------------------------

    def _predict_matrix(self, X):
        pred = numpy.full(X.shape[0], self.base, numpy.float64)
        for j, t, lv, rv in self.stumps:
            pred += numpy.where(X[:, j] <= t, lv, rv)
        return pred

    def predict_seconds(self, spec, schedules):
        """Predicted slope seconds per candidate schedule (rank is
        what matters; the absolute scale is only as good as the
        training slopes)."""
        X = numpy.stack([featurize(spec, s) for s in schedules])
        return numpy.exp(self._predict_matrix(X))

    def predict_rank(self, spec, schedules):
        """Candidate indices, predicted-fastest first; ties break on
        the lower index (deterministic)."""
        pred = self.predict_seconds(spec, schedules)
        return sorted(range(len(schedules)),
                      key=lambda i: (float(pred[i]), i))

    # -- validation ----------------------------------------------------------

    def validate(self):
        """Leave-one-spec-out: ``{"error", "spearman", "groups"}``
        where error = 1 - mean held-out Spearman over the scorable
        spec groups (None when NO group is scorable — an unvalidatable
        model must read as untrusted, not as perfect)."""
        groups = {}
        for i, row in enumerate(self._rows):
            groups.setdefault(row["digest"], []).append(i)
        scorable = []
        for digest in sorted(groups):
            indices = groups[digest]
            distinct = {json.dumps(self._rows[i]["schedule"],
                                   sort_keys=True) for i in indices}
            if (len(distinct) >= _MIN_GROUP
                    and len(self._rows) - len(indices) >= _MIN_GROUP):
                scorable.append((len(indices), digest))
        scorable = [digest for _, digest in
                    sorted(scorable, key=lambda g: (-g[0], g[1]))]
        scorable = scorable[:_MAX_GROUPS]
        rhos = []
        for digest in scorable:
            held = set(groups[digest])
            train = [row for i, row in enumerate(self._rows)
                     if i not in held]
            probe = CostModel(self.op, self.rounds,
                              self.learning_rate,
                              self.max_thresholds).fit(train)
            # collapse duplicate schedules to their median slope so a
            # re-measured schedule does not flood the rank with ties
            by_schedule = {}
            for i in held:
                row = self._rows[i]
                key = json.dumps(row["schedule"], sort_keys=True)
                by_schedule.setdefault(
                    key, (row["schedule"], []))[1].append(row["slope"])
            schedules = [by_schedule[k][0]
                         for k in sorted(by_schedule)]
            actual = [float(numpy.median(by_schedule[k][1]))
                      for k in sorted(by_schedule)]
            spec = _spec_of(self._rows[next(iter(held))]["payload"])
            pred = probe.predict_seconds(spec, schedules)
            rhos.append(spearman(pred, actual))
        if not rhos:
            return {"error": None, "spearman": None, "groups": 0}
        rho = float(numpy.mean(rhos))
        return {"error": 1.0 - rho, "spearman": rho,
                "groups": len(rhos)}


def train_for(op, mode="measure", log=None, min_triples=MIN_TRIPLES,
              trust_error=TRUST_ERROR, kind=None):
    """(model, info): the trained-and-trusted CostModel for one
    family, or (None, info) with ``info["fallback"]`` naming why the
    tuner must use measured fitness (``"thin-data"`` below
    ``min_triples`` rows, ``"untrusted"`` above the validation-error
    threshold or unvalidatable).  ``kind``: the device kind whose rows
    train it (default: :func:`~veles_tpu_torch.tune.cache.device_kind`)."""
    log = log or _cache.measurement_log()
    rows = log.rows(op=op, mode=mode, kind=kind)
    info = {"family": op, "mode": mode, "triples": len(rows),
            "min_triples": int(min_triples),
            "trust_error": float(trust_error),
            "error": None, "spearman": None, "groups": 0,
            "trusted": False, "fallback": None}
    if len(rows) < min_triples:
        info["fallback"] = "thin-data"
        return None, info
    model = CostModel(op).fit(rows)
    val = model.validate()
    info.update(error=val["error"], spearman=val["spearman"],
                groups=val["groups"])
    if val["error"] is None or val["error"] > trust_error:
        info["fallback"] = "untrusted"
        return None, info
    info["trusted"] = True
    return model, info
