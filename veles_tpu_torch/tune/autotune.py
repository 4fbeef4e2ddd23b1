"""The genetics-driven schedule tuner.

Counterpart of ``veles_tpu/tune/autotune.py``.  A :class:`ScheduleTuner`
searches one kernel family's launch parameters (``tune/spec.py``) for
one (op, key shape, dtype, precision level, device kind) spec with the
port's GA (:mod:`veles_tpu_torch.genetics`) and persists the winner in
the :class:`~veles_tpu_torch.tune.cache.ScheduleCache` the kernels
consult.

Fitness = **negative measured seconds per kernel call** under the
shared discipline (``tune/measure.py``): a whole generation's
candidates are timed together with interleaved round-robin slope
samples on the card's clock (device time behind a spin), ranked by the
positive-majority median.  Candidates are quantized onto the family's
legal values and checked against the card's limits BEFORE any launch;
duplicate or clamp-identical genomes hit the schedule-keyed fitness
memo (and the GA's values-keyed memo) and are never launched twice.

Fitness modes:

- ``measure``: the timing above;
- ``compile``: build the kernels and launch each candidate once, no
  timing (fitness = negative wall seconds of that first call): the CI
  mode, which still refuses candidates the kernel rejects;
- ``model``: the learned cost model (``tune/costmodel.py``) ranks a
  generation's distinct feasible schedules and only the top decile
  (floor 2) is launched and measured under ``model_base``; the rest
  carry their PREDICTED fitness for selection only.  The persisted
  winner is always a measured one.  Thin data or a model that fails its
  trust gate degrades to the base mode.

Every measured slope is appended to the ``measurements.jsonl`` sidecar,
the model's training data.  ``workers=N`` evaluates candidates in
spawned processes, ``farm_slaves`` / ``farm_address`` through the job
farm (:mod:`veles_tpu_torch.jobfarm`; remote hosts join with ``python -m
veles_tpu_torch.tune --worker HOST:PORT``, which quotes
:func:`evaluate_candidate`): each candidate gets its own timing there,
on the device the master names, and only the in-process default times a
generation's candidates interleaved.  ``fitness="model"`` falls back to
the base mode for a pool or farm run.  Each generation runs in a
``tune.generation`` tracer span and each spec's tuning in a
``tune.spec`` span.
"""

import json
import time

import torch

from veles_tpu_torch.genetics.config import extract_tunes
from veles_tpu_torch.genetics.optimizer import GeneticsOptimizer
from veles_tpu_torch.jobfarm import farm_enabled
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.tune import cache as _cache
from veles_tpu_torch.tune import measure as _measure
from veles_tpu_torch.tune.spec import (card_limits, family_for,
                                       valid_schedule)

__all__ = ["ScheduleTuner", "evaluate_candidate", "sweep_candidates",
           "default_device", "PENALTY"]

#: fitness for infeasible / failing / unmeasurable candidates: large
#: negative but FINITE, so roulette selection stays well defined
PENALTY = -1.0e9


def default_device():
    """The device a tuner measures on when none is named: the card.
    (The CPU runs only when asked for, as the tests do.)"""
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cuda")


def _schedule_memo_key(schedule):
    return json.dumps(schedule, sort_keys=True)


def _compile_runner(family, spec, schedule, device):
    """(run, seconds of the first call) or (None, None) when the
    candidate fails to build or launch: a PENALTY, never a crash."""
    try:
        warm, run = family.build_runner(spec, schedule, device)
        start = time.perf_counter()
        warm()
        return run, time.perf_counter() - start
    except Exception:
        return None, None


def _timed_fitness(run, repeats, rounds, device):
    """Multi-pass filtered slope timing of one warm runner: ``rounds``
    passes, positive-majority median, PENALTY when every pass measured
    noise."""
    samples = [_measure.slope_sample(run, 1, repeats + 1, device)
               for _ in range(rounds)]
    med = _measure.positive_majority_median(samples)
    return PENALTY if med is None else -med


def _record_triple(spec, schedule, slope, mode, kind):
    """Append one measured (spec, schedule, slope) triple to the
    sidecar; never raises."""
    try:
        digest, payload = _cache.schedule_key(
            spec["op"], spec["shape"], spec["dtype"],
            spec["precision_level"], kind, spec.get("extra"))
        _cache.record_measurement(digest, payload, schedule, slope,
                                  mode=mode)
    except Exception:
        pass


def evaluate_candidate(candidate):
    """Per-candidate fitness, module-level and self-contained so the
    process pool can pickle it and a farm worker can quote it.
    ``candidate`` is the GA's applied spec: ``{"family", "spec", "genes",
    "fitness_mode", "repeats", "rounds", "device"}``."""
    family = family_for(candidate["family"])
    spec = candidate["spec"]
    device = torch.device(candidate.get("device") or default_device())
    schedule = family.quantize(spec, candidate["genes"])
    if not family.feasible(spec, schedule, card_limits(device)):
        return PENALTY
    run, compile_s = _compile_runner(family, spec, schedule, device)
    if run is None:
        return PENALTY
    _registry.counter("tune.evals").inc()
    kind = _cache.device_kind(device)
    if candidate.get("fitness_mode") == "compile":
        _record_triple(spec, schedule, compile_s, "compile", kind)
        return -compile_s
    fitness = _timed_fitness(run, candidate.get("repeats", 8),
                             candidate.get("rounds", 3), device)
    if fitness > PENALTY:
        _record_triple(spec, schedule, -fitness, "measure", kind)
    return fitness


class _TunerGA(GeneticsOptimizer):
    """GeneticsOptimizer that tracks the genuinely dispatched
    (non-memoized) evaluations for the receipt.  ``snap_fn`` projects
    raw genomes onto the quantized schedule lattice BEFORE the memo
    lookup, so genomes that clamp to one schedule are one genome on
    every evaluator path."""

    def __init__(self, *args, snap_fn=None, **kwargs):
        super(_TunerGA, self).__init__(*args, **kwargs)
        self.snap_fn = snap_fn
        self.dispatched = 0

    def _evaluate_all(self):
        if self.snap_fn is not None:
            for chromo in self.population.unevaluated():
                chromo.values = self.snap_fn(chromo.values)
        memo_before = len(self._fitness_memo)
        pending = len(self.population.unevaluated())
        with _tracer.span("tune.generation", cat="tune",
                          generation=self.population.generation,
                          pending=pending):
            super(_TunerGA, self)._evaluate_all()
        self.dispatched += (len(self._fitness_memo) - memo_before
                            if self.memoize_fitness else pending)


class ScheduleTuner(Logger):
    """Tune ONE (op, shape, dtype, precision, device) spec.

    ``spec`` comes from the ``tune/spec.py`` builders or a
    ``record_specs`` walk; ``device`` is where the candidates run (the
    card unless named).  :meth:`tune` consults the schedule cache first
    (a valid hit skips the GA); on a miss it runs the GA, its population
    seeded with the family's seeds (the rule's plan first), and persists
    the winner."""

    def __init__(self, spec, cache=None, generations=4, population=8,
                 workers=0, farm_slaves=0, farm_address="127.0.0.1:0",
                 fitness="measure", repeats=8, rounds=3, rng=None,
                 device=None, device_kind=None, model_base="measure",
                 model_min_triples=None, model_trust=None, **kwargs):
        super(ScheduleTuner, self).__init__(**kwargs)
        self.spec = dict(spec)
        self.family = family_for(self.spec["op"])
        self.cache = cache or _cache.cache_for()
        self.generations = generations
        self.population = population
        self.workers = workers
        self.farm_slaves = farm_slaves
        self.farm_address = farm_address
        self.fitness_mode = fitness
        self.repeats = repeats
        self.rounds = rounds
        self.rng = rng
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.device_kind = device_kind or _cache.device_kind(self.device)
        self.limits = card_limits(self.device)
        self.model_base = model_base
        self.model_min_triples = model_min_triples
        self.model_trust = model_trust
        #: candidates scored in a pool's children or the farm's workers
        self._elsewhere = bool(workers) or farm_enabled(farm_slaves,
                                                        farm_address)
        if fitness == "model" and self._elsewhere:
            # model ranking needs the in-process batch evaluator (the
            # pool's children and the farm's workers score candidates
            # one by one); degrade to the base mode rather than mis-rank
            self.warning("tune: fitness='model' is in-process only; "
                         "using fitness=%r for the pool/farm run",
                         model_base)
            self.fitness_mode = model_base
        self._model = None
        self._model_info = None
        self._best_measured = (PENALTY, None)
        self._sched_memo = {}

    @property
    def _measure_mode(self):
        """The mode actual measurements run under: the base mode in
        (and under fallback from) fitness='model'."""
        if self.fitness_mode == "model":
            return self.model_base
        return self.fitness_mode

    def key(self):
        return _cache.schedule_key(
            self.spec["op"], self.spec["shape"], self.spec["dtype"],
            self.spec["precision_level"], self.device_kind,
            self.spec.get("extra"))

    # -- the in-process batch evaluator (interleaved discipline) -------------

    def _batch_fitness(self, candidates):
        fits = [None] * len(candidates)
        to_measure = {}   # schedule memo key -> (schedule, [indices])
        for i, cand in enumerate(candidates):
            schedule = self.family.quantize(self.spec, cand["genes"])
            key = _schedule_memo_key(schedule)
            if key in self._sched_memo:
                fits[i] = self._sched_memo[key]
            elif not self.family.feasible(self.spec, schedule,
                                          self.limits):
                fits[i] = self._sched_memo[key] = PENALTY
            else:
                entry = to_measure.setdefault(key, (schedule, []))
                entry[1].append(i)

        measure_keys = list(to_measure)
        if self._model is not None and len(measure_keys) > 2:
            # model mode: rank the distinct feasible schedules, launch
            # and measure only the top decile (floor 2); the rest carry
            # their PREDICTED fitness: selection only, never persisted
            schedules = [to_measure[key][0] for key in measure_keys]
            predicted = self._model.predict_seconds(self.spec,
                                                    schedules)
            order = sorted(range(len(measure_keys)),
                           key=lambda i: (float(predicted[i]), i))
            top = max(2, -(-len(measure_keys) // 10))
            for rank_i in order[top:]:
                key = measure_keys[rank_i]
                fitness = -float(predicted[rank_i])
                self._sched_memo[key] = fitness
                self._model_info["predicted"] += 1
                for i in to_measure[key][1]:
                    fits[i] = fitness
            measure_keys = [measure_keys[rank_i]
                            for rank_i in order[:top]]

        mode = self._measure_mode
        runners, compile_s = {}, {}
        for key in measure_keys:
            schedule, indices = to_measure[key]
            run, seconds = _compile_runner(self.family, self.spec,
                                           schedule, self.device)
            if run is None:
                self._sched_memo[key] = PENALTY
                for i in indices:
                    fits[i] = PENALTY
                continue
            _registry.counter("tune.evals").inc()
            runners[key] = run
            compile_s[key] = seconds

        if mode == "compile":
            ranked = {key: compile_s[key] for key in runners}
        else:
            # ONE sample of every candidate per pass: drift spreads
            # across all candidates equally
            samples = _measure.interleaved_slopes(
                runners, 1, self.repeats + 1, rounds=self.rounds,
                device=self.device)
            ranked = _measure.rank(samples)

        for key in runners:
            med = ranked.get(key)
            fitness = PENALTY if med is None else -med
            self._sched_memo[key] = fitness
            if med is not None:
                schedule = to_measure[key][0]
                _record_triple(self.spec, schedule, med, mode,
                               self.device_kind)
                if fitness > self._best_measured[0]:
                    self._best_measured = (fitness, schedule)
            for i in to_measure[key][1]:
                fits[i] = fitness
        return fits

    # -- the cost model ------------------------------------------------------

    def _setup_model(self):
        """Train-and-trust-gate the family's cost model from the
        measurement sidecar; on thin data or a failed gate ``self._model``
        stays None and the run degrades to the base mode (the receipt
        row's ``model.fallback`` says why)."""
        from veles_tpu_torch.tune import costmodel
        kwargs = {}
        if self.model_min_triples is not None:
            kwargs["min_triples"] = self.model_min_triples
        if self.model_trust is not None:
            kwargs["trust_error"] = self.model_trust
        try:
            model, info = costmodel.train_for(
                self.family.name, mode=self.model_base,
                kind=self.device_kind, **kwargs)
        except Exception as exc:
            model, info = None, {"family": self.family.name,
                                 "fallback": "train-error: %s" % exc}
        self._model = model
        info["predicted"] = 0
        self._model_info = info
        if model is None:
            self.warning(
                "tune: cost model unavailable for %s (%s); measuring "
                "every candidate (fitness=%r)", self.family.name,
                info.get("fallback"), self.model_base)

    # -- the GA run ----------------------------------------------------------

    def _ga_spec(self, space):
        return {
            "family": self.family.name,
            "spec": {k: v for k, v in self.spec.items()},
            "genes": space,
            # the pool's children and the farm's workers measure every
            # candidate they get
            "fitness_mode": self._measure_mode,
            "repeats": self.repeats,
            "rounds": self.rounds,
            "device": str(self.device),
        }

    def _snap_genome(self, space):
        """A genome -> genome projection onto the quantized schedule
        lattice, so two genomes that clamp to one schedule ARE one
        genome."""
        import numpy
        order = [path[-1] for path, _ in extract_tunes(space)]

        def snap(values):
            genes = dict(zip(order, (float(v) for v in values)))
            schedule = self.family.quantize(self.spec, genes)
            snapped = self.family.genes_of(schedule)
            return numpy.asarray([float(snapped[name])
                                  for name in order], numpy.float64)

        return snap

    def _seed_population(self, opt):
        """Overwrite the random initial genomes with the family's seeds
        (the rule's plan first, clamped into the Tune boxes): the GA
        starts from the static plan and mutation explores around it."""
        import numpy
        tunes = opt.tunes  # [(path, Tune)] in the GA's gene order
        seeds = self.family.seeds(self.spec, self.limits)
        for chromo, schedule in zip(opt.population.chromosomes, seeds):
            genes = self.family.genes_of(schedule)
            chromo.values = numpy.asarray(
                [min(max(float(genes[path[-1]]), tune.min), tune.max)
                 for path, tune in tunes], numpy.float64)
            chromo.fitness = None

    def tune(self, force=False):
        """Returns the receipt row: ``{"digest", "op", "shape",
        "dtype", "schedule", "fitness", "source", "evals", "genomes"}``
        with ``source`` one of ``cache`` / ``ga`` / ``untunable`` /
        ``unranked``."""
        digest, payload = self.key()
        row = {"digest": digest, "op": self.spec["op"],
               "shape": list(self.spec["shape"]),
               "dtype": self.spec["dtype"],
               "precision_level": self.spec["precision_level"],
               "evals": 0, "genomes": 0}
        if not force:
            entry = self.cache.get(digest)
            if entry is not None:
                # the kernels' consult validation: an entry they would
                # reject is a MISS here too, retuned and overwritten
                normalized = valid_schedule(self.spec["op"],
                                            entry["schedule"], self.spec)
                if normalized is not None:
                    row.update(schedule=normalized,
                               fitness=entry.get("fitness"),
                               source="cache")
                    _registry.counter("tune.cache_hits").inc()
                    return row
        _registry.counter("tune.cache_misses").inc()

        space = self.family.space(self.spec)
        if space is None:
            row.update(schedule=None, source="untunable")
            return row

        if self.fitness_mode == "model":
            self._setup_model()
            row["model"] = self._model_info

        batch = None if self._elsewhere else self._batch_fitness
        opt = _TunerGA(
            self._ga_spec(space), evaluate_candidate,
            generations=self.generations, population=self.population,
            workers=self.workers, farm_slaves=self.farm_slaves,
            farm_address=self.farm_address, rng=self.rng,
            batch_fitness_fn=batch, device=self.device.type,
            snap_fn=self._snap_genome(space))
        self._seed_population(opt)
        evals_before = _registry.counter("tune.evals").value
        with _tracer.span("tune.spec", cat="tune", op=self.spec["op"],
                          digest=digest[:12]):
            best_candidate, best_fitness = opt.run()
        # "evals" = candidates actually built and launched (the
        # tune.evals delta; infeasible and memo-hit genomes are free);
        # "genomes" = distinct genomes the GA dispatched.  In pool
        # children and remote farm workers the counter ticks elsewhere:
        # count dispatches there rather than claim none
        evals = _registry.counter("tune.evals").value - evals_before
        if self._elsewhere and evals == 0:
            evals = opt.dispatched
        row["evals"] = evals
        row["genomes"] = opt.dispatched

        if self._model is not None:
            # only a MEASURED winner may be persisted or reported
            best_fitness, best_schedule = self._best_measured
            if best_fitness > PENALTY:
                self.cache.put(digest, payload, best_schedule,
                               fitness=best_fitness, source="ga",
                               evals=evals)
                row.update(schedule=best_schedule,
                           fitness=best_fitness, source="ga")
                self.info(
                    "tune: %s %s -> %s (model-ranked; fitness %.3g, "
                    "%d evals / %d genomes, %d predicted-only)",
                    self.spec["op"], tuple(self.spec["shape"]),
                    best_schedule, best_fitness, evals,
                    opt.dispatched, self._model_info["predicted"])
                return row

        if best_fitness <= PENALTY:
            # nothing rankable: do NOT persist (the static plans keep
            # serving; a later, quieter run may succeed)
            self.warning(
                "tune: no candidate for %s %s produced a rankable "
                "measurement; keeping the static plan",
                self.spec["op"], tuple(self.spec["shape"]))
            row.update(schedule=None, source="unranked")
            return row

        schedule = self.family.quantize(self.spec,
                                        best_candidate["genes"])
        self.cache.put(digest, payload, schedule,
                       fitness=best_fitness, source="ga", evals=evals)
        row.update(schedule=schedule, fitness=best_fitness,
                   source="ga")
        self.info("tune: %s %s -> %s (fitness %.3g, %d evals / %d "
                  "genomes)", self.spec["op"],
                  tuple(self.spec["shape"]), schedule, best_fitness,
                  evals, opt.dispatched)
        return row


def sweep_candidates(spec, candidates, repeats=24, rounds=5,
                     device_kind=None, cache=None, persist=True,
                     fitness="measure", device=None):
    """The plain candidate sweep (no GA) under the same measurement
    discipline and persistence path: what ``ops.matmul.autotune_matmul``
    runs.  ``candidates`` are schedule dicts; clamp-identical ones are
    measured once.  Returns ``(best_schedule_or_None, ranking)``, the
    ranking mapping each distinct schedule's memo key to its median
    seconds (None: rejected as noise)."""
    family = family_for(spec["op"])
    device = torch.device(device) if device is not None \
        else default_device()
    limits = card_limits(device)
    kind = device_kind or _cache.device_kind(device)
    distinct = {}
    for candidate in candidates:
        schedule = family.quantize(spec, family.genes_of(candidate))
        key = _schedule_memo_key(schedule)
        if key not in distinct and family.feasible(spec, schedule,
                                                   limits):
            distinct[key] = schedule

    runners, compile_s = {}, {}
    for key, schedule in distinct.items():
        run, seconds = _compile_runner(family, spec, schedule, device)
        if run is None:
            continue
        _registry.counter("tune.evals").inc()
        runners[key] = run
        compile_s[key] = seconds

    if fitness == "compile":
        ranking = {key: compile_s[key] for key in runners}
    else:
        samples = _measure.interleaved_slopes(
            runners, 1, repeats + 1, rounds=rounds, device=device)
        ranking = _measure.rank(samples)
    for key, med in ranking.items():
        if med is not None:
            _record_triple(spec, distinct[key], med, fitness, kind)
    best_key, best_time = None, float("inf")
    for key, med in ranking.items():
        if med is not None and med < best_time:
            best_key, best_time = key, med
    if best_key is None:
        return None, ranking
    best = distinct[best_key]
    if persist:
        digest, payload = _cache.schedule_key(
            spec["op"], spec["shape"], spec["dtype"],
            spec["precision_level"], kind, spec.get("extra"))
        (cache or _cache.cache_for()).put(
            digest, payload, best, fitness=-best_time, source="sweep",
            evals=len(runners))
    return best, ranking
