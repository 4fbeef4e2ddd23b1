"""GeneticsOptimizer: evolve a population by evaluating candidate
configurations as jobs.

Counterpart of ``veles_tpu/genetics/optimizer.py``.  Evaluations run
through a pluggable evaluator:

- in-process (default): ``fitness_fn(candidate_spec) -> float``;
- a whole generation at once: ``batch_fitness_fn(specs) -> [float]``
  (the schedule autotuner's interleaved timing);
- process pool: ``workers=N`` evaluates candidates concurrently in
  subprocesses started with the ``spawn`` method (a forked child cannot
  use CUDA), so ``fitness_fn`` must be picklable by reference;
- control plane: ``farm_slaves=N`` farms each generation's candidate
  specs as jobs through the port's Server/Client stack
  (:class:`veles_tpu_torch.jobfarm.JobFarm`), one farm for the whole
  optimization, shut down when :meth:`GeneticsOptimizer.run` ends;
  remote hosts join with :meth:`GeneticsOptimizer.worker`.  ``device``
  is where the farm's workers run (the card unless the CPU is asked
  for, see ``jobfarm.py``).

Fitness is MAXIMIZED (use -validation_error).
"""

import concurrent.futures
import multiprocessing

from veles_tpu_torch.genetics.config import apply_values, extract_tunes
from veles_tpu_torch.genetics.core import Population
from veles_tpu_torch.logger import Logger

__all__ = ["GeneticsOptimizer"]


class GeneticsOptimizer(Logger):

    FARM_TAG = "genetics"

    def __init__(self, spec, fitness_fn, generations=5, population=12,
                 workers=0, farm_slaves=0, farm_address="127.0.0.1:0",
                 rng=None, batch_fitness_fn=None, memoize_fitness=True,
                 device=None, **population_kwargs):
        super(GeneticsOptimizer, self).__init__()
        self.spec = spec
        self.fitness_fn = fitness_fn
        self.generations = generations
        self.workers = workers
        self.farm_slaves = farm_slaves
        self.farm_address = farm_address
        #: where the farm's workers run (None: -d / VELES_BACKEND, else
        #: the card)
        self.device = device
        #: optional whole-generation evaluator ``fn(specs) -> [fitness]``
        #: for fitness functions that must see a generation's candidates
        #: together (the schedule autotuner's interleaved round-robin
        #: timing); ignored on the farm and process-pool paths
        self.batch_fitness_fn = batch_fitness_fn
        #: a values-keyed memo: a genome evolve() recreates (elitism,
        #: crossover of agreeing parents) never pays a second evaluation
        self.memoize_fitness = memoize_fitness
        self._fitness_memo = {}
        self.tunes = extract_tunes(spec)
        if not self.tunes:
            raise ValueError("spec contains no Tune markers")
        mins = [t.min for _, t in self.tunes]
        maxs = [t.max for _, t in self.tunes]
        self.population = Population(
            mins, maxs, size=population, rng=rng, **population_kwargs)
        self.history = []  # (generation, best_fitness, best_spec)
        self._farm = None
        #: the farm's accounting after run() (jobfarm.JobFarm.stats)
        self.farm_stats = None

    def candidate_spec(self, chromosome):
        return apply_values(self.spec, self.tunes, chromosome.values)

    def worker(self, address):
        """Blocking remote-worker loop: evaluate the candidate specs the
        optimizing master at ``address`` hands out (the worker quotes the
        same fitness_fn).  Returns the number of evaluations."""
        from veles_tpu_torch.jobfarm import JobFarm
        return JobFarm(self.FARM_TAG, device=self.device).worker(
            address, self.fitness_fn)

    @property
    def farm_enabled(self):
        from veles_tpu_torch.jobfarm import farm_enabled
        return farm_enabled(self.farm_slaves, self.farm_address)

    @staticmethod
    def _genome_key(chromosome):
        return tuple(float(v) for v in chromosome.values)

    def _evaluate_all(self):
        pending = self.population.unevaluated()
        if self.memoize_fitness:
            # serve memo hits, then collapse the remainder onto one
            # representative per distinct genome
            groups = {}
            for chromo in pending:
                key = self._genome_key(chromo)
                memoized = self._fitness_memo.get(key)
                if memoized is not None:
                    chromo.fitness = memoized
                else:
                    groups.setdefault(key, []).append(chromo)
            reps = [chromos[0] for chromos in groups.values()]
        else:
            groups = None
            reps = pending
        specs = [self.candidate_spec(c) for c in reps]
        if self.farm_enabled and specs:
            # one farm for the whole optimization: remote workers stay
            # connected between generations
            if self._farm is None:
                from veles_tpu_torch.jobfarm import JobFarm
                self._farm = JobFarm(self.FARM_TAG, device=self.device)
                self._farm.start(runner=self.fitness_fn,
                                 address=self.farm_address,
                                 local_slaves=self.farm_slaves)
            fits = self._farm.submit(specs)
        elif self.workers and len(reps) > 1:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context(
                        "spawn")) as pool:
                fits = list(pool.map(self.fitness_fn, specs))
        elif self.batch_fitness_fn is not None:
            fits = list(self.batch_fitness_fn(specs)) if specs else []
        else:
            fits = [self.fitness_fn(spec) for spec in specs]
        for chromo, fitness in zip(reps, fits):
            fitness = float(fitness)
            if groups is None:
                chromo.fitness = fitness
                continue
            key = self._genome_key(chromo)
            self._fitness_memo[key] = fitness
            for duplicate in groups[key]:
                duplicate.fitness = fitness

    def run(self):
        """Returns (best_spec, best_fitness)."""
        try:
            for gen in range(self.generations):
                self._evaluate_all()
                best = self.population.best
                self.history.append(
                    (gen, best.fitness, self.candidate_spec(best)))
                self.info("generation %d best fitness %.4f", gen,
                          best.fitness)
                if gen < self.generations - 1:
                    self.population.evolve()
        finally:
            if self._farm is not None:
                self._farm.shutdown()
                self.farm_stats = self._farm.stats
                self._farm = None
        best = self.population.best
        return self.candidate_spec(best), best.fitness
