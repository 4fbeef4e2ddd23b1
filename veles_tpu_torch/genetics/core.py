"""GA core: chromosomes, population, selection and mutation operators.

Counterpart of ``veles_tpu/genetics/core.py``, line for line: numeric and
gray-coded binary chromosome representations, roulette-wheel selection,
single/two-point crossover, several mutation operators (uniform reset,
gaussian jitter, binary bit-flip), elitism, reproducibility through the
keyed PRNG.  The draws come from the port's :mod:`veles_tpu_torch.prng`,
which gives the JAX package's numpy draws bit for bit, so one seed walks
the same genomes in both packages.
"""

import numpy

from veles_tpu_torch import prng as prng_module

__all__ = ["Chromosome", "Population", "gray_encode", "gray_decode"]


def gray_encode(value, vmin, vmax, bits):
    """Quantize value in [vmin, vmax] to a gray-coded integer."""
    span = (1 << bits) - 1
    frac = 0.0 if vmax == vmin else (value - vmin) / (vmax - vmin)
    n = int(round(numpy.clip(frac, 0.0, 1.0) * span))
    return n ^ (n >> 1)

def gray_decode(code, vmin, vmax, bits):
    n = code
    shift = 1
    while shift < bits:
        n ^= n >> shift
        shift <<= 1
    span = (1 << bits) - 1
    return vmin + (vmax - vmin) * (n / span if span else 0.0)


class Chromosome(object):
    """One candidate: numeric genome over [mins, maxs] boxes.

    ``binary_bits``: when set, genes live as gray-coded integers of that
    many bits (the reference's binary representation); mutation flips
    bits instead of jittering floats.
    """

    def __init__(self, mins, maxs, rng, values=None, binary_bits=None):
        self.mins = numpy.asarray(mins, numpy.float64)
        self.maxs = numpy.asarray(maxs, numpy.float64)
        self.binary_bits = binary_bits
        self.fitness = None
        if values is not None:
            self.values = numpy.asarray(values, numpy.float64)
        else:
            self.values = self.mins + rng.random_sample(
                len(self.mins)) * (self.maxs - self.mins)

    def copy(self):
        c = Chromosome(self.mins, self.maxs, None, values=self.values,
                       binary_bits=self.binary_bits)
        c.fitness = self.fitness
        return c

    # -- mutation operators --------------------------------------------------

    def mutate_uniform(self, rng, rate):
        for i in range(len(self.values)):
            if rng.random_sample() < rate:
                self.values[i] = self.mins[i] + rng.random_sample() * (
                    self.maxs[i] - self.mins[i])
        self.fitness = None

    def mutate_gaussian(self, rng, rate, scale=0.1):
        for i in range(len(self.values)):
            if rng.random_sample() < rate:
                span = self.maxs[i] - self.mins[i]
                self.values[i] = float(numpy.clip(
                    self.values[i] + rng.normal(0, scale * span),
                    self.mins[i], self.maxs[i]))
        self.fitness = None

    def mutate_binary(self, rng, rate):
        bits = self.binary_bits or 16
        for i in range(len(self.values)):
            code = gray_encode(self.values[i], self.mins[i], self.maxs[i],
                               bits)
            for b in range(bits):
                if rng.random_sample() < rate:
                    code ^= 1 << b
            self.values[i] = gray_decode(code, self.mins[i], self.maxs[i],
                                         bits)
        self.fitness = None


class Population(object):
    """Roulette GA loop (reference genetics/core.py:371-).

    fitness is MAXIMIZED; use -metric for minimization.
    """

    def __init__(self, mins, maxs, size=20, rng=None, binary_bits=None,
                 crossover="two_point", mutation="gaussian",
                 mutation_rate=0.2, elite=2):
        self.rng = rng or prng_module.get("genetics")
        self.mins = list(mins)
        self.maxs = list(maxs)
        self.binary_bits = binary_bits
        self.crossover = crossover
        self.mutation = mutation
        self.mutation_rate = mutation_rate
        self.elite = elite
        self.generation = 0
        self.chromosomes = [
            Chromosome(mins, maxs, self.rng, binary_bits=binary_bits)
            for _ in range(size)]

    @property
    def best(self):
        evaluated = [c for c in self.chromosomes if c.fitness is not None]
        return max(evaluated, key=lambda c: c.fitness) if evaluated \
            else None

    def unevaluated(self):
        return [c for c in self.chromosomes if c.fitness is None]

    # -- selection -----------------------------------------------------------

    def _roulette_pick(self):
        fits = numpy.array([c.fitness for c in self.chromosomes],
                           numpy.float64)
        shifted = fits - fits.min() + 1e-12
        probs = shifted / shifted.sum()
        r = self.rng.random_sample()
        return self.chromosomes[int(numpy.searchsorted(
            numpy.cumsum(probs), r))]

    def _crossover(self, a, b):
        n = len(a.values)
        values = numpy.array(a.values)
        if self.crossover == "single_point":
            point = int(self.rng.random_sample() * n)
            values[point:] = b.values[point:]
        elif self.crossover == "two_point":
            p1 = int(self.rng.random_sample() * n)
            p2 = int(self.rng.random_sample() * n)
            p1, p2 = min(p1, p2), max(p1, p2)
            values[p1:p2] = b.values[p1:p2]
        else:  # uniform
            for i in range(n):
                if self.rng.random_sample() < 0.5:
                    values[i] = b.values[i]
        return Chromosome(self.mins, self.maxs, self.rng, values=values,
                          binary_bits=self.binary_bits)

    def _mutate(self, chromo):
        if self.mutation == "uniform":
            chromo.mutate_uniform(self.rng, self.mutation_rate)
        elif self.mutation == "binary":
            chromo.mutate_binary(self.rng, self.mutation_rate)
        else:
            chromo.mutate_gaussian(self.rng, self.mutation_rate)

    def evolve(self):
        """All chromosomes must be evaluated; produce the next
        generation (elitism + roulette crossover + mutation)."""
        if self.unevaluated():
            raise RuntimeError("evolve() with unevaluated chromosomes")
        ranked = sorted(self.chromosomes, key=lambda c: -c.fitness)
        next_gen = [c.copy() for c in ranked[:self.elite]]
        while len(next_gen) < len(self.chromosomes):
            child = self._crossover(self._roulette_pick(),
                                    self._roulette_pick())
            self._mutate(child)
            next_gen.append(child)
        self.chromosomes = next_gen
        self.generation += 1
