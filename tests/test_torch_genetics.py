"""The port's GA core (veles_tpu_torch/genetics/) against the JAX
package's (veles_tpu/genetics/): the same gray codes, Tune markers,
evaluation order and best genome for one seed and a pure-Python
fitness under every crossover and mutation operator, the values-keyed
fitness memo, the whole-generation evaluator, the ``spawn`` process
pool, and the farmed GA over the job farm: two farm workers give the
JAX package's farmed history, chromosomes and best (equal floats) and
the port's in-process run; a remote worker joins; without a card and
without the CPU asked for, the farm raises ``no CUDA device``."""

import operator

import numpy
import pytest

from veles_tpu_torch.genetics import (GeneticsOptimizer, Population, Tune,
                                      apply_values, extract_tunes,
                                      gray_decode, gray_encode)
from veles_tpu_torch.prng import RandomGenerator


@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_gray_roundtrip_matches_jax(bits):
    from veles_tpu.genetics import core as jax_core
    for value in numpy.linspace(-3.0, 5.0, 17):
        code = gray_encode(value, -3.0, 5.0, bits)
        assert code == jax_core.gray_encode(value, -3.0, 5.0, bits)
        assert gray_decode(code, -3.0, 5.0, bits) == \
            jax_core.gray_decode(code, -3.0, 5.0, bits)
        assert abs(gray_decode(code, -3.0, 5.0, bits) - value) <= \
            8.0 / ((1 << bits) - 1) / 2 + 1e-12


def test_tune_extract_and_apply_match_jax():
    from veles_tpu.genetics import config as jax_config
    spec = {"lr": Tune(0.1, 0.01, 1.0), "layers": [
        {"n": Tune(8, 4, 64)}, {"n": 3}], "m": {"x": Tune(0.5, 0.0, 1.0)}}
    jspec = {"lr": jax_config.Tune(0.1, 0.01, 1.0), "layers": [
        {"n": jax_config.Tune(8, 4, 64)}, {"n": 3}],
        "m": {"x": jax_config.Tune(0.5, 0.0, 1.0)}}
    tunes, jtunes = extract_tunes(spec), jax_config.extract_tunes(jspec)
    assert [p for p, _ in tunes] == [p for p, _ in jtunes]
    values = [17.6, 0.3, 0.25]   # the sorted paths: layers, lr, m
    assert apply_values(spec, tunes, values) == \
        jax_config.apply_values(jspec, jtunes, values)
    assert apply_values(spec, tunes, values)["layers"][0]["n"] == 18


def _both(seed, population_kwargs):
    """The port's and the JAX optimizer on one sphere spec and seed;
    returns (port order, port best, jax order, jax best)."""
    from veles_tpu.genetics import GeneticsOptimizer as JaxOptimizer
    from veles_tpu.genetics import Tune as JaxTune
    from veles_tpu.prng import RandomGenerator as JaxGenerator

    def run(optimizer, tune, generator):
        order = []

        def fitness(spec):
            order.append((round(spec["x"], 12), round(spec["y"], 12)))
            return -((spec["x"] - 0.3) ** 2 + (spec["y"] + 1.2) ** 2)
        opt = optimizer({"x": tune(0.0, -2.0, 2.0),
                         "y": tune(0.0, -3.0, 3.0)}, fitness,
                        generations=6, population=8,
                        rng=generator("ga", seed=seed),
                        **population_kwargs)
        best_spec, best = opt.run()
        return order, (best_spec["x"], best_spec["y"], best)
    return run(GeneticsOptimizer, Tune, RandomGenerator) + \
        run(JaxOptimizer, JaxTune, JaxGenerator)


@pytest.mark.parametrize("crossover", ["two_point", "single_point",
                                       "uniform"])
@pytest.mark.parametrize("mutation,bits", [("gaussian", None),
                                           ("uniform", None),
                                           ("binary", 8)])
def test_same_evaluation_order_and_best_as_jax(crossover, mutation, bits):
    """One seed and a pure-Python fitness: the port's GA draws JAX's
    numbers bit for bit, so it evaluates the same genomes in the same
    order and crowns the same best."""
    order, best, jax_order, jax_best = _both(
        11, dict(crossover=crossover, mutation=mutation, binary_bits=bits,
                 mutation_rate=0.3))
    assert order == jax_order and len(order) > 8
    assert best == jax_best


def test_population_converges_on_sphere():
    rng = RandomGenerator("sphere", seed=5)
    pop = Population([-5.0, -5.0], [5.0, 5.0], size=30, rng=rng)
    for _ in range(40):
        for chromo in pop.unevaluated():
            x, y = chromo.values
            chromo.fitness = -((x - 1.0) ** 2 + (y + 2.0) ** 2)
        pop.evolve()
    for chromo in pop.unevaluated():
        x, y = chromo.values
        chromo.fitness = -((x - 1.0) ** 2 + (y + 2.0) ** 2)
    assert pop.best.fitness > -0.05


def test_binary_mutation_stays_in_bounds():
    rng = RandomGenerator("bits", seed=2)
    pop = Population([0.0, -1.0], [1.0, 1.0], size=10, rng=rng,
                     binary_bits=6, mutation="binary", mutation_rate=0.5)
    for _ in range(10):
        for chromo in pop.unevaluated():
            chromo.fitness = float(sum(chromo.values))
        pop.evolve()
    for chromo in pop.chromosomes:
        assert 0.0 <= chromo.values[0] <= 1.0
        assert -1.0 <= chromo.values[1] <= 1.0


def test_evolve_refuses_unevaluated_chromosomes():
    pop = Population([0.0], [1.0], size=4,
                     rng=RandomGenerator("u", seed=1))
    with pytest.raises(RuntimeError):
        pop.evolve()


def test_duplicate_genomes_memoized_invocation_count():
    calls = []

    def fitness(spec):
        calls.append(spec["x"])
        return -(spec["x"] - 0.7) ** 2
    opt = GeneticsOptimizer(
        {"x": Tune(0.0, 0.0, 1.0)}, fitness, generations=5, population=6,
        rng=RandomGenerator("memo", seed=5), binary_bits=1,
        mutation="binary", mutation_rate=0.5)
    opt.run()
    assert len(calls) == len(set(calls))
    assert all(c.fitness is not None for c in opt.population.chromosomes)


def test_batch_fitness_path_evaluates_generations_together():
    batches = []

    def boom(spec):
        raise AssertionError("serial fitness path used")

    def batch(specs):
        batches.append(len(specs))
        return [-(s["x"] - 0.5) ** 2 for s in specs]
    opt = GeneticsOptimizer(
        {"x": Tune(0.0, 0.0, 1.0)}, boom, generations=3, population=5,
        rng=RandomGenerator("batch", seed=9), batch_fitness_fn=batch)
    opt.run()
    assert batches and batches[0] == 5
    assert len(batches) <= 3 and sum(batches) <= 15


def test_process_pool_evaluates_in_spawned_workers():
    """``workers=N`` runs the fitness in ``spawn``ed processes (a forked
    child cannot use CUDA): the fitness is picklable by reference."""
    opt = GeneticsOptimizer({"x": Tune(0.0, 0.0, 1.0)},
                            operator.itemgetter("x"), generations=2,
                            population=4, workers=2,
                            rng=RandomGenerator("pool", seed=4))
    best_spec, best = opt.run()
    assert best == best_spec["x"] and 0.0 <= best <= 1.0


def _sphere(spec):
    return -((spec["x"] - 1.0) ** 2 + (spec["y"] - 0.5) ** 2)


def _farmed(optimizer, tune, generator, crossover, **kwargs):
    """One optimizer over tests/test_genetics.py's farmed sphere spec:
    (history, [(values, fitness)], best spec, best fitness)."""
    opt = optimizer({"x": tune(0.0, -2.0, 2.0), "y": tune(0.0, -2.0, 2.0)},
                    _sphere, generations=3, population=8,
                    rng=generator("gfarm", seed=5), crossover=crossover,
                    mutation_rate=0.3, **kwargs)
    best_spec, best = opt.run()
    return (opt.history,
            [(tuple(c.values), c.fitness)
             for c in opt.population.chromosomes], best_spec, best), opt


@pytest.mark.parametrize("crossover", ["two_point", "single_point",
                                       "uniform"])
def test_farmed_ga_equals_the_jax_farmed_ga(crossover):
    """Two farm workers in each package, one seed, an analytic fitness:
    the same history, chromosomes and best, equal floats; and the
    port's farmed run equals its in-process run."""
    from veles_tpu.genetics import GeneticsOptimizer as JaxOptimizer
    from veles_tpu.genetics import Tune as JaxTune
    from veles_tpu.prng import RandomGenerator as JaxGenerator
    ours, opt = _farmed(GeneticsOptimizer, Tune, RandomGenerator,
                        crossover, farm_slaves=2)
    theirs, _ = _farmed(JaxOptimizer, JaxTune, JaxGenerator, crossover,
                        farm_slaves=2)
    assert ours == theirs
    in_process, _ = _farmed(GeneticsOptimizer, Tune, RandomGenerator,
                            crossover)
    assert ours == in_process
    # one farm for the whole run, one batch a generation
    assert opt.farm_stats["batches"] == 3
    assert all(c.fitness is not None for c in opt.population.chromosomes)
    assert ours[3] == max(f for _, f in ours[1])


def test_optimizer_farms_over_control_plane():
    """tests/test_genetics.py's one farmed generation on the port."""
    opt = GeneticsOptimizer(
        {"x": Tune(0.0, -2.0, 2.0), "y": Tune(0.0, -2.0, 2.0)}, _sphere,
        generations=1, population=8, farm_slaves=2,
        rng=RandomGenerator("gfarm", seed=5))
    best_spec, best_fitness = opt.run()
    assert all(c.fitness is not None for c in opt.population.chromosomes)
    assert best_fitness == max(c.fitness
                               for c in opt.population.chromosomes)
    assert -9.0 < best_fitness <= 0.0
    assert best_fitness == _sphere(best_spec)


def test_remote_worker_evaluates_for_the_optimizer():
    """Remote-only farming: the optimizer binds an explicit address and
    a worker joins it through ``GeneticsOptimizer.worker``; the farm
    stays up across generations."""
    import socket
    import threading
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    address = "127.0.0.1:%d" % probe.getsockname()[1]
    probe.close()
    spec = {"x": Tune(0.0, -2.0, 2.0), "y": Tune(0.0, -2.0, 2.0)}
    opt = GeneticsOptimizer(spec, _sphere, generations=3, population=6,
                            farm_address=address,
                            rng=RandomGenerator("gremote", seed=3))
    assert opt.farm_enabled
    done = {}

    def work():
        worker = GeneticsOptimizer(spec, _sphere)
        done["n"] = worker.worker(address)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    best_spec, best = opt.run()
    thread.join(30)
    assert not thread.is_alive()
    assert done["n"] == sum(1 for _ in opt._fitness_memo)
    assert best == _sphere(best_spec) == max(
        c.fitness for c in opt.population.chromosomes)


def test_farmed_optimizer_takes_the_card_unless_asked(monkeypatch):
    import torch
    from veles_tpu_torch.config import root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    monkeypatch.setitem(root.common.engine.__dict__, "backend", "cuda")
    opt = GeneticsOptimizer({"x": Tune(0.0, 0.0, 1.0)}, float,
                            farm_slaves=1, generations=1, population=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.worker("127.0.0.1:1")
    opt = GeneticsOptimizer({"x": Tune(0.0, 0.0, 1.0)}, operator.itemgetter(
        "x"), farm_slaves=1, generations=1, population=2, device="cpu",
        rng=RandomGenerator("cpu", seed=1))
    best_spec, best = opt.run()
    assert best == best_spec["x"]


def test_a_spec_without_tune_markers_is_refused():
    with pytest.raises(ValueError):
        GeneticsOptimizer({"x": 1.0}, float)
