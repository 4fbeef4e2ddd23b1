"""``python -m veles_tpu_torch.tune``: tune the kernel schedules a model
really uses and write a TUNE.json receipt.

Counterpart of ``python -m veles_tpu.tune``, with its options and
receipt (``"torch"`` in the place of ``"jax"``, the card's name as
``device_kind``).  Runs one raw train step of the model for its kernel
specs (tune/walk.py), tunes each through the GA (cache hits skip
straight through: a second run over the same model is all hits), and
writes the receipt.  It runs on the card, or on the CPU with ``-d cpu``
(the kernels' plain versions: for tests).  A tuned schedule takes
effect at the next capture of a step or rung; the captured ones keep
theirs.

    # tune VGG16's wgrad layers on the card
    python -m veles_tpu_torch.tune --model vgg16 --batch 32 --ops conv_vjp

    # CI smoke: launch-once fitness, tiny GA
    python -m veles_tpu_torch.tune --model mlp --fitness compile \
        --generations 1 --population 4 --max-specs 2

    # model-guided search: rank candidates with the learned cost
    # model, launch only the top decile
    python -m veles_tpu_torch.tune --model mlp --fitness model

    # fleet schedule bank: fold another host's tuning into this cache
    python -m veles_tpu_torch.tune --merge-bank /shared/schedule_bank.json
    # audit the training data, model trust and cache provenance
    python -m veles_tpu_torch.tune --report

A fleet tunes in parallel over the job farm: start workers with
``--worker HOST:PORT`` in other processes or on other hosts, then run
the master with ``--farm-slaves N --farm-address HOST:PORT``.  A worker
runs on the card, or on the CPU with ``-d cpu``; it times each candidate
on the device the master names (the cache key's device kind).

    # a master with one local worker, and a worker process joining it
    python -m veles_tpu_torch.tune --model convnet --farm-slaves 1 \
        --farm-address 127.0.0.1:8270
    python -m veles_tpu_torch.tune --worker 127.0.0.1:8270

``VELES_SCHEDULE_CACHE`` (or ``--cache``) moves the cache.
"""

import argparse
import json
import os
import sys
import time

__all__ = ["main"]

_MODELS = ("mlp", "convnet", "alexnet", "vgg16", "transformer")


def _model(name, hidden):
    from veles_tpu_torch.models import zoo
    if name == "mlp":
        return zoo.mnist_mlp_layers(hidden=hidden), (784,)
    if name == "convnet":
        specs = [
            {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
             "padding": 1, "learning_rate": 0.05,
             "gradient_moment": 0.9},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3,
             "padding": 1, "learning_rate": 0.05,
             "gradient_moment": 0.9},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.05, "gradient_moment": 0.9},
        ]
        return specs, (16, 16, 3)
    if name == "alexnet":
        return zoo.alexnet_layers(), (227, 227, 3)
    if name == "vgg16":
        return zoo.vgg_layers(), (224, 224, 3)
    if name == "transformer":
        # the sequence workload: its fused step records attention
        # consults (and the head/MLP matmuls) at trace time
        return zoo.transformer_layers(blocks=2, heads=8,
                                      hidden=2048), (128, 512)
    raise SystemExit("unknown --model %r (have %s)" %
                     (name, ", ".join(_MODELS)))


def _parser():
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.tune",
        description="Genetics-driven kernel schedule autotuner")
    parser.add_argument("--model", default="mlp",
                        help="zoo model to walk (%s)" %
                        "|".join(_MODELS))
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--hidden", type=int, default=100,
                        help="mlp hidden width")
    parser.add_argument("--generations", type=int, default=4)
    parser.add_argument("--population", type=int, default=8)
    parser.add_argument("--fitness",
                        choices=("measure", "compile", "model"),
                        default="measure",
                        help="measure = interleaved timing on the card's "
                        "clock; compile = build and launch once (CI "
                        "smoke); model = cost-model ranked, only the top "
                        "decile launches")
    parser.add_argument("--model-base", choices=("measure", "compile"),
                        default="measure",
                        help="measurement mode for --fitness model's "
                        "top slice (and its fallback)")
    parser.add_argument("--repeats", type=int, default=8,
                        help="chain length per timing slope")
    parser.add_argument("--rounds", type=int, default=3,
                        help="interleaved passes per generation")
    parser.add_argument("--workers", type=int, default=0,
                        help="process-pool evaluators")
    parser.add_argument("--farm-slaves", type=int, default=0,
                        help="local control-plane farm workers")
    parser.add_argument("--farm-address", default="127.0.0.1:0")
    parser.add_argument("--worker", metavar="HOST:PORT",
                        help="run as a remote farm worker for a "
                        "tuning master at HOST:PORT (blocks)")
    parser.add_argument("-d", "--device", default="cuda",
                        help="where the step and the candidates run: "
                        "cuda (the card, default), cuda:N or cpu")
    # choices derive from the family registry
    from veles_tpu_torch.tune.spec import FAMILIES
    parser.add_argument("--ops", action="append",
                        choices=tuple(sorted(FAMILIES)),
                        help="restrict to these kernel families")
    parser.add_argument("--max-specs", type=int, default=0,
                        help="tune at most N specs (0 = all)")
    parser.add_argument("--precision-level", type=int, default=None)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--loss", default="softmax")
    parser.add_argument("--cache", default=None,
                        help="schedule cache DIR (default: "
                        "$VELES_SCHEDULE_CACHE, else schedule_cache under "
                        "root.common.dirs.cache)")
    parser.add_argument("--out", default="TUNE.json",
                        help="receipt path")
    parser.add_argument("--force", action="store_true",
                        help="retune even on cache hits")
    parser.add_argument("--seed", type=int, default=13)
    parser.add_argument("--merge-bank", metavar="PATH",
                        help="merge a fleet schedule bank into the "
                        "local cache and exit (no tuning)")
    parser.add_argument("--export-bank", metavar="PATH",
                        help="export the local cache as a fleet bank "
                        "and exit (no tuning)")
    parser.add_argument("--report", action="store_true",
                        help="print cost-model validation, per-family "
                        "triple counts and bank provenance; exit")
    return parser


def _merge_bank(path):
    from veles_tpu_torch.tune import cache as tune_cache
    cache = tune_cache.cache_for()
    counts = cache.merge_bank(path)
    print("bank merge: %d adopted, %d kept (local wins), %d stale "
          "digests rejected, %d invalid of %d (cache now %d entries)"
          % (counts["adopted"], counts["kept"], counts["stale"],
             counts["invalid"], counts["total"], len(cache)),
          flush=True)
    return 0


def _export_bank(path):
    from veles_tpu_torch.tune import cache as tune_cache
    cache = tune_cache.cache_for()
    count = cache.export_bank(path)
    print("bank export: %d entries -> %s" % (count, path), flush=True)
    return 0


def _report(mode):
    """The operator audit: what would the cost model train on, how
    much does it trust itself, and who contributed the cache."""
    from veles_tpu_torch.tune import cache as tune_cache
    from veles_tpu_torch.tune import costmodel
    from veles_tpu_torch.tune.spec import FAMILIES
    log = tune_cache.measurement_log()
    print("measurement sidecar: %s" % log.path)
    counts = log.count_by_family(mode=mode)
    stale = len(log.rows(mode=mode, current_only=False)) \
        - sum(counts.values())
    print("  %d current triple(s) (mode=%s), %d stale/foreign"
          % (sum(counts.values()), mode, stale))
    for op in sorted(FAMILIES):
        n = counts.get(op, 0)
        if not n:
            print("  %-12s %5d triples (thin: no model)" % (op, n))
            continue
        model, info = costmodel.train_for(op, mode=mode)
        if info["fallback"] == "thin-data":
            print("  %-12s %5d triples (thin: < %d, no model)"
                  % (op, n, info["min_triples"]))
        elif info["error"] is None:
            print("  %-12s %5d triples (unvalidatable: no spec group "
                  "with %d+ schedules; untrusted)" % (op, n, 3))
        else:
            print("  %-12s %5d triples  val error %.3f (spearman "
                  "%.3f over %d held-out specs) -> %s"
                  % (op, n, info["error"], info["spearman"],
                     info["groups"],
                     "TRUSTED" if info["trusted"] else "untrusted"))
    cache = tune_cache.cache_for()
    entries = cache.entries()
    print("schedule cache: %s (%d entries)" % (cache.path,
                                               len(entries)))
    for digest in sorted(entries):
        entry = entries[digest]
        print("  %s  %-9s %-22s %-8s host=%s fitness=%s"
              % (digest[:12], entry.get("op"),
                 tuple(entry.get("shape", ())), entry.get("source"),
                 entry.get("host", "local"), entry.get("fitness")))
    print("tune counters: %s" % tune_cache.tune_counters(),
          flush=True)
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)

    if args.cache:
        os.environ["VELES_SCHEDULE_CACHE"] = args.cache
    if args.merge_bank:
        return _merge_bank(args.merge_bank)
    if args.export_bank:
        return _export_bank(args.export_bank)
    if args.report:
        return _report(args.model_base if args.fitness == "model"
                       else args.fitness)

    import torch

    if args.worker:
        from veles_tpu_torch.jobfarm import JobFarm
        from veles_tpu_torch.tune.autotune import evaluate_candidate
        done = JobFarm("genetics", device=torch.device(
            args.device).type).worker(args.worker, evaluate_candidate)
        print("tune: worker evaluated %d candidate(s) for %s"
              % (done, args.worker), flush=True)
        return 0

    from veles_tpu_torch.models.zoo import build_plans_and_state
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.tune import cache as tune_cache
    from veles_tpu_torch.tune.autotune import ScheduleTuner
    from veles_tpu_torch.tune.walk import collect_specs

    device = torch.device(args.device)
    if args.precision_level is None:
        from veles_tpu_torch.config import root
        args.precision_level = int(root.common.engine.get(
            "precision_level", 0))

    start = time.monotonic()
    layer_specs, input_shape = _model(args.model, args.hidden)
    plans, state, _ = build_plans_and_state(layer_specs, input_shape,
                                            seed=args.seed)
    specs = collect_specs(plans, state, args.batch, input_shape,
                          loss=args.loss, dtype=args.dtype,
                          precision_level=args.precision_level,
                          ops=args.ops, device=device, seed=args.seed)
    del state
    if args.max_specs:
        specs = specs[:args.max_specs]
    print("tune: %s walked %d kernel spec(s) from one train step on %s"
          % (args.model, len(specs), device), flush=True)

    cache = tune_cache.cache_for()
    rows, counts, evals = [], {}, 0
    for spec in specs:
        tuner = ScheduleTuner(
            spec, cache=cache, generations=args.generations,
            population=args.population, workers=args.workers,
            farm_slaves=args.farm_slaves, farm_address=args.farm_address,
            fitness=args.fitness, repeats=args.repeats,
            rounds=args.rounds, model_base=args.model_base,
            device=device, rng=RandomGenerator("tune", seed=args.seed))
        row = tuner.tune(force=args.force)
        rows.append(row)
        counts[row["source"]] = counts.get(row["source"], 0) + 1
        evals += row["evals"]
        print("  %-11s %-24s %s  (%s, %d evals)" % (
            row["op"], tuple(row["shape"]),
            row.get("schedule"), row["source"], row["evals"]),
            flush=True)

    receipt = {
        "schema": 1,
        "model": args.model,
        "batch": args.batch,
        "dtype": args.dtype,
        "precision_level": args.precision_level,
        "loss": args.loss,
        "device_kind": tune_cache.device_kind(device),
        "torch": torch.__version__,
        "fitness": args.fitness,
        "generations": args.generations,
        "population": args.population,
        "cache_path": cache.path,
        "specs": rows,
        "counts": counts,
        "evals": evals,
        "tune_counters": tune_cache.tune_counters(),
        "wall_s": round(time.monotonic() - start, 2),
    }
    with open(args.out, "w") as fout:
        json.dump(receipt, fout, indent=1, sort_keys=True)
        fout.write("\n")
    print("tune: %s -> %s (%s; %d evals, %.1fs)" % (
        args.model, args.out,
        ", ".join("%d %s" % (n, src)
                  for src, n in sorted(counts.items())),
        evals, receipt["wall_s"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
