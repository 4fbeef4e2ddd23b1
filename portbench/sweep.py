#!/usr/bin/env python3
"""The rate sweep that fixes a serving cell's offered rate: one
process and one engine as the cell sets them up, and at each rate, on
each seed, a fresh batcher (warmed as a run warms it) under an
open-loop window.

    python3 portbench/sweep.py --workload NAME --rates 300,400,500 \\
        [--seeds 8000000001,8000000002] [--seconds 8]

Prints one JSON line a rate and seed: requests offered and answered,
shed, latency percentiles from the due time, and for each third of the
window its p95 and its rows a dispatch.  The batcher has two stable
regimes: small batches (the ladder's lower rungs) and, once a backlog
has pushed a dispatch to a large rung, large batches at several times
the latency.  A rate is sustained on a seed when every request was
answered, none was shed, and every third of the window stayed in the
small-batch regime (rows a dispatch no more than the ladder's second
rung) with a p95 under twice the first third's; it is sustained when
it is on every seed.  The last line gives the highest rate sustained
with every rate below it.  Needs a CUDA card.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT

import numpy  # noqa: E402
import torch  # noqa: E402

from portbench import inputs, serve  # noqa: E402
from portbench.bench import Bench  # noqa: E402


def _p95(latency):
    done = latency[numpy.isfinite(latency)]
    return float(numpy.percentile(done, 95)) * 1e3 if len(done) else None


def one_rate(engine, traffic, pool, rate, seconds, seed):
    """One window at ``rate`` on a fresh batcher: its JSON row."""
    batcher = serve.batcher_for(engine, traffic)
    try:
        serve.warm(batcher, pool, engine.ladder)
        times, images = inputs.schedule(seed, rate, seconds, len(pool))
        gc.collect()  # as a run's set-up ends
        cuts = [0, len(times) // 3, 2 * len(times) // 3, len(times)]
        snaps = [dict(batcher.stats)]
        full0 = gc.get_stats()[2]["collections"]
        answers = serve.Answers(times, time.perf_counter())
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            serve.offer(batcher, pool, times, images, answers, lo, hi)
            snaps.append(dict(batcher.stats))
        answers.wait(answers.t0 + seconds + 30.0)
        snaps[-1] = dict(batcher.stats)
        full = gc.get_stats()[2]["collections"] - full0
    finally:
        batcher.stop()
    latency = answers.latency
    done = latency[numpy.isfinite(latency)] * 1e3
    thirds = [latency[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:])]
    rows = [(b["requests"] - a["requests"]) / max(b["batches"] -
                                                  a["batches"], 1)
            for a, b in zip(snaps[:-1], snaps[1:])]
    row = {"rate": rate, "seed": seed, "offered": len(times),
           "answered": answers.answered, "shed": int(answers.shed.sum()),
           "p50_ms": float(numpy.percentile(done, 50)) if len(done) else None,
           "p95_ms": float(numpy.percentile(done, 95)) if len(done) else None,
           "p95_thirds_ms": [_p95(t) for t in thirds],
           "rows_thirds": rows,
           "late_ms_max": float(answers.late.max()) * 1e3,
           "gc_full_collections": full}
    small = int(engine.ladder[1]) if len(engine.ladder) > 1 else 1
    p95s = row["p95_thirds_ms"]
    row["small_batch_regime"] = all(r <= small for r in rows)
    row["sustained"] = bool(
        row["answered"] == row["offered"] and not row["shed"] and
        None not in p95s and row["small_batch_regime"] and
        all(p < 2 * p95s[0] for p in p95s))
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seeds", default="8000000001,8000000002")
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    entry = bench.workload(args.workload)
    model = bench.config(entry["config"])
    traffic = bench.traffic(entry["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = torch.device("cuda")
    engine = serve.engine_for(model, traffic, seeds[0], dev)
    pool = inputs.make_images(model, seeds[0], "pool", int(traffic["pool"]),
                              dev).cpu().numpy()
    knee, broken = None, False
    for rate in sorted(float(r) for r in args.rates.split(",")):
        held = True
        for seed in seeds:
            row = one_rate(engine, traffic, pool, rate, args.seconds, seed)
            print(json.dumps(row), flush=True)
            held = held and row["sustained"]
        if held and not broken:
            knee = rate
        broken = broken or not held
    print(json.dumps({"workload": args.workload, "highest_sustained": knee,
                      "card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
