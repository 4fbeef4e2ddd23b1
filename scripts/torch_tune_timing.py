"""Time tuned schedules against the static plans on the card.

    python3 scripts/torch_tune_timing.py --tree DIR --label L \\
        [--parts step,layers,attention,consult] [--out chiprun_out/x.json]

Imports ``veles_tpu_torch`` from the checkout ``DIR`` (the repo root by
default) and reads the schedule cache ``VELES_SCHEDULE_CACHE`` names
(point it at a tuned cache, or at an empty directory for the static
plans).  Parts:

- ``step``: VGG16's captured train step at batch 32 (seed 0, seeded
  inputs): 3 warm-up steps, then ``--steps`` steps each timed with CUDA
  events; their median.  Runs on any checkout, a parent without the
  tuner too, so parent, change, change, parent go in one call;
- ``layers``: each VGG16 wgrad layer at batch 32 under the rule's plan
  and under the cached schedule (when there is one), both timed in turn
  in one interleaved run on the card's clock (``tune.measure``: device
  time, the host's launch cost hidden behind a spin), and the sums over
  the 13 layers;
- ``attention``: the flash forward at (512, 128, 64), level 0, rule
  (the resident grid) against the cached grid, the same way;
- ``consult``: the host cost of the memoized consult (``conv_wgrad``'s
  and ``matmul``'s) in microseconds a call, and of a first (unmemoized)
  consult.

Prints one JSON line and writes it to ``--out``.  Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: VGG16-D's 13 convolutions at 224x224: (input channels, output
#: channels, output side)
VGG16_CONVS = [(3, 64, 224), (64, 64, 224), (64, 128, 112),
               (128, 128, 112), (128, 256, 56), (256, 256, 56),
               (256, 256, 56), (256, 512, 28), (512, 512, 28),
               (512, 512, 28), (512, 512, 14), (512, 512, 14),
               (512, 512, 14)]
BATCH = 32


def part_step(steps):
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    shape = (224, 224, 3)
    plans, host_state, _ = build_plans_and_state(vgg_layers(config="D"),
                                                 shape, seed=0)
    state = state_from_jax(host_state, Device())
    del host_state
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((BATCH,) + shape, generator=gen, device="cuda") * 2 - 1
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda",
                      dtype=torch.int32)
    step = build_train_step(plans)
    for _ in range(3):
        state, _m = step(state, x, t, float(BATCH))
    torch.cuda.synchronize()
    events = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _m = step(state, x, t, float(BATCH))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    return {"step_ms": ms, "median_ms": statistics.median(ms)}


def _rule_vs_cached(spec, rounds=7):
    """(rule ms, cached ms or None, cached schedule) of one spec, timed
    in one interleaved run."""
    import torch
    from veles_tpu_torch.tune import cache, measure
    from veles_tpu_torch.tune.spec import (card_limits, family_for,
                                           valid_schedule)
    card = torch.device("cuda", 0)
    family = family_for(spec["op"])
    rule = family.default(spec, card_limits(card))
    digest, _ = cache.schedule_key(
        spec["op"], spec["shape"], spec["dtype"], spec["precision_level"],
        cache.device_kind(card), spec["extra"])
    entry = cache.cache_for().get(digest)
    tuned = None if entry is None else valid_schedule(
        spec["op"], entry["schedule"], spec)
    runners = {"rule": family.build_runner(spec, rule, card)}
    if tuned is not None and tuned != rule:
        runners["tuned"] = family.build_runner(spec, tuned, card)
    for warm, _ in runners.values():
        warm()
    ranked = measure.rank(measure.interleaved_slopes(
        {key: run for key, (_, run) in runners.items()}, 1, 9,
        rounds=rounds, device=card))
    rule_ms = ranked["rule"] * 1e3 if ranked["rule"] else None
    if tuned is None or tuned == rule:
        return rule_ms, rule_ms, tuned, rule
    return (rule_ms, ranked["tuned"] * 1e3 if ranked["tuned"] else None,
            tuned, rule)


def part_layers():
    from veles_tpu_torch.tune.spec import conv_vjp_spec
    layers, rule_sum, tuned_sum = [], 0.0, 0.0
    seen = {}
    for ci, co, side in VGG16_CONVS:
        key = (ci, co, side)
        if key not in seen:
            spec = conv_vjp_spec((BATCH, side, side, ci), 3, 3, co,
                                 (side, side), "float32", 0,
                                 padding=(1, 1, 1, 1), sliding=(1, 1),
                                 activation="strict_relu")
            seen[key] = _rule_vs_cached(spec)
        rule_ms, tuned_ms, tuned, rule = seen[key]
        rule_sum += rule_ms
        tuned_sum += tuned_ms
        layers.append({"ci": ci, "co": co, "side": side, "rule": rule,
                       "tuned": tuned, "rule_ms": rule_ms,
                       "tuned_ms": tuned_ms})
    return {"layers": layers, "rule_sum_ms": rule_sum,
            "tuned_sum_ms": tuned_sum}


def part_attention():
    from veles_tpu_torch.tune.spec import attention_spec
    rule_ms, tuned_ms, tuned, rule = _rule_vs_cached(
        attention_spec(512, 128, 64, "float32", 0))
    return {"rule": rule, "tuned": tuned, "rule_ms": rule_ms,
            "tuned_ms": tuned_ms}


def part_consult(calls=100000):
    import importlib

    import torch
    from veles_tpu_torch.ops import conv_vjp
    from veles_tpu_torch.tune import cache
    # the module (the package re-exports the function under its name)
    matmul_mod = importlib.import_module("veles_tpu_torch.ops.matmul")
    x = torch.empty((BATCH, 14, 14, 512), device="cuda")
    y = torch.empty((BATCH, 14, 14, 512), device="cuda")
    geometry = conv_vjp._geometry(x, y, (3, 3), (1, 1, 1, 1), (1, 1))
    args = (x, y, geometry, "strict_relu", (1, 1, 1, 1), (1, 1), 0)
    cache.invalidate()
    t0 = time.perf_counter()
    conv_vjp.tuned_schedule(*args)
    first_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    for _ in range(calls):
        conv_vjp.tuned_schedule(*args)
    wgrad_us = (time.perf_counter() - t0) / calls * 1e6
    t0 = time.perf_counter()
    for _ in range(calls):
        matmul_mod.tuned_schedule(32, 25088, 4096, "float32", 0, x.device)
    matmul_us = (time.perf_counter() - t0) / calls * 1e6
    return {"first_us": first_us, "conv_wgrad_memoized_us": wgrad_us,
            "matmul_memoized_us": matmul_us, "calls": calls}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--label", default="change")
    parser.add_argument("--parts", default="step")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    torch.backends.cudnn.deterministic = True
    from veles_tpu_torch.ops import common
    common.load_kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    out = {"label": args.label, "card": smi,
           "cache": os.environ.get("VELES_SCHEDULE_CACHE")}
    parts = {"step": lambda: part_step(args.steps), "layers": part_layers,
             "attention": part_attention, "consult": part_consult}
    for name in args.parts.split(","):
        out[name] = parts[name]()
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            fout.write(text)
    print("tune timing: " + text, flush=True)


if __name__ == "__main__":
    main()
