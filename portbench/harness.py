"""One run of one cell, after the command line's checks: the program's
set-up and window (:mod:`portbench.train` or :mod:`portbench.serve`,
by the traffic's ``kind``), the per-layer readers over the traced
window, then, with the program's state freed, the comparison with the
reference; returns the result line's object and the check rows."""

import gc
import math
import time

import torch

from portbench import check, serve, train

__all__ = ["run_cell", "KINDS"]

#: the runner of each traffic ``kind``
KINDS = {"train": train.run, "serve": serve.run}


def _device_info(dev, count, outcome):
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": kind, "count": count,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    return info


def run_cell(bench, workload, seed, seconds, trace, device, t_start):
    entry = bench.workload(workload)
    model = bench.config(entry["config"])
    traffic = bench.traffic(entry["traffic"])
    dev = torch.device(device)
    outcome = KINDS[traffic["kind"]](model, traffic, seed, seconds,
                                       trace, device, t_start)
    metrics = {}
    if trace:
        tr = outcome.read_trace()
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(outcome)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in bench.end_to_end(workload):
            if m["name"] not in outcome.e2e:
                raise KeyError("workload %s: no end-to-end %s" % (
                    workload, m["name"]))
            metrics[m["name"]] = {"value": float(outcome.e2e[m["name"]]),
                                  "unit": m["unit"]}
    device_info = _device_info(dev, int(entry.get("chips", 1)), outcome)
    result = {"correct": False, "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = outcome.window_s
        result["breakdown"] = tr.breakdown()
    result["run"] = dict(outcome.extra, workload=workload, seed=seed,
                         seconds=seconds, trace=bool(trace),
                         window_s=outcome.window_s)
    # the program's memory back to the card before the reference runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = outcome.check()
    result["run"]["check_s"] = time.perf_counter() - t_check
    correct, rows = check.judge(numbers, bench.limits(workload),
                                outcome.missing)
    result["correct"] = bool(correct)
    result["checks"] = rows
    return result, numbers
