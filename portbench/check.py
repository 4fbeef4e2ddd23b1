"""How ``correct`` is decided: the numbers compared with the plain
reference, and their limits.

Training (three steps from the seed, through the window's own call and
feed, before the window):

- ``loss_gap``: the relative gap of the first step's loss (the later
  steps' losses carry the program's run-to-run orders, compounded
  through the updates: ``loss_gap_steps``, their largest relative gap,
  is reported beside it and judged by no limit);
- ``grad_gap``: the largest gap between the program's and the
  reference's norm of a leaf's first gradient (the program's worked out
  from its momentum after one step, ``v / lr``), over the larger of the
  reference leaf's norm and the median leaf's;
- ``change_gap``: the same for the norm of each leaf's change after the
  three steps, over the leaves whose first reference gradient is at
  least a thousandth of the median leaf's (a leaf below it moves by
  round-off alone).

Serving (once the window has closed), over a sample of the answered
requests drawn from the seed, each served answer's log-probabilities
against the reference's (in int8, the reference's own quantization of
the seeded weights on the seeded calibration images):

- ``logp_gap``: the widest gap, in nats, over every class of every
  sampled answer;
- ``logp_gap_median``: the median over the sampled answers of each
  answer's widest gap (an isolated rounding flip moves one answer, not
  the median);
- ``top1_gap``: the widest gap by which the class an answer puts first
  lies below the reference's best, in the reference's log-probabilities
  (0 where the two agree).

In int8 the program's quantized state is judged too
(:func:`quant_numbers`): ``scale_gap`` and ``qweight_mismatch``.

A workload's limits are data: ``portbench/limits/<workload>.json``
maps each compared number to its limit; a number without a limit is
reported and not judged.  ``correct`` is false when a number exceeds
its limit, is not finite, or when a request never got an answer.
"""

import json
import math
import os

import numpy

__all__ = ["load_limits", "train_numbers", "serve_numbers",
           "quant_numbers", "judge"]


def load_limits(bench_dir, workload):
    path = os.path.join(bench_dir, "limits", workload + ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as fin:
        return {k: float(v) for k, v in json.load(fin)["limits"].items()}


def _gap(got, want, floor):
    return abs(got - want) / max(abs(want), floor)


def train_numbers(program, reference, lr):
    """The training numbers from the program's readings and the
    reference's, each {"loss", "grad_norms", "change_norms"} (the
    program's "grad_norms" are its velocity norms, v = lr g)."""
    losses = [_gap(p, r, 1e-30) for p, r in zip(program["loss"],
                                                 reference["loss"])]
    grads = [v / lr for v in program["grad_norms"]]
    ref_grads = reference["grad_norms"]
    median = float(numpy.median(ref_grads))
    grad = max(_gap(p, r, median) for p, r in zip(grads, ref_grads))
    moved = [i for i, r in enumerate(ref_grads) if r >= 1e-3 * median]
    ref_change = [reference["change_norms"][i] for i in moved]
    median_change = float(numpy.median(ref_change))
    change = max(_gap(program["change_norms"][i],
                      reference["change_norms"][i], median_change)
                 for i in moved)
    return {"loss_gap": losses[0], "loss_gap_steps": max(losses[1:]),
            "grad_gap": grad, "change_gap": change,
            "leaves_compared": len(moved),
            "leaves_excluded": len(ref_grads) - len(moved)}


def serve_numbers(served_logp, reference_logp):
    """``logp_gap``, ``logp_gap_median`` and ``top1_gap`` over paired
    (rows, classes) arrays."""
    served = numpy.asarray(served_logp, numpy.float64)
    want = numpy.asarray(reference_logp, numpy.float64)
    if not want.size:
        return {"logp_gap": float("nan")}
    widest = numpy.abs(served - want).max(axis=1)
    first = want[numpy.arange(len(want)), served.argmax(axis=1)]
    return {"logp_gap": float(widest.max()),
            "logp_gap_median": float(numpy.median(widest)),
            "top1_gap": float((want.max(axis=1) - first).max())}


def quant_numbers(program, want):
    """The int8 start, the program's quantized parameters against the
    reference's own (each {"wq", "ws", "act"} per quantized layer):
    ``scale_gap``, the largest relative gap of an activation or weight
    scale, and ``qweight_mismatch``, the share of int8 weights that
    differ."""
    gap, differ, total = 0.0, 0, 0
    for p, r in zip(program, want):
        if r is None:
            continue
        act = abs(float(p["act"]) - float(r["act"])) / float(r["act"])
        ws = float(((p["ws"] - r["ws"]).abs() / r["ws"]).max())
        gap = max(gap, act, ws)
        differ += int((p["wq"] != r["wq"]).sum())
        total += p["wq"].numel()
    return {"scale_gap": gap, "qweight_mismatch": differ / total}


def judge(numbers, limits, missing=0):
    """(correct, [[name, value, limit or None], ...]): every compared
    number beside its limit, last the requests never answered (limit
    0)."""
    rows, correct = [], True
    for name, value in numbers.items():
        if name.startswith("leaves_"):
            continue
        limit = limits.get(name)
        rows.append([name, value, limit])
        if limit is not None and not (math.isfinite(value) and
                                      value <= limit):
            correct = False
    rows.append(["unanswered", missing, 0])
    if missing:
        correct = False
    return correct, rows
