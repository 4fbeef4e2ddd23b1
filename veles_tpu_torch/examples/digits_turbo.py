"""Digits through the epoch trainer: the whole epoch as one call per
class (``compiler.build_train_epoch`` / ``build_eval_epoch``).

Counterpart of ``examples/digits_turbo.py``, with its layers,
hyperparameters and seeds: the standard workflow (``digits.py``) drives
the unit graph, loader -> fused trainer -> decision, one step a
minibatch under the decision's gates; this example trades those gates
for speed.  The dataset lives on the device, each train and validation
pass is one call that gathers its minibatches there
(``gather_minibatch``, one launch a minibatch; on the card each step is
a replay of a captured graph) and runs a sub-batch tail as a masked
step, so the full validation set counts.  Early stopping happens
between epochs.

Run it directly (no CLI wrapper: the epoch trainer is the loop):

    python veles_tpu_torch/examples/digits_turbo.py [--epochs 40] \\
        [--batch 48] [--backend cuda|cpu]
"""

import argparse
import os
import sys

import numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--backend", default="cuda",
                        choices=("cuda", "cpu"),
                        help="cuda (the card, the default) | cpu")
    parser.add_argument("--batch", type=int, default=48)
    args = parser.parse_args(argv)

    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import (build_eval_epoch,
                                          build_train_epoch)
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.datasets import digits_arrays
    from veles_tpu_torch.models.zoo import build_plans_and_state

    device = Device(backend=args.backend)

    # the same deterministic split the standard digits anchor trains on
    train_x, train_y, valid_x, valid_y = digits_arrays()
    data = numpy.concatenate([train_x, valid_x])
    labels = numpy.concatenate([train_y, valid_y])
    train_idx = numpy.arange(len(train_x))
    valid_idx = numpy.arange(len(train_x), len(data))
    rng = numpy.random.RandomState(2)

    specs = [
        {"type": "all2all_tanh", "output_sample_shape": 64,
         "learning_rate": 0.08, "gradient_moment": 0.9,
         "weights_decay": 1e-4},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.08, "gradient_moment": 0.9,
         "weights_decay": 1e-4},
    ]
    plans, state, _ = build_plans_and_state(specs, (64,), seed=2)
    state = state_from_jax(state, device)

    dataset = device.put(data)
    labels_dev = device.put(labels.astype(numpy.int32))
    valid_order = device.put(valid_idx.astype(numpy.int32))

    train = build_train_epoch(plans, args.batch)
    evaluate = build_eval_epoch(plans, args.batch)

    best_err, best_epoch = float("inf"), -1
    for epoch in range(args.epochs):
        train_order = device.put(
            rng.permutation(train_idx).astype(numpy.int32))
        state, totals = train(state, dataset, labels_dev, train_order)
        params = [{"weights": s["weights"], "bias": s["bias"]}
                  for s in state]
        m = evaluate(params, dataset, labels_dev, valid_order)
        err_pct = 100.0 * int(m["n_err"]) / int(m["samples"])
        if err_pct < best_err:
            best_err, best_epoch = err_pct, epoch
        print("epoch %2d: train loss %.4f  valid err %.2f%%" % (
            epoch, float(totals["loss_mean"]), err_pct))
    print("best validation error %.2f%% (epoch %d)" % (
        best_err, best_epoch))
    return best_err


if __name__ == "__main__":
    main()
