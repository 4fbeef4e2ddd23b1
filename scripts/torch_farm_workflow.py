"""The digits_conv workflow module of ``chip_smoke.py``'s farm phase.

``veles_tpu_torch/examples/digits_conv.py`` at its full width (conv 16
3x3, max pooling 2x2, conv 32 3x3, max pooling 2x2, all2all_relu 64,
softmax 10; minibatch 48), with the hooks of the command line's meta
modes:

- ``member_factory(index, seed, ratio)``: an ensemble member, its layer
  weights and its loader's shuffles drawn from generators of its own
  seeded by ``seed``, trained on a ``ratio`` share of the train set
  (the loader's ``train_ratio``) for ``root.farm_workflow.epochs``;
- ``ensemble_test_data()``: the digits' validation split, as the
  loader serves it;
- ``tunable_spec()`` (``learning_rate``, ``gradient_moment``) and
  ``fitness(spec)``: minus the best validation error after
  ``root.farm_workflow.fitness_epochs`` epochs, from a fixed seed.

A member or a fitness run draws from no global generator, so several of
them train at once in the job farm's threads and each gives what it
gives alone.  ``root.farm_workflow.state_dir``, when set, receives a
mark ``member_NNN.started.PID`` as a member's run starts and its trained
state as ``member_NNN.live.npz`` at the end of the run (what the
member's pickle must hold), and ``root.farm_workflow.log`` a JSON line
for each fitness run.

    python -m veles_tpu_torch scripts/torch_farm_workflow.py - \\
        --ensemble-train 3:0.8 --farm-slaves 2
    python -m veles_tpu_torch scripts/torch_farm_workflow.py - \\
        --optimize 2:4 --farm-slaves 2
"""

import json
import os
import threading

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import digits_arrays
from veles_tpu_torch.examples import digits_conv
from veles_tpu_torch.genetics import Tune
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.farm_workflow.update({
    "epochs": 40,           # tests/test_quality.py's digits_conv run
    "fitness_epochs": 10,
    "fitness_seed": 7,
    "state_dir": "",
    "log": "",
})

_LOG_LOCK = threading.Lock()


class FarmMember(StandardWorkflow):
    """digits_conv whose end of run hands its trained state to
    ``root.farm_workflow.state_dir`` when that is set."""

    def __init__(self, workflow, member=None, **kwargs):
        super(FarmMember, self).__init__(workflow, **kwargs)
        self.member = member

    def run(self):
        directory = root.farm_workflow.state_dir
        if directory and self.member is not None:
            # the mark of a member in training, by process
            open(os.path.join(directory, "member_%03d.started.%d" % (
                self.member, os.getpid())), "w").close()
        result = super(FarmMember, self).run()
        if directory and self.member is not None:
            from veles_tpu_torch.compiler import extract_state
            from veles_tpu_torch.convert import state_to_numpy
            trainer = getattr(self, "fused_trainer", None)
            with self._card_hold():
                state = state_to_numpy(
                    trainer._state_ if trainer is not None and
                    trainer._state_ is not None else extract_state(self))
            numpy.savez(os.path.join(
                directory, "member_%03d.live.npz" % self.member),
                **{"%s%d" % (key, i): leaf
                   for i, entry in enumerate(state)
                   for key, leaf in entry.items() if leaf is not None})
        return result


def build(launcher, seed, train_ratio=1.0, learning_rate=None,
          gradient_moment=None, max_epochs=None, member=None):
    """digits_conv's layers and loader, every draw from ``seed``."""
    cfg = root.digits_conv
    hyper = {"learning_rate": cfg.learning_rate
             if learning_rate is None else learning_rate,
             "gradient_moment": cfg.gradient_moment
             if gradient_moment is None else gradient_moment,
             "weights_decay": cfg.weights_decay,
             "prng": RandomGenerator("farm_layers", seed=seed)}
    return FarmMember(
        launcher, member=member,
        layers=[
            dict(type="conv_relu", n_kernels=16, kx=3, ky=3, padding=1,
                 **hyper),
            dict(type="max_pooling", kx=2, ky=2),
            dict(type="conv_relu", n_kernels=32, kx=3, ky=3, padding=1,
                 **hyper),
            dict(type="max_pooling", kx=2, ky=2),
            dict(type="all2all_relu", output_sample_shape=64, **hyper),
            dict(type="softmax", output_sample_shape=10, **hyper),
        ],
        loader_factory=lambda w: digits_conv.DigitsImageLoader(
            w, minibatch_size=cfg.minibatch_size, train_ratio=train_ratio,
            prng=RandomGenerator("farm_loader", seed=seed)),
        decision_config=dict(
            max_epochs=max_epochs or root.farm_workflow.epochs,
            fail_iterations=cfg.fail_iterations))


def member_factory(index, seed, ratio):
    from veles_tpu_torch.dummy import DummyWorkflow
    return build(DummyWorkflow().workflow, seed, train_ratio=ratio,
                 member=index)


def ensemble_test_data():
    """The validation split the members were measured on."""
    _, _, valid_x, valid_y = digits_arrays()
    return valid_x.reshape(-1, 8, 8, 1), valid_y


def tunable_spec():
    cfg = root.digits_conv
    return {"learning_rate": Tune(cfg.learning_rate, 0.005, 0.1),
            "gradient_moment": Tune(cfg.gradient_moment, 0.5, 0.95)}


def fitness(spec):
    """Minus the best validation error (%) of a run of
    ``root.farm_workflow.fitness_epochs`` epochs with ``spec``'s
    hyperparameters, from ``root.farm_workflow.fitness_seed``."""
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.launcher import _resolve_device
    sw = build(DummyWorkflow().workflow, root.farm_workflow.fitness_seed,
               learning_rate=spec["learning_rate"],
               gradient_moment=spec["gradient_moment"],
               max_epochs=root.farm_workflow.fitness_epochs)
    sw.initialize(device=_resolve_device())
    sw.run()
    value = -float(sw.decision.best_metric)
    if root.farm_workflow.log:
        with _LOG_LOCK, open(root.farm_workflow.log, "a") as fout:
            fout.write(json.dumps({
                "spec": spec, "fitness": value,
                "thread": threading.current_thread().name}) + "\n")
    return value


def run(load, main):
    load(digits_conv.build)
    main()
