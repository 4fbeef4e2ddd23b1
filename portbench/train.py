"""The training cells: the program's fused path, driven minibatch by
minibatch.

A ``StandardWorkflow`` over the configuration's zoo layers and a
``FullBatchLoader`` that holds the seeded images on the device, fused
(``FusedTrainer``: the captured train step on the card) with keyed
dropout and no input pipeline; the benchmark's weights adopted before
``initialize``.  Each minibatch runs the loader (the device gather),
the trainer (the step) and the decision, as the workflow's loop runs
them.  There is no validation class, so the window holds training
minibatches only.

Set-up drives the same object through its first steps: steps 1 to 3
are read for the comparison with the reference (the losses, the
momentum after step 1, the parameters after step 3, and the rows each
step took), and the warm-up steps after them capture nothing new.
"""

import time

import numpy
import torch

from portbench import inputs, reference
from portbench.outcome import Outcome, peak_reserved, profiled, sync

__all__ = ["run", "CHECKED_STEPS"]

#: steps compared with the reference
CHECKED_STEPS = 3


def _leaves(state, keys):
    return [entry[k] for entry in state if entry.get("weights") is not None
            for k in keys]


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def _workflow(model, traffic, host_images, host_labels, seed, device):
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow

    class SeededImages(FullBatchLoader):
        """The benchmark's images, all of the train class."""

        def load_data(self):
            self.original_data = host_images
            self.original_labels = host_labels
            self.class_lengths[0] = 0
            self.class_lengths[1] = 0
            self.class_lengths[2] = len(host_images)

    sw = StandardWorkflow(
        DummyLauncher(), layers=program_specs(model),
        loader_factory=lambda w: SeededImages(
            w, minibatch_size=traffic["batch"],
            prng=prng.RandomGenerator("portbench.loader",
                                      seed=inputs.subseed(seed, "order"))),
        decision_config=dict(max_epochs=None, fail_iterations=2 ** 62))
    sw.fuse(dropout_seed=dropout_seed(seed))
    return sw


def program_specs(model):
    """The program's layer specs: the zoo's, where the configuration
    names a zoo source (checked against the table), else the table's."""
    source = model.config.get("program", {})
    specs = model.zoo_specs()
    if "zoo" in source:
        from veles_tpu_torch.models import zoo
        zoo_specs = getattr(zoo, source["zoo"])(**source.get("kwargs", {}))
        if _canon(zoo_specs) != _canon(specs):
            raise ValueError("%s: zoo.%s does not match the table" % (
                model.name, source["zoo"]))
        specs = zoo_specs
    return specs


def _canon(specs):
    return [{k: tuple(v) if isinstance(v, (list, tuple)) else v
             for k, v in s.items()} for s in specs]


def dropout_seed(seed):
    return inputs.subseed(seed, "dropout") % 2 ** 31


def run(model, traffic, seed, seconds, trace, device, t_start):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.convert import adopt_workflow_state
    from veles_tpu_torch.loader.base import TRAIN

    dev = torch.device(device)
    batch = int(traffic["batch"])
    samples = int(traffic["samples"])
    params = inputs.make_params(model, seed, dev)
    host_state = [{k: None if v is None else v.cpu().numpy()
                   for k, v in p.items()} for p in params]
    images = inputs.make_images(model, seed, "train_images", samples, dev)
    host_images = images.cpu().numpy()
    del images
    host_labels = inputs.make_labels(model, seed, "train_labels", samples,
                                     dev).cpu().numpy()
    sw = _workflow(model, traffic, host_images, host_labels, seed, device)
    adopt_workflow_state(sw, host_state)
    del host_state
    sw.initialize(device=Device(dev.type))
    loader, trainer, decision = sw.loader, sw.fused_trainer, sw.decision

    def step():
        loader.run()
        if loader.minibatch_class != TRAIN:
            raise RuntimeError("a %s minibatch in a training window"
                               % loader.minibatch_class)
        trainer.run()
        decision.run()

    readings = {"loss": [], "rows": []}
    for i in range(CHECKED_STEPS):
        step()
        readings["rows"].append(numpy.array(
            loader.minibatch_indices.mem[:loader.minibatch_size]))
        readings["loss"].append(float(trainer.last_loss))
        if i == 0:
            readings["grad_norms"] = _norms(_leaves(
                trainer._state_, ("accum_weights", "accum_bias")))
    readings["change_norms"] = _norms(
        t - t0 for t, t0 in zip(_leaves(trainer._state_,
                                        ("weights", "bias")),
                                _leaves(params, ("weights", "bias"))))
    del params
    for _ in range(int(traffic.get("warmup_steps", 2))):
        step()
    skips0 = int(trainer.skip_count)
    sync(dev)
    peak_setup = peak_reserved(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = 0
    with profiled(trace, dev) as prof:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while time.perf_counter() - t0 < seconds:
            step()
            steps += 1
        sync(dev)
        window_s = time.perf_counter() - t0
    peak_window = peak_reserved(dev)
    skipped = int(trainer.skip_count) - skips0
    sw.stop()
    del sw, loader, trainer, decision
    out = Outcome("train", model, traffic, window_s, prof)
    out.setup_s = setup_s
    out.steps, out.batch = steps, batch
    out.images = steps * batch
    out.attempted, out.failed = steps, skipped
    out.peak_window_bytes = peak_window
    out.memory_peak_bytes = max(peak_setup, peak_window)
    out.e2e = {"train_images_per_s": steps * batch / window_s,
               "setup_s": setup_s}
    out.check = lambda: _check(model, seed, dev, host_images, host_labels,
                               readings)
    return out


def _check(model, seed, dev, host_images, host_labels, readings):
    """The reference's three steps over the rows the program took."""
    rows = numpy.concatenate(readings["rows"])
    if len(set(rows.tolist())) != len(rows):
        raise RuntimeError("the checked steps took a row twice")
    batches = [(torch.from_numpy(host_images[r]).to(dev),
                torch.from_numpy(host_labels[r]).to(dev))
               for r in readings["rows"]]
    params = inputs.make_params(model, seed, dev)
    with reference.tf32(False):
        want = reference.train_steps(model, params, batches,
                                     dropout_seed(seed), CHECKED_STEPS)
    from portbench import check
    return check.train_numbers(readings, want,
                               model.solver["learning_rate"])
