"""The serving cells: the program's ``AOTEngine`` (f32, or int8 after
its post-training quantization) behind a ``ContinuousBatcher``, under
open-loop arrivals.

The plans are the workflow's (``compiler.workflow_plan`` of a
``StandardWorkflow`` over the configuration's zoo layers, as a
snapshot gives them), the weights the benchmark's.  Set-up quantizes
(int8: calibrated on the traffic's seeded calibration images),
captures the ladder, starts the batcher and sends each rung's worth of
requests through it twice.  The window then submits single images from
the seeded pool on the seeded schedule (:func:`inputs.schedule`) from
this thread, whatever the backlog: open loop.  Each request's latency
runs from the moment it was due to its answer, so a stall delays the
requests behind it too; a shed or failed request counts as missing.
A sample of the requests, drawn from the seed before the window, keeps
its answers for the comparison with the reference.
"""

import collections
import gc
import time

import numpy
import torch

from portbench import inputs, reference
from portbench.outcome import Outcome, peak_reserved, profiled, sync
from portbench.train import program_specs

__all__ = ["run", "start", "engine_for", "batcher_for", "warm", "Answers",
           "offer", "plans_for", "sample_indices", "reference_quantized",
           "reference_logp"]

#: answered requests compared with the reference
SAMPLE = 256
#: how long after the window's close an answer is waited for
GRACE_S = 60.0


def plans_for(model):
    """The program's plans of the configuration's layers."""
    from veles_tpu_torch.compiler import workflow_plan
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    sw = StandardWorkflow(DummyLauncher(), layers=program_specs(model),
                          loader_factory=lambda w: FullBatchLoader(
                              w, minibatch_size=1))
    return workflow_plan(sw)


def engine_for(model, traffic, seed, dev):
    """The captured engine of the traffic's precision and ladder, on
    the seeded weights (int8: quantized by the program)."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.serve.engine import AOTEngine
    device = Device(dev.type)
    plans = plans_for(model)
    params = inputs.make_params(model, seed, dev)
    if traffic["precision"] == "int8":
        from veles_tpu_torch.quant import quantize_model_spec
        calib = inputs.make_images(model, seed, "calibration",
                                   int(traffic["calibration_images"]), dev)
        params, _ = quantize_model_spec(
            plans, params, samples=calib.cpu().numpy(),
            percentile=float(traffic["calibration_percentile"]),
            device=device)
        del calib
    elif traffic["precision"] != "float32":
        raise ValueError("precision %r" % traffic["precision"])
    engine = AOTEngine(plans, params, model.input_shape,
                       ladder=traffic["ladder"], device=device)
    engine.compile()
    return engine


def warm(batcher, pool, ladder):
    """Each rung's worth of requests at once, twice: the batcher's
    staging buffer of every rung is made and touched."""
    for _ in range(2):
        for rung in ladder:
            reqs = [batcher.submit(pool[i % len(pool)])
                    for i in range(rung)]
            for req in reqs:
                req.done.wait(60.0)


class Answers(object):
    """What a window keeps of its requests.  Each request is let go as
    soon as it is answered, as an outside client lets go of its
    answer, so the load leaves the process nothing to collect (a window
    that held every request would hand the cyclic collector tens of
    thousands of survivors, and its full passes stall every thread for
    ~150 ms).  Per request: the seconds from its due time to its answer
    (inf while it has none), how late it was submitted, whether it was
    shed and its ``queue`` mark; per dispatch (by its ``device`` mark's
    start): its ``device`` + ``d2h`` seconds and rows; and the answers
    of the requests in ``keep``."""

    def __init__(self, times, t0, keep=()):
        count = len(times)
        self.times, self.t0 = times, t0
        self.latency = numpy.full(count, numpy.inf)
        self.late = numpy.zeros(count)
        self.shed = numpy.zeros(count, bool)
        self.queue_s = numpy.full(count, numpy.nan)
        self.dispatches = {}
        self.keep = set(int(i) for i in keep)
        self.results = {}
        self._open = collections.deque()

    @property
    def answered(self):
        return int(numpy.isfinite(self.latency).sum())

    def note(self, i, req):
        if req is None:
            self.shed[i] = True
        else:
            self._open.append((i, req))

    def reap(self):
        """Let go of the answered requests at the head of the line."""
        while self._open and self._open[0][1].done.is_set():
            self._close(*self._open.popleft())

    def wait(self, deadline):
        """Wait for each open request until ``deadline``."""
        while self._open:
            i, req = self._open.popleft()
            if req.done.wait(max(0.0, deadline - time.perf_counter())):
                self._close(i, req)

    def _close(self, i, req):
        if req.error is not None or req.result is None:
            return
        self.latency[i] = req.enqueued - (self.t0 + self.times[i]) + \
            req.latency
        if i in self.keep:
            self.results[i] = req.result
        marks = {name: (start, dur) for name, start, dur in req.marks or ()}
        if "queue" in marks:
            self.queue_s[i] = marks["queue"][1]
        if "device" in marks and "d2h" in marks:
            start, dur = marks["device"]
            rows = self.dispatches.get(start, (0.0, 0))[1]
            self.dispatches[start] = (dur + marks["d2h"][1], rows + req.rows)


def offer(batcher, pool, times, images, answers, lo=0, hi=None):
    """Submit ``pool[images[i]]`` at ``answers.t0 + times[i]`` for ``i``
    in ``[lo, hi)`` (open loop: late submissions go at once), noting
    each request in ``answers``."""
    from veles_tpu_torch.serve.batcher import ServeOverload
    t0 = answers.t0
    for i in range(lo, len(times) if hi is None else hi):
        answers.reap()
        wait = t0 + times[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        answers.late[i] = time.perf_counter() - t0 - times[i]
        try:
            req = batcher.submit(pool[images[i]])
        except ServeOverload:
            req = None
        answers.note(i, req)


def batcher_for(engine, traffic):
    """A started batcher over ``engine``, as the traffic sets it."""
    from veles_tpu_torch.serve.batcher import ContinuousBatcher
    return ContinuousBatcher(
        engine, max_delay_s=float(traffic["max_delay_ms"]) / 1e3,
        max_queue=int(traffic["max_queue"])).start()


def start(model, traffic, seed, dev):
    """The engine and its running batcher, as the traffic sets them."""
    engine = engine_for(model, traffic, seed, dev)
    return engine, batcher_for(engine, traffic)


def run(model, traffic, seed, seconds, trace, device, t_start):
    dev = torch.device(device)
    engine, batcher = start(model, traffic, seed, dev)
    try:
        pool = inputs.make_images(model, seed, "pool", int(traffic["pool"]),
                                  dev).cpu().numpy()
        warm(batcher, pool, engine.ladder)
        times, images = inputs.schedule(seed, float(traffic["rate_per_s"]),
                                        seconds, len(pool))
        # set-up's survivors collected now, so no full pass of the
        # cyclic collector falls into the window
        gc.collect()
        sync(dev)
        peak_setup = peak_reserved(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stats0 = dict(batcher.stats)
        full0 = gc.get_stats()[2]["collections"]
        keep = sample_indices(seed, len(times))
        with profiled(trace, dev) as prof:
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            answers = Answers(times, t0, keep)
            offer(batcher, pool, times, images, answers)
            answers.wait(t0 + seconds + GRACE_S)
            sync(dev)
            window_s = time.perf_counter() - t0
        full = gc.get_stats()[2]["collections"] - full0
        stats = {k: batcher.stats[k] - stats0.get(k, 0)
                 for k in batcher.stats}
    finally:
        batcher.stop()
    peak_window = peak_reserved(dev)
    ladder = engine.ladder
    # the program's quantized state (host arrays), judged by the check
    qstate = engine.params if traffic["precision"] == "int8" else None
    del engine, batcher
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    missing = len(times) - answers.answered
    out = Outcome("serve", model, traffic, window_s, prof)
    out.setup_s = setup_s
    out.attempted, out.failed = len(times), missing
    out.missing = missing
    out.memory_peak_bytes = max(peak_setup, peak_window)
    out.answers = answers
    out.stats, out.ladder = stats, ladder
    out.precision = traffic["precision"]
    # a missing request's latency is beyond any answer's: the longest
    # wait the run could see stands for it
    finite = numpy.where(numpy.isfinite(answers.latency), answers.latency,
                         seconds + GRACE_S) * 1e3
    out.e2e = {"serve_p50_ms": float(numpy.percentile(finite, 50)),
               "serve_p95_ms": float(numpy.percentile(finite, 95)),
               "serve_p99_ms": float(numpy.percentile(finite, 99)),
               "serve_images_per_s": answers.answered / window_s,
               "setup_s": setup_s}
    late = answers.late
    out.extra = {"requests": len(times),
                 "generator_late_ms_p50": float(numpy.median(late)) * 1e3,
                 "generator_late_ms_max": float(late.max()) * 1e3
                 if len(late) else 0.0,
                 "gc_full_collections": full}
    results = answers.results
    out.check = lambda: _check(model, traffic, seed, dev, pool, images,
                               results, qstate)
    return out


def sample_indices(seed, count, size=SAMPLE):
    """A seeded sample of ``size`` of a window's ``count`` request
    indices, sorted: the requests whose answers the check compares."""
    if count <= size:
        return numpy.arange(count)
    rng = numpy.random.Generator(numpy.random.Philox(
        inputs.subseed(seed, "check")))
    return numpy.sort(rng.choice(count, size, replace=False))


def reference_quantized(model, traffic, seed, dev, qmax=127):
    """The reference's own int8 (``qmax``) quantization of the seeded
    weights on the seeded calibration images."""
    params = inputs.make_params(model, seed, dev)
    calib = inputs.make_images(model, seed, "calibration",
                               int(traffic["calibration_images"]), dev)
    with reference.tf32(False):
        return reference.quantize(
            model, params, calib, qmax=qmax,
            percentile=float(traffic["calibration_percentile"]))


def reference_logp(model, traffic, seed, dev, x, qparams=None, tf32=False):
    """The reference's log-probabilities of images ``x`` (a device
    tensor): float32 from the seeded weights, or the quantized model
    ``qparams`` (:func:`reference_quantized`)."""
    with reference.tf32(tf32), torch.no_grad():
        if qparams is not None:
            logits = reference.quantized_logits(model, qparams, x)
        else:
            logits = reference.forward_logits(
                model, inputs.make_params(model, seed, dev), x)
        return torch.log_softmax(logits, dim=-1).double().cpu().numpy()


def _check(model, traffic, seed, dev, pool, images, results, qstate):
    from portbench import check
    picked = sorted(results)
    if not picked:
        return {"logp_gap": float("nan")}
    numbers, qparams = {}, None
    if qstate is not None:
        # the reference quantizes for itself; the program's quantized
        # state is read only to be judged against it
        qparams = reference_quantized(model, traffic, seed, dev)
        numbers.update(check.quant_numbers(
            reference.as_quantized(model, qstate, dev), qparams))
        del qstate
    x = torch.from_numpy(pool[images[picked]]).to(dev)
    want = reference_logp(model, traffic, seed, dev, x, qparams)
    with numpy.errstate(divide="ignore"):
        got = numpy.log(numpy.stack([results[i] for i in picked]).astype(
            numpy.float64))
    numbers.update(check.serve_numbers(got, want))
    return numbers
