"""The port's input pipeline (veles_tpu_torch/pipeline_input.py, the
staging slots of memory.Array, the loader's serve-record window and
serve shadow, FullBatchLoader's slot buffers, the fused trainer's
``pipeline`` knob) on the CPU, mirroring tests/test_pipeline_input.py
and held against the JAX package's pipeline:

- a pipelined fused run equals the synchronous one bit for bit (epoch
  metrics and weights), through the device gather and the host fill,
  short tails included, and agrees with the JAX package's pipelined run
  (the same epoch metrics, weights within max-rel 1e-4, the workflow
  tests' epoch limit);
- ``Workflow.stop()`` mid-epoch joins the worker, and a later run starts
  a new one; served-ahead minibatches are requeued, never dropped, and a
  pickle taken mid-run resumes to the uninterrupted run's weights bit
  for bit;
- a worker failure (a serve that raises, a gather that fails as a kernel
  that does not build would, ``VELES_CHAOS="pipeline.serve=exc"``)
  raises on the graph thread;
- a divergence rollback with the pipeline on ends as it does with it
  off (tests/test_torch_health.py's run: bit-equal weights);
- auto-fuse starts the pipeline unless
  ``root.common.engine.pipeline_input`` (``VELES_PIPELINE_INPUT=0``)
  says no, and the fused trainer pickles its knob;
- the staging slots, ``print_stats``' stage timers;
- on the card (``cuda``): pinned slots, and kernel 1 launched from the
  worker's thread on its side stream with the run bit-equal to the
  synchronous one.
"""

import io
import os
import pickle
import re
import subprocess
import sys
import threading
import time

import numpy
import pytest
import torch

from veles_tpu_torch import chaos, prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_workflow import StandardWorkflow

CPU = Device(backend="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the workflow tests' epoch limit (tests/test_torch_workflow.py)
EPOCH_TOL = 1e-4

LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 32,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": 4,
     "learning_rate": 0.05, "gradient_moment": 0.9},
]


def _blobs(self):
    """tests/test_models.py's BlobsLoader: 4-class Gaussian blobs."""
    self.class_lengths[:] = [0, 64, 256]
    self._calc_class_end_offsets()
    self.create_originals((16,))
    rng = numpy.random.RandomState(99)
    centers = rng.randn(4, 16) * 2.0
    for i in range(self.total_samples):
        label = i % 4
        self.original_data.mem[i] = centers[label] + rng.randn(16) * 0.3
        self.original_labels[i] = label


def _tail_blobs(self):
    """Class sizes no multiple of the minibatch: validation 10 (tail
    10), train 70 (32 + 32 + 6)."""
    self.class_lengths[:] = [0, 10, 70]
    self._calc_class_end_offsets()
    self.create_originals((16,))
    rng = numpy.random.RandomState(99)
    centers = rng.randn(4, 16) * 2.0
    for i in range(self.total_samples):
        label = i % 4
        self.original_data.mem[i] = centers[label] + rng.randn(16) * 0.3
        self.original_labels[i] = label


class Blobs(FullBatchLoader):
    load_data = _blobs


class TailBlobs(FullBatchLoader):
    load_data = _tail_blobs


def _build(pipeline, max_epochs=4, on_device=True, loader_cls=Blobs,
           minibatch_size=64, device=CPU, depth=1):
    prng.get().seed(1234)
    sw = StandardWorkflow(
        DummyLauncher(), layers=[dict(s) for s in LAYERS],
        loader_factory=lambda w: loader_cls(
            w, minibatch_size=minibatch_size, on_device=on_device,
            prng=prng.RandomGenerator("pipe", seed=7)),
        decision_config=dict(max_epochs=max_epochs))
    sw.fuse(pipeline=pipeline, pipeline_depth=depth)
    sw.initialize(device=device)
    return sw


def _build_jax(on_device):
    """The JAX package's same pipelined run (tests/test_pipeline_input.py
    builds it so)."""
    import veles_tpu.prng as jax_prng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
    from veles_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxStandard
    loader_cls = type("JaxBlobs", (JaxLoader,), {"load_data": _blobs})
    jax_prng.get().seed(1234)
    sw = JaxStandard(
        JaxWorkflow().workflow, layers=[dict(s) for s in LAYERS],
        loader_factory=lambda w: loader_cls(
            w, minibatch_size=64, on_device=on_device,
            prng=jax_prng.RandomGenerator("pipe", seed=7)),
        decision_config=dict(max_epochs=4))
    sw.fuse(pipeline=True)
    sw.initialize(device=JaxDevice(backend="cpu"))
    return sw


def _weights(sw):
    sw.fused_trainer.sync()
    out = []
    for fwd in sw.forwards:
        for arr in (fwd.weights, fwd.bias):
            arr.map_read()
            out.append(numpy.array(arr.mem))
    return out


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("prefetch") and t.is_alive()]


def _step(sw):
    sw.loader.run()
    sw.fused_trainer.run()
    sw.decision.run()


PATHS = pytest.mark.parametrize("on_device", [True, False],
                                ids=["device-gather", "host-fill"])


@PATHS
def test_pipeline_bit_identical_to_sync(on_device):
    sync = _build(False, on_device=on_device)
    sync.run()
    pipe = _build(True, on_device=on_device)
    assert pipe.fused_trainer.prefetcher is not None
    pipe.run()
    assert sync.decision.epoch_metrics == pipe.decision.epoch_metrics
    assert sync.fused_trainer.run_calls == pipe.fused_trainer.run_calls
    for got, want in zip(_weights(pipe), _weights(sync)):
        assert got.tobytes() == want.tobytes()
    assert pipe.fused_trainer.prefetcher.stats["serves"] >= \
        pipe.fused_trainer.run_calls
    assert not _prefetch_threads()


@PATHS
def test_pipeline_depth_two_bit_identical_to_sync(on_device):
    """Two minibatches served ahead (three slots): every slot's buffers
    reused after its consumer, short tails included, and the run equals
    the synchronous one bit for bit."""
    sync = _build(False, on_device=on_device, loader_cls=TailBlobs,
                  minibatch_size=32)
    sync.run()
    pipe = _build(True, on_device=on_device, loader_cls=TailBlobs,
                  minibatch_size=32, depth=2)
    prefetcher = pipe.fused_trainer.prefetcher
    assert prefetcher.depth == 2 and prefetcher.nslots == 3
    pipe.run()
    assert sync.decision.epoch_metrics == pipe.decision.epoch_metrics
    assert sync.fused_trainer.run_calls == pipe.fused_trainer.run_calls
    for got, want in zip(_weights(pipe), _weights(sync)):
        assert got.tobytes() == want.tobytes()
    assert prefetcher.stats["applied"] == pipe.fused_trainer.run_calls
    if on_device:
        slots = {slot for _, slot in pipe.loader._outs_}
        assert slots == {0, 1, 2}
    assert not _prefetch_threads()


@PATHS
def test_pipeline_matches_jax_pipeline(on_device):
    """The same pipelined run in both packages: epoch metrics equal,
    weights within the workflow tests' epoch limit."""
    jsw = _build_jax(on_device)
    jsw.run()
    tsw = _build(True, on_device=on_device)
    tsw.run()
    assert tsw.decision.epoch_metrics == jsw.decision.epoch_metrics
    assert tsw.fused_trainer.run_calls == jsw.fused_trainer.run_calls
    jsw.fused_trainer.sync()
    want = []
    for fwd in jsw.forwards:
        for arr in (fwd.weights, fwd.bias):
            arr.map_read()
            want.append(numpy.asarray(arr.mem, numpy.float64))
    for got, w in zip(_weights(tsw), want):
        rel = numpy.abs(got - w).max() / max(numpy.abs(w).max(), 1e-30)
        assert rel <= EPOCH_TOL, rel


@PATHS
def test_pipeline_short_tail_minibatches(on_device):
    """Short tails keep the synchronous sequence of (class, size,
    offset, flags, epoch) and its zero / -1 padding."""
    def serve_sequence(pipeline, steps=12):
        sw = _build(pipeline, on_device=on_device, loader_cls=TailBlobs,
                    minibatch_size=32)
        loader, trainer = sw.loader, sw.fused_trainer
        seq = []
        for _ in range(steps):
            loader.run()
            pf = trainer.prefetcher
            if pf is not None:
                x, y = pf.current.data, pf.current.labels
            else:
                x = loader.minibatch_data.device_array(trainer.device)
                y = loader.minibatch_labels.device_array(trainer.device)
            seq.append((loader.minibatch_class, loader.minibatch_size,
                        loader.minibatch_offset, bool(loader.last_minibatch),
                        bool(loader.epoch_ended), loader.epoch_number,
                        x.numpy().tobytes(), y.numpy().tobytes()))
            trainer.run()
        sw.stop()
        return seq

    sync_seq = serve_sequence(False)
    pipe_seq = serve_sequence(True)
    assert sync_seq == pipe_seq
    sizes = [s[1] for s in pipe_seq]
    assert 6 in sizes and 10 in sizes
    for _cls, size, _off, _lmb, _ee, _en, xb, yb in pipe_seq:
        if size == 6:
            x = numpy.frombuffer(xb, numpy.float32).reshape(32, 16)
            y = numpy.frombuffer(yb, numpy.int32)
            assert not x[6:].any()
            assert (y[6:] == -1).all()
    assert not _prefetch_threads()


def test_pipeline_stop_mid_epoch_joins_worker():
    sw = _build(True)
    for _ in range(3):
        _step(sw)
    prefetcher = sw.fused_trainer.prefetcher
    assert prefetcher._worker is not None
    assert _prefetch_threads()
    sw.stop()
    assert prefetcher._worker is None
    assert not _prefetch_threads()
    sw.run()
    assert bool(sw.decision.complete)
    assert prefetcher._worker is None
    assert not _prefetch_threads()


def _wait_served_ahead(prefetcher):
    deadline = time.time() + 10.0
    while prefetcher._results.empty() and time.time() < deadline:
        time.sleep(0.01)
    assert not prefetcher._results.empty()


def test_pipeline_never_drops_served_ahead_minibatches():
    """The served-ahead minibatch keeps its record: a mid-run pickle
    requeues it, shutdown does the same, and only consumed samples are
    counted."""
    sw = _build(True)
    loader = sw.loader
    for _ in range(3):
        _step(sw)
    _wait_served_ahead(sw.fused_trainer.prefetcher)
    state = loader.__getstate__()
    assert len(state["failed_minibatches"]) == 1
    sw.stop()
    assert len(loader.failed_minibatches) == 1
    offset, size, mb_class = loader.failed_minibatches[0][:3]
    assert size > 0 and mb_class in (0, 1, 2)
    assert loader.samples_served == 3 * 64


@PATHS
def test_midrun_pickle_resumes_exactly(on_device):
    """A pickle taken while a minibatch is served ahead resumes to the
    uninterrupted run: the same serves, bit-equal weights."""
    steps, cut = 14, 6

    def serves(sw, n):
        seq = []
        for _ in range(n):
            _step(sw)
            loader = sw.loader
            seq.append((loader.minibatch_class, loader.minibatch_size,
                        loader.minibatch_offset, loader.epoch_number))
        return seq

    whole = _build(True, max_epochs=20, on_device=on_device)
    want_seq = serves(whole, steps)
    want = _weights(whole)
    whole.stop()

    sw = _build(True, max_epochs=20, on_device=on_device)
    got_seq = serves(sw, cut)
    _wait_served_ahead(sw.fused_trainer.prefetcher)
    blob = pickle.dumps(sw, protocol=pickle.HIGHEST_PROTOCOL)
    sw.stop()
    restored = pickle.loads(blob)
    assert len(restored.loader.failed_minibatches) == 1
    restored.workflow = DummyLauncher()
    restored.restored_from_snapshot_ = True
    restored.initialize(device=CPU)
    assert restored.fused_trainer.prefetcher is not None
    got_seq += serves(restored, steps - cut)
    got = _weights(restored)
    restored.stop()
    assert got_seq == want_seq
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert not _prefetch_threads()


def test_loader_setstate_migrates_legacy_serving_fields():
    """Snapshots written when minibatch_class / epoch_number were plain
    attributes still restore now that they are properties."""
    sw = _build(False)
    state = sw.loader.__getstate__()
    state["minibatch_class"] = 2
    state["epoch_number"] = 5
    state["minibatch_size"] = 64
    state.pop("_minibatch_class", None)
    state.pop("_epoch_number", None)
    restored = object.__new__(type(sw.loader))
    restored.__setstate__(state)
    assert restored.minibatch_class == 2
    assert restored.epoch_number == 5
    assert restored.minibatch_size == 0


def test_pipeline_worker_failure_propagates():
    sw = _build(True)
    sw.loader.run()
    sw.fused_trainer.run()

    def boom(*args):
        raise RuntimeError("fill exploded")
    sw.loader.fill_indices = boom
    with pytest.raises(RuntimeError, match="fill exploded"):
        for _ in range(4):
            sw.loader.run()
    assert sw.fused_trainer.prefetcher._worker is None
    assert not _prefetch_threads()


def test_gather_failure_on_worker_raises_on_graph_thread(monkeypatch):
    """The first gather of a pipelined run (on the card: the kernel's
    build, at its first launch) happens on the worker: its failure
    raises on the graph thread."""
    import veles_tpu_torch.loader.fullbatch as fullbatch

    def no_kernel(*args, **kwargs):
        raise RuntimeError("nvcc failed on gather.cu")
    monkeypatch.setattr(fullbatch, "gather_minibatch", no_kernel)
    sw = _build(True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sw.run()
    assert sw.fused_trainer.prefetcher._worker is None
    assert not _prefetch_threads()


def test_chaos_pipeline_serve_raises_on_graph_thread(monkeypatch):
    monkeypatch.setenv("VELES_CHAOS", "seed=1;pipeline.serve=exc:n3")
    sw = _build(True)
    chaos.install_from_env()
    try:
        with pytest.raises(RuntimeError, match="injected serve failure"):
            sw.run()
    finally:
        chaos.uninstall()
        sw.stop()
    assert sw.fused_trainer.prefetcher._worker is None
    assert not _prefetch_threads()


def test_rollback_with_pipeline_ends_as_without(tmp_path, monkeypatch):
    """tests/test_torch_health.py's sustained-NaN run (2 rollbacks),
    pipeline off and on: the same rollbacks, learning rates and
    weights, bit for bit."""
    from test_torch_health import _LAYERS, SUSTAINED, TorchNoisyBlobs
    monkeypatch.chdir(tmp_path)
    runs = []
    for pipeline in (False, True):
        saved = (root.common.snapshot.get("dir"),
                 root.common.snapshot.get("time_interval", 15))
        root.common.snapshot.update({
            "dir": str(tmp_path / ("pipe%d" % pipeline)),
            "time_interval": 0})
        try:
            prng.get().seed(4242)
            sw = StandardWorkflow(
                DummyLauncher(), layers=[dict(s) for s in _LAYERS],
                loader_factory=lambda w: TorchNoisyBlobs(
                    w, minibatch_size=64,
                    prng=prng.RandomGenerator("chaos_resume", seed=7)),
                decision_config=dict(max_epochs=6, skip_budget=4))
            sw.fuse(pipeline=pipeline)
            sw.initialize(device=CPU)
        finally:
            root.common.snapshot.update({"dir": saved[0],
                                         "time_interval": saved[1]})
        assert (sw.fused_trainer.prefetcher is not None) == pipeline
        chaos.install(chaos.FaultPlan.from_spec(SUSTAINED))
        try:
            sw.run()
        finally:
            chaos.uninstall()
        runs.append(sw)
    off, on = runs
    assert on.snapshotter.rollbacks == off.snapshotter.rollbacks == 2
    assert bool(on.decision.complete) and bool(off.decision.complete)
    assert [gd.learning_rate for gd in on.gds] == \
        [gd.learning_rate for gd in off.gds]
    assert on.decision.epoch_metrics == off.decision.epoch_metrics
    for got, want in zip(_weights(on), _weights(off)):
        assert numpy.isfinite(got).all()
        assert got.tobytes() == want.tobytes()
    assert not _prefetch_threads()


def test_auto_fuse_starts_the_pipeline():
    """On a CUDA device (claimed here by a CPU device) auto-fuse starts
    the Prefetcher; ``pipeline_input = False`` keeps the synchronous
    serve."""
    def build():
        device = Device(backend="cpu")
        device.backend = "cuda"
        prng.get().seed(1234)
        sw = StandardWorkflow(
            DummyLauncher(), layers=[dict(s) for s in LAYERS],
            loader_factory=lambda w: Blobs(
                w, minibatch_size=64,
                prng=prng.RandomGenerator("pipe", seed=7)),
            decision_config=dict(max_epochs=2))
        sw.initialize(device=device)
        return sw

    sw = build()
    assert sw.fused_trainer.pipeline
    assert sw.fused_trainer.prefetcher is not None
    sw.run()
    assert sw.fused_trainer.prefetcher.stats["applied"] == \
        sw.fused_trainer.run_calls
    root.common.engine.pipeline_input = False
    try:
        off = build()
    finally:
        root.common.engine.pipeline_input = True
    assert off.fused_trainer.prefetcher is None
    off.run()
    assert off.decision.epoch_metrics == sw.decision.epoch_metrics


@pytest.mark.parametrize("value,want", [("0", False), ("1", True)])
def test_pipeline_input_reads_the_environment(value, want):
    env = dict(os.environ, VELES_PIPELINE_INPUT=value)
    out = subprocess.run(
        [sys.executable, "-c", "from veles_tpu_torch.config import root; "
         "print(root.common.engine.pipeline_input)"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)


def test_fused_trainer_pickles_the_pipeline_knob():
    sw = _build(True)
    state = sw.fused_trainer.__getstate__()
    assert state["pipeline"] is True and state["pipeline_depth"] == 1
    assert state["_prefetcher"] is None
    restored = pickle.loads(pickle.dumps(sw.fused_trainer))
    assert restored.pipeline is True and restored.prefetcher is None
    sw.stop()


# -- memory.Array staging -------------------------------------------------


def test_array_staging_ping_pong():
    arr = Array(numpy.zeros((4, 3), numpy.float32))
    arr.stage_init(2)
    assert arr.staged
    bufs = arr._stage_bufs_
    assert bufs[0] is arr.mem
    arr.stage_begin(0)
    arr.mem[:] = 1.0
    dev0 = arr.stage_put(CPU)
    arr.stage_begin(1)
    assert arr.mem is bufs[1] and arr.stage_slot == 1
    arr.mem[:] = 2.0
    dev1 = arr.stage_put(CPU)
    arr.stage_begin(0)
    arr.mem[:] = 3.0
    numpy.testing.assert_array_equal(dev0.numpy(), 1.0)
    numpy.testing.assert_array_equal(dev1.numpy(), 2.0)
    arr.map_read()
    assert arr.mem is bufs[0]
    arr.mem = numpy.zeros((2, 2), numpy.float32)
    assert not arr.staged


def test_array_staged_capture_prefers_device_path():
    arr = Array(numpy.zeros(3, numpy.float32))
    dev = CPU.put(numpy.arange(3, dtype=numpy.float32))
    arr.set_device_array(dev, CPU)
    assert arr.staged_capture(CPU) is dev
    arr.mem = numpy.full(3, 7.0, numpy.float32)
    out = arr.staged_capture(CPU)
    assert out is not dev
    numpy.testing.assert_array_equal(out.numpy(), 7.0)


def test_cpu_device_put_owns_its_buffer():
    buf = numpy.ones((64, 16), numpy.float32)
    dev = CPU.put(buf)
    buf[:] = 3.0
    numpy.testing.assert_array_equal(dev.numpy(), 1.0)


def test_stage_put_decouples_from_host_buffer():
    arr = Array(numpy.ones((64, 16), numpy.float32))
    arr.stage_init(2)
    arr.stage_begin(0)
    arr.mem[:] = 1.0
    dev = arr.stage_put(CPU)
    arr.mem[:] = 3.0
    numpy.testing.assert_array_equal(dev.numpy(), 1.0)


def test_shallow_pickle_reads_no_device_tensor():
    """A shallow Array pickles its shape and dtype only, and leaves the
    device tensor (a pipeline slot being refilled) alone."""
    arr = Array(numpy.zeros((4, 3), numpy.float32), shallow_pickle=True)
    arr.set_device_array(torch.ones(4, 3), CPU)
    restored = pickle.loads(pickle.dumps(arr))
    assert restored.shape == (4, 3) and not restored.mem.any()
    assert arr._state_ == 3  # still device-dirty: no read happened


# -- print_stats ------------------------------------------------------------


def _stats_runs(sw, unit_name, **kwargs):
    buf = io.StringIO()
    sw.print_stats(out=buf, **kwargs)
    text = buf.getvalue()
    match = re.search(r"%s \((\d+) runs\)" % unit_name, text)
    assert match, text
    return int(match.group(1)), text


def test_print_stats_reports_per_run_deltas():
    sw = _build(False, max_epochs=2)
    sw.run()
    first_runs, _ = _stats_runs(sw, "FusedTrainer")
    total_after_first = sw.fused_trainer.run_calls
    assert first_runs == total_after_first
    sw.decision.complete <<= False
    sw.decision.max_epochs = 4
    sw.run()
    second_runs, text = _stats_runs(sw, "FusedTrainer")
    assert second_runs == sw.fused_trainer.run_calls - total_after_first
    assert "(this run)" in text
    cumulative_runs, text = _stats_runs(sw, "FusedTrainer",
                                        cumulative=True)
    assert cumulative_runs == sw.fused_trainer.run_calls
    assert "(this run)" not in text


def test_print_stats_surfaces_pipeline_stage_timers():
    sw = _build(True, max_epochs=2, on_device=False)
    sw.run()
    buf = io.StringIO()
    sw.print_stats(out=buf)
    text = buf.getvalue()
    assert "pipeline_fill" in text
    assert "pipeline_h2d" in text
    assert "pipeline_wait" in text
    assert "depth 1" in text


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned slots, streams and the "
                    "gather kernel have no CPU mode")
    return Device()


@pytest.mark.cuda
def test_cuda_staging_slots_are_pinned(cuda_device):
    arr = Array(numpy.arange(12, dtype=numpy.float32).reshape(4, 3))
    arr.stage_init(2, pin=True)
    assert all(t.is_pinned() for t in arr._stage_pinned_)
    assert arr.mem.tolist() == numpy.arange(12).reshape(4, 3).tolist()
    arr.stage_begin(1)
    arr.mem[:] = 5.0
    dev = arr.stage_put(cuda_device)
    arr.stage_begin(1)  # waits for the upload
    arr.mem[:] = 6.0
    assert (dev.cpu().numpy() == 5.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("on_device", [True, False],
                         ids=["device-gather", "host-fill"])
def test_cuda_pipeline_launches_from_the_side_stream(cuda_device,
                                                     monkeypatch,
                                                     on_device):
    import veles_tpu_torch.ops.gather as gather
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    sync = _build(False, on_device=on_device, device=cuda_device)
    sync.run()
    launches = []
    real = gather._launch

    def spy(*args, **kwargs):
        launches.append((threading.current_thread().name,
                         torch.cuda.current_stream().cuda_stream))
        return real(*args, **kwargs)
    spy.fn = real.fn
    monkeypatch.setattr(gather, "_launch", spy)
    pipe = _build(True, on_device=on_device, device=cuda_device)
    pipe.run()
    for got, want in zip(_weights(pipe), _weights(sync)):
        assert got.tobytes() == want.tobytes()
    assert pipe.decision.epoch_metrics == sync.decision.epoch_metrics
    side = pipe.fused_trainer.prefetcher.side_stream.cuda_stream
    if on_device:
        assert launches and all(name.startswith("prefetch") and
                                stream == side for name, stream in launches)
    else:
        assert not launches
    assert not _prefetch_threads()


@pytest.mark.cuda
@PATHS
def test_cuda_pipeline_depth_two_bit_identical_to_sync(cuda_device,
                                                       monkeypatch,
                                                       on_device):
    """Three slots on the card: each slot's gather buffers or pinned
    staging buffers rewritten only after the graph's stream has read
    them, short tails included; the run equals the synchronous one bit
    for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    sync = _build(False, on_device=on_device, loader_cls=TailBlobs,
                  minibatch_size=32, device=cuda_device)
    sync.run()
    pipe = _build(True, on_device=on_device, loader_cls=TailBlobs,
                  minibatch_size=32, device=cuda_device, depth=2)
    pipe.run()
    prefetcher = pipe.fused_trainer.prefetcher
    assert prefetcher.nslots == 3
    assert pipe.decision.epoch_metrics == sync.decision.epoch_metrics
    for got, want in zip(_weights(pipe), _weights(sync)):
        assert got.tobytes() == want.tobytes()
    if not on_device:
        pinned = pipe.loader.minibatch_data._stage_pinned_
        assert pinned is not None and len(pinned) == 3
        assert all(t.is_pinned() for t in pinned)
    assert not _prefetch_threads()


def test_trainings_in_threads_share_the_card_without_deadlock(monkeypatch):
    """Two pipelined trainings in threads of one process, under the
    card's lock protocol (``graphs.shared()`` around each unit's run and
    initialize, as ``Workflow`` takes it on a card that a job farm's
    local workers share, and a capture every
    third step of each, as the first steps of each graph signature take
    it): neither deadlocks, and each ends with the weights it has alone
    (the job farm's in-process workers)."""
    import contextlib
    from veles_tpu_torch import graphs
    from veles_tpu_torch.models.fused import FusedTrainer
    from veles_tpu_torch.workflow import Workflow
    want = []
    for _ in range(2):
        sw = _build(True, max_epochs=3)
        sw.run()
        want.append(_weights(sw))
    monkeypatch.setattr(Workflow, "_card_hold",
                        lambda self: graphs.shared())
    run = FusedTrainer.run
    calls = {}

    def capturing_run(self):
        n = calls[id(self)] = calls.get(id(self), 0) + 1
        with graphs.capturing() if n % 3 == 1 else \
                contextlib.nullcontext():
            run(self)
    monkeypatch.setattr(FusedTrainer, "run", capturing_run)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results, errors = {}, []
    # built in turn (the layers draw from the global generator), run at
    # once
    sws = [_build(True, max_epochs=3) for _ in range(2)]

    def train(i):
        try:
            sws[i].run()
            results[i] = _weights(sws[i])
        except Exception as exc:  # reported below
            errors.append(exc)
    threads = [threading.Thread(target=train, args=(i,), daemon=True)
               for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads), "deadlocked"
    assert not errors, errors
    assert sum(calls.values()) > 6
    for i in range(2):
        assert all(a.tobytes() == b.tobytes()
                   for a, b in zip(results[i], want[i]))
    assert graphs._SHARED_COUNT[0] == 0 and graphs._CAPTURING[0] is None
