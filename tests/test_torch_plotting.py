"""The port's plotters and graphics transport (veles_tpu_torch/plotter.py,
plotting_units.py, graphics_server.py, graphics_client.py and
``StandardWorkflow.link_plotters``) against the JAX package's.

- each of the seven plotters captures, on the same seeded arrays, what
  the JAX package's captures: equal values, matrix, histogram counts
  and edges, table rows, slave statistics;
- each renders a PNG of more than 500 bytes (tests/test_services.py);
- ``dumps`` / ``loads`` use the same codec bytes (``g`` gzip, ``r`` raw)
  and refuse an unknown one;
- ``link_plotters`` on a 3-epoch per-unit CPU run gives error curves
  within rel 1e-4 of the JAX package's from the same seeds and weights
  (one point a finished epoch, and the final epoch's, which the JAX
  package's exit leaves out) and the same confusion matrix; fused, the
  confusion matrix is the epoch's validation minibatches';
- the pub/sub round trip of tests/test_services.py, a workflow's linked
  plotters published through a launcher's ``GraphicsServer`` and
  received equal to the live ones, and the graphics client process
  rendering what it receives; a slave's plotter publishes nothing.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy
import pytest

import veles_tpu.plotter as jax_plotter
import veles_tpu.plotting_units as jax_units
import veles_tpu_torch.plotter as torch_plotter
import veles_tpu_torch.plotting_units as torch_units
import veles_tpu_torch.prng as torch_prng
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.memory import Array as JaxArray
from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.memory import Array

from test_torch_workflow import blobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLOTTERS = ("AccumulatingPlotter", "MatrixPlotter", "ImagePlotter",
            "Histogram", "MultiHistogram", "TableMaxMin", "SlaveStats")


class _Slave(object):
    def __init__(self, sid, power):
        self.id = sid
        self.power = power


class _Conn(object):
    def __init__(self, sid, power, times):
        self.slave = _Slave(sid, power)
        self.job_times = list(times)


class _Server(object):
    """What SlaveStats reads of a control-plane server."""

    def __init__(self):
        self.slaves = {"a": _Conn("a" * 16, 12.5, [0.5, 0.25, 1.0]),
                       "b": _Conn("b" * 16, 3.0, [])}


def _captured(units, array, dummy, name):
    """``name`` from ``units`` fed the seeded inputs, captured."""
    rng = numpy.random.RandomState(0)
    wf = dummy()
    cls = getattr(units, name)
    plot = cls(wf, label="err") if name == "AccumulatingPlotter" \
        else cls(wf)
    if name == "AccumulatingPlotter":
        for value in (5.0, 3.0, 2.0, 1.5):
            plot.input = value
            plot.capture()
    elif name == "MatrixPlotter":
        plot.input = array(rng.randint(0, 50, (4, 4)).astype(numpy.int32))
    elif name == "ImagePlotter":
        plot.input = array(rng.rand(2, 8, 8).astype(numpy.float32))
    elif name == "Histogram":
        plot.input = array(rng.randn(500).astype(numpy.float32))
    elif name == "MultiHistogram":
        plot.inputs = [array(rng.randn(100).astype(numpy.float32)),
                       array(rng.randn(100).astype(numpy.float32))]
    elif name == "TableMaxMin":
        plot.names = ["w0", "b0"]
        plot.inputs = [array(rng.randn(10).astype(numpy.float32)),
                       array(rng.randn(5).astype(numpy.float32))]
    elif name == "SlaveStats":
        plot.server = _Server()
    if name != "AccumulatingPlotter":
        plot.capture()
    return plot


def _data(plot):
    """A plotter's captured data, comparable across packages."""
    name = type(plot).__name__
    if name in ("AccumulatingPlotter", "EpochCurve"):
        return plot.values
    if name == "MatrixPlotter":
        return plot.matrix.tolist()
    if name == "ImagePlotter":
        return plot.images.tolist()
    if name == "Histogram":
        return plot.counts.tolist(), plot.edges.tolist()
    if name == "MultiHistogram":
        return [(c.tolist(), e.tolist()) for c, e in plot.hists]
    if name == "TableMaxMin":
        return plot.rows
    return plot.stats


def _torch_plot(name):
    return _captured(torch_units, Array, DummyWorkflow, name)


@pytest.mark.parametrize("name", PLOTTERS)
def test_capture_matches_jax(name):
    got = _torch_plot(name)
    want = _captured(jax_units, JaxArray, JaxDummyWorkflow, name)
    assert _data(got) == _data(want)
    assert _data(got)  # something was captured


@pytest.mark.parametrize("name", PLOTTERS)
def test_renders_png(name, tmp_path):
    pytest.importorskip("matplotlib")
    from veles_tpu_torch.graphics_client import render_plot
    path = render_plot(_torch_plot(name), str(tmp_path))
    assert path.endswith(name + ".png")
    assert os.path.getsize(path) > 500


def test_codec_bytes_match_jax():
    plot = _torch_plot("Histogram")
    blob = torch_plotter.dumps(plot)
    jax_blob = jax_plotter.dumps(_captured(
        jax_units, JaxArray, JaxDummyWorkflow, "Histogram"))
    assert blob[:1] == jax_blob[:1] == b"g"
    back = torch_plotter.loads(blob)
    assert type(back) is torch_units.Histogram
    assert _data(back) == _data(plot)
    assert back.workflow is None and back.input is None
    raw = b"r" + pickle.dumps(plot)
    assert _data(torch_plotter.loads(raw)) == _data(jax_plotter.loads(
        b"r" + pickle.dumps(_captured(jax_units, JaxArray,
                                      JaxDummyWorkflow, "Histogram"))))
    for loads in (torch_plotter.loads, jax_plotter.loads):
        with pytest.raises(ValueError):
            loads(b"x" + blob[1:])


def _linked_jax(arrays):
    import veles_tpu.prng as jax_prng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWf
    from test_torch_loader import JaxArraysLoader
    from test_torch_workflow import layers
    sw = JaxWf(JaxLauncher(), layers=layers(),
               loader_factory=lambda w: JaxArraysLoader(
                   w, arrays, minibatch_size=20,
                   prng=jax_prng.RandomGenerator("loader", seed=1)),
               decision_config=dict(max_epochs=3))
    plots = sw.link_plotters()
    jax_prng.get().seed(11)
    sw.initialize(device=JaxDevice(backend="cpu"))
    sw.run()
    return sw, plots


def _linked_torch(arrays, fuse=False, launcher=None):
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from test_torch_loader import TorchArraysLoader
    from test_torch_workflow import layers
    sw = StandardWorkflow(
        launcher or DummyLauncher(), layers=layers(),
        loader_factory=lambda w: TorchArraysLoader(
            w, arrays, minibatch_size=20,
            prng=torch_prng.RandomGenerator("loader", seed=1)),
        decision_config=dict(max_epochs=3))
    if fuse:
        sw.fuse()
    plots = sw.link_plotters()
    torch_prng.get().seed(11)
    sw.initialize(device=Device(backend="cpu"))
    sw.run()
    return sw, plots


def test_link_plotters_curves_match_jax():
    """3 epochs per unit: the curves within rel 1e-4 of JAX's, one point
    a finished epoch, the confusion matrices equal.  The JAX package's
    exit does not wait on its plotters, so its curves stop one epoch
    short; the port's hold the final epoch too, equal to the decision's
    last metrics."""
    arrays = blobs()
    jax_sw, want = _linked_jax(arrays)
    sw, got = _linked_torch(arrays)
    assert [type(p).__name__ for p in got] == [
        "EpochCurve", "EpochCurve", "MatrixPlotter", "MultiHistogram"]
    for g, w in zip(got[:2], want[:2]):
        assert len(g.values) == len(w.values) + 1
        numpy.testing.assert_allclose(g.values[:-1], w.values, rtol=1e-4)
    # the decision's epochs 0-3: validation at each, train from epoch 1
    assert (len(got[0].values), len(got[1].values)) == (4, 3)
    assert got[0].values[-1] == float(sw.decision.epoch_metrics[1])
    assert got[1].values[-1] == float(sw.decision.epoch_metrics[2])
    # the JAX evaluator's matrix at the end of its run (its plotter's last
    # capture is an epoch older)
    jax_sw.evaluator.confusion_matrix.map_read()
    assert got[2].matrix.tolist() == numpy.asarray(
        jax_sw.evaluator.confusion_matrix.mem).tolist()
    assert [int(c.sum()) for c, _ in got[3].hists] == \
        [int(c.sum()) for c, _ in want[3].hists] == [12 * 16, 16 * 4]


def test_fused_confusion_is_the_epochs_validation():
    arrays = blobs()
    sw, plots = _linked_torch(arrays, fuse=True)
    conf = plots[2].matrix
    assert int(conf.sum()) == 30  # the validation count
    assert int(conf.sum() - numpy.trace(conf)) == round(
        sw.decision.epoch_metrics[1] * 30 / 100)
    assert len(plots[0].values) == 4


def test_graphics_pubsub_roundtrip():
    import zmq
    from veles_tpu_torch.graphics_server import GraphicsServer
    server = GraphicsServer()
    sub = zmq.Context.instance().socket(zmq.SUB)
    try:
        sub.connect(server.endpoints["tcp"])
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        time.sleep(0.2)  # PUB/SUB join
        acc = torch_units.AccumulatingPlotter(DummyWorkflow(), label="loss")
        acc.values = [3.0, 2.0, 1.0]
        server.publish(acc)
        assert sub.poll(3000), "no plot frame received"
        plot = torch_plotter.loads(sub.recv())
        assert isinstance(plot, torch_units.AccumulatingPlotter)
        assert plot.values == [3.0, 2.0, 1.0]
        assert set(server.endpoints) >= {"tcp", "ipc", "inproc"}
    finally:
        sub.close(0)
        server.shutdown()


def test_linked_plotters_publish_what_they_hold(tmp_path):
    """A fused run with a GraphicsServer on its launcher: every epoch's
    four plots arrive and equal the live plotters' last captures; the
    graphics client renders them."""
    import zmq
    from veles_tpu_torch.graphics_server import GraphicsServer
    launcher = DummyLauncher()
    server = GraphicsServer(launcher)
    sub = zmq.Context.instance().socket(zmq.SUB)
    client = None
    try:
        sub.connect(server.endpoints["tcp"])
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        out_dir = str(tmp_path / "png")
        env = {"PYTHONPATH": ROOT}
        if _has_matplotlib():
            client = GraphicsServer.launch_client(
                out_dir, server.endpoints["tcp"], extra_env=env)
        time.sleep(1.0)  # both subscribers join before the first plot
        sw, plots = _linked_torch(blobs(), fuse=True, launcher=launcher)
        received = []
        while sub.poll(2000):
            received.append(torch_plotter.loads(sub.recv()))
        # four plots at each of the decision's epochs 0-3
        assert server.published == len(received) == 16
        for live, sent in zip(plots, received[-4:]):
            assert type(sent) is type(live)
            assert _data(sent) == _data(live)
        assert [len(p.values) for p in received[0::4]] == [1, 2, 3, 4]
        if client is not None:
            want = ["EpochCurve.png", "MatrixPlotter.png",
                    "MultiHistogram.png"]
            deadline = time.time() + 120
            while (not os.path.isdir(out_dir) or
                   sorted(os.listdir(out_dir)) != want) and \
                    time.time() < deadline:
                assert client.poll() is None, "the client died"
                time.sleep(0.1)
            assert sorted(os.listdir(out_dir)) == want
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        sub.close(0)
        server.shutdown()


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_slave_plotter_does_not_publish():
    class Recorder(object):
        def __init__(self):
            self.plots = []

        def publish(self, plot):
            self.plots.append(plot)

    from veles_tpu_torch.workflow import Workflow
    for mode, want in (("slave", 0), ("standalone", 1)):
        launcher = DummyLauncher()
        launcher.graphics_server = Recorder()
        launcher.workflow_mode = mode
        wf = Workflow(launcher)
        plot = torch_units.AccumulatingPlotter(wf)
        plot.input = 1.0
        plot.run()
        assert len(launcher.graphics_server.plots) == want, mode
        assert plot.values == ([1.0] if want else [])


def test_graphics_client_module_runs():
    """The client's command line parses (its zmq loop is covered above)."""
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.graphics_client", "--help"],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and "--endpoint" in proc.stdout
