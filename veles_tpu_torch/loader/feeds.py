"""Queue-fed loaders for interactive and serving pipelines.

Counterpart of ``veles_tpu/loader/feeds.py``: :class:`QueueLoader` and
its :class:`InteractiveLoader` and :class:`RestfulLoader` names serve
whatever ``feed()`` provides, one sample a minibatch of the test class;
:class:`ZeroMQLoader` receives its samples on a ROUTER socket (``zmq``,
imported at initialize); :class:`EnsembleLoader` serves one entry of an
ensemble's results JSON a minibatch.  They serve through the host path.
"""

import json
import queue

import numpy

from veles_tpu_torch.loader.base import Loader, TEST

__all__ = ["QueueLoader", "InteractiveLoader", "RestfulLoader",
           "ZeroMQLoader", "EnsembleLoader"]


class QueueLoader(Loader):
    """Serves whatever feed() provides; TEST-class only (serving)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("testing", True)
        super(QueueLoader, self).__init__(workflow, **kwargs)
        self.sample_shape = kwargs.get("sample_shape")
        self.queue = queue.Queue()

    def feed(self, sample):
        self.queue.put(numpy.asarray(sample, numpy.float32))

    def load_data(self):
        if self.sample_shape is None:
            raise ValueError("sample_shape is required")
        self.class_lengths[:] = [1, 0, 0]  # a rolling TEST stream
        self._calc_class_end_offsets()

    def create_minibatch_data(self):
        self.minibatch_data.mem = numpy.zeros(
            (self.max_minibatch_size,) + tuple(self.sample_shape),
            numpy.float32)

    def analyze_dataset(self):
        self.normalizer.analyze(self.minibatch_data.mem)

    def fill_indices(self, start_offset, count):
        sample = self.queue.get()  # blocks for work
        self.minibatch_size = 1
        self.minibatch_class = TEST
        self.minibatch_data.map_invalidate()
        self.minibatch_data.mem[0] = sample
        self.minibatch_indices.map_invalidate()
        self.minibatch_indices.mem[0] = 0
        return True

    def fill_minibatch(self):
        pass

    def _advance_global_offset(self):
        self.minibatch_class = TEST
        return 1, 1


class InteractiveLoader(QueueLoader):
    """feed() from a notebook or a REPL."""


class RestfulLoader(QueueLoader):
    """Fed by a REST front end for serving pipelines."""


class ZeroMQLoader(QueueLoader):
    """Receives work items over a ZMQ ROUTER socket."""

    def __init__(self, workflow, **kwargs):
        super(ZeroMQLoader, self).__init__(workflow, **kwargs)
        self.endpoint = None
        self._socket = None
        self._thread = None
        self.restartable = False  # stop() closes the socket for good

    def initialize(self, **kwargs):
        import pickle
        import threading

        import zmq

        result = super(ZeroMQLoader, self).initialize(**kwargs)
        context = zmq.Context.instance()
        self._socket = context.socket(zmq.ROUTER)
        port = self._socket.bind_to_random_port("tcp://127.0.0.1")
        self.endpoint = "tcp://127.0.0.1:%d" % port
        self._pump_stop_ = threading.Event()

        def pump():
            # the socket is owned by THIS thread: zmq sockets are not
            # thread-safe, so stop() only raises the flag and the pump
            # closes the socket itself
            while not self._pump_stop_.is_set():
                if not self._socket.poll(100):
                    continue
                identity, payload = self._socket.recv_multipart()
                self.feed(pickle.loads(payload))
                self._socket.send_multipart([identity, b"ok"])
            self._socket.close(0)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        self.info("ZeroMQLoader on %s", self.endpoint)
        return result

    def stop(self):
        super(ZeroMQLoader, self).stop()
        if getattr(self, "_pump_stop_", None) is not None:
            self._pump_stop_.set()


class EnsembleLoader(Loader):
    """Reads an ensemble's results JSON: serves one TEST 'sample' per
    trained model entry so an ensemble-test workflow can iterate
    members."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("testing", True)
        super(EnsembleLoader, self).__init__(workflow, **kwargs)
        self.results_path = kwargs.get("results_path")
        self.models = []
        self.current_model = None

    def load_data(self):
        with open(self.results_path) as fin:
            self.models = json.load(fin)["models"]
        self.class_lengths[:] = [len(self.models), 0, 0]
        self._calc_class_end_offsets()

    def create_minibatch_data(self):
        self.minibatch_data.mem = numpy.zeros(
            (self.max_minibatch_size, 1), numpy.float32)

    def analyze_dataset(self):
        self.normalizer.analyze(self.minibatch_data.mem)

    def fill_minibatch(self):
        index = int(self.minibatch_indices.mem[0])
        self.current_model = self.models[index]
