"""Graphics transport: a ZMQ PUB socket broadcasting pickled plotters.

Counterpart of ``veles_tpu/graphics_server.py``.  The PUB socket binds
tcp (a free port on 127.0.0.1), ipc (a socket file in the temporary
directory) and inproc, and tries the EPGM multicast endpoint of
``root.common.graphics.multicast_address``: bound where the zmq build
carries pgm, skipped with a log line where it does not, the plots then
riding tcp / ipc / inproc.  Each payload is
:func:`veles_tpu_torch.plotter.dumps` of a plotter.  The renderer is a
separate process (:mod:`veles_tpu_torch.graphics_client`,
:meth:`GraphicsServer.launch_client`).  A host service: it touches no
device.
"""

import os
import subprocess
import sys
import tempfile

from veles_tpu_torch import plotter as plotter_module
from veles_tpu_torch.logger import Logger

__all__ = ["GraphicsServer"]


class GraphicsServer(Logger):
    def __init__(self, launcher=None):
        super(GraphicsServer, self).__init__()
        import zmq
        self.context = zmq.Context.instance()
        self.socket = self.context.socket(zmq.PUB)
        self.endpoints = {}
        port = self.socket.bind_to_random_port("tcp://127.0.0.1")
        self.endpoints["tcp"] = "tcp://127.0.0.1:%d" % port
        ipc_path = os.path.join(
            tempfile.gettempdir(),
            "veles-tpu-torch-graphics-%d.ipc" % os.getpid())
        try:
            self.socket.bind("ipc://" + ipc_path)
            self.endpoints["ipc"] = "ipc://" + ipc_path
        except zmq.ZMQError:
            pass
        inproc = "inproc://veles-tpu-torch-graphics"
        try:
            self.socket.bind(inproc)
            self.endpoints["inproc"] = inproc
        except zmq.ZMQError:
            pass
        from veles_tpu_torch.config import root
        mcast = root.common.graphics.get("multicast_address")
        if mcast:
            epgm = "epgm://%s:5555" % mcast
            try:
                self.socket.bind(epgm)
                self.endpoints["epgm"] = epgm
            except zmq.ZMQError as exc:
                self.info("EPGM multicast unavailable (%s): %s; plots "
                          "ride tcp/ipc/inproc", epgm, exc)
        if launcher is not None:
            launcher.graphics_server = self
        self.published = 0
        self.info("graphics server on %s", self.endpoints["tcp"])

    def publish(self, plot):
        self.socket.send(plotter_module.dumps(plot))
        self.published += 1

    def shutdown(self):
        self.socket.close(0)

    @staticmethod
    def launch_client(output_dir, endpoint, extra_env=None):
        """Start the renderer process (``python -m
        veles_tpu_torch.graphics_client``); returns its Popen."""
        env = dict(os.environ)
        env.update(extra_env or {})
        return subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch.graphics_client",
             "--endpoint", endpoint, "--output", output_dir], env=env)
