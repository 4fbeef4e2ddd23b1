"""Plotter framework: units that ship themselves to the graphics
service for rendering.

Counterpart of ``veles_tpu/plotter.py``.  A Plotter unit's ``run()``
captures its linked data into plain attributes (``capture``) and
publishes a stripped pickle of itself on the launcher's
:class:`~veles_tpu_torch.graphics_server.GraphicsServer`; a separate
graphics client renders it (``render(axes)``, matplotlib), so training
never waits on rendering.  On a slave ``run()`` does nothing.

A payload is one codec byte and the pickle of the port's object: ``g``
gzip (level 1) or ``r`` raw.  The pickle leaves out the unit's links
and workflow, and the live sources a capture reads (``input``,
``inputs``, ``server``): what is published is the captured data alone.
A capture reads the port's ``Array``s with ``map_read``, one
device-to-host copy each, on the host side of the unit graph.
"""

import gzip
import pickle

from veles_tpu_torch.units import Unit

__all__ = ["Plotter", "dumps", "loads"]

#: the attributes a capture reads from (live Arrays, units, servers);
#: a published plot carries what they held, not them
SOURCE_ATTRS = ("input", "inputs", "server")


class Plotter(Unit):
    """Base plotter; subclasses implement capture() and render(axes)."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        super(Plotter, self).__init__(workflow, **kwargs)
        self.clear_plot = kwargs.get("clear_plot", False)
        self.redraw_plot = kwargs.get("redraw_plot", True)

    @property
    def graphics_server(self):
        workflow = self.workflow
        launcher = getattr(workflow, "launcher", None)
        return getattr(launcher, "graphics_server", None)

    def run(self):
        if self.workflow is not None and \
                self.workflow.workflow_mode == "slave":
            return  # plotting happens on a master or standalone only
        self.capture()
        server = self.graphics_server
        if server is not None:
            server.publish(self)

    def capture(self):
        """Snapshot linked data into plain attributes before pickling."""

    def render(self, axes):
        """Draw onto a matplotlib axes."""
        raise NotImplementedError

    def __getstate__(self):
        state = super(Plotter, self).__getstate__()
        state["_links_from"] = {}
        state["_links_to"] = {}
        state["_workflow"] = None
        for name in SOURCE_ATTRS:
            if name in state:
                state[name] = [] if name == "inputs" else None
        return state


def dumps(plotter):
    return b"g" + gzip.compress(
        pickle.dumps(plotter, protocol=pickle.HIGHEST_PROTOCOL), 1)


def loads(blob):
    codec, payload = blob[:1], blob[1:]
    if codec == b"g":
        return pickle.loads(gzip.decompress(payload))
    if codec == b"r":
        return pickle.loads(payload)
    raise ValueError("unknown plot codec %r" % codec)
