"""Concrete plotter units.

Counterpart of ``veles_tpu/plotting_units.py``: accumulating line plots
(a metric a run), the matrix (confusion) plot, sample images, the
histogram, the per-unit multi-histogram, the min/max table and the
per-slave statistics.  Each keeps plain captured state, so it pickles
small and renders anywhere (the graphics client, the tests).  A capture
reads a port ``Array`` through ``map_read``: one device-to-host copy,
on the host side of the unit graph.
"""

import numpy

from veles_tpu_torch.plotter import Plotter

__all__ = ["AccumulatingPlotter", "MatrixPlotter", "ImagePlotter",
           "Histogram", "MultiHistogram", "TableMaxMin", "SlaveStats"]


class AccumulatingPlotter(Plotter):
    """Appends one scalar per run; renders the series
    (reference AccumulatingPlotter)."""

    def __init__(self, workflow, **kwargs):
        super(AccumulatingPlotter, self).__init__(workflow, **kwargs)
        self.input = None          # linked: object with the value
        self.input_field = kwargs.get("input_field")
        self.label = kwargs.get("label", "metric")
        self.plot_style = kwargs.get("plot_style", "-")
        self.values = []

    def capture(self):
        value = self.input
        if self.input_field is not None:
            if isinstance(value, (list, tuple, dict)):
                value = value[self.input_field]
            else:
                value = getattr(value, self.input_field)
        if value is not None:
            self.values.append(float(value))

    def render(self, axes):
        axes.plot(self.values, self.plot_style, label=self.label)
        axes.set_xlabel("updates")
        axes.set_ylabel(self.label)
        axes.legend()


class MatrixPlotter(Plotter):
    """Renders a matrix with cell annotations — the confusion-matrix
    plotter (reference MatrixPlotter)."""

    def __init__(self, workflow, **kwargs):
        super(MatrixPlotter, self).__init__(workflow, **kwargs)
        self.input = None  # linked Array or ndarray
        self.matrix = None

    def capture(self):
        arr = self.input
        if hasattr(arr, "map_read"):
            arr.map_read()
            arr = arr.mem
        if arr is not None:
            self.matrix = numpy.array(arr)

    def render(self, axes):
        axes.imshow(self.matrix, interpolation="nearest", cmap="Blues")
        n_rows, n_cols = self.matrix.shape
        for r in range(n_rows):
            for c in range(n_cols):
                axes.text(c, r, str(self.matrix[r, c]),
                          ha="center", va="center", fontsize=8)
        axes.set_xlabel("predicted")
        axes.set_ylabel("target")


class ImagePlotter(Plotter):
    """Shows sample images (reference ImagePlotter)."""

    def __init__(self, workflow, **kwargs):
        super(ImagePlotter, self).__init__(workflow, **kwargs)
        self.input = None
        self.count = kwargs.get("count", 1)
        self.images = None

    def capture(self):
        arr = self.input
        if hasattr(arr, "map_read"):
            arr.map_read()
            arr = arr.mem
        if arr is not None:
            self.images = numpy.array(arr[:self.count])

    def render(self, axes):
        img = self.images[0]
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        axes.imshow(img, cmap="gray")
        axes.axis("off")


class Histogram(Plotter):
    """Value histogram of a tensor (reference Histogram)."""

    def __init__(self, workflow, **kwargs):
        super(Histogram, self).__init__(workflow, **kwargs)
        self.input = None
        self.n_bins = kwargs.get("n_bins", 30)
        self.counts = None
        self.edges = None

    def capture(self):
        arr = self.input
        if hasattr(arr, "map_read"):
            arr.map_read()
            arr = arr.mem
        if arr is not None:
            self.counts, self.edges = numpy.histogram(
                numpy.asarray(arr).ravel(), bins=self.n_bins)

    def render(self, axes):
        centers = (self.edges[:-1] + self.edges[1:]) / 2
        axes.bar(centers, self.counts,
                 width=(self.edges[1] - self.edges[0]) * 0.9)
        axes.set_ylabel("count")


class MultiHistogram(Plotter):
    """Grid of per-unit weight histograms (reference MultiHistogram); an
    empty Array (a pooling layer's weights) is left out."""

    def __init__(self, workflow, **kwargs):
        super(MultiHistogram, self).__init__(workflow, **kwargs)
        self.inputs = []  # list of Arrays
        self.n_bins = kwargs.get("n_bins", 20)
        self.hists = []

    def capture(self):
        self.hists = []
        for arr in self.inputs:
            if hasattr(arr, "map_read"):
                arr.map_read()
                data = arr.mem
            else:
                data = arr
            if data is None:
                continue  # an empty Array: a layer without weights
            self.hists.append(numpy.histogram(
                numpy.asarray(data).ravel(), bins=self.n_bins))

    def render(self, axes):
        for i, (counts, edges) in enumerate(self.hists):
            centers = (edges[:-1] + edges[1:]) / 2
            axes.plot(centers, counts, label="w%d" % i)
        axes.legend()


class TableMaxMin(Plotter):
    """Min/max table of watched tensors (reference TableMaxMin)."""

    def __init__(self, workflow, **kwargs):
        super(TableMaxMin, self).__init__(workflow, **kwargs)
        self.inputs = []
        self.names = []
        self.rows = []

    def capture(self):
        self.rows = []
        for name, arr in zip(self.names, self.inputs):
            if hasattr(arr, "map_read"):
                arr.map_read()
                data = arr.mem
            else:
                data = arr
            data = numpy.asarray(data)
            self.rows.append((name, float(data.min()),
                              float(data.max())))

    def render(self, axes):
        axes.axis("off")
        cells = [["%s" % n, "%.4g" % mn, "%.4g" % mx]
                 for n, mn, mx in self.rows]
        axes.table(cellText=cells, colLabels=["name", "min", "max"],
                   loc="center")


class SlaveStats(Plotter):
    """Per-slave job statistics from the control-plane server
    (reference SlaveStats)."""

    def __init__(self, workflow, **kwargs):
        super(SlaveStats, self).__init__(workflow, **kwargs)
        self.server = None  # linked veles_tpu_torch.server.Server
        self.stats = []

    def capture(self):
        self.stats = []
        if self.server is None:
            return
        for conn in self.server.slaves.values():
            times = list(conn.job_times)
            self.stats.append({
                "id": conn.slave.id[:8],
                "power": conn.slave.power,
                "jobs": len(times),
                "mean_time": float(numpy.mean(times)) if times else 0.0,
            })

    def render(self, axes):
        axes.axis("off")
        cells = [[s["id"], "%.1f" % s["power"], str(s["jobs"]),
                  "%.3f" % s["mean_time"]] for s in self.stats]
        axes.table(cellText=cells or [["-", "-", "-", "-"]],
                   colLabels=["slave", "power", "jobs", "mean s"],
                   loc="center")
