"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
root of a checkout and, under ``portbench/``, one file per
configuration (``configs/<config>.json``, named by the configuration's
``file``), per traffic mix (``traffic/<traffic>.json``), per per-layer
metric (``metrics/<metric>.py``, a ``read(ctx)`` returning a number or
None) and per workload's limits (``limits/<workload>.json``).  Adding
any of them takes a new file and a new entry, never an edit.
"""

import importlib.util
import json
import os

from portbench import check
from portbench.model import load_config

__all__ = ["Bench"]

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


class Bench(object):
    """``root``: the directory holding ``BENCHMARK.json``;
    ``bench_dir``: the one holding configs/, traffic/, metrics/ and
    limits/ (default ``root/portbench``)."""

    def __init__(self, root, bench_dir=None):
        self.root = os.path.abspath(root)
        self.dir = bench_dir or os.path.join(self.root, "portbench")
        with open(os.path.join(self.root, "BENCHMARK.json")) as fin:
            self.spec = json.load(fin)
        self._readers = {}

    def workload(self, name):
        for entry in self.spec["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError("no workload %r in BENCHMARK.json (known: %s)" % (
            name, ", ".join(w["name"] for w in self.spec["workloads"])))

    def config(self, name):
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return load_config(os.path.join(self.root, entry["file"]))
        raise KeyError("no configuration %r in BENCHMARK.json" % name)

    def traffic(self, name):
        with open(os.path.join(self.dir, "traffic", name + ".json")) as fin:
            traffic = json.load(fin)
        traffic["name"] = name
        return traffic

    def limits(self, workload):
        return check.load_limits(self.dir, workload)

    def end_to_end(self, workload):
        """The end-to-end metric entries this workload reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", (workload,))]

    def per_layer(self, workload):
        """The per-layer metric entries this workload reports: those
        that list it, or, without a list, every one whose moved metric
        it reports."""
        moved = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.spec["per_layer"]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif m["moves"] in moved:
                out.append(m)
        return out

    def reader(self, metric):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        fn = self._readers.get(metric)
        if fn is None:
            path = os.path.join(self.dir, "metrics", metric + ".py")
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + metric.replace(".", "_").replace(
                    "-", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            fn = self._readers[metric] = module.read
        return fn
