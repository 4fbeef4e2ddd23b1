"""Publisher unit: gathers a training report and hands it to backends.

Counterpart of ``veles_tpu/publishing/publisher.py``: ``gather_info``
collects the workflow's name, checksum, date, epochs, the decision's
metrics, the loader's class lengths, every unit's runs and run time,
the workflow graph (``generate_graph``) and ``gather_results``, under
the JAX package's keys; ``run`` renders the info through each backend
(nothing on a slave).
"""

import time

from veles_tpu_torch.units import Unit

__all__ = ["Publisher"]


class Publisher(Unit):
    def __init__(self, workflow, **kwargs):
        super(Publisher, self).__init__(workflow, **kwargs)
        self.backends = list(kwargs.get("backends", ()))
        self.plots_dir = kwargs.get("plots_dir")
        self.reports = []

    def gather_info(self):
        sw = self.workflow
        decision = getattr(sw, "decision", None)
        loader = getattr(sw, "loader", None)
        info = {
            "name": type(sw).__name__,
            "checksum": sw.checksum,
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
            "epochs": getattr(decision, "epoch_number", None),
            "metrics": {
                "test": getattr(decision, "epoch_metrics",
                                [None] * 3)[0],
                "validation": getattr(decision, "epoch_metrics",
                                      [None] * 3)[1],
                "train": getattr(decision, "epoch_metrics",
                                 [None] * 3)[2],
                "best": getattr(decision, "best_metric", None),
            },
            "dataset": {
                "test": loader.class_lengths[0] if loader else 0,
                "validation": loader.class_lengths[1] if loader else 0,
                "train": loader.class_lengths[2] if loader else 0,
            },
            "units": [
                {"name": u.name, "runs": u.run_calls,
                 "time": round(u.timers.get("run", 0.0), 4)}
                for u in sw.units if u is not sw],
            "graph_dot": sw.generate_graph(),
            "plots_dir": self.plots_dir,
        }
        results = sw.gather_results()
        if results:
            info["results"] = results
        return info

    def run(self):
        if self.workflow is not None and \
                self.workflow.workflow_mode == "slave":
            return
        info = self.gather_info()
        for backend in self.backends:
            self.reports.append(backend.render(info))
