"""Launcher — owns a workflow and the run session.

Counterpart of ``veles_tpu/launcher.py`` in its standalone mode: it
holds the workflow (the ``Unit.workflow`` protocol), honors ``--resume``
before initialize, resolves the device, runs the workflow and writes
its results.

The device: ``initialize(device=None)`` takes ``-d`` (which the CLI
writes to ``root.common.engine.backend``), else ``VELES_BACKEND``, else
``cuda``, and builds the port's :class:`~veles_tpu_torch.backends.Device`.
``cuda`` raises where there is no card; nothing falls back to the CPU,
which runs only when asked for (``-d cpu``).  The JAX package's ``auto``
and ``tpu`` are refused.

The multi-process start (:meth:`Launcher.init_multihost`): where the
cluster scheduler sets ``VELES_COORDINATOR`` (host:port),
``VELES_NUM_PROCESSES`` and ``VELES_PROCESS_ID``, ``initialize`` joins
the ``torch.distributed`` world at ``tcp://VELES_COORDINATOR`` — NCCL on
the card (rank r on card ``r % cards``), gloo with ``-d cpu`` — and a
standard workflow then fuses with a data-parallel mesh over the world
(``StandardWorkflow._maybe_auto_fuse``).  ``--grad-bucket-mb`` and
``--grad-compress`` set that mesh's gradient buckets and wire format
(``root.common.train``).

Not ported: the master and slave modes (``-l`` / ``-m``; ROADMAP.md
Queue 1 item 12), and the status reporter, trace, heartbeat, profiler
and alert telemetry (items 11 and 12).
"""

import os
import threading
import time

from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
from veles_tpu_torch.logger import Logger

__all__ = ["Launcher"]


def _resolve_device(device=None):
    """A port Device: ``device`` as it is when it is one, else the
    backend it names, else ``root.common.engine.backend`` /
    ``VELES_BACKEND``, else ``cuda``."""
    from veles_tpu_torch.backends import BACKENDS, Device
    from veles_tpu_torch.config import root
    if device is not None and not isinstance(device, str):
        return device
    backend = device or root.common.engine.get("backend") or \
        os.environ.get("VELES_BACKEND") or "cuda"
    if backend not in BACKENDS:
        raise ValueError(
            "backend %r is not one of the port's: use cuda (the card) or "
            "cpu (asked for explicitly; nothing falls back to it)"
            % (backend,))
    return Device(backend)


class Launcher(Logger, metaclass=CommandLineArgumentsRegistry):
    """Session owner: holds the workflow and the device."""

    def __init__(self, interactive=False, **kwargs):
        super(Launcher, self).__init__(**kwargs)
        self.interactive = interactive
        self._workflow = None
        self.device = None
        self.stopped = False
        self.initialized = False
        self._finished_event = threading.Event()
        self.start_time = None

    @classmethod
    def init_parser(cls, parser):
        parser.add_argument(
            "--resume", default="", metavar="auto|PATH",
            help="restore the workflow from a snapshot before "
                 "initialize: 'auto' resumes from the newest verified "
                 "_current target in the snapshot directory (fresh "
                 "start when none exists); a path resumes from that "
                 "snapshot (with previous-good fallback if corrupt)")
        parser.add_argument(
            "--grad-bucket-mb", type=float, default=None, metavar="MB",
            help="data-parallel mesh: target size of the gradient "
                 "all-reduce buckets overlapped with the backward pass "
                 "(default ~25; 'inf' = one flat bucket)")
        parser.add_argument(
            "--grad-compress", default=None, choices=["bf16"],
            help="compress the gradient all-reduce's wire traffic; "
                 "guarded by the numerics watchdog with an automatic "
                 "f32 fall-back after a skipped step")
        return parser

    @classmethod
    def apply_args(cls, args):
        from veles_tpu_torch.config import root
        train_cfg = {}
        if getattr(args, "grad_bucket_mb", None) is not None:
            train_cfg["grad_bucket_mb"] = args.grad_bucket_mb
        if getattr(args, "grad_compress", None) is not None:
            train_cfg["grad_compress"] = args.grad_compress
        if train_cfg:
            root.common.train.update(train_cfg)
        if getattr(args, "resume", ""):
            root.common.snapshot.update({"resume": args.resume})

    # -- workflow ownership (Unit.workflow protocol) -----------------------

    def add_ref(self, workflow):
        self._workflow = workflow

    def del_ref(self, workflow):
        if self._workflow is workflow:
            self._workflow = None

    @property
    def workflow(self):
        return self._workflow

    @property
    def workflow_mode(self):
        return "standalone"

    @property
    def is_standalone(self):
        return True

    # -- lifecycle ---------------------------------------------------------

    def _maybe_resume(self):
        """Honor ``--resume`` / ``root.common.snapshot.resume``: swap the
        attached workflow for the verified snapshot BEFORE initialize.
        An already-restored workflow (``-w``) is left alone."""
        from veles_tpu_torch.config import root
        spec = root.common.snapshot.get("resume") or ""
        if not spec or \
                getattr(self._workflow, "restored_from_snapshot_", False):
            return
        from veles_tpu_torch.snapshotter import SnapshotterBase
        path = SnapshotterBase.resolve_resume(spec)
        if path is None:
            self.info("--resume auto: no snapshot found; starting fresh")
            return
        self.info("resuming workflow from snapshot %s", path)
        from veles_tpu_torch.workflow import restore_workflow
        self._workflow = restore_workflow(path, self)

    @staticmethod
    def init_multihost(backend="cuda"):
        """Join the ``torch.distributed`` world the cluster scheduler
        describes (``VELES_COORDINATOR`` host:port,
        ``VELES_NUM_PROCESSES``, ``VELES_PROCESS_ID``): NCCL for the
        ``cuda`` backend, gloo for ``cpu``.  Returns False (and does
        nothing) without ``VELES_COORDINATOR``; True once this process
        is in the world."""
        coordinator = os.environ.get("VELES_COORDINATOR")
        if not coordinator:
            return False
        import torch
        import torch.distributed as dist
        if dist.is_initialized():
            return True
        rank = int(os.environ.get("VELES_PROCESS_ID", 0))
        world = int(os.environ.get("VELES_NUM_PROCESSES", 1))
        if backend == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if backend == "cuda" else "gloo",
            init_method="tcp://" + coordinator, rank=rank,
            world_size=world)
        return True

    def initialize(self, device=None, **kwargs):
        if self._workflow is None:
            raise RuntimeError("no workflow attached to the launcher")
        self._maybe_resume()
        self.device = _resolve_device(device)
        if self.init_multihost(self.device.backend) and \
                self.device.backend == "cuda":
            import torch
            index = torch.cuda.current_device()
            if self.device.device_index != index:
                from veles_tpu_torch.backends import Device
                self.device = Device("cuda", index)
        self.info("initializing workflow %s on %s (standalone mode)",
                  self._workflow.name, self.device)
        self._workflow.initialize(device=self.device, **kwargs)
        self.initialized = True

    def run(self):
        if not self.initialized:
            self.initialize()
        self.start_time = time.time()
        self._finished_event.clear()
        self.stopped = False
        try:
            self._workflow.run()
            self._finished_event.set()
        finally:
            self.stopped = True
        self.info("session finished in %.1f s",
                  time.time() - self.start_time)
        self._workflow.print_stats()
        self._workflow.write_results()

    def on_workflow_finished(self):
        self._finished_event.set()

    def stop(self):
        self.stopped = True
        if self._workflow is not None:
            self._workflow.stop()
        self._finished_event.set()
