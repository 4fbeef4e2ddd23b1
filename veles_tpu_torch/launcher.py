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

Telemetry (``veles_tpu_torch/observe``), as in the JAX launcher:
``--trace PATH`` records the span tracer through the run and saves it
to PATH (the flight recorder's dumps go beside it), ``--metrics-interval
N`` writes a heartbeat line every N seconds to ``--metrics-path`` (else
``<trace>.heartbeat.jsonl``, else ``veles_heartbeat.jsonl``),
``--alerts`` arms the stock alert rules the heartbeat evaluates, and
``--profile DIR`` (or ``VELES_PROFILE``) runs ``torch.profiler`` around
a window of fused train steps.  The flags land in
``root.common.observe``.  SIGTERM dumps the flight ring and saves the
trace before the process dies, and any exception that escapes the run
dumps the flight ring.

Not ported: the master and slave modes (``-l`` / ``-m``; ROADMAP.md
Queue 1 item 12), with the status reporter and the merged cluster
trace that need them.
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
        from veles_tpu_torch.config import root
        self.interactive = interactive
        # telemetry: the CLI's flags land in root.common.observe
        # (apply_args); kwargs override them for programmatic use
        obs = root.common.observe
        self.trace_path = kwargs.get("trace", obs.get("trace", ""))
        self.metrics_interval = float(kwargs.get(
            "metrics_interval", obs.get("metrics_interval", 0)) or 0)
        self.metrics_path = kwargs.get(
            "metrics_path", obs.get("metrics_path", ""))
        self.profile_dir = kwargs.get(
            "profile", obs.get("profile", "")) or \
            os.environ.get("VELES_PROFILE", "")
        self.alerts_enabled = bool(kwargs.get(
            "alerts", obs.get("alerts", False)))
        self._workflow = None
        self.device = None
        self.stopped = False
        self.initialized = False
        self._finished_event = threading.Event()
        self.start_time = None

    @classmethod
    def init_parser(cls, parser):
        parser.add_argument(
            "--trace", default="", metavar="PATH",
            help="write a Chrome/Perfetto trace of this run (unit runs, "
                 "fused steps, input pipeline stages, snapshot writes) "
                 "to PATH; free when unset")
        parser.add_argument(
            "--metrics-interval", type=float, default=0, metavar="N",
            help="append a JSONL telemetry heartbeat every N seconds "
                 "(step-time percentiles, throughput, health counters, "
                 "compiles, device memory, MFU); 0 disables")
        parser.add_argument(
            "--metrics-path", default="", metavar="PATH",
            help="heartbeat JSONL destination (default: <trace>."
                 "heartbeat.jsonl next to --trace, else "
                 "veles_heartbeat.jsonl)")
        parser.add_argument(
            "--alerts", action="store_true", default=False,
            help="arm the stock burn-rate and anomaly alert rules on "
                 "this process; the --metrics-interval heartbeat "
                 "evaluates them, and a firing dumps the flight ring")
        parser.add_argument(
            "--profile", default="", metavar="DIR",
            help="write a torch.profiler Chrome trace into DIR around a "
                 "window of fused train steps (also VELES_PROFILE=DIR; "
                 "the window VELES_PROFILE_WINDOW=start:stop, default "
                 "5:25)")
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
        root.common.observe.update({
            "trace": getattr(args, "trace", ""),
            "metrics_interval": getattr(args, "metrics_interval", 0),
            "metrics_path": getattr(args, "metrics_path", ""),
            "profile": getattr(args, "profile", ""),
            "alerts": getattr(args, "alerts", False),
        })
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

    # -- telemetry ---------------------------------------------------------

    def _start_telemetry(self):
        """The run's observability: the flight ring beside ``--trace``,
        the tracer, the profiler window, the stock alert rules and the
        heartbeat.  Returns the heartbeat (or None); the rest is
        process-global."""
        from veles_tpu_torch import observe
        if self.trace_path:
            observe.flight.base_path = self.trace_path + ".flight"
            observe.tracer.start()
            if observe.tracer.label is None:
                observe.tracer.label = self.workflow_mode
        if self.profile_dir:
            observe.install_profiler(
                observe.ProfilerHook(self.profile_dir))
        if self.alerts_enabled:
            from veles_tpu_torch.observe.alerts import alerts, default_rules
            if not alerts.rules:
                alerts.configure([r.spec() for r in default_rules()])
            self.info("alerting armed: %d rules (%s)", len(alerts.rules),
                      ", ".join(r.name for r in alerts.rules))
            if self.metrics_interval <= 0:
                self.warning("--alerts without --metrics-interval: the "
                             "rules are armed but nothing evaluates them "
                             "(the heartbeat is the evaluator)")
        if self.metrics_interval > 0:
            path = self.metrics_path or (
                self.trace_path + ".heartbeat.jsonl"
                if self.trace_path else "veles_heartbeat.jsonl")
            heartbeat = observe.Heartbeat(
                path, self.metrics_interval, workflow=self._workflow)
            heartbeat.start()
            self.info("telemetry heartbeat -> %s every %.3g s",
                      path, self.metrics_interval)
            return heartbeat
        return None

    def _stop_telemetry(self, heartbeat):
        from veles_tpu_torch import observe
        # the step times whose CUDA events completed since the last
        # step reach the histograms before the last heartbeat line
        trainer = getattr(self._workflow, "fused_trainer", None)
        if trainer is not None:
            trainer.poll_step_times()
        if heartbeat is not None:
            heartbeat.stop()
        if self.profile_dir:
            observe.uninstall_profiler()
        if self.trace_path:
            observe.tracer.stop()
            try:
                observe.tracer.save(self.trace_path)
                self.info("trace written to %s (%d events)",
                          self.trace_path, len(observe.tracer.events))
            except OSError as exc:
                self.error("failed to write trace %s: %s",
                           self.trace_path, exc)
            self._write_merged_trace()

    def _write_merged_trace(self):
        """A master's merge of its trace with its slaves' chunks into
        ``<trace>.merged.json`` (``observe.merge.merge_run``).  It needs
        the master's trace collector, which comes with the master-slave
        layer (ROADMAP.md Queue 1 item 12): a standalone run has none,
        and this does nothing."""
        return None

    def _install_fatal_signal_hook(self):
        """SIGTERM dumps the flight ring and saves the ``--trace``
        buffer before the process dies.  Only the main thread may set
        signal handlers: elsewhere this does nothing.  Returns an
        uninstall callable."""
        import signal

        def on_term(signum, frame):
            from veles_tpu_torch import observe
            observe.flight.dump(reason="signal-%d" % signum)
            if self.trace_path:
                observe.tracer.stop()
                try:
                    observe.tracer.save(self.trace_path)
                except OSError:
                    pass
            signal.signal(signum, previous or signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        try:
            previous = signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            return lambda: None

        def uninstall():
            try:
                signal.signal(signal.SIGTERM, previous)
            except (ValueError, TypeError):
                pass

        return uninstall

    def run(self):
        if not self.initialized:
            self.initialize()
        self.start_time = time.time()
        self._finished_event.clear()
        self.stopped = False
        heartbeat = None
        uninstall_signals = self._install_fatal_signal_hook()
        try:
            # inside the try: a failure here still reaches the finally
            # that stops the heartbeat and the tracer and saves the trace
            heartbeat = self._start_telemetry()
            self._workflow.run()
            self._finished_event.set()
        except BaseException:
            # a black-box dump of any escaping failure; the finally
            # still saves the --trace buffer
            from veles_tpu_torch import observe
            observe.flight.dump(reason="exception")
            raise
        finally:
            uninstall_signals()
            self.stopped = True
            self._stop_telemetry(heartbeat)
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
