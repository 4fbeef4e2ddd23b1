"""Launcher — owns a workflow and the run session.

Counterpart of ``veles_tpu/launcher.py``: it holds the workflow (the
``Unit.workflow`` protocol), honors ``--resume`` before initialize,
resolves the device, runs the workflow and writes its results.  Modes:

- ``standalone`` (default): initialize and run on the device;
- ``master`` (``-l`` / ``--listen-address host:port``): initialize on
  the device (the master holds the canonical state there), then serve
  jobs to slaves through a :class:`~veles_tpu_torch.server.Server` until
  the workflow completes; a master never runs the unit graph;
- ``slave`` (``-m`` / ``--master-address host:port``): initialize on
  the device, then take jobs from the master through a
  :class:`~veles_tpu_torch.client.Client`, each one pass of the per-unit
  graph.  A slave never restores a snapshot: its state comes from the
  master.

Membership changes reach :meth:`Launcher.on_fleet_change` (an event
record and a log line).  A master with ``--trace`` also writes
``<trace>.merged.json``: its own trace and the chunks its slaves shipped,
on one timeline with the slaves' clock offsets corrected
(``observe.merge.merge_run``).

The device: ``initialize(device=None)`` takes ``-d`` (which the CLI
writes to ``root.common.engine.backend``), else ``VELES_BACKEND``, else
``cuda``, and builds the port's :class:`~veles_tpu_torch.backends.Device`.
``cuda`` raises where there is no card; nothing falls back to the host,
whose devices run only when asked for: ``-d cpu`` (the units' device
runs on the CPU) and ``-d numpy`` (the host pseudo-device: each unit
takes its host run over numpy buffers, and CUDA is never initialized).
The JAX package's ``auto`` and ``tpu`` are refused.

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

``--web-status URL`` (``root.common.launcher.web_status``) points a master
or standalone run at a web-status service
(``veles_tpu_torch/web_status.py``): a reporter thread posts the
session's status every ``notification_interval`` seconds
(``root.common.web.notification_interval``, default 1) and once more
after the run ends, and forwards the ``Logger.event`` records the run
emits (an event hook enqueues them; the thread posts them, a record
leaving the queue only once its post succeeded).  A slave stays silent.
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
            "backend %r is not one of the port's: use cuda (the card), or "
            "cpu or numpy (the host, asked for explicitly; nothing falls "
            "back to it)" % (backend,))
    return Device(backend)


class Launcher(Logger, metaclass=CommandLineArgumentsRegistry):
    """Session owner: holds the workflow and the device."""

    def __init__(self, interactive=False, **kwargs):
        super(Launcher, self).__init__(**kwargs)
        from veles_tpu_torch.config import root
        cfg = root.common.launcher
        self.master_address = kwargs.get(
            "master_address", cfg.get("master_address", ""))
        self.listen_address = kwargs.get(
            "listen_address", cfg.get("listen_address", ""))
        self.interactive = interactive
        self.web_status_url = kwargs.get(
            "web_status", cfg.get("web_status", ""))
        self.notification_interval = float(kwargs.get(
            "notification_interval",
            root.common.web.get("notification_interval", 1)))
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
        self._agent = None  # the Server or Client of a master or slave
        self._finished_event = threading.Event()
        self._reporter_stop = threading.Event()
        self._reporter_thread = None
        self.start_time = None

    @classmethod
    def init_parser(cls, parser):
        parser.add_argument(
            "-l", "--listen-address", default="",
            help="run as master, listening on host:port")
        parser.add_argument(
            "-m", "--master-address", default="",
            help="run as slave of the given master host:port")
        parser.add_argument(
            "--web-status", default="",
            help="URL of a web-status service to post periodic session "
                 "status to")
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
        root.common.launcher.update({
            "listen_address": getattr(args, "listen_address", ""),
            "master_address": getattr(args, "master_address", ""),
            "web_status": getattr(args, "web_status", ""),
        })
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
        if self.master_address:
            return "slave"
        if self.listen_address:
            return "master"
        return "standalone"

    @property
    def is_master(self):
        return self.workflow_mode == "master"

    @property
    def is_slave(self):
        return self.workflow_mode == "slave"

    @property
    def is_standalone(self):
        return self.workflow_mode == "standalone"

    # -- lifecycle ---------------------------------------------------------

    def _maybe_resume(self):
        """Honor ``--resume`` / ``root.common.snapshot.resume``: swap the
        attached workflow for the verified snapshot BEFORE initialize, so
        slaves reconnecting to a restarted master are admitted at the
        restored epoch.  Slaves never restore (their state comes from
        the master); an already-restored workflow (``-w``) is left
        alone."""
        from veles_tpu_torch.config import root
        spec = root.common.snapshot.get("resume") or ""
        if not spec or self.is_slave or \
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
        self.info("initializing workflow %s on %s (%s mode)",
                  self._workflow.name, self.device, self.workflow_mode)
        # a master initializes too: it holds the canonical state, but
        # never runs the unit graph
        self._workflow.initialize(device=self.device, **kwargs)
        if self.is_master:
            from veles_tpu_torch.server import Server
            self._agent = Server(self.listen_address, self._workflow,
                                 launcher=self)
        elif self.is_slave:
            from veles_tpu_torch.client import Client
            self._agent = Client(self.master_address, self._workflow,
                                 launcher=self)
        self.initialized = True

    def on_fleet_change(self, info):
        """The Server's reshard hook: every membership change becomes an
        event record and a log line, beside the health events it may
        explain (a loss spike right after half the fleet left is not
        divergence)."""
        self.event("fleet.reshard", "instant", **{
            k: v for k, v in info.items() if v is not None})
        self.info("fleet change: %s -> membership epoch %s, %s live, "
                  "unserved remainder %s", info.get("reason"),
                  info.get("epoch"), info.get("live"),
                  info.get("remaining"))

    # -- the web-status reporter -------------------------------------------

    def _start_status_reporter(self):
        """Periodic status posts to the web-status service while the
        session runs; a slave stays silent."""
        if not self.web_status_url or self.is_slave:
            return
        import collections
        import json
        import uuid

        from veles_tpu_torch.logger import add_event_hook, remove_event_hook
        from veles_tpu_torch.web_status import StatusReporter
        reporter = StatusReporter(
            self.web_status_url,
            "%s-%s" % (self._workflow.name, uuid.uuid4().hex[:8]),
            self._workflow)
        self._reporter_stop.clear()
        # the hook only enqueues: the posts happen on the reporter's
        # thread, never on the thread that emits the event
        pending_events = collections.deque(maxlen=200)
        dropped = [0]

        def hook(record):
            if len(pending_events) == pending_events.maxlen:
                dropped[0] += 1  # logged from the reporter's thread
            pending_events.append(record)

        add_event_hook(hook)

        def drain_events(limit=50):
            # peek, post, then pop: a failed post leaves the record for
            # the next cycle; the limit bounds one drain
            sent = 0
            while pending_events and sent < limit:
                reporter.post_event(json.dumps(pending_events[0],
                                               default=repr))
                pending_events.popleft()
                sent += 1
            if dropped[0]:
                self.debug("%d events dropped (queue full)", dropped[0])
                dropped[0] = 0

        def loop():
            try:
                while not self._reporter_stop.wait(
                        self.notification_interval):
                    try:
                        reporter.post()
                        drain_events()
                    except Exception as exc:
                        self.debug("status post failed: %s", exc)
                try:
                    reporter.post()  # the final state, after the run
                    drain_events()
                except Exception as exc:
                    self.debug("final status post failed: %s", exc)
            finally:
                remove_event_hook(hook)

        self._reporter_thread = threading.Thread(
            target=loop, daemon=True, name="status-reporter")
        self._reporter_thread.start()

    def _stop_status_reporter(self):
        if self._reporter_thread is not None:
            self._reporter_stop.set()
            self._reporter_thread.join(timeout=5)
            self._reporter_thread = None

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
        """A master's merge of its trace with the chunks its slaves
        shipped into ``<trace>.merged.json``: one timeline, a track a
        process, the slaves' timestamps corrected by their clock
        offsets.  Nothing without a master's collector or chunks."""
        collector = getattr(self._agent, "trace_collector", None)
        if collector is None or not collector.keys():
            return
        try:
            import json

            from veles_tpu_torch.observe import merge, tracer
            with open(self.trace_path) as fin:
                master_doc = json.load(fin)
            merged = merge.merge_run(
                master_doc, collector,
                trace_id=getattr(self._agent, "trace_id", None),
                master_label=tracer.label or "master")
            merged_path = self.trace_path + ".merged.json"
            tmp = merged_path + ".tmp"
            with open(tmp, "w") as fout:
                json.dump(merged, fout)
            os.replace(tmp, merged_path)
            self.info("merged cluster trace written to %s "
                      "(%d slave track(s))", merged_path,
                      len(collector.keys()))
        except Exception as exc:
            self.error("failed to write merged trace: %s", exc)

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
        # the first ^C asks for this graceful stop, the second forces
        # the exit (thread_pool.ThreadPool's escalation)
        from veles_tpu_torch.thread_pool import ThreadPool
        ThreadPool.install_sigint()
        ThreadPool.sigint_hook = self.stop
        heartbeat = None
        uninstall_signals = self._install_fatal_signal_hook()
        try:
            # inside the try: a failure here still reaches the finally
            # that stops the heartbeat and the tracer and saves the trace
            heartbeat = self._start_telemetry()
            self._start_status_reporter()
            if self._agent is not None:
                self._agent.run()  # blocks until the session ends
            else:
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
            ThreadPool.sigint_hook = None
            self.stopped = True
            self._stop_status_reporter()
            self._stop_telemetry(heartbeat)
        self.info("session finished in %.1f s",
                  time.time() - self.start_time)
        self._workflow.print_stats()
        self._workflow.write_results()

    def on_workflow_finished(self):
        if self.is_slave:
            return  # a job's pass ended; the master ends the session
        self._finished_event.set()
        if self._agent is not None:
            self._agent.on_workflow_finished()

    def stop(self):
        self.stopped = True
        if self._workflow is not None:
            self._workflow.stop()
        if self._agent is not None:
            self._agent.stop()
        self._finished_event.set()

    def pause(self):
        if self._agent is not None:
            self._agent.pause()

    def resume(self):
        if self._agent is not None:
            self._agent.resume()
