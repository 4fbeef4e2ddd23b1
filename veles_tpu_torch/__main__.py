"""CLI entry point: ``python -m veles_tpu_torch <workflow.py> <config.py|->
[key=value ...]``.

Counterpart of ``veles_tpu/__main__.py``: site configs, seeding, the
config file (run with ``root`` in its globals) and ``key=value``
overrides, the workflow module's ``run(load, main)`` protocol, snapshot
restore (``-w``, ``--resume``), and the run through the
:class:`~veles_tpu_torch.launcher.Launcher`: standalone, a master (``-l
host:port``) or a slave (``-m host:port``), on the card unless ``-d
cpu`` asks for the CPU or ``-d numpy`` for the host pseudo-device (each
unit's host run over numpy buffers; CUDA is never initialized).
Nothing takes a host device without being asked.

The meta modes, with the JAX package's hooks in the workflow module,
printed lines and ``--result-file`` JSON: ``--optimize GENS:POP``
(``tunable_spec()`` and ``fitness(spec)``: the GA,
:mod:`veles_tpu_torch.genetics`), ``--ensemble-train N[:RATIO]``
(``member_factory(index, seed[, ratio])``) and ``--ensemble-test
RESULTS_JSON`` (``ensemble_test_data()``: :mod:`veles_tpu_torch.ensemble`),
each farmed over the job farm with ``--farm-slaves`` / ``--farm-address``
(:mod:`veles_tpu_torch.jobfarm`).  They run on the card unless ``-d cpu``
asks for the CPU, and resolve the device before any socket opens.

``--frontend [PORT]`` serves the web command composer
(:mod:`veles_tpu_torch.frontend`) instead of running; ``-b`` detaches
the run as a daemon (a double fork, ``setsid``, stdio onto
``--log-file`` or ``/dev/null``) before anything touches CUDA, the
plugins or the workflow, so the daemon is the process that takes the
card.  Plugin packages (``veles_tpu_torch.load_plugins``) are imported
before the workflow module.
"""

import ast
import importlib
import json
import os
import runpy
import sys
import time

from veles_tpu_torch import chaos, prng
from veles_tpu_torch.config import load_site_configs, root
from veles_tpu_torch.logger import (set_event_file, set_file_logging,
                                    setup_logging)

__all__ = ["Main", "main"]


class Main(object):
    """Drives one training session."""

    EXIT_SUCCESS = 0
    EXIT_FAILURE = 1

    def init_parser(self):
        from veles_tpu_torch.cmdline import build_parser
        parser = build_parser()
        parser.add_argument("workflow", nargs="?",
                            help="workflow python file or module")
        parser.add_argument("config", nargs="?", default=None,
                            help="config python file ('-' for none)")
        parser.add_argument("overrides", nargs="*", default=[],
                            help="config overrides: root.path.key=value")
        parser.add_argument("-r", "--random-seed", default=None,
                            help="seed (int, hex with 0x, or file path)")
        parser.add_argument("-d", "--device", default=None,
                            help="backend: cuda (default, the card) | "
                                 "cpu | numpy (the host, only when asked "
                                 "for; numpy runs each unit on its host "
                                 "buffers)")
        parser.add_argument("-w", "--snapshot", default=None,
                            help="restore from snapshot file")
        parser.add_argument("-f", "--log-file", default=None)
        parser.add_argument("--event-file", default=None,
                            help="JSON-lines event record sink")
        parser.add_argument("-v", "--verbose", action="store_true")
        parser.add_argument("--result-file", default=None)
        parser.add_argument("--dry-run", choices=("load", "init"),
                            default=None)
        parser.add_argument(
            "--sync-run", action="store_true",
            help="wait for the device after every unit's run for honest "
                 "per-unit timings")
        parser.add_argument(
            "--no-fuse", action="store_true",
            help="keep the per-unit graph on the card instead of fusing "
                 "the train step (the debug path)")
        parser.add_argument("--dump-graph", default=None,
                            help="write the graphviz dot file and exit")
        parser.add_argument(
            "--dump-unit-attributes", default=None, nargs="?",
            const="no-arrays", choices=("all", "no-arrays"),
            metavar="all|no-arrays",
            help="after initialize, print every unit's attributes and "
                 "exit; 'all' includes large array contents")
        parser.add_argument(
            "--optimize", default=None, metavar="GENS:POP",
            help="genetic hyper-parameter optimization: the workflow "
                 "module must expose tunable_spec() and fitness(spec)")
        parser.add_argument(
            "--ensemble-train", default=None, metavar="N[:RATIO]",
            help="train an N-model ensemble; the module must expose "
                 "member_factory(index, seed[, train_ratio]): the "
                 "optional third parameter receives RATIO (the "
                 "per-member train-set fraction, default 1.0)")
        parser.add_argument(
            "--ensemble-test", default=None, metavar="RESULTS_JSON",
            help="test a trained ensemble from its results file")
        parser.add_argument(
            "--ensemble-dir", default="ensemble",
            help="ensemble output directory")
        parser.add_argument(
            "--farm-slaves", type=int, default=0, metavar="N",
            help="farm --optimize/--ensemble-train/--ensemble-test "
                 "jobs over the control plane with N local workers; "
                 "the bound address is logged so remote workers can "
                 "join")
        parser.add_argument(
            "--farm-address", default="127.0.0.1:0", metavar="HOST:PORT",
            help="bind address for the job-farm master (use "
                 "0.0.0.0:PORT to accept off-host workers)")
        parser.add_argument(
            "--frontend", nargs="?", const="8080", default=None,
            metavar="PORT",
            help="serve the web command composer instead of running")
        parser.add_argument(
            "-b", "--background", action="store_true",
            help="daemonize: detach and keep running after the terminal "
                 "closes (log goes to --log-file)")
        return parser

    @staticmethod
    def _dump_unit_attributes(workflow, arrays=False):
        """Aligned dump of every unit's public attributes."""
        rows = []
        for i, unit in enumerate(workflow.units_in_dependency_order):
            for key in sorted(vars(unit)):
                if key.startswith("_"):
                    continue
                value = vars(unit)[key]
                if (not arrays and hasattr(value, "__len__")
                        and not isinstance(value, (str, bytes))
                        and getattr(value, "ndim", 1) != 0
                        and len(value) > 32):
                    text = "<%s of length %d>" % (
                        type(value).__name__, len(value))
                else:
                    text = repr(value)
                if len(text) > 100:
                    text = text[:97] + "..."
                rows.append((str(i), type(unit).__name__, key, text))
        widths = [max(len(r[c]) for r in rows) for c in range(3)]
        for row in rows:
            print("%*s  %-*s  %-*s  %s" % (
                widths[0], row[0], widths[1], row[1],
                widths[2], row[2], row[3]))

    def _run_frontend(self, parser, port):
        from veles_tpu_torch.frontend import FrontendServer
        server = FrontendServer(parser, port=int(port))
        server.start_background()
        print("composer on http://127.0.0.1:%d/ (Ctrl-C to stop)"
              % server.port, flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
        return self.EXIT_SUCCESS

    @staticmethod
    def _daemonize(log_file):
        """The classic double fork; stdio re-pointed at the log file."""
        if os.fork() > 0:
            os._exit(0)
        os.setsid()
        if os.fork() > 0:
            os._exit(0)
        sys.stdout.flush()
        sys.stderr.flush()
        target = log_file or os.devnull
        fd = os.open(target, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        null = os.open(os.devnull, os.O_RDONLY)
        os.dup2(null, 0)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(null)
        if fd > 2:
            os.close(fd)

    @staticmethod
    def _seed(spec):
        if spec is None:
            return
        if os.path.exists(spec):
            with open(spec, "rb") as fin:
                seed = fin.read(8)
        else:
            seed = int(spec, 0)
        prng.get().seed(seed)
        prng.get("second").seed(seed if isinstance(seed, int)
                                else seed[::-1])

    @staticmethod
    def _apply_config(path, overrides):
        if path and path != "-":
            runpy.run_path(path, init_globals={"root": root})
        for override in overrides:
            if "=" not in override:
                raise ValueError("override must be key=value: %r" % override)
            key, value = override.split("=", 1)
            node = root
            parts = key.split(".")
            if parts[0] == "root":
                parts = parts[1:]
            for part in parts[:-1]:
                node = getattr(node, part)
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
            setattr(node, parts[-1], value)

    @staticmethod
    def _load_workflow_module(spec):
        if os.path.exists(spec):
            sys.path.insert(0, os.path.dirname(os.path.abspath(spec)))
            spec = os.path.splitext(os.path.basename(spec))[0]
        return importlib.import_module(spec)

    def run_workflow(self, workflow_class, config=None, snapshot=None,
                     device=None, **kwargs):
        """Programmatic run (the ``veles_tpu_torch.run(...)`` path)."""
        from veles_tpu_torch.launcher import Launcher
        if config:
            root.update(config)
        launcher = Launcher()
        if snapshot:
            from veles_tpu_torch.workflow import restore_workflow
            workflow = restore_workflow(snapshot, launcher)
        else:
            # --resume is honored inside launcher.initialize
            workflow = workflow_class(launcher, **kwargs)
        launcher.initialize(device=device)
        launcher.run()
        return launcher.workflow or workflow

    def run(self, argv=None):
        load_site_configs()
        parser = self.init_parser()
        args, extra = parser.parse_known_args(argv)
        overrides = list(args.overrides) + [
            e for e in extra if "=" in e and not e.startswith("-")]
        setup_logging(level=10 if args.verbose else 20)
        if args.log_file:
            set_file_logging(args.log_file)
        if args.event_file:
            set_event_file(args.event_file)
        # VELES_CHAOS: this session's fault plan (read afresh, so an
        # in-process session sees the variable as it is now)
        chaos.install_from_env()
        self._seed(args.random_seed)
        if args.device:
            root.common.engine.backend = args.device
        if args.result_file:
            root.common.result_file = args.result_file
        from veles_tpu_torch.cmdline import apply_parsed_args
        apply_parsed_args(args)
        if args.sync_run:
            root.common.sync_run = True
        if args.no_fuse:
            root.common.engine.auto_fuse = False
        if args.frontend is not None:
            return self._run_frontend(parser, args.frontend)
        if args.background:
            # before anything touches CUDA: a forked child cannot use a
            # CUDA context its parent initialized
            self._daemonize(args.log_file)
        if not args.workflow:
            parser.print_help()
            return self.EXIT_FAILURE
        import veles_tpu_torch
        veles_tpu_torch.load_plugins()
        self._apply_config(args.config, overrides)
        module = self._load_workflow_module(args.workflow)
        if overrides:
            # a workflow module may install config defaults at import
            # time; command-line overrides still win
            self._apply_config(None, overrides)
        if args.dry_run == "load":
            return self.EXIT_SUCCESS
        if args.optimize:
            return self._run_optimize(module, args)
        if args.ensemble_train:
            return self._run_ensemble_train(module, args)
        if args.ensemble_test:
            return self._run_ensemble_test(module, args)
        run_fn = getattr(module, "run", None)
        if run_fn is None:
            raise SystemExit("workflow file must define run(load, main)")
        # the run(load, main) protocol: load builds or restores the
        # workflow, main initializes and runs it
        from veles_tpu_torch.launcher import Launcher
        launcher = Launcher()
        state = {}

        def load(workflow_class, **kwargs):
            if args.snapshot:
                from veles_tpu_torch.workflow import restore_workflow
                state["workflow"] = restore_workflow(args.snapshot,
                                                     launcher)
                return state["workflow"], True
            workflow_class(launcher, **kwargs)
            # --resume: the launcher's one implementation (initialize
            # calling it again is a no-op); it swaps the restored
            # workflow in for the one just built
            launcher._maybe_resume()
            state["workflow"] = launcher.workflow
            return (state["workflow"],
                    state["workflow"].restored_from_snapshot_)

        def main(**kwargs):
            if args.dump_graph:
                with open(args.dump_graph, "w") as fout:
                    fout.write(state["workflow"].generate_graph())
                return
            launcher.initialize(**kwargs)
            if args.dump_unit_attributes:
                self._dump_unit_attributes(
                    state["workflow"],
                    arrays=args.dump_unit_attributes == "all")
                return
            if args.dry_run == "init":
                return
            launcher.run()

        run_fn(load, main)
        self.workflow = state.get("workflow")
        if self.workflow is not None and args.result_file:
            self.workflow.write_results(args.result_file)
        return self.EXIT_SUCCESS

    # -- the meta modes ----------------------------------------------------

    @staticmethod
    def _meta_device(args):
        """The device of a meta mode's runs, resolved before anything
        starts: ``-d``, else ``VELES_BACKEND``, else the card, which
        raises where there is none."""
        from veles_tpu_torch.launcher import _resolve_device
        return _resolve_device(args.device)

    def _run_optimize(self, module, args):
        """--optimize GENS:POP."""
        from veles_tpu_torch.genetics import GeneticsOptimizer
        gens, _, pop = args.optimize.partition(":")
        spec_fn = getattr(module, "tunable_spec", None)
        fitness = getattr(module, "fitness", None)
        if spec_fn is None or fitness is None:
            raise SystemExit("--optimize needs tunable_spec() and "
                             "fitness(spec) in the workflow module")
        device = self._meta_device(args)
        optimizer = GeneticsOptimizer(
            spec_fn(), fitness, generations=int(gens),
            population=int(pop) if pop else 12,
            farm_slaves=args.farm_slaves,
            farm_address=args.farm_address, device=device)
        best_spec, best_fitness = optimizer.run()
        self.optimizer = optimizer
        print("best fitness %.6f with %s" % (best_fitness, best_spec))
        if args.result_file:
            with open(args.result_file, "w") as fout:
                json.dump({"fitness": best_fitness,
                           "spec": best_spec}, fout, indent=1,
                          default=repr)
        return self.EXIT_SUCCESS

    def _run_ensemble_train(self, module, args):
        """--ensemble-train N[:RATIO]."""
        from veles_tpu_torch.ensemble import EnsembleTrainer
        factory = getattr(module, "member_factory", None)
        if factory is None:
            raise SystemExit("--ensemble-train needs "
                             "member_factory(index, seed)")
        n, _, ratio = args.ensemble_train.partition(":")
        trainer = EnsembleTrainer(
            factory, size=int(n), directory=args.ensemble_dir,
            train_ratio=float(ratio) if ratio else 1.0,
            device=self._meta_device(args), farm_slaves=args.farm_slaves,
            farm_address=args.farm_address)
        path = trainer.run()
        print("ensemble results -> %s" % path)
        return self.EXIT_SUCCESS

    def _run_ensemble_test(self, module, args):
        """--ensemble-test RESULTS_JSON: evaluate the stored members on
        ``ensemble_test_data() -> (x, labels)`` of the workflow module;
        with --farm-slaves / --farm-address the member evaluations run
        as farm jobs."""
        from veles_tpu_torch.ensemble import EnsembleTester
        tester = EnsembleTester(
            args.ensemble_test, device=self._meta_device(args),
            farm_slaves=args.farm_slaves, farm_address=args.farm_address)
        print("loaded %d ensemble members" % len(tester.results))
        data_fn = getattr(module, "ensemble_test_data", None)
        if data_fn is None:
            print("(module defines no ensemble_test_data(); "
                  "nothing evaluated)")
            return self.EXIT_SUCCESS
        x, labels = data_fn()
        err = tester.error_rate(x, labels)
        print("ensemble error rate: %.2f%% over %d samples"
              % (err, len(labels)))
        if args.result_file:
            with open(args.result_file, "w") as fout:
                json.dump({"ensemble_error_pct": err,
                           "samples": len(labels),
                           "members": len(tester.results)}, fout,
                          indent=1)
        return self.EXIT_SUCCESS


def main(argv=None):
    return Main().run(argv)


if __name__ == "__main__":
    sys.exit(main())
