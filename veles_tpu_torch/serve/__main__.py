"""``python -m veles_tpu_torch.serve``: stand up the inference service.

Counterpart of ``veles_tpu/serve/__main__.py``.  Serves a trained
workflow snapshot (the manifest-verified pickles of
``snapshotter.py``, written by the port or by the JAX package) behind
one engine + continuous batcher replica per visible CUDA card
(``--replicas`` overrides; on one card two replicas share it), on the
card unless ``-d cpu`` asks for the CPU:

    python -m veles_tpu_torch.serve --snapshot mnist_current.pickle \\
        --port 8080 --transport-port 8081 \\
        --ladder 1,8,32,128 --max-delay-ms 2 \\
        --slo-p50-ms 20 --slo-p99-ms 100

``--transport-port`` opens the binary frame listener beside the JSON
front.  ``SIGHUP`` or ``POST /reload {"snapshot": path}`` hot-swaps the
served weights without dropping the queue (same digest: no new
capture).  ``--watch-dir`` runs the freshness loop over a publish
directory: new snapshots are manifest-verified, canaried on one replica
under mirrored traffic, and promoted or rolled back; ``POST /publish``
wakes it.  ``--demo`` trains a tiny blobs MLP in process instead.

The compile receipt printed at start counts the kernel library builds
this process ran (0 when ``veles_tpu_torch/build/`` already holds the
library) and the CUDA graphs it captured: a graph does not outlive its
process, so there is no warm compile cache to restart from.

The fleet roles:

    python -m veles_tpu_torch.serve --snapshot model.pickle --quantize \
        --fleet-host --host-id h0 --transport-port 0
    python -m veles_tpu_torch.serve --fleet HOST:PORT,HOST:PORT --port 8080

``--fleet-host`` captures its ladder, then opens only the binary
listener and prints ``FLEET_HOST_READY port=... host_id=... digest=...
new_compiles=... kernel_builds=... captures=...``; at a clean stop
(``--duration`` or SIGTERM) it prints ``FLEET_HOST_STOPPED host_id=...
launches={...}``, the kernel launches it served.  ``--fleet`` is the
front: no local model, a ``FleetRouter`` over the hosts (least-loaded
routing, hedged tails unless ``--no-hedge``, exactly-once completion
under host loss) behind the same HTTP front.
"""

import argparse
import signal
import sys
import threading
import time


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.serve",
        description="graph-captured, continuously batched inference "
                    "service")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--snapshot", help="trained workflow snapshot "
                        "(snapshotter export) to serve")
    source.add_argument("--demo", action="store_true",
                        help="train a tiny demo MLP and serve it")
    source.add_argument("--fleet", metavar="HOST:PORT,HOST:PORT,...",
                        help="run the FRONT of a multi-host serve fleet "
                        "over these serve hosts: no local model; "
                        "requests are routed least-loaded with hedged "
                        "tails and exactly-once completion under host "
                        "loss")
    parser.add_argument("--fleet-host", action="store_true",
                        help="run as a serve HOST of a fleet: the "
                        "binary listener only (--transport-port), "
                        "announced with --host-id; a --fleet front "
                        "dials it")
    parser.add_argument("--host-id", default=None,
                        help="fleet host identity (--fleet-host; "
                        "default: machine id + pid)")
    parser.add_argument("--no-hedge", action="store_true",
                        help="--fleet: disable request hedging (the "
                        "straggler A/B's control leg)")
    parser.add_argument("--hedge-budget", action="store_true",
                        help="--fleet: cap hedges per SLO class with "
                        "per-class token budgets (an exhausted budget "
                        "routes normally, never fails)")
    parser.add_argument("--max-inflight", type=int, default=None,
                        help="--fleet: bound on unresolved front "
                        "requests; past it the class-ordered shedder "
                        "evicts best_effort, then batch")
    parser.add_argument("--hedge-factor", type=float, default=2.0,
                        help="--fleet: hedge past factor x the mean "
                        "completed latency (throughput-corrected)")
    parser.add_argument("--hedge-floor-ms", type=float, default=50.0,
                        help="--fleet: minimum straggler age before a "
                        "hedge fires")
    parser.add_argument("-d", "--device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="where the replicas run: cuda (default) "
                        "| cpu")
    parser.add_argument("--tenant-quota", default=None,
                        metavar="TENANT=RATE[:BURST],...",
                        help="per-tenant token-bucket admission quotas "
                        "(requests/s with optional burst; '*' sets the "
                        "default for unlisted tenants, which are "
                        "otherwise unlimited)")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--path", default="/infer")
    parser.add_argument("--replicas", type=int, default=None,
                        help="engine replicas (default: one per "
                        "visible card)")
    parser.add_argument("--transport-port", type=int, default=None,
                        help="also listen for the binary frame "
                        "transport on this port (0 = ephemeral)")
    parser.add_argument("--ladder", default="1,8,32,128",
                        help="comma-separated batch-shape ladder")
    parser.add_argument("--max-delay-ms", type=float, default=2.0,
                        help="max continuous-batching queue delay")
    parser.add_argument("--max-queue", type=int, default=256,
                        help="pending-request bound before 503 shedding")
    parser.add_argument("--slo-p50-ms", type=float, default=None)
    parser.add_argument("--slo-p99-ms", type=float, default=None)
    parser.add_argument("--watch-dir", default=None, metavar="DIR",
                        help="run the freshness loop over this publish "
                        "directory (the trainer's --publish-dir)")
    parser.add_argument("--mirror-fraction", type=float, default=0.25,
                        help="traffic slice mirrored to the canary "
                        "replica (shadow-scored, never returned)")
    parser.add_argument("--min-mirrors", type=int, default=8,
                        help="clean mirrored pairs required before a "
                        "canary is promoted")
    parser.add_argument("--freshness-poll-s", type=float, default=0.5,
                        help="publish-directory poll interval")
    parser.add_argument("--no-canary", action="store_true",
                        help="reload verified candidates directly "
                        "instead of canarying them")
    parser.add_argument("--quantize", action="store_true",
                        help="post-training-quantize the model to int8 "
                        "before serving (the matmul_int8 kernel)")
    parser.add_argument("--calibrate", default=None, metavar="FILE.npy",
                        help="calibration samples for --quantize (.npy "
                        "of shape (N,) + sample_shape); default: the "
                        "loader's first samples, else random ones")
    parser.add_argument("--calibration-percentile", type=float,
                        default=99.9,
                        help="abs-activation percentile the int8 grid "
                        "covers (100 = min/max calibration)")
    parser.add_argument("--duration", type=float, default=None,
                        help="serve for N seconds then exit (default: "
                        "until interrupted)")
    return parser


def _quantize_spec(sw, args, device):
    """--quantize: the f32 spec of the workflow, calibrated and
    quantized -> (plans, params, sample_shape)."""
    import numpy

    from veles_tpu_torch.quant import quantize_model_spec
    from veles_tpu_torch.serve.router import ReplicaPool

    plans, params, sample_shape = ReplicaPool._workflow_spec(sw)
    if args.calibrate:
        samples = numpy.load(args.calibrate)
    else:
        loader = getattr(sw, "loader", None)
        data = getattr(loader, "original_data", None)
        if data is not None and data:
            samples = numpy.asarray(data.mem[:1024], numpy.float32)
        else:
            print("WARNING: no calibration stream (--calibrate) and no "
                  "loader data; calibrating on random samples")
            rng = numpy.random.RandomState(11)
            samples = rng.randn(256, *sample_shape).astype(numpy.float32)
    mode = ("minmax" if args.calibration_percentile >= 100.0
            else "percentile")
    qparams, calib = quantize_model_spec(
        plans, params, samples, mode=mode,
        percentile=args.calibration_percentile, device=device)
    print("quantized %d/%d layers (clip fraction %.5f)"
          % (len(calib.layers), len(plans), calib.clip_fraction))
    return plans, qparams, sample_shape


def _demo_workflow(device):
    import numpy

    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from veles_tpu_torch.prng import RandomGenerator

    class BlobsLoader(FullBatchLoader):
        """Deterministic 4-class Gaussian blobs."""

        def load_data(self):
            rng = numpy.random.RandomState(99)
            centers = rng.randn(4, 16) * 2.0
            data = numpy.zeros((320, 16), numpy.float32)
            labels = numpy.arange(320) % 4
            for i, label in enumerate(labels):
                data[i] = centers[label] + rng.randn(16) * 0.3
            self.original_data = data
            self.original_labels = labels.astype(numpy.int32)
            self.class_lengths[0] = 0
            self.class_lengths[1] = 64
            self.class_lengths[2] = 256

    sw = StandardWorkflow(
        DummyWorkflow().workflow,
        layers=[
            {"type": "all2all_tanh", "output_sample_shape": 16,
             "learning_rate": 0.05, "gradient_moment": 0.9},
            {"type": "softmax", "output_sample_shape": 4,
             "learning_rate": 0.05, "gradient_moment": 0.9},
        ],
        loader_factory=lambda w: BlobsLoader(
            w, minibatch_size=64,
            prng=RandomGenerator("serve-demo", seed=1)),
        decision_config=dict(max_epochs=3),
    )
    sw.initialize(device=device)
    sw.run()
    sw.stop()
    return sw


def _serve_for(duration):
    try:
        if duration is not None:
            time.sleep(duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass


def _fleet_front_main(args):
    """--fleet: the front tier: no local model, route over the hosts."""
    from veles_tpu_torch.serve import ServeService
    from veles_tpu_torch.serve.fleet import FleetRouter
    from veles_tpu_torch.serve.qos import HedgeBudget, TenantQuota
    router = FleetRouter(hedge=not args.no_hedge,
                         hedge_factor=args.hedge_factor,
                         hedge_floor_s=args.hedge_floor_ms / 1e3,
                         hedge_budget=HedgeBudget()
                         if args.hedge_budget else None,
                         max_inflight=args.max_inflight)
    try:
        for address in args.fleet.split(","):
            router.add_host(address=address.strip())
    except Exception:
        router.stop()
        raise
    quota = TenantQuota.from_spec(args.tenant_quota) \
        if args.tenant_quota else None
    service = ServeService(router, port=args.port, path=args.path,
                           transport_port=args.transport_port,
                           quota=quota)
    service.start_background()
    snap = router.snapshot()
    print("fleet front on http://127.0.0.1:%d%s over %d host(s) "
          "(digest %s, hedging %s)"
          % (service.port, args.path, snap["hosts_live"],
             snap["digest"], "on" if router.hedge else "off"),
          flush=True)
    try:
        _serve_for(args.duration)
    finally:
        service.stop()
    return 0


def _launch_counts():
    """The kernel wrappers' launches in this process (replays included:
    a graph replay adds its captured launches), by wrapper name."""
    from veles_tpu_torch import graphs
    return {getattr(w, "__name__", repr(w)): w.launches
            for w in graphs.counters() if w.launches}


def _fleet_host_main(args, pool, receipt, freshness=None):
    """--fleet-host: the binary listener a --fleet front dials.  The
    ladder is captured before the listener opens, so the hello that
    puts the host in rotation carries a finished receipt.  A host is a
    full serve process: ``--watch-dir`` runs the freshness loop here
    too."""
    import json
    import os

    from veles_tpu_torch.network_common import machine_id
    from veles_tpu_torch.serve.transport import BinaryTransportServer
    host_id = args.host_id or "%s-%d" % (machine_id(), os.getpid())
    pool.start()
    quota = None
    if args.tenant_quota:
        from veles_tpu_torch.serve.qos import TenantQuota
        quota = TenantQuota.from_spec(args.tenant_quota)
    transport = BinaryTransportServer(
        pool, port=args.transport_port or 0,
        host_meta={"host_id": host_id}, quota=quota)
    transport.start_background()

    def _stop(signum, frame):
        raise KeyboardInterrupt  # a clean stop: the finally reports
    signal.signal(signal.SIGTERM, _stop)
    # the READY line is the handshake a driver parses before it dials
    print("FLEET_HOST_READY port=%d host_id=%s digest=%s new_compiles=%d "
          "kernel_builds=%d captures=%d"
          % (transport.port, host_id, pool.digest,
             receipt["new_compiles"], receipt["kernel_builds"],
             receipt["captures"]), flush=True)
    try:
        _serve_for(args.duration)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        if freshness is not None:
            freshness.stop()
        transport.stop()
        pool.stop()
        print("FLEET_HOST_STOPPED host_id=%s launches=%s"
              % (host_id, json.dumps(_launch_counts(), sort_keys=True)),
              flush=True)
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.fleet:
        if args.fleet_host:
            parser.error("--fleet (front) and --fleet-host (host) are "
                         "different roles; pick one")
        return _fleet_front_main(args)
    if not (args.snapshot or args.demo):
        parser.error("one of --snapshot / --demo / --fleet is required")
    if args.fleet_host and args.transport_port is None:
        args.transport_port = 0
    from veles_tpu_torch.backends import Device
    device = Device(backend=args.device)  # raises without a card
    if args.demo:
        sw = _demo_workflow(device)
    else:
        from veles_tpu_torch.workflow import restore_workflow
        sw = restore_workflow(args.snapshot)

    from veles_tpu_torch.serve import ReplicaPool, ServeService
    ladder = tuple(int(b) for b in args.ladder.split(","))
    pool_kwargs = dict(
        replicas=args.replicas, ladder=ladder, backend=args.device,
        max_delay_s=args.max_delay_ms / 1e3, max_queue=args.max_queue,
        slo_p50_ms=args.slo_p50_ms, slo_p99_ms=args.slo_p99_ms)
    if args.quantize:
        plans, qparams, sample_shape = _quantize_spec(sw, args, device)
        pool = ReplicaPool(plans, qparams, sample_shape, **pool_kwargs)
    else:
        pool = ReplicaPool.from_workflow(sw, **pool_kwargs)
    receipt = pool.compile()
    freshness = None
    if args.watch_dir:
        from veles_tpu_torch.serve import FreshnessController
        freshness = FreshnessController(
            pool, args.watch_dir, poll_s=args.freshness_poll_s,
            mirror_fraction=args.mirror_fraction,
            min_mirrors=args.min_mirrors,
            canary=not args.no_canary).start()
    if args.fleet_host:
        return _fleet_host_main(args, pool, receipt, freshness)
    loader = getattr(sw, "loader", None)
    quota = None
    if args.tenant_quota:
        from veles_tpu_torch.serve.qos import TenantQuota
        quota = TenantQuota.from_spec(args.tenant_quota)
    service = ServeService(
        pool, port=args.port, path=args.path,
        labels_mapping=getattr(loader, "reversed_labels_mapping", None),
        transport_port=args.transport_port, freshness=freshness,
        quota=quota)
    service.start_background()
    print("serving on http://127.0.0.1:%d%s with %d replica(s)%s  "
          "(compile receipt: %s)"
          % (service.port, args.path, len(pool.replicas),
             "; binary transport :%d" % service.transport_port
             if service.transport_port is not None else "",
             {k: v for k, v in receipt.items() if k != "per_replica"}),
          flush=True)
    if args.snapshot:
        # SIGHUP reloads the snapshot path in place, on a thread so the
        # handler returns at once
        def _reload(signum, frame):
            def run():
                try:
                    print("SIGHUP: reloading %s -> %s" % (
                        args.snapshot,
                        service.reload_snapshot(args.snapshot)),
                        flush=True)
                except Exception as exc:
                    print("SIGHUP reload failed: %s" % exc, flush=True)
            threading.Thread(target=run, name="serve-reload").start()
        signal.signal(signal.SIGHUP, _reload)
    try:
        _serve_for(args.duration)
    finally:
        if freshness is not None:
            freshness.stop()
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
