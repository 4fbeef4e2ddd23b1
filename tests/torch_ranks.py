"""The ranks of the port's parallel tests: functions that
``tests/torch_spawn.spawn`` runs in each process of a gloo world.

Each takes ``(rank, world, *inputs)`` with host numpy inputs, runs the
port on the CPU and returns host numpy results (lists / dicts), which
the test compares with the JAX package's on the same inputs.  The
module imports neither JAX nor the JAX package: the ranks start fast
and hold only the port.  Several checks share one spawn.
"""

import numpy
import torch


def tensors(state):
    """Host numpy state -> CPU tensors (copies)."""
    return [{k: None if v is None else torch.tensor(numpy.array(v))
             for k, v in entry.items()} for entry in state]


def host(state):
    return [{k: None if v is None else v.detach().cpu().numpy().copy()
             for k, v in entry.items()} for entry in state]


def metrics_host(m):
    return {k: v.item() for k, v in m.items()}


def mlp_plans(hyper=None, solver="momentum"):
    """The port's 16-32-4 MLP plans of tests/test_mesh.py and
    tests/test_bucketed.py: all2all_tanh then softmax."""
    from veles_tpu_torch.compiler import LayerPlan
    from veles_tpu_torch.models.all2all import All2AllSoftmax, All2AllTanh
    hyper = hyper or {"learning_rate": 0.1, "gradient_moment": 0.9}
    return [LayerPlan(All2AllTanh, solver=solver, hyper=dict(hyper)),
            LayerPlan(All2AllSoftmax, solver=solver, hyper=dict(hyper))]


def zoo_plans(specs, sample_shape):
    """The port's plans of a zoo spec list (the state comes from the
    test, drawn by the JAX package's zoo)."""
    from veles_tpu_torch.models.zoo import build_plans_and_state
    plans, _, _ = build_plans_and_state(specs, sample_shape, seed=0)
    return plans


def _run(step, state, x, y, bs, steps, **kw):
    losses, m = [], None
    for _ in range(steps):
        state, m = step(state, x, y, bs, **kw)
        losses.append(m["loss"].item())
    return state, losses, m


# -- tests/test_torch_bucketed.py ---------------------------------------------


BUCKET_CASES = {"inf": float("inf"), "one_leaf": 2048 / 2.0 ** 20,
                "straddle": 1000 / 2.0 ** 20, "tiny": 64 / 2.0 ** 20}


def freed_without_gc(build, call):
    """Whether a step that ``build()`` made and ``call(step)`` ran once
    is freed by reference counts alone when dropped, with the cyclic
    collector off: a step kept by a reference cycle would hold its
    graphs' memory on the card until a collection."""
    import gc
    import weakref
    step = build()
    call(step)
    ref = weakref.ref(step)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del step
        return ref() is None
    finally:
        if collecting:
            gc.enable()


def bucketed_world(rank, world, state, x, y, grads, rows, keyed, mse):
    """The SPMD step's checks at one world size."""
    from veles_tpu_torch import threefry
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.models.dropout import DropoutForward
    from veles_tpu_torch.parallel import (auto_mesh, bucketed,
                                          ring_all_reduce, shard_batch)
    from veles_tpu_torch.parallel.analysis import collective_counts
    from veles_tpu_torch.parallel.mesh import axis_group

    mesh = auto_mesh(device="cpu")
    group = axis_group(mesh, "data")
    xs = shard_batch(mesh, torch.from_numpy(x))
    ys = shard_batch(mesh, torch.from_numpy(y))
    out = {}
    # bucketed == flat, bit for bit, over 3 chained steps (the flat one
    # donated, the others raw)
    for name, mb in sorted(BUCKET_CASES.items()):
        step = build_train_step(mlp_plans(), mesh=mesh, grad_bucket_mb=mb,
                                donate=(name == "inf"))
        s, losses, m = _run(step, tensors(state), xs, ys, 64.0, 3)
        out["case_" + name] = (host(s), losses, int(m["n_err"]),
                               len(step.bucket_plan.buckets))
    # one and three steps of the 0.001 MB step, for JAX's SPMD step
    step = build_train_step(mlp_plans(), mesh=mesh, grad_bucket_mb=0.001,
                            donate=False)
    s1, l1, m1 = _run(step, tensors(state), xs, ys, 64.0, 1)
    s3, l3, _ = _run(step, s1, xs, ys, 64.0, 2)
    out["spmd"] = (host(s1), l1 + l3, metrics_host(m1), host(s3))
    counts = collective_counts(step, s3, xs, ys, 64.0)
    out["counts"] = (counts, len(step.bucket_plan.buckets))
    out["freed"] = {donate: freed_without_gc(
        lambda: build_train_step(mlp_plans(), mesh=mesh,
                                 grad_bucket_mb=0.001, donate=donate),
        lambda step: step(tensors(state), xs, ys, 64.0))
        for donate in (True, False)}
    if grads is None:
        return out
    # bf16 compression on the same input gradients
    mine = [{k: torch.from_numpy(v) for k, v in e.items()}
            for e in grads[rank]]
    got = bucketed.bucketed_all_reduce(mine, group, bucket_bytes=256,
                                       compress="bf16")
    out["bf16_reduce"] = host(got)
    step = build_train_step(mlp_plans(), mesh=mesh, grad_bucket_mb=0.001,
                            grad_compress="bf16", donate=False)
    sc, mc = step(tensors(state), xs, ys, 64.0)
    sp, mp = step(tensors(state), xs, ys, 64.0, None,
                  numpy.float32(numpy.nan))
    out["bf16_step"] = (host(sc), metrics_host(mc), host(sp),
                        metrics_host(mp))
    # the explicit ring: the step and the sum
    step = build_train_step(mlp_plans(), mesh=mesh, grad_bucket_mb=0.001,
                            grad_allreduce_impl="ring", donate=False)
    out["ring_step"] = host(_run(step, tensors(state), xs, ys, 64.0, 3)[0])
    out["ring_sums"] = [ring_all_reduce(torch.from_numpy(r[rank]),
                                        group).numpy() for r in rows]
    # the keyed step: each rank's dropout mask is fold_in(key, rank)'s
    kplans_spec, kstate, kx, ky, seed = keyed
    from veles_tpu_torch.compiler import LayerPlan
    from veles_tpu_torch.models.all2all import All2AllSoftmax, All2AllTanh
    kplans = [LayerPlan(All2AllTanh, hyper=dict(kplans_spec)),
              LayerPlan(DropoutForward, static={"dropout_ratio": 0.5}),
              LayerPlan(All2AllSoftmax, hyper=dict(kplans_spec))]
    masks = []
    make_mask = DropoutForward.make_mask

    def recording(key, shape, ratio, dtype, device):
        mask = make_mask(key, shape, ratio, dtype, device)
        masks.append(mask.numpy().copy())
        return mask
    DropoutForward.make_mask = staticmethod(recording)
    try:
        step = build_train_step(kplans, mesh=mesh, grad_bucket_mb=0.001,
                                donate=False)
        ks, km = step(tensors(kstate), shard_batch(mesh, torch.from_numpy(
            kx)), shard_batch(mesh, torch.from_numpy(ky)), 64.0,
            threefry.key(seed))
    finally:
        DropoutForward.make_mask = make_mask
    out["keyed"] = (masks, host(ks), metrics_host(km))
    # the mse mask keys on GLOBAL rows (11 of 16 real, the pad rows in
    # the last rank)
    mstate, mx, mt = mse
    from veles_tpu_torch.compiler import LayerPlan as Plan
    mplans = [Plan(All2AllTanh, hyper={"learning_rate": 0.1})]
    step = build_train_step(mplans, loss="mse", mesh=mesh,
                            grad_bucket_mb=0.001, donate=False)
    ms, mm = step(tensors(mstate), shard_batch(mesh, torch.from_numpy(mx)),
                  shard_batch(mesh, torch.from_numpy(mt)), 11.0)
    ref = build_train_step(mplans, loss="mse", donate=False)
    rs, rm = ref(tensors(mstate), torch.from_numpy(mx),
                 torch.from_numpy(mt), 11.0)
    out["mse"] = (host(ms), metrics_host(mm), host(rs), metrics_host(rm))
    return out


# -- tests/test_torch_mesh.py -------------------------------------------------


def zero_world2(rank, world, states, x, y, conv):
    """ZeRO-1 == the flat all-reduce, bit for bit, and bwd_remat == no
    remat, at world 2."""
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.parallel import auto_mesh, shard_batch
    from veles_tpu_torch.parallel.mesh import (gather_zero_state,
                                               unzero_state, zero_state)
    mesh = auto_mesh(device="cpu")
    xs = shard_batch(mesh, torch.from_numpy(x))
    ys = shard_batch(mesh, torch.from_numpy(y))
    out = {}
    for solver, state in sorted(states.items()):
        plans = mlp_plans(solver=solver)
        flat = build_train_step(plans, mesh=mesh,
                                grad_bucket_mb=float("inf"), donate=False)
        sf, lf, mf = _run(flat, tensors(state), xs, ys, 64.0, 3)
        for n_shards in (None, 5):
            m = n_shards or world
            zero = build_train_step(plans, mesh=mesh, zero=1,
                                    zero_shards=n_shards,
                                    donate=(n_shards is None))
            zs = tensors(zero_state(state, world, n_shards=m, rank=rank))
            zs, lz, mz = _run(zero, zs, xs, ys, 64.0, 3)
            full = unzero_state(gather_zero_state(zs, mesh), m)
            out[(solver, n_shards)] = (
                host(sf), lf, int(mf["n_err"]), full, lz, int(mz["n_err"]),
                zero.slots_per_device, zs[0]["accum_weights"].shape[0])
    # bwd_remat: the same bits, meshed and on one rank
    specs, cstate, cx, cy = conv
    plans = zoo_plans(specs, cx.shape[1:])
    cxs = shard_batch(mesh, torch.from_numpy(cx))
    cys = shard_batch(mesh, torch.from_numpy(cy))
    runs = {}
    for remat in (False, True):
        step = build_train_step(plans, mesh=mesh, grad_bucket_mb=0.001,
                                bwd_remat=remat, donate=False)
        runs[("mesh", remat)] = host(_run(step, tensors(cstate), cxs, cys,
                                          16.0, 2)[0])
        step = build_train_step(plans, bwd_remat=remat)
        runs[("one", remat)] = host(_run(step, tensors(cstate),
                                         torch.from_numpy(cx),
                                         torch.from_numpy(cy), 16.0, 2)[0])
    out["remat"] = runs
    return out


def zero_world4(rank, world, state, x, y, schedule, snapshot_dir):
    """ZeRO-1 at world 4, and the elastic MeshManager through a 4 -> 3
    -> 4 membership schedule, then resumed from its snapshot."""
    import hashlib

    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.parallel import auto_mesh, shard_batch
    from veles_tpu_torch.parallel.mesh import (MeshManager,
                                               gather_zero_state,
                                               mesh_snapshot, unzero_state,
                                               zero_state)
    mesh = auto_mesh(device="cpu")
    xs = shard_batch(mesh, torch.from_numpy(x))
    ys = shard_batch(mesh, torch.from_numpy(y))
    plans = mlp_plans()
    zero = build_train_step(plans, mesh=mesh, zero=1)
    zs = tensors(zero_state(state, world, rank=rank))
    s1, l1, _ = _run(zero, zs, xs, ys, 64.0, 1)
    full1 = unzero_state(gather_zero_state(s1, mesh), world)
    s3, l3, _ = _run(zero, s1, xs, ys, 64.0, 2)
    out = {"zero": (full1, l1 + l3,
                    unzero_state(gather_zero_state(s3, mesh), world))}

    def digest(canonical):
        h = hashlib.sha256()
        for entry in canonical:
            for key in sorted(entry):
                if entry[key] is not None:
                    h.update(key.encode())
                    h.update(numpy.ascontiguousarray(entry[key]).tobytes())
        return h.hexdigest()

    manager = MeshManager(plans, state, n_shards=16,
                          snapshot_dir=snapshot_dir)
    # 48 rows divide over 4 and 3 members
    xt, yt = torch.from_numpy(x[:48]), torch.from_numpy(y[:48])
    log, losses = [], []
    for members, steps in schedule:
        if tuple(members) != manager.ranks:
            before = digest(manager.canonical_state())
            manager.submit_membership(members)
            event = manager.maybe_reshard()
            log.append((before, digest(manager.canonical_state()),
                        event["moved_shards"], event["bytes_moved"],
                        event["to_size"], event["compile_cached"],
                        dict(manager._owners), manager.applied_steps))
        for _ in range(steps):
            m = manager.step(xt, yt, 48.0)
            losses.append(None if m is None else m["loss"].item())
    final = manager.canonical_state()
    out["manager"] = (log, losses, final, digest(final),
                      manager.shard_bytes(), mesh_snapshot())
    # the newest snapshot is the one taken before the last reshard: the
    # resumed manager holds that state, bit for bit
    resumed = MeshManager.resume(snapshot_dir, plans)
    restored = (digest(resumed.canonical_state()), resumed.applied_steps,
                resumed.mesh_epoch)
    m = resumed.step(xt, yt, 48.0)
    out["resumed"] = restored + (None if m is None else m["loss"].item(),)
    return out


# -- tests/test_torch_parallel.py ---------------------------------------------


def annotation_world4(rank, world, state, x, y, small):
    """The annotation path (DP and TP x DP) and collective_bytes."""
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.parallel import (batch_sharding, make_mesh,
                                          mlp_state_shardings, shard_batch)
    from veles_tpu_torch.parallel.analysis import collective_bytes
    from veles_tpu_torch.parallel.api import shard_state, unshard_state
    out = {}
    for name, axes, model in (("dp", {"data": 4}, None),
                              ("tp_dp", {"data": 2, "model": 2}, "model")):
        mesh = make_mesh(axes, device="cpu")
        shardings = mlp_state_shardings(mesh, state, model_axis=model)
        step = build_train_step(mlp_plans(), mesh=mesh,
                                state_shardings=shardings,
                                batch_sharding=batch_sharding(mesh),
                                donate=(name == "dp"))
        ds = shard_state(mesh, tensors(state), shardings)
        ds, m = step(ds, shard_batch(mesh, torch.from_numpy(x)),
                     shard_batch(mesh, torch.from_numpy(y)), 64.0)
        out[name] = (host(unshard_state(mesh, ds, shardings)),
                     metrics_host(m))
    # collective_bytes of the flat-bucket SPMD step on the 16-8-4 MLP
    sstate, sx, sy = small
    mesh = make_mesh({"data": 4}, device="cpu")
    step = build_train_step(mlp_plans({"learning_rate": 0.1}), mesh=mesh,
                            grad_bucket_mb=float("inf"), donate=False)
    out["bytes"] = collective_bytes(
        step, tensors(sstate), shard_batch(mesh, torch.from_numpy(sx)),
        shard_batch(mesh, torch.from_numpy(sy)), 8.0)
    return out


def fused_world2(rank, world, arrays, epochs):
    """StandardWorkflow.fuse(mesh=...) over the blobs arrays, the bf16
    -> f32 fall-back after a poisoned step, and the meshed trainer's
    snapshot."""
    import pickle

    from veles_tpu_torch import chaos, prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import extract_state
    from veles_tpu_torch.convert import state_to_numpy
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from veles_tpu_torch.observe.metrics import registry
    from veles_tpu_torch.parallel import auto_mesh

    class Loader(FullBatchLoader):
        def __init__(self, workflow, **kwargs):
            super(Loader, self).__init__(workflow, **kwargs)

        def load_data(self):
            valid_x, valid_y, train_x, train_y = arrays
            self.original_data = numpy.concatenate([valid_x, train_x])
            self.original_labels = numpy.concatenate([valid_y, train_y])
            self.class_lengths[0] = 0
            self.class_lengths[1] = len(valid_x)
            self.class_lengths[2] = len(train_x)

    hyper = {"learning_rate": 0.1, "gradient_moment": 0.9,
             "weights_decay": 5e-5}

    def build(**fuse):
        sw = StandardWorkflow(
            DummyLauncher(),
            layers=[dict(type="all2all_tanh", output_sample_shape=16,
                         **hyper),
                    dict(type="softmax", output_sample_shape=4, **hyper)],
            loader_factory=lambda w: Loader(
                w, minibatch_size=20,
                prng=prng.RandomGenerator("loader", seed=1)),
            decision_config=dict(max_epochs=epochs))
        sw.fuse(mesh=auto_mesh(device="cpu"), **fuse)
        prng.get().seed(11)
        sw.initialize(device=Device(backend="cpu"))
        return sw

    registry.reset()
    sw = build(grad_bucket_mb=0.001)
    errors = []
    dec = sw.decision
    inner = dec._on_epoch_ended

    def hook():
        errors.append(tuple(
            None if dec.epoch_metrics[c] is None else
            round(dec.epoch_metrics[c] * dec.class_lengths[c] / 100.0)
            for c in (1, 2)))
        inner()
    dec._on_epoch_ended = hook
    sw.run()
    trainer = sw.fused_trainer
    out = {"errors": errors,
           "state": state_to_numpy(extract_state(sw)),
           "update_validation": sw.update_validation,
           "receipt": trainer.comm_receipt,
           "gauges": {k: registry.peek(k).value for k in
                      ("comm.allreduce_bytes", "comm.buckets",
                       "comm.overlap_pct")}}
    # the pickled trainer carries the mesh's axes; a bare trainer
    # rebuilds the mesh from them over this world
    from veles_tpu_torch.models.fused import FusedTrainer
    from veles_tpu_torch.parallel.mesh import mesh_axes
    state = trainer.__getstate__()
    fields = pickle.loads(pickle.dumps({
        k: state[k] for k in ("_spmd_axes_", "mesh", "data_axis",
                              "grad_bucket_mb", "grad_compress")}))

    def restore(axes):
        bare = FusedTrainer.__new__(FusedTrainer)
        bare.mesh, bare._spmd_axes_ = None, axes
        bare.device = Device(backend="cpu")
        bare.warning = lambda *a, **k: None
        bare._restore_mesh()
        return mesh_axes(bare.mesh)
    try:
        restore({"data": 1, "model": 3})
        refused = False
    except ValueError as exc:
        refused = "re-fuse" in str(exc)
    out["restore"] = (fields, restore(fields["_spmd_axes_"]),
                      restore({"data": 5}), refused)
    # bf16 compression, one poisoned step: the decision's health sync
    # falls back to f32, and training goes on finite
    plan = chaos.FaultPlan.from_spec("seed=1;step.grad=nan:a3:x1")
    chaos.install(plan)
    try:
        sw = build(grad_compress="bf16", grad_bucket_mb=0.001)
        trainer = sw.fused_trainer
        compress = []
        inner2 = sw.decision._on_epoch_ended

        def hook2():
            inner2()
            compress.append(trainer.grad_compress)
        sw.decision._on_epoch_ended = hook2
        sw.run()
    finally:
        chaos.uninstall()
    state = state_to_numpy(extract_state(sw))
    out["fallback"] = (compress, int(trainer.skip_count),
                       registry.counter("comm.compress_fallbacks").value,
                       all(bool(numpy.isfinite(v).all()) for e in state
                           for v in e.values() if v is not None))
    return out


# -- tests/test_torch_parallel_transformer.py ---------------------------------


def transformer_world2(rank, world, specs, sample_shape, state, x, y,
                       prefix, part):
    """TP at model 2 (``part`` "tp") or the pipeline at 2 stages
    ("pipe"), beside the unsplit step; each rank returns the gathered
    global state."""
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.parallel import build_tp_train_step, make_mesh
    from veles_tpu_torch.parallel.tensor import (gather_tp_state,
                                                 place_tp_state)
    plans = zoo_plans(specs, sample_shape)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = {}
    ref = build_train_step(plans, donate=False)
    rs, rl, _ = _run(ref, tensors(state), xt, yt, 16.0, 3)
    out["reference"] = (host(rs), rl)
    if part == "pipe":
        return _pipeline_world2(out, plans, state, xt, yt, prefix)
    mesh = make_mesh({"model": 2}, device="cpu")
    step = build_tp_train_step(plans, mesh=mesh, donate=False)
    ts, tl, m = _run(step, place_tp_state(mesh, plans, state, "cpu"), xt,
                     yt, 16.0, 3)
    out["tp"] = (gather_tp_state(mesh, plans, ts), tl, metrics_host(m))
    ts = place_tp_state(mesh, plans, state, "cpu")
    ts, m = build_tp_train_step(plans, mesh=mesh)(
        ts, xt, yt, 16.0, None, numpy.float32(numpy.nan))
    out["tp_poison"] = (gather_tp_state(mesh, plans, ts), metrics_host(m))
    return out


def _pipeline_world2(out, plans, state, xt, yt, prefix):
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.parallel import (build_pipeline_train_step,
                                          make_mesh)
    from veles_tpu_torch.parallel.pipeline import (stack_pipeline_state,
                                                   unstack_pipeline_state)
    mesh = make_mesh({"pipe": 2}, device="cpu")
    for mb in (1, 2):
        ps, layout = stack_pipeline_state(mesh, plans, state, "cpu")
        step = build_pipeline_train_step(plans, mesh=mesh, microbatches=mb,
                                         donate=(mb == 1))
        ps, pl, m = _run(step, ps, xt, yt, 16.0, 3)
        out["pipe_%d" % mb] = (unstack_pipeline_state(mesh, ps, layout), pl,
                               metrics_host(m))
    ps, layout = stack_pipeline_state(mesh, plans, state, "cpu")
    step = build_pipeline_train_step(plans, mesh=mesh, donate=False)
    ps, m = step(ps, xt, yt, 16.0, None, numpy.float32(numpy.nan))
    out["pipe_poison"] = (unstack_pipeline_state(mesh, ps, layout),
                          metrics_host(m))
    # a prefix layer before the block run: its update is the same on
    # every rank and equals the unsplit step's
    pspecs, pshape, pstate, px, py = prefix
    pplans = zoo_plans(pspecs, pshape)
    ref = build_train_step(pplans, donate=False)
    rs, rl, _ = _run(ref, tensors(pstate), torch.from_numpy(px),
                     torch.from_numpy(py), 16.0, 3)
    ps, layout = stack_pipeline_state(mesh, pplans, pstate, "cpu")
    step = build_pipeline_train_step(pplans, mesh=mesh, donate=False)
    ps, pl, _ = _run(step, ps, torch.from_numpy(px), torch.from_numpy(py),
                     16.0, 3)
    out["prefix"] = (host(rs), rl, host(ps[:1]),
                     unstack_pipeline_state(mesh, ps, layout), pl)
    return out


def transformer_world4(rank, world, specs, sample_shape, state, x, y,
                       stages, sx):
    """TP x DP (data 2, model 2) and pipeline_forward over 4 real
    TransformerBlock stages."""
    from veles_tpu_torch.models.transformer import TransformerBlock
    from veles_tpu_torch.parallel import build_tp_train_step, make_mesh
    from veles_tpu_torch.parallel.api import shard_batch
    from veles_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                   stack_stage_params,
                                                   stage_param_sharding)
    from veles_tpu_torch.parallel.tensor import (gather_tp_state,
                                                 place_tp_state)
    plans = zoo_plans(specs, sample_shape)
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    step = build_tp_train_step(plans, mesh=mesh, data_axis="data",
                               grad_bucket_mb=0.001)
    ts, tl, m = _run(step, place_tp_state(mesh, plans, state, "cpu"),
                     shard_batch(mesh, torch.from_numpy(x)),
                     shard_batch(mesh, torch.from_numpy(y)), 16.0, 3)
    out = {"tp_dp": (gather_tp_state(mesh, plans, ts), tl,
                     metrics_host(m)),
           "freed": freed_without_gc(
               lambda: build_tp_train_step(plans, mesh=mesh,
                                           data_axis="data",
                                           grad_bucket_mb=0.001),
               lambda step: step(place_tp_state(mesh, plans, state, "cpu"),
                                 shard_batch(mesh, torch.from_numpy(x)),
                                 shard_batch(mesh, torch.from_numpy(y)),
                                 16.0))}
    mesh = make_mesh({"pipe": 4}, device="cpu")

    def stage_fn(params, a):
        return TransformerBlock.apply(params, a, heads=2, hidden=16)
    stacked = stage_param_sharding(mesh, stack_stage_params(stages))
    with torch.no_grad():
        out["forward"] = pipeline_forward(
            stage_fn, stacked, torch.from_numpy(sx), mesh,
            microbatches=2).numpy()
    return out


# -- tests/test_torch_ring.py -------------------------------------------------


def _local(t, mesh, dims):
    """This rank's block of a global array: dims maps dim -> axis."""
    from veles_tpu_torch.parallel.api import Spec, shard_leaf
    spec = [None] * t.ndim
    for dim, axis in dims.items():
        spec[dim] = axis
    return shard_leaf(mesh, t, Spec(*spec))


def ring_world4(rank, world, qkv, small, bf16, dp_qkv):
    """Ring and Ulysses attention on a 1-D seq axis of 4, gradients,
    bf16, and on a 2-D data x seq mesh."""
    from veles_tpu_torch.parallel import (make_mesh, ring_attention,
                                          ulysses_attention)
    from veles_tpu_torch.parallel.api import unshard_leaf, Spec
    mesh = make_mesh({"seq": 4}, device="cpu")
    q, k, v = (torch.from_numpy(t) for t in qkv)
    ql, kl, vl = (_local(t, mesh, {1: "seq"}) for t in (q, k, v))
    out = {}
    for causal in (False, True):
        with torch.no_grad():
            out[("ring", causal)] = ring_attention(
                ql, kl, vl, mesh, causal=causal).numpy()
            out[("ulysses", causal)] = ulysses_attention(
                ql, kl, vl, mesh, causal=causal).numpy()
    # gradients through the ring (the ppermute transpose)
    q, k, v = (torch.from_numpy(t) for t in small)
    leaves = [_local(t, mesh, {1: "seq"}).requires_grad_(True)
              for t in (q, k, v)]
    loss = (ring_attention(*leaves, mesh, causal=True) ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    out["grads"] = [unshard_leaf(mesh, g, Spec(None, "seq")).numpy()
                    for g in grads]
    leaves = [_local(t, mesh, {1: "seq"}).requires_grad_(True)
              for t in (q, k, v)]
    loss = (ulysses_attention(*leaves, mesh, causal=True) ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    out["ulysses_grads"] = [unshard_leaf(mesh, g, Spec(None, "seq")).numpy()
                            for g in grads]
    with torch.no_grad():
        qb, kb, vb = (_local(torch.from_numpy(t).to(torch.bfloat16), mesh,
                             {1: "seq"}) for t in bf16)
        out["bf16"] = ring_attention(qb, kb, vb, mesh, causal=True).to(
            torch.float32).numpy()
        mesh2 = make_mesh({"data": 2, "seq": 2}, device="cpu")
        ql, kl, vl = (_local(torch.from_numpy(t), mesh2,
                             {0: "data", 1: "seq"}) for t in dp_qkv)
        out["dp_ring"] = ring_attention(ql, kl, vl, mesh2, causal=True,
                                        data_axis="data").numpy()
        out["dp_ulysses"] = ulysses_attention(ql, kl, vl, mesh2,
                                              causal=True,
                                              data_axis="data").numpy()
    return out


def ring_world8(rank, world, qkv):
    """batch -> data, seq -> the ring, heads -> model (dp x sp x tp)."""
    from veles_tpu_torch.parallel import make_mesh, ring_attention
    mesh = make_mesh({"data": 2, "seq": 2, "model": 2}, device="cpu")
    q, k, v = (_local(torch.from_numpy(t), mesh,
                      {0: "data", 1: "seq", 2: "model"}) for t in qkv)
    with torch.no_grad():
        return ring_attention(q, k, v, mesh, causal=True, data_axis="data",
                              head_axis="model").numpy()


# -- tests/test_torch_moe.py --------------------------------------------------


def _tanh_stage(params, x):
    return torch.tanh(x.float() @ params["w"] + params["b"]).to(x.dtype)


def moe_world4(rank, world, moe_cases, stages, x, dp):
    """moe_apply at expert 4 and data 2 x expert 2; pipeline_forward at
    4 stages (microbatches 1, 2, 4), its gradients, and data 2 x pipe
    2."""
    from veles_tpu_torch.parallel import make_mesh, moe_apply
    from veles_tpu_torch.parallel.moe import shard_moe_params
    from veles_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                   stack_stage_params,
                                                   stage_param_sharding)
    out = {}
    mesh = make_mesh({"expert": 4}, device="cpu")
    with torch.no_grad():
        for top_k, (params, tokens) in sorted(moe_cases.items()):
            out[("moe", top_k)] = moe_apply(
                shard_moe_params(mesh, params), torch.from_numpy(tokens),
                mesh, top_k=top_k).numpy()
        mesh2 = make_mesh({"data": 2, "expert": 2}, device="cpu")
        params, tokens = moe_cases[2]
        local = _local(torch.from_numpy(tokens), mesh2, {0: "data"})
        out["moe_dp"] = moe_apply(shard_moe_params(mesh2, params), local,
                                  mesh2, top_k=2, data_axis="data").numpy()
    pipe = make_mesh({"pipe": 4}, device="cpu")
    stacked = stage_param_sharding(pipe, stack_stage_params(stages))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for mb in (1, 2, 4):
            out[("pipe", mb)] = pipeline_forward(_tanh_stage, stacked, xt,
                                                 pipe, mb).numpy()
    params = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    loss = torch.sum(pipeline_forward(_tanh_stage, params, xt, pipe, 4) ** 2)
    grads = torch.autograd.grad(loss, [params["w"], params["b"]])
    out["pipe_grads"] = [g.numpy() for g in grads]
    dstages, dx = dp
    mesh3 = make_mesh({"data": 2, "pipe": 2}, device="cpu")
    dstacked = stage_param_sharding(mesh3, stack_stage_params(dstages),
                                    axis="pipe")
    with torch.no_grad():
        out["pipe_dp"] = pipeline_forward(
            _tanh_stage, dstacked,
            _local(torch.from_numpy(dx), mesh3, {0: "data"}), mesh3, 2,
            data_axis="data").numpy()
    return out
