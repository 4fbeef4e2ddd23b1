"""Device meshes over ``torch.distributed`` ranks, the ZeRO-1 state
layout and the elastic ZeRO-1 mesh.

Counterpart of ``veles_tpu/parallel/mesh.py``.  JAX runs one controller
over many devices; the port runs one process a rank.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions carry the
JAX package's axis names (``"data"``, ``"model"``, ``"pipe"``,
``"seq"``, ``"expert"``): :func:`axis_group` is the process group a
collective on an axis runs on, :func:`axis_index` this rank's
coordinate there (``lax.axis_index``) and :func:`axis_size` the axis's
length (``mesh.shape[axis]``).

The world: :func:`make_mesh` and :func:`auto_mesh` span the ranks of
the default process group (``launcher.init_multihost`` starts one from
``VELES_COORDINATOR``, a test from a file store).  Without one, they
start a world of one process on the caller's device.  The backend is
NCCL on the card and gloo on the CPU, and the CPU only when the caller
asks for it (``device="cpu"``): the default device is the card, and
nothing falls back.

ZeRO-1 (docs/distributed.md, "Elastic mesh contract"): the optimizer
state (the accum leaves) splits into ``n_shards`` logical shards a
tensor; each rank hosts ``ceil(n_shards / N)`` slots, and an int32
``zero_slots`` table maps slots to shard ids (the id ``n_shards`` is a
padding slot backed by an all-zero row).  :func:`zero_slot_table`,
:func:`zero_state` and :func:`unzero_state` return what the JAX
package's return (host numpy), and ``zero_state(..., rank=r)`` the k
slot rows rank r holds, which is the state the port's ZeRO-1 step takes
(``compiler.build_train_step(zero=1)``); :func:`gather_zero_state`
collects every rank's rows.

:class:`MeshManager`: the elastic ZeRO-1 mesh over the ranks of a fixed
world (see its docstring).
"""

import numpy
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "auto_mesh", "axis_group", "axis_index",
           "axis_size", "mesh_axes", "ensure_world", "zero_slot_table",
           "zero_state", "unzero_state", "gather_zero_state",
           "ZERO_SHARDED_KEYS", "MeshManager", "mesh_snapshot"]


def _device_type(device):
    """The mesh's device type: "cuda" unless ``device`` names the
    CPU.  The card is the default; it raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh lives on the card unless the "
                "caller asks for the CPU (device='cpu')")
        return "cuda"
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError("a mesh lives on cuda or cpu, not %r" % (device,))
    return kind


def ensure_world(device=None):
    """The default process group, started as a world of one process
    (NCCL on the card, gloo on the CPU) when there is none.  Returns
    the world size."""
    kind = _device_type(device)
    if not dist.is_initialized():
        backend = "nccl" if kind == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def make_mesh(axes, device=None):
    """axes: dict name -> size, e.g. {"data": 4, "model": 2}, over the
    world's ranks in order (the last axis varies fastest, as JAX lays a
    device grid out).  Sizes must multiply to the world size; -1 once
    means "the rest"."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    world = ensure_world(device)
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(numpy.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if world % known:
            raise ValueError("cannot infer -1 axis: %d ranks over %d"
                             % (world, known))
        sizes[sizes.index(-1)] = world // known
    if int(numpy.prod(sizes)) != world:
        raise ValueError("mesh %s needs %d ranks, the world has %d"
                         % (dict(axes), int(numpy.prod(sizes)), world))
    return init_device_mesh(kind, tuple(sizes), mesh_dim_names=tuple(names))


def auto_mesh(data_axis="data", device=None):
    """Every rank on one data-parallel axis."""
    return make_mesh({data_axis: ensure_world(device)}, device)


def axis_group(mesh, axis):
    """The process group of ``mesh``'s axis ``axis``."""
    return mesh.get_group(axis)


def axis_size(mesh, axis):
    return dist.get_world_size(mesh.get_group(axis))


def axis_index(mesh, axis):
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return dist.get_rank(mesh.get_group(axis))


def mesh_axes(mesh):
    """{axis name: size}, the JAX mesh's ``shape``."""
    return {name: axis_size(mesh, name) for name in mesh.mesh_dim_names}


class GroupMesh(object):
    """A one-axis mesh over a subgroup of the world (the elastic mesh's
    members): the part of ``DeviceMesh``'s interface the parallel layer
    uses."""

    def __init__(self, axis, group, device_type):
        self.mesh_dim_names = (axis,)
        self.device_type = device_type
        self._group = group

    def get_group(self, axis):
        if axis != self.mesh_dim_names[0]:
            raise KeyError(axis)
        return self._group


# -- ZeRO-1 state layout -----------------------------------------------------

#: accum leaves — the state entries that live sharded in ZeRO form
ZERO_SHARDED_KEYS = ("accum_weights", "accum_bias", "accum2_weights",
                     "accum2_bias")


def _zero_ref_key(key):
    """The param tensor an accum leaf shadows (its shape source)."""
    return "bias" if key.endswith("bias") else "weights"


def zero_slot_table(n_shards, n_devices, owners=None):
    """The int32 ``(n_devices * ceil(n_shards / n_devices),)`` slot
    table for an ownership map ``{shard: device_index}`` (default round
    robin).  Device d's slots are ``[d*k, (d+1)*k)``, its shard ids
    ascending, padded with the id ``n_shards``."""
    m, n = int(n_shards), int(n_devices)
    k = -(-m // n)
    table = numpy.full((n * k,), m, numpy.int32)
    owned = {d: [] for d in range(n)}
    if owners is None:
        for shard in range(m):
            owned[shard % n].append(shard)
    else:
        for shard, d in owners.items():
            owned[int(d)].append(int(shard))
    for d in range(n):
        shards = sorted(owned[d])
        if len(shards) > k:
            raise ValueError(
                "device %d owns %d shards, capacity %d (n_shards=%d "
                "over %d devices)" % (d, len(shards), k, m, n))
        table[d * k:d * k + len(shards)] = shards
    return table


def _host(value):
    """A host numpy copy (a CPU tensor's ``numpy()`` would share its
    memory, which a donated step rewrites)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return numpy.asarray(value)


def zero_state(state, n_devices, n_shards=None, slots=None, rank=None):
    """Pack a canonical state (full accum arrays) into ZeRO-1 form:
    accum leaves become ``(n_slots, shard_elems)`` slot matrices (host
    numpy) and every entry gains the ``zero_slots`` table; params stay
    whole.  ``rank=r`` keeps only device r's ``k`` slot rows of each
    matrix, what rank r's ZeRO-1 step holds.  ``n_shards`` defaults to
    one shard a device."""
    from veles_tpu_torch.parallel.bucketed import shard_elems

    m = int(n_shards or n_devices)
    if slots is None:
        slots = zero_slot_table(m, n_devices)
    slots = numpy.asarray(slots, numpy.int32)
    k = slots.shape[0] // int(n_devices)
    out = []
    for entry in state:
        packed = {key: None if value is None else _host(value)
                  for key, value in entry.items()}
        packed["zero_slots"] = slots
        for key in ZERO_SHARDED_KEYS:
            arr = packed.get(key)
            if arr is None:
                continue
            e = shard_elems(arr.size, m)
            flat = numpy.zeros(((m + 1) * e,), arr.dtype)
            flat[:arr.size] = arr.reshape((-1,))
            rows = flat.reshape((m + 1, e))[slots]
            if rank is not None:
                rows = rows[rank * k:(rank + 1) * k]
            packed[key] = numpy.ascontiguousarray(rows)
        out.append(packed)
    return out


def unzero_state(state, n_shards):
    """Invert :func:`zero_state` (all slot rows): full canonical accum
    arrays (host numpy) by each entry's ``zero_slots`` table.  Rows
    move, bits never change."""
    m = int(n_shards)
    out = []
    for entry in state:
        slots = _host(entry["zero_slots"])
        plain = {key: None if value is None else _host(value)
                 for key, value in entry.items() if key != "zero_slots"}
        for key in ZERO_SHARDED_KEYS:
            rows = plain.get(key)
            if rows is None:
                continue
            ref = plain[_zero_ref_key(key)]
            e = rows.shape[-1]
            full = numpy.zeros((m + 1, e), rows.dtype)
            full[slots] = rows
            plain[key] = full[:m].reshape((-1,))[:ref.size].reshape(
                ref.shape)
        out.append(plain)
    return out


def gather_zero_state(state, mesh, data_axis="data"):
    """Every rank's slot rows of a ZeRO-1 step's state, all-gathered
    over ``data_axis``: the state :func:`unzero_state` takes.  Called
    on every rank of the axis."""
    from veles_tpu_torch.parallel import collectives
    group = axis_group(mesh, data_axis)
    n = axis_size(mesh, data_axis)
    out = []
    for entry in state:
        full = dict(entry)
        for key in ZERO_SHARDED_KEYS:
            rows = entry.get(key)
            if rows is None:
                continue
            rows = rows.contiguous()
            gathered = torch.empty((n * rows.shape[0],) + rows.shape[1:],
                                   dtype=rows.dtype, device=rows.device)
            collectives.all_gather(gathered, rows, group)
            full[key] = gathered
        out.append(full)
    return out


#: Mesh keys surfaced to dashboards/heartbeats: registry name -> short
#: name.
_MESH_KEYS = (
    ("mesh.size", "size"),
    ("mesh.epoch", "epoch"),
    ("mesh.reshards", "reshards"),
    ("mesh.bytes_moved", "bytes_moved"),
    ("mesh.coalesced_events", "coalesced_events"),
    ("mesh.compile_hits", "compile_hits"),
    ("mesh.compile_misses", "compile_misses"),
)


def mesh_snapshot(reg=None):
    """The elastic-mesh counters as a flat dict: mesh size and epoch,
    reshards and bytes moved, step-cache traffic, plus the
    ``mesh.reshard_s`` time-to-recover histogram.  {} in a process
    that never built a MeshManager."""
    from veles_tpu_torch.observe.metrics import registry as _registry
    from veles_tpu_torch.observe.metrics import snapshot_keys
    reg = reg if reg is not None else _registry
    out = snapshot_keys(_MESH_KEYS, reg)
    hist = reg.peek("mesh.reshard_s")
    if hist is not None and getattr(hist, "count", 0):
        out["reshard_s"] = hist.snapshot()
    return out


def _rank_key(rank):
    """Stable consistent-hash key of a rank (the same rank hashes the
    same across reshards and restarts)."""
    return "r%d" % rank


class MeshManager(object):
    """Elastic ZeRO-1 training mesh over the ranks of a fixed world
    (docs/distributed.md, "Elastic mesh contract").

    Counterpart of ``veles_tpu/parallel/mesh.py``'s, with ranks for
    devices.  Every rank of the world builds one with the same
    arguments and calls :meth:`step` (and anything else) in the same
    order: the members train on their rows of the global batch, the
    others take part only in a reshard.  It owns the live state in
    ZeRO-1 form over the members and survives membership churn: an
    event (:meth:`submit_membership`, fed by ``elastic.FleetView``
    epochs through :meth:`sync_fleet`) only marks a pending member set,
    and :meth:`step` applies the newest one before touching the data
    plane, so back-to-back events coalesce into ONE reshard.  A reshard
    gathers the canonical state over the old members, broadcasts it to
    the world (a joiner gets its rows), takes a verified safety
    snapshot, recomputes consistent-hash ownership
    (``elastic.shard_owners``, minimal-move from the previous owners)
    and makes the new members' process group
    (``torch.distributed.new_group``, on every rank); ``bytes_moved``
    counts the changed-owner shards (``elastic.movement_plan``) a point
    to point reshard would send.  Steps are cached by digest (members,
    shards, plan), so rejoining a member set seen before builds no new
    step.  The chaos point ``mesh.reshard`` (action ``crash``) fires
    after the safety snapshot, before the new layout;
    :meth:`resume` restarts from the newest verified snapshot.
    """

    def __init__(self, plans, state, loss="softmax", ranks=None,
                 n_shards=None, data_axis="data", snapshot_dir=None,
                 donate=True, bwd_remat=False, device="cpu"):
        from veles_tpu_torch.observe.metrics import registry as _registry
        self.plans = plans
        self.loss = loss
        self.data_axis = data_axis
        self.snapshot_dir = snapshot_dir
        self.donate = donate
        self.bwd_remat = bwd_remat
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self._ranks = tuple(sorted(ranks if ranks is not None
                                   else range(dist.get_world_size())))
        if not self._ranks:
            raise ValueError("MeshManager needs at least one rank")
        #: logical shard count, the movement granularity: 4x the first
        #: mesh, so a leave moves ~1/N of the optimizer state in ~4
        #: pieces and a shrink never runs out of shards to spread
        self.n_shards = int(n_shards or 4 * len(self._ranks))
        if self.n_shards < len(self._ranks):
            raise ValueError(
                "n_shards=%d < %d ranks: every rank needs at least one "
                "logical shard" % (self.n_shards, len(self._ranks)))
        self.mesh_epoch = 0
        self.applied_steps = 0
        self._pending = None          # (ranks, source_epoch) | None
        self._fleet_epoch_seen = None
        self._steps = {}              # digest -> step
        self._groups = {}             # member ranks -> process group
        self._owners = None
        #: per-reshard receipt rows (movement plan, bytes, timings)
        self.reshard_log = []
        self._reg = _registry
        canonical = [{k: None if v is None else _host(v)
                      for k, v in entry.items()} for entry in state]
        self._layout = [{k: None if v is None else (v.shape, v.dtype)
                         for k, v in entry.items()} for entry in canonical]
        self._adopt(canonical)
        self._publish_gauges()

    # -- membership ----------------------------------------------------

    @property
    def ranks(self):
        return self._ranks

    @property
    def size(self):
        return len(self._ranks)

    @property
    def is_member(self):
        return self.rank in self._ranks

    def submit_membership(self, ranks, epoch=None):
        """Queue a membership change, applied at the NEXT step boundary;
        a newer event before then replaces it (counted in
        ``mesh.coalesced_events``)."""
        ranks = tuple(sorted(ranks))
        if not ranks:
            raise ValueError("membership event with zero ranks")
        if self._pending is not None:
            self._reg.counter("mesh.coalesced_events").inc()
        self._pending = (ranks, epoch)

    def sync_fleet(self, fleet, ranks_for):
        """Feed membership from an ``elastic.FleetView``: when its
        ``membership_epoch`` moved since the last sync, the union of
        ``ranks_for(sid)`` over live members becomes the pending rank
        set.  Returns True when an event was queued."""
        epoch = fleet.membership_epoch
        if epoch == self._fleet_epoch_seen:
            return False
        self._fleet_epoch_seen = epoch
        ranks = set()
        for sid in fleet.members:
            ranks.update(ranks_for(sid))
        self.submit_membership(ranks, epoch=epoch)
        return True

    # -- state layout ---------------------------------------------------

    def _group(self, ranks):
        """The process group of ``ranks``; made on every rank of the
        world, in one order."""
        group = self._groups.get(ranks)
        if group is None:
            if len(ranks) == dist.get_world_size():
                group = dist.group.WORLD
            else:
                group = dist.new_group(list(ranks))
            self._groups[ranks] = group
        return group

    def _adopt(self, canonical, owners=None):
        """Pack the canonical state for the current members; a member
        keeps its slot rows on its device."""
        from veles_tpu_torch.elastic import shard_owners
        keys = [_rank_key(r) for r in self._ranks]
        self._owners = shard_owners(self.n_shards, keys, previous=owners)
        index = {key: i for i, key in enumerate(keys)}
        slots = zero_slot_table(
            self.n_shards, len(keys),
            owners={s: index[m] for s, m in self._owners.items()})
        self._group(self._ranks)
        self._state = None
        if self.is_member:
            packed = zero_state(canonical, len(keys),
                                n_shards=self.n_shards, slots=slots,
                                rank=self._ranks.index(self.rank))
            self._state = [{k: None if v is None else
                            torch.as_tensor(numpy.ascontiguousarray(v),
                                            device=self.device)
                            for k, v in entry.items()} for entry in packed]

    def canonical_state(self):
        """The full state as host numpy, on every rank of the world:
        gathered over the members, then sent from the first member to
        the others.  Called on every rank."""
        if self.is_member:
            full = unzero_state(gather_zero_state(
                self._state, GroupMesh(self.data_axis,
                                       self._group(self._ranks),
                                       self.device.type),
                self.data_axis), self.n_shards)
        else:
            full = [{k: None if v is None else numpy.zeros(*v)
                     for k, v in entry.items()} for entry in self._layout]
        src = self._ranks[0]
        out = []
        for entry in full:
            sent = {}
            for key, value in entry.items():
                if value is not None and dist.get_world_size() > 1:
                    tensor = torch.as_tensor(
                        numpy.ascontiguousarray(value), device=self.device)
                    dist.broadcast(tensor, src=src)
                    value = tensor.cpu().numpy()
                sent[key] = value
            out.append(sent)
        return out

    def shard_bytes(self):
        """Bytes of optimizer state a logical shard (all layers, all
        accum leaves): the unit ``bytes_moved`` counts in."""
        from veles_tpu_torch.parallel.bucketed import shard_elems
        total = 0
        for entry in self._layout:
            for key in ZERO_SHARDED_KEYS:
                meta = entry.get(key)
                if meta is None:
                    continue
                shape, dtype = meta
                total += shard_elems(int(numpy.prod(shape)),
                                     self.n_shards) * dtype.itemsize
        return total

    # -- step cache -----------------------------------------------------

    def _digest(self):
        import hashlib
        meta = [(p.forward_cls.__name__, p.solver, p.include_bias,
                 tuple(sorted(p.hyper_full().items())),
                 tuple(sorted(p.static.items())))
                for p in self.plans]
        blob = repr((self._ranks, self.n_shards, self.loss,
                     self.data_axis, self.bwd_remat, meta)).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _get_step(self):
        from veles_tpu_torch import compiler
        digest = self._digest()
        step = self._steps.get(digest)
        if step is not None:
            self._reg.counter("mesh.compile_hits").inc()
            return step
        self._reg.counter("mesh.compile_misses").inc()
        mesh = GroupMesh(self.data_axis, self._group(self._ranks),
                         self.device.type)
        step = compiler.build_train_step(
            self.plans, loss=self.loss, mesh=mesh,
            data_axis=self.data_axis, zero=1, zero_shards=self.n_shards,
            donate=self.donate, bwd_remat=self.bwd_remat)
        self._steps[digest] = step
        return step

    # -- reshard --------------------------------------------------------

    def maybe_reshard(self):
        """Apply the newest pending membership event (if any) at this
        step boundary; returns the reshard receipt row or None."""
        if self._pending is None:
            return None
        ranks, epoch = self._pending
        self._pending = None
        if ranks == self._ranks:
            return None  # no-op churn (leave + rejoin of the same set)
        return self._reshard(ranks, epoch)

    def _reshard(self, ranks, source_epoch):
        import time as _time

        from veles_tpu_torch import chaos
        from veles_tpu_torch.elastic import movement_plan
        t0 = _time.perf_counter()
        canonical = self.canonical_state()
        snapshot_path = self.snapshot(reason="pre_reshard",
                                      state=canonical)
        if chaos.plan is not None:
            fault = chaos.plan.fire("mesh.reshard")
            if fault is not None and fault.action == "crash":
                # after the safety snapshot, before the new layout
                raise chaos.ChaosCrash("simulated crash mid-reshard")
        old_owners = self._owners
        old_size = len(self._ranks)
        self._ranks = ranks
        self._adopt(canonical, owners=old_owners)
        plan = movement_plan(old_owners, self._owners)
        per_shard = self.shard_bytes()
        bytes_moved = plan["n_moved"] * per_shard
        self.mesh_epoch += 1
        cached = self._digest() in self._steps
        if self.is_member:
            self._get_step()
        elapsed = _time.perf_counter() - t0
        event = {
            "mesh_epoch": self.mesh_epoch,
            "source_epoch": source_epoch,
            "step": self.applied_steps,
            "from_size": old_size,
            "to_size": len(self._ranks),
            "n_shards": self.n_shards,
            "moved_shards": plan["n_moved"],
            "changed_fraction": plan["changed_fraction"],
            "bytes_moved": bytes_moved,
            "full_gather_bytes": self.n_shards * per_shard,
            "reshard_s": elapsed,
            "compile_cached": cached,
            "snapshot": snapshot_path,
        }
        self.reshard_log.append(event)
        self._reg.counter("mesh.reshards").inc()
        self._reg.counter("mesh.bytes_moved").inc(bytes_moved)
        self._reg.histogram("mesh.reshard_s").observe(elapsed)
        self._publish_gauges()
        from veles_tpu_torch.observe.trace import tracer
        if tracer.active:
            tracer.instant("mesh.resharded", cat="mesh", **{
                k: event[k] for k in ("mesh_epoch", "from_size",
                                      "to_size", "moved_shards",
                                      "bytes_moved", "reshard_s")})
        return event

    def _publish_gauges(self):
        self._reg.gauge("mesh.size").set(len(self._ranks))
        self._reg.gauge("mesh.epoch").set(self.mesh_epoch)

    # -- snapshots ------------------------------------------------------

    def snapshot(self, reason="manual", state=None):
        """Verified safety snapshot of the canonical state (+ progress
        counters), written by the first member; returns the path (the
        same on every rank), or None without a ``snapshot_dir``.
        Called on every rank (``state=None`` gathers it)."""
        if not self.snapshot_dir:
            return None
        import os

        from veles_tpu_torch import snapshotter
        if state is None:
            state = self.canonical_state()
        path = os.path.join(
            self.snapshot_dir, "mesh_%s_e%d_s%d.pickle" %
            (reason, self.mesh_epoch, self.applied_steps))
        if self.rank == self._ranks[0]:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            snapshotter.write_state_snapshot(
                path, {"state": state, "applied_steps": self.applied_steps,
                       "mesh_epoch": self.mesh_epoch,
                       "n_shards": self.n_shards},
                workflow_name="MeshManager", epoch=self.mesh_epoch)
        if dist.get_world_size() > 1:
            dist.barrier()
        return path

    @classmethod
    def resume(cls, snapshot_dir, plans, **kwargs):
        """A manager from the newest verified snapshot in
        ``snapshot_dir`` (the ``--resume auto`` path), on every rank.
        The state is bit-exact: the snapshot holds the canonical form,
        and the repack moves rows, never values."""
        from veles_tpu_torch import snapshotter
        snap = snapshotter.latest_state_snapshot(snapshot_dir)
        if snap is None:
            raise snapshotter.SnapshotError(
                "no verified mesh snapshot under %s" % snapshot_dir)
        payload = snapshotter.load_state_snapshot(snap)
        kwargs.setdefault("n_shards", payload.get("n_shards"))
        manager = cls(plans, payload["state"], snapshot_dir=snapshot_dir,
                      **kwargs)
        manager.applied_steps = int(payload.get("applied_steps", 0))
        manager.mesh_epoch = int(payload.get("mesh_epoch", 0))
        manager._publish_gauges()
        return manager

    # -- stepping -------------------------------------------------------

    def step(self, x, target, batch_size=None, step_key=None,
             grad_poison=None, loss_poison=None):
        """One train step on the current members (every rank calls it),
        any pending membership event applied FIRST.  ``x`` / ``target``
        are the global batch; each member takes its rows (the leading
        dim must divide by the member count).  Returns the metrics on a
        member, None elsewhere; the state advances in place."""
        self.maybe_reshard()
        n = len(self._ranks)
        if x.shape[0] % n:
            raise ValueError(
                "global batch %d does not divide over %d ranks — pick a "
                "batch size divisible by every mesh size the membership "
                "schedule can reach" % (x.shape[0], n))
        self.applied_steps += 1
        if not self.is_member:
            return None
        if batch_size is None:
            batch_size = float(x.shape[0])
        rows = x.shape[0] // n
        me = self._ranks.index(self.rank)
        step = self._get_step()
        self._state, metrics = step(
            self._state, x[me * rows:(me + 1) * rows],
            target[me * rows:(me + 1) * rows], batch_size, step_key,
            grad_poison, loss_poison)
        return metrics
