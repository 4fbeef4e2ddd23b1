"""Bucketed gradient all-reduce overlapped with the backward pass.

Counterpart of ``veles_tpu/parallel/bucketed.py``:

- :func:`plan_buckets` partitions the gradient leaves into size-targeted
  buckets (default ~25 MB, ``--grad-bucket-mb``), walking the leaves in
  REVERSE order — the order the backward produces them — and splitting
  a leaf at exact element boundaries where it does not fit.  It is pure
  Python over shapes: the port's plan equals the JAX package's on the
  same leaves.  :func:`grad_leaves` gives a gradient list's leaves in
  JAX's pytree order (layers in order, each dict's keys sorted: bias
  before weights, None dropped).
- :class:`BucketSync` is the train step's overlap: it hooks the
  parameter leaves (``Tensor.register_hook`` fires under
  ``torch.autograd.grad``), and each hook issues its bucket's
  asynchronous all-reduce as soon as the bucket is complete and every
  bucket before it has been issued (so every rank issues them in one
  order); :meth:`BucketSync.finish` waits on the handles before the
  numerics guard and the update.  :func:`bucketed_all_reduce` does the
  same on gradients already computed.  A sum is elementwise and the
  concatenate / slice round trip exact, so any bucketing gives the flat
  all-reduce's bits at a world of 2; ``impl="ring"``
  (``parallel/ring.py``'s explicit ring) sums in another order.
- ``compress="bf16"`` halves the wire bytes (a cast before and after
  the sum); the numerics guard and the trainer's f32 fall-back
  (``FusedTrainer.on_health_sync``) own the risk.
- The ZeRO-1 helpers (:func:`shard_elems`, :func:`slot_matrix`,
  :func:`unslot_matrix`, :func:`chained_reduce_scatter`,
  :func:`gather_slots`).
- :func:`overlap_model` / :func:`comm_receipt` /
  :func:`publish_comm_receipt`: the analytic overlap-credited schedule,
  its ``comm.*`` gauges and its modeled ``comm.bucket`` spans.
"""

import math
import time

import numpy
import torch

from veles_tpu_torch.parallel import collectives

__all__ = ["DEFAULT_BUCKET_MB", "Bucket", "BucketPlan", "plan_buckets",
           "grad_leaves", "BucketSync", "bucketed_all_reduce",
           "flat_all_reduce", "overlap_model", "comm_receipt",
           "publish_comm_receipt", "shard_elems", "slot_matrix",
           "unslot_matrix", "chained_reduce_scatter", "gather_slots"]

#: default bucket size target (the JAX package's)
DEFAULT_BUCKET_MB = 25.0


class Bucket(object):
    """One all-reduce payload: contiguous element spans of flattened
    gradient leaves.  ``slices`` holds ``(leaf_index, start, stop)``
    element ranges (into the leaf's 1-D view)."""

    __slots__ = ("slices", "elems", "nbytes")

    def __init__(self):
        self.slices = []
        self.elems = 0
        self.nbytes = 0

    def __repr__(self):
        return "<Bucket %d leaves %d elems %.2f MB>" % (
            len(self.slices), self.elems, self.nbytes / 2.0 ** 20)


class BucketPlan(object):
    """Static partition of a gradient pytree's leaves into buckets,
    ordered by backward-pass production (last layer first)."""

    __slots__ = ("buckets", "n_leaves", "total_elems", "total_bytes",
                 "bucket_bytes")

    def __init__(self, buckets, n_leaves, bucket_bytes):
        self.buckets = buckets
        self.n_leaves = n_leaves
        self.total_elems = sum(b.elems for b in buckets)
        self.total_bytes = sum(b.nbytes for b in buckets)
        self.bucket_bytes = bucket_bytes

    def __repr__(self):
        return "<BucketPlan %d buckets / %d leaves / %.1f MB>" % (
            len(self.buckets), self.n_leaves,
            self.total_bytes / 2.0 ** 20)


def _itemsize(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return numpy.dtype(dtype).itemsize


def _leaf_meta(leaf):
    """(n_elements, itemsize) for a tensor, an array or anything with a
    ``shape`` and a ``dtype``."""
    size = int(math.prod(leaf.shape)) if len(leaf.shape) else 1
    return size, int(_itemsize(leaf.dtype))


def plan_buckets(leaves, bucket_bytes=None):
    """Partition ``leaves`` (in pytree order) into size-targeted
    buckets, walking them in REVERSE order; a leaf that does not fit
    the current bucket's room is split at the exact element boundary.
    ``bucket_bytes=None`` means :data:`DEFAULT_BUCKET_MB`; ``inf`` (or
    any target >= the total) gives ONE bucket, the flat all-reduce."""
    if bucket_bytes is None:
        bucket_bytes = DEFAULT_BUCKET_MB * 2.0 ** 20
    elif bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be positive, got %r"
                         % (bucket_bytes,))
    buckets = []
    cur = Bucket()
    for i in reversed(range(len(leaves))):
        size, item = _leaf_meta(leaves[i])
        pos = 0
        while pos < size:
            room = bucket_bytes - cur.nbytes
            if room < item and cur.slices:
                buckets.append(cur)
                cur = Bucket()
                room = bucket_bytes
            take = size - pos
            if room < take * item:
                # at least one element per span, so a bucket target
                # smaller than one element still makes progress
                take = max(int(room // item), 1)
            cur.slices.append((i, pos, pos + take))
            cur.elems += take
            cur.nbytes += take * item
            pos += take
            if cur.nbytes >= bucket_bytes:
                buckets.append(cur)
                cur = Bucket()
    if cur.slices:
        buckets.append(cur)
    return BucketPlan(buckets, len(leaves), bucket_bytes)


def grad_leaves(tree):
    """The tensor leaves of a list / dict tree in JAX's pytree order
    (dict keys sorted, None dropped), with their paths."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + (i,))
        else:
            out.append((path, node))
    walk(tree, ())
    return out


def _set_path(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def _wire(vec, compress):
    """The bucket as sent: bf16 for ``compress="bf16"`` (f32 buckets),
    else a tensor the sum may overwrite."""
    if compress == "bf16" and vec.dtype == torch.float32:
        return vec.to(torch.bfloat16)
    return vec.clone()


class BucketSync(object):
    """One step's bucketed all-reduce of ``plan``'s leaves over
    ``group``: :meth:`hook` returns leaf i's gradient hook, which adds
    ``poison`` (the chaos harness's scalar, before the sum, so a fault
    on one rank spreads as a bad chip's would) and issues every bucket
    that is complete and next in order; :meth:`finish` waits and
    returns the summed leaves (1-D, in the plan's leaf order)."""

    def __init__(self, plan, group, impl="psum", compress=None,
                 poison=None):
        if impl not in ("psum", "ring"):
            raise ValueError("unknown all-reduce impl %r" % (impl,))
        if compress not in (None, "bf16"):
            raise ValueError("unknown gradient compression %r" % (compress,))
        self.plan = plan
        self.group = group
        self.impl = impl
        self.compress = compress
        self.poison = poison
        self._flat = [None] * plan.n_leaves
        self._pending = [len({i for i, _, _ in b.slices})
                         for b in plan.buckets]
        self._waiting = {}
        for b, bucket in enumerate(plan.buckets):
            for i in {i for i, _, _ in bucket.slices}:
                self._waiting.setdefault(i, []).append(b)
        self._issued = []

    def hook(self, index):
        def fire(grad):
            if self.poison is not None:
                grad = grad + self.poison.to(grad.dtype)
            self.add(index, grad)
            return grad
        return fire

    def add(self, index, grad):
        """Leaf ``index``'s local gradient is ready."""
        self._flat[index] = grad.reshape(-1)
        for b in self._waiting.get(index, ()):
            self._pending[b] -= 1
        while (len(self._issued) < len(self.plan.buckets)
               and self._pending[len(self._issued)] == 0):
            self._issue(self.plan.buckets[len(self._issued)])

    def _issue(self, bucket):
        parts = [self._flat[i][start:stop]
                 for i, start, stop in bucket.slices]
        vec = parts[0] if len(parts) == 1 else torch.cat(parts)
        wire = _wire(vec, self.compress) if len(parts) == 1 or \
            self.compress else vec
        if self.impl == "ring":
            from veles_tpu_torch.parallel.ring import ring_all_reduce
            self._issued.append((bucket, ring_all_reduce(wire, self.group),
                                 None, vec.dtype))
        else:
            work = collectives.all_reduce(wire, self.group, async_op=True)
            self._issued.append((bucket, wire, work, vec.dtype))

    def finish(self):
        """Wait for every bucket; the summed 1-D leaves, plan order."""
        if len(self._issued) != len(self.plan.buckets):
            missing = [i for i, g in enumerate(self._flat) if g is None]
            raise RuntimeError("gradient buckets left unissued: no "
                               "gradient for leaves %s" % missing)
        pieces = [[] for _ in range(self.plan.n_leaves)]
        for bucket, wire, work, dtype in self._issued:
            if work is not None:
                work.wait()
            vec = wire.to(dtype)
            offset = 0
            for i, start, stop in bucket.slices:
                pieces[i].append((start, vec[offset:offset + stop - start]))
                offset += stop - start
        out = []
        for spans in pieces:
            spans.sort(key=lambda item: item[0])
            out.append(spans[0][1] if len(spans) == 1 else
                       torch.cat([piece for _, piece in spans]))
        return out


def bucketed_all_reduce(grads, group, bucket_bytes=None, plan=None,
                        impl="psum", compress=None):
    """Sum a gradient tree (lists / dicts of tensors) over ``group``,
    one collective a bucket, issued in plan order; returns a tree of
    the same structure."""
    found = grad_leaves(grads)
    if not found:
        return grads
    leaves = [leaf for _, leaf in found]
    if plan is None:
        plan = plan_buckets(leaves, bucket_bytes)
    sync = BucketSync(plan, group, impl, compress)
    for index in reversed(range(len(leaves))):
        sync.add(index, leaves[index])
    out = _copy_tree(grads)
    for (path, leaf), flat in zip(found, sync.finish()):
        _set_path(out, path, flat.reshape(leaf.shape))
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree


def flat_all_reduce(grads, group, impl="psum", compress=None):
    """The flat reference: ONE bucket spanning the whole tree."""
    return bucketed_all_reduce(grads, group, bucket_bytes=float("inf"),
                               impl=impl, compress=compress)


# -- ZeRO-1 reduce-scatter + all-gather --------------------------------------


def shard_elems(size, n_shards):
    """Per-shard element count for a tensor of ``size`` elements split
    into ``n_shards`` logical shards (ceil-div; the last shard pads)."""
    return -(-int(size) // max(int(n_shards), 1))


def slot_matrix(flat, slots, n_shards, elems):
    """A flattened tensor as per-slot rows: padded to ``n_shards *
    elems``, reshaped to (n_shards, elems), one all-zero pad row
    appended (id ``n_shards``), rows gathered by the ``slots`` table."""
    flat = flat.reshape(-1)
    pad = n_shards * elems - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mat = torch.cat([flat.reshape(n_shards, elems),
                     flat.new_zeros(1, elems)])
    return mat.index_select(0, slots.long())


def unslot_matrix(rows, slots, n_shards, size, shape, dtype):
    """Invert :func:`slot_matrix`: slot rows back to shard order (pad
    slots all land on the dropped row ``n_shards``), padding stripped,
    reshaped to ``shape``."""
    elems = rows.shape[-1]
    full = rows.new_zeros((n_shards + 1, elems), dtype=dtype)
    full.index_copy_(0, slots.long(), rows.to(dtype))
    return full[:n_shards].reshape(-1)[:size].reshape(shape)


def chained_reduce_scatter(mats, group):
    """Reduce-scatter each (n_slots, elems) slot matrix over ``group``;
    rank r receives the summed rows ``[r*k, (r+1)*k)`` — its owned
    shards.  ``mats`` arrive in backward production order and issue in
    that order; returns the (k, elems) matrices, same order."""
    n = collectives.group_size(group)
    outs, works = [], []
    for mat in mats:
        mat = mat.contiguous()
        part = mat.new_empty((mat.shape[0] // n,) + tuple(mat.shape[1:]))
        works.append(collectives.reduce_scatter(part, mat, group,
                                                async_op=True))
        outs.append(part)
    for work in works:
        work.wait()
    return outs


def gather_slots(part, group):
    """All-gather the per-rank (k, elems) shard rows back to the full
    (n_slots, elems) slot matrix."""
    n = collectives.group_size(group)
    part = part.contiguous()
    out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
    collectives.all_gather(out, part, group)
    return out


# -- analytic overlap model ---------------------------------------------------


def overlap_model(grad_bytes, n_buckets, n_devices, step_seconds=None,
                  ici_gbps=100.0, hop_latency_s=1e-6, bwd_fraction=0.6):
    """Overlap-credited ring all-reduce schedule for one train step
    (the JAX package's model, unchanged: ``ici_gbps`` is its link rate
    parameter, not a measurement of any link).  Wire time is the ring
    bound 2(n-1)/n * bytes / bw; launch latency is paid per bucket;
    bucket k hides behind the backward that produces buckets k+1..;
    the last bucket is never hidden.  ``step_seconds=None`` credits no
    overlap."""
    n = max(int(n_devices), 1)
    n_buckets = max(int(n_buckets), 1)
    bw = ici_gbps * 1e9
    t_wire = (2.0 * (n - 1) / n) * grad_bytes / bw if n > 1 else 0.0
    t_lat = n_buckets * 2 * (n - 1) * hop_latency_s
    t_comm = t_wire + t_lat
    if step_seconds and n_buckets > 1:
        window = (bwd_fraction * step_seconds *
                  (n_buckets - 1.0) / n_buckets)
    else:
        window = 0.0
    tail = t_comm / n_buckets
    hidden = min(max(t_comm - tail, 0.0), window)
    exposed = t_comm - hidden
    return {
        "n_devices": n,
        "n_buckets": n_buckets,
        "t_comm_s": t_comm,
        "t_comm_hidden_s": hidden,
        "t_comm_exposed_s": exposed,
        "overlap_pct": round(100.0 * hidden / t_comm, 2) if t_comm
        else 0.0,
        "bwd_fraction": bwd_fraction,
        "ici_usable_gbps": ici_gbps,
        "hop_latency_s": hop_latency_s,
    }


def comm_receipt(grad_leaves, n_devices, bucket_bytes=None,
                 step_seconds=None, compress=None, ici_gbps=100.0,
                 hop_latency_s=1e-6, bwd_fraction=0.6):
    """The per-step communication receipt of a gradient tree's leaves:
    the exact bucket partition (the plan the step runs) plus the
    modeled overlap schedule.  ``compress="bf16"`` halves the wire
    bytes."""
    plan = plan_buckets(grad_leaves, bucket_bytes)
    bucket_sizes = [b.nbytes for b in plan.buckets]
    wire_bytes = plan.total_bytes
    if compress == "bf16":
        wire_bytes //= 2
    model = overlap_model(
        wire_bytes, len(bucket_sizes), n_devices,
        step_seconds=step_seconds, ici_gbps=ici_gbps,
        hop_latency_s=hop_latency_s, bwd_fraction=bwd_fraction)
    return {
        "allreduce_bytes": plan.total_bytes,
        "wire_bytes": wire_bytes,
        "compress": compress,
        "bucket_bytes": bucket_sizes,
        "bucket_target_bytes": (None if math.isinf(plan.bucket_bytes)
                                else int(plan.bucket_bytes)),
        "model": model,
    }


def publish_comm_receipt(receipt, tracer=None, registry=None):
    """A :func:`comm_receipt` as the ``comm.allreduce_bytes`` /
    ``comm.buckets`` / ``comm.overlap_pct`` gauges, plus one
    ``comm.bucket`` span a bucket on the caller's track (the modeled
    schedule, stamped ``modeled`` in the args) and a ``comm.receipt``
    instant."""
    from veles_tpu_torch.observe.metrics import registry as _registry
    from veles_tpu_torch.observe.trace import tracer as _tracer
    reg = registry if registry is not None else _registry
    reg.gauge("comm.allreduce_bytes").set(receipt["allreduce_bytes"])
    reg.gauge("comm.buckets").set(len(receipt["bucket_bytes"]))
    reg.gauge("comm.overlap_pct").set(receipt["model"]["overlap_pct"])
    tr = tracer if tracer is not None else _tracer
    if not tr.active:
        return
    model = receipt["model"]
    total = max(sum(receipt["bucket_bytes"]), 1)
    cursor = time.perf_counter()
    for index, nbytes in enumerate(receipt["bucket_bytes"]):
        dur = model["t_comm_s"] * nbytes / total
        tr.complete("comm.bucket", cursor, dur, cat="comm",
                    args={"index": index, "bytes": nbytes,
                          "modeled": True})
        cursor += dur
    tr.instant("comm.receipt", cat="comm",
               buckets=len(receipt["bucket_bytes"]),
               allreduce_bytes=receipt["allreduce_bytes"],
               overlap_pct=model["overlap_pct"],
               compress=receipt.get("compress") or "none")
