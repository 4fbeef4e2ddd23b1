"""Ring collectives and sequence-parallel attention over mesh axes.

Counterpart of ``veles_tpu/parallel/ring.py``.  The JAX functions take
global arrays and ``shard_map`` them; here each rank passes its own
shards and gets its own shard back.

- :func:`ring_attention` — blockwise (online-softmax) attention where
  the K/V shards rotate around the ``seq`` axis's ring
  (``collectives.ppermute``, differentiable: its transpose rotates the
  other way), each step touching one (T_local x T_local) score block.
- :func:`ulysses_attention` — the all-to-all alternative: reshard
  (seq-sharded -> head-sharded), full local attention per head group,
  reshard back.
- :func:`ring_all_reduce` — the same ring applied to a vector sum:
  chunked reduce-scatter then all-gather, 2(n-1) shifts of one 1/n
  chunk each.  It sums in another order than ``all_reduce``.

The reference computes attention here in plain ops (no Pallas call),
and so does the port: plain torch, f32 scores.  Causal masking uses
global positions.  ``data_axis`` / ``head_axis`` name the axes the
caller split the batch / heads over: attention needs no collective on
them, so they only document the layout (dp x sp x tp composes at no
extra communication).
"""

import math

import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

__all__ = ["ring_attention", "ulysses_attention", "attention_reference",
           "ring_all_reduce"]


def ring_all_reduce(x, group):
    """Sum a 1-D vector over ``group`` with an explicit ring; returns a
    new tensor."""
    n = collectives.group_size(group)
    if n == 1:
        return x.clone()
    length = x.shape[0]
    pad = (-length) % n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    chunks = x.reshape(n, -1).clone()
    me = collectives.group_rank(group)
    # reduce-scatter: after n-1 rotations rank i owns the fully reduced
    # chunk (i+1) % n
    for step in range(n - 1):
        send = (me - step) % n
        recv = (me - step - 1) % n
        block = collectives._permute(chunks[send], group, 1)
        chunks[recv] += block
    # all-gather: rotate the reduced chunks around the ring
    for step in range(n - 1):
        send = (me + 1 - step) % n
        block = collectives._permute(chunks[send], group, 1)
        chunks[(me - step) % n] = block
    out = chunks.reshape(-1)
    return out[:length] if pad else out


def attention_reference(q, k, v, causal=False):
    """Single-device oracle: q, k, v (B, T, H, D) -> (B, T, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _ring_body(my_index, n_shards, t_local, group, causal, scale, q, k,
               v):
    """The ring loop over this rank's (B, Tl, H, D) shards."""
    batch, _, heads, depth = q.shape
    dev = q.device
    q_pos = my_index * t_local + torch.arange(t_local, device=dev)
    m = torch.full((batch, heads, t_local), -math.inf,
                   dtype=torch.float32, device=dev)
    l = torch.zeros((batch, heads, t_local), dtype=torch.float32,
                    device=dev)
    o = torch.zeros((batch, heads, t_local, depth), dtype=torch.float32,
                    device=dev)
    k_blk, v_blk = k, v
    for i in range(n_shards):
        src = (my_index - i) % n_shards  # origin rank of current block
        k_pos = src * t_local + torch.arange(t_local, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k_blk.float()) * scale
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v_blk.float())
        m = m_new
        k_blk = collectives.ppermute(k_blk, group, 1)
        v_blk = collectives.ppermute(v_blk, group, 1)
    out = o / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q, k, v, mesh, seq_axis="seq", causal=False,
                   data_axis=None, head_axis=None):
    """This rank's q, k, v shards (B_l, T / n, H_l, D), T split over
    ``seq_axis``; returns this rank's output shard.  ``data_axis`` /
    ``head_axis``: see the module docstring."""
    del data_axis, head_axis
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _ring_body(axis_index(mesh, seq_axis), axis_size(mesh, seq_axis),
                      q.shape[1], axis_group(mesh, seq_axis), causal,
                      scale, q, k, v)


def ulysses_attention(q, k, v, mesh, seq_axis="seq", causal=False,
                      data_axis=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style) over
    this rank's (B_l, T / n, H, D) shards: reshard to (B_l, T, H / n,
    D), full local attention on the head group, reshard back.  Heads
    must divide by the axis size."""
    del data_axis
    group = axis_group(mesh, seq_axis)
    n = axis_size(mesh, seq_axis)
    if q.shape[2] % n:
        raise ValueError("heads %d not divisible by mesh axis %d" %
                         (q.shape[2], n))

    def spread(x):
        return collectives.all_to_all(x, group, split_dim=2, concat_dim=1)

    out = attention_reference(spread(q), spread(k), spread(v),
                              causal=causal)
    return collectives.all_to_all(out, group, split_dim=1, concat_dim=2)
