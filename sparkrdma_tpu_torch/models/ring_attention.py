"""Sequence-parallel attention: the port of
``sparkrdma_tpu/models/ring_attention.py``, ring and Ulysses schedules.

Each process holds the local shard ``[..., S/D, d]`` of q, k and v (the
sequence axis split over the D ranks of the exchange group in rank
order) and gets back its local shard of the output, where the JAX
package took the global arrays and sharded them over a mesh.  With
``group=None`` (D = 1) local is global.

- :func:`ring_attention`: K/V shards circulate one ring hop per step
  (``parallel/ring.py``).  At hop j the shard in hand is that of source
  ``src = (rank - j) mod D``; ``block_attention`` computes the partials
  of the local queries against it with global offsets
  ``q_offset = rank * s_local`` and ``k_offset = src * s_local``, and
  :func:`fold_partials` folds them into the running ``(m, l, o)``.
- :func:`ulysses_attention`: one ``all_to_all_single`` turns sequence
  sharding into head sharding (each rank gets N/D full-length heads),
  one ``block_attention`` call over the whole sequence is full flash
  attention per head, and the inverse ``all_to_all_single`` restores
  sequence sharding.

Both are exact attention (the online rescaling is exact, not an
approximation); causal masking uses global positions.  The fold and the
collectives are plain torch, as the JAX package left them to XLA; the
K/V hop is not overlapped with compute.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.ops.attention import block_attention
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup, as_group
from sparkrdma_tpu_torch.parallel.ring import ring_shift


def fold_partials(m, l, o, m_blk, l_blk, o_blk):
    """The exact online-softmax fold of one block's partials into the
    running ``(m, l, o)``.  Rows fully masked in the block carry
    ``m_blk = NEG_INF``, so ``beta = 0`` removes their partials."""
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_blk - m_new)
    l_new = l * alpha + l_blk * beta
    o_new = o * alpha[..., None] + o_blk * beta[..., None]
    return m_new, l_new, o_new


def normalize(o: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    """``o / l`` in q's dtype; ``l`` floored at 1e-30 as in the JAX
    package (only a pathological non-causal row can reach 0)."""
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def _canonicalize(q, k, v, group):
    """Tensors on the group's device, leading dims flattened to one
    batch-head axis: ``[..., s, d] -> [N, s, d]``."""
    q, k, v = (torch.as_tensor(x, device=group.device) for x in (q, k, v))
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share a shape")
    if q.dim() < 2:
        raise ValueError(f"need [..., S, d_head], got {tuple(q.shape)}")
    s_local, d_head = q.shape[-2], q.shape[-1]
    q3, k3, v3 = (x.reshape(-1, s_local, d_head) for x in (q, k, v))
    return q3, k3, v3, q.shape, q.dtype


def ring_attention(q, k, v, group=None, causal: bool = False) -> torch.Tensor:
    """Exact attention over sequences sharded on the group, K/V
    circulating the ring.

    q, k, v: this rank's shard ``[S/D, d_head]`` or ``[..., S/D,
    d_head]`` (leading batch/head dims), tensors or numpy arrays.
    Returns this rank's shard of ``softmax(q k^T / sqrt(d)) v``, shaped
    and typed like q.  ``group`` is an :class:`ExchangeGroup`, a
    ``torch.distributed`` process group, or None for a world of one.
    """
    g = as_group(group, q)
    q3, k3, v3, shape, dtype = _canonicalize(q, k, v, g)
    s_local, d_head = q3.shape[1], q3.shape[2]
    D, rank = g.size, g.rank
    scale = 1.0 / math.sqrt(d_head)
    cur_k, cur_v = k3, v3
    for j in range(D):
        src = (rank - j) % D
        part = block_attention(q3, cur_k, cur_v, q_offset=rank * s_local,
                               k_offset=src * s_local, causal=causal,
                               scale=scale)
        # folding the first hop into (NEG_INF, 0, 0) returns its
        # partials bit for bit, so they start the accumulator
        acc = part if j == 0 else fold_partials(*acc, *part)
        if j < D - 1:
            cur_k, cur_v = ring_shift(cur_k, g), ring_shift(cur_v, g)
    m, l, o = acc
    return normalize(o, l, dtype).reshape(shape)


def _all_to_all(x: torch.Tensor, group: ExchangeGroup) -> torch.Tensor:
    """``out[src] = x[rank]`` of rank src, over the leading axis of size
    D.  bfloat16 travels as its bytes: gloo's all-to-all refuses
    16-bit types."""
    send = x.contiguous()
    wire = send.view(torch.uint8) if send.dtype == torch.bfloat16 else send
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group.group)
    return recv.view(x.dtype)


def ulysses_attention(q, k, v, group=None,
                      causal: bool = False) -> torch.Tensor:
    """Exact attention via the Ulysses (all-to-all head-parallel)
    schedule: the batch-head product N of the leading dims must divide
    by D.

    q, k, v: this rank's shard ``[..., H, S/D, d_head]``.  Returns this
    rank's output shard, shaped and typed like q.
    """
    g = as_group(group, q)
    D = g.size
    q3, k3, v3, shape, dtype = _canonicalize(q, k, v, g)
    N, s_local, d_head = q3.shape
    if N % D:
        raise ValueError(
            f"batch·head product {N} not divisible by D={D} "
            "(the Ulysses schedule shards heads; use ring_attention "
            "when heads < devices)"
        )

    def to_heads(x):  # [N, s_local, d] -> [N/D, S, d]
        if D == 1:
            return x
        got = _all_to_all(x.reshape(D, N // D, s_local, d_head), g)
        return got.transpose(0, 1).reshape(N // D, D * s_local, d_head)

    qh, kh, vh = to_heads(q3), to_heads(k3), to_heads(v3)
    _m, l, o = block_attention(qh, kh, vh, q_offset=0, k_offset=0,
                               causal=causal, scale=1.0 / math.sqrt(d_head))
    out = normalize(o, l, dtype)
    if D > 1:  # [N/D, S, d] -> [N, s_local, d]
        out = out.reshape(N // D, D, s_local, d_head).transpose(0, 1)
        out = _all_to_all(out, g).reshape(N, s_local, d_head)
    return out.reshape(shape)
