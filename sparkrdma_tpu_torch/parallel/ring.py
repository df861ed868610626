"""Ring exchange: the port of ``sparkrdma_tpu/parallel/ring.py``.

One ring hop moves rank r's tensor to rank (r + 1) mod D with one
``isend`` and one ``irecv`` (``dist.batch_isend_irecv``), where the JAX
package used ``ppermute``.  After D - 1 hops every rank has seen every
source's shard once, with at most two shards in flight, and a consumer
folds them one hop at a time (:meth:`RingExchange.ring_reduce`): the
schedule of ring attention.

The JAX package's ``supports_pallas_partition_id`` has no counterpart.
It probed whether ``axis_index`` could feed a Pallas kernel's offsets
inside a compiled scan; here the rank is a plain integer of the
process, and a kernel takes it as an argument.

``RingExchange`` works rank-locally: each process passes its own shard
and gets back what it alone holds, where the JAX class took the global
``[D, ...]`` array and returned ``[D, D, ...]``.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.parallel.group import ExchangeGroup, as_group


def _shift(x: torch.Tensor, group: ExchangeGroup, step: int) -> torch.Tensor:
    """Send ``x`` to rank + step and receive from rank - step (mod D)."""
    if group.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = group.global_rank((group.rank + step) % group.size)
    src = group.global_rank((group.rank - step) % group.size)
    ops = [dist.P2POp(dist.isend, x, dst, group.group),
           dist.P2POp(dist.irecv, out, src, group.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One ring hop: rank r's ``x`` goes to rank (r + 1) mod D, and the
    result is rank (r - 1)'s.  The identity at D = 1."""
    return _shift(x, as_group(group, x), 1)


def ring_shift_back(x: torch.Tensor, group=None) -> torch.Tensor:
    """One hop the other way: rank r's ``x`` goes to rank (r - 1) mod D."""
    return _shift(x, as_group(group, x), -1)


class RingExchange:
    """Ring data plane over an exchange group."""

    def __init__(self, group=None):
        self.group = as_group(group)
        self.n_devices = self.group.size

    def _hops(self, shard: torch.Tensor, reverse: bool) -> List[torch.Tensor]:
        step = -1 if reverse else 1
        seen = [shard]
        for _ in range(self.n_devices - 1):
            seen.append(_shift(seen[-1], self.group, step))
        return seen

    def all_shards(self, shard: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
        """Ring-collect: ``out[j]`` is the shard of source (rank - j)
        mod D (rank + j with ``reverse``), shape ``[D, *shard.shape]``.
        Every rank ends holding all shards, having moved one shard per
        hop."""
        return torch.stack(self._hops(shard, reverse))

    def ring_reduce(self, shard: torch.Tensor, init_fn: Callable,
                    consume: Callable):
        """Fold ``consume(acc, src, cur)`` over the D hops, starting from
        ``init_fn(shard)``; at hop j, ``cur`` is the shard of source
        ``src = (rank - j) mod D``.  Only the shard in hand and the one
        arriving are resident."""
        D, rank = self.n_devices, self.group.rank
        acc = init_fn(shard)
        cur = shard
        for j in range(D):
            acc = consume(acc, (rank - j) % D, cur)
            if j < D - 1:
                cur = _shift(cur, self.group, 1)
        return acc
