"""The exchange group: the counterpart of ``sparkrdma_tpu/parallel/mesh.py``.

The JAX package fixes a 1-D ``Mesh`` whose one axis, ``EXCHANGE_AXIS``
("x"), carries every collective; ``make_mesh(D)`` builds it over D
devices, and code inside ``shard_map`` reads its index on that axis with
``axis_index``.  The port runs one process per GPU instead: the mesh
axis is a ``torch.distributed`` process group, ``make_mesh(D)`` is a
group of world size D, and ``axis_index(EXCHANGE_AXIS)`` is the plain
integer :attr:`ExchangeGroup.rank`.

``ExchangeGroup()`` with no group is a world of one on the caller's
device (CUDA unless the caller asks for the CPU; it raises without
CUDA).  Otherwise it wraps an initialised process group: NCCL on the
cards, gloo in the CPU tests.  The caller initialises that group
itself (``torch.distributed.init_process_group`` with its address,
world size and rank, after ``torch.cuda.set_device(rank)`` on the
cards): nothing here discovers a cluster.

The collectives of the shuffle, each the identity at size 1:

- :meth:`ExchangeGroup.all_to_all`, ``lax.all_to_all(split_axis=0,
  concat_axis=0)``: row d of a ``[D, ...]`` tensor goes to rank d;
- :meth:`ExchangeGroup.all_gather`, ``lax.all_gather``;
- :meth:`ExchangeGroup.agree_max`, an integer all-reduce max on the
  host: how the ranks agree on shapes and on an overflow retry before
  the next collective, where the JAX host saw every device at once.

At size > 1, ``all_to_all`` and ``all_gather`` each run inside the
stage range ``exchange.all_to_all`` / ``exchange.all_gather``
(``utils/trace.py``: the copy to a contiguous input and the output
allocation included) and add the bytes this rank sends to other ranks
to the registry's ``exchange_bytes_total{op=}``: ``(D - 1) / D`` of an
``all_to_all``'s ``[D, ...]`` block, ``D - 1`` times an
``all_gather``'s input.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.parallel.device import (
    DeviceLike,
    one_process_per_gpu,
    resolve_device,
)
from sparkrdma_tpu_torch.utils.trace import stage


# all_gather_into_tensor, under the name newer releases give it
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


class ExchangeGroup:
    """``rank`` and ``size`` of one process in its exchange group, and
    the ``device`` its tensors live on."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 device: DeviceLike = None):
        self.device: torch.device = resolve_device(device)
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)

    def global_rank(self, rank: int) -> int:
        """The world rank of ``rank`` in this group (peers of
        point-to-point ops are named by world rank)."""
        return dist.get_global_rank(self.group, rank)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` is ``[D, ...]``: row d goes to rank d, and row s of the
        result is what rank s sent here (``all_to_all_single``)."""
        if self.size == 1:
            return x
        if x.shape[0] != self.size:
            raise ValueError(
                f"all_to_all takes [{self.size}, ...], got {tuple(x.shape)}")
        counter("exchange_bytes_total", op="all_to_all").inc(
            x.nbytes // self.size * (self.size - 1))
        with stage("exchange.all_to_all"):
            x = x.contiguous()
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[D, *x.shape]``: row s is rank s's ``x``, at least 1-D
        (``all_gather_into_tensor``)."""
        if self.size == 1:
            return x[None]
        counter("exchange_bytes_total", op="all_gather").inc(
            x.nbytes * (self.size - 1))
        with stage("exchange.all_gather"):
            out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
            _all_gather_single(out, x.contiguous(), group=self.group)
        return out.view(self.size, *x.shape)

    def agree_max(self, *values: int) -> List[int]:
        """The largest of each integer over the ranks (one all-reduce;
        negate for a minimum).  Every rank must call it with as many
        values."""
        if self.size == 1:
            return [int(v) for v in values]
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return [int(v) for v in t.tolist()]

    def __repr__(self) -> str:
        return (f"ExchangeGroup(rank={self.rank}, size={self.size}, "
                f"device={self.device})")


def as_group(group, like=None) -> ExchangeGroup:
    """``group`` as an :class:`ExchangeGroup`.  ``None`` is a world of
    one, and a ``torch.distributed`` process group is wrapped; either
    lives on the device of ``like`` when it is a tensor, else on
    CUDA."""
    if isinstance(group, ExchangeGroup):
        return group
    device = like.device if isinstance(like, torch.Tensor) else None
    return ExchangeGroup(group, device=device)


def step_group(n_devices: int, group, what: str) -> Optional[ExchangeGroup]:
    """The group a step over ``n_devices`` exchanges over: ``None`` at
    one device, else ``group`` (an :class:`ExchangeGroup` or a process
    group, wrapped on CUDA) of exactly that size.  Without one, a step
    over more devices raises ``ValueError``."""
    if group is None:
        if n_devices != 1:
            raise ValueError(one_process_per_gpu(what, n_devices))
        return None
    g = as_group(group)
    if g.size != n_devices:
        raise ValueError(
            f"{what} made for {n_devices} devices got a group of {g.size}")
    return None if n_devices == 1 else g


def world_group(device: DeviceLike = None) -> ExchangeGroup:
    """The initialised ``torch.distributed`` world as an exchange group
    on ``device`` (its ranks are the D of a job launched one process per
    GPU), or a world of one when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return ExchangeGroup(device=device)
    return ExchangeGroup(dist.group.WORLD, device=device)
