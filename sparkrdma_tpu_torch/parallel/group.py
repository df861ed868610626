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
world size and rank): nothing here discovers a cluster.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device


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
