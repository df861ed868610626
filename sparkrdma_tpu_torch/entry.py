"""The port's compile entry: the counterpart of ``__graft_entry__.entry``.

``entry()`` returns ``(fn, example_args)``: the forward step of the
flagship model, one distributed-sort step (sample, range partition,
all_to_all, local sort; ``models/terasort.py::make_sort_step``) over
this rank's 8192 rows, and seeded int32 keys, values and the validity
mask for it, on the card unless the caller passes ``device="cpu"``.
``fn(*example_args)`` returns ``(keys' [D * capacity], vals', n_valid[1],
max_fill[1])``.

D is the size of the ``torch.distributed`` world when one is initialised
(one process per card, NCCL), else 1; at D > 1 each rank's args are its
contiguous shard of the seeded ``D * 8192`` rows, and the step exchanges
over the world.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.models.terasort import make_sort_step
from sparkrdma_tpu_torch.parallel.device import DeviceLike
from sparkrdma_tpu_torch.parallel.group import world_group

N_LOCAL = 8192
SAMPLE_SIZE = 256


Args = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def entry(device: DeviceLike = None) -> Tuple[Callable, Args]:
    """(fn, example_args) of one sort step on this rank's shard."""
    group = world_group(device)
    n_devices, rank = group.size, group.rank
    capacity = ((N_LOCAL // n_devices * 2) + 7) // 8 * 8
    fn = make_sort_step(n_devices, N_LOCAL, capacity,
                        sample_size=SAMPLE_SIZE, group=group)
    rng = np.random.default_rng(0)
    n = n_devices * N_LOCAL
    mine = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
    keys = rng.integers(0, 1 << 31, size=n, dtype=np.int32)[mine]
    vals = rng.integers(0, 1 << 31, size=n, dtype=np.int32)[mine]
    valid = np.ones(N_LOCAL, np.int32)
    return fn, tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(group.device)
        for x in (keys, vals, valid))
