"""The shard-level hash exchange: the port of
``sparkrdma_tpu/ops/exchange.py::hash_exchange``.

Hash-partition this rank's (keys, vals, valid) columns into D buckets
of ``capacity`` and move every bucket to its owner with one
``all_to_all`` per column, over the exchange group of
``parallel/group.py``.  Padding (valid == 0) rides a trash bucket (id =
D) that is never exchanged, so it takes no real capacity and signals no
false overflow; bucket fill slots carry (dtype-max key, 0 value, 0
valid).  With one device every key already lives here, so the exchange
is the identity (outputs keep the input length, max_fill = 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkrdma_tpu_torch.ops.lexsort import unsigned_order
from sparkrdma_tpu_torch.ops.partition import (
    hash_partition_ids,
    partition_to_buckets_dropping,
)
from sparkrdma_tpu_torch.parallel.group import step_group


def hash_exchange(
    keys: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    n_devices: int,
    capacity: int,
    group=None,
    unsigned_keys: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (keys', vals', valid', max_fill): flat ``[D * capacity]``
    columns of everything this rank owns after the exchange (row s of
    the ``[D, capacity]`` layout came from rank s), and the largest TRUE
    bucket fill of this rank's map side (> capacity: overflow, the
    caller retries bigger).  ``group`` is the exchange group of D > 1
    ranks.  ``unsigned_keys``: the keys are uint32 carried as int32 bits
    in unsigned order (``models/_base.py::carry_keys``); the hash reads
    their uint32 bits, as the JAX package's does."""
    g = step_group(n_devices, group, "hash_exchange")
    if g is None:
        return keys, vals, valid, torch.zeros((), dtype=torch.int32,
                                              device=keys.device)
    ids = hash_partition_ids(unsigned_order(keys) if unsigned_keys else keys,
                             n_devices)
    (bk, bv, bm), counts = partition_to_buckets_dropping(
        ids, valid > 0, (keys, vals, valid), n_devices, capacity,
        fill_values=(torch.iinfo(keys.dtype).max, 0, 0),
    )
    ek, ev, em = (g.all_to_all(b).reshape(-1) for b in (bk, bv, bm))
    return ek, ev, em, counts.max()
