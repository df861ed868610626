"""The shard-level hash exchange: the port of
``sparkrdma_tpu/ops/exchange.py::hash_exchange``, one device only.

With one device every key already lives here, so the exchange is the
identity (outputs keep the input length, max_fill = 0).  The multi-GPU
exchange over ``torch.distributed`` is a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkrdma_tpu_torch.parallel.device import MULTI_GPU_ITEM


def hash_exchange(
    keys: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    n_devices: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (keys', vals', valid', max_fill) of everything this
    device owns after the exchange."""
    if n_devices != 1:
        raise NotImplementedError(
            f"hash_exchange over {n_devices} devices is not ported yet "
            f"({MULTI_GPU_ITEM})"
        )
    return keys, vals, valid, torch.zeros((), dtype=torch.int32,
                                          device=keys.device)
