"""Numpy columns to tensors and back.

There are no weights: both packages consume the same numpy columns
(keys, values, validity, payload) made from a seed.  ``to_torch`` puts
them on a device with their dtype unchanged; ``to_numpy`` brings
tensors back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.device import DeviceLike, resolve_device


def to_torch(*arrays, device: DeviceLike = None) -> Tuple[torch.Tensor, ...]:
    """Each array as a contiguous tensor of the same dtype on ``device``
    (default CUDA).  ``None`` passes through."""
    dev = resolve_device(device)
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
        out.append(t.to(dev))
    return tuple(out)


def to_numpy(*tensors) -> Tuple[np.ndarray, ...]:
    """Each tensor as a host numpy array of the same dtype."""
    return tuple(
        None if t is None else t.detach().cpu().contiguous().numpy()
        for t in tensors
    )
