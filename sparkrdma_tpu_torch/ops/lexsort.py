"""Multi-column sorts: the counterpart of ``lax.sort`` with
``num_keys > 1``, which PyTorch lacks.

The port sorts rows by three column shapes only: (key, invalid),
(key, value) and (key, invalid, value), with ``invalid`` a 0/1 column.
An int32 key packs with ``invalid`` into one int64 sort key
``(key << 1) | invalid``, and an int32 key with an int32 value into
``(key << 32) | (value + 2**31)``.  Anything wider runs as stable sorts
in sequence, least significant column first.  Every sort is stable, so
rows equal in every column keep their input order.  (The JAX package
sorts with ``is_stable=False``; tests compare within equal keys
canonically.)
"""

from __future__ import annotations

from typing import List

import torch

_BIAS32 = 1 << 31


def _chain(sort_keys: List[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting ascending by ``sort_keys`` (most significant
    first), by one stable sort per key, least significant first."""
    perm = None
    for key in reversed(sort_keys):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _key_invalid(keys: torch.Tensor, invalid: torch.Tensor):
    if keys.dtype == torch.int32:
        return [(keys.to(torch.int64) << 1) | invalid.to(torch.int64)]
    return [keys, invalid]


def perm_by_key_invalid(keys: torch.Tensor,
                        invalid: torch.Tensor) -> torch.Tensor:
    """Rows by key, then by the 0/1 ``invalid`` column."""
    return _chain(_key_invalid(keys, invalid))


def perm_by_key_value(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Rows by key, then by value."""
    if keys.dtype == torch.int32 and vals.dtype == torch.int32:
        return _chain([(keys.to(torch.int64) << 32)
                       | (vals.to(torch.int64) + _BIAS32)])
    return _chain([keys, vals])


def perm_by_key_invalid_value(keys: torch.Tensor, invalid: torch.Tensor,
                              vals: torch.Tensor) -> torch.Tensor:
    """Rows by key, then by the 0/1 ``invalid`` column, then by value."""
    return _chain(_key_invalid(keys, invalid) + [vals])
