"""TeraSort (sortByKey) on one GPU: the port of
``sparkrdma_tpu/models/terasort.py``.

This slice ports the ``n_devices == 1`` branches: a distributed sort on
one device IS the local sort, so sampling, windowing, the all_to_all
and the merge are skipped.  The output contract is kept: a run of
length ``capacity`` padded with the key dtype's max, ``n_valid``, and
``max_fill`` for the overflow retry.

Validity is a 0/1 column ordered as a secondary sort key, so padding
sorts after every real record of the same key: real keys equal to the
dtype max are not confused with padding.  ``lax.sort`` with
``num_keys=2`` becomes one sort on a packed int64 key for int32 keys,
or two stable sorts for int64 keys (``ops/lexsort.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.models._base import ExchangeModel, check_dtypes
from sparkrdma_tpu_torch.ops.lexsort import perm_by_key_invalid
from sparkrdma_tpu_torch.parallel.device import require_one_device


def _pad_rows(x: torch.Tensor, capacity: int, fill) -> torch.Tensor:
    """Trim or pad the leading dimension to ``capacity``."""
    pad = capacity - x.shape[0]
    if pad < 0:
        return x[:capacity]
    if pad == 0:
        return x
    tail = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def _local_sort_step(keys, vals, valid, n_devices: int, capacity: int):
    """One device's sort.  ``valid`` is int32 0/1 or None (everything
    valid, no validity operand).  Returns (keys' [capacity],
    vals' [capacity], n_valid int32[1], max_fill int32[1])."""
    require_one_device(n_devices, "TeraSort")
    n_local = keys.shape[0]
    sentinel = torch.iinfo(keys.dtype).max
    if valid is None:
        k, perm = torch.sort(keys, stable=True)
        v = vals[perm]
        n_real = torch.full((1,), n_local, dtype=torch.int32,
                            device=keys.device)
    else:
        inv = 1 - valid.to(torch.int32)
        keys = torch.where(valid > 0, keys, sentinel)
        perm = perm_by_key_invalid(keys, inv)
        k, v = keys[perm], vals[perm]
        n_real = valid.sum(dtype=torch.int32).reshape(1)
    k = _pad_rows(k, capacity, sentinel)
    v = _pad_rows(v, capacity, 0)
    n_valid = torch.clamp(n_real, max=capacity)
    max_fill = torch.full((1,), n_local, dtype=torch.int32, device=k.device)
    return k, v, n_valid, max_fill


def _local_sort_wide_step(keys, payload, n_devices: int, capacity: int):
    """Wide-record variant (the HiBench TeraSort shape): the key sort
    carries a row index, and the payload rows [n, W] follow by one row
    gather.  Returns (keys' [capacity], payload' [capacity, W],
    n_valid int32[1], max_fill int32[1])."""
    require_one_device(n_devices, "TeraSort")
    n_local = keys.shape[0]
    sentinel = torch.iinfo(keys.dtype).max
    k, perm = torch.sort(keys, stable=True)
    p = payload.index_select(0, perm)
    k = _pad_rows(k, capacity, sentinel)
    p = _pad_rows(p, capacity, 0)
    n_valid = torch.full((1,), min(n_local, capacity), dtype=torch.int32,
                         device=k.device)
    max_fill = torch.full((1,), n_local, dtype=torch.int32, device=k.device)
    return k, p, n_valid, max_fill


class TeraSorter(ExchangeModel):
    """Host-facing driver for the sort (the sortByKey job)."""

    def __init__(self, device=None, capacity_factor: float = 1.3, **kw):
        super().__init__(device, capacity_factor, **kw)

    def sort_device(self, keys: torch.Tensor, vals: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    capacity: Optional[int] = None):
        """One sort step on device tensors whose length divides D.
        Returns ((keys', vals', n_valid[1], max_fill[1]), capacity);
        nothing is synchronised."""
        n = keys.shape[0]
        if n % self.n_devices:
            raise ValueError(f"length {n} not divisible by D={self.n_devices}")
        check_dtypes(keys=keys, vals=vals)
        cap = capacity or self._capacity(n // self.n_devices)
        keys, vals, valid = self._to_device(keys, vals, valid)
        return _local_sort_step(keys, vals, valid, self.n_devices, cap), cap

    def sort_device_wide(self, keys: torch.Tensor, payload: torch.Tensor,
                         capacity: Optional[int] = None):
        """Wide-record sort step (HiBench shape): ``payload`` is [n, W]
        rows that follow their keys.  Returns ((keys', payload' [cap, W],
        n_valid[1], max_fill[1]), capacity)."""
        n = keys.shape[0]
        if n % self.n_devices:
            raise ValueError(f"length {n} not divisible by D={self.n_devices}")
        if payload.dim() != 2 or payload.shape[0] != n:
            raise ValueError(f"payload must be [n, W], got {payload.shape}")
        check_dtypes(keys=keys)
        cap = capacity or self._capacity(n // self.n_devices)
        keys, payload = self._to_device(keys, payload)
        out = _local_sort_wide_step(keys, payload, self.n_devices, cap)
        return out, cap

    def sort(self, keys, vals=None) -> Tuple[np.ndarray, np.ndarray]:
        """Full host-facing sortByKey: returns (sorted_keys, sorted_vals)."""
        keys = np.asarray(keys)
        vals = np.zeros_like(keys) if vals is None else np.asarray(vals)
        if keys.shape != vals.shape or keys.ndim != 1:
            raise ValueError("keys/vals must be equal-length 1-D arrays")
        check_dtypes(keys=keys, vals=vals)
        n = keys.shape[0]
        if n == 0:
            return keys.copy(), vals.copy()
        D = self.n_devices
        n_pad = self._padded_length(n) - n
        valid = None
        if n_pad:
            sentinel = np.iinfo(keys.dtype).max
            keys = np.concatenate([keys, np.full(n_pad, sentinel, keys.dtype)])
            vals = np.concatenate([vals, np.zeros(n_pad, vals.dtype)])
            valid = np.ones(n + n_pad, np.int32)
            valid[n:] = 0
        tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
        tval = None if valid is None else torch.from_numpy(valid)
        tk, tv, tval = self._to_device(tk, tv, tval)

        def run(cap):
            (sk, sv, n_valid, max_fill), _ = self.sort_device(
                tk, tv, tval, capacity=cap
            )
            return (sk, sv, n_valid), max_fill

        sk, sv, n_valid = self._run_with_overflow_retry(n + n_pad, run)
        sk_h = sk.cpu().numpy().reshape(D, -1)
        sv_h = sv.cpu().numpy().reshape(D, -1)
        nv = n_valid.cpu().numpy().reshape(-1)
        out_k = np.concatenate([sk_h[d, : nv[d]] for d in range(D)])
        out_v = np.concatenate([sv_h[d, : nv[d]] for d in range(D)])
        return out_k, out_v
