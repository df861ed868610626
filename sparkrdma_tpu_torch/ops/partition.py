"""On-device partitioning, the map side of the shuffle: the port of
``sparkrdma_tpu/ops/partition.py``.

Compute a partition id per element (hash or range), then bucket the
elements into a ``[n_parts, capacity]`` layout that an all-to-all can
move.  Buckets are capacity-padded, and overflow is detected (count >
capacity), not spilled: callers re-run with a larger capacity.

The JAX package computes the murmur3 finalizer in uint32.  PyTorch has
no uint32 arithmetic, so it runs here in int64 masked to 32 bits, bit
for bit the same.  The grouping sort is stable (JAX's is not), so rows
within a bucket may come in another order than in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparkrdma_tpu_torch.ops.scan_kernels import cumsum_1d

_MASK32 = (1 << 32) - 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32) held in int64,
    with no int64 product past 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_partition_ids(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Partition id per integer key (the HashPartitioner analog): the
    murmur3 finalizer of the key's low 32 bits, modulo ``n_parts``."""
    if keys.dtype.is_floating_point:
        raise ValueError("hash_partition_ids takes integer keys")
    x = keys.to(torch.int64) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x % n_parts).to(torch.int32)


def make_range_splitters(sample: torch.Tensor, n_parts: int) -> torch.Tensor:
    """``n_parts - 1`` ascending splitters from a key sample (the
    RangePartitioner analog): equal-frequency quantiles."""
    sorted_sample = torch.sort(sample).values
    n = sorted_sample.shape[0]
    idx = (torch.arange(1, n_parts, device=sample.device) * n) // n_parts
    return sorted_sample[idx.clamp(0, n - 1)]


def range_partition_ids(keys: torch.Tensor,
                        splitters: torch.Tensor) -> torch.Tensor:
    """Partition id = number of splitters <= key (part 0 gets keys below
    ``splitters[0]``)."""
    dt = torch.promote_types(keys.dtype, splitters.dtype)
    return torch.searchsorted(splitters.to(dt), keys.to(dt),
                              right=True).to(torch.int32)


def _default_fill(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _window_copy(sorted_arr: torch.Tensor, starts: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """Windows ``[starts[p], starts[p] + capacity)`` of ``sorted_arr`` as
    a ``[len(starts), capacity]`` layout, by one gather; the tail is
    padded so no window runs off the end."""
    src = torch.cat([sorted_arr, sorted_arr.new_zeros(capacity)])
    slot = torch.arange(capacity, device=starts.device)
    return src[starts.to(torch.int64)[:, None] + slot[None, :]]


def partition_to_buckets(
    part_ids: torch.Tensor,
    values: Tuple[torch.Tensor, ...],
    n_parts: int,
    capacity: int,
    fill_values: Optional[Tuple] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Bucket elements into a ``[n_parts, capacity]`` padded layout.

    ``values`` are arrays ``[n, ...]`` permuted together; ``fill_values``
    default to the dtype max for the first (a sentinel that sorts last)
    and 0 for the rest.  Elements past a bucket's capacity are dropped.
    Returns ``(bucketed, counts)``: ``bucketed[i]`` is ``[n_parts,
    capacity, ...]``, ``counts`` the int32 TRUE counts per bucket (above
    capacity on overflow).
    """
    n = part_ids.shape[0]
    dev = part_ids.device
    if fill_values is None:
        fill_values = tuple(_default_fill(v.dtype) if i == 0 else 0
                            for i, v in enumerate(values))
    if n == 0:
        counts = torch.zeros(n_parts, dtype=torch.int32, device=dev)
        bucketed = tuple(
            torch.full((n_parts, capacity, *v.shape[1:]), fill,
                       dtype=v.dtype, device=dev)
            for v, fill in zip(values, fill_values))
        return bucketed, counts
    sorted_ids, perm = torch.sort(part_ids.to(torch.int32), stable=True)
    edges = torch.searchsorted(
        sorted_ids, torch.arange(n_parts + 1, dtype=torch.int32, device=dev))
    counts = (edges[1:] - edges[:-1]).to(torch.int32)
    starts = edges[:-1]
    slot = torch.arange(capacity, device=dev)
    valid = slot[None, :] < counts.clamp(max=capacity)[:, None]
    bucketed = []
    for v, fill in zip(values, fill_values):
        if v.dim() == 1:
            b = _window_copy(v[perm], starts, capacity)
            b = torch.where(valid, b, torch.as_tensor(fill, dtype=v.dtype,
                                                      device=dev))
        else:
            idx = (starts.to(torch.int64)[:, None] + slot[None, :]).clamp(
                0, n - 1)
            b = v[perm[idx]]
            mask = valid.reshape(valid.shape + (1,) * (v.dim() - 1))
            b = torch.where(mask, b, torch.as_tensor(fill, dtype=v.dtype,
                                                     device=dev))
        bucketed.append(b)
    return tuple(bucketed), counts


def partition_to_buckets_dropping(
    part_ids: torch.Tensor,
    keep: torch.Tensor,
    values: Tuple[torch.Tensor, ...],
    n_parts: int,
    capacity: int,
    fill_values: Optional[Tuple] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """:func:`partition_to_buckets` with a trash bucket: rows whose
    ``keep`` (bool) is false go to bucket ``n_parts``, which is sliced
    off the outputs and the counts, so they take no real capacity and
    signal no false overflow."""
    ids = torch.where(keep, part_ids.to(torch.int32), n_parts)
    bucketed, counts = partition_to_buckets(ids, values, n_parts + 1,
                                            capacity, fill_values)
    return tuple(b[:n_parts] for b in bucketed), counts[:n_parts]


def bucketize_segments(
    part_ids: torch.Tensor,
    values: Tuple[torch.Tensor, ...],
    n_parts: int,
    capacity: int,
    fill_values: Optional[Tuple] = None,
    sort_within: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """:func:`partition_to_buckets` plus the int32 ``[n_parts + 1]``
    EXCLUSIVE prefix sum of the capacity-clamped counts (the exchange
    plan's row offsets).  ``sort_within=True`` sorts each bucket by the
    first value column (1-D columns only); pad slots hold the dtype max
    and stay at the tail."""
    bucketed, counts = partition_to_buckets(part_ids, values, n_parts,
                                            capacity, fill_values)
    clamped = counts.clamp(max=capacity)
    offsets = torch.cat([clamped.new_zeros(1), cumsum_1d(clamped)])
    if sort_within:
        if any(b.dim() != 2 for b in bucketed):
            raise ValueError(
                "sort_within requires 1-D value columns (buckets are "
                "[n_parts, capacity]); gather multi-dim payloads after "
                "the key sort instead"
            )
        first, order = torch.sort(bucketed[0], dim=1, stable=True)
        bucketed = (first,) + tuple(torch.gather(b, 1, order)
                                    for b in bucketed[1:])
    return tuple(bucketed), counts, offsets
