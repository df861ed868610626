"""Columnar record batches: the unsafe-row analog for the record plane.

The reference keeps its map-side hot loop off slow object paths by
wrapping Spark's ``UnsafeShuffleWriter`` — records stay in serialized
row form end to end (RdmaWrapperShuffleWriter.scala:85-101).  The
TPU-native record plane gets the same property from columns: a
:class:`ColumnBatch` holds one batch of (key, value) records as two
parallel numpy arrays, so partitioning, serialization, combining, and
grouping are all vectorized numpy kernels instead of per-record Python.

Value columns may be any fixed-width dtype — numeric, ``|SN`` byte
strings (the classic 10-90 byte shuffle payload), or structured rows.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Optional, Tuple

import numpy as np


class ColumnBatch:
    """One batch of records as parallel (keys, vals) columns.

    ``key_sorted`` marks a batch whose rows are already in ascending
    key order — writers set it after map-side bucket sorting, it rides
    the wire in the frame flags, and sorted-aware readers merge such
    runs with views instead of re-sorting (the gather is the record
    plane's most expensive kernel)."""

    __slots__ = ("keys", "vals", "key_sorted")

    def __init__(self, keys: np.ndarray, vals: np.ndarray,
                 key_sorted: bool = False):
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        if keys.ndim != 1 or vals.ndim != 1 or keys.shape[0] != vals.shape[0]:
            raise ValueError(
                f"keys/vals must be equal-length 1-D columns, got "
                f"{keys.shape} / {vals.shape}"
            )
        if keys.dtype.hasobject or vals.dtype.hasobject:
            raise TypeError(
                "object-dtype columns defeat the columnar plane; use the "
                "tuple record path for non-fixed-width records"
            )
        if vals.dtype.kind == "S" and vals.dtype.itemsize:
            # numpy bytes-strings ('S') strip trailing NULs on every
            # element extraction, silently corrupting raw payloads;
            # reinterpret as void rows of the same width — exact bytes,
            # zero-copy.  (Keys keep 'S' semantics: their padded
            # comparison is what hashing and ordering want.)
            vals = vals.view(f"V{vals.dtype.itemsize}")
        self.keys = keys
        self.vals = vals
        self.key_sorted = key_sorted

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.keys.nbytes + self.vals.nbytes)

    def __iter__(self) -> Iterator[Tuple]:
        """Record view (slow path, for plane interop): yields Python
        (key, value) scalars."""
        yield from zip(self.keys.tolist(), self.vals.tolist())

    @classmethod
    def from_records(
        cls,
        records: Iterable[Tuple],
        key_dtype=None,
        val_dtype=None,
    ) -> "ColumnBatch":
        """Pack an iterable of (k, v) tuples into columns (dtype
        inferred by numpy unless given)."""
        ks: List = []
        vs: List = []
        for k, v in records:
            ks.append(k)
            vs.append(v)
        keys = np.asarray(ks, dtype=key_dtype)
        vals = np.asarray(vs, dtype=val_dtype)
        return cls(keys, vals)


def concat_batches(batches: List[ColumnBatch]) -> Optional[ColumnBatch]:
    """Concatenate batches into one (None for an empty list)."""
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    return ColumnBatch(
        np.concatenate([b.keys for b in batches]),
        np.concatenate([b.vals for b in batches]),
    )


_REDUCE_UFUNCS = {
    "sum": np.add,
    "min": np.minimum,
    "max": np.maximum,
}


def take_rows(col: np.ndarray, idx: np.ndarray,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """``col[idx]`` through the native prefetching row gather when
    eligible (the record plane's hottest kernel); falls back to ``np.take``."""
    from sparkrdma_tpu_torch.memory.staging import native_row_gather

    if out is None:
        out = np.empty(idx.shape[0], col.dtype)
    if not native_row_gather(col, idx, out):
        np.take(col, idx, out=out)
    return out


def stable_key_order(keys: np.ndarray) -> np.ndarray:
    """Stable argsort choosing the fastest path: integer keys spanning
    < 2^16 values (partition ids, modest-cardinality group keys) rebase
    to uint16 where numpy's stable sort is RADIX (faster than the int64
    timsort path); WIDE-range int64 keys (the TeraSort shape) ride the
    native 64-bit LSD radix argsort."""
    if len(keys) and np.issubdtype(keys.dtype, np.integer):
        kmin = keys.min()
        if int(keys.max()) - int(kmin) < (1 << 16):
            return np.argsort(
                (keys - kmin).astype(np.uint16), kind="stable"
            )
        if keys.dtype == np.int64 and len(keys) >= (1 << 14):
            from sparkrdma_tpu_torch.memory.staging import (
                native_radix_argsort,
                native_rank_compress,
            )

            # wide RANGE but low CARDINALITY (the groupByKey shape):
            # compress keys to dense sorted uint16 ranks and ride the
            # radix path above instead of the 4-pass 64-bit radix;
            # the probe self-aborts early on high-cardinality columns
            res = native_rank_compress(keys)
            if res is not None:
                return np.argsort(res[0], kind="stable")
            order = native_radix_argsort(keys)
            if order is not None:
                return order
    return np.argsort(keys, kind="stable")


def _run_heads(sorted_keys: np.ndarray) -> np.ndarray:
    """Indices of the first row of each key run in a key-sorted column."""
    heads = np.empty(len(sorted_keys), bool)
    heads[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=heads[1:])
    return np.flatnonzero(heads)


def combine_columns(batch: ColumnBatch, kind: str) -> ColumnBatch:
    """Vectorized reduce-by-key over one batch: sort by key, then one
    ``ufunc.reduceat`` per run — the columnar combiner the tuple plane
    does per record through ``Aggregator.merge_value``."""
    if kind == "group":
        return batch  # grouping collects, nothing to reduce map-side
    ufunc = _REDUCE_UFUNCS[kind]
    if len(batch) == 0:
        return batch
    if batch.key_sorted:
        sk, sv = batch.keys, batch.vals
    else:
        order = stable_key_order(batch.keys)
        sk = take_rows(batch.keys, order)
        sv = take_rows(batch.vals, order)
    idx = _run_heads(sk)
    return ColumnBatch(sk[idx], ufunc.reduceat(sv, idx), key_sorted=True)


def group_columns(batch: ColumnBatch,
                  order: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Vectorized group-by-key: returns (unique_keys, per-key value
    arrays) — group_by_key's output with numpy arrays standing in for
    the tuple plane's Python lists.  A ``key_sorted`` batch skips the
    sort+gather entirely (value arrays are then VIEWS into the batch);
    callers holding a precomputed stable key order (e.g. the sorted-run
    merge over concatenated key-sorted blocks) pass it as ``order`` to
    skip just the sort."""
    if batch.key_sorted:
        sk, sv = batch.keys, batch.vals
    else:
        if order is None:
            order = stable_key_order(batch.keys)
        sk = take_rows(batch.keys, order)
        sv = take_rows(batch.vals, order)
    idx = _run_heads(sk)
    return sk[idx], np.split(sv, idx[1:])


def sorted_runs_order(batches, cat: ColumnBatch):
    """Stable merge order over ``cat`` = concat of the (key-sorted)
    ``batches`` via the native loser tree — None when ineligible (the
    caller falls back to a full sort).  A single sorted run is the
    identity order; K runs merge in K log K compares per row."""
    if not batches or not all(b.key_sorted for b in batches):
        return None
    if len(batches) == 1:
        return np.arange(len(cat.keys), dtype=np.int64)
    if cat.keys.dtype != np.int64:
        return None
    from sparkrdma_tpu_torch.memory.staging import native_kway_merge

    offs = np.zeros(len(batches) + 1, np.int64)
    np.cumsum([len(b) for b in batches], out=offs[1:])
    return native_kway_merge(np.ascontiguousarray(cat.keys), offs)


def sort_batch(batch: ColumnBatch) -> ColumnBatch:
    """Stable key sort of one batch (gather per block — the unit the
    decode pipeline parallelizes across workers)."""
    if batch.key_sorted or len(batch) <= 1:
        return ColumnBatch(batch.keys, batch.vals, key_sorted=True)
    order = stable_key_order(batch.keys)
    return ColumnBatch(
        take_rows(batch.keys, order), take_rows(batch.vals, order),
        key_sorted=True,
    )


def iter_batch_records(batch: ColumnBatch,
                       chunk: int = 1 << 16) -> Iterator[Tuple]:
    """Chunked record view of one batch: (k, v) scalars materialize
    ``chunk`` rows at a time instead of two whole-column ``tolist``
    calls — the streaming surface the k-way merge yields through."""
    n = len(batch)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        yield from zip(
            batch.keys[lo:hi].tolist(), batch.vals[lo:hi].tolist()
        )


def iter_merged_sorted_batches(batches: List[ColumnBatch],
                               chunk: int = 1 << 16) -> Iterator[Tuple]:
    """Streaming k-way merge over per-block sorted runs — the read-side
    order-by stage without the materialize-then-sort: unsorted batches
    stable-sort ONCE per block (already done in the decode workers on
    the pipelined path), then the runs merge lazily.  int64 keys ride
    the native loser tree for the merge ORDER (keys-only concat) with
    the gather+tolist chunked, so peak residency is numpy columns plus
    one chunk of record objects instead of the whole partition's tuple
    list; other key dtypes heap-merge the chunked record iterators.
    The emitted sequence is bit-identical to a stable global sort of
    the concatenated batches (stable per-run sort + run-order-stable
    merge)."""
    import heapq

    nonempty = [
        b if b.key_sorted else sort_batch(b) for b in batches if len(b)
    ]
    if not nonempty:
        return
    if len(nonempty) == 1:
        yield from iter_batch_records(nonempty[0], chunk)
        return
    cat = concat_batches(nonempty)
    order = sorted_runs_order(nonempty, cat)
    if order is None and len(cat) > chunk:
        # no native loser tree for this key dtype: a vectorized stable
        # sort over the (run-structured) concat beats a Python-level
        # heap walk for anything sizable, and the stability argument
        # keeps the sequence identical either way
        order = stable_key_order(cat.keys)
    if order is not None:
        keys, vals = cat.keys, cat.vals
        for lo in range(0, len(order), chunk):
            ci = order[lo : lo + chunk]
            yield from zip(keys[ci].tolist(), vals[ci].tolist())
        return
    yield from heapq.merge(
        *[iter_batch_records(b, chunk) for b in nonempty],
        key=lambda kv: kv[0],
    )


def merge_sorted_groups(
    per_batch: List[Tuple[np.ndarray, List[np.ndarray]]],
) -> Iterator[Tuple[Any, np.ndarray]]:
    """Group-by-key over pre-grouped (unique_keys, value-views) runs —
    the read-side merge for KEY-SORTED blocks, skipping the global
    concat+gather (the record plane's most expensive kernel).  Worth it
    when total unique keys is modest (the per-key Python loop); callers
    guard on cardinality and fall back to ``group_columns`` over a
    concat otherwise."""
    groups: "dict" = {}
    for uk, splits in per_batch:
        for k, v in zip(uk.tolist(), splits):
            lst = groups.get(k)
            if lst is None:
                groups[k] = [v]
            else:
                lst.append(v)
    for k, vs in groups.items():
        yield k, (vs[0] if len(vs) == 1 else np.concatenate(vs))
