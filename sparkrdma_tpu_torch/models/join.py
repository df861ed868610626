"""Equi-joins, the SQL-exchange workloads: the port of
``sparkrdma_tpu/models/join.py``.

The star-schema shape of TPC-DS q64/q72: a large FACT table joined to a
DIMENSION table whose join keys are unique.

- :class:`HashJoiner`, the exchange-shuffle join: both sides merge into
  one packed (key, role, payload) stream, which one hash exchange moves
  (three ``all_to_all``s over the group; the identity on one device),
  then each rank probes the rows it owns.
- :class:`BroadcastJoiner`, the broadcast join: every rank holds the
  whole dimension table (the JAX step's replicated ``P(None)`` input,
  Spark's broadcast variable) and its own shard of the fact side; no
  exchange.

At D > 1 each rank passes its own shards (both sides for the hash join,
the fact side for the broadcast join) and gets back its joined rows;
the union over the ranks is the whole join.

The probe is one sort keyed (key, role), role 0 = valid dimension, 1 =
valid fact, 2 = invalid, so each key's run opens with its dimension
row; then one forward fill (kernel 1's ``fill``, ``ops/scan_kernels.py``)
carries the latest dimension (key, value) rightward, and a fact row
matches iff the filled key equals its own.

Transport words: both sides' keys and values ride one column each of
4-byte words, or 8-byte words as soon as any key or value column is
64-bit.  The JAX package carries them as uint32 / uint64; PyTorch has
little uint32 arithmetic, so the port carries the same bits as int32 /
int64 and sorts them in unsigned order (``ops/lexsort.py``).  Narrower
integers and floats widen losslessly (bool, int8/16/32/64, uint8/16/32
and float16/bfloat16/float32/float64 values; integer or bool keys);
other dtypes raise.  The JAX package's ``check_no_silent_truncation`` has no
counterpart (``models/_base.py``).

The probe's sort packs key and role into one int64 word whenever both
key columns are at most 4 bytes wide, whatever the transport width
(``ops/lexsort.py``'s :func:`sort_key_role`), and reads the sorted key
and role back from that word; only 8-byte key columns sort in two
passes and gather both.  Each probe adds the rows it sorted to the
registry's ``join_probe_rows_total{sort=packed|chain}``.

A step's stages run inside the ranges ``join.pack`` (the packed
stream) and ``join.probe`` (the sort, its gathers, the fill and the
masks), and at D > 1 ``join.buckets`` (the hash buckets) and the
group's ``exchange.all_to_all`` (``utils/trace.py``).

Output rows are the probe layout with a found mask (1 only on matched
fact rows); the host wrappers drop the rest per join variant.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.models._base import ExchangeModel
from sparkrdma_tpu_torch.ops.lexsort import sort_key_role, unpack_key_role
from sparkrdma_tpu_torch.ops.partition import (
    hash_partition_ids,
    partition_to_buckets_dropping,
)
from sparkrdma_tpu_torch.ops.scan_kernels import scan_flagged
from sparkrdma_tpu_torch.parallel.group import step_group
from sparkrdma_tpu_torch.utils.trace import stage

# role column: dimension rows sort before fact rows of the same key;
# invalid (padding) rows sort last and never match
_ROLE_DIM = 0
_ROLE_FACT = 1
_ROLE_INVALID = 2

_INT_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
               torch.int64, torch.uint8, torch.uint16, torch.uint32)
_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_WORD = {4: torch.int32, 8: torch.int64}
_FLOAT_WORD = {4: torch.float32, 8: torch.float64}


def _transport_width(*cols) -> int:
    """Transport word size: 8 bytes as soon as any key or value column
    is 64-bit, else 4."""
    return 8 if any(c.dtype.itemsize == 8 for c in cols) else 4


def _key_u(k: torch.Tensor, width: int) -> torch.Tensor:
    """Transport word of an integer key column: the bits of JAX's
    ``k.astype(uint32 / uint64)``."""
    if k.dtype not in _INT_DTYPES:
        raise ValueError(f"join keys must be integers, got {k.dtype}")
    if k.dtype.itemsize == width:
        return k.view(_WORD[width])
    return k.to(_WORD[width])


def _pay_u(v: torch.Tensor, width: int) -> torch.Tensor:
    """Lossless transport word of a value column: same-width dtypes
    reinterpret their bits, narrower ints and floats widen first."""
    if v.dtype not in _INT_DTYPES + _FLOAT_DTYPES:
        raise ValueError(f"unsupported join value dtype {v.dtype}")
    if v.dtype.itemsize == width:
        return v.view(_WORD[width])
    if v.dtype.is_floating_point:
        return v.to(_FLOAT_WORD[width]).view(_WORD[width])
    return v.to(_WORD[width])


def _pay_from_u(u: np.ndarray, dtype, width: int) -> np.ndarray:
    """Inverse of :func:`_pay_u` on host words."""
    dtype = np.dtype(dtype)
    if dtype.itemsize == width:
        return u.view(dtype)
    if np.issubdtype(dtype, np.floating):
        return u.view(np.dtype(f"f{width}")).astype(dtype)
    return u.astype(dtype)


def _key_bytes(lk, rk) -> int:
    """Byte size of the wider key column: what decides whether the
    probe's sort packs key and role into one word."""
    return max(lk.dtype.itemsize, rk.dtype.itemsize)


def _pack_sides(lk, lv, l_valid, rk, rv, r_valid):
    """Merge fact and dimension columns into one (key, role, payload)
    stream of transport words (facts first)."""
    w = _transport_width(lk, rk, lv, rv)
    ku = torch.cat([_key_u(lk, w), _key_u(rk, w)])
    role = torch.cat([
        torch.where(l_valid > 0, _ROLE_FACT, _ROLE_INVALID),
        torch.where(r_valid > 0, _ROLE_DIM, _ROLE_INVALID),
    ]).to(torch.int32)
    pay = torch.cat([_pay_u(lv, w), _pay_u(rv, w)])
    return ku, role, pay


def _probe_fill(sk, srole, spay):
    """Forward fill over a stream already sorted with each key's
    dimension row first: carry each dimension row's (key, value)
    rightward through kernel 1; a fact row matches iff the filled key
    equals its own (a run with no dimension row inherits an earlier
    run's fill, which the key test rejects; invalid rows never fill and
    never match).  Returns ``(dim_val, found)``, found a bool mask true
    exactly on matched fact rows.  Shared with the fused join+aggregate,
    whose sort key differs."""
    flag, (fkey, fval) = scan_flagged("fill", srole == _ROLE_DIM, (sk, spay))
    found = (srole == _ROLE_FACT) & flag & (fkey == sk)
    return fval, found


def _sorted_key_role(ku, role, word, perm):
    """The probe stream's key words and roles in sorted order: decoded
    from the sorted packed ``word``, or gathered through ``perm`` where
    the key did not pack.  Adds the rows to the probe counter."""
    counter("join_probe_rows_total",
            sort="chain" if word is None else "packed").inc(ku.shape[0])
    if word is None:
        return ku[perm], role[perm]
    return unpack_key_role(word, ku.dtype)


def _probe_packed(ku, role, pay, key_bytes: int):
    """Sort-merge probe over a packed stream: one sort keyed (key,
    role), then :func:`_probe_fill`.  ``key_bytes`` is the wider key
    column's byte size (:func:`_key_bytes`).  Returns ``(keys_u,
    fact_pay, dim_pay, found, is_fact)``, found = 1 exactly on matched
    fact rows and dim_pay 0 elsewhere."""
    word, perm = sort_key_role(ku, role, key_bytes)
    sk, srole = _sorted_key_role(ku, role, word, perm)
    del word  # 8 B a row, no longer read: freed before the fill
    spay = pay[perm]
    fval, found_b = _probe_fill(sk, srole, spay)
    fval = torch.where(found_b, fval, 0)
    is_fact = (srole == _ROLE_FACT).to(torch.int32)
    return sk, spay, fval, found_b.to(torch.int32), is_fact


def _check_rows(what: str, n_left: int, n_right: int, lk, rk) -> None:
    if lk.shape[0] != n_left or rk.shape[0] != n_right:
        raise ValueError(
            f"{what} step made for ({n_left}, {n_right}) rows got "
            f"({lk.shape[0]}, {rk.shape[0]})"
        )


def _exchange_packed(ku, role, pay, group, capacity: int):
    """The hash exchange of the packed stream: buckets by the murmur3 of
    the key word, invalid rows to the trash bucket, fill slots (0,
    invalid, 0).  Returns the received (key, role, payload) stream and
    the largest true bucket fill."""
    D = group.size
    with stage("join.buckets"):
        (bk, br, bp), counts = partition_to_buckets_dropping(
            hash_partition_ids(ku, D), role != _ROLE_INVALID,
            (ku, role, pay), D, capacity,
            fill_values=(0, _ROLE_INVALID, 0))
    eku, erole, epay = (group.all_to_all(b).reshape(-1)
                        for b in (bk, br, bp))
    return eku, erole, epay, counts.max().reshape(1)


def make_hash_join_step(n_devices: int, n_left: int, n_right: int,
                        capacity: int, group=None):
    """The fused-exchange join step over this rank's [n_left] fact and
    [n_right] dimension columns (keys, values, int32 0/1 validity):
    both sides ride one hash exchange as a packed stream, then probe.
    Returns fn(lk, lv, l_valid, rk, rv, r_valid) -> (keys_u, fact_pay,
    dim_pay, found, is_fact, fill[1]); ``fill`` is the largest bucket
    fill for the overflow retry (0 on one device).  ``group`` is the
    exchange group of D > 1 ranks."""
    g = step_group(n_devices, group, "The hash join")

    def step(lk, lv, l_valid, rk, rv, r_valid):
        _check_rows("hash join", n_left, n_right, lk, rk)
        with stage("join.pack"):
            ku, role, pay = _pack_sides(lk, lv, l_valid, rk, rv, r_valid)
        if g is None:
            fill = torch.zeros(1, dtype=torch.int32, device=ku.device)
        else:
            ku, role, pay, fill = _exchange_packed(ku, role, pay, g,
                                                   capacity)
        with stage("join.probe"):
            return (*_probe_packed(ku, role, pay, _key_bytes(lk, rk)),
                    fill)

    return step


def make_broadcast_join_step(n_devices: int, n_left: int, n_right_total: int,
                             group=None):
    """The broadcast join step: this rank's [n_left] fact rows against
    the whole [n_right_total] dimension table, which every rank holds.
    Returns fn(lk, lv, l_valid, rk, rv, r_valid) -> (keys_u, fact_pay,
    dim_pay, found, is_fact).  No collective runs; ``group`` names the
    D > 1 ranks it runs in."""
    step_group(n_devices, group, "The broadcast join")

    def step(lk, lv, l_valid, rk, rv, r_valid):
        _check_rows("broadcast join", n_left, n_right_total, lk, rk)
        with stage("join.pack"):
            packed = _pack_sides(lk, lv, l_valid, rk, rv, r_valid)
        with stage("join.probe"):
            return _probe_packed(*packed, _key_bytes(lk, rk))

    return step


#: join variants (Spark/SQL parity): inner keeps matched fact rows with
#: the dim value; left_outer keeps EVERY fact row plus a matched mask;
#: semi keeps matched fact rows without the dim value (left-semi,
#: TPC-DS q16); anti keeps the UNmatched fact rows (left-anti, q94).
JOIN_HOWS = ("inner", "left_outer", "semi", "anti")


class HashJoiner(ExchangeModel):
    """Exchange-shuffle join of (fact_keys, fact_vals) with a
    unique-keyed (dim_keys, dim_vals); ``how`` picks the variant
    (:data:`JOIN_HOWS`)."""

    def __init__(self, device=None, capacity_factor: float = 1.6, **kw):
        super().__init__(device, capacity_factor, **kw)

    def join(self, fact_keys, fact_vals, dim_keys, dim_vals,
             how: str = "inner"):
        """inner -> (keys, fact_vals, dim_vals) for matching fact rows;
        left_outer -> (keys, fact_vals, dim_vals, matched) for ALL fact
        rows (dim_vals is 0 where unmatched); semi/anti -> (keys,
        fact_vals) for matched/unmatched fact rows.  At D > 1 both
        sides are this rank's shards and the rows are those this rank
        owns.  Input order is not preserved."""
        lk, lv = _as_columns(fact_keys, fact_vals)
        rk, rv = _as_columns(dim_keys, dim_vals)
        (nl, nr), _full = self._local_length(lk.shape[0], rk.shape[0])
        lk, lv, l_valid = _pad_to(lk, lv, nl)
        rk, rv, r_valid = _pad_to(rk, rv, nr)
        placed = self._to_device(*(torch.from_numpy(x) for x in
                                   (lk, lv, l_valid, rk, rv, r_valid)))

        def attempt(factor: float):
            # one capacity for the fused fact+dim stream
            cap = self._capacity(nl + nr, factor)
            step = make_hash_join_step(self.n_devices, nl, nr, cap,
                                       self.group)
            *rows, fill = step(*placed)
            return rows, self._overflowed(fill, cap)

        rows = self._retry_with_factor(attempt)
        return _mask_output(*rows, lk.dtype, lv.dtype, rv.dtype, how)


class BroadcastJoiner(ExchangeModel):
    """Broadcast join: the dimension side replicated to every rank;
    ``how`` picks the variant (:data:`JOIN_HOWS`)."""

    def join(self, fact_keys, fact_vals, dim_keys, dim_vals,
             how: str = "inner"):
        """Same output contract as :meth:`HashJoiner.join`; at D > 1
        the fact side is this rank's shard and the dimension side the
        whole table."""
        lk, lv = _as_columns(fact_keys, fact_vals)
        rk, rv = _as_columns(dim_keys, dim_vals)
        nl = self._ladder(lk.shape[0])
        lk, lv, l_valid = _pad_to(lk, lv, nl)
        r_valid = np.ones(rk.shape[0], np.int32)
        step = make_broadcast_join_step(self.n_devices, nl, rk.shape[0],
                                        self.group)
        rows = step(*self._to_device(*(torch.from_numpy(x) for x in
                                       (lk, lv, l_valid, rk, rv, r_valid))))
        return _mask_output(*rows, lk.dtype, lv.dtype, rv.dtype, how)


def _mask_output(sk, spay, fval, found, is_fact, key_dtype, lv_dtype,
                 rv_dtype, how="inner"):
    """Host-side join filter per variant, restoring the original dtypes
    from the transport words."""
    if how not in JOIN_HOWS:
        raise ValueError(f"how must be one of {JOIN_HOWS}, got {how!r}")
    sk, spay, fval, found, is_fact = (
        t.cpu().numpy() for t in (sk, spay, fval, found, is_fact))
    width = sk.dtype.itemsize
    found_h = found > 0
    if how in ("inner", "semi"):
        mask = found_h
    elif how == "left_outer":
        mask = is_fact > 0
    else:  # anti: real fact rows with no dimension match
        mask = (is_fact > 0) & ~found_h
    keys = sk.astype(np.dtype(key_dtype))[mask]
    outl = _pay_from_u(spay, lv_dtype, width)[mask]
    if how in ("semi", "anti"):
        return keys, outl
    outv = _pay_from_u(fval, rv_dtype, width)[mask]
    if how == "left_outer":
        return keys, outl, outv, found_h[mask]
    return keys, outl, outv


def _as_columns(keys, vals) -> Tuple[np.ndarray, np.ndarray]:
    k = np.ascontiguousarray(np.asarray(keys))
    v = np.ascontiguousarray(np.asarray(vals))
    if k.shape != v.shape or k.ndim != 1:
        raise ValueError("keys/vals must be equal-length 1-D arrays")
    return k, v


def _pad_to(k, v, total):
    """Pad numpy columns to ``total`` rows with an int32 validity
    column."""
    n = k.shape[0]
    valid = np.ones(total, np.int32)
    if total > n:
        valid[n:] = 0
        k = np.concatenate([k, np.zeros(total - n, k.dtype)])
        v = np.concatenate([v, np.zeros(total - n, v.dtype)])
    return k, v, valid
