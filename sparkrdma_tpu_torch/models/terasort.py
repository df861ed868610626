"""TeraSort (sortByKey): the port of ``sparkrdma_tpu/models/terasort.py``.

At D > 1 every rank runs one step on its own shard
(``models/_base.py``):

    local sort -> exact-quantile sample -> all_gather -> splitters
    -> contiguous destination windows -> all_to_all -> merge

Each rank sorts its local keys first, so the sample is an exact local
quantile sketch and the destination windows are contiguous runs of the
sorted keys: one gather of ``starts[:, None] + arange(capacity)``
fills the ``[D, capacity]`` send block's keys and, through the sort's
permutation, the source rows of its payload, with no per-destination
loop and no read of ``starts`` on the host.  The payload rows move once
on the map side, from the unsorted rows straight into the send block.
The windows move with three ``all_to_all``s (keys, values,
per-source valid counts) and the received sorted runs are merged by
:func:`~sparkrdma_tpu_torch.ops.merge_kernel.merge_runs` (a merge-path
kernel on the card), whose source slots gather the payload rows once.
The step is factored into its rank-local halves, :func:`sort_and_sample`
and :func:`fill_windows` on the map side and :func:`merge_received` on
the reduce side, which run on one device as they run in a rank of a
group.  Rank r's output is its sorted run; the runs concatenated in
rank order are the global sort.

At D = 1 a distributed sort IS the local sort, so sampling, windowing,
the all_to_all and the merge are skipped.  Both keep the output
contract: a run of length ``capacity`` (``D * capacity`` at D > 1)
padded with the key dtype's max, ``n_valid``, and ``max_fill`` for the
overflow retry.

One function, :func:`_sort_keys`, sorts a rank's keys by (key,
validity) into the output its caller gives and returns the sort's
permutation: :func:`sort_and_sample`'s ``[n_local]`` keys, or at D = 1
``capacity`` keys, so that the sort and the D = 1 payload gather write
straight into their first ``min(n, capacity)`` rows and only the tail
is filled after them.  The registry's
``terasort_payload_rows_total{stage=local_sort|fill_windows|merge}``
counts the payload rows each stage gathers (``local_sort`` at D = 1
only), from shapes on the host.

Each stage of a step runs inside its range (``utils/trace.py``):
``terasort.local_sort`` (the sort, and at D = 1 the payload gather;
at D > 1 :func:`sort_and_sample`), ``terasort.pad`` (at D = 1 the fill of the
outputs' tail past the sorted rows), and at D > 1
``terasort.splitters`` (the sample's all_gather and the splitters),
``terasort.fill_windows`` and ``terasort.merge``; the all_to_alls run
in the group's ``exchange.all_to_all``.

Validity is a 0/1 column ordered as a secondary sort key, so padding
sorts after every real record of the same key: real keys equal to the
dtype max are not confused with padding.  ``lax.sort`` with
``num_keys=2`` becomes one sort on a packed int64 key for int32 keys,
or two stable sorts for int64 keys (``ops/lexsort.py``); the merge
keeps that order without sorting.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.models._base import (
    ExchangeModel,
    as_tensor,
    carry_keys,
    carry_values,
    restore_keys,
    restore_values,
)
from sparkrdma_tpu_torch.ops.lexsort import perm_by_key_invalid
from sparkrdma_tpu_torch.ops.merge_kernel import merge_runs
from sparkrdma_tpu_torch.ops.partition import make_range_splitters
from sparkrdma_tpu_torch.parallel.group import step_group
from sparkrdma_tpu_torch.utils.trace import stage


def _sort_keys(keys, valid, k_out):
    """Sort this rank's keys by (key, validity) into the first ``min(n,
    len(k_out))`` rows of ``k_out``.  ``valid`` is int32 0/1 or None
    (every row real); invalid rows get the dtype-max key, so they form
    the sorted run's tail.  Returns (perm int64 [n], the real rows int32
    0-d or None without ``valid``)."""
    n = keys.shape[0]
    m = min(n, k_out.shape[0])
    k_out = k_out[:m]
    if valid is None:
        n_real = None
        if m == n:
            perm = torch.empty(n, dtype=torch.int64, device=keys.device)
            torch.sort(keys, stable=True, out=(k_out, perm))
        else:
            k, perm = torch.sort(keys, stable=True)
            k_out.copy_(k[:m])
    else:
        inv = 1 - valid.to(torch.int32)
        keys = torch.where(valid > 0, keys, torch.iinfo(keys.dtype).max)
        perm = perm_by_key_invalid(keys, inv)
        torch.index_select(keys, 0, perm[:m], out=k_out)
        n_real = valid.sum(dtype=torch.int32)
    return perm, n_real


def sort_and_sample(keys, valid, sample_size: int):
    """Map side, first half: sort this rank's keys by (key, validity)
    (:func:`_sort_keys`) and take the exact local quantiles
    ``k[(arange(S) * n) // S]``.  No payload moves here.  Returns (k,
    perm int64 [n], n_real int32 0-d, sample [S])."""
    n_local = keys.shape[0]
    k = keys.new_empty(n_local)
    perm, n_real = _sort_keys(keys, valid, k)
    if n_real is None:
        n_real = torch.full((), n_local, dtype=torch.int32,
                            device=keys.device)
    at = (torch.arange(sample_size, device=keys.device) * n_local
          ) // sample_size
    return k, perm, n_real, k[at]


def fill_windows(k, perm, vals, n_real, splitters, capacity: int):
    """Map side, second half: destination p gets the keys in
    ``[splitters[p-1], splitters[p])``, a contiguous window of the
    sorted keys ``k``, found by ``searchsorted(right=True)``.  One
    gather of ``starts[:, None] + arange(capacity)`` gives the send
    block's keys and, through ``perm``, the source rows of its payload,
    which one ``index_select`` reads straight from the unsorted
    ``vals`` (``[n]`` or ``[n, W]``).  Slots past a window's count hold
    the key dtype's max; their payload rows all read one fixed source
    row (0 where ``vals`` is 1-D).  Returns (keys [D, cap], vals [D,
    cap(, W)], valid counts int32 [D], true counts int32 [D])."""
    n_local = k.shape[0]
    dev = k.device
    n_parts = splitters.shape[0] + 1
    edges = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.searchsorted(k, splitters, right=True),
        torch.full((1,), n_local, dtype=torch.int64, device=dev),
    ])
    counts = edges[1:] - edges[:-1]
    starts = edges[:-1]
    # real rows of window p: everything before the invalid tail at n_real
    valid_counts = (torch.minimum(edges[1:], n_real.to(torch.int64))
                    - starts).clamp(0, capacity)
    slot = torch.arange(capacity, device=dev)
    window_valid = slot[None, :] < counts.clamp(max=capacity)[:, None]
    # every padding slot reads sorted row 0, so one source row serves all
    at = torch.where(window_valid, starts[:, None] + slot[None, :], 0)
    bk = torch.where(window_valid, k[at], torch.iinfo(k.dtype).max)
    counter("terasort_payload_rows_total",
            stage="fill_windows").inc(n_parts * capacity)
    bv = vals.index_select(0, perm[at].reshape(-1)).reshape(
        n_parts, capacity, *vals.shape[1:])
    if vals.dim() == 1:
        bv = torch.where(window_valid, bv, 0)
    return bk, bv, valid_counts.to(torch.int32), counts.to(torch.int32)


def merge_received(rk, rv, rvalid):
    """Reduce side: merge the ``[D, cap]`` block the all_to_all
    delivered (row s from rank s, its first ``rvalid[s]`` slots real)
    in the order of a stable sort keyed (key, invalid), so padding
    comes last even where its key equals a real max-valued key, and
    gather the payload rows once through the merge's source slots.
    ``rv`` is ``[D, cap]`` or ``[D, cap, W]``.  Returns (keys [D*cap],
    vals [D*cap(, W)], n_valid int32[1]).

    The merge relies on two facts about the block, which
    :func:`sort_and_sample` and :func:`fill_windows` guarantee: each
    row's valid prefix is ascending (a window of a sorted run), and
    every slot past it holds the key dtype's max."""
    keys, src = merge_runs(rk, rvalid)
    counter("terasort_payload_rows_total", stage="merge").inc(rk.numel())
    sv = rv.reshape(rk.numel(), *rv.shape[2:]).index_select(0, src)
    return keys, sv, rvalid.sum(dtype=torch.int32).reshape(1)


def _exchange_step(keys, vals, valid, group, capacity: int,
                   sample_size: int):
    """One rank's step at D > 1 (module docstring)."""
    with stage("terasort.local_sort"):
        k, perm, n_real, sample = sort_and_sample(keys, valid, sample_size)
    with stage("terasort.splitters"):
        splitters = make_range_splitters(
            group.all_gather(sample).reshape(-1), group.size)
    with stage("terasort.fill_windows"):
        bk, bv, valid_counts, counts = fill_windows(k, perm, vals, n_real,
                                                    splitters, capacity)
    rk, rv = group.all_to_all(bk), group.all_to_all(bv)
    rvalid = group.all_to_all(valid_counts.reshape(-1, 1)).reshape(-1)
    with stage("terasort.merge"):
        sk, sv, n_valid = merge_received(rk, rv, rvalid)
    return sk, sv, n_valid, counts.max().reshape(1)


def _local_sort_step(keys, vals, valid, n_devices: int, capacity: int,
                     sample_size: int = 1024, group=None):
    """One rank's sort.  ``valid`` is int32 0/1 or None (everything
    valid, no validity operand).  At D = 1 :func:`_sort_keys` and the
    payload gather write into the capacity-sized outputs and
    ``terasort.pad`` fills their tail (module docstring).  Returns
    (keys' [D * capacity], vals', n_valid int32[1], max_fill
    int32[1])."""
    g = step_group(n_devices, group, "TeraSort")
    if g is not None:
        return _exchange_step(keys, vals, valid, g, capacity, sample_size)
    n_local = keys.shape[0]
    m = min(n_local, capacity)
    with stage("terasort.local_sort"):
        k = keys.new_empty(capacity)
        v = vals.new_empty((capacity, *vals.shape[1:]))
        perm, n_real = _sort_keys(keys, valid, k)
        counter("terasort_payload_rows_total", stage="local_sort").inc(m)
        torch.index_select(vals, 0, perm[:m], out=v[:m])
    with stage("terasort.pad"):
        k[m:].fill_(torch.iinfo(keys.dtype).max)
        v[m:].zero_()
    if n_real is None:
        n_valid = torch.full((1,), m, dtype=torch.int32, device=k.device)
    else:
        n_valid = torch.clamp(n_real.reshape(1), max=capacity)
    max_fill = torch.full((1,), n_local, dtype=torch.int32, device=k.device)
    return k, v, n_valid, max_fill


def _check_rows(what: str, n_local: int, keys) -> None:
    if keys.shape[0] != n_local:
        raise ValueError(f"{what} step made for {n_local} rows per rank "
                         f"got {keys.shape[0]}")


def _check_group(n_devices: int, n_local: int, group) -> None:
    if step_group(n_devices, group, "TeraSort") is not None and n_local < 1:
        raise ValueError("a TeraSort rank needs at least one row (pad "
                         "with a validity column)")


def make_sort_step(n_devices: int, n_local: int, capacity: int,
                   sample_size: int = 1024, with_validity: bool = True,
                   group=None):
    """The sort step over this rank's ``[n_local]`` (keys, vals(,
    valid)): fn(...) -> (keys' [D * capacity], vals', n_valid[1],
    max_fill[1]), the counterpart of the JAX ``make_sort_step``.
    ``group`` is the exchange group of D > 1 ranks."""
    _check_group(n_devices, n_local, group)
    sample_size = min(sample_size, max(1, n_local))

    if with_validity:
        def step(k, v, valid):
            _check_rows("sort", n_local, k)
            return _local_sort_step(k, v, valid, n_devices, capacity,
                                    sample_size, group)
    else:
        def step(k, v):
            _check_rows("sort", n_local, k)
            return _local_sort_step(k, v, None, n_devices, capacity,
                                    sample_size, group)
    return step


def make_wide_sort_step(n_devices: int, n_local: int, payload_words: int,
                        capacity: int, sample_size: int = 1024, group=None):
    """The wide-record sort step: fn(keys [n_local], payload [n_local,
    W]) -> (keys' [D * capacity], payload' [D * capacity, W], n_valid[1],
    max_fill[1])."""
    _check_group(n_devices, n_local, group)
    sample_size = min(sample_size, max(1, n_local))

    def step(k, p):
        _check_rows("wide sort", n_local, k)
        if p.dim() != 2 or p.shape[1] != payload_words:
            raise ValueError(f"payload must be [n, {payload_words}], got "
                             f"{tuple(p.shape)}")
        return _local_sort_step(k, p, None, n_devices, capacity,
                                sample_size, group)
    return step


class TeraSorter(ExchangeModel):
    """Host-facing driver for the sort (the sortByKey job)."""

    def __init__(self, device=None, capacity_factor: float = 1.3,
                 sample_size: int = 1024, **kw):
        super().__init__(device, capacity_factor, **kw)
        self.sample_size = sample_size

    def sort_device(self, keys: torch.Tensor, vals: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    capacity: Optional[int] = None):
        """One sort step on this rank's device tensors (every rank passes
        as many rows).  Returns ((keys', vals', n_valid[1],
        max_fill[1]), capacity) in the caller's dtypes; nothing is
        synchronised."""
        n_local = keys.shape[0]
        key_dtype, val_dtype = keys.dtype, vals.dtype
        ck, cv = carry_keys(keys), carry_values(vals, "payload")
        cap = capacity or self._capacity(n_local)
        ck, cv, valid = self._to_device(ck, cv, valid)
        step = make_sort_step(self.n_devices, n_local, cap,
                              self.sample_size, valid is not None,
                              self.group)
        sk, sv, n_valid, max_fill = step(ck, cv) if valid is None else \
            step(ck, cv, valid)
        return (restore_keys(sk, key_dtype),
                restore_values(sv, val_dtype, "payload"),
                n_valid, max_fill), cap

    def sort_device_wide(self, keys: torch.Tensor, payload: torch.Tensor,
                         capacity: Optional[int] = None):
        """Wide-record sort step (HiBench shape): ``payload`` is [n, W]
        rows that follow their keys.  Returns ((keys', payload' [D *
        cap, W], n_valid[1], max_fill[1]), capacity)."""
        n_local = keys.shape[0]
        if payload.dim() != 2 or payload.shape[0] != n_local:
            raise ValueError(f"payload must be [n, W], got {payload.shape}")
        key_dtype = keys.dtype
        cap = capacity or self._capacity(n_local)
        ck, payload = self._to_device(carry_keys(keys), payload)
        step = make_wide_sort_step(self.n_devices, n_local,
                                   payload.shape[1], cap, self.sample_size,
                                   self.group)
        sk, sp, n_valid, max_fill = step(ck, payload)
        return (restore_keys(sk, key_dtype), sp, n_valid, max_fill), cap

    def sort(self, keys, vals=None) -> Tuple[np.ndarray, np.ndarray]:
        """Host-facing sortByKey of this rank's shard: returns
        (sorted_keys, sorted_vals), this rank's sorted run (at D = 1
        the whole sort)."""
        keys = np.asarray(keys)
        vals = np.zeros_like(keys) if vals is None else np.asarray(vals)
        if keys.shape != vals.shape or keys.ndim != 1:
            raise ValueError("keys/vals must be equal-length 1-D arrays")
        tk, tv = as_tensor(keys), as_tensor(vals)
        ck, cv = carry_keys(tk), carry_values(tv, "payload")
        n = keys.shape[0]
        (n_local,), full = self._local_length(n)
        if n_local == 0:
            return keys.copy(), vals.copy()
        valid = None
        if not full:
            pad = n_local - n
            ck = torch.cat([ck, ck.new_full((pad,),
                                            torch.iinfo(ck.dtype).max)])
            cv = torch.cat([cv, cv.new_zeros(pad)])
            valid = torch.ones(n_local, dtype=torch.int32)
            valid[n:] = 0
        ck, cv, valid = self._to_device(ck, cv, valid)

        def run(cap):
            step = make_sort_step(self.n_devices, n_local, cap,
                                  self.sample_size, valid is not None,
                                  self.group)
            sk, sv, n_valid, max_fill = step(ck, cv) if valid is None else \
                step(ck, cv, valid)
            return (sk, sv, n_valid), max_fill

        sk, sv, n_valid = self._run_with_overflow_retry(n_local, run)
        nv = int(n_valid[0])
        return (restore_keys(sk[:nv], tk.dtype).cpu().numpy(),
                restore_values(sv[:nv], tv.dtype, "payload").cpu().numpy())
