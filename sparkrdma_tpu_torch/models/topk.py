"""Grouped top-k, the rank/LIMIT-per-group SQL shape: the port of
``sparkrdma_tpu/models/topk.py``.

TPC-DS q67-style plans rank rows within each group and keep the top k:

  hash exchange (the identity on one device) -> one sort keyed (key,
  validity, value descending via bitwise complement) -> per-run rank
  -> rank mask.

The caller picks how ties rank (``ties``):

- ``"row_number"`` (the default, the JAX package's): ``row_number()
  over (partition by key order by value desc) <= k``, each slot's index
  less its run's first (``ops/segment.py``'s ``run_ends`` and
  ``prev_run_end``: one launch of kernel 1's fill); ties in any order;
- ``"rank"``: SQL's ``rank() ... <= k``, one plus the number of rows of
  the partition with a strictly larger value, so every row tied at the
  k-th place is kept: the index of the first slot of the row's run of
  equal (key, value) less its partition's first (two fills).  The step
  also hands back each slot's rank and, in sorted order, an optional
  payload column that rides the sort (on one device).  Only
  :func:`make_topk_step` offers it; ``GroupedTopK`` keeps
  ``row_number()``.

The sort and its gathers run in the range ``topk.sort``, the rank in
``topk.rank`` (``utils/trace.py``), and each step adds the slots it
ranked to the registry's ``topk_rows_total{ties=row_number|rank}``.

A key lives on one rank after the exchange, so at D > 1 each rank
returns the final top-k lists of the keys it owns.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import torch

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.models._base import ExchangeModel
from sparkrdma_tpu_torch.ops.exchange import hash_exchange
from sparkrdma_tpu_torch.ops.lexsort import perm_by_key_invalid_value
from sparkrdma_tpu_torch.ops.segment import prev_run_end, run_ends
from sparkrdma_tpu_torch.parallel.group import step_group
from sparkrdma_tpu_torch.utils.trace import stage

#: how ties rank (module docstring)
TIES = ("row_number", "rank")


def _rank_in_runs(ks: torch.Tensor, valid_s: torch.Tensor) -> torch.Tensor:
    """Rank of each slot within its (key, validity) run in a sorted
    layout: its index minus the run's start, which is one past the
    previous run's end (0 for the first run)."""
    iota = torch.arange(ks.shape[0], dtype=torch.int32, device=ks.device)
    _flag, (run_start,) = prev_run_end(run_ends(ks, valid_s), (iota + 1,))
    return iota - run_start


def _sql_rank(ks: torch.Tensor, inv_s: torch.Tensor,
              vs: torch.Tensor) -> torch.Tensor:
    """SQL ``rank()`` of each slot within its (key, validity) run of a
    layout sorted by (key, validity, value descending): one plus the
    index of the first slot of its run of equal (key, validity, value)
    less the index of the partition's first slot."""
    iota = torch.arange(ks.shape[0], dtype=torch.int32, device=ks.device)
    _f, (part_start,) = prev_run_end(run_ends(ks, inv_s), (iota + 1,))
    _f, (tie_start,) = prev_run_end(run_ends(ks, inv_s, vs), (iota + 1,))
    return tie_start - part_start + 1


def make_topk_step(n_devices: int, n_local: int, capacity: int, k: int,
                   group=None, unsigned_keys: bool = False,
                   ties: str = "row_number"):
    """Grouped top-k over this rank's [n_local] (keys, values, int32
    0/1 validity).  ``group`` and ``unsigned_keys`` as in
    ``hash_exchange``; ``ties`` as in the module docstring.

    ``"row_number"``: returns fn(keys, vals, valid) -> (keys', vals',
    keep, n_keep[1], max_fill[1]) with keep = 1 on the top-k rows of
    each key (value descending; ties in any order).

    ``"rank"``: returns fn(keys, vals, valid, payload=None) -> (keys',
    vals', keep, n_keep[1], max_fill[1], rank, payload'), keep = 1 on
    the valid rows whose SQL rank is at most k, ``rank`` that 1-based
    rank (int32; 0 on invalid slots) and ``payload'`` the payload column
    in the sorted order (None without one; one device only)."""
    if ties not in TIES:
        raise ValueError(f"ties must be one of {TIES}, got {ties!r}")
    step_group(n_devices, group, "Grouped top-k")

    def sort(keys, vals, valid, payload):
        flat_k, flat_v, flat_m, max_fill = hash_exchange(
            keys, vals, valid, n_devices, capacity, group, unsigned_keys)
        if payload is not None and n_devices > 1:
            raise ValueError("a payload rides the sort on one device only")
        counter("topk_rows_total", ties=ties).inc(flat_k.shape[0])
        with stage("topk.sort"):
            flat_k = torch.where(flat_m > 0, flat_k,
                                 torch.iinfo(flat_k.dtype).max)
            # the complement reverses the order of signed ints, and
            # undoes itself after the sort
            inv = 1 - flat_m.to(torch.int32)
            perm = perm_by_key_invalid_value(flat_k, inv, ~flat_v)
            ks, inv_s, vs = flat_k[perm], inv[perm], flat_v[perm]
            ps = None if payload is None else payload[perm]
        return ks, inv_s, vs, ps, max_fill.reshape(1)

    def step(keys, vals, valid):
        ks, inv_s, vs, _ps, max_fill = sort(keys, vals, valid, None)
        with stage("topk.rank"):
            rank = _rank_in_runs(ks, inv_s)
            keep = ((rank < k) & (inv_s == 0)).to(torch.int32)
            n_keep = keep.sum(dtype=torch.int32).reshape(1)
        return ks, vs, keep, n_keep, max_fill

    def step_rank(keys, vals, valid, payload=None):
        ks, inv_s, vs, ps, max_fill = sort(keys, vals, valid, payload)
        with stage("topk.rank"):
            real = inv_s == 0
            rank = torch.where(real, _sql_rank(ks, inv_s, vs), 0)
            keep = ((rank <= k) & real).to(torch.int32)
            n_keep = keep.sum(dtype=torch.int32).reshape(1)
        return ks, vs, keep, n_keep, max_fill, rank, ps

    return step if ties == "row_number" else step_rank


def _make_step_with_k(n_devices, n_local, capacity, k, with_validity=True,
                      group=None, unsigned_keys=False):
    """The step maker signature of ``ExchangeModel._run_padded_keyed``;
    the validity-free path reuses the general step with every slot
    valid (the rank needs the validity run delimiter anyway)."""
    step = make_topk_step(n_devices, n_local, capacity, k, group,
                          unsigned_keys)
    if with_validity:
        return step

    def run(keys, vals):
        return step(keys, vals, torch.ones(keys.shape[0], dtype=torch.int32,
                                           device=keys.device))

    return run


class GroupedTopK(ExchangeModel):
    """Host-facing grouped top-k: ``{key: [k largest values desc]}``."""

    def __init__(self, device=None, capacity_factor: float = 2.0, **kw):
        super().__init__(device, capacity_factor, **kw)

    def top_k(self, keys, vals, k: int) -> Dict[int, List[int]]:
        """{key: its k largest values, descending} for the keys this
        rank owns; integer values of any width, uint32 included."""
        if k <= 0:
            raise ValueError(f"k must be positive: {k}")
        step_maker = functools.partial(_make_step_with_k, k=k)
        rows, _nu = self._run_padded_keyed(keys, vals, step_maker, "order")
        if rows is None:
            return {}
        ks_h, vs_h, keep_h = rows
        mask = keep_h > 0
        out: Dict[int, List[int]] = {}
        for kk, vv in zip(ks_h[mask].tolist(), vs_h[mask].tolist()):
            out.setdefault(kk, []).append(vv)
        # rows arrive key-grouped and value-descending, and a key lives
        # on one rank, so each list is already the final top-k
        return out
