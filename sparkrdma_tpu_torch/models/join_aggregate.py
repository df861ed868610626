"""Fused broadcast join + aggregation, one sort where q64/q72 plans two:
the port of ``sparkrdma_tpu/models/join_aggregate.py``.

TPC-DS q64/q72 plans end in ``fact JOIN dim -> aggregate``.  When the
group key is a pure function of the join key (the key itself, its
bucket, a date part), sorting the packed stream by (group key, join
key, role) groups equal join keys inside contiguous group-key runs, so
one sort serves both stages:

  sort (gk, key, role, payload)       # ops/lexsort.py: (key, role), then gk
  -> forward fill of dimension rows   # the join probe (join.py), kernel 1
  -> run ends and heads               # ops/segment.py: run_ends, run_heads
  -> per-run sum/count                # ops/segment.py: run_totals
  -> per-run min/max by segmented scans (kernel 1's min and max kinds)

The three parts run inside the ranges ``join_aggregate.pack`` (the
packed stream and the group key), ``join_aggregate.probe`` (the sort,
its gathers, the fill and the value hook) and
``join_aggregate.aggregate`` (the run sums, counts, mins and maxs)
(``utils/trace.py``).

Outputs use the run-end layout of ``aggregate_by_key_local`` (entries
where ``counts > 0``).

At D > 1 each rank joins its fact shard against the whole dimension
table and aggregates its own rows; the host driver then agrees on the
largest group count, pads, all-gathers every rank's (gk, sums, counts,
mins, maxs) rows and merges them on every rank (two-phase aggregation's
final combine), so each rank returns the whole table.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.models._base import ExchangeModel
from sparkrdma_tpu_torch.models.aggregate import KeyStats
from sparkrdma_tpu_torch.models.join import (
    _ROLE_INVALID,
    _as_columns,
    _check_rows,
    _key_bytes,
    _pack_sides,
    _pad_to,
    _probe_fill,
    _sorted_key_role,
)
from sparkrdma_tpu_torch.ops.lexsort import sort_group_key_role
from sparkrdma_tpu_torch.ops.segment import (
    run_ends,
    run_heads,
    run_totals,
    segmented_scan,
)
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup, step_group
from sparkrdma_tpu_torch.utils.trace import stage

GroupKeyFn = Callable[[torch.Tensor], torch.Tensor]
AggValFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

_MASK32 = (1 << 32) - 1


def _minmax_identities(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def _hook_view(word: torch.Tensor) -> torch.Tensor:
    """What a hook sees of a transport word: the unsigned value as int64
    for a 4-byte word (JAX's uint32), the int64 bits of an 8-byte one."""
    if word.dtype == torch.int32:
        return word.to(torch.int64) & _MASK32
    return word


@functools.lru_cache(maxsize=16)
def make_broadcast_join_aggregate_step(
    n_devices: int,
    n_left: int,
    n_right_total: int,
    group_key_fn: GroupKeyFn,
    agg_val_fn: Optional[AggValFn] = None,
    group=None,
):
    """The fused step: this rank's [n_left] fact rows, the whole
    [n_right_total] dimension table on every rank; no collective runs,
    and ``group`` names the D > 1 ranks it runs in.  Returns fn(lk, lv,
    l_valid, rk, rv, r_valid) -> run-end partial aggregates ``(gk, sums, counts, mins,
    maxs, n_groups[1])``, ``gk`` a transport word.

    Hooks see int64 tensors of the transport view: for a 4-byte
    transport the unsigned 32-bit value (what JAX's uint32 holds, so
    ``key % 1024`` and ``pay ^ dim`` compute the same numbers), for an
    8-byte transport the int64 bit pattern of JAX's uint64.
    ``group_key_fn(key_u)`` must depend ONLY on the join key (the fusion
    precondition); its result is kept modulo the transport width.
    ``agg_val_fn(key_u, fact_pay_u, dim_val_u)`` builds the aggregated
    value per matched fact row, as int32, int64 or float32 (the dtypes
    kernel 1 scans); ``None`` aggregates the dimension value read as the
    signed transport width.  Hooks key the step cache by identity: pass
    module-level functions, not fresh lambdas.
    """
    step_group(n_devices, group, "The broadcast join+aggregate")

    def step(lk, lv, l_valid, rk, rv, r_valid):
        _check_rows("broadcast join+aggregate", n_left, n_right_total, lk, rk)
        with stage("join_aggregate.pack"):
            ku, role, pay = _pack_sides(lk, lv, l_valid, rk, rv, r_valid)
            gk = group_key_fn(_hook_view(ku)).to(ku.dtype)
            # invalid rows ride the all-ones (unsigned max) group, so
            # they sort to the tail and never delimit or join a real
            # group
            gk = torch.where(role != _ROLE_INVALID, gk, -1)
        with stage("join_aggregate.probe"):
            sgk, word, perm = sort_group_key_role(gk, ku, role,
                                                  _key_bytes(lk, rk))
            sk, srole = _sorted_key_role(ku, role, word, perm)
            del word  # 8 B a row, no longer read: freed before the fill
            spay = pay[perm]
            dim_val, found = _probe_fill(sk, srole, spay)
            if agg_val_fn is None:
                v = dim_val
            else:
                v = agg_val_fn(_hook_view(sk), _hook_view(spay),
                               _hook_view(dim_val))
        with stage("join_aggregate.aggregate"):
            return _aggregate_runs(sgk, v, found)

    return step


def _aggregate_runs(sgk, v, found):
    """Run-end (gk, sums, counts, mins, maxs, n_groups[1]) of the
    matched values ``v`` over the group-key runs of ``sgk``."""
    id_min, id_max = _minmax_identities(v.dtype)
    is_last = run_ends(sgk)
    heads = run_heads(is_last)
    # the invalid tail never counts: found is 0 there
    sums, counts, real, _flag, _ = run_totals(
        is_last, torch.where(found, v, 0), found.to(torch.int32))
    mins = segmented_scan(torch.where(found, v, id_min), heads, "min")
    maxs = segmented_scan(torch.where(found, v, id_max), heads, "max")
    mins = torch.where(real, mins, 0).to(v.dtype)
    maxs = torch.where(real, maxs, 0).to(v.dtype)
    out_gk = torch.where(real, sgk, -1)
    n_groups = real.sum(dtype=torch.int32).reshape(1)
    return out_gk, sums, counts, mins, maxs, n_groups


class BroadcastJoinAggregator(ExchangeModel):
    """Host-facing fused ``fact JOIN dim -> aggregateByKey`` for group
    keys derived from the join key.  Returns ``{group_key: KeyStats}``
    over matched fact rows (inner-join semantics)."""

    def join_aggregate(
        self,
        fact_keys,
        fact_vals,
        dim_keys,
        dim_vals,
        group_key_fn: Optional[GroupKeyFn] = None,
        agg_val_fn: Optional[AggValFn] = None,
    ) -> Dict[int, KeyStats]:
        """Hooks as in :func:`make_broadcast_join_aggregate_step`;
        ``None`` groups by the join key and aggregates the dimension
        value.  Group keys come back in the join key's signed domain."""
        if group_key_fn is None:
            group_key_fn = _identity_group_key
        lk, lv = _as_columns(fact_keys, fact_vals)
        rk, rv = _as_columns(dim_keys, dim_vals)
        nl = self._ladder(lk.shape[0])
        lk, lv, l_valid = _pad_to(lk, lv, nl)
        r_valid = np.ones(rk.shape[0], np.int32)
        step = make_broadcast_join_aggregate_step(
            self.n_devices, nl, rk.shape[0], group_key_fn, agg_val_fn,
            self.group)
        rows = step(*self._to_device(
            *(torch.from_numpy(x) for x in (lk, lv, l_valid, rk, rv,
                                            r_valid))))[:5]
        if self.n_devices > 1:
            rows = _gather_partials(self.group, rows)
        gk, sums, counts, mins, maxs = rows
        # transport words read as signed, then as the join key's dtype
        # (the _mask_output contract), so negative keys round-trip
        gk_h = gk.cpu().numpy().astype(lk.dtype, copy=False)
        sums_h, counts_h = sums.cpu().numpy(), counts.cpu().numpy()
        mins_h, maxs_h = mins.cpu().numpy(), maxs.cpu().numpy()

        def conv_for(a):
            return float if np.issubdtype(a.dtype, np.floating) else int

        c_sum, c_min, c_max = (conv_for(sums_h), conv_for(mins_h),
                               conv_for(maxs_h))
        out: Dict[int, KeyStats] = {}
        (idx,) = (counts_h > 0).nonzero()
        for i in idx:
            key = int(gk_h[i])
            st = KeyStats(c_sum(sums_h[i]), int(counts_h[i]),
                          c_min(mins_h[i]), c_max(maxs_h[i]))
            prev = out.get(key)
            if prev is not None:  # partial rows merge (two-phase combine)
                st = KeyStats(prev.sum + st.sum, prev.count + st.count,
                              min(prev.min, st.min), max(prev.max, st.max))
            out[key] = st
        return out


def _gather_partials(group: ExchangeGroup, rows):
    """Every rank's real partial rows (counts > 0), padded to the
    largest count with counts 0, all-gathered: [D * G] each."""
    real = rows[2] > 0
    rows = [r[real] for r in rows]
    (g,) = group.agree_max(rows[0].shape[0])
    if g == 0:
        return rows
    return [group.all_gather(torch.cat([r, r.new_zeros(g - r.shape[0])]))
            .reshape(-1) for r in rows]


def _identity_group_key(key_u):
    return key_u
