"""Keyed reductions over one device's rows, and the run-end layout
they share: the port of ``sparkrdma_tpu/ops/segment.py``.

Sort the keys once, take prefix sums, and read per-run totals at
run-end positions through a forward fill.  Results stay at their
run-end positions: entries are valid where ``counts > 0``.  Every scan
and fill goes through :func:`~sparkrdma_tpu_torch.ops.scan_kernels.
scan_flagged`, which runs the CUDA kernel on a CUDA tensor and its
plain version on a CPU tensor.  Sums accumulate in the value dtype and
wrap on overflow (JVM Int/Long semantics, as in the JAX package).

This module owns the run-end layout.  Its callers (the two reductions
here, ``models/join_aggregate.py``, ``models/topk.py``) use
:func:`run_ends` and :func:`run_heads` (the runs' last and first
slots), :func:`shift` (a column moved one slot), :func:`prev_run_end`
(each column at the previous run end, by one launch of kernel 1's
fill) and :func:`run_totals` (per-run sums and counts as differences
of two prefix sums).

:func:`compact_flagged` packs the rows a predicate keeps (a HAVING
over the run-end layout, a join's matched rows) into a fixed-capacity
buffer on the device, without a host synchronisation, so that a later
step can consume them as the run-end layout's callers consume ``counts
> 0`` on the host.

The reductions run in the ranges ``keyed.sort`` (the sort and the
value gather) and ``keyed.scan`` (the cumsums, the fill and the run-end
arithmetic), the compaction in ``keyed.compact`` (``utils/trace.py``),
and each adds its rows in to the registry's
``keyed_rows_total{op=reduce|aggregate|compact}``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.ops.lexsort import (
    perm_by_key_invalid,
    perm_by_key_invalid_value,
    perm_by_key_value,
)
from sparkrdma_tpu_torch.ops.scan_kernels import cumsum_1d, scan_flagged
from sparkrdma_tpu_torch.utils.trace import stage

def segmented_scan(vals: torch.Tensor, heads: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Inclusive segmented scan: ``out[i]`` combines ``vals`` with ``op``
    (``"add"``, ``"min"`` or ``"max"``) from the nearest segment head at
    or before ``i`` through ``i``.  The JAX version takes the op and its
    identity; here the kind names both (0, dtype max, dtype min)."""
    if op not in ("add", "min", "max"):
        raise ValueError(f"unsupported segmented_scan op {op!r}")
    _f, (out,) = scan_flagged(op, heads, (vals,))
    return out


def _ff_run_carry(is_last: torch.Tensor, columns):
    """Forward fill of ``columns`` from run-END positions: position i
    holds each column's value at the latest run end at or before i.
    Positions before the first end are unspecified and flagged False.
    Returns (filled_flag, columns)."""
    return scan_flagged("fill", is_last, tuple(columns))


def run_ends(*cols: torch.Tensor) -> torch.Tensor:
    """The run-end mask of a stream sorted by ``cols``: True where any
    column changes at the next slot, and on the last slot."""
    first, *rest = cols
    bound = first[1:] != first[:-1]
    for c in rest:
        bound = bound | (c[1:] != c[:-1])
    return torch.cat([bound, bound.new_ones(min(first.shape[0], 1))])


def run_heads(is_last: torch.Tensor) -> torch.Tensor:
    """The run-head mask (each run's first slot) from the run-end mask:
    the last slot always ends a run, so the run ends rotated one slot
    later are the heads, with no fill."""
    return torch.cat([is_last[-1:], is_last[:-1]])


def shift(x: torch.Tensor, fill, back: bool = False) -> torch.Tensor:
    """``x`` moved one slot later (``out[i] = x[i - 1]``), or with
    ``back`` one slot earlier (``out[i] = x[i + 1]``); the slot left
    free holds ``fill``."""
    edge = x.new_full((min(x.shape[0], 1),), fill)
    return torch.cat([x[1:], edge] if back else [edge, x[:-1]])


def prev_run_end(is_last: torch.Tensor, cols):
    """Each column's value at the latest run end strictly before each
    slot (0 where there is none): one launch of kernel 1's fill from
    the run ends of ``is_last``, then :func:`shift`.  Returns ``(flag,
    cols)``, ``flag`` true from the first run end on."""
    flag, filled = _ff_run_carry(is_last, cols)
    return flag, [shift(torch.where(flag, c, c.new_zeros(())), 0)
                  for c in filled]


def run_totals(is_last: torch.Tensor, vals: torch.Tensor,
               marks: torch.Tensor, carry=()):
    """Sums of ``vals`` and counts of the int32 0/1 ``marks`` at each run
    end of ``is_last`` (0 elsewhere), and ``real = counts > 0``.  The
    ``carry`` columns ride the same fill to the previous run end.
    Returns ``(sums, counts, real, flag, carried)``, ``flag`` and
    ``carried`` as :func:`prev_run_end` gives them."""
    csum_v = cumsum_1d(vals)
    csum_m = cumsum_1d(marks)
    flag, (prev_v, prev_m, *carried) = prev_run_end(
        is_last, (csum_v, csum_m, *carry))
    counts = torch.where(is_last, csum_m - prev_m, 0).to(torch.int32)
    real = counts > 0
    sums = torch.where(real, csum_v - prev_v, 0).to(vals.dtype)
    return sums, counts, real, flag, carried


def _sentinel(keys: torch.Tensor) -> int:
    return torch.iinfo(keys.dtype).max


def _gather(perm: torch.Tensor, *cols):
    return tuple(c[perm] for c in cols)


def reduce_by_key_local(
    keys: torch.Tensor, vals: torch.Tensor, valid: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum values by key over one device's rows.

    ``valid`` is an int32 0/1 indicator, or ``None`` when every slot is
    real (drops the validity operand from the sort).  Invalid slots
    must be pre-masked to (key = dtype max, value = 0, valid = 0);
    real keys equal to the dtype max still count correctly because
    validity is tracked explicitly.

    Returns ``(unique_keys, sums, counts, n_unique)``: full-length
    tensors whose run-end positions hold each distinct real key, its
    sum and its count; other positions hold (dtype max, 0, 0).
    """
    n = keys.shape[0]
    counter("keyed_rows_total", op="reduce").inc(n)
    with stage("keyed.sort"):
        if valid is None:
            ks, perm = torch.sort(keys, stable=True)
            (vs,) = _gather(perm, vals)
            ms = torch.ones(n, dtype=torch.int32, device=keys.device)
        else:
            inv = 1 - valid.to(torch.int32)
            perm = perm_by_key_invalid(keys, inv)
            ks, inv_s, vs = _gather(perm, keys, inv, vals)
            ms = 1 - inv_s
    with stage("keyed.scan"):
        sums, counts, real, _flag, _ = run_totals(run_ends(ks), vs, ms)
        uniq = torch.where(real, ks, _sentinel(keys))
        n_unique = real.sum(dtype=torch.int32)
    return uniq, sums, counts, n_unique


def aggregate_by_key_local(
    keys: torch.Tensor, vals: torch.Tensor, valid: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Sum, count, min and max per distinct key in one pass (the
    device-side combineByKey).

    Same masking contract and run-end layout as
    :func:`reduce_by_key_local`.  Values join the sort key, so a run's
    slots ascend by value: its max is the run-end slot itself and its
    min is the slot right after the previous run's end, which rides the
    forward fill as a next-value column.  Runs are delimited on
    (key, validity), so a real run is all-valid even when a real key
    equals the sentinel.

    Returns ``(unique_keys, sums, counts, mins, maxs, n_unique)``.
    """
    n = keys.shape[0]
    counter("keyed_rows_total", op="aggregate").inc(n)
    with stage("keyed.sort"):
        if valid is None:
            perm = perm_by_key_value(keys, vals)
            ks, vs = _gather(perm, keys, vals)
            ms = torch.ones(n, dtype=torch.int32, device=keys.device)
        else:
            inv = 1 - valid.to(torch.int32)
            perm = perm_by_key_invalid_value(keys, inv, vals)
            ks, inv_s, vs = _gather(perm, keys, inv, vals)
            ms = 1 - inv_s
    with stage("keyed.scan"):
        is_last = run_ends(ks) if valid is None else run_ends(ks, inv_s)
        sums, counts, real, flag, (prev_next,) = run_totals(
            is_last, vs, ms, (shift(vs, 0, back=True),))
        maxs = torch.where(real, vs, 0).to(vals.dtype)
        # run 0 has no previous end: its min is the globally first slot
        mins = torch.where(shift(flag, False), prev_next, vs[:1])
        mins = torch.where(real, mins, 0).to(vals.dtype)
        uniq = torch.where(real, ks, _sentinel(keys))
        n_unique = real.sum(dtype=torch.int32)
    return uniq, sums, counts, mins, maxs, n_unique


def compact_flagged(
    flag: torch.Tensor, columns: Sequence[torch.Tensor], capacity: int,
    fill_values: Sequence[object],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The rows where the bool ``flag`` is set, in their order, packed
    into ``[capacity]`` columns, without a host synchronisation.

    Returns ``(columns, count)``: slot j < min(count, capacity) holds the
    (j + 1)-th flagged row of each column, every later slot its column's
    fill value, and ``count`` is the true number of flagged rows as a
    one-element int32 device tensor.  A count above ``capacity`` means
    rows were left out: the caller retries with a larger capacity, as
    ``models/_base.py`` retries a bucket overflow.  Rows number fewer
    than 2**31.

    Each row's 1-based position among the flagged rows is the running
    count of the flags (:func:`~sparkrdma_tpu_torch.ops.scan_kernels.
    cumsum_1d`, kernel 1 on a CUDA tensor); slot j then takes the first
    row whose position reaches j + 1 (a binary search of the ``capacity``
    slots in the positions) and one gather of ``capacity`` rows per
    column, so the work past the cumsum is that of the slots and not of
    the rows.
    """
    n = flag.shape[0]
    dev = flag.device
    counter("keyed_rows_total", op="compact").inc(n)
    with stage("keyed.compact"):
        if n == 0:
            return ([torch.full((capacity,), f, dtype=c.dtype, device=dev)
                     for c, f in zip(columns, fill_values)],
                    torch.zeros(1, dtype=torch.int32, device=dev))
        pos = cumsum_1d(flag.to(torch.int32))
        count = pos[-1:].clone()
        slot = torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
        src = torch.searchsorted(pos, slot).clamp_(max=n - 1)
        live = slot <= count
        out = [torch.where(live, c[src], f).to(c.dtype)
               for c, f in zip(columns, fill_values)]
    return out, count
