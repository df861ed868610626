"""Keyed reductions over one device's rows: the port of
``sparkrdma_tpu/ops/segment.py``.

Sort the keys once, take prefix sums, and read per-run totals at
run-end positions through a forward fill.  Results stay at their
run-end positions: entries are valid where ``counts > 0``.  Every scan
and fill goes through :func:`~sparkrdma_tpu_torch.ops.scan_kernels.
scan_flagged`, which runs the CUDA kernel on a CUDA tensor and its
plain version on a CPU tensor.  Sums accumulate in the value dtype and
wrap on overflow (JVM Int/Long semantics, as in the JAX package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparkrdma_tpu_torch.ops.lexsort import (
    perm_by_key_invalid,
    perm_by_key_invalid_value,
    perm_by_key_value,
)
from sparkrdma_tpu_torch.ops.scan_kernels import cumsum_1d, scan_flagged

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


def _prev_end(flag: torch.Tensor, cols):
    """Shift the filled run-end carry right by one: position i sees the
    latest run end STRICTLY before i (zeros when there is none)."""
    out = []
    for c in cols:
        masked = torch.where(flag, c, torch.zeros((), dtype=c.dtype,
                                                  device=c.device))
        out.append(torch.cat([masked.new_zeros(1), masked[:-1]]))
    return out


def _sentinel(keys: torch.Tensor) -> int:
    return torch.iinfo(keys.dtype).max


def _trues(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


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
    if valid is None:
        ks, perm = torch.sort(keys, stable=True)
        (vs,) = _gather(perm, vals)
        ms = torch.ones(n, dtype=torch.int32, device=keys.device)
    else:
        inv = 1 - valid.to(torch.int32)
        perm = perm_by_key_invalid(keys, inv)
        ks, inv_s, vs = _gather(perm, keys, inv, vals)
        ms = 1 - inv_s
    csum_v = cumsum_1d(vs)
    csum_m = cumsum_1d(ms)
    is_last = torch.cat([ks[1:] != ks[:-1], _trues(1, keys.device)])
    flag, (fv, fm) = _ff_run_carry(is_last, (csum_v, csum_m))
    prev_v, prev_m = _prev_end(flag, (fv, fm))
    counts = torch.where(is_last, csum_m - prev_m, 0).to(torch.int32)
    real = counts > 0
    sums = torch.where(real, csum_v - prev_v, 0).to(vals.dtype)
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
    if valid is None:
        perm = perm_by_key_value(keys, vals)
        ks, vs = _gather(perm, keys, vals)
        ms = torch.ones(n, dtype=torch.int32, device=keys.device)
        bound = ks[1:] != ks[:-1]
    else:
        inv = 1 - valid.to(torch.int32)
        perm = perm_by_key_invalid_value(keys, inv, vals)
        ks, inv_s, vs = _gather(perm, keys, inv, vals)
        ms = 1 - inv_s
        bound = (ks[1:] != ks[:-1]) | (inv_s[1:] != inv_s[:-1])
    csum_v = cumsum_1d(vs)
    csum_m = cumsum_1d(ms)
    is_last = torch.cat([bound, _trues(1, keys.device)])
    vs_next = torch.cat([vs[1:], vs.new_zeros(1)])
    flag, (fv, fm, fnext) = _ff_run_carry(is_last, (csum_v, csum_m, vs_next))
    prev_v, prev_m, prev_next = _prev_end(flag, (fv, fm, fnext))
    counts = torch.where(is_last, csum_m - prev_m, 0).to(torch.int32)
    real = counts > 0
    sums = torch.where(real, csum_v - prev_v, 0).to(vals.dtype)
    maxs = torch.where(real, vs, 0).to(vals.dtype)
    # run 0 has no previous end: its min is the globally first slot
    had_prev = torch.cat([flag.new_zeros(1), flag[:-1]])
    mins = torch.where(had_prev, prev_next, vs[:1])
    mins = torch.where(real, mins, 0).to(vals.dtype)
    uniq = torch.where(real, ks, _sentinel(keys))
    n_unique = real.sum(dtype=torch.int32)
    return uniq, sums, counts, mins, maxs, n_unique
