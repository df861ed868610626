"""Grouping sets over a packed key: SQL's ``GROUP BY ROLLUP(c1, ..,
cF)``, the nine grouping sets of TPC-DS query 67 over its eight
columns.

The columns are packed into one nonnegative int64 key, ``c1`` in the
most significant field (``field_bits`` gives each field's width, most
significant first).  Level ``l`` (0 .. F) is the grouping set that
keeps the first ``F - l`` columns: its key is the packed key with the
last ``l`` fields cleared (the rolled-up columns, NULL in SQL; the
level says which), and level F is the grand total.

The operator starts from the finest level's groups, sorted by the
packed key (a keyed reduction and a compaction give them).  Because
``c1`` is most significant, that one order already puts every coarser
level's groups in contiguous runs, so no level sorts:

- the levels at whose run end each group stands are read off one word:
  the xor of its key with the next group's has its top set bit in the
  first field that changes, and one ``bucketize`` of it against the
  fields' lowest bits counts the levels (the last group ends all);
- each level's rows are packed, in key order, behind the previous
  level's, by a prefix sum of its run-end flags (kernel 1's
  ``cumsum_1d``) and one scatter of the masked key and the running
  total of the finest sums at the run end;
- level 1 is read off the finest groups; every coarser level's run ends
  are run ends of level 1 too, so levels 2 .. F read only level 1's
  rows (a window of ``capacity - n_groups`` slots behind the finest
  groups, which the coarser levels' rows must fit);
- a row's sum is its running total less the previous row's of the
  same level (0 for a level's first row), as ``ops/segment.py``'s
  run-end layout differences its totals.

The output is level-major: level 0's rows, then level 1's, .., each in
key order, in ``capacity`` slots with the true row count and each
level's first slot, all on the device: the step never waits for the
host.  Coarser rows above ``capacity - n_groups`` mean rows were left
out, and the caller retries larger.  Sums accumulate in the sums' dtype
and wrap on overflow, as the keyed reductions' do.

The operator runs in the range ``rollup`` (``utils/trace.py``).  The
rows out of each level are counted on the device; :func:`level_rows`
reads them off ``starts`` where the caller reads the host anyway, and
adds them to the registry's ``rollup_rows_total{level=}``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from sparkrdma_tpu_torch.metrics import counter
from sparkrdma_tpu_torch.ops.scan_kernels import cumsum_1d
from sparkrdma_tpu_torch.ops.segment import shift
from sparkrdma_tpu_torch.utils.trace import stage

KEY_FILL = torch.iinfo(torch.int64).max


def level_low_bits(field_bits: Sequence[int]) -> List[int]:
    """The lowest key bit each level keeps, levels 0 .. F: level l
    clears the last l fields (level F keeps no bit: the whole width)."""
    low = [0]
    for b in reversed(field_bits):
        low.append(low[-1] + int(b))
    return low


def level_masks(field_bits: Sequence[int]) -> List[int]:
    """The key mask of each level, levels 0 .. F."""
    width = sum(int(b) for b in field_bits)
    return [((1 << width) - 1) >> b << b for b in level_low_bits(field_bits)]


def level_rows(starts) -> List[int]:
    """The rows out of each level of one step, from its ``starts`` (one
    host read), added to the registry's ``rollup_rows_total{level=}``."""
    at = starts.tolist()
    rows = [b - a for a, b in zip(at[:-1], at[1:])]
    for level, n in enumerate(rows):
        counter("rollup_rows_total", level=str(level)).inc(n)
    return rows


def _ends(keys, n, bounds, first: int, last: int):
    """One past the coarsest level each slot of the ascending ``keys``
    ends, from level ``first`` on (``bounds``: each level's lowest kept
    bit, as a power of two, from ``first``): a slot ends the levels
    whose bound its key's xor with the next key reaches.  Slot ``n - 1``
    ends every level (``last``), the slots past it none (0)."""
    iota = torch.arange(keys.shape[0], dtype=torch.int64,
                        device=keys.device)
    diff = keys ^ shift(keys, 0, back=True)
    ends = torch.bucketize(diff, bounds, right=True, out_int32=True) + first
    return torch.where(iota < n - 1, ends,
                       torch.where(iota == n - 1, last, 0))


def _place(out, ends, level: int, cols, start, dump, top: int):
    """The slots that end ``level`` (``ends > level``), in order, to
    ``out``'s slots from ``start`` on by one scatter a column; the rest
    to their own ``dump`` slot (as do rows past ``top``, the last).
    Returns how many end it (0-d)."""
    on = ends > level
    pos = cumsum_1d(on.to(torch.int32))
    dest = torch.where(on, pos + (start - 1), dump).clamp_(max=top)
    for o, c in zip(out, cols):
        o.scatter_(0, dest, c)
    return pos[-1]


def make_rollup_step(n_groups: int, capacity: int,
                     field_bits: Sequence[int]):
    """ROLLUP over the packed key's fields (module docstring).

    Returns fn(keys, sums, count) -> (keys', levels, sums', n_rows[1],
    starts[F + 2]): ``keys`` the [n_groups] int64 finest keys ascending,
    distinct below the one-element ``count`` (slots past it are
    ignored), ``sums`` their totals.  ``keys'`` (the level's masked key;
    int64 max past the rows), ``levels`` (int32; -1 past the rows) and
    ``sums'`` (0 past the rows) fill ``capacity`` slots level-major;
    ``starts[l]`` is level l's first slot and ``starts[F + 1]`` the
    row count, as is ``n_rows``.  The coarser levels' rows
    (``starts[F + 1] - starts[1]``) must fit ``capacity - n_groups``
    slots: more means rows were left out."""
    fields = [int(b) for b in field_bits]
    width = sum(fields)
    if not fields or min(fields) <= 0 or width > 62:
        raise ValueError(f"field widths must be positive and fit 62 bits: "
                         f"{fields}")
    if n_groups < 1 or capacity <= n_groups:
        raise ValueError(f"{n_groups} group slots, capacity {capacity}: "
                         f"need 1 <= groups < capacity")
    F = len(fields)
    masks = level_masks(fields)
    lows = level_low_bits(fields)[:F]
    window = capacity - n_groups
    spare = max(n_groups, window)
    top = capacity + spare - 1
    bounds_on = {}

    def step(keys, sums, count):
        dev = keys.device
        if dev not in bounds_on:
            bounds_on[dev] = torch.tensor([1 << b for b in lows],
                                          dtype=torch.int64, device=dev)
        bounds = bounds_on[dev]
        with stage("rollup"):
            n = count.reshape(()).to(torch.int64)
            csum = cumsum_1d(sums)
            # level 0 is the finest groups themselves, level 1 lands
            # behind them; past ``capacity`` a slot per row takes the
            # rows a level does not place
            out = (torch.full((capacity + spare,), KEY_FILL,
                              dtype=torch.int64, device=dev),
                   torch.zeros(capacity + spare, dtype=sums.dtype,
                               device=dev))
            out[0][:n_groups] = keys
            out[1][:n_groups] = csum
            dump = capacity + torch.arange(spare, dtype=torch.int64,
                                           device=dev)
            ends = _ends(keys, n, bounds, 0, F + 1)
            starts = [n.new_zeros(()), n]
            g1 = _place(out, ends, 1, (keys & masks[1], csum), n,
                        dump[:n_groups], top)
            starts.append(n + g1)
            # every coarser level's rows are level 1's rows that end it:
            # the later levels scan those alone, a window of the slots
            # level 1 may fill
            at = (n + torch.arange(window, device=dev)).clamp_(max=top)
            k1, c1 = out[0][at], out[1][at]
            ends = _ends(k1, g1, bounds[1:], 1, F + 1)
            for level in range(2, F + 1):
                g = _place(out, ends, level, (k1 & masks[level], c1),
                           starts[-1], dump[:window], top)
                starts.append(starts[-1] + g)
            starts = torch.stack(starts)
            total = starts[-1]
            r = torch.arange(capacity, dtype=torch.int64, device=dev)
            levels = torch.bucketize(r, starts[1:F + 1], right=True,
                                     out_int32=True)
            live = r < total
            c = out[1][:capacity]
            first = r == starts[levels.long()]
            rsums = torch.where(first, c, c - shift(c, 0))
            result = (torch.where(live, out[0][:capacity], KEY_FILL),
                      torch.where(live, levels, -1),
                      torch.where(live, rsums, 0).to(sums.dtype),
                      total.to(torch.int32).reshape(1), starts)
        return result

    return step
