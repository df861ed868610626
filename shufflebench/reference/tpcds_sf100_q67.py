"""Plain reference of TPC-DS query 67 on one card's share, and its
control.

The answer is every row of the query's rollup whose ``rank()`` within
its ``i_category`` is at most ``rank_limit``: its 8 columns (NULL, -1,
in the columns its grouping set rolls up), its level (the number of
columns rolled up), ``sumsales`` and ``rk``.  It is computed apart from
the program's plan:

- the joins are binary searches of each fact key in the sorted
  dimension keys (``torch.searchsorted``), not sort-merge probes;
- each of the nine grouping sets is aggregated on its own: its columns'
  values, each numbered by ``torch.unique``, make one mixed-radix key,
  whose ``torch.unique`` groups the rows and whose ``index_add_`` sums
  them (int64 cents), not one packed key's sort and run ends;
- the rank sorts every row by (category, sum descending) with two
  stable ``argsort``s and counts ties from the first index of each equal
  value with ``torch.cummax``, not the program's fills.

The tables come again from the seed (``inputs/tpcds_sf100_q67.py``),
never from the program.  Plain torch; imports nothing of the program.

Numbers compared, each with limit 0 (exact):

- ``rows_wrong``: output rows that are not rows of the answer (any of
  the eight columns, the level, ``sumsales`` or ``rk`` differing) or
  repeat one, plus answer rows the output lacks;
- ``count_gap``: |the program's count of kept rows - the answer's|;
- ``rollup_rows_wrong``: the same count over every row of the nine
  grouping sets before the rank (the eight columns, the level and
  ``sumsales``).  At the cell's size the rank keeps rows of the four
  coarsest levels alone, whose NULL columns hide the product, date and
  store fields: this number judges the finer levels and those fields.
  The program hands its rollup's rows over as packed keys, unpacked
  here by the configuration's ``group_key``.

The control (``control``) sums ``sumsales`` as float32 scan totals, as
a scan-based aggregate would in that type: a float32 running total over
each grouping set's rows in group order, differenced at each group's
last row.  Past 2^24 cents the running total loses cents, so sums, and
the ranks they decide, come out wrong.  It breaks the exact sums the
configuration states.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from shufflebench.common import module

LIMITS = {"rows_wrong": 0, "count_gap": 0, "rollup_rows_wrong": 0}
COLUMNS = 8
FIELDS = COLUMNS + 3  # the columns, level, sumsales, rk
# the output's layout: FIELDS kept-row columns, the kept count, then
# the rollup's packed keys, levels, sums and row count
KEPT_COUNT, ROLLUP = FIELDS, FIELDS + 1


def n_valid(output) -> int:
    return 0  # one card: no row order across ranks


def _joined(config, seed: int, rank: int, device):
    """([8, m] int64 columns, [m] int64 sales) of the share's rows that
    pass the three joins and the month predicate."""
    import torch

    t = module("inputs", "tpcds_sf100_q67").make_tables(config, seed, rank,
                                                        device)

    def lookup(keys, dim_keys):
        i = torch.searchsorted(dim_keys, keys).clamp_(
            max=dim_keys.shape[0] - 1)
        return i, dim_keys[i] == keys

    first, last = (int(m) for m in config["month_seq"])
    d, hit = lookup(t["ss_date"], t["d_sk"])
    seq = t["d_month_seq"][d]
    hit &= (seq >= first) & (seq <= last)
    i, hit_i = lookup(t["ss_item"], t["i_sk"])
    s, hit_s = lookup(t["ss_store"], t["s_sk"])
    hit &= hit_i & hit_s
    d, i, s = d[hit], i[hit], s[hit]
    cols = torch.stack([t["i_category"][i], t["i_class"][i],
                        t["i_brand"][i], t["i_sk"][i], t["d_year"][d],
                        t["d_qoy"][d], t["d_moy"][d],
                        t["s_store_id"][s]]).long()
    sales = t["ss_quantity"][hit].long() * t["ss_sales_price"][hit].long()
    return cols, sales


def _group_sums(inv, sales, groups: int, float_sums: bool):
    import torch

    if float_sums:
        # a running total over the rows in group order, differenced at
        # each group's last row, as a scan-based aggregate sums
        order = torch.argsort(inv, stable=True)
        total = torch.cumsum(sales[order].float(), 0)
        ends = torch.cumsum(torch.bincount(inv, minlength=groups), 0) - 1
        at_end = total[ends]
        return torch.round(
            at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])).long()
    sums = torch.zeros(groups, dtype=torch.int64, device=sales.device)
    sums.index_add_(0, inv, sales)
    return sums


def _rollup(config, seed: int, rank: int, device, float_sums=False):
    """[10, r] int64 rows of every grouping set (8 columns, level,
    sumsales), grouping set by grouping set."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cols, sales = _joined(config, seed, rank, device)
    m = cols.shape[1]
    # each column's values numbered 0 .. distinct - 1: the digits of a
    # mixed-radix key per grouping set
    digits, radix = [], []
    for c in cols:
        u, d = torch.unique(c, return_inverse=True)
        digits.append(d)
        radix.append(int(u.shape[0]))
    rows = []
    for level in range(COLUMNS + 1):
        kept = COLUMNS - level
        key = torch.zeros(m, dtype=torch.int64, device=cols.device)
        for c in range(kept):
            key = key * radix[c] + digits[c]
        _u, inv = torch.unique(key, return_inverse=True)
        groups = int(_u.shape[0])
        block = torch.full((COLUMNS + 2, groups), -1, dtype=torch.int64,
                           device=cols.device)
        for c in range(kept):
            block[c].scatter_(0, inv, cols[c])
        block[COLUMNS] = level
        block[COLUMNS + 1] = _group_sums(inv, sales, groups, float_sums)
        rows.append(block)
    return torch.cat(rows, 1)


def _ranked(rows, rank_limit: int):
    """[11, k] int64 rows of the answer: the rollup's ``rows`` with
    their ``rank()`` within ``i_category`` (the grand total a partition
    of its own), those at most ``rank_limit``."""
    import torch

    part = torch.where(rows[COLUMNS] == COLUMNS, -1, rows[0])
    order = torch.argsort(rows[COLUMNS + 1], descending=True, stable=True)
    order = order[torch.argsort(part[order], stable=True)]
    p, s = part[order], rows[COLUMNS + 1][order]
    idx = torch.arange(p.shape[0], device=p.device)
    new_part = torch.ones_like(p, dtype=torch.bool)
    new_part[1:] = p[1:] != p[:-1]
    new_tie = new_part.clone()
    new_tie[1:] |= s[1:] != s[:-1]
    part_start = torch.cummax(torch.where(new_part, idx, 0), 0).values
    tie_start = torch.cummax(torch.where(new_tie, idx, 0), 0).values
    rk = tie_start - part_start + 1
    out = torch.cat([rows[:, order], rk[None]])
    return out[:, rk <= rank_limit]


def _answer(config, seed: int, rank: int, device, float_sums=False):
    """[11, k] int64 rows of the answer (8 columns, level, sumsales,
    rk)."""
    return _ranked(_rollup(config, seed, rank, device, float_sums),
                   int(config["rank_limit"]))


def _layout(config):
    """Each column's shift and width in the packed key and the year's
    base, from the configuration's ``group_key``."""
    g = config["group_key"]
    bits = [int(b) for b in g["bits"]]
    return ([sum(bits[i + 1:]) for i in range(COLUMNS)], bits,
            int(g["year_base"]))


def _unpack(config, keys, levels):
    """[8, r] int64 columns of packed keys; NULL, -1, in the columns a
    row's level rolls up."""
    import torch

    shifts, bits, year_base = _layout(config)
    cols = []
    for i in range(COLUMNS):
        v = (keys >> shifts[i]) & ((1 << bits[i]) - 1)
        if i == 4:
            v = v + year_base
        cols.append(torch.where(levels < COLUMNS - i, v, -1))
    return torch.stack(cols)


def _pack(config, cols):
    """The packed keys of [8, r] columns (the inverse of
    :func:`_unpack`; a NULL column packs as 0)."""
    import torch

    shifts, _bits, year_base = _layout(config)
    key = torch.zeros_like(cols[0])
    for i in range(COLUMNS):
        v = cols[i] - year_base if i == 4 else cols[i]
        key |= torch.where(cols[i] >= 0, v, 0) << shifts[i]
    return key


def _rows(output):
    """The program's kept rows as [11, k] int64 and its kept count."""
    import torch

    cols, n_kept = output[:FIELDS], int(output[KEPT_COUNT][0])
    k = min(n_kept, cols[0].shape[0])
    return torch.stack([c[:k].long() for c in cols]), n_kept


def _rollup_rows(config, output):
    """The program's rollup rows as [10, r] int64 (8 columns, level,
    sumsales)."""
    import torch

    keys, levels, sums, n_rows = output[ROLLUP:ROLLUP + 4]
    r = min(int(n_rows[0]), keys.shape[0])
    levels = levels[:r].long()
    return torch.cat([_unpack(config, keys[:r].long(), levels),
                      levels[None], sums[:r].long()[None]])


def _lexsorted(rows):
    """The columns of [F, n] ``rows`` in lexicographic order."""
    import torch

    order = torch.arange(rows.shape[1], device=rows.device)
    for f in reversed(range(rows.shape[0])):
        order = order[torch.argsort(rows[f][order], stable=True)]
    return rows[:, order]


def _wrong(got, want) -> int:
    """Rows of ``got`` that are not rows of ``want`` (distinct rows) or
    repeat one, plus rows of ``want`` that ``got`` lacks."""
    import torch

    def distinct(rows):
        rows = _lexsorted(rows)
        new = torch.ones(rows.shape[1], dtype=torch.bool,
                         device=rows.device)
        new[1:] = (rows[:, 1:] != rows[:, :-1]).any(0)
        return rows[:, new]

    both = _lexsorted(torch.cat([distinct(got), want], 1))
    matched = int((both[:, 1:] == both[:, :-1]).all(0).sum())
    return got.shape[1] - matched + want.shape[1] - matched


def judge(config, seed: int, world: int, rank: int, output, offset: int,
          device) -> Dict[str, int]:
    """The program's kept rows and rollup rows against the share's
    answer."""
    every = _rollup(config, seed, rank, device)
    want = _ranked(every, int(config["rank_limit"]))
    got, n_kept = _rows(output)
    got = got.to(want.device)
    rollup_got = _rollup_rows(config, output).to(want.device)
    return {"rows_wrong": _wrong(got, want),
            "count_gap": abs(n_kept - want.shape[1]),
            "rollup_rows_wrong": _wrong(rollup_got, every)}


def combine(readings: Sequence[Dict[str, int]], config,
            world: int) -> Dict[str, int]:
    (r,) = readings  # one card
    return dict(r)


def control(config, seed: int, world: int, rank: int, offset: int, nv: int,
            rows_out: int, device) -> List[object]:
    """The control's kept rows and rollup rows in the program's layout:
    ``rows_out`` slots of each kept-row field, the kept count, then the
    rollup's packed keys, levels, sums and row count."""
    import torch

    every = _rollup(config, seed, rank, device, float_sums=True)
    rows = _ranked(every, int(config["rank_limit"]))
    k = min(rows.shape[1], rows_out)
    out = []
    for r in range(FIELDS):
        c = torch.zeros(rows_out, dtype=torch.int64, device=device)
        c[:k] = rows[r, :k]
        out.append(c)
    count = every.shape[1]
    return out + [
        torch.tensor([rows.shape[1]], dtype=torch.int32, device=device),
        _pack(config, every[:COLUMNS]).to(device),
        every[COLUMNS].to(device), every[COLUMNS + 1].to(device),
        torch.tensor([count], dtype=torch.int32, device=device)]
