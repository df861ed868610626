"""Plain reference of TPC-DS query 55 on one card's share, and its
control.

The answer is query 55's group table over the share: for each
``i_brand_id`` with a matched row, the sum (exact, int64 cents), count,
min and max of ``ss_ext_sales_price`` over the ``store_sales`` rows
whose date passes the date predicate and whose item passes the manager
predicate.  The joins are binary searches of each fact key in the
sorted dimension keys (``torch.searchsorted``), not the program's
sort-merge probes; the aggregate is ``scatter_add`` and
``scatter_reduce`` over the brands.

The tables come again from the seed (``inputs/tpcds_sf100.py``), never
from the program.  Plain torch; imports nothing of the program.

Numbers compared, each with limit 0 (exact):

- ``cells_wrong``: cells of the [4, brands] table (sum, count, min,
  max) that differ, plus output rows whose brand has no matched row or
  is repeated;
- ``matched_gap``: |matched fact rows - the answer's|.

The control (``control``) holds the price as a float32 of dollars, the
4-byte type a later change would be tempted to move it in, and sums it
as a scan-based aggregate does (the program's is one): a running total
in float32 over the rows in brand order, differenced at each brand's
last row.  It breaks the exact decimal sums the configuration states.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from shufflebench.common import module

LIMITS = {"cells_wrong": 0, "matched_gap": 0}
U32 = (1 << 32) - 1


def n_valid(output) -> int:
    return 0  # the group table has no row order across ranks


def _matches(config, seed: int, rank: int, device):
    """(brand, cents) int64 of every fact row of rank ``rank`` that
    passes both joins and their predicates."""
    import torch

    t = module("inputs", "tpcds_sf100").make_tables(config, seed, rank,
                                                    device)
    p = config["predicate"]

    def join(keys, dim_keys, dim_ok):
        i = torch.searchsorted(dim_keys, keys).clamp_(max=dim_keys.shape[0]
                                                      - 1)
        return i, (dim_keys[i] == keys) & dim_ok[i]

    date_ok = (t["d_year"] == p["d_year"]) & (t["d_moy"] == p["d_moy"])
    _i, hit = join(t["ss_date"], t["d_sk"], date_ok)
    item, cents = t["ss_item"][hit], t["ss_price"][hit]
    i, hit = join(item, t["i_sk"], t["i_manager"] == p["i_manager_id"])
    return t["i_brand"][i[hit]].long(), cents[hit].long()


def _table(brand, cents, float_sums: bool = False):
    """(brands, [4, brands] table) of sum, count, min and max."""
    import torch

    brands, g = torch.unique(brand, return_inverse=True)
    B = brands.shape[0]
    out = torch.zeros(4, B, dtype=torch.int64, device=brand.device)
    if float_sums:
        # a running total over the rows in brand order, differenced at
        # each brand's last row, as a scan-based aggregate sums
        order = torch.argsort(g, stable=True)
        total = torch.cumsum(cents[order].float() / 100, 0)
        ends = torch.cumsum(torch.bincount(g, minlength=B), 0) - 1
        at_end = total[ends]
        s = at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])
        out[0] = torch.round(s.double() * 100).long()
    else:
        out[0].scatter_add_(0, g, cents)
    out[1].scatter_add_(0, g, torch.ones_like(g))
    for i, how in ((2, "amin"), (3, "amax")):
        out[i] = out[i].scatter_reduce(0, g, cents, how, include_self=False)
    return brands, out


def judge(config, seed: int, world: int, rank: int, output, offset: int,
          device) -> Dict[str, int]:
    """The program's group table against the share's answer."""
    import torch

    brands, want = _table(*_matches(config, seed, rank, device))
    gk, sums, counts, mins, maxs = output[:5]
    real = counts > 0
    g = gk[real].long() & U32
    known = torch.zeros_like(g, dtype=torch.bool)
    i = torch.zeros_like(g)
    if brands.numel():
        i = torch.searchsorted(brands, g).clamp_(max=brands.shape[0] - 1)
        known = brands[i] == g
    i = i[known]
    stray = int((~known).sum()) + i.numel() - torch.unique(i).numel()
    got = torch.zeros_like(want)
    for r, x in enumerate((sums, counts, mins, maxs)):
        got[r, i] = x[real][known].long()
    return {"cells_wrong": int((got != want).sum()) + stray,
            "matched_gap": abs(int(counts[real].long().sum())
                               - int(want[1].sum()))}


def combine(readings: Sequence[Dict[str, int]], config,
            world: int) -> Dict[str, int]:
    (r,) = readings  # one card
    return dict(r)


def control(config, seed: int, world: int, rank: int, offset: int, nv: int,
            rows_out: int, device) -> List[object]:
    """The control's table in the program's run-end layout: one row
    per brand, sums of a float32 running total of dollars."""
    import torch

    brands, t = _table(*_matches(config, seed, rank, device),
                       float_sums=True)
    return [brands.to(torch.int32), t[0], t[1], t[2], t[3]]
