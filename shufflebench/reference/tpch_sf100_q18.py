"""Plain reference of TPC-H query 18 on one card's share, and its
control.

The answer is every order of the share whose lines' ``l_quantity`` sum
past ``having_quantity``, with its ``o_custkey``, ``o_orderdate``,
``o_totalprice`` and that sum, ascending by order key.  The sums are
``torch.unique`` of the order keys and an int64 ``index_add_``, not the
program's sort and scans; the join with ``orders`` is a binary search of
each survivor in the sorted order keys (``torch.searchsorted``), not
the program's sort-merge probe.

The tables come again from the seed (``inputs/tpch_sf100_q18.py``),
never from the program.  Plain torch; imports nothing of the program.

Numbers compared, each with limit 0 (exact), over the whole qualifying
set:

- ``rows_wrong``: output rows any of whose five columns differs from
  the answer's row of that order, plus output orders the answer lacks
  or repeats, plus answer orders the output lacks;
- ``survivor_gap``: |the program's count of HAVING survivors - the
  answer's|.

The control (``control``) carries ``l_quantity`` as float32 and sums it
as a scan-based aggregate does: a float32 running total over the rows
in order-key order, differenced at each order's last row.  Past 2^24
the running total loses units, sums come out wrong and HAVING decisions
flip.  It breaks the exact sums the configuration states.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from shufflebench.common import module

LIMITS = {"rows_wrong": 0, "survivor_gap": 0}
COLUMNS = 5  # o_orderkey, o_custkey, o_orderdate, o_totalprice, sum


def n_valid(output) -> int:
    return 0  # one card: no row order across ranks


def _answer(config, seed: int, rank: int, device, float_sums=False):
    """([5, k] int64 rows of the answer ascending by order key, the
    number of HAVING survivors)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = module("inputs", "tpch_sf100_q18").make_tables(config, seed, rank,
                                                       device)
    keys, inv = torch.unique(t["l_orderkey"], return_inverse=True)
    qty = t["l_quantity"]
    del t["l_orderkey"], t["l_quantity"]
    if float_sums:
        # a running total over the rows in key order, differenced at
        # each order's last row, as a scan-based aggregate sums
        order = torch.argsort(inv, stable=True)
        total = torch.cumsum(qty[order].float(), 0)
        del order
        ends = torch.cumsum(torch.bincount(inv, minlength=keys.shape[0]),
                            0) - 1
        at_end = total[ends]
        sums = torch.round(
            at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])).long()
    else:
        sums = torch.zeros(keys.shape[0], dtype=torch.int64, device=device)
        sums.index_add_(0, inv, qty.long())
    del inv, qty
    hit = sums > int(config["having_quantity"])
    s_key, s_sum = keys[hit].long(), sums[hit]
    o_sorted, o_perm = torch.sort(t["o_orderkey"].long())
    i = torch.searchsorted(o_sorted, s_key).clamp_(max=o_sorted.shape[0]
                                                   - 1)
    match = o_sorted[i] == s_key
    rows = o_perm[i[match]]
    answer = torch.stack([s_key[match], t["o_custkey"][rows].long(),
                          t["o_orderdate"][rows].long(),
                          t["o_totalprice"][rows].long(), s_sum[match]])
    return answer, int(hit.sum())


def _rows(output):
    """The program's matched rows as [5, k] int64 and its survivor
    count."""
    import torch

    *cols, n_surv, n_out = output
    k = min(int(n_out[0]), cols[0].shape[0])
    return torch.stack([c[:k].long() for c in cols]), int(n_surv[0])


def judge(config, seed: int, world: int, rank: int, output, offset: int,
          device) -> Dict[str, int]:
    """The program's qualifying orders against the share's answer."""
    import torch

    want, survivors = _answer(config, seed, rank, device)
    got, got_survivors = _rows(output)
    keys = want[0]
    known = torch.zeros(got.shape[1], dtype=torch.bool, device=got.device)
    i = torch.zeros(got.shape[1], dtype=torch.int64, device=got.device)
    if keys.numel():
        i = torch.searchsorted(keys, got[0]).clamp_(max=keys.shape[0] - 1)
        known = keys[i] == got[0]
    i_known = i[known]
    found = torch.unique(i_known).numel()
    stray = int((~known).sum()) + i_known.numel() - found
    differ = int((got[:, known] != want[:, i_known]).any(0).sum())
    missing = keys.numel() - found
    return {"rows_wrong": stray + differ + missing,
            "survivor_gap": abs(got_survivors - survivors)}


def combine(readings: Sequence[Dict[str, int]], config,
            world: int) -> Dict[str, int]:
    (r,) = readings  # one card
    return dict(r)


def control(config, seed: int, world: int, rank: int, offset: int, nv: int,
            rows_out: int, device) -> List[object]:
    """The control's answer in the program's layout: ``rows_out`` slots
    of each column, then its survivor and row counts."""
    import torch

    rows, survivors = _answer(config, seed, rank, device, float_sums=True)
    k = min(rows.shape[1], rows_out)
    cols = []
    for r in range(COLUMNS):
        c = torch.zeros(rows_out, dtype=torch.int64, device=device)
        c[:k] = rows[r, :k]
        cols.append(c)
    count = torch.tensor([rows.shape[1]], dtype=torch.int32, device=device)
    return cols + [torch.tensor([survivors], dtype=torch.int32,
                                device=device), count]
