"""The plain references: they pass the program, fail planted wrong
outputs, and fail their controls."""

import torch

from shufflebench import common
from shufflebench.tests import sizes


def _cfg(name, small):
    return dict(common.data("configs", name), **small)


def _terasort_output(cfg, seed, capacity):
    """The answer as the program lays it out on one card."""
    ins = common.module("inputs", "hibench_terasort")
    k = ins.make_keys(cfg, seed, 0, "cpu")
    p = ins.make_payload(cfg, seed, 0, "cpu")
    sk, perm = torch.sort(k, stable=True)
    n = k.shape[0]
    out_k = torch.full((capacity,), torch.iinfo(torch.int64).max)
    out_k[:n] = sk
    out_p = torch.zeros((capacity, p.shape[1]), dtype=torch.int32)
    out_p[:n] = p[perm]
    return [out_k, out_p, torch.tensor([n], dtype=torch.int32)]


def test_terasort_judge_right_and_wrong():
    ref = common.module("reference", "hibench_terasort")
    cfg = _cfg("hibench_terasort", sizes.TERASORT)
    out = _terasort_output(cfg, 7, 5328)
    r = ref.judge(cfg, 7, 1, 0, out, 0, "cpu")
    assert ref.combine([r], cfg, 1) == {"rows_wrong": 0, "count_gap": 0,
                                         "pad_wrong": 0}
    out[1][5, 3] += 1
    out[0][4096] = 0
    out[2][0] = 4000
    got = ref.combine([ref.judge(cfg, 7, 1, 0, out, 0, "cpu")], cfg, 1)
    assert got["rows_wrong"] == 1 and got["count_gap"] == 96
    # 96 real rows past n_valid (key and payload each), 1 padding key
    assert got["pad_wrong"] == 2 * 96 + 1


def test_terasort_control_fails_where_keys_tie_in_32_bits():
    ref = common.module("reference", "hibench_terasort")
    cfg = _cfg("hibench_terasort", sizes.TERASORT_TIES)
    n = sizes.TERASORT_TIES["records_per_card"]
    out = ref.control(cfg, 11, 1, 0, 0, n, n, "cpu")
    got = ref.combine([ref.judge(cfg, 11, 1, 0, out, 0, "cpu")], cfg, 1)
    assert got["rows_wrong"] > ref.LIMITS["rows_wrong"]
    exact = _terasort_output(cfg, 11, n)
    assert ref.judge(cfg, 11, 1, 0, exact, 0, "cpu")["rows_wrong"] == 0


def _tpcds_loop(cfg, seed):
    """Query 55's group table by a plain loop over the rows:
    {brand: [sum, count, min, max]}."""
    t = common.module("inputs", "tpcds_sf100").make_tables(cfg, seed, 0,
                                                           "cpu")
    p = cfg["predicate"]
    days = {k for k, y, m in zip(t["d_sk"].tolist(), t["d_year"].tolist(),
                                  t["d_moy"].tolist())
            if (y, m) == (p["d_year"], p["d_moy"])}
    items = {k: b for k, b, m in zip(t["i_sk"].tolist(),
                                      t["i_brand"].tolist(),
                                      t["i_manager"].tolist())
             if m == p["i_manager_id"]}
    table = {}
    for d, i, c in zip(t["ss_date"].tolist(), t["ss_item"].tolist(),
                       t["ss_price"].tolist()):
        if d in days and i in items:
            row = table.setdefault(items[i], [0, 0, c, c])
            row[0] += c
            row[1] += 1
            row[2], row[3] = min(row[2], c), max(row[3], c)
    return table


def _tpcds_output(table):
    """The loop's table in the program's run-end layout."""
    brands = sorted(table)
    cols = [torch.tensor(brands, dtype=torch.int32)]
    cols += [torch.tensor([table[b][r] for b in brands]) for r in range(4)]
    return cols


def test_tpcds_reference_matches_a_loop():
    ref = common.module("reference", "tpcds_sf100")
    cfg = _cfg("tpcds_sf100", sizes.TPCDS)
    brands, want = ref._table(*ref._matches(cfg, 3, 0, "cpu"))
    loop = _tpcds_loop(cfg, 3)
    assert brands.tolist() == sorted(loop)
    assert want.T.tolist() == [loop[b] for b in sorted(loop)]
    assert sum(r[1] for r in loop.values()) > 100


def test_tpcds_judge_and_control():
    ref = common.module("reference", "tpcds_sf100")
    cfg = _cfg("tpcds_sf100", sizes.TPCDS)
    right = _tpcds_output(_tpcds_loop(cfg, 5))
    r = ref.judge(cfg, 5, 1, 0, right, 0, "cpu")
    assert ref.combine([r], cfg, 1) == {"cells_wrong": 0, "matched_gap": 0}
    wrong = [x.clone() for x in right]
    wrong[2][0] += 1
    got = ref.combine([ref.judge(cfg, 5, 1, 0, wrong, 0, "cpu")], cfg, 1)
    assert got == {"cells_wrong": 1, "matched_gap": 1}
    ctrl = ref.control(cfg, 5, 1, 0, 0, 0, 0, "cpu")
    got = ref.combine([ref.judge(cfg, 5, 1, 0, ctrl, 0, "cpu")], cfg, 1)
    assert got["cells_wrong"] > ref.LIMITS["cells_wrong"]
    assert got["matched_gap"] == 0  # only the sums are off


def test_tpcds_judge_counts_stray_and_repeated_brands():
    ref = common.module("reference", "tpcds_sf100")
    cfg = _cfg("tpcds_sf100", sizes.TPCDS)
    right = _tpcds_output(_tpcds_loop(cfg, 9))
    dup = [torch.cat([x, x[:1]]) for x in right]
    assert ref.judge(cfg, 9, 1, 0, dup, 0, "cpu")["cells_wrong"] == 1
    stray = [x.clone() for x in right]
    stray[0][0] = 1  # no brand is 1: its row is stray, its cells missing
    got = ref.judge(cfg, 9, 1, 0, stray, 0, "cpu")
    missing = sum(int(x[0]) != 0 for x in right[1:])  # a min may be 0
    assert got["cells_wrong"] == 1 + missing and got["matched_gap"] == 0
    # the run-end layout's empty rows (count 0) are not output rows
    pad = [torch.cat([x, torch.zeros(3, dtype=x.dtype)]) for x in right]
    assert ref.judge(cfg, 9, 1, 0, pad, 0, "cpu") == {"cells_wrong": 0,
                                                       "matched_gap": 0}
