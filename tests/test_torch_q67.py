"""TPC-DS query 67's operators on the CPU: the grouped top-k's ``rank()``
mode (``models/topk.py``) and the grouping-sets operator
(``models/rollup.py``) against plain torch, the top-k's default
``row_number()`` mode against the parent's step bit for bit, their
stage ranges and counters, and the query's plan
(``shufflebench/drivers/tpcds_sf100_q67.py``) against its plain
reference at small shares.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
from sparkrdma_tpu_torch.models.rollup import (
    KEY_FILL,
    level_masks,
    level_rows,
    make_rollup_step,
)
from sparkrdma_tpu_torch.models.topk import GroupedTopK, make_topk_step
from sparkrdma_tpu_torch.ops.exchange import hash_exchange
from sparkrdma_tpu_torch.ops.lexsort import perm_by_key_invalid_value
from sparkrdma_tpu_torch.ops.segment import prev_run_end, run_ends
from sparkrdma_tpu_torch.utils import trace as T

I32_MAX = torch.iinfo(torch.int32).max


def _rows(n, n_keys, n_vals, seed, dtype=torch.int32, invalid=0.2):
    """(keys, vals, valid) with values over ``n_vals`` (ties) and a
    share of invalid slots pre-masked as the keyed steps expect."""
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, n_keys, (n,), generator=g, dtype=torch.int32)
    vals = torch.randint(-n_vals, n_vals, (n,), generator=g, dtype=dtype)
    valid = (torch.rand(n, generator=g) >= invalid).to(torch.int32)
    return (torch.where(valid > 0, keys, I32_MAX),
            torch.where(valid > 0, vals, 0), valid)


def _plain_rank(keys, vals, valid, k):
    """{(key, value, rank)} of SQL ``rank() <= k`` by quadratic
    counting: one plus the valid rows of the key with a larger value."""
    m = valid > 0
    kk, vv = keys[m].long(), vals[m].long()
    larger = ((kk[:, None] == kk[None, :]) & (vv[None, :] > vv[:, None]))
    rank = 1 + larger.sum(1)
    keep = rank <= k
    return sorted(zip(kk[keep].tolist(), vv[keep].tolist(),
                      rank[keep].tolist()))


def _kept(out):
    ks, vs, keep, n_keep, _fill, rank, _pay = out
    m = keep > 0
    assert int(n_keep[0]) == int(m.sum())
    return sorted(zip(ks[m].long().tolist(), vs[m].long().tolist(),
                      rank[m].long().tolist()))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 3, 40])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rank_mode_matches_plain(seed, k, dtype):
    n = 700
    keys, vals, valid = _rows(n, 9, 12, seed, dtype)
    step = make_topk_step(1, n, n, k, ties="rank")
    assert _kept(step(keys, vals, valid)) == _plain_rank(keys, vals, valid,
                                                         k)


def test_rank_keeps_every_tie_at_the_cut_and_short_partitions():
    keys = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1, 2, 0], dtype=torch.int32)
    vals = torch.tensor([9, 8, 9, 8, 8, 7, 5, 5, 4, 9], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.int32)
    keys = torch.where(valid > 0, keys, I32_MAX)
    out = make_topk_step(1, 10, 10, 3, ties="rank")(keys, vals, valid)
    # key 0: 9, 9 rank 1, the three 8s rank 3 (all kept past k = 3),
    # 7 rank 6; key 1's tie and key 2's single row are under k
    assert _kept(out) == [(0, 8, 3), (0, 8, 3), (0, 8, 3), (0, 9, 1),
                          (0, 9, 1), (1, 5, 1), (1, 5, 1), (2, 4, 1)]
    rank = out[5]
    assert int(rank[out[2] == 0].max()) in (0, 6)
    assert bool((rank[(out[0] == I32_MAX)] == 0).all())


def test_rank_payload_rides_the_sort():
    n = 300
    keys, vals, valid = _rows(n, 5, 7, 11, torch.int64)
    pay = torch.arange(n, dtype=torch.int32) * 3
    ks, vs, keep, _n, _f, rank, ps = make_topk_step(
        1, n, n, 10, ties="rank")(keys, vals, valid, pay)
    row = ps // 3
    assert torch.equal(ks, keys[row]) and torch.equal(vs, vals[row])
    assert sorted(row.tolist()) == list(range(n))
    assert make_topk_step(1, n, n, 10, ties="rank")(keys, vals,
                                                    valid)[6] is None


def _parent_topk_step(k):
    """The grouped top-k step as the port had it before ``ties``: one
    sort keyed (key, validity, complemented value), each slot's index
    less its run's first, rank < k."""
    def step(keys, vals, valid):
        flat_k, flat_v, flat_m, max_fill = hash_exchange(
            keys, vals, valid, 1, keys.shape[0])
        flat_k = torch.where(flat_m > 0, flat_k,
                             torch.iinfo(flat_k.dtype).max)
        inv = 1 - flat_m.to(torch.int32)
        perm = perm_by_key_invalid_value(flat_k, inv, ~flat_v)
        ks, inv_s, vs = flat_k[perm], inv[perm], flat_v[perm]
        iota = torch.arange(ks.shape[0], dtype=torch.int32)
        _f, (start,) = prev_run_end(run_ends(ks, inv_s), (iota + 1,))
        keep = (((iota - start) < k) & (inv_s == 0)).to(torch.int32)
        return (ks, vs, keep, keep.sum(dtype=torch.int32).reshape(1),
                max_fill.reshape(1))
    return step


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("k", [1, 3, 100])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("explicit", [False, True])
def test_row_number_default_is_the_parents_bit_for_bit(seed, k, dtype,
                                                       explicit):
    n = 800
    keys, vals, valid = _rows(n, 13, 5, seed, dtype)
    kw = {"ties": "row_number"} if explicit else {}
    got = make_topk_step(1, n, n, k, **kw)(keys, vals, valid)
    want = _parent_topk_step(k)(keys, vals, valid)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_grouped_topk_lists_with_ties():
    """The host-facing model keeps ``row_number()``: k values a key,
    ties cut at k."""
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 6, 500).astype(np.int64)
    vals = rng.integers(0, 9, 500).astype(np.int64)
    got = GroupedTopK(device="cpu").top_k(keys, vals, 3)
    assert sorted(got) == np.unique(keys).tolist()
    for key in got:
        desc = sorted(vals[keys == key].tolist(), reverse=True)
        assert got[key] == desc[:3]


def test_ties_must_be_named():
    with pytest.raises(ValueError, match="ties"):
        make_topk_step(1, 8, 8, 2, ties="dense_rank")


# -- the grouping-sets operator ---------------------------------------------

FIELDS = [3, 2, 4, 3]  # four columns, most significant first


def _finest(n_rows, seed, fields=FIELDS, top_same=False):
    """Distinct packed keys of random column values, ascending, and
    int64 sums."""
    g = torch.Generator().manual_seed(seed)
    cols = [torch.randint(0, 1 << b, (n_rows,), generator=g)
            for b in fields]
    if top_same:
        cols[0].fill_(5)
        cols[1].fill_(1)
    key = torch.zeros(n_rows, dtype=torch.int64)
    for c, b in zip(cols, fields):
        key = (key << b) | c
    keys = torch.unique(key)
    sums = torch.randint(-(1 << 40), 1 << 40, keys.shape, generator=g)
    return keys, sums


def _plain_rollup(keys, sums, fields=FIELDS):
    """Level-major (key, level, sum) of every grouping set, each level
    grouped on its own by ``torch.unique`` of its masked keys."""
    out_k, out_l, out_s = [], [], []
    for level, mask in enumerate(level_masks(fields)):
        u, inv = torch.unique(keys & mask, return_inverse=True)
        s = torch.zeros(u.shape[0], dtype=torch.int64)
        s.index_add_(0, inv, sums)
        out_k.append(u)
        out_l.append(torch.full(u.shape, level, dtype=torch.int32))
        out_s.append(s)
    return torch.cat(out_k), torch.cat(out_l), torch.cat(out_s)


def _run_rollup(keys, sums, slots, capacity, fields=FIELDS):
    n = keys.shape[0]
    pad = slots - n
    k = torch.cat([keys, torch.full((pad,), KEY_FILL, dtype=torch.int64)])
    s = torch.cat([sums, torch.zeros(pad, dtype=torch.int64)])
    step = make_rollup_step(slots, capacity, fields)
    return step(k, s, torch.tensor([n], dtype=torch.int32))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("n_rows,pad", [(400, 0), (400, 37), (1, 5),
                                        (3000, 100)])
def test_rollup_matches_plain(seed, n_rows, pad):
    keys, sums = _finest(n_rows, seed)
    want = _plain_rollup(keys, sums)
    total = want[0].shape[0]
    slots = keys.shape[0] + pad
    coarse = total - keys.shape[0]
    rk, lv, rs, n_out, starts = _run_rollup(keys, sums, slots,
                                            slots + coarse + 50)
    assert int(n_out[0]) == total == int(starts[-1])
    assert torch.equal(rk[:total], want[0])
    assert torch.equal(lv[:total], want[1])
    assert torch.equal(rs[:total], want[2])
    assert bool((rk[total:] == KEY_FILL).all()) and bool((lv[total:] ==
                                                           -1).all())
    assert bool((rs[total:] == 0).all())
    counts = torch.bincount(want[1].long(), minlength=len(FIELDS) + 1)
    assert torch.equal(starts[1:] - starts[:-1], counts)


@pytest.mark.parametrize("spare", [0, 1])
def test_rollup_coarse_rows_exactly_fill_their_window(spare):
    keys, sums = _finest(500, 4)
    want = _plain_rollup(keys, sums)
    coarse = want[0].shape[0] - keys.shape[0]
    n = keys.shape[0]
    rk, lv, rs, n_out, starts = _run_rollup(keys, sums, n,
                                            n + coarse + spare)
    assert int(starts[-1] - starts[1]) == coarse
    assert torch.equal(rk[:n + coarse], want[0])
    assert torch.equal(rs[:n + coarse], want[2])


def test_rollup_levels_that_collapse_to_one_group():
    """Every key shares its two top fields: levels 2 .. 4 hold one row
    each, with the whole sum."""
    keys, sums = _finest(200, 7, top_same=True)
    want = _plain_rollup(keys, sums)
    rk, lv, rs, n_out, starts = _run_rollup(keys, sums, keys.shape[0],
                                            want[0].shape[0] + 1)
    per_level = (starts[1:] - starts[:-1]).tolist()
    assert per_level[2:] == [1, 1, 1]
    total = int(n_out[0])
    assert torch.equal(rs[total - 3:total], sums.sum().repeat(3))
    assert torch.equal(rk[:total], want[0]) and torch.equal(rs[:total],
                                                            want[2])


@pytest.mark.parametrize("level1_fits", [True, False])
def test_rollup_overflow_is_seen_and_keeps_what_fits(level1_fits):
    """Coarser rows past ``capacity - n_groups``: the count says so, and
    the finest groups and the level-1 rows that fit are right (past
    level 1's window the later levels read a cut level 1)."""
    keys, sums = _finest(300, 8)
    want = _plain_rollup(keys, sums)
    n = keys.shape[0]
    coarse = want[0].shape[0] - n
    g1 = int((want[1] == 1).sum())
    cap = n + (coarse - 5 if level1_fits else g1 // 2)
    rk, lv, rs, n_out, starts = _run_rollup(keys, sums, n, cap)
    assert int(starts[-1] - starts[1]) > cap - n
    assert int(starts[2] - starts[1]) == g1
    fit = min(n + g1, cap)
    assert torch.equal(rk[:fit], want[0][:fit])
    assert torch.equal(rs[:fit], want[2][:fit])
    assert torch.equal(lv[:fit], want[1][:fit])


def test_rollup_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        make_rollup_step(10, 10, FIELDS)
    with pytest.raises(ValueError):
        make_rollup_step(10, 10, [40, 30])
    with pytest.raises(ValueError):
        make_rollup_step(10, 10, [4, 0])


# -- stage ranges and counters -----------------------------------------------


def _range_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [(e.time_range.start, e.name) for e in prof.events()
             if e.name.startswith(T.RANGE_PREFIX)]
    return [n[len(T.RANGE_PREFIX):] for _t, n in sorted(names)]


@pytest.mark.parametrize("ties", ["row_number", "rank"])
def test_topk_records_sort_and_rank(ties):
    keys, vals, valid = _rows(128, 5, 9, 3)
    step = make_topk_step(1, 128, 128, 4, ties=ties)
    assert _range_names(lambda: step(keys, vals, valid)) == [
        "topk.sort", "topk.rank"]


def test_rollup_records_its_range():
    keys, sums = _finest(100, 2)
    assert _range_names(lambda: _run_rollup(keys, sums, keys.shape[0],
                                            4 * keys.shape[0])) == [
        "rollup"]


def test_counters_count_rows_ranked_and_levels_read():
    """``topk_rows_total`` counts the slots each step ranks;
    ``rollup_rows_total`` the rows out of each level, where
    ``level_rows`` reads a step's level starts (the step itself adds
    nothing)."""
    keys, vals, valid = _rows(64, 5, 9, 3)
    fk, fs = _finest(50, 3)
    want = _plain_rollup(fk, fs)
    per_level = torch.bincount(want[1].long(),
                               minlength=len(FIELDS) + 1).tolist()
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        make_topk_step(1, 64, 64, 4)(keys, vals, valid)
        make_topk_step(1, 64, 64, 4, ties="rank")(keys, vals, valid)
        make_topk_step(1, 40, 40, 4, ties="rank")(keys[:40], vals[:40],
                                                  valid[:40])
        starts = _run_rollup(fk, fs, fk.shape[0] + 6, 8 * fk.shape[0])[4]
        stepped = GLOBAL_REGISTRY.snapshot()["counters"]
        assert level_rows(starts) == per_level
        assert level_rows(starts) == per_level
        snap = GLOBAL_REGISTRY.snapshot()["counters"]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    topk = {c["labels"]["ties"]: c["value"] for c in snap
            if c["name"] == "topk_rows_total"}
    assert topk == {"row_number": 64, "rank": 104}
    assert not [c for c in stepped if c["name"] == "rollup_rows_total"]
    levels = {c["labels"]["level"]: c["value"] for c in snap
              if c["name"] == "rollup_rows_total"}
    assert levels == {str(lv): 2 * n for lv, n in enumerate(per_level)}


# -- the plan of query 67 against its reference --------------------------------


def _q67(name):
    from shufflebench import common
    from shufflebench.tests import test_shufflebench_tpcds67 as sizes

    config = dict(common.data("configs", "tpcds_sf100_q67"))
    config.update(getattr(sizes, name))
    return (config, common.module("drivers", "tpcds_sf100_q67"),
            common.module("reference", "tpcds_sf100_q67"))


def _run_job(config, driver, seed):
    job = driver.Job(config, seed, 0, 1, None, torch.device("cpu"))
    for factor in job.factors:
        job.use_factor(factor)
        out = job.step()
        if not job.overflowed(out):
            break
    assert not job.overflowed(out)
    return job, out


def _in_row_order(rows):
    """[11, k] distinct output rows in lexicographic order."""
    distinct = torch.unique(rows, dim=1)
    assert distinct.shape == rows.shape
    return distinct


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 41, 42])
@pytest.mark.parametrize("sizes", ["SMALL", "TIES"])
def test_q67_plan_equals_the_reference(seed, sizes):
    config, driver, ref = _q67(sizes)
    job, out = _run_job(config, driver, seed)
    want = ref._answer(config, seed, 0, "cpu")
    n_kept = int(out[11][0])
    assert n_kept == want.shape[1] > 3 * config["rank_limit"]
    got = torch.stack([c[:n_kept].long() for c in out[:11]])
    assert torch.equal(_in_row_order(got), _in_row_order(want))
    assert ref.judge(config, seed, 1, 0, out, 0, "cpu") == {
        "rows_wrong": 0, "count_gap": 0, "rollup_rows_wrong": 0}
    info = job.info()
    levels = [int(x) for x in info["level_rows"].split(",")]
    assert len(levels) == 9 and levels[-1] == 1 and sum(levels) == \
        info["rollup_rows"]
    job.release()


def test_q67_step_records_the_join_keyed_rollup_and_topk_ranges():
    config, driver, _ref = _q67("SMALL")
    job, _out = _run_job(config, driver, 9)
    assert _range_names(job.step) == [
        "join.pack", "join.probe", "keyed.compact", "join.pack",
        "join.probe", "join.pack", "join.probe", "keyed.sort",
        "keyed.scan", "keyed.compact", "rollup", "topk.sort", "topk.rank",
        "keyed.compact"]
    job.release()


def test_q67_overflow_is_seen():
    config, driver, ref = _q67("SMALL")
    job = driver.Job(dict(config, kept_capacity=64), 7, 0, 1, None,
                     torch.device("cpu"))
    out = job.step()
    assert job.overflowed(out) and int(out[11][0]) > 64
    assert ref.judge(config, 7, 1, 0, out, 0, "cpu")["rows_wrong"] > 0
