"""The port's keyed reduction as TPC-H query 18 runs it, on the CPU:
``ops/segment.py::compact_flagged`` against ``masked_select``, the
reduction's run sums exact after the int32 running total wraps, the
query's plan (``shufflebench/drivers/tpch_sf100_q18.py``) against its
plain reference at a small share, and the ``keyed.*`` stage ranges and
``keyed_rows_total`` counter of the reductions and the compaction.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparkrdma_tpu_torch.metrics import GLOBAL_REGISTRY
from sparkrdma_tpu_torch.models.aggregate import make_aggregate_step
from sparkrdma_tpu_torch.models.wordcount import make_count_step
from sparkrdma_tpu_torch.ops import compact_flagged
from sparkrdma_tpu_torch.ops.segment import (
    aggregate_by_key_local,
    reduce_by_key_local,
)
from sparkrdma_tpu_torch.utils import trace as T

N = 1000
FILL = {torch.int32: -7, torch.int64: 1 << 40}


def _flags(pattern, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    if pattern == "none":
        return torch.zeros(n, dtype=torch.bool)
    if pattern == "all":
        return torch.ones(n, dtype=torch.bool)
    return torch.rand(n, generator=g) < 0.3


def _capacity(k, where):
    return {"above": k + 17, "at": k, "below": max(k // 2, 1)}[where]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("where", ["above", "at", "below"])
@pytest.mark.parametrize("pattern", ["random", "none", "all"])
def test_compact_flagged_matches_masked_select(pattern, where, dtype):
    flag = _flags(pattern, N)
    g = torch.Generator().manual_seed(4)
    hi = torch.iinfo(dtype).max
    col = torch.randint(-hi, hi, (N,), generator=g, dtype=dtype)
    other = torch.arange(N, dtype=dtype)
    k = int(flag.sum())
    cap = _capacity(k, where)
    (a, b), count = compact_flagged(flag, (col, other), cap,
                                    (FILL[dtype], -1))
    assert count.dtype == torch.int32 and count.shape == (1,)
    assert int(count[0]) == k
    assert a.shape == b.shape == (cap,)
    assert a.dtype == b.dtype == dtype
    kept = min(k, cap)
    assert torch.equal(a[:kept], torch.masked_select(col, flag)[:kept])
    assert torch.equal(b[:kept], torch.masked_select(other, flag)[:kept])
    assert bool((a[kept:] == FILL[dtype]).all())
    assert bool((b[kept:] == -1).all())


def test_compact_flagged_of_no_rows_is_all_fill():
    (a,), count = compact_flagged(torch.zeros(0, dtype=torch.bool),
                                  (torch.zeros(0, dtype=torch.int32),), 5,
                                  (3,))
    assert torch.equal(a, torch.full((5,), 3, dtype=torch.int32))
    assert int(count[0]) == 0


def test_compact_flagged_keeps_the_rows_order():
    flag = torch.tensor([1, 0, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    col = torch.tensor([9, 8, 7, 6, 5, 4, 3, 2], dtype=torch.int32)
    (a,), count = compact_flagged(flag, (col,), 4, (0,))
    assert a.tolist() == [9, 6, 5, 3] and int(count[0]) == 5


def _wrapping_rows(n, seed):
    """Keys of runs of 1 to 7 rows and values near 2^24, so that the
    running total of the values passes 2^31 many times over."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.repeat(
        np.arange(n, dtype=np.int32) * 32 + 1,
        rng.integers(1, 8, n)))
    vals = rng.integers(1 << 23, 1 << 24, keys.shape[0], dtype=np.int32)
    assert int(vals.astype(np.int64).sum()) > 8 * (1 << 31)
    return keys, vals


def _sums_by_key(keys, vals):
    u, inv = np.unique(keys, return_inverse=True)
    s = np.zeros(u.shape[0], np.int64)
    np.add.at(s, inv, vals.astype(np.int64))
    return dict(zip(u.tolist(), s.tolist()))


@pytest.mark.parametrize("with_valid", [False, True])
def test_reduce_by_key_local_exact_past_the_int32_running_total(with_valid):
    keys, vals = _wrapping_rows(600, 5)
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    valid = torch.ones_like(k) if with_valid else None
    uniq, sums, counts, n_unique = reduce_by_key_local(k, v, valid)
    real = counts > 0
    got = dict(zip(uniq[real].tolist(), sums[real].tolist()))
    assert got == _sums_by_key(keys, vals)
    assert sums.dtype == torch.int32 and int(n_unique) == len(got)


def test_count_step_unpadded_exact_past_the_int32_running_total():
    """The step Q18 runs: ``make_count_step`` at D = 1 without a
    validity column."""
    keys, vals = _wrapping_rows(900, 6)
    n = keys.shape[0]
    step = make_count_step(1, n, n, with_validity=False)
    uniq, sums, counts, n_unique, fill = step(torch.from_numpy(keys),
                                              torch.from_numpy(vals))
    real = counts > 0
    assert dict(zip(uniq[real].tolist(), sums[real].tolist())) == \
        _sums_by_key(keys, vals)
    assert int(fill[0]) == 0 and int(n_unique[0]) == int(real.sum())


# -- the plan of query 18 against its reference --------------------------------


def _q18(overrides):
    from shufflebench import common

    config = dict(common.data("configs", "tpch_sf100_q18"))
    config.update(overrides)
    return (config, common.module("drivers", "tpch_sf100_q18"),
            common.module("reference", "tpch_sf100_q18"))


SMALL = {"orders_per_card": 4096, "having_quantity": 150}


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 41])
@pytest.mark.parametrize("capacity", [8192, 256])
def test_q18_plan_equals_the_reference(seed, capacity):
    """The driver's steps at a small share, with the HAVING threshold
    lowered so that about a fifth of the orders survive; a capacity
    below the survivors overflows and is retried larger, as the
    harness retries."""
    config, driver, ref = _q18(dict(SMALL, survivor_capacity=capacity))
    job = driver.Job(config, seed, 0, 1, None, torch.device("cpu"))
    for factor in job.factors:
        job.use_factor(factor)
        out = job.step()
        if not job.overflowed(out):
            break
    assert not job.overflowed(out)
    want, survivors = ref._answer(config, seed, 0, "cpu")
    assert 500 < survivors < job.capacity
    assert int(out[5][0]) == survivors == int(out[6][0])
    got = torch.stack([c[:survivors].long() for c in out[:5]])
    assert torch.equal(got, want)
    assert ref.judge(config, seed, 1, 0, out, 0, "cpu") == {
        "rows_wrong": 0, "survivor_gap": 0}
    job.release()


def test_q18_overflow_is_seen_and_leaves_rows_out():
    config, driver, ref = _q18(dict(SMALL, survivor_capacity=64))
    job = driver.Job(config, 7, 0, 1, None, torch.device("cpu"))
    out = job.step()
    assert job.overflowed(out)
    assert int(out[5][0]) > 64
    assert ref.judge(config, 7, 1, 0, out, 0, "cpu")["rows_wrong"] > 0


# -- stage ranges and the row counter ------------------------------------------


def _range_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [(e.time_range.start, e.name) for e in prof.events()
             if e.name.startswith(T.RANGE_PREFIX)]
    return [n[len(T.RANGE_PREFIX):] for _t, n in sorted(names)]


def _small_rows():
    g = torch.Generator().manual_seed(8)
    keys = torch.randint(0, 50, (256,), generator=g, dtype=torch.int32)
    vals = torch.randint(0, 100, (256,), generator=g, dtype=torch.int32)
    return keys, vals


@pytest.mark.parametrize("make", [make_count_step, make_aggregate_step],
                         ids=["reduce", "aggregate"])
@pytest.mark.parametrize("with_validity", [False, True])
def test_keyed_steps_record_sort_and_scan(make, with_validity):
    keys, vals = _small_rows()
    step = make(1, 256, 256, with_validity=with_validity)
    args = (keys, vals) if not with_validity else (
        keys, vals, torch.ones_like(keys))
    assert _range_names(lambda: step(*args)) == ["keyed.sort", "keyed.scan"]


def test_compaction_records_its_range():
    flag = torch.arange(64) % 3 == 0
    assert _range_names(lambda: compact_flagged(
        flag, (torch.arange(64),), 32, (0,))) == ["keyed.compact"]


def test_q18_step_records_the_keyed_and_join_ranges():
    config, driver, _ref = _q18(SMALL)
    job = driver.Job(config, 9, 0, 1, None, torch.device("cpu"))
    assert _range_names(job.step) == [
        "keyed.sort", "keyed.scan", "keyed.compact", "join.pack",
        "join.probe", "keyed.compact"]
    job.release()


def test_keyed_rows_total_counts_rows_in():
    keys, vals = _small_rows()
    GLOBAL_REGISTRY.reset()
    GLOBAL_REGISTRY.enabled = True
    try:
        reduce_by_key_local(keys, vals, None)
        aggregate_by_key_local(keys, vals, torch.ones_like(keys))
        aggregate_by_key_local(keys[:100], vals[:100], None)
        compact_flagged(keys > 10, (keys,), 8, (0,))
        snap = GLOBAL_REGISTRY.snapshot()["counters"]
    finally:
        GLOBAL_REGISTRY.enabled = False
        GLOBAL_REGISTRY.reset()
    got = {c["labels"]["op"]: c["value"] for c in snap
           if c["name"] == "keyed_rows_total"}
    assert got == {"reduce": 256, "aggregate": 356, "compact": 256}
