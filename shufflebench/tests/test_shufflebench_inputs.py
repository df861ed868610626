"""The input makers: the same seed makes the same inputs, another seed
or rank others, at the configuration's shapes."""

import torch

from shufflebench import common
from shufflebench.tests import sizes

BIG_SEED = (1 << 31) + 12345  # past 32 signed bits, as the driver's are


def _ts():
    return common.module("inputs", "hibench_terasort")


def _tp():
    return common.module("inputs", "tpcds_sf100")


def test_stream_seed_separates_streams_and_seeds():
    seen = {common.stream_seed(s, r, t) for s in (0, 1, BIG_SEED)
            for r in range(4) for t in range(2)}
    assert len(seen) == 24
    assert all(0 <= x < 1 << 63 for x in seen)
    assert common.stream_seed(BIG_SEED, 1) == common.stream_seed(BIG_SEED, 1)


def test_terasort_records_by_seed_and_rank():
    cfg = dict(common.data("configs", "hibench_terasort"), **sizes.TERASORT)
    k = _ts().make_keys(cfg, BIG_SEED, 0, "cpu")
    p = _ts().make_payload(cfg, BIG_SEED, 0, "cpu")
    assert k.dtype == torch.int64 and k.shape == (4096,)
    assert p.dtype == torch.int32 and p.shape == (4096, 23)
    assert torch.equal(k, _ts().make_keys(cfg, BIG_SEED, 0, "cpu"))
    assert torch.equal(p, _ts().make_payload(cfg, BIG_SEED, 0, "cpu"))
    assert not torch.equal(k, _ts().make_keys(cfg, BIG_SEED, 1, "cpu"))
    assert not torch.equal(k, _ts().make_keys(cfg, BIG_SEED + 1, 0, "cpu"))
    # the whole 64-bit range, both signs
    assert bool((k < 0).any()) and bool((k > 0).any())
    assert int(k.abs().max()) > 1 << 60


def test_terasort_record_is_100_bytes():
    cfg = common.data("configs", "hibench_terasort")
    assert 8 * cfg["key_words_int64"] + 4 * cfg["payload_words_int32"] == 100
    assert cfg["bytes_per_step_per_card"] == 100 * cfg["records_per_card"]


def test_tpcds_tables():
    cfg = dict(common.data("configs", "tpcds_sf100"), **sizes.TPCDS)
    t = _tp().make_tables(cfg, BIG_SEED, 0, "cpu")
    assert t["d_sk"].shape == (80,) and t["i_sk"].shape == (64,)
    assert all(t[k].shape == (4096,) and t[k].dtype == torch.int32
               for k in ("ss_date", "ss_item", "ss_price"))
    lo, hi = cfg["sales_date_sk"]
    assert int(t["ss_date"].min()) >= lo and int(t["ss_date"].max()) <= hi
    assert int(t["ss_item"].min()) >= 1 and int(t["ss_item"].max()) <= 64
    assert int(t["i_manager"].min()) >= 1 and int(t["i_manager"].max()) <= 4
    # category x 10^6 + class x 10^3 + brand, each part in range
    b = t["i_brand"]
    assert bool(((b // 1000000 >= 1) & (b // 1000000 <= 2)).all())
    assert bool(((b // 1000 % 1000 >= 1) & (b // 1000 % 1000 <= 2)).all())
    # a quantity of 1 .. 100 of a sales price of at most 300.00
    assert int(t["ss_price"].min()) >= 0
    assert int(t["ss_price"].max()) <= 100 * 30000
    again = _tp().make_tables(cfg, BIG_SEED, 0, "cpu")
    assert all(torch.equal(t[k], again[k]) for k in t)
    other = _tp().make_tables(cfg, BIG_SEED, 1, "cpu")
    # dimensions are broadcast: the same on every rank
    assert torch.equal(t["i_brand"], other["i_brand"])
    assert not torch.equal(t["ss_item"], other["ss_item"])


def test_tpcds_calendar():
    jdn = torch.tensor([2415022, 2440588, 2450815, 2451484, 2451513,
                        2451514, 2451545, 2452640, 2488070])
    year, month = _tp().civil(jdn)
    assert year.tolist() == [1900, 1970, 1998, 1999, 1999, 1999, 2000,
                             2002, 2100]
    assert month.tolist() == [1, 1, 1, 11, 11, 12, 1, 12, 1]
    cfg = common.data("configs", "tpcds_sf100")
    t = _tp().make_tables(dict(cfg, fact_rows_per_card=16), 3, 0, "cpu")
    assert int(t["d_sk"][0]) == 2415022 and int(t["d_sk"][-1]) == 2488070
    nov99 = (t["d_year"] == 1999) & (t["d_moy"] == 11)
    assert t["d_sk"][nov99].tolist() == list(range(2451484, 2451514))
    lo, hi = cfg["sales_date_sk"]
    assert hi - lo + 1 == 1826  # 1998-01-01 .. 2002-12-31


def test_tpcds_sizes_are_sf100():
    cfg = common.data("configs", "tpcds_sf100")
    assert cfg["store_sales_rows"] == 287997024
    assert cfg["item_rows"] == 204000 and cfg["date_dim_rows"] == 73049
    assert cfg["fact_bytes_per_row"] == 4 * len(cfg["fact_columns"]) == 12
    assert cfg["bytes_per_step_per_card"] == 12 * cfg["fact_rows_per_card"]
    assert cfg["predicate"] == {"i_manager_id": 28, "d_moy": 11,
                                "d_year": 1999}
