"""TPC-DS query 67 (``tpcds67.d1``) on the CPU at small shares: the input
maker's determinism and the spec's ranges, the reference and its
control, and ``correct`` coming out false under each planted fault of
``faults_tpcds67.py``."""

import pytest
import torch

from shufflebench import calibrate, common, harness

CELL = "tpcds67.d1"
# 2^14 fact rows over 1999-2001 (a third in 2000), 64 items of 3
# categories, 8 stores: about 1000 finest groups a category, so the
# rank cut at 100 falls among them
SMALL = {"fact_rows_per_card": 1 << 14, "date_dim_first_sk": 2451180,
         "date_dim_rows": 1096, "sales_date_sk": [2451180, 2452275],
         "item_rows": 64, "brand_parts": [3, 4, 2], "store_rows": 8,
         "row_capacity": 8192, "rollup_capacity": 12288, "kept_capacity": 512,
         "bytes_per_step_per_card": 20 << 14}
# every sale 1.00 or 2.00: sums tie everywhere, the 100th rank too
TIES = dict(SMALL, pricing={"quantity": [1, 2],
                            "wholesale_cost_cents": [100, 100],
                            "markup_pct": [0, 0], "discount_pct": [0, 0]})
# 2^15 rows: the grand total passes 2^31 cents
WIDE = dict(SMALL, fact_rows_per_card=1 << 15, row_capacity=16384,
            rollup_capacity=24576, bytes_per_step_per_card=20 << 15)
# rk <= 3: as at the cell's size, the rank keeps rows of the coarsest
# levels alone (each category's row and its two largest classes, and
# the grand total), whose NULL columns hide the finer fields
COARSE = dict(SMALL, rank_limit=3)
SOUND = {"rows_wrong": 0, "count_gap": 0, "rollup_rows_wrong": 0}


def _cfg(small):
    return dict(common.data("configs", "tpcds_sf100_q67"), **small)


def _tables(seed, small=SMALL, rank=0):
    return common.module("inputs", "tpcds_sf100_q67").make_tables(
        _cfg(small), seed, rank, "cpu")


def test_inputs_are_deterministic_per_seed():
    a, b, c = _tables(2 ** 31 + 7), _tables(2 ** 31 + 7), _tables(8)
    assert {"ss_date", "ss_item", "ss_store", "ss_quantity",
            "ss_sales_price", "d_month_seq", "i_category",
            "s_store_id"} <= set(a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["ss_sales_price"][:100],
                           c["ss_sales_price"][:100])


def test_inputs_keep_the_spec_ranges():
    cfg = _cfg(SMALL)
    t = _tables(11)
    for k in ("ss_date", "ss_item", "ss_store", "ss_quantity",
              "ss_sales_price"):
        assert t[k].dtype == torch.int32 and t[k].shape == (1 << 14,), k
    lo, hi = cfg["sales_date_sk"]
    assert lo <= int(t["ss_date"].min()) <= int(t["ss_date"].max()) <= hi
    assert int(t["ss_store"].min()) == 1 and int(t["ss_store"].max()) == 8
    assert t["s_store_id"].tolist() == [1, 1, 2, 2, 3, 3, 4, 4]
    assert set(t["i_category"].tolist()) == {1, 2, 3}
    q = t["ss_quantity"]
    assert int(q.min()) >= 1 and int(q.max()) <= 100
    assert int(t["ss_sales_price"].min()) >= 0
    assert int(t["ss_sales_price"].max()) <= 30000
    # 1999-01-01 is month 1188; month 1200 is January 2000, quarter 1
    seq = t["d_month_seq"]
    assert int(seq[0]) == 1188
    jan = (seq == 1200).nonzero()[:, 0]
    assert jan.numel() == 31 and int(t["d_year"][jan[0]]) == 2000
    assert int(t["d_moy"][jan[0]]) == 1 and int(t["d_qoy"][jan[0]]) == 1
    assert set(t["d_qoy"][seq == 1211].tolist()) == {4}


def test_item_hierarchy_matches_query_55s():
    """The item draws are query 55's: ``i_brand_id`` = category x 10^6 +
    class x 10^3 + brand of the same seed."""
    q55 = common.data("configs", "tpcds_sf100")
    cfg55 = dict(q55, fact_rows_per_card=16, item_rows=64, date_dim_rows=8,
                 brand_parts=[3, 4, 2])
    t55 = common.module("inputs", "tpcds_sf100").make_tables(cfg55, 5, 0,
                                                             "cpu")
    t = _tables(5)
    assert torch.equal(t["i_category"] * 1000000 + t["i_class"] * 1000
                       + t["i_brand"], t55["i_brand"])


@pytest.mark.parametrize("small", [SMALL, TIES], ids=["priced", "ties"])
def test_reference_passes_the_plan(small):
    rows = calibrate.calibrate(CELL, [31, 2 ** 31 + 32], [], "cpu", small)
    assert [r["readings"] for r in rows] == [SOUND] * 2


def test_control_fails():
    program, control = calibrate.calibrate(CELL, [33], [33], "cpu", SMALL)
    assert program["readings"] == SOUND
    assert control["kind"] == "control"
    assert control["readings"]["rows_wrong"] > 0
    assert control["readings"]["rollup_rows_wrong"] > 0


def test_ties_straddle_the_rank_cut():
    """With every sale 1.00 or 2.00 a tie runs across the 100th rank in
    some category, and ``rank()`` keeps every row of it."""
    ref = common.module("reference", "tpcds_sf100_q67")
    want = ref._answer(_cfg(TIES), 34, 0, "cpu")
    rk, cat = want[10], want[0]
    kept = [int((cat == c).sum()) for c in (1, 2, 3)]
    assert max(kept) > 100 and int(rk.max()) <= 100
    grand = want[8] == 8
    assert int(grand.sum()) == 1 and int(rk[grand][0]) == 1
    assert bool((want[:8, grand] == -1).all())


def test_sound_run_is_correct():
    line, notes, _f = harness.run_cell(CELL, 2 ** 31 + 5, 0.2, True, "cpu",
                                       overrides=SMALL)
    assert line["correct"] is True
    assert " kept_rows " in notes[1] and " level_rows " in notes[1]
    assert line["checks"] == {k: {"value": 0, "limit": 0} for k in SOUND}


@pytest.mark.parametrize("fault,small,seen_by", [
    ("row_number_for_rank", TIES, "rows_wrong"),
    ("level_dropped", SMALL, "rows_wrong"),
    ("month_short", SMALL, "rows_wrong"),
    ("wrapped_sum", WIDE, "rows_wrong"),
    ("fine_level_dropped", COARSE, "rollup_rows_wrong"),
    ("store_id_shifted", COARSE, "rollup_rows_wrong"),
    ("date_payload_shifted", COARSE, "rollup_rows_wrong")])
def test_fault_is_not_correct(fault, small, seen_by, monkeypatch):
    from sparkrdma_tpu_torch.models import rollup, topk

    # the fault patches these in this process: restore them afterwards
    driver = common.module("drivers", "tpcds_sf100_q67")
    for mod, name in ((topk, "_sql_rank"), (rollup, "make_rollup_step"),
                      (driver, "month_ok"), (driver, "sales"),
                      (driver, "Job")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    line, _notes, _f = harness.run_cell(
        CELL, 77, 0.2, False, "cpu", overrides=small,
        prepare=f"shufflebench.tests.faults_tpcds67:{fault}")
    assert line["correct"] is False
    assert line["checks"][seen_by]["value"] > 0
    if small is COARSE:
        # the kept rows cannot show it: the rollup's rows do
        assert line["checks"]["rows_wrong"]["value"] == 0


def test_scan_bytes_count_rows_not_slots():
    """``scan_bytes_per_step`` counts the rows a step holds: doubling
    every capacity moves it not at all."""
    drv = common.module("drivers", "tpcds_sf100_q67")
    seen = []
    for doubling in (0, 1):
        job = drv.Job(_cfg(SMALL), 81, 0, 1, None, torch.device("cpu"))
        job.use_factor(doubling)
        assert not job.overflowed(job.step())
        info = job.info()
        seen.append(info["scan_bytes_per_step"])
        levels = [int(x) for x in info["level_rows"].split(",")]
        assert seen[-1] == drv.scan_bytes(
            1 << 14, 1096, 64, 8, info["matched_rows"], info["groups"],
            levels[1], info["rollup_rows"])
        job.release()
    assert seen[0] == seen[1]


def test_runs_on_one_card_only():
    drv = common.module("drivers", "tpcds_sf100_q67")
    with pytest.raises(ValueError, match="one card"):
        drv.Job(_cfg(SMALL), 80, 0, 4, None, torch.device("cpu"))


_LOADS = """
import json, sys
from shufflebench import common, harness
from shufflebench.tests.test_shufflebench_tpcds67 import SMALL
cfg = dict(common.data("configs", "tpcds_sf100_q67"), **SMALL)
ref = common.module("reference", "tpcds_sf100_q67")
out = ref.control(cfg, 5, 1, 0, 0, 0, 512, "cpu")
ref.combine([ref.judge(cfg, 5, 1, 0, out, 0, "cpu")], cfg, 1)
before = sorted({m.split(".")[0] for m in sys.modules})
harness.run_cell("tpcds67.d1", 5, 0.2, False, "cpu", overrides=SMALL)
print(json.dumps([before, sorted({m.split(".")[0] for m in sys.modules})]))
"""


def test_reference_loads_nothing_of_the_program_and_no_jax():
    import json
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-c", _LOADS], cwd=str(common.ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref_run, cell_run = (set(x) for x in json.loads(
        r.stdout.strip().splitlines()[-1]))
    jax = {"jax", "jaxlib", "flax", "sparkrdma_tpu"}
    assert not ref_run & (jax | {"sparkrdma_tpu_torch"})
    assert "sparkrdma_tpu_torch" in cell_run and not cell_run & jax
