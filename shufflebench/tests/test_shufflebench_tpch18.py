"""TPC-H query 18 (``tpch18.d1``) on the CPU at small shares: the input
maker's determinism and the spec's ranges, the reference and its
control, and ``correct`` coming out false under each planted fault of
``faults_tpch18.py``."""

import pytest
import torch

from shufflebench import calibrate, common, harness

CELL = "tpch18.d1"
# about a fifth of 4096 orders pass HAVING at 150, and some orders'
# sums equal it
SMALL = {"orders_per_card": 4096, "having_quantity": 150,
         "bytes_per_step_per_card": 52 * 4096}
# 2^18 orders: the running total of about 2^20 quantities passes 2^24,
# where float32 loses units; HAVING at 250 keeps thousands of orders
CONTROL = {"orders_per_card": 1 << 18, "having_quantity": 250,
           "bytes_per_step_per_card": 52 << 18}


def _cfg(small):
    return dict(common.data("configs", "tpch_sf100_q18"), **small)


def _tables(seed, small=SMALL, rank=0):
    return common.module("inputs", "tpch_sf100_q18").make_tables(
        _cfg(small), seed, rank, "cpu")


def test_inputs_are_deterministic_per_seed():
    a, b, c = _tables(2 ** 31 + 7), _tables(2 ** 31 + 7), _tables(8)
    assert set(a) == {"o_orderkey", "o_custkey", "o_orderdate",
                      "o_totalprice", "l_orderkey", "l_quantity"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["l_quantity"][:100], c["l_quantity"][:100])


def test_inputs_keep_the_spec_ranges():
    cfg = _cfg(SMALL)
    t = _tables(11)
    ok = t["o_orderkey"].long()
    assert ok.dtype == torch.int64 and torch.unique(ok).numel() == 4096
    assert bool(((ok & 31) < 8).all()) and int(ok.min()) >= 1
    # rank 0's share: order indices 4 j + 1
    idx = ((ok >> 5) << 3) | (ok & 7)
    assert bool((idx % 4 == 1).all())
    assert not torch.equal(ok, torch.sort(ok).values)  # arrival order
    cust = t["o_custkey"]
    assert bool((cust % 3 != 0).all()) and int(cust.min()) >= 1
    assert int(cust.max()) <= cfg["customer_rows"]
    lo, hi = cfg["orderdate_days"]
    assert lo <= int(t["o_orderdate"].min()) <= int(t["o_orderdate"].max()) \
        <= hi
    lines = torch.bincount(torch.searchsorted(
        torch.sort(ok).values, t["l_orderkey"].long()), minlength=4096)
    assert int(lines.min()) == 1 and int(lines.max()) == 7
    assert set(torch.unique(lines).tolist()) == set(range(1, 8))
    q = t["l_quantity"]
    assert q.dtype == torch.int32 and int(q.min()) == 1 and \
        int(q.max()) == 50
    assert t["o_totalprice"].dtype == torch.int64
    assert bool((t["o_totalprice"] > 0).all())
    other = _tables(11, rank=2)
    assert not bool(torch.isin(other["o_orderkey"], t["o_orderkey"]).any())


def test_key_and_price_helpers_follow_dbgen():
    """dbgen's sparse order keys and part retail prices (cents)."""
    ins = common.module("inputs", "tpch_sf100_q18")
    assert ins.retail_cents(torch.tensor([1, 1000, 19999])).tolist() == [
        90000 + 0 + 100, 90000 + 100 + 0, 90000 + 1999 + 99900]
    assert ins.sparse_key(torch.tensor([1, 7, 8, 15, 16])).tolist() == [
        1, 7, 32, 39, 64]


def test_reference_passes_the_plan_and_the_control_fails():
    rows = calibrate.calibrate(CELL, [31, 32], [31, 32], "cpu", CONTROL)
    ref = common.module("reference", "tpch_sf100_q18")
    for row in rows:
        over = any(row["readings"][k] > v for k, v in ref.LIMITS.items())
        assert over == (row["kind"] == "control"), row


def test_control_is_exact_below_2_to_the_24():
    """At 4096 orders the float32 running total stays exact: the control
    fails only where the configuration's sizes push it past 2^24."""
    rows = calibrate.calibrate(CELL, [33], [33], "cpu", SMALL)
    assert all(r["readings"] == {"rows_wrong": 0, "survivor_gap": 0}
               for r in rows)


def test_sound_run_is_correct():
    line, notes, _f = harness.run_cell(CELL, 2 ** 31 + 5, 0.2, True, "cpu",
                                       overrides=SMALL)
    assert line["correct"] is True
    assert " survivors " in notes[1] and " capacity 8192 " in notes[1]
    assert line["checks"] == {"rows_wrong": {"value": 0, "limit": 0},
                              "survivor_gap": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("fault", ["dropped_quantity", "having_ge",
                                   "lost_survivor"])
def test_fault_is_not_correct(fault, monkeypatch):
    from sparkrdma_tpu_torch.models import wordcount
    from sparkrdma_tpu_torch.ops import segment

    # the fault patches these in this process: restore them afterwards
    driver = common.module("drivers", "tpch_sf100_q18")
    for mod, name in ((wordcount, "make_count_step"), (driver, "having"),
                      (segment, "compact_flagged")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    line, _notes, _f = harness.run_cell(
        CELL, 77, 0.2, False, "cpu", overrides=SMALL,
        prepare=f"shufflebench.tests.faults_tpch18:{fault}")
    assert line["correct"] is False
    assert line["checks"]["rows_wrong"]["value"] > 0


def test_runs_on_one_card_only():
    drv = common.module("drivers", "tpch_sf100_q18")
    with pytest.raises(ValueError, match="one card"):
        drv.Job(_cfg(SMALL), 80, 0, 4, None, torch.device("cpu"))


_LOADS = """
import json, sys
from shufflebench import common, harness
small = {"orders_per_card": 4096, "having_quantity": 150}
cfg = dict(common.data("configs", "tpch_sf100_q18"), **small)
ref = common.module("reference", "tpch_sf100_q18")
out = ref.control(cfg, 5, 1, 0, 0, 0, 2048, "cpu")
ref.combine([ref.judge(cfg, 5, 1, 0, out, 0, "cpu")], cfg, 1)
before = sorted({m.split(".")[0] for m in sys.modules})
harness.run_cell("tpch18.d1", 5, 0.2, False, "cpu", overrides=small)
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
