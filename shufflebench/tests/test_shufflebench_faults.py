"""``correct`` comes out false when the timed path is broken
underneath (``faults.py``), once for each fault a cell can have, and
the controls fail where the program passes.  The card is skipped: the
cells run on the CPU at tiny sizes, ``terasort.d4`` in a gloo world of
four processes."""

import pytest

from shufflebench import calibrate, harness
from shufflebench.tests import faults, sizes

D1 = [("terasort.d1", "unchanged"), ("terasort.d1", "half_batch"),
      ("terasort.d1", "altered"), ("tpcds.d1", "tpcds_unchanged"),
      ("tpcds.d1", "tpcds_half_batch"), ("tpcds.d1", "tpcds_altered")]
D4 = ["unchanged", "half_batch", "no_exchange", "altered"]


@pytest.mark.parametrize("cell,fault", D1)
def test_fault_on_one_card_is_not_correct(cell, fault, monkeypatch):
    getattr(faults, fault)(monkeypatch.setattr)
    line, _notes, _f = harness.run_cell(cell, 77, 0.2, False, "cpu",
                                        overrides=sizes.CELLS[cell])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault", D4)
def test_fault_on_four_ranks_is_not_correct(fault):
    line, _notes, _f = harness.run_cell(
        "terasort.d4", 78, 0.3, False, "cpu", overrides=sizes.TERASORT,
        prepare=f"shufflebench.tests.faults:{fault}", cell=sizes.D4_CELL)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_sound_four_ranks_are_correct():
    line, _notes, forbidden = harness.run_cell(
        "terasort.d4", 79, 0.3, True, "cpu", overrides=sizes.TERASORT,
        cell=sizes.D4_CELL)
    assert line["correct"] is True and forbidden == []
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) <= {"host_ms"}


@pytest.mark.parametrize("cell,small", [
    ("terasort.d1", sizes.TERASORT_TIES), ("tpcds.d1", sizes.TPCDS),
    ("terasort.d4", sizes.TERASORT_TIES_D4)])
def test_controls_fail_where_the_program_passes(cell, small):
    from shufflebench import common

    entry = sizes.D4_CELL if cell == "terasort.d4" else \
        harness.find_cell(common.benchmark(), cell)
    rows = calibrate.calibrate(cell, [31, 32], [31, 32], "cpu", small,
                               cell=entry)
    ref = common.module("reference", entry["config"])
    for row in rows:
        over = any(row["readings"][k] > v for k, v in ref.LIMITS.items())
        assert over == (row["kind"] == "control"), row


def test_tpcds_runs_on_one_card_only():
    """The TPC-DS driver refuses a world of more than one rank: no cell
    runs the hash join's exchange yet."""
    import torch

    from shufflebench import common

    cfg = dict(common.data("configs", "tpcds_sf100"), **sizes.TPCDS)
    drv = common.module("drivers", "tpcds_sf100")
    with pytest.raises(ValueError, match="one card"):
        drv.Job(cfg, 80, 0, 4, None, torch.device("cpu"))
