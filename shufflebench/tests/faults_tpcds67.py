"""Faults planted underneath the timed path of TPC-DS query 67, for the
tests that see ``correct`` come out false; as in ``faults.py``, each
function patches with ``set_attr`` and the harness's ``prepare`` names
one as ``shufflebench.tests.faults_tpcds67:<name>``.

``row_number_for_rank`` ranks ties by ``row_number()`` instead of
``rank()``; ``level_dropped`` leaves the grand total's grouping set out
of the rollup; ``month_short`` applies the month predicate one month
short (``d_month_seq`` between 1200 and 1210); ``wrapped_sum`` sums
``ss_sales_price * ss_quantity`` in int32, which wraps past 2^31
cents.

At the cell's size the rank keeps rows of the four coarsest levels
alone, so three faults live where only the rollup's rows show them:
``fine_level_dropped`` leaves level 1 (no ``s_store_id``) out of the
rollup; ``store_id_shifted`` joins each store row to the next row's
``s_store_id``; ``date_payload_shifted`` joins each day to the year,
quarter and month of the day before.
"""

from __future__ import annotations


def row_number_for_rank(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.models import topk

    set_attr(topk, "_sql_rank",
             lambda ks, inv_s, vs: topk._rank_in_runs(ks, inv_s) + 1)


def level_dropped(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.models import rollup

    orig = rollup.make_rollup_step

    def make(n_groups, capacity, field_bits):
        step = orig(n_groups, capacity, field_bits)

        def dropped(keys, sums, count):
            # the grand total is the last row: one row fewer drops it
            k, levels, s, n_rows, starts = step(keys, sums, count)
            return k, levels, s, n_rows - 1, starts
        return dropped

    set_attr(rollup, "make_rollup_step", make)


def month_short(set_attr=setattr) -> None:
    from shufflebench import common

    driver = common.module("drivers", "tpcds_sf100_q67")
    orig = driver.month_ok
    set_attr(driver, "month_ok",
             lambda seq, first, last: orig(seq, first, last - 1))


def wrapped_sum(set_attr=setattr) -> None:
    from shufflebench import common

    driver = common.module("drivers", "tpcds_sf100_q67")
    set_attr(driver, "sales", lambda q, p: q.int() * p.int())


def fine_level_dropped(set_attr=setattr) -> None:
    import torch

    from sparkrdma_tpu_torch.models import rollup

    orig = rollup.make_rollup_step

    def make(n_groups, capacity, field_bits):
        step = orig(n_groups, capacity, field_bits)

        def dropped(keys, sums, count):
            k, levels, s, n_rows, starts = step(keys, sums, count)
            keep = levels != 1
            gone = int((~keep).sum())

            def pack(x, fill):
                return torch.cat([x[keep], x.new_full((gone,), fill)])

            return (pack(k, rollup.KEY_FILL), pack(levels, -1), pack(s, 0),
                    n_rows - gone, torch.cat([starts[:2], starts[2:] - gone]))
        return dropped

    set_attr(rollup, "make_rollup_step", make)


def _shifted_job(set_attr, name: str, by: int) -> None:
    """The driver's job with its dimension payload ``name`` rolled by
    ``by`` rows."""
    import torch

    from shufflebench import common

    driver = common.module("drivers", "tpcds_sf100_q67")

    class Shifted(driver.Job):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            setattr(self, name, torch.roll(getattr(self, name), by))

    set_attr(driver, "Job", Shifted)


def store_id_shifted(set_attr=setattr) -> None:
    _shifted_job(set_attr, "s_id", -1)


def date_payload_shifted(set_attr=setattr) -> None:
    _shifted_job(set_attr, "d_bits", 1)
