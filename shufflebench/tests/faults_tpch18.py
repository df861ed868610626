"""Faults planted underneath the timed path of TPC-H query 18, for the
tests that see ``correct`` come out false; as in ``faults.py``, each
function patches with ``set_attr`` and the harness's ``prepare`` names
one as ``shufflebench.tests.faults_tpch18:<name>``.

``dropped_quantity`` drops one ``lineitem`` row's quantity from the
reduction (a line of the order with the largest sum); ``having_ge``
applies HAVING as ``>=``; ``lost_survivor`` makes each compaction lose
its last row as a compaction one slot short would, with a count that
does not exceed the capacity, so no overflow is flagged.
"""

from __future__ import annotations


def dropped_quantity(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.models import wordcount

    orig = wordcount.make_count_step

    def make(*args, **kw):
        step = orig(*args, **kw)

        def dropped(k, v):
            uniq, sums, _c, _n, _f = step(k, v)
            key = uniq[sums.argmax()]
            v = v.clone()
            v[(k == key).nonzero()[0, 0]] = 0
            return step(k, v)
        return dropped

    set_attr(wordcount, "make_count_step", make)


def having_ge(set_attr=setattr) -> None:
    from shufflebench import common

    driver = common.module("drivers", "tpch_sf100_q18")
    set_attr(driver, "having", lambda sums, quantity: sums >= quantity)


def lost_survivor(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.ops import segment

    orig = segment.compact_flagged

    def lossy(flag, columns, capacity, fill_values):
        cols, count = orig(flag, columns, capacity, fill_values)
        k = min(int(count[0]), capacity)
        if k:
            for c, f in zip(cols, fill_values):
                c[k - 1] = f
            count = count.clamp(max=k - 1)
        return cols, count

    set_attr(segment, "compact_flagged", lossy)
