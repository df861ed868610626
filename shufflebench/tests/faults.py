"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false.  Each function patches the program with
``set_attr`` (``setattr`` in a rank of a world, pytest's
``monkeypatch.setattr`` in the test's own process); the harness's
``prepare`` names one as ``shufflebench.tests.faults:<name>``.

TeraSort (``TeraSorter.sort_device_wide``): ``unchanged`` hands the
input rows back in input order; ``half_batch`` sorts only the first
half of the records; ``no_exchange`` makes every ``all_to_all`` keep
the rank's own block; ``altered`` flips a bit of the first output row.

TPC-DS query 55: ``tpcds_unchanged`` makes the join+aggregate hand
its joined stream back unaggregated; ``tpcds_half_batch`` drops the
second half of the fact rows from the date join; ``tpcds_altered`` adds
1 to one brand's sum.
"""

from __future__ import annotations


def _sorter():
    from sparkrdma_tpu_torch.models.terasort import TeraSorter

    return TeraSorter


def unchanged(set_attr=setattr) -> None:
    cls = _sorter()
    orig = cls.sort_device_wide

    def step(self, keys, payload, capacity=None):
        (sk, sp, nv, mf), cap = orig(self, keys, payload, capacity)
        k = min(int(nv.reshape(-1)[0]), keys.shape[0])
        sk, sp = sk.clone(), sp.clone()
        sk[:k], sp[:k] = keys[:k], payload[:k]
        return (sk, sp, nv, mf), cap

    set_attr(cls, "sort_device_wide", step)


def half_batch(set_attr=setattr) -> None:
    cls = _sorter()
    orig = cls.sort_device_wide

    def step(self, keys, payload, capacity=None):
        half = keys.shape[0] // 2
        cap = capacity or self._capacity(keys.shape[0])
        return orig(self, keys[:half], payload[:half], cap)

    set_attr(cls, "sort_device_wide", step)


def no_exchange(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.parallel.group import ExchangeGroup

    set_attr(ExchangeGroup, "all_to_all", lambda self, x: x.clone())


def altered(set_attr=setattr) -> None:
    cls = _sorter()
    orig = cls.sort_device_wide

    def step(self, keys, payload, capacity=None):
        (sk, sp, nv, mf), cap = orig(self, keys, payload, capacity)
        sp[0, 0] ^= 1
        return (sk, sp, nv, mf), cap

    set_attr(cls, "sort_device_wide", step)


def tpcds_unchanged(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.models import join_aggregate

    def make(n_devices, n_left, n_right_total, group_key_fn,
             agg_val_fn=None, group=None):
        def step(lk, lv, l_valid, rk, rv, r_valid):
            valid = l_valid.int()
            return lk, lv, valid, lv, lv, valid.sum().reshape(1)
        return step

    set_attr(join_aggregate, "make_broadcast_join_aggregate_step", make)


def tpcds_half_batch(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.models import join

    orig = join.make_hash_join_step

    def make(n_devices, n_left, n_right, capacity, group=None):
        step = orig(n_devices, n_left, n_right, capacity, group)

        def half(lk, lv, l_valid, rk, rv, r_valid):
            l_valid = l_valid.clone()
            l_valid[n_left // 2:] = 0
            return step(lk, lv, l_valid, rk, rv, r_valid)
        return half

    set_attr(join, "make_hash_join_step", make)


def tpcds_altered(set_attr=setattr) -> None:
    from sparkrdma_tpu_torch.models import join_aggregate

    orig = join_aggregate.make_broadcast_join_aggregate_step

    def make(*args, **kw):
        step = orig(*args, **kw)

        def alt(*cols):
            out = list(step(*cols))
            first = int((out[2] > 0).nonzero()[0, 0])
            out[1] = out[1].clone()
            out[1][first] += 1
            return tuple(out)
        return alt

    set_attr(join_aggregate, "make_broadcast_join_aggregate_step", make)
