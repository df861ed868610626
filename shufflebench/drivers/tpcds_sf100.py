"""Driver of ``tpcds_sf100``: each step of the window is TPC-DS query
55 on one card's share of ``store_sales``, in two steps of the port:

1. ``make_hash_join_step`` of the fact rows with ``date_dim`` on the
   date key; the date predicate (``d_year``, ``d_moy``) marks the valid
   dimension rows, and each fact row's item key and price ride as one
   int64 payload word;
2. ``make_broadcast_join_aggregate_step`` of the matched rows with
   ``item`` on the item key; the manager predicate marks the valid item
   rows, the group is the item's ``i_brand_id`` (a function of the join
   key, as the fusion needs) and the aggregate is the sum, count, min
   and max of the price in int64 cents.

One card only: the hash join runs no exchange.  The tables are made on
the device from the seed by ``inputs/tpcds_sf100.py`` and stay the
same for every step; the predicates are evaluated in every step.
"""

from __future__ import annotations

from typing import Dict

import torch

from sparkrdma_tpu_torch.models import join as join_mod
from sparkrdma_tpu_torch.models import join_aggregate as ja_mod
from sparkrdma_tpu_torch.ops import scan_kernels

from shufflebench.common import module

LOW32 = (1 << 32) - 1

# least bytes of the step's two scan stages, each counted once as the
# whole work it does, however many launches run it: the probe reads a
# row's dimension flag, key and payload words and writes the filled
# value and the match flag; the aggregate reads the flag, key, payload
# and group-run flag and writes the run-end sum, count, min and max
FLAG, WORD32, WORD64 = 1, 4, 8
PROBE_BYTES_PER_ROW = FLAG + 3 * WORD64 + FLAG  # int64 transport words
AGG_BYTES_PER_ROW = (FLAG + 2 * WORD32 + FLAG) + (3 * WORD64 + WORD32)


def scan_bytes(config) -> int:
    """Least bytes of the step's scans: the date join's probe over the
    fact and date rows, then the item join's probe and the aggregate's
    scans over those rows and the item rows."""
    m1 = int(config["fact_rows_per_card"]) + int(config["date_dim_rows"])
    m2 = m1 + int(config["item_rows"])
    return PROBE_BYTES_PER_ROW * m1 + AGG_BYTES_PER_ROW * m2


def price(key_u, fact_pay_u, dim_val_u):
    """The aggregated value: the fact row's price in cents, int64."""
    return fact_pay_u


class Job:
    """One card's share of the cell: its tables and the two steps."""

    def __init__(self, config, seed: int, rank: int, world: int, group,
                 device):
        if world != 1:
            raise ValueError("tpcds_sf100 runs on one card")
        t = module("inputs", "tpcds_sf100").make_tables(config, seed, rank,
                                                        device)
        self.config = config
        self.pred = config["predicate"]
        # the fact rows as the plan carries them: the date key, and the
        # item key and price in one payload word
        self.ss_date = t["ss_date"]
        self.ss_pay = (t["ss_price"].long() << 32) | t["ss_item"].long()
        self.ss_ones = torch.ones_like(self.ss_date)
        self.d_sk, self.d_year, self.d_moy = t["d_sk"], t["d_year"], \
            t["d_moy"]
        self.i_sk, self.i_manager = t["i_sk"], t["i_manager"]
        # the brand of item sk k at k; index 0 and keys past the items
        # (dimension rows' payloads, never valid) read 0
        brand = torch.zeros(self.i_sk.shape[0] + 2, dtype=torch.int64,
                            device=device)
        brand[1:-1] = t["i_brand"]
        top = brand.shape[0] - 1

        def brand_of(key_u):
            return brand[key_u.clamp(0, top)]

        n, n_date = self.ss_date.shape[0], self.d_sk.shape[0]
        self.step1 = join_mod.make_hash_join_step(1, n, n_date, 0, None)
        self.step2 = ja_mod.make_broadcast_join_aggregate_step(
            1, n + n_date, self.i_sk.shape[0], brand_of, price, None)
        self.factors = (None,)
        self.launches = 0

    def use_factor(self, factor) -> None:
        raise AssertionError("one card has no capacity to retry")

    def step(self):
        """One run of the query; returns (brand, sums, counts, mins,
        maxs) in the run-end layout, without waiting for the device."""
        p = self.pred
        before = scan_kernels.LAUNCHES.count
        date_ok = ((self.d_year == p["d_year"])
                   & (self.d_moy == p["d_moy"])).int()
        item_ok = (self.i_manager == p["i_manager_id"]).int()
        _sk, pay, _dval, found, _fact, _fill = self.step1(
            self.ss_date, self.ss_pay, self.ss_ones, self.d_sk, self.d_sk,
            date_ok)
        item = (pay & LOW32).int()
        cents = (pay >> 32).int()
        out = self.step2(item, cents, found, self.i_sk, self.i_sk, item_ok)
        self.launches = scan_kernels.LAUNCHES.count - before
        return out[:5]

    def overflowed(self, out) -> bool:
        return False

    def info(self) -> Dict[str, object]:
        return {"kernel1_launches_per_step": self.launches,
                "fact_rows_per_card": int(self.ss_date.shape[0]),
                "scan_bytes_per_step": scan_bytes(self.config)}

    def release(self) -> None:
        del self.ss_date, self.ss_pay, self.ss_ones, self.d_sk, self.d_year
        del self.d_moy, self.i_sk, self.i_manager, self.step1, self.step2
