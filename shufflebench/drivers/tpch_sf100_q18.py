"""Driver of ``tpch_sf100_q18``: each step of the window is TPC-H query
18 on one card's share of ``lineitem`` and ``orders``, through the
port's entries, with no host synchronisation inside the step:

1. ``make_count_step`` (one card, no validity column): the sum of
   ``l_quantity`` by ``l_orderkey`` in the run-end layout;
2. HAVING: :func:`having` on that layout (``sum > having_quantity``);
3. ``compact_flagged`` of the survivors' (key, sum) into the capacity's
   slots, with their true count;
4. ``make_hash_join_step`` of ``orders`` (fact: the order key and the
   order's row) with the survivors (dimension: key and sum, valid below
   the count);
5. ``compact_flagged`` of the matched rows, then ``o_custkey``,
   ``o_orderdate`` and ``o_totalprice`` gathered by the matched row.

The capacity starts at ``survivor_capacity`` and doubles on an
overflow (a count above it), ``capacity_doublings`` times at most.
One card only: the reduction and the join run no exchange.  The tables
are made on the device from the seed by ``inputs/tpch_sf100_q18.py``
and stay the same for every step.
"""

from __future__ import annotations

from typing import Dict

import torch

from sparkrdma_tpu_torch.models import join as join_mod
from sparkrdma_tpu_torch.models import wordcount
from sparkrdma_tpu_torch.ops import scan_kernels, segment

from shufflebench.common import module

KEY_FILL = torch.iinfo(torch.int32).max

# least bytes of the step's scan stages, each counted once as the whole
# work it does, however many launches run it: the reduction reads a
# sorted row's value and run-end flag and writes its run-end sum and
# count; a compaction reads a row's flag and writes its position; the
# join's probe reads a row's dimension flag, key and payload words and
# writes the filled value and the match flag (4-byte transport words)
FLAG, WORD32 = 1, 4
REDUCE_BYTES_PER_ROW = (WORD32 + FLAG) + 2 * WORD32
COMPACT_BYTES_PER_ROW = FLAG + WORD32
PROBE_BYTES_PER_ROW = FLAG + 3 * WORD32 + FLAG


def scan_bytes(n_lines: int, n_orders: int, capacity: int) -> int:
    """Least bytes of the step's scans: the reduction and the survivors'
    compaction over the lineitem rows, then the join's probe and the
    matched rows' compaction over the orders and the survivor slots."""
    m = n_orders + capacity
    return ((REDUCE_BYTES_PER_ROW + COMPACT_BYTES_PER_ROW) * n_lines
            + (PROBE_BYTES_PER_ROW + COMPACT_BYTES_PER_ROW) * m)


def having(sums, quantity: int):
    """The HAVING predicate on the run-end layout's sums (0 off the run
    ends)."""
    return sums > quantity


class Job:
    """One card's share of the cell: its tables and the step's entries."""

    def __init__(self, config, seed: int, rank: int, world: int, group,
                 device):
        if world != 1:
            raise ValueError("tpch_sf100_q18 runs on one card")
        t = module("inputs", "tpch_sf100_q18").make_tables(config, seed,
                                                           rank, device)
        self.device = device
        self.l_key, self.l_qty = t["l_orderkey"], t["l_quantity"]
        self.o_key, self.o_cust = t["o_orderkey"], t["o_custkey"]
        self.o_date, self.o_price = t["o_orderdate"], t["o_totalprice"]
        n_o = self.o_key.shape[0]
        self.o_row = torch.arange(n_o, dtype=torch.int32, device=device)
        self.o_ones = torch.ones(n_o, dtype=torch.int32, device=device)
        self.quantity = int(config["having_quantity"])
        n_l = self.l_key.shape[0]
        self.count = wordcount.make_count_step(1, n_l, n_l,
                                               with_validity=False)
        cap = int(config["survivor_capacity"])
        self.factors = tuple(cap << i for i in
                             range(int(config["capacity_doublings"]) + 1))
        self.use_factor(self.factors[0])
        self.launches = 0
        self.survivors = None

    def use_factor(self, capacity: int) -> None:
        self.capacity = capacity
        self.join = join_mod.make_hash_join_step(
            1, self.o_key.shape[0], capacity, 0, None)
        self.slots = torch.arange(capacity, dtype=torch.int32,
                                  device=self.device)

    def step(self):
        """One run of the query; returns (o_orderkey, o_custkey,
        o_orderdate, o_totalprice, sum_qty) in ``capacity`` slots
        ascending by order key, then the survivors' and the matched
        rows' true counts ([1] each), without waiting for the device.
        Past the matched count the slots hold the fill values."""
        before = scan_kernels.LAUNCHES.count
        uniq, sums, _c, _n, _f = self.count(self.l_key, self.l_qty)
        (s_key, s_sum), n_surv = segment.compact_flagged(
            having(sums, self.quantity), (uniq, sums), self.capacity,
            (KEY_FILL, 0))
        del uniq, sums
        s_valid = (self.slots < n_surv).to(torch.int32)
        sk, row, qty, found, _fact, _fill = self.join(
            self.o_key, self.o_row, self.o_ones, s_key, s_sum, s_valid)
        (okey, row, qty), n_out = segment.compact_flagged(
            found.bool(), (sk, row, qty), self.capacity, (KEY_FILL, 0, 0))
        live = self.slots < n_out
        out = (okey, torch.where(live, self.o_cust[row], 0),
               torch.where(live, self.o_date[row], 0),
               torch.where(live, self.o_price[row], 0), qty, n_surv, n_out)
        self.launches = scan_kernels.LAUNCHES.count - before
        self.survivors = n_surv
        return out

    def overflowed(self, out) -> bool:
        return int(out[5][0]) > self.capacity

    def info(self) -> Dict[str, object]:
        n_l, n_o = int(self.l_key.shape[0]), int(self.o_key.shape[0])
        return {"kernel1_launches_per_step": self.launches,
                "lineitem_rows": n_l, "orders_rows": n_o,
                "capacity": self.capacity,
                "survivors": int(self.survivors[0]),
                "scan_bytes_per_step": scan_bytes(n_l, n_o, self.capacity)}

    def release(self) -> None:
        del self.l_key, self.l_qty, self.o_key, self.o_cust, self.o_date
        del self.o_price, self.o_row, self.o_ones, self.count, self.join
        del self.slots, self.survivors
