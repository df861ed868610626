"""Driver of ``tpcds_sf100_q67``: each step of the window is TPC-DS query
67 on one card's share of ``store_sales``, through the port's entries,
with no host synchronisation inside the step:

1. ``make_hash_join_step`` of the fact rows (the date key; the row
   number as payload) with ``date_dim``: the month predicate
   (:func:`month_ok`) is the dimension rows' validity, and the day's
   year, quarter and month, packed as the key's date fields, its
   payload;
2. ``compact_flagged`` of the matched rows' (row, date fields) into
   ``row_capacity`` slots; the slots' item, store and
   ``ss_sales_price * ss_quantity`` (:func:`sales`, int64 cents) are
   gathered by row;
3. the item and store joins (``make_hash_join_step``) of the slots,
   each dimension's attributes packed as its payload (the item's
   category, class, brand and product; the store's ``s_store_id``),
   scattered back to the slots;
4. ``make_count_step`` (one card, no validity column) sums the value by
   the packed 8-column key; ``compact_flagged`` packs the groups;
5. ``make_rollup_step`` (``models/rollup.py``): the 9 grouping sets of
   the ROLLUP, level-major;
6. ``make_topk_step(ties="rank")`` partitioned by :func:`partition`
   (``i_category``; the grand total a partition of its own), value
   ``sumsales``, keeps ``rk <= rank_limit``;
7. ``compact_flagged`` of the kept rows, whose 8 columns (NULL, -1, in
   the columns their level rolls up) are unpacked from the key.

Every capacity doubles on an overflow of any, ``capacity_doublings``
times at most.  One card only: no exchange.  The tables are made on
the device from the seed by ``inputs/tpcds_sf100_q67.py`` and stay the
same for every step; the predicate is evaluated in every step.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from sparkrdma_tpu_torch.models import join as join_mod
from sparkrdma_tpu_torch.models import rollup as rollup_mod
from sparkrdma_tpu_torch.models import topk as topk_mod
from sparkrdma_tpu_torch.models import wordcount
from sparkrdma_tpu_torch.ops import scan_kernels, segment

from shufflebench.common import module

KEY_FILL = torch.iinfo(torch.int64).max
COLUMNS = 8

# least bytes of the step's scan stages, each counted once as the whole
# work it does over the rows that hold data, however many launches run
# it and however many capacity slots it spans: a join's probe reads a
# row's dimension flag, key and payload words and writes the filled
# value and the match flag (4-byte transport words); a compaction reads
# a row's flag and writes its position; the reduction reads a sorted
# row's value and run-end flag and writes its run-end sum and count;
# the rollup reads each group's sum and writes its running total, and
# per coarser level reads a row's run-end flag and writes its position
# (level 1 over the groups, the later levels over level 1's rows); the
# rank reads a row's two run-end flags and writes the two run starts
FLAG, WORD32, WORD64 = 1, 4, 8
PROBE_BYTES_PER_ROW = FLAG + 3 * WORD32 + FLAG
COMPACT_BYTES_PER_ROW = FLAG + WORD32
REDUCE_BYTES_PER_ROW = (WORD64 + FLAG) + (WORD64 + WORD32)
ROLLUP_BYTES_PER_GROUP = 2 * WORD64 + COMPACT_BYTES_PER_ROW
ROLLUP_BYTES_PER_LEVEL1_ROW = (COLUMNS - 1) * COMPACT_BYTES_PER_ROW
RANK_BYTES_PER_ROW = 2 * (FLAG + WORD32)


def scan_bytes(n_fact: int, n_date: int, n_item: int, n_store: int,
               n_match: int, n_groups: int, n_level1: int,
               n_rollup: int) -> int:
    """Least bytes of the step's scans: the date join's probe and the
    matched rows' compaction over the fact and date rows; the item and
    store joins' probes over the ``n_match`` matched rows and each
    dimension; the reduction and the groups' compaction over the matched
    rows; the rollup's running total and level 1 over the ``n_groups``
    groups, its later levels over level 1's ``n_level1`` rows; the rank
    and the kept rows' compaction over the ``n_rollup`` rows of the
    nine levels."""
    m1 = n_fact + n_date
    return ((PROBE_BYTES_PER_ROW + COMPACT_BYTES_PER_ROW) * m1
            + PROBE_BYTES_PER_ROW * (2 * n_match + n_item + n_store)
            + (REDUCE_BYTES_PER_ROW + COMPACT_BYTES_PER_ROW) * n_match
            + ROLLUP_BYTES_PER_GROUP * n_groups
            + ROLLUP_BYTES_PER_LEVEL1_ROW * n_level1
            + (RANK_BYTES_PER_ROW + COMPACT_BYTES_PER_ROW) * n_rollup)


def month_ok(month_seq, first: int, last: int):
    """The month predicate on ``date_dim`` (int32 0/1)."""
    return ((month_seq >= first) & (month_seq <= last)).to(torch.int32)


def sales(quantity, price):
    """``ss_sales_price * ss_quantity`` in int64 cents."""
    return quantity.long() * price.long()


def partition(keys, levels, shift: int, grand_total: int):
    """The rank's partition, ``i_category`` (the key's top field), with
    the grand total's NULL category as -1."""
    return torch.where(levels == grand_total, -1,
                       keys >> shift).to(torch.int32)


class KeyLayout:
    """Each column's shift and width in the packed key, most significant
    first, from the configuration's ``group_key``."""

    def __init__(self, config):
        g = config["group_key"]
        self.bits: List[int] = [int(b) for b in g["bits"]]
        self.year_base = int(g["year_base"])
        self.shifts = [sum(self.bits[i + 1:]) for i in range(COLUMNS)]
        self.width = sum(self.bits)

    def fields(self, first: int, *cols):
        """Columns ``first``, ``first + 1``, .. packed as the key packs
        them, shifted down so that the last given is at bit 0 (int64)."""
        low = self.shifts[first + len(cols) - 1]
        word = torch.zeros_like(cols[0], dtype=torch.int64)
        for i, c in enumerate(cols):
            word = word | (c.long() << (self.shifts[first + i] - low))
        return word

    def check(self, name: str, col, at: int) -> None:
        top = int(col.max()) if col.numel() else 0
        low = int(col.min()) if col.numel() else 0
        if low < 0 or top >= 1 << self.bits[at]:
            raise ValueError(f"{name} spans {low} .. {top}, beyond its "
                             f"{self.bits[at]} key bits")

    def unpack(self, keys, levels):
        """The 8 columns of packed keys, int32; a column the row's level
        rolls up is NULL, -1."""
        out = []
        for i in range(COLUMNS):
            v = (keys >> self.shifts[i]) & ((1 << self.bits[i]) - 1)
            if i == 4:
                v = v + self.year_base
            out.append(torch.where(levels < COLUMNS - i, v, -1)
                       .to(torch.int32))
        return out


class Job:
    """One card's share of the cell: its tables and the step's entries."""

    def __init__(self, config, seed: int, rank: int, world: int, group,
                 device):
        if world != 1:
            raise ValueError("tpcds_sf100_q67 runs on one card")
        t = module("inputs", "tpcds_sf100_q67").make_tables(config, seed,
                                                            rank, device)
        self.config, self.device = config, device
        self.layout = lay = KeyLayout(config)
        self.ss_date, self.ss_item = t["ss_date"], t["ss_item"]
        self.ss_store = t["ss_store"]
        self.ss_qty, self.ss_price = t["ss_quantity"], t["ss_sales_price"]
        n = self.ss_date.shape[0]
        self.fact_row = torch.arange(n, dtype=torch.int32, device=device)
        self.fact_ones = torch.ones(n, dtype=torch.int32, device=device)
        year = t["d_year"] - lay.year_base
        for name, col, at in (("i_category", t["i_category"], 0),
                              ("i_class", t["i_class"], 1),
                              ("i_brand", t["i_brand"], 2),
                              ("i_item_sk", t["i_sk"], 3), ("d_year", year, 4),
                              ("d_qoy", t["d_qoy"], 5), ("d_moy", t["d_moy"], 6),
                              ("s_store_id", t["s_store_id"], 7)):
            lay.check(name, col, at)
        if lay.width > 62 or sum(lay.bits[:4]) > 31:
            raise ValueError("the key must fit 62 bits and the item's "
                             "fields an int32 payload")
        self.d_sk, self.d_seq = t["d_sk"], t["d_month_seq"]
        # each dimension's fields of the key, as its join payload
        self.d_bits = lay.fields(4, year, t["d_qoy"], t["d_moy"]).to(
            torch.int32)
        self.i_sk = t["i_sk"]
        self.i_bits = lay.fields(0, t["i_category"], t["i_class"],
                                 t["i_brand"], t["i_sk"]).to(torch.int32)
        self.s_sk, self.s_id = t["s_sk"], t["s_store_id"]
        self.months = tuple(int(m) for m in config["month_seq"])
        self.k = int(config["rank_limit"])
        self.date_join = join_mod.make_hash_join_step(
            1, n, self.d_sk.shape[0], 0, None)
        self.factors = tuple(range(int(config["capacity_doublings"]) + 1))
        self.use_factor(self.factors[0])
        self.launches = 0
        self.counts = None

    def use_factor(self, doubling: int) -> None:
        c = self.config
        self.rows = int(c["row_capacity"]) << doubling
        self.rollup_rows = int(c["rollup_capacity"]) << doubling
        self.kept = int(c["kept_capacity"]) << doubling
        dev = self.device
        self.item_join = join_mod.make_hash_join_step(
            1, self.rows, self.i_sk.shape[0], 0, None)
        self.store_join = join_mod.make_hash_join_step(
            1, self.rows, self.s_sk.shape[0], 0, None)
        self.sum_step = wordcount.make_count_step(1, self.rows, self.rows,
                                                  with_validity=False)
        self.rollup = rollup_mod.make_rollup_step(self.rows, self.rollup_rows,
                                                  self.layout.bits)
        self.topk = topk_mod.make_topk_step(1, self.rollup_rows,
                                            self.rollup_rows, self.k,
                                            ties="rank")
        self.slots = torch.arange(self.rows, dtype=torch.int32, device=dev)
        self.rollup_slots = torch.arange(self.rollup_rows, dtype=torch.int32,
                                         device=dev)
        self.kept_slots = torch.arange(self.kept, dtype=torch.int32,
                                       device=dev)
        self.dump = {m: self.rows + torch.arange(self.rows + m, device=dev)
                     for m in (self.i_sk.shape[0], self.s_sk.shape[0])}

    def _joined(self, join, keys, valid, dim_keys, dim_pay):
        """The dimension payload each slot's key joins, by slot (-1 where
        it joins none): the join's matched rows carry their slot as the
        fact payload and are scattered back to it."""
        dim_ones = torch.ones_like(dim_keys)
        _sk, slot, val, found, _fact, _fill = join(
            keys, self.slots, valid, dim_keys, dim_pay, dim_ones)
        dest = torch.where(found > 0, slot.long(),
                           self.dump[dim_keys.shape[0]])
        out = torch.full((dest.shape[0] + self.rows,), -1, dtype=torch.int32,
                         device=keys.device)
        out.scatter_(0, dest, val)
        return out[:self.rows]

    def step(self):
        """One run of the query; returns, without waiting for the
        device: the kept rows' 8 columns, level, sumsales and rk in
        ``kept_capacity`` slots (past the kept rows' count they hold
        fills) and that count ([1]); the rollup's rows (packed keys,
        levels, sums in ``rollup_capacity`` slots) and their count
        ([1]); the matched and group counts ([1] each) and each level's
        first slot."""
        lay, before = self.layout, scan_kernels.LAUNCHES.count
        date_ok = month_ok(self.d_seq, *self.months)
        _sk, row, dbits, found, _fact, _fill = self.date_join(
            self.ss_date, self.fact_row, self.fact_ones, self.d_sk,
            self.d_bits, date_ok)
        (row, dbits), n_match = segment.compact_flagged(
            found.bool(), (row, dbits), self.rows, (0, 0))
        del found, _sk, _fact
        live = self.slots < n_match
        valid = live.to(torch.int32)
        ibits = self._joined(self.item_join, self.ss_item[row], valid,
                             self.i_sk, self.i_bits)
        sid = self._joined(self.store_join, self.ss_store[row], valid,
                           self.s_sk, self.s_id)
        live = live & (ibits >= 0) & (sid >= 0)
        key = ((ibits.long() << lay.shifts[3])
               | (dbits.long() << lay.shifts[6]) | sid.long())
        key = torch.where(live, key, KEY_FILL)
        value = sales(self.ss_qty[row], self.ss_price[row])
        value = torch.where(live, value, 0)
        del row, dbits, ibits, sid
        uniq, sums, counts, _nu, _f = self.sum_step(key, value)
        del key, value
        (gkey, gsum), n_groups = segment.compact_flagged(
            (counts > 0) & (uniq != KEY_FILL), (uniq, sums), self.rows,
            (KEY_FILL, 0))
        del uniq, sums, counts
        rkey, level, rsum, n_rows, starts = self.rollup(gkey, gsum, n_groups)
        del gkey, gsum
        part = partition(rkey, level, lay.shifts[0], COLUMNS)
        _ks, vs, keep, _nk, _f, rk, pay = self.topk(
            part, rsum, (self.rollup_slots < n_rows).to(torch.int32),
            self.rollup_slots)
        (pay, vs, rk), n_kept = segment.compact_flagged(
            keep.bool(), (pay, vs, rk), self.kept, (0, 0, 0))
        kept = self.kept_slots < n_kept
        lvl = torch.where(kept, level[pay], COLUMNS + 1)
        cols = lay.unpack(rkey[pay], lvl)
        out = (*cols, torch.where(kept, lvl, -1), torch.where(kept, vs, 0),
               torch.where(kept, rk, 0), n_kept, rkey, level, rsum, n_rows,
               n_match, n_groups, starts)
        self.launches = scan_kernels.LAUNCHES.count - before
        self.counts = (n_rows, n_match, n_groups, starts, n_kept)
        return out

    def overflowed(self, out) -> bool:
        n_kept = int(out[COLUMNS + 3][0])
        n_rows, n_match, n_groups = (int(c[0]) for c in out[-4:-1])
        coarse = n_rows - int(out[-1][1])
        return (n_match > self.rows or n_groups > self.rows
                or coarse > self.rollup_rows - self.rows
                or n_kept > self.kept)

    def info(self) -> Dict[str, object]:
        n_rows, n_match, n_groups = (int(c[0]) for c in self.counts[:3])
        rows = rollup_mod.level_rows(self.counts[3])
        n_kept = int(self.counts[4][0])
        n = int(self.ss_date.shape[0])
        return {"kernel1_launches_per_step": self.launches,
                "fact_rows_per_card": n, "matched_rows": n_match,
                "groups": n_groups, "rollup_rows": n_rows,
                "level_rows": ",".join(str(r) for r in rows),
                "kept_rows": n_kept, "row_capacity": self.rows,
                "rollup_capacity": self.rollup_rows,
                "scan_bytes_per_step": scan_bytes(
                    n, int(self.d_sk.shape[0]), int(self.i_sk.shape[0]),
                    int(self.s_sk.shape[0]), n_match, n_groups, rows[1],
                    n_rows)}

    def release(self) -> None:
        del self.ss_date, self.ss_item, self.ss_store, self.ss_qty
        del self.ss_price, self.fact_row, self.fact_ones, self.d_sk
        del self.d_seq, self.d_bits, self.i_sk, self.i_bits, self.s_sk
        del self.s_id, self.date_join, self.item_join, self.store_join
        del self.sum_step, self.rollup, self.topk, self.slots
        del self.rollup_slots, self.kept_slots, self.dump, self.counts
