"""The tables of TPC-H query 18 on one card's share, made on the device
from the seed, as dbgen (TPC-H v3.0.1, clause 4.2.3) makes their
columns:

- ``orders``: ``orders_per_card`` orders, the card's share of the order
  indices (``4 j + rank + 1`` at 4 cards), each with dbgen's sparse
  key (the first 8 of every 32: index i keeps its low 3 bits and moves
  the rest up 2); ``o_custkey`` uniform over the customer keys that are
  not multiples of 3; ``o_orderdate`` uniform over ``orderdate_days``
  (days since 1970-01-01); 1 to 7 lines an order, uniform;
- ``lineitem``: each order's lines, ``l_quantity`` uniform over
  1 .. 50; ``l_partkey``, ``l_discount`` and ``l_tax`` only price the
  order: ``o_totalprice`` is dbgen's integer sum over its lines, in
  cents (``configs/tpch_sf100_q18.json``, ``assumed``).

Both tables reach the card in an order permuted from the seed, as a
hash shuffle's reduce side receives them.  Plain torch only.
"""

from __future__ import annotations

from typing import Dict

from shufflebench.common import generator


def sparse_key(i):
    """dbgen's ``mk_sparse`` of 1-based order indices (int64)."""
    return ((i >> 3) << 5) | (i & 7)


def retail_cents(partkey):
    """p_retailprice of int64 part keys, in cents (clause 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def make_tables(config, seed: int, rank: int, device) -> Dict[str, object]:
    """The card's ``orders`` (o_orderkey, o_custkey, o_orderdate as
    int32, o_totalprice as int64) and ``lineitem`` (l_orderkey,
    l_quantity as int32), each in its arrival order."""
    import torch

    n_o = int(config["orders_per_card"])
    cards = int(config["cards"])
    g = generator(device, seed, rank, 0)

    def uniform(lo, hi, n, dtype=torch.int64):
        return torch.randint(int(lo), int(hi) + 1, (n,), generator=g,
                             dtype=dtype, device=device)

    index = torch.arange(n_o, dtype=torch.int64, device=device) * cards \
        + rank + 1
    o_key = sparse_key(index)
    mort = int(config["customer_mortality"])
    u = uniform(0, int(config["customer_rows"]) * (mort - 1) // mort - 1, n_o)
    o_cust = mort * (u // (mort - 1)) + 1 + u % (mort - 1)
    o_date = uniform(*config["orderdate_days"], n_o, torch.int32)
    lines = uniform(*config["lines_per_order"], n_o)
    order_of_line = torch.repeat_interleave(
        torch.arange(n_o, device=device), lines)
    n_l = int(order_of_line.shape[0])
    qty = uniform(*config["quantity"], n_l, torch.int32)
    part = uniform(1, config["part_rows"], n_l)
    disc = uniform(*config["discount_pct"], n_l)
    tax = uniform(*config["tax_pct"], n_l)
    line = retail_cents(part) * qty * (100 - disc) // 100 * (100 + tax) // 100
    del part, disc, tax
    o_price = torch.zeros(n_o, dtype=torch.int64, device=device)
    o_price.index_add_(0, order_of_line, line)
    del line
    l_perm = torch.randperm(n_l, generator=g, device=device)
    l_key = o_key.to(torch.int32)[order_of_line[l_perm]]
    l_qty = qty[l_perm]
    del order_of_line, l_perm, qty
    o_perm = torch.randperm(n_o, generator=g, device=device)
    return dict(o_orderkey=o_key.to(torch.int32)[o_perm],
                o_custkey=o_cust.to(torch.int32)[o_perm],
                o_orderdate=o_date[o_perm], o_totalprice=o_price[o_perm],
                l_orderkey=l_key, l_quantity=l_qty)
