"""The tables of TPC-DS query 67, made on the device from the seed with
the generators of ``inputs/tpcds_sf100.py`` (imported, not copied).

- ``date_dim``: as query 55's, with ``d_month_seq`` and ``d_qoy`` of
  each day (``configs/tpcds_sf100_q67.json``, ``assumed``);
- ``item``: ``i_item_sk`` 1 .. ``item_rows`` with ``i_category``,
  ``i_class`` and ``i_brand`` drawn as query 55's ``i_brand_id`` parts
  are, from the same stream of the seed;
- ``store``: ``s_store_sk`` 1 .. ``store_rows`` and ``s_store_id`` =
  ``(s_store_sk + 1) // 2``;
- ``store_sales`` (rank r's share, ``fact_rows_per_card`` rows):
  ``ss_sold_date_sk`` uniform over the sales dates, ``ss_item_sk`` and
  ``ss_store_sk`` uniform over their keys, ``ss_quantity`` and
  ``ss_sales_price`` (cents) priced as query 55's rows are.

The dimensions are one stream each of the seed, the same on every rank
(broadcast tables); the fact share is a stream of (seed, rank).  Plain
torch only.
"""

from __future__ import annotations

from typing import Dict

from shufflebench.common import generator, module


def make_tables(config, seed: int, rank: int, device) -> Dict[str, object]:
    import torch

    base = module("inputs", "tpcds_sf100")
    uniform = base._uniform
    n = int(config["fact_rows_per_card"])
    n_item, n_date = int(config["item_rows"]), int(config["date_dim_rows"])
    n_store = int(config["store_rows"])
    d_sk = torch.arange(n_date, dtype=torch.int64, device=device) \
        + int(config["date_dim_first_sk"])
    d_year, d_moy = base.civil(d_sk)
    g = generator(device, seed, base._DIMS, 0)
    cat, cls, brand = config["brand_parts"]
    i_category = uniform(g, 1, cat, n_item, device)
    i_class = uniform(g, 1, cls, n_item, device)
    i_brand = uniform(g, 1, brand, n_item, device)
    s_sk = torch.arange(1, n_store + 1, dtype=torch.int32, device=device)
    g = generator(device, seed, rank, 0)
    lo, hi = config["sales_date_sk"]
    ss_date = uniform(g, int(lo), int(hi), n, device)
    ss_item = uniform(g, 1, n_item, n, device)
    ss_store = uniform(g, 1, n_store, n, device)
    p = config["pricing"]
    qty = uniform(g, *p["quantity"], n, device)
    cost = uniform(g, *p["wholesale_cost_cents"], n, device)
    markup = uniform(g, *p["markup_pct"], n, device)
    discount = uniform(g, *p["discount_pct"], n, device)
    price = cost * (100 + markup) // 100 * (100 - discount) // 100
    del cost, markup, discount
    return dict(
        d_sk=d_sk.to(torch.int32), d_year=d_year.to(torch.int32),
        d_moy=d_moy.to(torch.int32),
        d_qoy=((d_moy - 1) // 3 + 1).to(torch.int32),
        d_month_seq=((d_year - 1900) * 12 + d_moy - 1).to(torch.int32),
        i_sk=torch.arange(1, n_item + 1, dtype=torch.int32, device=device),
        i_category=i_category, i_class=i_class, i_brand=i_brand,
        s_sk=s_sk, s_store_id=(s_sk + 1) // 2,
        ss_date=ss_date, ss_item=ss_item, ss_store=ss_store,
        ss_quantity=qty, ss_sales_price=price)
