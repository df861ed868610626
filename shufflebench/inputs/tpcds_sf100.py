"""The tables of TPC-DS query 55, made on the device from the seed.

- ``date_dim``: ``date_dim_rows`` days from ``date_dim_first_sk`` on;
  ``d_date_sk`` is the day's Julian day number, as in the spec's data,
  and ``d_year`` and ``d_moy`` are its civil year and month;
- ``item``: ``i_item_sk`` 1 .. ``item_rows``, each with an
  ``i_manager_id`` uniform over 1 .. ``manager_ids`` and an
  ``i_brand_id`` of category x 10^6 + class x 10^3 + brand, each part
  uniform over its range;
- ``store_sales`` (rank r's share, ``fact_rows_per_card`` rows):
  ``ss_sold_date_sk`` uniform over the sales dates ``sales_date_sk``,
  ``ss_item_sk`` uniform over the items, and ``ss_ext_sales_price`` in
  cents, priced as the spec prices a sale (``pricing``): a quantity, a
  wholesale cost, a markup on it to the list price, a discount off it
  to the sales price, and the sales price times the quantity.

The dimensions are one stream each of the seed, the same on every
rank (broadcast tables); the fact share is a stream of (seed, rank).
Plain torch only.
"""

from __future__ import annotations

from typing import Dict

from shufflebench.common import generator

_DIMS = 1 << 20  # stream numbers of the dimension tables, above any rank
UNIX_EPOCH_JDN = 2440588  # 1970-01-01


def civil(jdn):
    """(year, month) of int64 Julian day numbers, the proleptic
    Gregorian calendar (the days-to-civil algorithm of H. Hinnant)."""
    z = jdn - UNIX_EPOCH_JDN + 719468
    era = z.div(146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    month = mp + 3 - 12 * (mp >= 10).long()
    year = yoe + era * 400 + (month <= 2).long()
    return year, month


def _uniform(g, lo: int, hi: int, n: int, device):
    """n int32 draws uniform over [lo, hi]."""
    import torch

    return torch.randint(lo, hi + 1, (n,), generator=g, dtype=torch.int32,
                         device=device)


def make_tables(config, seed: int, rank: int, device) -> Dict[str, object]:
    import torch

    n = int(config["fact_rows_per_card"])
    n_item, n_date = int(config["item_rows"]), int(config["date_dim_rows"])
    d_sk = torch.arange(n_date, dtype=torch.int64, device=device) \
        + int(config["date_dim_first_sk"])
    d_year, d_moy = civil(d_sk)
    g = generator(device, seed, _DIMS, 0)
    cat, cls, brand = config["brand_parts"]
    i_brand = (_uniform(g, 1, cat, n_item, device) * 1000000
               + _uniform(g, 1, cls, n_item, device) * 1000
               + _uniform(g, 1, brand, n_item, device))
    i_manager = _uniform(g, 1, int(config["manager_ids"]), n_item, device)
    g = generator(device, seed, rank, 0)
    lo, hi = config["sales_date_sk"]
    ss_date = _uniform(g, int(lo), int(hi), n, device)
    ss_item = _uniform(g, 1, n_item, n, device)
    p = config["pricing"]
    qty = _uniform(g, *p["quantity"], n, device)
    cost = _uniform(g, *p["wholesale_cost_cents"], n, device)
    markup = _uniform(g, *p["markup_pct"], n, device)
    discount = _uniform(g, *p["discount_pct"], n, device)
    lst = cost * (100 + markup) // 100
    ss_price = lst * (100 - discount) // 100 * qty
    return dict(
        d_sk=d_sk.to(torch.int32), d_year=d_year.to(torch.int32),
        d_moy=d_moy.to(torch.int32),
        i_sk=torch.arange(1, n_item + 1, dtype=torch.int32, device=device),
        i_brand=i_brand, i_manager=i_manager,
        ss_date=ss_date, ss_item=ss_item, ss_price=ss_price)
