"""Configuration overrides that shrink each configuration to a size a
CPU test run holds: same shapes (100 B records, the star schema), few
rows."""

TERASORT = {"records_per_card": 4096, "bytes_per_step_per_card": 409600}
# enough records that equal 32-bit key prefixes occur (the control's
# fault shows only then): about 2^40 / 2^33 = 128 pairs
TERASORT_TIES = {"records_per_card": 1 << 20,
                 "bytes_per_step_per_card": 100 << 20}
TERASORT_TIES_D4 = {"records_per_card": 1 << 18,
                    "bytes_per_step_per_card": 100 << 18}
# November 1999 in the middle of 80 days of sales, 64 items of 8 brands
# and 4 managers: about 4096 x 30 / 80 / 4 = 384 matched rows
TPCDS = {"fact_rows_per_card": 4096, "item_rows": 64, "date_dim_rows": 80,
         "date_dim_first_sk": 2451464, "sales_date_sk": [2451464, 2451543],
         "manager_ids": 4, "brand_parts": [2, 2, 2],
         "predicate": {"i_manager_id": 3, "d_moy": 11, "d_year": 1999},
         "bytes_per_step_per_card": 12 * 4096}
CELLS = {"terasort.d1": TERASORT, "tpcds.d1": TPCDS, "terasort.d4": TERASORT}
# the four-rank TeraSort cell as a workload entry, so that the tests
# of the world's machinery do not depend on BENCHMARK.json listing it
D4_CELL = {"name": "terasort.d4", "config": "hibench_terasort",
           "traffic": "closed_loop.short_trace", "chips": 4}
