"""Deterministic TPC-DS subset generator.

Generates the tables q17 / q25 / q64 need, at a row scale controlled by
`scale` (scale=1.0 approximates SF0.1 row counts for the fact tables).
Schemas follow the TPC-DS column names/types the queries reference; value
distributions are synthetic but respect the join topology: every foreign
key is drawn from the referenced table's key domain, and store_returns /
catalog_sales rows are derived from actual store_sales rows so the
ss JOIN sr JOIN cs chains produce realistic match rates.

Everything is seeded — same scale, same bytes (and the same bytes as the
JAX package's generator, of which this is a copy).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

# Rows at scale=1.0 (fact tables ~ SF0.1 / 30; dimensions fixed).
_BASE = {
    "store_sales": 300_000,
    "date_dim": 73_049,     # 1998-01-01 .. 2197-12-31 in real TPC-DS
    "store": 12,
    "item": 2_000,
    "customer": 10_000,
    "promotion": 30,
}

TABLES = ("store_sales", "store_returns", "catalog_sales",
          "catalog_returns", "web_sales", "web_returns", "inventory",
          "date_dim", "store", "item", "customer", "promotion",
          "customer_demographics", "household_demographics",
          "customer_address", "time_dim", "reason", "income_band",
          "warehouse", "ship_mode", "web_site", "web_page", "call_center",
          "catalog_page")

_QUARTERS = ["%dQ%d" % (y, q) for y in range(1998, 2004)
             for q in range(1, 5)]


def _date_dim(n_dates: int):
    sk = np.arange(1, n_dates + 1, dtype=np.int64)
    # ~91-day quarters cycling through _QUARTERS; years 1998..2003.
    day = sk - 1
    year = 1998 + (day // 365)
    moy = 1 + (day % 365) // 31
    qoy = 1 + (moy - 1) // 3
    quarter_name = np.array(["%dQ%d" % (y, q) for y, q in
                             zip(year, np.minimum(qoy, 4))])
    _DAYS = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
    return {
        "d_date_sk": sk,
        "d_year": year.astype(np.int64),
        "d_moy": np.minimum(moy, 12).astype(np.int64),
        "d_dom": (1 + (day % 365) % 31).astype(np.int64),
        "d_dow": (day % 7).astype(np.int64),
        "d_day_name": np.array([_DAYS[d] for d in (day % 7)]),
        "d_qoy": np.minimum(qoy, 4).astype(np.int64),
        "d_quarter_name": quarter_name,
        # Sequential month/week counters (official d_month_seq/d_week_seq
        # semantics: monotone over the calendar) — the year-over-year
        # self-join queries (q2/q59) and month-window subqueries (q54)
        # key on these.
        "d_month_seq": ((year - 1998) * 12
                        + np.minimum(moy, 12) - 1).astype(np.int64),
        "d_week_seq": (day // 7 + 1).astype(np.int64),
    }


def generate(out_dir: str, scale: float = 1.0,
             seed: int = 20260730) -> Dict[str, str]:
    """Write the table subset as parquet dirs under `out_dir`; returns
    {table: path}. Idempotent for a given (out_dir, scale, seed): existing
    table dirs are reused."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    # Columns added in later rounds draw from a SEPARATE stream: inserting
    # draws into `rng`'s sequence would silently reshuffle every
    # previously-generated table (and the constants the query suite's
    # filters were tuned against).
    rng2 = np.random.default_rng(seed + 1)
    n_ss = max(int(_BASE["store_sales"] * scale), 1000)
    n_dates = _BASE["date_dim"] // 20  # ~6 years of days
    n_item = max(int(_BASE["item"] * min(scale, 4)), 200)
    n_cust = max(int(_BASE["customer"] * min(scale, 4)), 500)
    n_store = _BASE["store"]
    n_promo = _BASE["promotion"]

    tables: Dict[str, dict] = {}
    tables["date_dim"] = _date_dim(n_dates)

    tables["store"] = {
        "s_store_sk": np.arange(1, n_store + 1, dtype=np.int64),
        "s_store_id": np.array(["S%04d" % i for i in range(n_store)]),
        # q96 filters s_store_name = 'ese' (real TPC-DS store names are
        # spelled-out digit fragments); give a third of stores that name.
        "s_store_name": np.array([["ese", "store_%d" % (i % 7),
                                   "ation"][i % 3]
                                  for i in range(n_store)]),
        "s_number_employees": (200 + 17 * np.arange(n_store) % 110
                               ).astype(np.int64),
        "s_city": np.array([["Midway", "Fairview", "Oakdale", "Riverside",
                             "Centerville"][i % 5] for i in range(n_store)]),
        "s_state": np.array([["TN", "CA", "WA", "NY", "TX"][i % 5]
                             for i in range(n_store)]),
        "s_zip": np.array(["%05d" % (35000 + 13 * i) for i in range(n_store)]),
        # q24's market-grouped store pairing join.
        "s_market_id": (1 + np.arange(n_store) % 10).astype(np.int64),
        # q50's full select list (street/county/company identity columns).
        "s_company_id": np.ones(n_store, dtype=np.int64),
        "s_street_number": np.array(["%d" % (100 + 7 * i)
                                     for i in range(n_store)]),
        "s_street_name": np.array([["Main", "Oak", "Park", "First"][i % 4]
                                   for i in range(n_store)]),
        "s_street_type": np.array([["St", "Ave", "Blvd"][i % 3]
                                   for i in range(n_store)]),
        "s_suite_number": np.array(["Suite %d" % (10 * i)
                                    for i in range(n_store)]),
        "s_county": np.array([["Williamson County", "Ziebach County"][i % 2]
                              for i in range(n_store)]),
        "s_gmt_offset": np.full(n_store, -5.0),
        "s_company_name": np.array(["Unknown"] * n_store),
    }

    _CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Sports",
                   "Music", "Women", "Men", "Children", "Shoes"]
    tables["item"] = {
        "i_item_sk": np.arange(1, n_item + 1, dtype=np.int64),
        "i_item_id": np.array(["I%08d" % (i % (n_item // 2 + 1))
                               for i in range(n_item)]),
        "i_item_desc": np.array(["desc_%d" % (i % 997) for i in range(n_item)]),
        "i_product_name": np.array(["prod_%d" % i for i in range(n_item)]),
        "i_current_price": np.round(rng.uniform(0.5, 100.0, n_item), 2),
        "i_wholesale_cost": np.round(rng.uniform(0.3, 80.0, n_item), 2),
        "i_brand_id": (1001001 + (np.arange(n_item) % 60) * 1000
                       ).astype(np.int64),
        "i_brand": np.array(["brand_%02d" % (i % 60) for i in range(n_item)]),
        "i_category_id": (1 + np.arange(n_item) % 10).astype(np.int64),
        "i_category": np.array([_CATEGORIES[i % 10] for i in range(n_item)]),
        "i_class": np.array([["personal", "portable", "reference",
                              "self-help", "accessories", "classical",
                              "fragrances", "pants"][i % 8]
                             for i in range(n_item)]),
        "i_manufact_id": (1 + np.arange(n_item) % 200).astype(np.int64),
        "i_manufact": np.array(["manufact_%03d" % (i % 200)
                                for i in range(n_item)]),
        "i_manager_id": (1 + np.arange(n_item) % 100).astype(np.int64),
        "i_color": np.array([["red", "blue", "green", "plum", "puff",
                              "misty", "navy", "orange"][i % 8]
                             for i in range(n_item)]),
        "i_units": np.array([["Oz", "Bunch", "Ton", "N/A", "Dozen", "Box",
                              "Pound", "Pallet"][i % 8]
                             for i in range(n_item)]),
        "i_size": np.array([["medium", "extra large", "N/A", "small",
                             "petite", "large"][i % 6]
                            for i in range(n_item)]),
    }

    n_addr = 1000  # ss_addr_sk / c_current_addr_sk domain
    tables["customer"] = {
        "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_customer_id": np.array(["C%010d" % i for i in range(n_cust)]),
        "c_current_addr_sk": rng.integers(1, n_addr + 1,
                                          n_cust).astype(np.int64),
        "c_current_cdemo_sk": rng.integers(1, 1001,
                                           n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, 1001,
                                           n_cust).astype(np.int64),
        "c_first_sales_date_sk": rng.integers(
            1, _BASE["date_dim"] // 20 + 1, n_cust).astype(np.int64),
        "c_first_shipto_date_sk": rng.integers(
            1, _BASE["date_dim"] // 20 + 1, n_cust).astype(np.int64),
        "c_first_name": np.array(["fn_%d" % (i % 400) for i in range(n_cust)]),
        "c_last_name": np.array(["ln_%d" % (i % 700) for i in range(n_cust)]),
        "c_preferred_cust_flag": np.array([["Y", "N"][i % 2]
                                           for i in range(n_cust)]),
        "c_birth_country": np.array([["UNITED STATES", "CANADA", "MEXICO",
                                      "GERMANY", "JAPAN"][i % 5]
                                     for i in range(n_cust)]),
        "c_birth_year": (1940 + np.arange(n_cust) % 60).astype(np.int64),
        "c_birth_month": (1 + np.arange(n_cust) % 12).astype(np.int64),
        "c_salutation": np.array([["Mr.", "Mrs.", "Ms.", "Dr."][i % 4]
                                  for i in range(n_cust)]),
        "c_email_address": np.array(["c%d@example.com" % i
                                     for i in range(n_cust)]),
    }

    tables["promotion"] = {
        "p_promo_sk": np.arange(1, n_promo + 1, dtype=np.int64),
        "p_promo_id": np.array(["P%06d" % i for i in range(n_promo)]),
        "p_channel_email": np.array([["N", "Y"][i % 2]
                                     for i in range(n_promo)]),
        "p_channel_event": np.array([["N", "N", "Y"][i % 3]
                                     for i in range(n_promo)]),
        # Staggered so (dmail OR email OR tv) is DISCRIMINATING: promos
        # with i % 4 == 2 match no channel, keeping q61's promotions sum
        # strictly below its total.
        "p_channel_dmail": np.array([["Y", "N", "N", "N"][i % 4]
                                     for i in range(n_promo)]),
        "p_channel_tv": np.array([["N", "N", "N", "Y"][i % 4]
                                  for i in range(n_promo)]),
    }

    # Demographic / address / time dimensions (fixed-size, like TPC-DS).
    n_demo = 1000  # ss_cdemo_sk / ss_hdemo_sk domain
    _GENDERS = ["M", "F"]
    _MARITAL = ["M", "S", "D", "W", "U"]
    _EDU = ["Primary", "Secondary", "College", "2 yr Degree",
            "4 yr Degree", "Advanced Degree", "Unknown"]
    tables["customer_demographics"] = {
        "cd_demo_sk": np.arange(1, n_demo + 1, dtype=np.int64),
        "cd_gender": np.array([_GENDERS[i % 2] for i in range(n_demo)]),
        "cd_marital_status": np.array([_MARITAL[(i // 2) % 5]
                                       for i in range(n_demo)]),
        "cd_education_status": np.array([_EDU[(i // 10) % 7]
                                         for i in range(n_demo)]),
        "cd_dep_count": (np.arange(n_demo) % 7).astype(np.int64),
        "cd_dep_employed_count": ((np.arange(n_demo) // 7) % 5
                                  ).astype(np.int64),
        "cd_dep_college_count": ((np.arange(n_demo) // 35) % 4
                                 ).astype(np.int64),
        "cd_purchase_estimate": (500 * (1 + np.arange(n_demo) % 20)
                                 ).astype(np.int64),
        "cd_credit_rating": np.array([["Low Risk", "Good", "Unknown",
                                       "High Risk"][i % 4]
                                      for i in range(n_demo)]),
    }
    tables["household_demographics"] = {
        "hd_demo_sk": np.arange(1, n_demo + 1, dtype=np.int64),
        "hd_dep_count": (np.arange(n_demo) % 10).astype(np.int64),
        "hd_vehicle_count": (np.arange(n_demo) % 6 - 1).astype(np.int64),
        # (i // 6) decouples from hd_vehicle_count's i % 6 cycle — the
        # q34/q73 filter ANDs buy_potential with vehicle_count > 0.
        "hd_income_band_sk": (1 + np.arange(n_demo) % 20).astype(np.int64),
        "hd_buy_potential": np.array([
            [">10000", "unknown", "1001-5000", "5001-10000", "501-1000",
             "0-500"][(i // 6) % 6] for i in range(n_demo)]),
    }
    tables["income_band"] = {
        "ib_income_band_sk": np.arange(1, 21, dtype=np.int64),
        "ib_lower_bound": (np.arange(20) * 10000).astype(np.int64),
        "ib_upper_bound": ((np.arange(20) + 1) * 10000 - 1).astype(np.int64),
    }
    _REASONS = ["reason 1", "reason 28", "Did not like the warranty",
                "Not the product that was ordred", "reason 55"]
    tables["reason"] = {
        "r_reason_sk": np.arange(1, len(_REASONS) + 1, dtype=np.int64),
        "r_reason_desc": np.array(_REASONS),
    }
    _CITIES = ["%s_%02d" % (base, i) for base in
               ("Springfield", "Greenville", "Franklin", "Clinton")
               for i in range(15)]
    _STATES = ["TX", "OH", "KY", "GA", "NM", "VA", "MO", "ND", "IN", "SC"]
    tables["customer_address"] = {
        "ca_address_sk": np.arange(1, n_addr + 1, dtype=np.int64),
        "ca_street_number": np.array(["%d" % (100 + 3 * i)
                                      for i in range(n_addr)]),
        "ca_street_name": np.array([["Main", "Oak", "Park", "First",
                                     "Elm", "Lake"][i % 6]
                                    for i in range(n_addr)]),
        "ca_city": np.array([_CITIES[i % len(_CITIES)]
                             for i in range(n_addr)]),
        "ca_zip": np.array(["%05d" % (10000 + 37 * i % 90000)
                            for i in range(n_addr)]),
        "ca_state": np.array([_STATES[i % len(_STATES)]
                              for i in range(n_addr)]),
        "ca_county": np.array([["Williamson County", "Ziebach County",
                                "Walker County", "Daviess County"][i % 4]
                               for i in range(n_addr)]),
        "ca_country": np.array(["United States"] * n_addr),
        "ca_gmt_offset": np.full(n_addr, -5.0),
        "ca_location_type": np.array([["apartment", "condo",
                                       "single family"][i % 3]
                                      for i in range(n_addr)]),
    }
    # Seconds 08:00:00 .. 20:59:59 (the selling day q96 probes).
    t_sk = np.arange(8 * 3600, 21 * 3600, dtype=np.int64)
    tables["time_dim"] = {
        "t_time_sk": t_sk,
        "t_hour": (t_sk // 3600).astype(np.int64),
        "t_minute": ((t_sk % 3600) // 60).astype(np.int64),
    }

    # -- store_sales ------------------------------------------------------
    # Sales concentrate in 1999-2001 (day 366..1460) so the year-filtered
    # queries (q17 2000Q1, q25 Apr-Oct 2000, q64 2000 vs 2001) see dense
    # data at every scale; date_dim itself still spans the full range.
    lo_day, hi_day = 366, min(1460, n_dates)
    # Rows group into multi-line TICKETS (one store visit: ticket-level
    # date/customer/store/demo/address shared by its rows, ~12 lines
    # Poisson-distributed) — the official layout the ticket-size band
    # queries (q34 counts 15-20, q73 counts 1-5) and per-ticket grouping
    # queries (q46/q68/q79) measure.
    n_ticket = max(n_ss // 12, 1)
    # Bimodal basket sizes: ~30% quick visits (1-5 lines), the rest full
    # carts (8-23) — both ticket-size bands (q73's 1-5, q34's 15-20)
    # carry mass at every scale. n_ss becomes the realized row total.
    sizes = np.where(rng.random(n_ticket) < 0.3,
                     rng.integers(1, 6, n_ticket),
                     rng.integers(8, 24, n_ticket))
    tick = np.repeat(np.arange(n_ticket, dtype=np.int64), sizes)
    n_ss = len(tick)
    t_date = rng.integers(lo_day, hi_day + 1, n_ticket).astype(np.int64)
    t_cust = rng.integers(1, n_cust + 1, n_ticket).astype(np.int64)
    t_store = rng.integers(1, n_store + 1, n_ticket).astype(np.int64)
    t_cdemo = rng.integers(1, n_demo + 1, n_ticket).astype(np.int64)
    t_hdemo = rng.integers(1, n_demo + 1, n_ticket).astype(np.int64)
    t_addr = rng.integers(1, n_addr + 1, n_ticket).astype(np.int64)
    ss_sold_date = t_date[tick]
    # Items WITHOUT replacement within a ticket ((item, ticket) is the
    # official PK the ss-sr identity joins key on): random per-ticket
    # base + within-ticket position, distinct for any basket <= n_item.
    starts_of = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos = np.arange(n_ss, dtype=np.int64) - np.repeat(starts_of, sizes)
    t_base = rng.integers(0, n_item, n_ticket).astype(np.int64)
    ss_item = 1 + (t_base[tick] + pos) % n_item
    ss_cust = t_cust[tick]
    ss_store = t_store[tick]
    ss_ticket = tick + 1
    ss_qty = rng.integers(1, 100, n_ss).astype(np.int64)
    ss_price = np.round(rng.uniform(1.0, 300.0, n_ss), 2)
    # ~2% of store rows carry a NULL store key (official store_sales has
    # nullable dimension FKs; the null-key report q76 depends on them).
    ss_store_null = rng2.random(n_ss) < 0.02
    tables["store_sales"] = {
        "ss_sold_date_sk": ss_sold_date,
        "ss_sold_time_sk": rng.integers(8 * 3600, 21 * 3600,
                                        n_ss).astype(np.int64),
        "ss_item_sk": ss_item,
        "ss_customer_sk": ss_cust,
        "ss_cdemo_sk": t_cdemo[tick],
        "ss_hdemo_sk": t_hdemo[tick],
        "ss_addr_sk": t_addr[tick],
        "ss_store_sk": pa.array(ss_store, mask=ss_store_null),
        "ss_promo_sk": rng.integers(1, n_promo + 1, n_ss).astype(np.int64),
        "ss_ticket_number": ss_ticket,
        "ss_quantity": ss_qty,
        "ss_wholesale_cost": np.round(ss_price * 0.6, 2),
        "ss_ext_wholesale_cost": np.round(ss_price * 0.6 * ss_qty, 2),
        "ss_list_price": np.round(ss_price * 1.2, 2),
        "ss_sales_price": ss_price,
        "ss_ext_sales_price": np.round(ss_price * ss_qty, 2),
        "ss_ext_list_price": np.round(ss_price * 1.2 * ss_qty, 2),
        "ss_ext_tax": np.round(ss_price * ss_qty * 0.08, 2),
        "ss_coupon_amt": np.round(
            np.where(rng.random(n_ss) < 0.3,
                     rng.uniform(0.0, 20.0, n_ss), 0.0), 2),
        # q24/q49/q78: what the customer actually paid.
        "ss_net_paid": np.round(ss_price * ss_qty * 0.97, 2),
        "ss_net_profit": np.round(ss_price * ss_qty * 0.1
                                  - rng.uniform(0, 50, n_ss), 2),
    }

    # -- store_returns: ~30% of sales return, tied to a real sale --------
    n_sr = n_ss * 3 // 10
    ret_pick = rng.choice(n_ss, n_sr, replace=False)
    ret_lag = rng.integers(1, 90, n_sr)
    sr_ret_qty = np.maximum(
        ss_qty[ret_pick] - rng.integers(0, 50, n_sr), 1).astype(np.int64)
    tables["store_returns"] = {
        "sr_returned_date_sk": np.minimum(ss_sold_date[ret_pick] + ret_lag,
                                          n_dates).astype(np.int64),
        "sr_item_sk": ss_item[ret_pick],
        "sr_customer_sk": ss_cust[ret_pick],
        "sr_cdemo_sk": rng.integers(1, n_demo + 1, n_sr).astype(np.int64),
        "sr_store_sk": ss_store[ret_pick],
        "sr_reason_sk": (1 + rng.integers(0, 5, n_sr)).astype(np.int64),
        "sr_ticket_number": ss_ticket[ret_pick],
        "sr_return_quantity": sr_ret_qty,
        "sr_return_amt": np.round(ss_price[ret_pick] * sr_ret_qty, 2),
        "sr_net_loss": np.round(rng.uniform(1.0, 200.0, n_sr), 2),
    }

    # -- catalog_sales: some to the same (customer, item) pairs ----------
    n_cs = n_ss * 6 // 10
    cs_follow = rng.random(n_cs) < 0.5  # half follow a store sale
    follow_pick = rng.choice(n_ss, n_cs, replace=True)
    cs_item = np.where(cs_follow, ss_item[follow_pick],
                       rng.integers(1, n_item + 1, n_cs)).astype(np.int64)
    cs_cust = np.where(cs_follow, ss_cust[follow_pick],
                       rng.integers(1, n_cust + 1, n_cs)).astype(np.int64)
    cs_date = np.minimum(
        np.where(cs_follow, ss_sold_date[follow_pick]
                 + rng.integers(1, 120, n_cs),
                 rng.integers(lo_day, hi_day + 1, n_cs)),
        n_dates).astype(np.int64)
    cs_qty = rng.integers(1, 100, n_cs).astype(np.int64)
    cs_order = np.arange(1, n_cs + 1, dtype=np.int64)
    cs_price = np.round(rng.uniform(1.0, 300.0, n_cs), 2)
    cs_page = rng2.integers(1, 101, n_cs).astype(np.int64)
    tables["catalog_sales"] = {
        "cs_sold_date_sk": cs_date,
        "cs_sold_time_sk": rng.integers(8 * 3600, 21 * 3600,
                                        n_cs).astype(np.int64),
        "cs_bill_customer_sk": cs_cust,
        "cs_bill_cdemo_sk": rng.integers(1, n_demo + 1,
                                         n_cs).astype(np.int64),
        "cs_bill_addr_sk": rng.integers(1, n_addr + 1,
                                        n_cs).astype(np.int64),
        "cs_ship_addr_sk": pa.array(
            rng.integers(1, n_addr + 1, n_cs).astype(np.int64),
            mask=rng2.random(n_cs) < 0.02),
        "cs_ship_date_sk": np.minimum(cs_date + rng.integers(1, 120, n_cs),
                                      n_dates).astype(np.int64),
        "cs_warehouse_sk": rng.integers(1, 6, n_cs).astype(np.int64),
        "cs_ship_mode_sk": rng.integers(1, 21, n_cs).astype(np.int64),
        "cs_call_center_sk": rng.integers(1, 5, n_cs).astype(np.int64),
        "cs_catalog_page_sk": cs_page,
        "cs_item_sk": cs_item,
        "cs_promo_sk": rng.integers(1, n_promo + 1, n_cs).astype(np.int64),
        "cs_order_number": cs_order,
        "cs_quantity": cs_qty,
        "cs_list_price": np.round(cs_price * 1.2, 2),
        "cs_sales_price": cs_price,
        "cs_ext_sales_price": np.round(cs_price * cs_qty, 2),
        "cs_ext_discount_amt": np.round(
            np.where(rng.random(n_cs) < 0.4,
                     rng.uniform(0.0, 60.0, n_cs), 5.0), 2),
        "cs_coupon_amt": np.round(
            np.where(rng.random(n_cs) < 0.3,
                     rng.uniform(0.0, 20.0, n_cs), 0.0), 2),
        "cs_ext_list_price": np.round(rng.uniform(5.0, 500.0, n_cs), 2),
        # q16 (shipping-cost report) and q49/q75/q78 (net paid).
        "cs_ext_ship_cost": np.round(rng2.uniform(0.5, 30.0, n_cs), 2),
        "cs_net_paid": np.round(cs_price * cs_qty * 0.95, 2),
        "cs_net_profit": np.round(rng.uniform(-50.0, 300.0, n_cs), 2),
    }

    # -- catalog_returns: ~20% of catalog sales --------------------------
    n_cr = n_cs * 2 // 10
    cr_pick = rng.choice(n_cs, n_cr, replace=False)
    tables["catalog_returns"] = {
        "cr_item_sk": cs_item[cr_pick],
        "cr_order_number": cs_order[cr_pick],
        "cr_returning_customer_sk": cs_cust[cr_pick],
        "cr_returned_date_sk": np.minimum(
            cs_date[cr_pick] + rng.integers(1, 90, n_cr),
            n_dates).astype(np.int64),
        "cr_return_amt_inc_tax": np.round(rng.uniform(1.0, 300.0, n_cr), 2),
        "cr_refunded_cash": np.round(rng.uniform(1.0, 150.0, n_cr), 2),
        "cr_reversed_charge": np.round(rng.uniform(0.0, 40.0, n_cr), 2),
        "cr_store_credit": np.round(rng.uniform(0.0, 40.0, n_cr), 2),
        # q5/q49/q77/q80/q83/q91 (returns reports over the catalog channel).
        "cr_return_amount": np.round(rng2.uniform(1.0, 250.0, n_cr), 2),
        "cr_net_loss": np.round(rng2.uniform(0.5, 80.0, n_cr), 2),
        "cr_return_quantity": rng2.integers(1, 10, n_cr).astype(np.int64),
        "cr_call_center_sk": rng2.integers(1, 5, n_cr).astype(np.int64),
        "cr_reason_sk": rng2.integers(1, 6, n_cr).astype(np.int64),
        "cr_catalog_page_sk": cs_page[cr_pick],
    }

    # -- web channel (round-5 breadth: the 3-channel query families) -----
    n_wh = 5
    tables["warehouse"] = {
        "w_warehouse_sk": np.arange(1, n_wh + 1, dtype=np.int64),
        "w_warehouse_name": np.array(["Warehouse %d" % i
                                      for i in range(n_wh)]),
        "w_warehouse_sq_ft": (50_000 + 25_000 * np.arange(n_wh)
                              ).astype(np.int64),
        "w_city": np.array([["Midway", "Fairview"][i % 2]
                            for i in range(n_wh)]),
        "w_county": np.array([["Williamson County", "Ziebach County"][i % 2]
                              for i in range(n_wh)]),
        "w_state": np.array([["TN", "CA", "WA"][i % 3] for i in range(n_wh)]),
        "w_country": np.array(["United States"] * n_wh),
    }
    n_sm = 20
    tables["ship_mode"] = {
        "sm_ship_mode_sk": np.arange(1, n_sm + 1, dtype=np.int64),
        "sm_type": np.array([["EXPRESS", "NEXT DAY", "OVERNIGHT",
                              "REGULAR", "TWO DAY"][i % 5]
                             for i in range(n_sm)]),
        "sm_code": np.array([["AIR", "SURFACE", "SEA"][i % 3]
                             for i in range(n_sm)]),
        "sm_carrier": np.array([["UPS", "FEDEX", "AIRBORNE", "USPS"][i % 4]
                                for i in range(n_sm)]),
    }
    n_web = 4
    tables["web_site"] = {
        "web_site_sk": np.arange(1, n_web + 1, dtype=np.int64),
        "web_site_id": np.array(["WEB%04d" % i for i in range(n_web)]),
        "web_name": np.array(["site_%d" % i for i in range(n_web)]),
        "web_company_name": np.array([["pri", "ought"][i % 2]
                                      for i in range(n_web)]),
    }
    n_wp = 10
    tables["web_page"] = {
        "wp_web_page_sk": np.arange(1, n_wp + 1, dtype=np.int64),
        "wp_char_count": (4000 + 150 * np.arange(n_wp)).astype(np.int64),
    }
    n_cc = 4
    tables["call_center"] = {
        "cc_call_center_sk": np.arange(1, n_cc + 1, dtype=np.int64),
        "cc_call_center_id": np.array(["CC%04d" % i for i in range(n_cc)]),
        "cc_name": np.array(["center_%d" % i for i in range(n_cc)]),
        "cc_county": np.array([["Williamson County",
                                "Ziebach County"][i % 2]
                               for i in range(n_cc)]),
        "cc_manager": np.array(["mgr_%d" % i for i in range(n_cc)]),
    }
    n_cp = 100
    tables["catalog_page"] = {
        "cp_catalog_page_sk": np.arange(1, n_cp + 1, dtype=np.int64),
        "cp_catalog_page_id": np.array(["CP%08d" % i for i in range(n_cp)]),
    }

    # -- web_sales: ~40% of store volume; half follow a store sale so
    # cross-channel customer/item overlap exists (q38/q87 INTERSECT/
    # EXCEPT, q11/q74 year-total ratios key on it) ----------------------
    n_ws = n_ss * 4 // 10
    ws_follow = rng.random(n_ws) < 0.5
    wf_pick = rng.choice(n_ss, n_ws, replace=True)
    ws_item = np.where(ws_follow, ss_item[wf_pick],
                       rng.integers(1, n_item + 1, n_ws)).astype(np.int64)
    ws_cust = np.where(ws_follow, ss_cust[wf_pick],
                       rng.integers(1, n_cust + 1, n_ws)).astype(np.int64)
    ws_date = np.minimum(
        np.where(ws_follow, ss_sold_date[wf_pick]
                 + rng.integers(0, 60, n_ws),
                 rng.integers(lo_day, hi_day + 1, n_ws)),
        n_dates).astype(np.int64)
    ws_qty = rng.integers(1, 100, n_ws).astype(np.int64)
    # Multi-line orders (~3 lines each): per-line warehouses can then
    # differ within one order (q94/q95 probe exactly that).
    ws_order = (np.arange(n_ws, dtype=np.int64) // 3) + 1
    ws_price = np.round(rng.uniform(1.0, 300.0, n_ws), 2)
    tables["web_sales"] = {
        "ws_sold_date_sk": ws_date,
        "ws_sold_time_sk": rng.integers(8 * 3600, 21 * 3600,
                                        n_ws).astype(np.int64),
        "ws_ship_date_sk": np.minimum(ws_date + rng.integers(1, 120, n_ws),
                                      n_dates).astype(np.int64),
        "ws_item_sk": ws_item,
        "ws_bill_customer_sk": ws_cust,
        "ws_bill_addr_sk": rng.integers(1, n_addr + 1,
                                        n_ws).astype(np.int64),
        "ws_ship_customer_sk": pa.array(
            rng.integers(1, n_cust + 1, n_ws).astype(np.int64),
            mask=rng2.random(n_ws) < 0.02),
        "ws_ship_hdemo_sk": rng.integers(1, n_demo + 1,
                                         n_ws).astype(np.int64),
        "ws_ship_addr_sk": rng.integers(1, n_addr + 1,
                                        n_ws).astype(np.int64),
        "ws_web_page_sk": rng.integers(1, n_wp + 1, n_ws).astype(np.int64),
        "ws_web_site_sk": rng.integers(1, n_web + 1, n_ws).astype(np.int64),
        "ws_ship_mode_sk": rng.integers(1, n_sm + 1, n_ws).astype(np.int64),
        "ws_warehouse_sk": rng.integers(1, n_wh + 1, n_ws).astype(np.int64),
        "ws_promo_sk": rng.integers(1, n_promo + 1, n_ws).astype(np.int64),
        "ws_order_number": ws_order,
        "ws_quantity": ws_qty,
        "ws_wholesale_cost": np.round(ws_price * 0.6, 2),
        "ws_list_price": np.round(ws_price * 1.2, 2),
        "ws_sales_price": ws_price,
        "ws_ext_sales_price": np.round(ws_price * ws_qty, 2),
        "ws_ext_list_price": np.round(ws_price * 1.2 * ws_qty, 2),
        "ws_ext_wholesale_cost": np.round(ws_price * 0.6 * ws_qty, 2),
        "ws_ext_discount_amt": np.round(
            np.where(rng.random(n_ws) < 0.4,
                     rng.uniform(0.0, 60.0, n_ws), 5.0), 2),
        "ws_ext_ship_cost": np.round(rng.uniform(0.5, 30.0, n_ws), 2),
        "ws_net_paid": np.round(ws_price * ws_qty * 0.95, 2),
        "ws_net_profit": np.round(ws_price * ws_qty * 0.1
                                  - rng.uniform(0, 50, n_ws), 2),
    }

    # -- web_returns: ~15% of web sales ----------------------------------
    n_wr = n_ws * 15 // 100
    wr_pick = rng.choice(n_ws, max(n_wr, 1), replace=False)
    n_wr = len(wr_pick)
    wr_qty = np.maximum(ws_qty[wr_pick] - rng.integers(0, 50, n_wr),
                        1).astype(np.int64)
    tables["web_returns"] = {
        "wr_returned_date_sk": np.minimum(
            ws_date[wr_pick] + rng.integers(1, 90, n_wr),
            n_dates).astype(np.int64),
        "wr_item_sk": ws_item[wr_pick],
        "wr_order_number": ws_order[wr_pick],
        "wr_returning_customer_sk": ws_cust[wr_pick],
        "wr_refunded_customer_sk": ws_cust[wr_pick],
        "wr_refunded_addr_sk": rng.integers(1, n_addr + 1,
                                            n_wr).astype(np.int64),
        "wr_returning_cdemo_sk": rng.integers(1, n_demo + 1,
                                              n_wr).astype(np.int64),
        "wr_refunded_cdemo_sk": rng.integers(1, n_demo + 1,
                                             n_wr).astype(np.int64),
        "wr_web_page_sk": rng.integers(1, n_wp + 1, n_wr).astype(np.int64),
        "wr_reason_sk": (1 + rng.integers(0, 5, n_wr)).astype(np.int64),
        "wr_return_quantity": wr_qty,
        "wr_return_amt": np.round(ws_price[wr_pick] * wr_qty, 2),
        "wr_fee": np.round(rng.uniform(0.5, 100.0, n_wr), 2),
        "wr_refunded_cash": np.round(rng.uniform(1.0, 150.0, n_wr), 2),
        "wr_net_loss": np.round(rng.uniform(1.0, 200.0, n_wr), 2),
    }
    # Returner == buyer for ~60% of returns (same demographics row) — the
    # correlation the paired-demographics probes (q85) measure. Post-hoc
    # fixup on rng2 so the main stream's draw sequence is untouched.
    _wr = tables["web_returns"]
    _wr["wr_returning_cdemo_sk"] = np.where(
        rng2.random(n_wr) < 0.6, _wr["wr_refunded_cdemo_sk"],
        _wr["wr_returning_cdemo_sk"]).astype(np.int64)

    # -- inventory: weekly on-hand snapshots over the dense sales window.
    # Size is items x weeks x warehouses (does NOT scale with `scale`
    # past the item cap — real TPC-DS inventory is similarly
    # item-bounded).
    inv_weeks = np.arange(lo_day, hi_day + 1, 7, dtype=np.int64)
    n_inv_items = min(n_item, 4000)
    inv_items = np.arange(1, n_inv_items + 1, dtype=np.int64)
    inv_wh = np.arange(1, n_wh + 1, dtype=np.int64)
    grid_d, grid_i, grid_w = np.meshgrid(inv_weeks, inv_items, inv_wh,
                                         indexing="ij")
    n_inv = grid_d.size
    tables["inventory"] = {
        "inv_date_sk": grid_d.reshape(-1),
        "inv_item_sk": grid_i.reshape(-1),
        "inv_warehouse_sk": grid_w.reshape(-1),
        "inv_quantity_on_hand": rng.integers(0, 1000,
                                             n_inv).astype(np.int64),
    }

    paths: Dict[str, str] = {}
    for name, cols in tables.items():
        path = os.path.join(out_dir, name)
        paths[name] = path
        if os.path.isdir(path) and os.listdir(path):
            continue  # already generated (deterministic)
        os.makedirs(path, exist_ok=True)
        pq.write_table(pa.table(cols), os.path.join(path, "part-0.parquet"))
    return paths
