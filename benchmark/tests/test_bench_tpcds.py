"""The `tpcds-sf1` configuration's lake: the specification's SF1 row counts
at the configured scale (computed, not written), every foreign key in
its domain, returns of real sales, and a result for every query of the
mix, on tiny lakes of two seeds."""

import numpy as np
import pandas as pd
import pytest

from benchmark import harness, spec
from benchmark.data import tpcds
from benchmark.reference import tpcds as reference
from benchmark.tests.cells import ROOT, SEED, tiny_cell

CELL = "tpcds-sf1.indexed-streams"

# The TPC-DS specification's rows at scale factor 1.
SPEC_SF1 = {
    "store_sales": 2_880_404, "store_returns": 287_514,
    "catalog_sales": 1_441_548, "catalog_returns": 144_067,
    "web_sales": 719_384, "web_returns": 71_763, "inventory": 11_745_000,
    "date_dim": 73_049, "time_dim": 86_400, "item": 18_000,
    "customer": 100_000, "customer_address": 50_000,
    "customer_demographics": 1_920_800, "household_demographics": 7_200,
    "promotion": 300, "store": 12, "reason": 35, "income_band": 20,
    "ship_mode": 20, "warehouse": 5, "web_site": 30, "web_page": 60,
    "call_center": 6, "catalog_page": 11_718,
}

# Referenced table of a foreign key, by the key column's ending. Every
# `*_sk` column other than its table's first (the surrogate key) is one.
REFERENCES = (
    ("date_sk", "date_dim"), ("time_sk", "time_dim"), ("item_sk", "item"),
    ("customer_sk", "customer"), ("cdemo_sk", "customer_demographics"),
    ("hdemo_sk", "household_demographics"), ("addr_sk", "customer_address"),
    ("store_sk", "store"), ("promo_sk", "promotion"), ("reason_sk", "reason"),
    ("income_band_sk", "income_band"), ("ship_mode_sk", "ship_mode"),
    ("warehouse_sk", "warehouse"), ("web_site_sk", "web_site"),
    ("web_page_sk", "web_page"), ("call_center_sk", "call_center"),
    ("catalog_page_sk", "catalog_page"),
)


def test_the_configured_scale_writes_the_sf1_rows():
    config = spec.find_cell(ROOT, CELL).config
    assert config["rows"] == SPEC_SF1
    assert tpcds.row_counts(config["generator_scale"]) == SPEC_SF1
    assert set(tpcds.TABLES) == set(SPEC_SF1)


@pytest.fixture(scope="module", params=[SEED, 2 ** 40 + 3])
def lake(request, tmp_path_factory):
    scale = tiny_cell(CELL).config["generator_scale"]
    root = tmp_path_factory.mktemp("tpcds") / "lake"
    paths = tpcds.generate(str(root), scale=scale,
                           seed=harness.data_seed(request.param))
    return harness.lake_tables(paths), scale


def test_the_tiny_lake_has_its_rows_and_every_column(lake):
    tables, scale = lake
    rows = tpcds.row_counts(scale)
    assert {t: len(df) for t, df in tables.items()} == rows
    assert len(tables["store_sales"].columns) == 23
    assert len(tables["catalog_sales"].columns) == 34
    assert len(tables["date_dim"].columns) == 28


def _foreign_keys(tables):
    for table, df in tables.items():
        for c in df.columns[1:]:
            if not c.endswith("_sk"):
                continue
            target = next((t for end, t in REFERENCES if c.endswith(end)),
                          None)
            assert target is not None, f"{table}.{c} references nothing"
            yield table, c, target


def test_every_foreign_key_lies_in_its_domain(lake):
    tables, _ = lake
    checked = 0
    for table, c, target in _foreign_keys(tables):
        values = tables[table][c].dropna()
        domain = tables[target].iloc[:, 0]
        assert values.isin(domain).all(), f"{table}.{c} -> {target}"
        checked += 1
    assert checked >= 95
    assert tables["date_dim"].d_date_sk.iloc[0] == 2_415_022
    sold = tables["store_sales"].ss_sold_date_sk
    assert sold.min() >= tpcds.jd(tpcds._SALES_FIRST)
    assert sold.max() <= tpcds.jd(tpcds._SALES_LAST)


@pytest.mark.parametrize("sales,returns,keys,qty,dates", [
    ("store_sales", "store_returns",
     [("ss_ticket_number", "sr_ticket_number"), ("ss_item_sk", "sr_item_sk"),
      ("ss_customer_sk", "sr_customer_sk")],
     ("ss_quantity", "sr_return_quantity"),
     ("ss_sold_date_sk", "sr_returned_date_sk")),
    ("catalog_sales", "catalog_returns",
     [("cs_order_number", "cr_order_number"), ("cs_item_sk", "cr_item_sk"),
      ("cs_bill_customer_sk", "cr_returning_customer_sk")],
     ("cs_quantity", "cr_return_quantity"),
     ("cs_sold_date_sk", "cr_returned_date_sk")),
    ("web_sales", "web_returns",
     [("ws_order_number", "wr_order_number"), ("ws_item_sk", "wr_item_sk"),
      ("ws_bill_customer_sk", "wr_returning_customer_sk")],
     ("ws_quantity", "wr_return_quantity"),
     ("ws_sold_date_sk", "wr_returned_date_sk")),
])
def test_returns_are_of_real_sales(lake, sales, returns, keys, qty, dates):
    """Each return matches exactly one sale on the (ticket or order, item,
    customer) identity, after the sale, of at most the sold quantity;
    (ticket or order, item) is a key of the sales."""
    tables, _ = lake
    s, r = tables[sales], tables[returns]
    s_keys, r_keys = [a for a, _ in keys], [b for _, b in keys]
    assert not s.duplicated(s_keys[:2]).any()
    j = r.merge(s, left_on=r_keys, right_on=s_keys, how="left",
                indicator=True)
    assert len(j) == len(r) and (j["_merge"] == "both").all()
    assert (j[qty[1]] <= j[qty[0]]).all() and (j[qty[1]] >= 1).all()
    assert (j[dates[1]] > j[dates[0]]).all()
    share = len(r) / len(s)
    assert 0.09 < share < 0.11


def test_every_query_of_the_mix_has_a_result(lake):
    tables, _ = lake
    queries = spec.find_cell(ROOT, CELL).traffic["queries"]
    assert sorted(queries) == sorted(reference.ORACLES)
    empty = [q for q in queries
             if len(pd.DataFrame(reference.ORACLES[q](tables))) == 0]
    assert not empty


def test_a_seed_gives_the_same_lake(tmp_path):
    a = tpcds.generate(str(tmp_path / "a"), scale=0.01, seed=5)
    b = tpcds.generate(str(tmp_path / "b"), scale=0.01, seed=5)
    c = tpcds.generate(str(tmp_path / "c"), scale=0.01, seed=6)
    ta, tb, tc = (harness.lake_tables(p) for p in (a, b, c))
    for t in ("store_sales", "customer", "item", "store_returns"):
        pd.testing.assert_frame_equal(ta[t], tb[t])
    assert not np.array_equal(ta["store_sales"].ss_item_sk.to_numpy(),
                              tc["store_sales"].ss_item_sk.to_numpy())
