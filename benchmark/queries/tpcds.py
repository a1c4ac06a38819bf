"""Frozen copy of 22 TPC-DS query builders (on the port's DataFrame API)
and 7 index definitions of `hyperspace_tpu_torch/tpcds/queries.py` (q29:
`queries_ext.py`) at commit 976226b: the queries whose plans read a
covering index, and the indexes they read.

Split mechanically from the source modules, function bodies unchanged;
the benchmark's yardstick, not to be edited with the port.

Filter constants that differ from the official text, kept as they are
(the generator, `benchmark/data/tpcds.py`, writes values they match):

- q53, q63, q89 name brands `brand_01` .. `brand_08` where the official
  text names syllable brands: the generator's `i_brand` is `brand_NN`.
- q17, q25 probe 2000 and q19, q55 probe 1999 where the official text
  probes 2001, 2001, 1998 and 2001: all lie in the five sales years.
- q64 probes the colours plum, puff, misty and prices 25 to 60, q65 and
  q67 the year 2000 for the official month window, q98 May 2000 for the
  official 30-day range: each matches rows of the SF1 lake.
"""

from __future__ import annotations

from typing import Dict

from hyperspace_tpu_torch.plan.expr import col, lit


def q17(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_store_sk",
        "ss_ticket_number", "ss_quantity")
    sr = dfs["store_returns"].select(
        "sr_returned_date_sk", "sr_item_sk", "sr_customer_sk",
        "sr_ticket_number", "sr_return_quantity")
    cs = dfs["catalog_sales"].select(
        "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk",
        "cs_quantity")
    d1 = (dfs["date_dim"].filter(col("d_quarter_name") == lit("2000Q1"))
          .select("d_date_sk"))
    d23q = col("d_quarter_name").isin("2000Q1", "2000Q2", "2000Q3")
    d2 = dfs["date_dim"].filter(d23q).select("d_date_sk")
    d3 = dfs["date_dim"].filter(d23q).select("d_date_sk")
    store = dfs["store"].select("s_store_sk", "s_state")
    item = dfs["item"].select("i_item_sk", "i_item_id", "i_item_desc")

    j = ss.join(sr, on=(col("ss_customer_sk") == col("sr_customer_sk"))
                & (col("ss_item_sk") == col("sr_item_sk"))
                & (col("ss_ticket_number") == col("sr_ticket_number")))
    j = j.join(cs, on=(col("sr_customer_sk") == col("cs_bill_customer_sk"))
               & (col("sr_item_sk") == col("cs_item_sk")))
    j = j.join(d1, on=col("ss_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_quantity", "sr_returned_date_sk",
        "sr_return_quantity", "cs_sold_date_sk", "cs_quantity")
    j = j.join(d2, on=col("sr_returned_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_quantity", "sr_return_quantity",
        "cs_sold_date_sk", "cs_quantity")
    j = j.join(d3, on=col("cs_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_quantity", "sr_return_quantity",
        "cs_quantity")
    j = j.join(store, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(item, on=col("ss_item_sk") == col("i_item_sk"))
    out = (j.group_by("i_item_id", "i_item_desc", "s_state").agg(
        ("count", "ss_quantity", "store_sales_quantitycount"),
        ("avg", "ss_quantity", "store_sales_quantityave"),
        ("stddev", "ss_quantity", "store_sales_quantitystdev"),
        ("count", "sr_return_quantity", "store_returns_quantitycount"),
        ("avg", "sr_return_quantity", "store_returns_quantityave"),
        ("stddev", "sr_return_quantity", "store_returns_quantitystdev"),
        ("count", "cs_quantity", "catalog_sales_quantitycount"),
        ("avg", "cs_quantity", "catalog_sales_quantityave"),
        ("stddev", "cs_quantity", "catalog_sales_quantitystdev"))
        .sort("i_item_id", "i_item_desc", "s_state").limit(100))
    return out


def q25(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_store_sk",
        "ss_ticket_number", "ss_net_profit")
    sr = dfs["store_returns"].select(
        "sr_returned_date_sk", "sr_item_sk", "sr_customer_sk",
        "sr_ticket_number", "sr_net_loss")
    cs = dfs["catalog_sales"].select(
        "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk",
        "cs_net_profit")
    d1 = (dfs["date_dim"]
          .filter((col("d_moy") == lit(4)) & (col("d_year") == lit(2000)))
          .select("d_date_sk"))
    d23f = ((col("d_moy") >= lit(4)) & (col("d_moy") <= lit(10))
            & (col("d_year") == lit(2000)))
    d2 = dfs["date_dim"].filter(d23f).select("d_date_sk")
    d3 = dfs["date_dim"].filter(d23f).select("d_date_sk")
    store = dfs["store"].select("s_store_sk", "s_store_id", "s_store_name")
    item = dfs["item"].select("i_item_sk", "i_item_id", "i_item_desc")

    j = ss.join(sr, on=(col("ss_customer_sk") == col("sr_customer_sk"))
                & (col("ss_item_sk") == col("sr_item_sk"))
                & (col("ss_ticket_number") == col("sr_ticket_number")))
    j = j.join(cs, on=(col("sr_customer_sk") == col("cs_bill_customer_sk"))
               & (col("sr_item_sk") == col("cs_item_sk")))
    j = j.join(d1, on=col("ss_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_net_profit", "sr_returned_date_sk",
        "sr_net_loss", "cs_sold_date_sk", "cs_net_profit")
    j = j.join(d2, on=col("sr_returned_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_net_profit", "sr_net_loss",
        "cs_sold_date_sk", "cs_net_profit")
    j = j.join(d3, on=col("cs_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_net_profit", "sr_net_loss",
        "cs_net_profit")
    j = j.join(store, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(item, on=col("ss_item_sk") == col("i_item_sk"))
    out = (j.group_by("i_item_id", "i_item_desc", "s_store_id",
                      "s_store_name").agg(
        ("sum", "ss_net_profit", "store_sales_profit"),
        ("sum", "sr_net_loss", "store_returns_loss"),
        ("sum", "cs_net_profit", "catalog_sales_profit"))
        .sort("i_item_id", "i_item_desc", "s_store_id", "s_store_name")
        .limit(100))
    return out


_Q64_COLORS = ("plum", "puff", "misty")


def _q64_cs_ui(dfs):
    """Catalog sales whose list-price total exceeds 2x the refund total —
    the HAVING subquery of q64 (filter over an aggregate)."""
    cs = dfs["catalog_sales"].select("cs_item_sk", "cs_order_number",
                                     "cs_ext_list_price")
    cr = dfs["catalog_returns"].select(
        "cr_item_sk", "cr_order_number", "cr_refunded_cash",
        "cr_reversed_charge", "cr_store_credit")
    j = cs.join(cr, on=(col("cs_item_sk") == col("cr_item_sk"))
                & (col("cs_order_number") == col("cr_order_number")))
    agg = j.group_by("cs_item_sk").agg(
        ("sum", "cs_ext_list_price", "sale"),
        ("sum", "cr_refunded_cash", "refund_cash"),
        ("sum", "cr_reversed_charge", "refund_charge"),
        ("sum", "cr_store_credit", "refund_credit"))
    having = (col("sale") > ((col("refund_cash") + col("refund_charge")
                              + col("refund_credit")) * lit(2.0)))
    return agg.filter(having).select("cs_item_sk")


def _q64_cross_sales(dfs):
    """FULL-WIDTH cross_sales, built ONCE over both probe years (the
    official WITH-view shape): the 13-way join — ss x sr x cs_ui x
    d1/d2/d3 x store x customer x cd1/cd2 x promotion x hd1/hd2 (with
    income bands) x ad1/ad2 x item — grouped by the official column list
    (syear distinguishes the years; the final query self-joins filtered
    slices, so the heavy chain executes once via common-subplan reuse).
    """
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_store_sk",
        "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_promo_sk",
        "ss_ticket_number", "ss_wholesale_cost", "ss_list_price",
        "ss_coupon_amt")
    sr = dfs["store_returns"].select("sr_item_sk", "sr_ticket_number")
    dy = (dfs["date_dim"].filter(col("d_year").isin(2000, 2001))
          .select("d_date_sk", col("d_year").alias("syear")))
    store = dfs["store"].select("s_store_sk", "s_store_name", "s_zip")
    item = (dfs["item"]
            .filter(col("i_color").isin(*_Q64_COLORS)
                    & (col("i_current_price") >= lit(25.0))
                    & (col("i_current_price") <= lit(60.0)))
            .select("i_item_sk", "i_product_name"))
    customer = dfs["customer"].select(
        "c_customer_sk", "c_current_cdemo_sk", "c_current_hdemo_sk",
        "c_current_addr_sk", "c_first_sales_date_sk",
        "c_first_shipto_date_sk")
    cd = dfs["customer_demographics"].select("cd_demo_sk",
                                             "cd_marital_status")
    hd = dfs["household_demographics"].select("hd_demo_sk",
                                              "hd_income_band_sk")
    ib = dfs["income_band"].select("ib_income_band_sk")
    ad = dfs["customer_address"].select(
        "ca_address_sk", "ca_street_number", "ca_street_name", "ca_city",
        "ca_zip")
    promo = dfs["promotion"].select("p_promo_sk")

    j = ss.join(sr, on=(col("ss_item_sk") == col("sr_item_sk"))
                & (col("ss_ticket_number") == col("sr_ticket_number")))
    j = j.join(_q64_cs_ui(dfs), on=col("ss_item_sk") == col("cs_item_sk"))
    j = j.join(dy, on=col("ss_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_customer_sk", "ss_store_sk", "ss_cdemo_sk",
        "ss_hdemo_sk", "ss_addr_sk", "ss_promo_sk", "ss_wholesale_cost",
        "ss_list_price", "ss_coupon_amt", "syear")
    j = j.join(store, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(customer, on=col("ss_customer_sk") == col("c_customer_sk"))
    # cd1 (sale-time) and cd2 (current) with differing marital status.
    j = j.join(cd, on=col("ss_cdemo_sk") == col("cd_demo_sk"))
    j = j.join(cd, on=col("c_current_cdemo_sk") == col("cd_demo_sk"))
    j = j.filter(col("cd_marital_status") != col("cd_marital_status_r"))
    j = j.join(promo, on=col("ss_promo_sk") == col("p_promo_sk"))
    j = j.join(hd, on=col("ss_hdemo_sk") == col("hd_demo_sk"))
    j = j.join(ib, on=col("hd_income_band_sk") == col("ib_income_band_sk"))
    j = j.join(hd, on=col("c_current_hdemo_sk") == col("hd_demo_sk"))
    j = j.join(ib, on=col("hd_income_band_sk_r")
               == col("ib_income_band_sk"))
    # first-sales / first-shipto years (d2 / d3).
    d2 = dfs["date_dim"].select("d_date_sk",
                                col("d_year").alias("fsyear"))
    d3 = dfs["date_dim"].select("d_date_sk",
                                col("d_year").alias("s2year"))
    j = j.join(d2, on=col("c_first_sales_date_sk") == col("d_date_sk"))
    j = j.join(d3, on=col("c_first_shipto_date_sk") == col("d_date_sk"))
    # bought-at (ad1 -> b_*) and current (ad2 -> c_*) addresses.
    j = j.join(ad, on=col("ss_addr_sk") == col("ca_address_sk"))
    j = j.join(ad, on=col("c_current_addr_sk") == col("ca_address_sk"))
    j = j.join(item, on=col("ss_item_sk") == col("i_item_sk"))
    j = j.select(
        "i_product_name", col("ss_item_sk").alias("item_sk"),
        "s_store_name", "s_zip",
        col("ca_street_number").alias("b_street_number"),
        col("ca_street_name").alias("b_street_name"),
        col("ca_city").alias("b_city"), col("ca_zip").alias("b_zip"),
        col("ca_street_number_r").alias("c_street_number"),
        col("ca_street_name_r").alias("c_street_name"),
        col("ca_city_r").alias("c_city"), col("ca_zip_r").alias("c_zip"),
        "syear", "fsyear", "s2year", "ss_wholesale_cost", "ss_list_price",
        "ss_coupon_amt")
    keys = ["i_product_name", "item_sk", "s_store_name", "s_zip",
            "b_street_number", "b_street_name", "b_city", "b_zip",
            "c_street_number", "c_street_name", "c_city", "c_zip",
            "syear", "fsyear", "s2year"]
    return j.group_by(*keys).agg(
        ("count", "*", "cnt"),
        ("sum", "ss_wholesale_cost", "s1"),
        ("sum", "ss_list_price", "s2"),
        ("sum", "ss_coupon_amt", "s3"))


def q64(dfs: Dict[str, "object"]):
    cross_sales = _q64_cross_sales(dfs)
    cs1 = cross_sales.filter(col("syear") == lit(2000))
    cs2 = cross_sales.filter(col("syear") == lit(2001)).select(
        col("item_sk").alias("item_sk2"),
        col("s_store_name").alias("store_name2"),
        col("s_zip").alias("store_zip2"), col("syear").alias("syear2"),
        col("cnt").alias("cnt2"), col("s1").alias("s1_2"),
        col("s2").alias("s2_2"), col("s3").alias("s3_2"))
    j = cs1.join(cs2, on=(col("item_sk") == col("item_sk2"))
                 & (col("s_store_name") == col("store_name2"))
                 & (col("s_zip") == col("store_zip2")))
    j = j.filter(col("cnt2") <= col("cnt"))
    return (j.select(
        "i_product_name", "item_sk", "s_store_name", "s_zip",
        "b_street_number", "b_street_name", "b_city", "b_zip",
        "c_street_number", "c_street_name", "c_city", "c_zip",
        "syear", "cnt", "s1", "s2", "s3",
        "syear2", "cnt2", "s1_2", "s2_2", "s3_2")
        .sort("i_product_name", "s_store_name", "cnt2", "item_sk",
              "s_zip", "b_street_number", "b_street_name", "b_city",
              "b_zip", "c_street_number", "c_street_name", "c_city",
              "c_zip", "s1", "s2", "s3", "s1_2", "s2_2",
              "s3_2").limit(100))


_STAR_FAMILY = ("q3", "q7", "q13", "q19", "q42", "q43", "q48", "q52",
                "q53", "q55", "q63", "q65", "q67", "q68", "q79", "q89",
                "q98")


def q3(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_item_sk",
                                   "ss_ext_sales_price")
    dt = (dfs["date_dim"].filter(col("d_moy") == lit(11))
          .select("d_date_sk", "d_year"))
    it = (dfs["item"].filter(col("i_manufact_id") == lit(128))
          .select("i_item_sk", "i_brand_id", "i_brand"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.group_by("d_year", "i_brand_id", "i_brand")
            .agg(("sum", "ss_ext_sales_price", "sum_agg"))
            .sort("d_year", "-sum_agg", "i_brand_id").limit(100))


def q42(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_item_sk",
                                   "ss_ext_sales_price")
    dt = (dfs["date_dim"]
          .filter((col("d_moy") == lit(11)) & (col("d_year") == lit(2000)))
          .select("d_date_sk", "d_year"))
    it = (dfs["item"].filter(col("i_manager_id") == lit(1))
          .select("i_item_sk", "i_category_id", "i_category"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.group_by("d_year", "i_category_id", "i_category")
            .agg(("sum", "ss_ext_sales_price", "sum_sales"))
            .sort("-sum_sales", "d_year", "i_category_id", "i_category")
            .limit(100))


def q52(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_item_sk",
                                   "ss_ext_sales_price")
    dt = (dfs["date_dim"]
          .filter((col("d_moy") == lit(11)) & (col("d_year") == lit(2000)))
          .select("d_date_sk", "d_year"))
    it = (dfs["item"].filter(col("i_manager_id") == lit(1))
          .select("i_item_sk", "i_brand_id", "i_brand"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.group_by("d_year", "i_brand_id", "i_brand")
            .agg(("sum", "ss_ext_sales_price", "ext_price"))
            .sort("d_year", "-ext_price", "i_brand_id").limit(100))


def q55(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_item_sk",
                                   "ss_ext_sales_price")
    dt = (dfs["date_dim"]
          .filter((col("d_moy") == lit(11)) & (col("d_year") == lit(1999)))
          .select("d_date_sk"))
    it = (dfs["item"].filter(col("i_manager_id") == lit(28))
          .select("i_item_sk", "i_brand_id", "i_brand"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.group_by("i_brand_id", "i_brand")
            .agg(("sum", "ss_ext_sales_price", "ext_price"))
            .sort("-ext_price", "i_brand_id").limit(100))


def q7(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk", "ss_promo_sk",
        "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk"))
    cd = (dfs["customer_demographics"]
          .filter((col("cd_gender") == lit("M"))
                  & (col("cd_marital_status") == lit("S"))
                  & (col("cd_education_status") == lit("College")))
          .select("cd_demo_sk"))
    promo = (dfs["promotion"]
             .filter((col("p_channel_email") == lit("N"))
                     | (col("p_channel_event") == lit("N")))
             .select("p_promo_sk"))
    it = dfs["item"].select("i_item_sk", "i_item_id")
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(cd, on=col("ss_cdemo_sk") == col("cd_demo_sk"))
    j = j.join(promo, on=col("ss_promo_sk") == col("p_promo_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.group_by("i_item_id")
            .agg(("avg", "ss_quantity", "agg1"),
                 ("avg", "ss_list_price", "agg2"),
                 ("avg", "ss_coupon_amt", "agg3"),
                 ("avg", "ss_sales_price", "agg4"))
            .sort("i_item_id").limit(100))


def q19(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_store_sk",
        "ss_ext_sales_price")
    dt = (dfs["date_dim"]
          .filter((col("d_moy") == lit(11)) & (col("d_year") == lit(1999)))
          .select("d_date_sk"))
    it = (dfs["item"].filter(col("i_manager_id") == lit(8))
          .select("i_item_sk", "i_brand_id", "i_brand", "i_manufact_id",
                  "i_manufact"))
    cust = dfs["customer"].select("c_customer_sk", "c_current_addr_sk")
    ca = dfs["customer_address"].select("ca_address_sk", "ca_zip")
    st = dfs["store"].select("s_store_sk", "s_zip")
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    j = j.join(cust, on=col("ss_customer_sk") == col("c_customer_sk"))
    j = j.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.filter(col("ca_zip").substr(1, 5) != col("s_zip").substr(1, 5))
    return (j.group_by("i_brand_id", "i_brand", "i_manufact_id",
                       "i_manufact")
            .agg(("sum", "ss_ext_sales_price", "ext_price"))
            .sort("-ext_price", "i_brand", "i_brand_id", "i_manufact_id",
                  "i_manufact")
            .limit(100))


def q68(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "ss_hdemo_sk",
        "ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price",
        "ss_ext_list_price", "ss_ext_tax")
    dt = (dfs["date_dim"]
          .filter((col("d_dom") >= lit(1)) & (col("d_dom") <= lit(2))
                  & col("d_year").isin(1999, 2000, 2001))
          .select("d_date_sk"))
    st = (dfs["store"].filter(col("s_city").isin("Midway", "Fairview"))
          .select("s_store_sk"))
    hd = (dfs["household_demographics"]
          .filter((col("hd_dep_count") == lit(4))
                  | (col("hd_vehicle_count") == lit(3)))
          .select("hd_demo_sk"))
    ca = dfs["customer_address"].select("ca_address_sk", "ca_city")
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(hd, on=col("ss_hdemo_sk") == col("hd_demo_sk"))
    j = j.join(ca, on=col("ss_addr_sk") == col("ca_address_sk"))
    dn = (j.group_by("ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                     "ca_city")
          .agg(("sum", "ss_ext_sales_price", "extended_price"),
               ("sum", "ss_ext_list_price", "list_price"),
               ("sum", "ss_ext_tax", "extended_tax"))
          .select("ss_ticket_number", "ss_customer_sk",
                  col("ca_city").alias("bought_city"), "extended_price",
                  "list_price", "extended_tax"))
    cust = dfs["customer"].select("c_customer_sk", "c_current_addr_sk",
                                  "c_first_name", "c_last_name")
    ca2 = dfs["customer_address"].select("ca_address_sk", "ca_city")
    out = dn.join(cust, on=col("ss_customer_sk") == col("c_customer_sk"))
    out = out.join(ca2, on=col("c_current_addr_sk") == col("ca_address_sk"))
    out = out.filter(col("ca_city") != col("bought_city"))
    return (out.select("c_last_name", "c_first_name", "ca_city",
                       "bought_city", "ss_ticket_number", "extended_price",
                       "extended_tax", "list_price")
            .sort("c_last_name", "ss_ticket_number").limit(100))


def q79(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_ticket_number", "ss_customer_sk", "ss_hdemo_sk", "ss_addr_sk",
        "ss_sold_date_sk", "ss_store_sk", "ss_coupon_amt", "ss_net_profit")
    dt = (dfs["date_dim"]
          .filter((col("d_dow") == lit(1))
                  & col("d_year").isin(1999, 2000, 2001))
          .select("d_date_sk"))
    st = (dfs["store"]
          .filter(col("s_number_employees").between(200, 295))
          .select("s_store_sk", "s_city"))
    hd = (dfs["household_demographics"]
          .filter((col("hd_dep_count") == lit(6))
                  | (col("hd_vehicle_count") > lit(2)))
          .select("hd_demo_sk"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(hd, on=col("ss_hdemo_sk") == col("hd_demo_sk"))
    ms = (j.group_by("ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                     "s_city")
          .agg(("sum", "ss_coupon_amt", "amt"),
               ("sum", "ss_net_profit", "profit")))
    cust = dfs["customer"].select("c_customer_sk", "c_last_name",
                                  "c_first_name")
    out = ms.join(cust, on=col("ss_customer_sk") == col("c_customer_sk"))
    out = out.select("c_last_name", "c_first_name",
                     col("s_city").substr(1, 30).alias("city"),
                     "ss_ticket_number", "amt", "profit")
    return (out.sort("c_last_name", "c_first_name", "city", "profit",
                     "ss_ticket_number").limit(100))


def q13(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_store_sk", "ss_cdemo_sk", "ss_hdemo_sk",
        "ss_addr_sk", "ss_quantity", "ss_sales_price", "ss_ext_sales_price",
        "ss_ext_wholesale_cost", "ss_net_profit")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2001))
          .select("d_date_sk"))
    st = dfs["store"].select("s_store_sk")
    cd = dfs["customer_demographics"].select(
        "cd_demo_sk", "cd_marital_status", "cd_education_status")
    hd = dfs["household_demographics"].select("hd_demo_sk", "hd_dep_count")
    ca = (dfs["customer_address"]
          .filter(col("ca_country") == lit("United States"))
          .select("ca_address_sk", "ca_state"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(cd, on=col("ss_cdemo_sk") == col("cd_demo_sk"))
    j = j.join(hd, on=col("ss_hdemo_sk") == col("hd_demo_sk"))
    j = j.join(ca, on=col("ss_addr_sk") == col("ca_address_sk"))
    demo = (((col("cd_marital_status") == lit("M"))
             & (col("cd_education_status") == lit("Advanced Degree"))
             & col("ss_sales_price").between(lit(100.0), lit(150.0))
             & (col("hd_dep_count") == lit(3)))
            | ((col("cd_marital_status") == lit("S"))
               & (col("cd_education_status") == lit("College"))
               & col("ss_sales_price").between(lit(50.0), lit(100.0))
               & (col("hd_dep_count") == lit(1)))
            | ((col("cd_marital_status") == lit("W"))
               & (col("cd_education_status") == lit("2 yr Degree"))
               & col("ss_sales_price").between(lit(150.0), lit(200.0))
               & (col("hd_dep_count") == lit(1))))
    addr = ((col("ca_state").isin("TX", "OH")
             & col("ss_net_profit").between(lit(100), lit(200)))
            | (col("ca_state").isin("OR", "NM", "KY")
               & col("ss_net_profit").between(lit(150), lit(300)))
            | (col("ca_state").isin("VA", "TX", "MS")
               & col("ss_net_profit").between(lit(50), lit(250))))
    return (j.filter(demo & addr)
            .agg(("avg", "ss_quantity", "avg_qty"),
                 ("avg", "ss_ext_sales_price", "avg_esp"),
                 ("avg", "ss_ext_wholesale_cost", "avg_ewc"),
                 ("sum", "ss_ext_wholesale_cost", "sum_ewc")))


def q48(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_store_sk", "ss_cdemo_sk", "ss_addr_sk",
        "ss_quantity", "ss_sales_price", "ss_net_profit")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk"))
    st = dfs["store"].select("s_store_sk")
    cd = dfs["customer_demographics"].select(
        "cd_demo_sk", "cd_marital_status", "cd_education_status")
    ca = (dfs["customer_address"]
          .filter(col("ca_country") == lit("United States"))
          .select("ca_address_sk", "ca_state"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(cd, on=col("ss_cdemo_sk") == col("cd_demo_sk"))
    j = j.join(ca, on=col("ss_addr_sk") == col("ca_address_sk"))
    demo = (((col("cd_marital_status") == lit("M"))
             & (col("cd_education_status") == lit("4 yr Degree"))
             & col("ss_sales_price").between(lit(100.0), lit(150.0)))
            | ((col("cd_marital_status") == lit("D"))
               & (col("cd_education_status") == lit("2 yr Degree"))
               & col("ss_sales_price").between(lit(50.0), lit(100.0)))
            | ((col("cd_marital_status") == lit("S"))
               & (col("cd_education_status") == lit("College"))
               & col("ss_sales_price").between(lit(150.0), lit(200.0))))
    addr = ((col("ca_state").isin("CO", "OH", "TX")
             & col("ss_net_profit").between(lit(0), lit(2000)))
            | (col("ca_state").isin("OR", "MN", "KY")
               & col("ss_net_profit").between(lit(150), lit(3000)))
            | (col("ca_state").isin("VA", "CA", "MS")
               & col("ss_net_profit").between(lit(50), lit(25000))))
    return j.filter(demo & addr).agg(("sum", "ss_quantity", "sum_qty"))


_DAY_COLS = (("sun_sales", "Sunday"), ("mon_sales", "Monday"),
             ("tue_sales", "Tuesday"), ("wed_sales", "Wednesday"),
             ("thu_sales", "Thursday"), ("fri_sales", "Friday"),
             ("sat_sales", "Saturday"))


def q43(dfs: Dict[str, "object"]):
    from hyperspace_tpu_torch.plan.expr import when

    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_store_sk",
                                   "ss_sales_price")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk", "d_day_name"))
    st = (dfs["store"].filter(col("s_gmt_offset") == lit(-5.0))
          .select("s_store_sk", "s_store_id", "s_store_name"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    aggs = [("sum", when(col("d_day_name") == lit(day),
                         col("ss_sales_price")), alias)
            for alias, day in _DAY_COLS]
    return (j.group_by("s_store_name", "s_store_id")
            .agg(*aggs)
            .sort("s_store_name", "s_store_id",
                  *[alias for alias, _ in _DAY_COLS])
            .limit(100))


_Q50_STORE_COLS = ("s_store_name", "s_company_id", "s_street_number",
                   "s_street_name", "s_street_type", "s_suite_number",
                   "s_city", "s_county", "s_state", "s_zip")


def q50(dfs: Dict[str, "object"]):
    from hyperspace_tpu_torch.plan.expr import when

    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_store_sk", "ss_ticket_number", "ss_item_sk",
        "ss_customer_sk")
    sr = dfs["store_returns"].select(
        "sr_returned_date_sk", "sr_ticket_number", "sr_item_sk",
        "sr_customer_sk")
    j = ss.join(sr, on=((col("ss_ticket_number") == col("sr_ticket_number"))
                        & (col("ss_item_sk") == col("sr_item_sk"))
                        & (col("ss_customer_sk") == col("sr_customer_sk"))))
    d2 = (dfs["date_dim"]
          .filter((col("d_year") == lit(2001)) & (col("d_moy") == lit(8)))
          .select("d_date_sk"))
    j = j.join(d2, on=col("sr_returned_date_sk") == col("d_date_sk"))
    d1 = dfs["date_dim"].select("d_date_sk")
    # Drop d2's key before the second date join or the names collide.
    j = j.select("ss_sold_date_sk", "ss_store_sk", "sr_returned_date_sk")
    j = j.join(d1, on=col("ss_sold_date_sk") == col("d_date_sk"))
    st = dfs["store"].select("s_store_sk", *_Q50_STORE_COLS)
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    lag = col("sr_returned_date_sk") - col("ss_sold_date_sk")
    buckets = [
        ("days_30", when(lag <= lit(30), lit(1)).otherwise(lit(0))),
        ("days_31_60", when((lag > lit(30)) & (lag <= lit(60)),
                            lit(1)).otherwise(lit(0))),
        ("days_61_90", when((lag > lit(60)) & (lag <= lit(90)),
                            lit(1)).otherwise(lit(0))),
        ("days_91_120", when((lag > lit(90)) & (lag <= lit(120)),
                             lit(1)).otherwise(lit(0))),
        ("days_over_120", when(lag > lit(120), lit(1)).otherwise(lit(0))),
    ]
    return (j.group_by(*_Q50_STORE_COLS)
            .agg(*[("sum", e, alias) for alias, e in buckets])
            .sort(*_Q50_STORE_COLS).limit(100))


_Q53_DISJUNCT_ARGS = (
    (("Books", "Children", "Electronics"),
     ("personal", "portable", "reference", "self-help"),
     ("brand_01", "brand_03", "brand_05", "brand_07")),
    (("Women", "Music", "Men"),
     ("accessories", "classical", "fragrances", "pants"),
     ("brand_02", "brand_04", "brand_06", "brand_08")),
)


def _item_disjunct_expr():
    (c1, k1, b1), (c2, k2, b2) = _Q53_DISJUNCT_ARGS
    return ((col("i_category").isin(*c1) & col("i_class").isin(*k1)
             & col("i_brand").isin(*b1))
            | (col("i_category").isin(*c2) & col("i_class").isin(*k2)
               & col("i_brand").isin(*b2)))


def _abs(e):
    from hyperspace_tpu_torch.plan.expr import when
    return when(e < lit(0.0), lit(0.0) - e).otherwise(e)


def _q53_shape(dfs, key_col: str, period_col: str, avg_alias: str):
    """Shared q53/q63 body: quarterly/monthly sums per item key vs the
    key's average over periods, rows deviating >10% from it."""
    ss = dfs["store_sales"].select("ss_item_sk", "ss_sold_date_sk",
                                   "ss_store_sk", "ss_sales_price")
    it = (dfs["item"]
          .filter(_item_disjunct_expr())
          .select("i_item_sk", key_col))
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk", period_col))
    st = dfs["store"].select("s_store_sk")
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    g = (j.group_by(key_col, period_col)
         .agg(("sum", "ss_sales_price", "sum_sales")))
    w = g.window([key_col], **{avg_alias: ("avg", "sum_sales")})
    dev = _abs(col("sum_sales") - col(avg_alias)) / col(avg_alias)
    return (w.filter((col(avg_alias) > lit(0.0)) & (dev > lit(0.1)))
            .select(key_col, "sum_sales", avg_alias)
            .sort(avg_alias, "sum_sales", key_col).limit(100))


def q53(dfs: Dict[str, "object"]):
    return _q53_shape(dfs, "i_manufact_id", "d_qoy", "avg_quarterly_sales")


def q63(dfs: Dict[str, "object"]):
    return _q53_shape(dfs, "i_manager_id", "d_moy", "avg_monthly_sales")


_Q89_KEYS = ["i_category", "i_class", "i_brand", "s_store_name",
             "s_company_name"]


def q89(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select("ss_item_sk", "ss_sold_date_sk",
                                   "ss_store_sk", "ss_sales_price")
    it = (dfs["item"]
          .filter(_item_disjunct_expr())
          .select("i_item_sk", "i_category", "i_class", "i_brand"))
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk", "d_moy"))
    st = dfs["store"].select("s_store_sk", "s_store_name",
                             "s_company_name")
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    g = (j.group_by(*(_Q89_KEYS + ["d_moy"]))
         .agg(("sum", "ss_sales_price", "sum_sales")))
    w = g.window(["i_category", "i_brand", "s_store_name",
                  "s_company_name"],
                 avg_monthly_sales=("avg", "sum_sales"))
    dev = (_abs(col("sum_sales") - col("avg_monthly_sales"))
           / col("avg_monthly_sales"))
    return (w.filter((col("avg_monthly_sales") > lit(0.0))
                     & (dev > lit(0.1)))
            .select(*(_Q89_KEYS + ["d_moy", "sum_sales",
                                   "avg_monthly_sales"]),
                    (col("sum_sales")
                     - col("avg_monthly_sales")).alias("delta"))
            .sort("delta", "s_store_name", *_Q89_KEYS, "d_moy")
            .limit(100).select(*(_Q89_KEYS + ["d_moy", "sum_sales",
                                              "avg_monthly_sales"])))


_Q98_KEYS = ["i_item_id", "i_item_desc", "i_category", "i_class",
             "i_current_price"]


def q98(dfs: Dict[str, "object"]):
    """Item revenue share of its class. Probes d_year=2000, d_moy=5 (a
    ~31-day window like the official 30-day d_date range, which the
    generator's date_dim does not carry)."""
    ss = dfs["store_sales"].select("ss_item_sk", "ss_sold_date_sk",
                                   "ss_ext_sales_price")
    it = (dfs["item"]
          .filter(col("i_category").isin("Sports", "Books", "Home"))
          .select("i_item_sk", *_Q98_KEYS))
    dt = (dfs["date_dim"]
          .filter((col("d_year") == lit(2000)) & (col("d_moy") == lit(5)))
          .select("d_date_sk"))
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    g = (j.group_by(*_Q98_KEYS)
         .agg(("sum", "ss_ext_sales_price", "itemrevenue")))
    w = g.window(["i_class"], class_revenue=("sum", "itemrevenue"))
    return (w.select(*_Q98_KEYS, "itemrevenue",
                     ((col("itemrevenue") * lit(100.0))
                      / col("class_revenue")).alias("revenueratio"))
            .sort("i_category", "i_class", "i_item_id", "i_item_desc",
                  "revenueratio", "itemrevenue"))


def q65(dfs: Dict[str, "object"]):
    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_store_sk",
                                   "ss_item_sk", "ss_sales_price")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk"))
    inner = (ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
             .group_by("ss_store_sk", "ss_item_sk")
             .agg(("sum", "ss_sales_price", "revenue")))
    sb = (inner.group_by("ss_store_sk")
          .agg(("avg", "revenue", "ave")))
    j = inner.join(sb, on=col("ss_store_sk") == col("ss_store_sk"))
    j = j.filter(col("revenue") <= col("ave") * lit(0.1))
    st = dfs["store"].select("s_store_sk", "s_store_name")
    it = dfs["item"].select("i_item_sk", "i_item_desc", "i_current_price",
                            "i_wholesale_cost", "i_brand")
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.select("s_store_name", "i_item_desc", "revenue",
                     "i_current_price", "i_wholesale_cost", "i_brand")
            .sort("s_store_name", "i_item_desc", "revenue").limit(100))


_Q67_ROLLUP = (("i_category", "string"), ("i_class", "string"),
               ("i_brand", "string"), ("i_product_name", "string"),
               ("d_year", "int64"), ("d_qoy", "int64"), ("d_moy", "int64"),
               ("s_store_id", "string"))


def q67(dfs: Dict[str, "object"]):
    from hyperspace_tpu_torch.engine.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.expr import null
    from hyperspace_tpu_torch.plan.nodes import Union

    ss = dfs["store_sales"].select("ss_sold_date_sk", "ss_item_sk",
                                   "ss_store_sk", "ss_quantity",
                                   "ss_sales_price")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk", "d_year", "d_qoy", "d_moy"))
    st = dfs["store"].select("s_store_sk", "s_store_id")
    it = dfs["item"].select("i_item_sk", "i_category", "i_class",
                            "i_brand", "i_product_name")
    j = ss.join(dt, on=col("ss_sold_date_sk") == col("d_date_sk"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    sales = (col("ss_sales_price") * col("ss_quantity")).alias("_sales")
    j = j.select(*[name for name, _ in _Q67_ROLLUP], sales)

    names = [name for name, _ in _Q67_ROLLUP]
    branches = []
    for depth in range(len(_Q67_ROLLUP), -1, -1):
        keep = names[:depth]
        if keep:
            g = j.group_by(*keep).agg(("sum", "_sales", "sumsales"))
        else:
            g = j.agg(("sum", "_sales", "sumsales"))
        entries = list(keep) + [null(dtype).alias(name)
                                for name, dtype in _Q67_ROLLUP[depth:]]
        branches.append(g.select(*entries, "sumsales").plan)
    u = DataFrame(Union(branches), j.session)
    w = u.window(["i_category"], order_by=["-sumsales"],
                 rk=("rank", "*"))
    return (w.filter(col("rk") <= lit(100))
            .sort(*names, "sumsales", "rk").limit(100))


def q29(dfs):
    ss = dfs["store_sales"].select(
        "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_store_sk",
        "ss_ticket_number", "ss_quantity")
    sr = dfs["store_returns"].select(
        "sr_returned_date_sk", "sr_item_sk", "sr_customer_sk",
        "sr_ticket_number", "sr_return_quantity")
    cs = dfs["catalog_sales"].select(
        "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk",
        "cs_quantity")
    d1 = (dfs["date_dim"]
          .filter((col("d_moy") == lit(9)) & (col("d_year") == lit(1999)))
          .select("d_date_sk"))
    d2 = (dfs["date_dim"]
          .filter((col("d_moy") >= lit(9)) & (col("d_moy") <= lit(12))
                  & (col("d_year") == lit(1999)))
          .select("d_date_sk"))
    d3 = (dfs["date_dim"]
          .filter(col("d_year").isin(1999, 2000, 2001))
          .select("d_date_sk"))
    store = dfs["store"].select("s_store_sk", "s_store_id", "s_store_name")
    item = dfs["item"].select("i_item_sk", "i_item_id", "i_item_desc")

    j = ss.join(sr, on=(col("ss_customer_sk") == col("sr_customer_sk"))
                & (col("ss_item_sk") == col("sr_item_sk"))
                & (col("ss_ticket_number") == col("sr_ticket_number")))
    j = j.join(cs, on=(col("sr_customer_sk") == col("cs_bill_customer_sk"))
               & (col("sr_item_sk") == col("cs_item_sk")))
    j = j.join(d1, on=col("ss_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_quantity", "sr_returned_date_sk",
        "sr_return_quantity", "cs_sold_date_sk", "cs_quantity")
    j = j.join(d2, on=col("sr_returned_date_sk") == col("d_date_sk")) \
        .select("ss_item_sk", "ss_store_sk", "ss_quantity",
                "sr_return_quantity", "cs_sold_date_sk", "cs_quantity")
    j = j.join(d3, on=col("cs_sold_date_sk") == col("d_date_sk")).select(
        "ss_item_sk", "ss_store_sk", "ss_quantity", "sr_return_quantity",
        "cs_quantity")
    j = j.join(store, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(item, on=col("ss_item_sk") == col("i_item_sk"))
    return (j.group_by("i_item_id", "i_item_desc", "s_store_id",
                       "s_store_name").agg(
        ("sum", "ss_quantity", "store_sales_quantity"),
        ("sum", "sr_return_quantity", "store_returns_quantity"),
        ("sum", "cs_quantity", "catalog_sales_quantity"))
        .sort("i_item_id", "i_item_desc", "s_store_id", "s_store_name")
        .limit(100))


# index name -> (table, IndexConfig args, queries that can use it); the
# seven of the source's `_INDEX_DEFS` that these queries read.
_INDEX_DEFS = (
    ("idx_ss_ret", "store_sales",
     (["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
      ["ss_sold_date_sk", "ss_store_sk", "ss_quantity", "ss_net_profit"]),
     ("q17", "q25", "q29", "q50")),
    ("idx_sr_ret", "store_returns",
     (["sr_customer_sk", "sr_item_sk", "sr_ticket_number"],
      ["sr_returned_date_sk", "sr_return_quantity", "sr_net_loss"]),
     ("q17", "q25", "q29", "q50")),
    ("idx_cs_order", "catalog_sales",
     (["cs_item_sk", "cs_order_number"], ["cs_ext_list_price"]), ("q64",)),
    ("idx_cr_order", "catalog_returns",
     (["cr_item_sk", "cr_order_number"],
      ["cr_refunded_cash", "cr_reversed_charge", "cr_store_credit"]),
     ("q64",)),
    ("idx_dd_quarter", "date_dim",
     (["d_quarter_name"], ["d_date_sk"]), ("q17",)),
    ("idx_ss_date", "store_sales",
     (["ss_sold_date_sk"],
      ["ss_item_sk", "ss_customer_sk", "ss_store_sk", "ss_hdemo_sk",
       "ss_cdemo_sk", "ss_addr_sk", "ss_promo_sk", "ss_ticket_number",
       "ss_quantity", "ss_list_price", "ss_sales_price", "ss_coupon_amt",
       "ss_ext_sales_price", "ss_ext_list_price", "ss_ext_tax",
       "ss_ext_wholesale_cost", "ss_net_profit"]),
     _STAR_FAMILY),
    ("idx_dd_datesk", "date_dim",
     (["d_date_sk"],
      ["d_year", "d_moy", "d_dom", "d_dow", "d_qoy", "d_day_name"]),
     _STAR_FAMILY),
)


BUILDERS = {
    "q3": q3,
    "q7": q7,
    "q13": q13,
    "q17": q17,
    "q19": q19,
    "q25": q25,
    "q29": q29,
    "q42": q42,
    "q43": q43,
    "q48": q48,
    "q50": q50,
    "q52": q52,
    "q53": q53,
    "q55": q55,
    "q63": q63,
    "q64": q64,
    "q65": q65,
    "q67": q67,
    "q68": q68,
    "q79": q79,
    "q89": q89,
    "q98": q98,
}
