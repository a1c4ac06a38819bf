"""Frozen copy of the pandas oracles of 22 TPC-DS queries of
`hyperspace_tpu_torch/tpcds/queries.py` (q29: `queries_ext.py`) at commit
976226b; plain NumPy and pandas, with nothing of the program imported.

Split mechanically from the source modules, function bodies unchanged;
the benchmark's yardstick, not to be edited with the port. The filter
constants are those of `benchmark/queries/tpcds.py`, which notes where
they differ from the official text.
"""

from __future__ import annotations

from typing import Dict


def q17_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    d1 = d[d.d_quarter_name == "2000Q1"][["d_date_sk"]]
    d23 = d[d.d_quarter_name.isin(["2000Q1", "2000Q2", "2000Q3"])][["d_date_sk"]]
    j = t["store_sales"].merge(
        t["store_returns"],
        left_on=["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
        right_on=["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
    j = j.merge(t["catalog_sales"],
                left_on=["sr_customer_sk", "sr_item_sk"],
                right_on=["cs_bill_customer_sk", "cs_item_sk"])
    j = j.merge(d1, left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.merge(d23, left_on="sr_returned_date_sk", right_on="d_date_sk")
    j = j.merge(d23, left_on="cs_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", "s_state"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_id", "i_item_desc"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["i_item_id", "i_item_desc", "s_state"]).agg(
        store_sales_quantitycount=("ss_quantity", "count"),
        store_sales_quantityave=("ss_quantity", "mean"),
        store_sales_quantitystdev=("ss_quantity", "std"),
        store_returns_quantitycount=("sr_return_quantity", "count"),
        store_returns_quantityave=("sr_return_quantity", "mean"),
        store_returns_quantitystdev=("sr_return_quantity", "std"),
        catalog_sales_quantitycount=("cs_quantity", "count"),
        catalog_sales_quantityave=("cs_quantity", "mean"),
        catalog_sales_quantitystdev=("cs_quantity", "std"),
    ).reset_index()
    return (g.sort_values(["i_item_id", "i_item_desc", "s_state"])
            .head(100).reset_index(drop=True))


def q25_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    d1 = d[(d.d_moy == 4) & (d.d_year == 2000)][["d_date_sk"]]
    d23 = d[(d.d_moy >= 4) & (d.d_moy <= 10) & (d.d_year == 2000)][["d_date_sk"]]
    j = t["store_sales"].merge(
        t["store_returns"],
        left_on=["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
        right_on=["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
    j = j.merge(t["catalog_sales"],
                left_on=["sr_customer_sk", "sr_item_sk"],
                right_on=["cs_bill_customer_sk", "cs_item_sk"])
    j = j.merge(d1, left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.merge(d23, left_on="sr_returned_date_sk", right_on="d_date_sk")
    j = j.merge(d23, left_on="cs_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", "s_store_id", "s_store_name"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_id", "i_item_desc"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["i_item_id", "i_item_desc", "s_store_id",
                   "s_store_name"]).agg(
        store_sales_profit=("ss_net_profit", "sum"),
        store_returns_loss=("sr_net_loss", "sum"),
        catalog_sales_profit=("cs_net_profit", "sum")).reset_index()
    return (g.sort_values(["i_item_id", "i_item_desc", "s_store_id",
                           "s_store_name"]).head(100).reset_index(drop=True))


_Q64_COLORS = ("plum", "puff", "misty")


def _q64_cs_ui_pandas(t):
    j = t["catalog_sales"].merge(
        t["catalog_returns"], left_on=["cs_item_sk", "cs_order_number"],
        right_on=["cr_item_sk", "cr_order_number"])
    g = j.groupby("cs_item_sk").agg(
        sale=("cs_ext_list_price", "sum"),
        refund_cash=("cr_refunded_cash", "sum"),
        refund_charge=("cr_reversed_charge", "sum"),
        refund_credit=("cr_store_credit", "sum")).reset_index()
    keep = g[g.sale > 2.0 * (g.refund_cash + g.refund_charge
                             + g.refund_credit)]
    return keep[["cs_item_sk"]]


def _q64_cross_sales_pandas(t):
    d = t["date_dim"]
    dy = d[d.d_year.isin([2000, 2001])][["d_date_sk", "d_year"]].rename(
        columns={"d_year": "syear"})
    it = t["item"]
    it = it[it.i_color.isin(list(_Q64_COLORS))
            & (it.i_current_price >= 25.0) & (it.i_current_price <= 60.0)]
    j = t["store_sales"].merge(
        t["store_returns"][["sr_item_sk", "sr_ticket_number"]],
        left_on=["ss_item_sk", "ss_ticket_number"],
        right_on=["sr_item_sk", "sr_ticket_number"])
    j = j.merge(_q64_cs_ui_pandas(t), left_on="ss_item_sk",
                right_on="cs_item_sk")
    j = j.merge(dy, left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", "s_store_name", "s_zip"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
    cd = t["customer_demographics"][["cd_demo_sk", "cd_marital_status"]]
    j = j.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(cd, left_on="c_current_cdemo_sk", right_on="cd_demo_sk",
                suffixes=("", "_r"))
    j = j[j.cd_marital_status != j.cd_marital_status_r]
    j = j.merge(t["promotion"][["p_promo_sk"]], left_on="ss_promo_sk",
                right_on="p_promo_sk")
    hd = t["household_demographics"][["hd_demo_sk", "hd_income_band_sk"]]
    ib = t["income_band"][["ib_income_band_sk"]]
    j = j.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
    j = j.merge(ib, left_on="hd_income_band_sk",
                right_on="ib_income_band_sk")
    j = j.merge(hd, left_on="c_current_hdemo_sk", right_on="hd_demo_sk",
                suffixes=("", "_r"))
    j = j.merge(ib, left_on="hd_income_band_sk_r",
                right_on="ib_income_band_sk", suffixes=("", "_r"))
    dd = t["date_dim"][["d_date_sk", "d_year"]]
    j = j.merge(dd.rename(columns={"d_year": "fsyear"}),
                left_on="c_first_sales_date_sk", right_on="d_date_sk")
    j = j.merge(dd.rename(columns={"d_year": "s2year"}),
                left_on="c_first_shipto_date_sk", right_on="d_date_sk")
    ad = t["customer_address"][["ca_address_sk", "ca_street_number",
                                "ca_street_name", "ca_city", "ca_zip"]]
    j = j.merge(ad, left_on="ss_addr_sk", right_on="ca_address_sk")
    j = j.merge(ad, left_on="c_current_addr_sk", right_on="ca_address_sk",
                suffixes=("", "_r"))
    j = j.merge(it[["i_item_sk", "i_product_name"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    j = j.rename(columns={
        "ss_item_sk": "item_sk",
        "ca_street_number": "b_street_number",
        "ca_street_name": "b_street_name", "ca_city": "b_city",
        "ca_zip": "b_zip", "ca_street_number_r": "c_street_number",
        "ca_street_name_r": "c_street_name", "ca_city_r": "c_city",
        "ca_zip_r": "c_zip"})
    keys = ["i_product_name", "item_sk", "s_store_name", "s_zip",
            "b_street_number", "b_street_name", "b_city", "b_zip",
            "c_street_number", "c_street_name", "c_city", "c_zip",
            "syear", "fsyear", "s2year"]
    return j.groupby(keys, as_index=False).agg(
        cnt=("item_sk", "size"),
        s1=("ss_wholesale_cost", "sum"),
        s2=("ss_list_price", "sum"),
        s3=("ss_coupon_amt", "sum"))


def q64_pandas(t: Dict[str, "object"]):
    cross_sales = _q64_cross_sales_pandas(t)
    cs1 = cross_sales[cross_sales.syear == 2000]
    cs2 = cross_sales[cross_sales.syear == 2001]
    cs2 = cs2[["item_sk", "s_store_name", "s_zip", "syear", "cnt", "s1",
               "s2", "s3"]].rename(columns={
        "item_sk": "item_sk2", "s_store_name": "store_name2",
        "s_zip": "store_zip2", "syear": "syear2", "cnt": "cnt2",
        "s1": "s1_2", "s2": "s2_2", "s3": "s3_2"})
    j = cs1.merge(cs2, left_on=["item_sk", "s_store_name", "s_zip"],
                  right_on=["item_sk2", "store_name2", "store_zip2"])
    j = j[j.cnt2 <= j.cnt]
    out = j[["i_product_name", "item_sk", "s_store_name", "s_zip",
             "b_street_number", "b_street_name", "b_city", "b_zip",
             "c_street_number", "c_street_name", "c_city", "c_zip",
             "syear", "cnt", "s1", "s2", "s3",
             "syear2", "cnt2", "s1_2", "s2_2", "s3_2"]]
    return (out.sort_values(["i_product_name", "s_store_name", "cnt2",
                             "item_sk", "s_zip", "b_street_number",
                             "b_street_name", "b_city", "b_zip",
                             "c_street_number", "c_street_name", "c_city",
                             "c_zip", "s1", "s2", "s3", "s1_2", "s2_2",
                             "s3_2"])
            .head(100).reset_index(drop=True))


def q3_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[d.d_moy == 11][["d_date_sk", "d_year"]]
    i = t["item"]
    it = i[i.i_manufact_id == 128][["i_item_sk", "i_brand_id", "i_brand"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["d_year", "i_brand_id", "i_brand"]).agg(
        sum_agg=("ss_ext_sales_price", "sum")).reset_index()
    return (g.sort_values(["d_year", "sum_agg", "i_brand_id"],
                          ascending=[True, False, True])
            .head(100).reset_index(drop=True))


def q42_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[(d.d_moy == 11) & (d.d_year == 2000)][["d_date_sk", "d_year"]]
    i = t["item"]
    it = i[i.i_manager_id == 1][["i_item_sk", "i_category_id", "i_category"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["d_year", "i_category_id", "i_category"]).agg(
        sum_sales=("ss_ext_sales_price", "sum")).reset_index()
    return (g.sort_values(["sum_sales", "d_year", "i_category_id",
                           "i_category"],
                          ascending=[False, True, True, True])
            [["d_year", "i_category_id", "i_category", "sum_sales"]]
            .head(100).reset_index(drop=True))


def q52_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[(d.d_moy == 11) & (d.d_year == 2000)][["d_date_sk", "d_year"]]
    i = t["item"]
    it = i[i.i_manager_id == 1][["i_item_sk", "i_brand_id", "i_brand"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["d_year", "i_brand_id", "i_brand"]).agg(
        ext_price=("ss_ext_sales_price", "sum")).reset_index()
    return (g.sort_values(["d_year", "ext_price", "i_brand_id"],
                          ascending=[True, False, True])
            .head(100).reset_index(drop=True))


def q55_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[(d.d_moy == 11) & (d.d_year == 1999)][["d_date_sk"]]
    i = t["item"]
    it = i[i.i_manager_id == 28][["i_item_sk", "i_brand_id", "i_brand"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["i_brand_id", "i_brand"]).agg(
        ext_price=("ss_ext_sales_price", "sum")).reset_index()
    return (g.sort_values(["ext_price", "i_brand_id"],
                          ascending=[False, True])
            .head(100).reset_index(drop=True))


def q7_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk"]]
    c = t["customer_demographics"]
    cd = c[(c.cd_gender == "M") & (c.cd_marital_status == "S")
           & (c.cd_education_status == "College")][["cd_demo_sk"]]
    p = t["promotion"]
    promo = p[(p.p_channel_email == "N")
              | (p.p_channel_event == "N")][["p_promo_sk"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(promo, left_on="ss_promo_sk", right_on="p_promo_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_id"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby("i_item_id").agg(
        agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
        agg3=("ss_coupon_amt", "mean"),
        agg4=("ss_sales_price", "mean")).reset_index()
    return g.sort_values("i_item_id").head(100).reset_index(drop=True)


def q19_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[(d.d_moy == 11) & (d.d_year == 1999)][["d_date_sk"]]
    i = t["item"]
    it = i[i.i_manager_id == 8][["i_item_sk", "i_brand_id", "i_brand",
                                 "i_manufact_id", "i_manufact"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    j = j.merge(t["customer"][["c_customer_sk", "c_current_addr_sk"]],
                left_on="ss_customer_sk", right_on="c_customer_sk")
    j = j.merge(t["customer_address"][["ca_address_sk", "ca_zip"]],
                left_on="c_current_addr_sk", right_on="ca_address_sk")
    j = j.merge(t["store"][["s_store_sk", "s_zip"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j[j.ca_zip.str[:5] != j.s_zip.str[:5]]
    g = j.groupby(["i_brand_id", "i_brand", "i_manufact_id",
                   "i_manufact"]).agg(
        ext_price=("ss_ext_sales_price", "sum")).reset_index()
    return (g.sort_values(["ext_price", "i_brand", "i_brand_id",
                           "i_manufact_id", "i_manufact"],
                          ascending=[False, True, True, True, True])
            .head(100).reset_index(drop=True))


def q68_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[(d.d_dom >= 1) & (d.d_dom <= 2)
           & d.d_year.isin([1999, 2000, 2001])][["d_date_sk"]]
    s = t["store"]
    st = s[s.s_city.isin(["Midway", "Fairview"])][["s_store_sk"]]
    h = t["household_demographics"]
    hd = h[(h.hd_dep_count == 4) | (h.hd_vehicle_count == 3)][["hd_demo_sk"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
    j = j.merge(t["customer_address"][["ca_address_sk", "ca_city"]],
                left_on="ss_addr_sk", right_on="ca_address_sk")
    dn = j.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                    "ca_city"]).agg(
        extended_price=("ss_ext_sales_price", "sum"),
        list_price=("ss_ext_list_price", "sum"),
        extended_tax=("ss_ext_tax", "sum")).reset_index()
    dn = dn.rename(columns={"ca_city": "bought_city"})
    out = dn.merge(t["customer"][["c_customer_sk", "c_current_addr_sk",
                                  "c_first_name", "c_last_name"]],
                   left_on="ss_customer_sk", right_on="c_customer_sk")
    out = out.merge(t["customer_address"][["ca_address_sk", "ca_city"]],
                    left_on="c_current_addr_sk", right_on="ca_address_sk")
    out = out[out.ca_city != out.bought_city]
    out = out[["c_last_name", "c_first_name", "ca_city", "bought_city",
               "ss_ticket_number", "extended_price", "extended_tax",
               "list_price"]]
    return (out.sort_values(["c_last_name", "ss_ticket_number"])
            .head(100).reset_index(drop=True))


def q79_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[(d.d_dow == 1) & d.d_year.isin([1999, 2000, 2001])][["d_date_sk"]]
    s = t["store"]
    st = s[(s.s_number_employees >= 200)
           & (s.s_number_employees <= 295)][["s_store_sk", "s_city"]]
    h = t["household_demographics"]
    hd = h[(h.hd_dep_count == 6) | (h.hd_vehicle_count > 2)][["hd_demo_sk"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
    ms = j.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                    "s_city"]).agg(
        amt=("ss_coupon_amt", "sum"),
        profit=("ss_net_profit", "sum")).reset_index()
    out = ms.merge(t["customer"][["c_customer_sk", "c_last_name",
                                  "c_first_name"]],
                   left_on="ss_customer_sk", right_on="c_customer_sk")
    out = out.assign(city=out.s_city.str[:30])
    out = out[["c_last_name", "c_first_name", "city", "ss_ticket_number",
               "amt", "profit"]]
    return (out.sort_values(["c_last_name", "c_first_name", "city",
                             "profit", "ss_ticket_number"])
            .head(100).reset_index(drop=True))


def q13_pandas(t: Dict[str, "object"]):
    import pandas as pd

    d = t["date_dim"]
    dt = d[d.d_year == 2001][["d_date_sk"]]
    ca = t["customer_address"]
    ca = ca[ca.ca_country == "United States"][["ca_address_sk", "ca_state"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk"]], left_on="ss_store_sk",
                right_on="s_store_sk")
    j = j.merge(t["customer_demographics"][
        ["cd_demo_sk", "cd_marital_status", "cd_education_status"]],
        left_on="ss_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(t["household_demographics"][["hd_demo_sk", "hd_dep_count"]],
                left_on="ss_hdemo_sk", right_on="hd_demo_sk")
    j = j.merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk")
    demo = (((j.cd_marital_status == "M")
             & (j.cd_education_status == "Advanced Degree")
             & j.ss_sales_price.between(100.0, 150.0)
             & (j.hd_dep_count == 3))
            | ((j.cd_marital_status == "S")
               & (j.cd_education_status == "College")
               & j.ss_sales_price.between(50.0, 100.0)
               & (j.hd_dep_count == 1))
            | ((j.cd_marital_status == "W")
               & (j.cd_education_status == "2 yr Degree")
               & j.ss_sales_price.between(150.0, 200.0)
               & (j.hd_dep_count == 1)))
    addr = ((j.ca_state.isin(["TX", "OH"])
             & j.ss_net_profit.between(100, 200))
            | (j.ca_state.isin(["OR", "NM", "KY"])
               & j.ss_net_profit.between(150, 300))
            | (j.ca_state.isin(["VA", "TX", "MS"])
               & j.ss_net_profit.between(50, 250)))
    j = j[demo & addr]
    return pd.DataFrame({
        "avg_qty": [j.ss_quantity.mean()],
        "avg_esp": [j.ss_ext_sales_price.mean()],
        "avg_ewc": [j.ss_ext_wholesale_cost.mean()],
        # min_count=1: SUM over zero rows is SQL NULL, not 0.0.
        "sum_ewc": [j.ss_ext_wholesale_cost.sum(min_count=1)]})


def q48_pandas(t: Dict[str, "object"]):
    import pandas as pd

    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk"]]
    ca = t["customer_address"]
    ca = ca[ca.ca_country == "United States"][["ca_address_sk", "ca_state"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk"]], left_on="ss_store_sk",
                right_on="s_store_sk")
    j = j.merge(t["customer_demographics"][
        ["cd_demo_sk", "cd_marital_status", "cd_education_status"]],
        left_on="ss_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk")
    demo = (((j.cd_marital_status == "M")
             & (j.cd_education_status == "4 yr Degree")
             & j.ss_sales_price.between(100.0, 150.0))
            | ((j.cd_marital_status == "D")
               & (j.cd_education_status == "2 yr Degree")
               & j.ss_sales_price.between(50.0, 100.0))
            | ((j.cd_marital_status == "S")
               & (j.cd_education_status == "College")
               & j.ss_sales_price.between(150.0, 200.0)))
    addr = ((j.ca_state.isin(["CO", "OH", "TX"])
             & j.ss_net_profit.between(0, 2000))
            | (j.ca_state.isin(["OR", "MN", "KY"])
               & j.ss_net_profit.between(150, 3000))
            | (j.ca_state.isin(["VA", "CA", "MS"])
               & j.ss_net_profit.between(50, 25000)))
    j = j[demo & addr]
    # min_count=1: SUM over zero rows is SQL NULL, not 0.
    return pd.DataFrame({"sum_qty": [j.ss_quantity.sum(min_count=1)]})


_DAY_COLS = (("sun_sales", "Sunday"), ("mon_sales", "Monday"),
             ("tue_sales", "Tuesday"), ("wed_sales", "Wednesday"),
             ("thu_sales", "Thursday"), ("fri_sales", "Friday"),
             ("sat_sales", "Saturday"))


def q43_pandas(t: Dict[str, "object"]):
    import numpy as np

    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk", "d_day_name"]]
    s = t["store"]
    st = s[s.s_gmt_offset == -5.0][["s_store_sk", "s_store_id",
                                    "s_store_name"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
    for alias, day in _DAY_COLS:
        j[alias] = np.where(j.d_day_name == day, j.ss_sales_price, np.nan)
    # min_count=1: a (store, weekday) group with no matching rows is SQL
    # NULL (the framework's no-ELSE CASE semantics), not 0.0.
    g = j.groupby(["s_store_name", "s_store_id"]).agg(
        **{alias: (alias, lambda s: s.sum(min_count=1))
           for alias, _ in _DAY_COLS}).reset_index()
    return (g.sort_values(["s_store_name", "s_store_id"]
                          + [alias for alias, _ in _DAY_COLS])
            .head(100).reset_index(drop=True))


_Q50_STORE_COLS = ("s_store_name", "s_company_id", "s_street_number",
                   "s_street_name", "s_street_type", "s_suite_number",
                   "s_city", "s_county", "s_state", "s_zip")


def q50_pandas(t: Dict[str, "object"]):
    import numpy as np

    j = t["store_sales"][["ss_sold_date_sk", "ss_store_sk",
                          "ss_ticket_number", "ss_item_sk",
                          "ss_customer_sk"]].merge(
        t["store_returns"][["sr_returned_date_sk", "sr_ticket_number",
                            "sr_item_sk", "sr_customer_sk"]],
        left_on=["ss_ticket_number", "ss_item_sk", "ss_customer_sk"],
        right_on=["sr_ticket_number", "sr_item_sk", "sr_customer_sk"])
    d = t["date_dim"]
    d2 = d[(d.d_year == 2001) & (d.d_moy == 8)][["d_date_sk"]]
    j = j.merge(d2, left_on="sr_returned_date_sk", right_on="d_date_sk")
    j = j[["ss_sold_date_sk", "ss_store_sk", "sr_returned_date_sk"]]
    j = j.merge(d[["d_date_sk"]], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", *_Q50_STORE_COLS]],
                left_on="ss_store_sk", right_on="s_store_sk")
    lag = j.sr_returned_date_sk - j.ss_sold_date_sk
    j = j.assign(
        days_30=np.where(lag <= 30, 1, 0),
        days_31_60=np.where((lag > 30) & (lag <= 60), 1, 0),
        days_61_90=np.where((lag > 60) & (lag <= 90), 1, 0),
        days_91_120=np.where((lag > 90) & (lag <= 120), 1, 0),
        days_over_120=np.where(lag > 120, 1, 0))
    g = j.groupby(list(_Q50_STORE_COLS)).agg(
        days_30=("days_30", "sum"), days_31_60=("days_31_60", "sum"),
        days_61_90=("days_61_90", "sum"),
        days_91_120=("days_91_120", "sum"),
        days_over_120=("days_over_120", "sum")).reset_index()
    return (g.sort_values(list(_Q50_STORE_COLS))
            .head(100).reset_index(drop=True))


_Q53_DISJUNCT_ARGS = (
    (("Books", "Children", "Electronics"),
     ("personal", "portable", "reference", "self-help"),
     ("brand_01", "brand_03", "brand_05", "brand_07")),
    (("Women", "Music", "Men"),
     ("accessories", "classical", "fragrances", "pants"),
     ("brand_02", "brand_04", "brand_06", "brand_08")),
)


def _item_disjunct_mask(i):
    (c1, k1, b1), (c2, k2, b2) = _Q53_DISJUNCT_ARGS
    return ((i.i_category.isin(c1) & i.i_class.isin(k1)
             & i.i_brand.isin(b1))
            | (i.i_category.isin(c2) & i.i_class.isin(k2)
               & i.i_brand.isin(b2)))


def _q53_shape_pandas(t, key_col: str, left_key: str, period_col: str,
                      avg_alias: str):
    i = t["item"]
    it = i[_item_disjunct_mask(i)][["i_item_sk", key_col]]
    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk", period_col]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    j = j.merge(t["store"][["s_store_sk"]], left_on="ss_store_sk",
                right_on="s_store_sk")
    g = (j.groupby([key_col, period_col])
         .agg(sum_sales=("ss_sales_price", "sum")).reset_index())
    g[avg_alias] = g.groupby(key_col)["sum_sales"].transform("mean")
    g = g[(g[avg_alias] > 0)
          & ((g.sum_sales - g[avg_alias]).abs() / g[avg_alias] > 0.1)]
    return (g[[key_col, "sum_sales", avg_alias]]
            .sort_values([avg_alias, "sum_sales", key_col])
            .head(100).reset_index(drop=True))


def q53_pandas(t: Dict[str, "object"]):
    return _q53_shape_pandas(t, "i_manufact_id", "ss_item_sk", "d_qoy",
                             "avg_quarterly_sales")


def q63_pandas(t: Dict[str, "object"]):
    return _q53_shape_pandas(t, "i_manager_id", "ss_item_sk", "d_moy",
                             "avg_monthly_sales")


_Q89_KEYS = ["i_category", "i_class", "i_brand", "s_store_name",
             "s_company_name"]


def q89_pandas(t: Dict[str, "object"]):
    i = t["item"]
    it = i[_item_disjunct_mask(i)][["i_item_sk", "i_category", "i_class",
                                    "i_brand"]]
    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk", "d_moy"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    j = j.merge(t["store"][["s_store_sk", "s_store_name",
                            "s_company_name"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    g = (j.groupby(_Q89_KEYS + ["d_moy"])
         .agg(sum_sales=("ss_sales_price", "sum")).reset_index())
    g["avg_monthly_sales"] = g.groupby(
        ["i_category", "i_brand", "s_store_name",
         "s_company_name"])["sum_sales"].transform("mean")
    g = g[(g.avg_monthly_sales > 0)
          & ((g.sum_sales - g.avg_monthly_sales).abs()
             / g.avg_monthly_sales > 0.1)]
    g = g.assign(delta=g.sum_sales - g.avg_monthly_sales)
    g = (g.sort_values(["delta", "s_store_name"] + _Q89_KEYS + ["d_moy"])
         .head(100).reset_index(drop=True))
    return g[_Q89_KEYS + ["d_moy", "sum_sales", "avg_monthly_sales"]]


_Q98_KEYS = ["i_item_id", "i_item_desc", "i_category", "i_class",
             "i_current_price"]


def q98_pandas(t: Dict[str, "object"]):
    i = t["item"]
    it = i[i.i_category.isin(["Sports", "Books", "Home"])][
        ["i_item_sk"] + _Q98_KEYS]
    d = t["date_dim"]
    dt = d[(d.d_year == 2000) & (d.d_moy == 5)][["d_date_sk"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    g = (j.groupby(_Q98_KEYS)
         .agg(itemrevenue=("ss_ext_sales_price", "sum")).reset_index())
    g["revenueratio"] = (g.itemrevenue * 100.0
                         / g.groupby("i_class")["itemrevenue"]
                         .transform("sum"))
    return (g[_Q98_KEYS + ["itemrevenue", "revenueratio"]]
            .sort_values(["i_category", "i_class", "i_item_id",
                          "i_item_desc", "revenueratio", "itemrevenue"])
            .reset_index(drop=True))


def q65_pandas(t: Dict[str, "object"]):
    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk"]]
    inner = (t["store_sales"]
             .merge(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
             .groupby(["ss_store_sk", "ss_item_sk"])
             .agg(revenue=("ss_sales_price", "sum")).reset_index())
    sb = (inner.groupby("ss_store_sk")
          .agg(ave=("revenue", "mean")).reset_index())
    j = inner.merge(sb, on="ss_store_sk")
    j = j[j.revenue <= 0.1 * j.ave]
    j = j.merge(t["store"][["s_store_sk", "s_store_name"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_desc", "i_current_price",
                           "i_wholesale_cost", "i_brand"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    return (j[["s_store_name", "i_item_desc", "revenue",
               "i_current_price", "i_wholesale_cost", "i_brand"]]
            .sort_values(["s_store_name", "i_item_desc", "revenue"])
            .head(100).reset_index(drop=True))


_Q67_ROLLUP = (("i_category", "string"), ("i_class", "string"),
               ("i_brand", "string"), ("i_product_name", "string"),
               ("d_year", "int64"), ("d_qoy", "int64"), ("d_moy", "int64"),
               ("s_store_id", "string"))


def q67_pandas(t: Dict[str, "object"]):
    import numpy as np
    import pandas as pd

    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk", "d_year", "d_qoy", "d_moy"]]
    j = t["store_sales"].merge(dt, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", "s_store_id"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"][["i_item_sk", "i_category", "i_class", "i_brand",
                           "i_product_name"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    j = j.assign(_sales=j.ss_sales_price * j.ss_quantity)
    names = [name for name, _ in _Q67_ROLLUP]
    parts = []
    for depth in range(len(names), -1, -1):
        keep = names[:depth]
        if keep:
            g = (j.groupby(keep).agg(sumsales=("_sales", "sum"))
                 .reset_index())
        else:
            g = pd.DataFrame({"sumsales": [j._sales.sum()]})
        for name in names[depth:]:
            g[name] = np.nan
        parts.append(g[names + ["sumsales"]])
    u = pd.concat(parts, ignore_index=True)
    u["rk"] = (u.groupby("i_category", dropna=False)["sumsales"]
               .rank(method="min", ascending=False).astype("int64"))
    u = u[u.rk <= 100]
    # Engine Sort is ascending nulls-FIRST; mirror it for the limit.
    u = u.sort_values(names + ["sumsales", "rk"], na_position="first")
    return u.head(100).reset_index(drop=True)


def q29_pandas(t):
    d = t["date_dim"]
    d1 = d[(d.d_moy == 9) & (d.d_year == 1999)][["d_date_sk"]]
    d2 = d[(d.d_moy >= 9) & (d.d_moy <= 12)
           & (d.d_year == 1999)][["d_date_sk"]]
    d3 = d[d.d_year.isin([1999, 2000, 2001])][["d_date_sk"]]
    j = t["store_sales"].merge(
        t["store_returns"],
        left_on=["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
        right_on=["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
    j = j.merge(t["catalog_sales"],
                left_on=["sr_customer_sk", "sr_item_sk"],
                right_on=["cs_bill_customer_sk", "cs_item_sk"])
    j = j.merge(d1, left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.merge(d2, left_on="sr_returned_date_sk", right_on="d_date_sk")
    j = j.merge(d3, left_on="cs_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", "s_store_id", "s_store_name"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_id", "i_item_desc"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["i_item_id", "i_item_desc", "s_store_id",
                   "s_store_name"], as_index=False).agg(
        store_sales_quantity=("ss_quantity", "sum"),
        store_returns_quantity=("sr_return_quantity", "sum"),
        catalog_sales_quantity=("cs_quantity", "sum"))
    return (g.sort_values(["i_item_id", "i_item_desc", "s_store_id",
                           "s_store_name"])
            .head(100).reset_index(drop=True))


ORACLES = {
    "q3": q3_pandas,
    "q7": q7_pandas,
    "q13": q13_pandas,
    "q17": q17_pandas,
    "q19": q19_pandas,
    "q25": q25_pandas,
    "q29": q29_pandas,
    "q42": q42_pandas,
    "q43": q43_pandas,
    "q48": q48_pandas,
    "q50": q50_pandas,
    "q52": q52_pandas,
    "q53": q53_pandas,
    "q55": q55_pandas,
    "q63": q63_pandas,
    "q64": q64_pandas,
    "q65": q65_pandas,
    "q67": q67_pandas,
    "q68": q68_pandas,
    "q79": q79_pandas,
    "q89": q89_pandas,
    "q98": q98_pandas,
}
