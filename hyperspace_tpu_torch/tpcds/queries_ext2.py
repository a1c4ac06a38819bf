"""Round-5 TPC-DS additions: the web channel, inventory, set-operation
and scalar-subquery families — closing the reference serde's
all-TPC-DS-serializable property (`index/serde/package.scala:46-49`) at
the ENGINE level: every query here executes end to end three ways
(rules on / rules off / pandas oracle) like the rest of the suite.

Shapes follow the official queries with this generator's parameter
choices (years 1999-2001 carry the sales mass; dimension values follow
`generator.py`'s vocabularies). Idioms covered beyond the round-4 set:
UNION-of-channels re-aggregation (q2/q33/q56/q60/q71/q83), year-over-year
self-joins on week/quarter sequences (q2/q31/q59), growth-ratio
cross-channel comparisons (q11/q74), INTERSECT/EXCEPT customer overlap
(q8/q38/q87), scalar subqueries (q54/q58/q92), inventory before/after
pivots (q21/q22/q37/q39/q82), rank windows over aggregates (q44/q49/q86),
ship-lag CASE pivots (q62/q99), and EXISTS/NOT-EXISTS channel probes
(q35/q69/q94/q16)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from hyperspace_tpu_torch.plan.expr import CaseWhen, col, lit
from hyperspace_tpu_torch.tpcds.queries_ext import _rollup_union


def _sum_case(cond, value, alias):
    return ("sum", CaseWhen([(cond, value)]), alias)


# ---------------------------------------------------------------------------
# q2 — ws+cs weekly sums, year-over-year by week_seq offset
# ---------------------------------------------------------------------------


_DAYS = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
         "Saturday"]


def q2(dfs):
    ws = dfs["web_sales"].select(
        col("ws_sold_date_sk").alias("sold_date_sk"),
        col("ws_ext_sales_price").alias("sales_price"))
    cs = dfs["catalog_sales"].select(
        col("cs_sold_date_sk").alias("sold_date_sk"),
        col("cs_ext_sales_price").alias("sales_price"))
    wscs = ws.union(cs)
    d = dfs["date_dim"].select("d_date_sk", "d_week_seq", "d_day_name",
                               "d_year")
    j = wscs.join(d, on=col("sold_date_sk") == col("d_date_sk"))
    aggs = [_sum_case(col("d_day_name") == lit(day), col("sales_price"),
                      day[:3].lower() + "_sales")
            for day in _DAYS]
    y1 = (j.filter(col("d_year") == lit(1999)).group_by("d_week_seq")
          .agg(*aggs))
    y2 = (j.filter(col("d_year") == lit(2000)).group_by("d_week_seq")
          .agg(*aggs))
    y2 = y2.select(*[col(c).alias(c + "2") for c in y2.columns])
    y2 = y2.with_column("wk_join", col("d_week_seq2") - lit(52))
    jj = y1.join(y2, on=col("d_week_seq") == col("wk_join"))
    out = jj.select(
        "d_week_seq",
        *[(col(day[:3].lower() + "_sales")
           / col(day[:3].lower() + "_sales2")).alias(
               "r_" + day[:3].lower()) for day in _DAYS])
    return out.sort("d_week_seq").limit(100)


def q2_pandas(t):
    ws = t["web_sales"][["ws_sold_date_sk", "ws_ext_sales_price"]].rename(
        columns={"ws_sold_date_sk": "sold_date_sk",
                 "ws_ext_sales_price": "sales_price"})
    cs = t["catalog_sales"][
        ["cs_sold_date_sk", "cs_ext_sales_price"]].rename(
        columns={"cs_sold_date_sk": "sold_date_sk",
                 "cs_ext_sales_price": "sales_price"})
    wscs = pd.concat([ws, cs], ignore_index=True)
    j = wscs.merge(t["date_dim"][["d_date_sk", "d_week_seq", "d_day_name",
                                  "d_year"]],
                   left_on="sold_date_sk", right_on="d_date_sk")

    def pivot(frame):
        g = (frame.groupby(["d_week_seq", "d_day_name"])["sales_price"]
             .sum().unstack("d_day_name"))
        out = pd.DataFrame(index=g.index)
        for day in _DAYS:
            out[day[:3].lower() + "_sales"] = (g[day] if day in g.columns
                                               else float("nan"))
        return out.reset_index()

    y1 = pivot(j[j.d_year == 1999])
    y2 = pivot(j[j.d_year == 2000])
    y2 = y2.rename(columns={c: c + "2" for c in y2.columns})
    jj = y1.merge(y2, left_on=y1.d_week_seq,
                  right_on=y2.d_week_seq2 - 52)
    out = pd.DataFrame({"d_week_seq": jj.d_week_seq})
    for day in _DAYS:
        k = day[:3].lower()
        out["r_" + k] = jj[k + "_sales"] / jj[k + "_sales2"]
    return out.sort_values("d_week_seq").head(100).reset_index(drop=True)


# ---------------------------------------------------------------------------
# q11 / q74 — cross-channel (store vs web) customer growth ratios
# ---------------------------------------------------------------------------


def _year_total(dfs, fact, cust_col, date_col, price_col, year, alias):
    f = dfs[fact].select(cust_col, date_col, price_col)
    d = (dfs["date_dim"].filter(col("d_year") == lit(year))
         .select("d_date_sk"))
    j = f.join(d, on=col(date_col) == col("d_date_sk"))
    return (j.group_by(cust_col)
            .agg(("sum", price_col, alias))
            .select(col(cust_col).alias(alias + "_cust"), alias))


def q11(dfs):
    s1 = _year_total(dfs, "store_sales", "ss_customer_sk",
                     "ss_sold_date_sk", "ss_ext_list_price", 1999, "ss1")
    s2 = _year_total(dfs, "store_sales", "ss_customer_sk",
                     "ss_sold_date_sk", "ss_ext_list_price", 2000, "ss2")
    w1 = _year_total(dfs, "web_sales", "ws_bill_customer_sk",
                     "ws_sold_date_sk", "ws_ext_list_price", 1999, "ws1")
    w2 = _year_total(dfs, "web_sales", "ws_bill_customer_sk",
                     "ws_sold_date_sk", "ws_ext_list_price", 2000, "ws2")
    j = s1.join(s2, on=col("ss1_cust") == col("ss2_cust"))
    j = j.join(w1, on=col("ss1_cust") == col("ws1_cust"))
    j = j.join(w2, on=col("ss1_cust") == col("ws2_cust"))
    j = j.filter((col("ss1") > lit(0)) & (col("ws1") > lit(0)))
    j = j.filter(col("ws2") / col("ws1") > col("ss2") / col("ss1"))
    c = dfs["customer"].select("c_customer_sk", "c_customer_id",
                               "c_first_name", "c_last_name",
                               "c_preferred_cust_flag")
    j = j.join(c, on=col("ss1_cust") == col("c_customer_sk"))
    return (j.select("c_customer_id", "c_first_name", "c_last_name",
                     "c_preferred_cust_flag")
            .sort("c_customer_id", "c_first_name", "c_last_name",
                  "c_preferred_cust_flag").limit(100))


def _year_total_pd(t, fact, cust_col, date_col, price_col, year, alias):
    d = t["date_dim"]
    dd = d[d.d_year == year][["d_date_sk"]]
    j = t[fact][[cust_col, date_col, price_col]].merge(
        dd, left_on=date_col, right_on="d_date_sk")
    g = j.groupby(cust_col, as_index=False)[price_col].sum()
    return g.rename(columns={cust_col: alias + "_cust", price_col: alias})


def q11_pandas(t):
    s1 = _year_total_pd(t, "store_sales", "ss_customer_sk",
                        "ss_sold_date_sk", "ss_ext_list_price", 1999, "ss1")
    s2 = _year_total_pd(t, "store_sales", "ss_customer_sk",
                        "ss_sold_date_sk", "ss_ext_list_price", 2000, "ss2")
    w1 = _year_total_pd(t, "web_sales", "ws_bill_customer_sk",
                        "ws_sold_date_sk", "ws_ext_list_price", 1999, "ws1")
    w2 = _year_total_pd(t, "web_sales", "ws_bill_customer_sk",
                        "ws_sold_date_sk", "ws_ext_list_price", 2000, "ws2")
    j = s1.merge(s2, left_on="ss1_cust", right_on="ss2_cust")
    j = j.merge(w1, left_on="ss1_cust", right_on="ws1_cust")
    j = j.merge(w2, left_on="ss1_cust", right_on="ws2_cust")
    j = j[(j.ss1 > 0) & (j.ws1 > 0)]
    j = j[j.ws2 / j.ws1 > j.ss2 / j.ss1]
    j = j.merge(t["customer"][["c_customer_sk", "c_customer_id",
                               "c_first_name", "c_last_name",
                               "c_preferred_cust_flag"]],
                left_on="ss1_cust", right_on="c_customer_sk")
    return (j[["c_customer_id", "c_first_name", "c_last_name",
               "c_preferred_cust_flag"]]
            .sort_values(["c_customer_id", "c_first_name", "c_last_name",
                          "c_preferred_cust_flag"])
            .head(100).reset_index(drop=True))


def q74(dfs):
    """q11's sibling: quantity-based totals, AVG instead of SUM."""
    s1 = _year_total(dfs, "store_sales", "ss_customer_sk",
                     "ss_sold_date_sk", "ss_net_profit", 1999, "ss1")
    s2 = _year_total(dfs, "store_sales", "ss_customer_sk",
                     "ss_sold_date_sk", "ss_net_profit", 2000, "ss2")
    w1 = _year_total(dfs, "web_sales", "ws_bill_customer_sk",
                     "ws_sold_date_sk", "ws_net_profit", 1999, "ws1")
    w2 = _year_total(dfs, "web_sales", "ws_bill_customer_sk",
                     "ws_sold_date_sk", "ws_net_profit", 2000, "ws2")
    j = s1.join(s2, on=col("ss1_cust") == col("ss2_cust"))
    j = j.join(w1, on=col("ss1_cust") == col("ws1_cust"))
    j = j.join(w2, on=col("ss1_cust") == col("ws2_cust"))
    j = j.filter((col("ss1") > lit(0)) & (col("ws1") > lit(0)))
    j = j.filter(col("ws2") / col("ws1") > col("ss2") / col("ss1"))
    c = dfs["customer"].select("c_customer_sk", "c_customer_id",
                               "c_first_name", "c_last_name")
    j = j.join(c, on=col("ss1_cust") == col("c_customer_sk"))
    return (j.select("c_customer_id", "c_first_name", "c_last_name")
            .sort("c_customer_id", "c_first_name", "c_last_name")
            .limit(100))


def q74_pandas(t):
    s1 = _year_total_pd(t, "store_sales", "ss_customer_sk",
                        "ss_sold_date_sk", "ss_net_profit", 1999, "ss1")
    s2 = _year_total_pd(t, "store_sales", "ss_customer_sk",
                        "ss_sold_date_sk", "ss_net_profit", 2000, "ss2")
    w1 = _year_total_pd(t, "web_sales", "ws_bill_customer_sk",
                        "ws_sold_date_sk", "ws_net_profit", 1999, "ws1")
    w2 = _year_total_pd(t, "web_sales", "ws_bill_customer_sk",
                        "ws_sold_date_sk", "ws_net_profit", 2000, "ws2")
    j = s1.merge(s2, left_on="ss1_cust", right_on="ss2_cust")
    j = j.merge(w1, left_on="ss1_cust", right_on="ws1_cust")
    j = j.merge(w2, left_on="ss1_cust", right_on="ws2_cust")
    j = j[(j.ss1 > 0) & (j.ws1 > 0)]
    j = j[j.ws2 / j.ws1 > j.ss2 / j.ss1]
    j = j.merge(t["customer"][["c_customer_sk", "c_customer_id",
                               "c_first_name", "c_last_name"]],
                left_on="ss1_cust", right_on="c_customer_sk")
    return (j[["c_customer_id", "c_first_name", "c_last_name"]]
            .sort_values(["c_customer_id", "c_first_name", "c_last_name"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q12 — web revenue share within class (window sum over partition)
# ---------------------------------------------------------------------------


def q12(dfs):
    ws = dfs["web_sales"].select("ws_item_sk", "ws_sold_date_sk",
                                 "ws_ext_sales_price")
    it = (dfs["item"].filter(col("i_category").isin(
        "Books", "Home", "Sports"))
        .select("i_item_sk", "i_item_id", "i_item_desc", "i_category",
                "i_class", "i_current_price"))
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_moy") == lit(2)))
         .select("d_date_sk"))
    j = ws.join(it, on=col("ws_item_sk") == col("i_item_sk"))
    j = j.join(d, on=col("ws_sold_date_sk") == col("d_date_sk"))
    g = (j.group_by("i_item_id", "i_item_desc", "i_category", "i_class",
                    "i_current_price")
         .agg(("sum", "ws_ext_sales_price", "itemrevenue")))
    w = g.window(["i_class"], revenue_class=("sum", "itemrevenue"))
    out = w.select(
        "i_item_id", "i_item_desc", "i_category", "i_class",
        "i_current_price", "itemrevenue",
        (col("itemrevenue") * lit(100.0)
         / col("revenue_class")).alias("revenueratio"))
    return out.sort("i_category", "i_class", "i_item_id", "i_item_desc",
                    "revenueratio").limit(100)


def q12_pandas(t):
    it = t["item"]
    it = it[it.i_category.isin(["Books", "Home", "Sports"])][
        ["i_item_sk", "i_item_id", "i_item_desc", "i_category", "i_class",
         "i_current_price"]]
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy == 2)][["d_date_sk"]]
    j = t["web_sales"][["ws_item_sk", "ws_sold_date_sk",
                        "ws_ext_sales_price"]].merge(
        it, left_on="ws_item_sk", right_on="i_item_sk")
    j = j.merge(dd, left_on="ws_sold_date_sk", right_on="d_date_sk")
    g = j.groupby(["i_item_id", "i_item_desc", "i_category", "i_class",
                   "i_current_price"], as_index=False).agg(
        itemrevenue=("ws_ext_sales_price", "sum"))
    g["revenueratio"] = (g.itemrevenue * 100.0
                         / g.groupby("i_class").itemrevenue.transform(
                             "sum"))
    return (g.sort_values(["i_category", "i_class", "i_item_id",
                           "i_item_desc", "revenueratio"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q18 — catalog buyer demographics, 4-level ROLLUP of averages
# ---------------------------------------------------------------------------


def q18(dfs):
    cd1 = (dfs["customer_demographics"]
           .filter((col("cd_gender") == lit("F"))
                   & (col("cd_education_status") == lit("Unknown")))
           .select("cd_demo_sk"))
    cd2 = dfs["customer_demographics"].select(
        col("cd_demo_sk").alias("cd2_demo_sk"),
        col("cd_dep_count").alias("cd2_dep_count"))
    c = (dfs["customer"].filter(col("c_birth_month").isin(1, 6, 8, 9))
         .select("c_customer_sk", "c_current_cdemo_sk",
                 "c_current_addr_sk", "c_birth_year"))
    ca = dfs["customer_address"].select("ca_address_sk", "ca_country",
                                        "ca_state", "ca_county")
    d = (dfs["date_dim"].filter(col("d_year") == lit(2000))
         .select("d_date_sk"))
    it = dfs["item"].select("i_item_sk", "i_item_id")
    cs = dfs["catalog_sales"].select(
        "cs_sold_date_sk", "cs_item_sk", "cs_bill_cdemo_sk",
        "cs_bill_customer_sk", "cs_quantity", "cs_list_price",
        "cs_coupon_amt", "cs_sales_price", "cs_net_profit")
    j = cs.join(cd1, on=col("cs_bill_cdemo_sk") == col("cd_demo_sk"))
    j = j.join(c, on=col("cs_bill_customer_sk") == col("c_customer_sk"))
    j = j.join(cd2, on=col("c_current_cdemo_sk") == col("cd2_demo_sk"))
    j = j.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"))
    j = j.join(d, on=col("cs_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("cs_item_sk") == col("i_item_sk"))
    u = _rollup_union(
        j, [("i_item_id", "string"), ("ca_country", "string"),
            ("ca_state", "string"), ("ca_county", "string")],
        {"agg1": ("avg", "cs_quantity"),
         "agg2": ("avg", "cs_list_price"),
         "agg3": ("avg", "cs_coupon_amt"),
         "agg4": ("avg", "cs_sales_price"),
         "agg5": ("avg", "cs_net_profit"),
         "agg6": ("avg", "c_birth_year"),
         "agg7": ("avg", "cd2_dep_count")}, j.session)
    return (u.select("i_item_id", "ca_country", "ca_state", "ca_county",
                     "agg1", "agg2", "agg3", "agg4", "agg5", "agg6",
                     "agg7")
            .sort("ca_country", "ca_state", "ca_county", "i_item_id")
            .limit(100))


def q18_pandas(t):
    cd = t["customer_demographics"]
    cd1 = cd[(cd.cd_gender == "F")
             & (cd.cd_education_status == "Unknown")][["cd_demo_sk"]]
    cd2 = cd[["cd_demo_sk", "cd_dep_count"]].rename(
        columns={"cd_demo_sk": "cd2_demo_sk",
                 "cd_dep_count": "cd2_dep_count"})
    c = t["customer"]
    c = c[c.c_birth_month.isin([1, 6, 8, 9])][
        ["c_customer_sk", "c_current_cdemo_sk", "c_current_addr_sk",
         "c_birth_year"]]
    d = t["date_dim"]
    dd = d[d.d_year == 2000][["d_date_sk"]]
    j = t["catalog_sales"].merge(cd1, left_on="cs_bill_cdemo_sk",
                                 right_on="cd_demo_sk")
    j = j.merge(c, left_on="cs_bill_customer_sk", right_on="c_customer_sk")
    j = j.merge(cd2, left_on="c_current_cdemo_sk", right_on="cd2_demo_sk")
    j = j.merge(t["customer_address"][["ca_address_sk", "ca_country",
                                       "ca_state", "ca_county"]],
                left_on="c_current_addr_sk", right_on="ca_address_sk")
    j = j.merge(dd, left_on="cs_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_id"]],
                left_on="cs_item_sk", right_on="i_item_sk")
    measures = {"agg1": "cs_quantity", "agg2": "cs_list_price",
                "agg3": "cs_coupon_amt", "agg4": "cs_sales_price",
                "agg5": "cs_net_profit", "agg6": "c_birth_year",
                "agg7": "cd2_dep_count"}
    levels = ["i_item_id", "ca_country", "ca_state", "ca_county"]
    outs = []
    for depth in range(len(levels), -1, -1):
        keys = levels[:depth]
        if keys:
            g = j.groupby(keys, as_index=False).agg(
                **{a: (src, "mean") for a, src in measures.items()})
        else:
            g = pd.DataFrame({a: [j[src].mean()]
                              for a, src in measures.items()})
        for name in levels:
            if name not in g.columns:
                g[name] = np.nan
        outs.append(g[levels + list(measures)])
    u = pd.concat(outs, ignore_index=True)
    # Engine ascending sort is nulls-FIRST; the rollup's subtotal rows
    # carry null keys, so the limit must cut the same rows.
    return (u.sort_values(["ca_country", "ca_state", "ca_county",
                           "i_item_id"], na_position="first")
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q30 — web returners above 1.2x their state's average return
# ---------------------------------------------------------------------------


def q30(dfs):
    wr = dfs["web_returns"].select("wr_returning_customer_sk",
                                   "wr_returned_date_sk",
                                   "wr_refunded_addr_sk", "wr_return_amt")
    d = (dfs["date_dim"].filter(col("d_year") == lit(2000))
         .select("d_date_sk"))
    ca = dfs["customer_address"].select("ca_address_sk", "ca_state")
    j = wr.join(d, on=col("wr_returned_date_sk") == col("d_date_sk"))
    j = j.join(ca, on=col("wr_refunded_addr_sk") == col("ca_address_sk"))
    ctr = (j.group_by("wr_returning_customer_sk", "ca_state")
           .agg(("sum", "wr_return_amt", "ctr_total_return")))
    avg_state = (ctr.group_by("ca_state")
                 .agg(("avg", "ctr_total_return", "state_avg"))
                 .select(col("ca_state").alias("avg_state"), "state_avg"))
    jj = ctr.join(avg_state, on=col("ca_state") == col("avg_state"))
    jj = jj.filter(col("ctr_total_return")
                   > col("state_avg") * lit(1.2))
    c = dfs["customer"].select("c_customer_sk", "c_customer_id",
                               "c_salutation", "c_first_name",
                               "c_last_name", "c_preferred_cust_flag",
                               "c_birth_month")
    jj = jj.join(c, on=col("wr_returning_customer_sk")
                 == col("c_customer_sk"))
    return (jj.select("c_customer_id", "c_salutation", "c_first_name",
                      "c_last_name", "c_preferred_cust_flag",
                      "c_birth_month", "ctr_total_return")
            .sort("c_customer_id", "c_salutation", "c_first_name",
                  "c_last_name", "c_preferred_cust_flag", "c_birth_month",
                  "ctr_total_return").limit(100))


def q30_pandas(t):
    d = t["date_dim"]
    dd = d[d.d_year == 2000][["d_date_sk"]]
    j = t["web_returns"].merge(dd, left_on="wr_returned_date_sk",
                               right_on="d_date_sk")
    j = j.merge(t["customer_address"][["ca_address_sk", "ca_state"]],
                left_on="wr_refunded_addr_sk", right_on="ca_address_sk")
    ctr = j.groupby(["wr_returning_customer_sk", "ca_state"],
                    as_index=False).agg(
        ctr_total_return=("wr_return_amt", "sum"))
    avg_state = ctr.groupby("ca_state", as_index=False).agg(
        state_avg=("ctr_total_return", "mean"))
    jj = ctr.merge(avg_state, on="ca_state")
    jj = jj[jj.ctr_total_return > jj.state_avg * 1.2]
    jj = jj.merge(t["customer"][["c_customer_sk", "c_customer_id",
                                 "c_salutation", "c_first_name",
                                 "c_last_name", "c_preferred_cust_flag",
                                 "c_birth_month"]],
                  left_on="wr_returning_customer_sk",
                  right_on="c_customer_sk")
    return (jj[["c_customer_id", "c_salutation", "c_first_name",
                "c_last_name", "c_preferred_cust_flag", "c_birth_month",
                "ctr_total_return"]]
            .sort_values(["c_customer_id", "c_salutation", "c_first_name",
                          "c_last_name", "c_preferred_cust_flag",
                          "c_birth_month", "ctr_total_return"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q31 — county quarterly growth: web outpacing store
# ---------------------------------------------------------------------------


def _county_q(dfs, fact, addr_col, date_col, price_col, qoy, alias):
    f = dfs[fact].select(addr_col, date_col, price_col)
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_qoy") == lit(qoy)))
         .select("d_date_sk"))
    ca = dfs["customer_address"].select("ca_address_sk", "ca_county")
    j = f.join(d, on=col(date_col) == col("d_date_sk"))
    j = j.join(ca, on=col(addr_col) == col("ca_address_sk"))
    return (j.group_by("ca_county").agg(("sum", price_col, alias))
            .select(col("ca_county").alias(alias + "_cty"), alias))


def q31(dfs):
    ss1 = _county_q(dfs, "store_sales", "ss_addr_sk", "ss_sold_date_sk",
                    "ss_ext_sales_price", 1, "ss1")
    ss2 = _county_q(dfs, "store_sales", "ss_addr_sk", "ss_sold_date_sk",
                    "ss_ext_sales_price", 2, "ss2")
    ss3 = _county_q(dfs, "store_sales", "ss_addr_sk", "ss_sold_date_sk",
                    "ss_ext_sales_price", 3, "ss3")
    ws1 = _county_q(dfs, "web_sales", "ws_bill_addr_sk",
                    "ws_sold_date_sk", "ws_ext_sales_price", 1, "ws1")
    ws2 = _county_q(dfs, "web_sales", "ws_bill_addr_sk",
                    "ws_sold_date_sk", "ws_ext_sales_price", 2, "ws2")
    ws3 = _county_q(dfs, "web_sales", "ws_bill_addr_sk",
                    "ws_sold_date_sk", "ws_ext_sales_price", 3, "ws3")
    j = ss1.join(ss2, on=col("ss1_cty") == col("ss2_cty"))
    j = j.join(ss3, on=col("ss1_cty") == col("ss3_cty"))
    j = j.join(ws1, on=col("ss1_cty") == col("ws1_cty"))
    j = j.join(ws2, on=col("ss1_cty") == col("ws2_cty"))
    j = j.join(ws3, on=col("ss1_cty") == col("ws3_cty"))
    j = j.filter((col("ss1") > lit(0)) & (col("ss2") > lit(0))
                 & (col("ws1") > lit(0)) & (col("ws2") > lit(0)))
    # One growth comparison (official ANDs q2->q3 as well; with this
    # generator's four counties that conjunction can select zero rows).
    j = j.filter(col("ws2") / col("ws1") > col("ss2") / col("ss1"))
    return (j.select(col("ss1_cty").alias("ca_county"),
                     (col("ws2") / col("ws1")).alias("web_q1_q2"),
                     (col("ss2") / col("ss1")).alias("store_q1_q2"),
                     (col("ws3") / col("ws2")).alias("web_q2_q3"),
                     (col("ss3") / col("ss2")).alias("store_q2_q3"))
            .sort("ca_county"))


def _county_q_pd(t, fact, addr_col, date_col, price_col, qoy, alias):
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_qoy == qoy)][["d_date_sk"]]
    j = t[fact][[addr_col, date_col, price_col]].merge(
        dd, left_on=date_col, right_on="d_date_sk")
    j = j.merge(t["customer_address"][["ca_address_sk", "ca_county"]],
                left_on=addr_col, right_on="ca_address_sk")
    g = j.groupby("ca_county", as_index=False)[price_col].sum()
    return g.rename(columns={"ca_county": alias + "_cty",
                             price_col: alias})


def q31_pandas(t):
    ss1 = _county_q_pd(t, "store_sales", "ss_addr_sk", "ss_sold_date_sk",
                       "ss_ext_sales_price", 1, "ss1")
    ss2 = _county_q_pd(t, "store_sales", "ss_addr_sk", "ss_sold_date_sk",
                       "ss_ext_sales_price", 2, "ss2")
    ss3 = _county_q_pd(t, "store_sales", "ss_addr_sk", "ss_sold_date_sk",
                       "ss_ext_sales_price", 3, "ss3")
    ws1 = _county_q_pd(t, "web_sales", "ws_bill_addr_sk",
                       "ws_sold_date_sk", "ws_ext_sales_price", 1, "ws1")
    ws2 = _county_q_pd(t, "web_sales", "ws_bill_addr_sk",
                       "ws_sold_date_sk", "ws_ext_sales_price", 2, "ws2")
    ws3 = _county_q_pd(t, "web_sales", "ws_bill_addr_sk",
                       "ws_sold_date_sk", "ws_ext_sales_price", 3, "ws3")
    j = ss1.merge(ss2, left_on="ss1_cty", right_on="ss2_cty")
    j = j.merge(ss3, left_on="ss1_cty", right_on="ss3_cty")
    j = j.merge(ws1, left_on="ss1_cty", right_on="ws1_cty")
    j = j.merge(ws2, left_on="ss1_cty", right_on="ws2_cty")
    j = j.merge(ws3, left_on="ss1_cty", right_on="ws3_cty")
    j = j[(j.ss1 > 0) & (j.ss2 > 0) & (j.ws1 > 0) & (j.ws2 > 0)]
    j = j[j.ws2 / j.ws1 > j.ss2 / j.ss1]
    out = pd.DataFrame({
        "ca_county": j.ss1_cty,
        "web_q1_q2": j.ws2 / j.ws1, "store_q1_q2": j.ss2 / j.ss1,
        "web_q2_q3": j.ws3 / j.ws2, "store_q2_q3": j.ss3 / j.ss2})
    return out.sort_values("ca_county").reset_index(drop=True)


# ---------------------------------------------------------------------------
# q33 — 3-channel manufacturer revenue for one category/month/gmt
# ---------------------------------------------------------------------------


def _q33_channel(dfs, fact, item_col, date_col, addr_col, price_col):
    manufact = (dfs["item"].filter(col("i_category") == lit("Books"))
                .select("i_manufact_id").distinct())
    it = dfs["item"].select("i_item_sk",
                            col("i_manufact_id").alias("manu"))
    it = it.join(manufact, on=col("manu") == col("i_manufact_id"),
                 how="left_semi")
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_moy") == lit(5)))
         .select("d_date_sk"))
    ca = (dfs["customer_address"].filter(col("ca_gmt_offset")
                                         == lit(-5.0))
          .select("ca_address_sk"))
    f = dfs[fact].select(item_col, date_col, addr_col, price_col)
    j = f.join(d, on=col(date_col) == col("d_date_sk"))
    j = j.join(ca, on=col(addr_col) == col("ca_address_sk"))
    j = j.join(it, on=col(item_col) == col("i_item_sk"))
    return (j.group_by("manu")
            .agg(("sum", price_col, "total_sales"))
            .select("manu", "total_sales"))


def q33(dfs):
    ss = _q33_channel(dfs, "store_sales", "ss_item_sk",
                      "ss_sold_date_sk", "ss_addr_sk",
                      "ss_ext_sales_price")
    cs = _q33_channel(dfs, "catalog_sales", "cs_item_sk",
                      "cs_sold_date_sk", "cs_bill_addr_sk",
                      "cs_ext_sales_price")
    ws = _q33_channel(dfs, "web_sales", "ws_item_sk", "ws_sold_date_sk",
                      "ws_bill_addr_sk", "ws_ext_sales_price")
    u = ss.union(cs).union(ws)
    return (u.group_by("manu").agg(("sum", "total_sales", "total_sales"))
            .sort("total_sales", "manu").limit(100))


def _q33_channel_pd(t, fact, item_col, date_col, addr_col, price_col):
    it = t["item"]
    manu = it[it.i_category == "Books"].i_manufact_id.unique()
    itt = it[it.i_manufact_id.isin(manu)][["i_item_sk", "i_manufact_id"]]
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy == 5)][["d_date_sk"]]
    ca = t["customer_address"]
    caa = ca[ca.ca_gmt_offset == -5.0][["ca_address_sk"]]
    j = t[fact][[item_col, date_col, addr_col, price_col]].merge(
        dd, left_on=date_col, right_on="d_date_sk")
    j = j.merge(caa, left_on=addr_col, right_on="ca_address_sk")
    j = j.merge(itt, left_on=item_col, right_on="i_item_sk")
    g = j.groupby("i_manufact_id", as_index=False)[price_col].sum()
    return g.rename(columns={"i_manufact_id": "manu",
                             price_col: "total_sales"})


def q33_pandas(t):
    u = pd.concat([
        _q33_channel_pd(t, "store_sales", "ss_item_sk", "ss_sold_date_sk",
                        "ss_addr_sk", "ss_ext_sales_price"),
        _q33_channel_pd(t, "catalog_sales", "cs_item_sk",
                        "cs_sold_date_sk", "cs_bill_addr_sk",
                        "cs_ext_sales_price"),
        _q33_channel_pd(t, "web_sales", "ws_item_sk", "ws_sold_date_sk",
                        "ws_bill_addr_sk", "ws_ext_sales_price")],
        ignore_index=True)
    g = u.groupby("manu", as_index=False).total_sales.sum()
    return (g.sort_values(["total_sales", "manu"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q59 — store weekly sales, this year vs 52 weeks later
# ---------------------------------------------------------------------------


_WEEKDAYS = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]


def q59(dfs):
    ss = dfs["store_sales"].select("ss_store_sk", "ss_sold_date_sk",
                                   "ss_sales_price")
    d = dfs["date_dim"].select("d_date_sk", "d_week_seq", "d_day_name")
    j = ss.join(d, on=col("ss_sold_date_sk") == col("d_date_sk"))
    aggs = [_sum_case(col("d_day_name") == lit(day),
                      col("ss_sales_price"),
                      day[:3].lower() + "_sales")
            for day in _WEEKDAYS]
    wss = j.group_by("d_week_seq", "ss_store_sk").agg(*aggs)
    st = dfs["store"].select("s_store_sk", "s_store_id", "s_store_name")
    # Year 1: weeks 53..104 (1999); year 2: +52.
    y1 = (wss.filter((col("d_week_seq") >= lit(53))
                     & (col("d_week_seq") <= lit(104)))
          .join(st, on=col("ss_store_sk") == col("s_store_sk")))
    y2 = wss.filter((col("d_week_seq") >= lit(105))
                    & (col("d_week_seq") <= lit(156)))
    y2 = y2.select(col("d_week_seq").alias("wk2"),
                   col("ss_store_sk").alias("store2"),
                   *[col(day[:3].lower() + "_sales").alias(
                       day[:3].lower() + "_sales2")
                     for day in _WEEKDAYS])
    y2 = y2.with_column("wk_join", col("wk2") - lit(52))
    jj = y1.join(y2, on=(col("ss_store_sk") == col("store2"))
                 & (col("d_week_seq") == col("wk_join")))
    out = jj.select(
        "s_store_name", "s_store_id", "d_week_seq",
        *[(col(day[:3].lower() + "_sales")
           / col(day[:3].lower() + "_sales2")).alias(
               "r_" + day[:3].lower()) for day in _WEEKDAYS])
    return (out.sort("s_store_name", "s_store_id", "d_week_seq")
            .limit(100))


def q59_pandas(t):
    j = t["store_sales"][["ss_store_sk", "ss_sold_date_sk",
                          "ss_sales_price"]].merge(
        t["date_dim"][["d_date_sk", "d_week_seq", "d_day_name"]],
        left_on="ss_sold_date_sk", right_on="d_date_sk")
    g = (j.groupby(["d_week_seq", "ss_store_sk", "d_day_name"])
         ["ss_sales_price"].sum().unstack("d_day_name"))
    wss = pd.DataFrame(index=g.index)
    for day in _WEEKDAYS:
        wss[day[:3].lower() + "_sales"] = (g[day] if day in g.columns
                                           else float("nan"))
    wss = wss.reset_index()
    st = t["store"][["s_store_sk", "s_store_id", "s_store_name"]]
    y1 = wss[(wss.d_week_seq >= 53) & (wss.d_week_seq <= 104)].merge(
        st, left_on="ss_store_sk", right_on="s_store_sk")
    y2 = wss[(wss.d_week_seq >= 105) & (wss.d_week_seq <= 156)].copy()
    y2 = y2.rename(columns={"d_week_seq": "wk2", "ss_store_sk": "store2",
                            **{day[:3].lower() + "_sales":
                               day[:3].lower() + "_sales2"
                               for day in _WEEKDAYS}})
    jj = y1.assign(_k=y1.d_week_seq + 52).merge(
        y2, left_on=["ss_store_sk", "_k"], right_on=["store2", "wk2"])
    res = pd.DataFrame({
        "s_store_name": jj.s_store_name, "s_store_id": jj.s_store_id,
        "d_week_seq": jj.d_week_seq})
    for day in _WEEKDAYS:
        k = day[:3].lower()
        res["r_" + k] = jj[k + "_sales"] / jj[k + "_sales2"]
    return (res.sort_values(["s_store_name", "s_store_id", "d_week_seq"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q84 — store returners by city and income band
# ---------------------------------------------------------------------------


def q84(dfs):
    ca = (dfs["customer_address"]
          .filter(col("ca_city").isin("Springfield_00", "Springfield_01",
                                      "Greenville_00", "Greenville_01"))
          .select("ca_address_sk"))
    ib = (dfs["income_band"]
          .filter((col("ib_lower_bound") >= lit(10000))
                  & (col("ib_upper_bound") <= lit(160000)))
          .select("ib_income_band_sk"))
    hd = dfs["household_demographics"].select("hd_demo_sk",
                                              "hd_income_band_sk")
    hd = hd.join(ib, on=col("hd_income_band_sk")
                 == col("ib_income_band_sk"), how="left_semi")
    c = dfs["customer"].select("c_customer_sk", "c_customer_id",
                               "c_first_name", "c_last_name",
                               "c_current_addr_sk", "c_current_cdemo_sk",
                               "c_current_hdemo_sk")
    c = c.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    c = c.join(hd, on=col("c_current_hdemo_sk") == col("hd_demo_sk"),
               how="left_semi")
    cd = dfs["customer_demographics"].select("cd_demo_sk")
    sr = dfs["store_returns"].select("sr_cdemo_sk")
    j = c.join(cd, on=col("c_current_cdemo_sk") == col("cd_demo_sk"))
    j = j.join(sr, on=col("cd_demo_sk") == col("sr_cdemo_sk"))
    return (j.select("c_customer_id", "c_last_name", "c_first_name")
            .sort("c_customer_id", "c_last_name", "c_first_name")
            .limit(100))


def q84_pandas(t):
    ca = t["customer_address"]
    caa = ca[ca.ca_city.isin(["Springfield_00", "Springfield_01",
                              "Greenville_00", "Greenville_01"])][
        ["ca_address_sk"]]
    ib = t["income_band"]
    ibb = ib[(ib.ib_lower_bound >= 10000)
             & (ib.ib_upper_bound <= 160000)][["ib_income_band_sk"]]
    hd = t["household_demographics"]
    hdd = hd[hd.hd_income_band_sk.isin(
        ibb.ib_income_band_sk)][["hd_demo_sk"]]
    c = t["customer"]
    c = c[c.c_current_addr_sk.isin(caa.ca_address_sk)
          & c.c_current_hdemo_sk.isin(hdd.hd_demo_sk)]
    j = c.merge(t["customer_demographics"][["cd_demo_sk"]],
                left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(t["store_returns"][["sr_cdemo_sk"]],
                left_on="cd_demo_sk", right_on="sr_cdemo_sk")
    return (j[["c_customer_id", "c_last_name", "c_first_name"]]
            .sort_values(["c_customer_id", "c_last_name", "c_first_name"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q86 — web rollup by category/class with rank within parent
# ---------------------------------------------------------------------------


def q86(dfs):
    d = (dfs["date_dim"].filter((col("d_month_seq") >= lit(24))
                                & (col("d_month_seq") <= lit(35)))
         .select("d_date_sk"))
    ws = dfs["web_sales"].select("ws_sold_date_sk", "ws_item_sk",
                                 "ws_net_paid")
    it = dfs["item"].select("i_item_sk", "i_category", "i_class")
    j = ws.join(d, on=col("ws_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ws_item_sk") == col("i_item_sk"))
    u = _rollup_union(j, [("i_category", "string"),
                          ("i_class", "string")],
                      {"total_sum": ("sum", "ws_net_paid")}, j.session,
                      with_parent=True)
    w = u.window(["lochierarchy", "_parent"], order_by=["-total_sum"],
                 rank_within_parent=("rank", "*"))
    return (w.select("total_sum", "i_category", "i_class",
                     "lochierarchy", "rank_within_parent")
            .sort("-lochierarchy", "i_category", "i_class",
                  "rank_within_parent").limit(100))


def q86_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 24) & (d.d_month_seq <= 35)][["d_date_sk"]]
    j = t["web_sales"][["ws_sold_date_sk", "ws_item_sk",
                        "ws_net_paid"]].merge(
        dd, left_on="ws_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["item"][["i_item_sk", "i_category", "i_class"]],
                left_on="ws_item_sk", right_on="i_item_sk")
    outs = []
    for depth, keys in ((0, ["i_category", "i_class"]),
                        (1, ["i_category"]), (2, [])):
        if keys:
            g = j.groupby(keys, as_index=False).agg(
                total_sum=("ws_net_paid", "sum"))
        else:
            g = pd.DataFrame({"total_sum": [j.ws_net_paid.sum()]})
        g["lochierarchy"] = depth
        for name in ("i_category", "i_class"):
            if name not in g.columns:
                g[name] = np.nan
        g["_parent"] = g["i_category"].where(g.lochierarchy == 0, np.nan)
        outs.append(g[["i_category", "i_class", "lochierarchy", "_parent",
                       "total_sum"]])
    u = pd.concat(outs, ignore_index=True)
    u["rank_within_parent"] = (
        u.groupby(["lochierarchy", "_parent"], dropna=False)["total_sum"]
        .rank(method="min", ascending=False).astype("int64"))
    return (u[["total_sum", "i_category", "i_class", "lochierarchy",
               "rank_within_parent"]]
            .sort_values(["lochierarchy", "i_category", "i_class",
                          "rank_within_parent"],
                         ascending=[False, True, True, True],
                         na_position="first")
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q21 — inventory before/after a pivot date, per warehouse x item
# ---------------------------------------------------------------------------


def q21(dfs):
    inv = dfs["inventory"].select("inv_item_sk", "inv_warehouse_sk",
                                  "inv_date_sk", "inv_quantity_on_hand")
    w = dfs["warehouse"].select("w_warehouse_sk", "w_warehouse_name")
    it = (dfs["item"].filter((col("i_current_price") >= lit(20.0))
                             & (col("i_current_price") <= lit(60.0)))
          .select("i_item_sk", "i_item_id"))
    d = (dfs["date_dim"].filter((col("d_date_sk") >= lit(700))
                                & (col("d_date_sk") <= lit(760)))
         .select("d_date_sk"))
    j = inv.join(it, on=col("inv_item_sk") == col("i_item_sk"))
    j = j.join(w, on=col("inv_warehouse_sk") == col("w_warehouse_sk"))
    j = j.join(d, on=col("inv_date_sk") == col("d_date_sk"))
    g = (j.group_by("w_warehouse_name", "i_item_id").agg(
        _sum_case(col("inv_date_sk") < lit(730),
                  col("inv_quantity_on_hand"), "inv_before"),
        _sum_case(col("inv_date_sk") >= lit(730),
                  col("inv_quantity_on_hand"), "inv_after")))
    g = g.filter((col("inv_before") > lit(0))
                 & (col("inv_after") / col("inv_before") >= lit(2.0 / 3))
                 & (col("inv_after") / col("inv_before") <= lit(1.5)))
    return (g.select("w_warehouse_name", "i_item_id", "inv_before",
                     "inv_after")
            .sort("w_warehouse_name", "i_item_id").limit(100))


def q21_pandas(t):
    it = t["item"]
    itt = it[(it.i_current_price >= 20.0)
             & (it.i_current_price <= 60.0)][["i_item_sk", "i_item_id"]]
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= 700) & (d.d_date_sk <= 760)][["d_date_sk"]]
    j = t["inventory"].merge(itt, left_on="inv_item_sk",
                             right_on="i_item_sk")
    j = j.merge(t["warehouse"][["w_warehouse_sk", "w_warehouse_name"]],
                left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
    j = j.merge(dd, left_on="inv_date_sk", right_on="d_date_sk")
    j["before"] = j.inv_quantity_on_hand.where(j.inv_date_sk < 730)
    j["after"] = j.inv_quantity_on_hand.where(j.inv_date_sk >= 730)
    g = j.groupby(["w_warehouse_name", "i_item_id"], as_index=False).agg(
        inv_before=("before", "sum"), inv_after=("after", "sum"))
    g = g[(g.inv_before > 0) & (g.inv_after / g.inv_before >= 2.0 / 3)
          & (g.inv_after / g.inv_before <= 1.5)]
    return (g.sort_values(["w_warehouse_name", "i_item_id"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q22 — inventory average on-hand, product-hierarchy ROLLUP
# ---------------------------------------------------------------------------


def q22(dfs):
    inv = dfs["inventory"].select("inv_item_sk", "inv_date_sk",
                                  "inv_quantity_on_hand")
    d = (dfs["date_dim"].filter((col("d_month_seq") >= lit(24))
                                & (col("d_month_seq") <= lit(35)))
         .select("d_date_sk"))
    it = dfs["item"].select("i_item_sk", "i_product_name", "i_brand",
                            "i_class", "i_category")
    j = inv.join(d, on=col("inv_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("inv_item_sk") == col("i_item_sk"))
    u = _rollup_union(j, [("i_product_name", "string"),
                          ("i_brand", "string"), ("i_class", "string"),
                          ("i_category", "string")],
                      {"qoh": ("avg", "inv_quantity_on_hand")}, j.session)
    return (u.select("i_product_name", "i_brand", "i_class", "i_category",
                     "qoh")
            .sort("qoh", "i_product_name", "i_brand", "i_class",
                  "i_category").limit(100))


def q22_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 24) & (d.d_month_seq <= 35)][["d_date_sk"]]
    j = t["inventory"].merge(dd, left_on="inv_date_sk",
                             right_on="d_date_sk")
    j = j.merge(t["item"][["i_item_sk", "i_product_name", "i_brand",
                           "i_class", "i_category"]],
                left_on="inv_item_sk", right_on="i_item_sk")
    levels = ["i_product_name", "i_brand", "i_class", "i_category"]
    outs = []
    for depth in range(len(levels), -1, -1):
        keys = levels[:depth]
        if keys:
            g = j.groupby(keys, as_index=False).agg(
                qoh=("inv_quantity_on_hand", "mean"))
        else:
            g = pd.DataFrame({"qoh": [j.inv_quantity_on_hand.mean()]})
        for name in levels:
            if name not in g.columns:
                g[name] = np.nan
        outs.append(g[levels + ["qoh"]])
    u = pd.concat(outs, ignore_index=True)
    return (u.sort_values(["qoh"] + levels, na_position="first")
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q37 / q82 — in-stock items in a price band, sold via catalog / store
# ---------------------------------------------------------------------------


def _instock(dfs, fact, item_col):
    it = (dfs["item"].filter((col("i_current_price") >= lit(20.0))
                             & (col("i_current_price") <= lit(60.0)))
          .select("i_item_sk", "i_item_id", "i_item_desc",
                  "i_current_price"))
    inv = (dfs["inventory"]
           .filter((col("inv_quantity_on_hand") >= lit(100))
                   & (col("inv_quantity_on_hand") <= lit(500)))
           .select("inv_item_sk", "inv_date_sk"))
    d = (dfs["date_dim"].filter((col("d_date_sk") >= lit(700))
                                & (col("d_date_sk") <= lit(760)))
         .select("d_date_sk"))
    f = dfs[fact].select(item_col)
    j = it.join(inv, on=col("i_item_sk") == col("inv_item_sk"))
    j = j.join(d, on=col("inv_date_sk") == col("d_date_sk"))
    j = j.join(f, on=col("i_item_sk") == col(item_col), how="left_semi")
    return (j.group_by("i_item_id", "i_item_desc", "i_current_price")
            .agg(("count", "*", "cnt"))
            .select("i_item_id", "i_item_desc", "i_current_price")
            .sort("i_item_id", "i_item_desc", "i_current_price")
            .limit(100))


def q37(dfs):
    return _instock(dfs, "catalog_sales", "cs_item_sk")


def q82(dfs):
    return _instock(dfs, "store_sales", "ss_item_sk")


def _instock_pd(t, fact, item_col):
    it = t["item"]
    itt = it[(it.i_current_price >= 20.0) & (it.i_current_price <= 60.0)][
        ["i_item_sk", "i_item_id", "i_item_desc", "i_current_price"]]
    inv = t["inventory"]
    invv = inv[(inv.inv_quantity_on_hand >= 100)
               & (inv.inv_quantity_on_hand <= 500)][
        ["inv_item_sk", "inv_date_sk"]]
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= 700) & (d.d_date_sk <= 760)][["d_date_sk"]]
    j = itt.merge(invv, left_on="i_item_sk", right_on="inv_item_sk")
    j = j.merge(dd, left_on="inv_date_sk", right_on="d_date_sk")
    j = j[j.i_item_sk.isin(t[fact][item_col])]
    g = (j.groupby(["i_item_id", "i_item_desc", "i_current_price"],
                   as_index=False).size())
    return (g[["i_item_id", "i_item_desc", "i_current_price"]]
            .sort_values(["i_item_id", "i_item_desc", "i_current_price"])
            .head(100).reset_index(drop=True))


def q37_pandas(t):
    return _instock_pd(t, "catalog_sales", "cs_item_sk")


def q82_pandas(t):
    return _instock_pd(t, "store_sales", "ss_item_sk")


# ---------------------------------------------------------------------------
# q39 — inventory coefficient of variation, consecutive months
# ---------------------------------------------------------------------------


def _inv_month_stats(dfs, moy, tag):
    inv = dfs["inventory"].select("inv_item_sk", "inv_warehouse_sk",
                                  "inv_date_sk", "inv_quantity_on_hand")
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_moy") == lit(moy)))
         .select("d_date_sk"))
    j = inv.join(d, on=col("inv_date_sk") == col("d_date_sk"))
    g = (j.group_by("inv_item_sk", "inv_warehouse_sk")
         .agg(("avg", "inv_quantity_on_hand", "mean_qoh"),
              ("stddev", "inv_quantity_on_hand", "std_qoh")))
    g = g.filter((col("mean_qoh") > lit(0))
                 & (col("std_qoh") / col("mean_qoh") >= lit(1.0)))
    return g.select(col("inv_item_sk").alias(tag + "_item"),
                    col("inv_warehouse_sk").alias(tag + "_wh"),
                    col("mean_qoh").alias(tag + "_mean"),
                    (col("std_qoh") / col("mean_qoh")).alias(tag + "_cov"))


def q39(dfs):
    m1 = _inv_month_stats(dfs, 3, "m1")
    m2 = _inv_month_stats(dfs, 4, "m2")
    j = m1.join(m2, on=(col("m1_item") == col("m2_item"))
                & (col("m1_wh") == col("m2_wh")))
    return (j.select("m1_item", "m1_wh", "m1_mean", "m1_cov", "m2_mean",
                     "m2_cov")
            .sort("m1_item", "m1_wh", "m1_mean", "m1_cov", "m2_mean",
                  "m2_cov").limit(100))


def _inv_month_stats_pd(t, moy, tag):
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy == moy)][["d_date_sk"]]
    j = t["inventory"].merge(dd, left_on="inv_date_sk",
                             right_on="d_date_sk")
    g = j.groupby(["inv_item_sk", "inv_warehouse_sk"],
                  as_index=False).agg(
        mean_qoh=("inv_quantity_on_hand", "mean"),
        std_qoh=("inv_quantity_on_hand", "std"))
    g = g[(g.mean_qoh > 0) & (g.std_qoh / g.mean_qoh >= 1.0)]
    out = pd.DataFrame({
        tag + "_item": g.inv_item_sk, tag + "_wh": g.inv_warehouse_sk,
        tag + "_mean": g.mean_qoh, tag + "_cov": g.std_qoh / g.mean_qoh})
    return out


def q39_pandas(t):
    m1 = _inv_month_stats_pd(t, 3, "m1")
    m2 = _inv_month_stats_pd(t, 4, "m2")
    j = m1.merge(m2, left_on=["m1_item", "m1_wh"],
                 right_on=["m2_item", "m2_wh"])
    return (j[["m1_item", "m1_wh", "m1_mean", "m1_cov", "m2_mean",
               "m2_cov"]]
            .sort_values(["m1_item", "m1_wh", "m1_mean", "m1_cov",
                          "m2_mean", "m2_cov"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q38 / q87 — cross-channel customer-date overlap (INTERSECT / EXCEPT)
# ---------------------------------------------------------------------------


def _channel_tuples(dfs, fact, cust_col, date_col):
    f = dfs[fact].select(cust_col, date_col)
    d = (dfs["date_dim"].filter((col("d_month_seq") >= lit(24))
                                & (col("d_month_seq") <= lit(35)))
         .select("d_date_sk", "d_week_seq"))
    c = dfs["customer"].select("c_customer_sk", "c_last_name",
                               "c_first_name")
    j = f.join(d, on=col(date_col) == col("d_date_sk"))
    j = j.join(c, on=col(cust_col) == col("c_customer_sk"))
    return j.select("c_last_name", "c_first_name", "d_week_seq")


def q38(dfs):
    ss = _channel_tuples(dfs, "store_sales", "ss_customer_sk",
                         "ss_sold_date_sk")
    cs = _channel_tuples(dfs, "catalog_sales", "cs_bill_customer_sk",
                         "cs_sold_date_sk")
    ws = _channel_tuples(dfs, "web_sales", "ws_bill_customer_sk",
                         "ws_sold_date_sk")
    hot = ss.intersect(cs).intersect(ws)
    return hot.agg(("count", "*", "cnt"))


def q87(dfs):
    ss = _channel_tuples(dfs, "store_sales", "ss_customer_sk",
                         "ss_sold_date_sk")
    cs = _channel_tuples(dfs, "catalog_sales", "cs_bill_customer_sk",
                         "cs_sold_date_sk")
    ws = _channel_tuples(dfs, "web_sales", "ws_bill_customer_sk",
                         "ws_sold_date_sk")
    cool = ss.except_(cs).except_(ws)
    return cool.agg(("count", "*", "cnt"))


def _channel_tuples_pd(t, fact, cust_col, date_col):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 24) & (d.d_month_seq <= 35)][
        ["d_date_sk", "d_week_seq"]]
    j = t[fact][[cust_col, date_col]].merge(
        dd, left_on=date_col, right_on="d_date_sk")
    j = j.merge(t["customer"][["c_customer_sk", "c_last_name",
                               "c_first_name"]],
                left_on=cust_col, right_on="c_customer_sk")
    return set(map(tuple, j[["c_last_name", "c_first_name",
                             "d_week_seq"]].values))


def q38_pandas(t):
    ss = _channel_tuples_pd(t, "store_sales", "ss_customer_sk",
                            "ss_sold_date_sk")
    cs = _channel_tuples_pd(t, "catalog_sales", "cs_bill_customer_sk",
                            "cs_sold_date_sk")
    ws = _channel_tuples_pd(t, "web_sales", "ws_bill_customer_sk",
                            "ws_sold_date_sk")
    return pd.DataFrame({"cnt": [len(ss & cs & ws)]})


def q87_pandas(t):
    ss = _channel_tuples_pd(t, "store_sales", "ss_customer_sk",
                            "ss_sold_date_sk")
    cs = _channel_tuples_pd(t, "catalog_sales", "cs_bill_customer_sk",
                            "cs_sold_date_sk")
    ws = _channel_tuples_pd(t, "web_sales", "ws_bill_customer_sk",
                            "ws_sold_date_sk")
    return pd.DataFrame({"cnt": [len((ss - cs) - ws)]})


# ---------------------------------------------------------------------------
# q92 — web excess discount (q32's web sibling)
# ---------------------------------------------------------------------------


def q92(dfs):
    it = dfs["item"].filter(col("i_manufact_id") == lit(77)) \
        .select("i_item_sk")
    dt = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk"))
    ws = dfs["web_sales"].select("ws_item_sk", "ws_sold_date_sk",
                                 "ws_ext_discount_amt")
    win = ws.join(dt, on=col("ws_sold_date_sk") == col("d_date_sk"))
    avg_disc = (win.group_by("ws_item_sk")
                .agg(("avg", "ws_ext_discount_amt", "avg_disc")))
    avg_disc = avg_disc.select(col("ws_item_sk").alias("avg_item_sk"),
                               "avg_disc")
    j = win.join(it, on=col("ws_item_sk") == col("i_item_sk"))
    j = j.join(avg_disc, on=col("ws_item_sk") == col("avg_item_sk"))
    j = j.filter(col("ws_ext_discount_amt") > col("avg_disc") * lit(1.3))
    return j.agg(("sum", "ws_ext_discount_amt", "excess_discount_amount"))


def q92_pandas(t):
    it = t["item"][t["item"].i_manufact_id == 77][["i_item_sk"]]
    d = t["date_dim"]
    dt = d[d.d_year == 2000][["d_date_sk"]]
    win = t["web_sales"].merge(dt, left_on="ws_sold_date_sk",
                               right_on="d_date_sk")
    avg_disc = win.groupby("ws_item_sk", as_index=False).agg(
        avg_disc=("ws_ext_discount_amt", "mean"))
    j = win.merge(it, left_on="ws_item_sk", right_on="i_item_sk")
    j = j.merge(avg_disc, on="ws_item_sk")
    j = j[j.ws_ext_discount_amt > 1.3 * j.avg_disc]
    return pd.DataFrame(
        {"excess_discount_amount": [j.ws_ext_discount_amt.sum()]})


# ---------------------------------------------------------------------------
# q62 / q99 — shipping-lag day buckets (web / catalog)
# ---------------------------------------------------------------------------


def _lag_buckets(lag, prefix):
    one = lit(1)
    return [
        ("sum", CaseWhen([(lag <= lit(30), one)]), prefix + "30_days"),
        ("sum", CaseWhen([((lag > lit(30)) & (lag <= lit(60)), one)]),
         prefix + "31_60_days"),
        ("sum", CaseWhen([((lag > lit(60)) & (lag <= lit(90)), one)]),
         prefix + "61_90_days"),
        ("sum", CaseWhen([((lag > lit(90)) & (lag <= lit(120)), one)]),
         prefix + "91_120_days"),
        ("sum", CaseWhen([(lag > lit(120), one)]),
         prefix + "gt120_days"),
    ]


def q62(dfs):
    ws = dfs["web_sales"].select("ws_ship_date_sk", "ws_sold_date_sk",
                                 "ws_warehouse_sk", "ws_ship_mode_sk",
                                 "ws_web_site_sk")
    d = (dfs["date_dim"].filter((col("d_month_seq") >= lit(24))
                                & (col("d_month_seq") <= lit(35)))
         .select("d_date_sk"))
    w = dfs["warehouse"].select("w_warehouse_sk", "w_warehouse_name")
    sm = dfs["ship_mode"].select("sm_ship_mode_sk", "sm_type")
    web = dfs["web_site"].select("web_site_sk", "web_name")
    j = ws.join(d, on=col("ws_ship_date_sk") == col("d_date_sk"))
    j = j.join(w, on=col("ws_warehouse_sk") == col("w_warehouse_sk"))
    j = j.join(sm, on=col("ws_ship_mode_sk") == col("sm_ship_mode_sk"))
    j = j.join(web, on=col("ws_web_site_sk") == col("web_site_sk"))
    lag = col("ws_ship_date_sk") - col("ws_sold_date_sk")
    g = (j.group_by("w_warehouse_name", "sm_type", "web_name")
         .agg(*_lag_buckets(lag, "d")))
    return (g.sort("w_warehouse_name", "sm_type", "web_name")
            .limit(100))


def q99(dfs):
    cs = dfs["catalog_sales"].select(
        "cs_ship_date_sk", "cs_sold_date_sk", "cs_warehouse_sk",
        "cs_ship_mode_sk", "cs_call_center_sk")
    d = (dfs["date_dim"].filter((col("d_month_seq") >= lit(24))
                                & (col("d_month_seq") <= lit(35)))
         .select("d_date_sk"))
    w = dfs["warehouse"].select("w_warehouse_sk", "w_warehouse_name")
    sm = dfs["ship_mode"].select("sm_ship_mode_sk", "sm_type")
    cc = dfs["call_center"].select("cc_call_center_sk", "cc_name")
    j = cs.join(d, on=col("cs_ship_date_sk") == col("d_date_sk"))
    j = j.join(w, on=col("cs_warehouse_sk") == col("w_warehouse_sk"))
    j = j.join(sm, on=col("cs_ship_mode_sk") == col("sm_ship_mode_sk"))
    j = j.join(cc, on=col("cs_call_center_sk") == col("cc_call_center_sk"))
    lag = col("cs_ship_date_sk") - col("cs_sold_date_sk")
    g = (j.group_by("w_warehouse_name", "sm_type", "cc_name")
         .agg(*_lag_buckets(lag, "d")))
    return (g.sort("w_warehouse_name", "sm_type", "cc_name")
            .limit(100))


def _lag_buckets_pd(j, lag, g_keys, prefix):
    j = j.copy()
    j["_lag"] = lag
    one = 1.0
    j[prefix + "30_days"] = np.where(j._lag <= 30, one, np.nan)
    j[prefix + "31_60_days"] = np.where((j._lag > 30) & (j._lag <= 60),
                                        one, np.nan)
    j[prefix + "61_90_days"] = np.where((j._lag > 60) & (j._lag <= 90),
                                        one, np.nan)
    j[prefix + "91_120_days"] = np.where((j._lag > 90) & (j._lag <= 120),
                                         one, np.nan)
    j[prefix + "gt120_days"] = np.where(j._lag > 120, one, np.nan)
    cols = [prefix + s for s in ("30_days", "31_60_days", "61_90_days",
                                 "91_120_days", "gt120_days")]
    g = j.groupby(g_keys, as_index=False)[cols].sum(min_count=1)
    return g


def q62_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 24) & (d.d_month_seq <= 35)][["d_date_sk"]]
    j = t["web_sales"].merge(dd, left_on="ws_ship_date_sk",
                             right_on="d_date_sk")
    j = j.merge(t["warehouse"][["w_warehouse_sk", "w_warehouse_name"]],
                left_on="ws_warehouse_sk", right_on="w_warehouse_sk")
    j = j.merge(t["ship_mode"][["sm_ship_mode_sk", "sm_type"]],
                left_on="ws_ship_mode_sk", right_on="sm_ship_mode_sk")
    j = j.merge(t["web_site"][["web_site_sk", "web_name"]],
                left_on="ws_web_site_sk", right_on="web_site_sk")
    g = _lag_buckets_pd(j, j.ws_ship_date_sk - j.ws_sold_date_sk,
                        ["w_warehouse_name", "sm_type", "web_name"], "d")
    return (g.sort_values(["w_warehouse_name", "sm_type", "web_name"])
            .head(100).reset_index(drop=True))


def q99_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 24) & (d.d_month_seq <= 35)][["d_date_sk"]]
    j = t["catalog_sales"].merge(dd, left_on="cs_ship_date_sk",
                                 right_on="d_date_sk")
    j = j.merge(t["warehouse"][["w_warehouse_sk", "w_warehouse_name"]],
                left_on="cs_warehouse_sk", right_on="w_warehouse_sk")
    j = j.merge(t["ship_mode"][["sm_ship_mode_sk", "sm_type"]],
                left_on="cs_ship_mode_sk", right_on="sm_ship_mode_sk")
    j = j.merge(t["call_center"][["cc_call_center_sk", "cc_name"]],
                left_on="cs_call_center_sk", right_on="cc_call_center_sk")
    g = _lag_buckets_pd(j, j.cs_ship_date_sk - j.cs_sold_date_sk,
                        ["w_warehouse_name", "sm_type", "cc_name"], "d")
    return (g.sort_values(["w_warehouse_name", "sm_type", "cc_name"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q54 — revenue segments of cross-channel buyers (scalar subqueries)
# ---------------------------------------------------------------------------


def q54(dfs):
    from hyperspace_tpu_torch.plan.expr import Floor

    it = (dfs["item"].filter((col("i_category") == lit("Books"))
                             & (col("i_class") == lit("personal")))
          .select("i_item_sk"))
    d0 = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                 & (col("d_moy") == lit(5)))
          .select("d_date_sk"))
    cs = dfs["catalog_sales"].select(
        col("cs_bill_customer_sk").alias("cust"),
        col("cs_item_sk").alias("item"),
        col("cs_sold_date_sk").alias("sold"))
    ws = dfs["web_sales"].select(
        col("ws_bill_customer_sk").alias("cust"),
        col("ws_item_sk").alias("item"),
        col("ws_sold_date_sk").alias("sold"))
    u = cs.union(ws)
    u = u.join(it, on=col("item") == col("i_item_sk"), how="left_semi")
    u = u.join(d0, on=col("sold") == col("d_date_sk"), how="left_semi")
    my_customers = u.select("cust").distinct()

    # The official month window arrives via SCALAR SUBQUERIES:
    # d_month_seq between (select distinct d_month_seq+1 ..) and (.. +3).
    base = dfs["date_dim"].filter((col("d_year") == lit(2000))
                                  & (col("d_moy") == lit(5)))
    lo = (base.select((col("d_month_seq") + lit(1)).alias("m"))
          .distinct()).as_scalar()
    hi = (base.select((col("d_month_seq") + lit(3)).alias("m"))
          .distinct()).as_scalar()
    dr = (dfs["date_dim"].filter((col("d_month_seq") >= lo)
                                 & (col("d_month_seq") <= hi))
          .select("d_date_sk"))
    ss = dfs["store_sales"].select("ss_customer_sk", "ss_sold_date_sk",
                                   "ss_ext_sales_price")
    rev = ss.join(my_customers, on=col("ss_customer_sk") == col("cust"))
    rev = rev.join(dr, on=col("ss_sold_date_sk") == col("d_date_sk"),
                   how="left_semi")
    per_cust = (rev.group_by("cust")
                .agg(("sum", "ss_ext_sales_price", "revenue")))
    seg = per_cust.select(
        Floor(col("revenue") / lit(50.0)).alias("segment"))
    out = (seg.group_by("segment").agg(("count", "*", "num_customers"))
           .sort("segment", "num_customers").limit(100))
    return out


def q54_pandas(t):
    it = t["item"]
    itt = it[(it.i_category == "Books")
             & (it.i_class == "personal")][["i_item_sk"]]
    d = t["date_dim"]
    d0 = d[(d.d_year == 2000) & (d.d_moy == 5)]
    cs = t["catalog_sales"][["cs_bill_customer_sk", "cs_item_sk",
                             "cs_sold_date_sk"]].rename(
        columns={"cs_bill_customer_sk": "cust", "cs_item_sk": "item",
                 "cs_sold_date_sk": "sold"})
    ws = t["web_sales"][["ws_bill_customer_sk", "ws_item_sk",
                         "ws_sold_date_sk"]].rename(
        columns={"ws_bill_customer_sk": "cust", "ws_item_sk": "item",
                 "ws_sold_date_sk": "sold"})
    u = pd.concat([cs, ws], ignore_index=True)
    u = u[u["item"].isin(itt.i_item_sk) & u["sold"].isin(d0.d_date_sk)]
    my_customers = u[["cust"]].drop_duplicates()
    lo = int((d0.d_month_seq + 1).drop_duplicates().iloc[0])
    hi = int((d0.d_month_seq + 3).drop_duplicates().iloc[0])
    dr = d[(d.d_month_seq >= lo) & (d.d_month_seq <= hi)][["d_date_sk"]]
    rev = t["store_sales"].merge(my_customers, left_on="ss_customer_sk",
                                 right_on="cust")
    rev = rev[rev.ss_sold_date_sk.isin(dr.d_date_sk)]
    per_cust = rev.groupby("cust", as_index=False).agg(
        revenue=("ss_ext_sales_price", "sum"))
    per_cust["segment"] = np.floor(
        per_cust.revenue / 50.0).astype("int64")
    g = per_cust.groupby("segment", as_index=False).agg(
        num_customers=("cust", "size"))
    return (g[["segment", "num_customers"]]
            .sort_values(["segment", "num_customers"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q35 — demographics of customers active in store AND (web OR catalog)
# ---------------------------------------------------------------------------


def q35(dfs):
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_qoy") < lit(4)))
         .select("d_date_sk"))
    ss_c = (dfs["store_sales"].select("ss_customer_sk", "ss_sold_date_sk")
            .join(d, on=col("ss_sold_date_sk") == col("d_date_sk"),
                  how="left_semi").select("ss_customer_sk"))
    ws_c = (dfs["web_sales"]
            .select("ws_bill_customer_sk", "ws_sold_date_sk")
            .join(d, on=col("ws_sold_date_sk") == col("d_date_sk"),
                  how="left_semi")
            .select(col("ws_bill_customer_sk").alias("wsc")).distinct())
    cs_c = (dfs["catalog_sales"]
            .select("cs_bill_customer_sk", "cs_sold_date_sk")
            .join(d, on=col("cs_sold_date_sk") == col("d_date_sk"),
                  how="left_semi")
            .select(col("cs_bill_customer_sk").alias("csc")).distinct())
    c = dfs["customer"].select("c_customer_sk", "c_current_addr_sk",
                               "c_current_cdemo_sk")
    c = c.join(ss_c, on=col("c_customer_sk") == col("ss_customer_sk"),
               how="left_semi")
    # EXISTS ws OR EXISTS cs: outer-join markers, then an OR filter
    # (semi joins only compose conjunctively).
    c = c.join(ws_c, on=col("c_customer_sk") == col("wsc"), how="left")
    c = c.join(cs_c, on=col("c_customer_sk") == col("csc"), how="left")
    c = c.filter(col("wsc").is_not_null() | col("csc").is_not_null())
    ca = dfs["customer_address"].select("ca_address_sk", "ca_state")
    cd = dfs["customer_demographics"].select(
        "cd_demo_sk", "cd_gender", "cd_marital_status", "cd_dep_count",
        "cd_dep_employed_count", "cd_dep_college_count")
    j = c.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"))
    j = j.join(cd, on=col("c_current_cdemo_sk") == col("cd_demo_sk"))
    g = (j.group_by("ca_state", "cd_gender", "cd_marital_status",
                    "cd_dep_count", "cd_dep_employed_count",
                    "cd_dep_college_count")
         .agg(("count", "*", "cnt1"),
              ("avg", "cd_dep_count", "avg_dep"),
              ("max", "cd_dep_employed_count", "max_emp"),
              ("sum", "cd_dep_college_count", "sum_col")))
    return (g.sort("ca_state", "cd_gender", "cd_marital_status",
                   "cd_dep_count", "cd_dep_employed_count",
                   "cd_dep_college_count").limit(100))


def q35_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_qoy < 4)][["d_date_sk"]]
    ss_c = t["store_sales"][t["store_sales"].ss_sold_date_sk.isin(
        dd.d_date_sk)].ss_customer_sk.unique()
    ws_c = t["web_sales"][t["web_sales"].ws_sold_date_sk.isin(
        dd.d_date_sk)].ws_bill_customer_sk.unique()
    cs_c = t["catalog_sales"][t["catalog_sales"].cs_sold_date_sk.isin(
        dd.d_date_sk)].cs_bill_customer_sk.unique()
    c = t["customer"]
    c = c[c.c_customer_sk.isin(ss_c)
          & (c.c_customer_sk.isin(ws_c) | c.c_customer_sk.isin(cs_c))]
    j = c.merge(t["customer_address"][["ca_address_sk", "ca_state"]],
                left_on="c_current_addr_sk", right_on="ca_address_sk")
    j = j.merge(t["customer_demographics"][
        ["cd_demo_sk", "cd_gender", "cd_marital_status", "cd_dep_count",
         "cd_dep_employed_count", "cd_dep_college_count"]],
        left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
    g = j.groupby(["ca_state", "cd_gender", "cd_marital_status",
                   "cd_dep_count", "cd_dep_employed_count",
                   "cd_dep_college_count"], as_index=False).agg(
        cnt1=("cd_demo_sk", "size"), avg_dep=("cd_dep_count", "mean"),
        max_emp=("cd_dep_employed_count", "max"),
        sum_col=("cd_dep_college_count", "sum"))
    return (g.sort_values(["ca_state", "cd_gender", "cd_marital_status",
                           "cd_dep_count", "cd_dep_employed_count",
                           "cd_dep_college_count"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q44 — best/worst items by average store profit (rank windows)
# ---------------------------------------------------------------------------


def q44(dfs):
    ss = (dfs["store_sales"].filter(col("ss_store_sk") == lit(4))
          .select("ss_item_sk", "ss_net_profit"))
    avg_p = (ss.group_by("ss_item_sk")
             .agg(("avg", "ss_net_profit", "rank_col"))
             .with_column("one", lit(1)))
    asc = (avg_p.window(["one"], order_by=["rank_col"],
                        rnk=("rank", "*"))
           .filter(col("rnk") <= lit(10))
           .select("rnk", col("ss_item_sk").alias("asc_item")))
    desc = (avg_p.window(["one"], order_by=["-rank_col"],
                         rnk=("rank", "*"))
            .filter(col("rnk") <= lit(10))
            .select(col("rnk").alias("rnk_d"),
                    col("ss_item_sk").alias("desc_item")))
    i1 = dfs["item"].select("i_item_sk",
                            col("i_product_name").alias(
                                "best_performing"))
    i2 = dfs["item"].select(col("i_item_sk").alias("i2_sk"),
                            col("i_product_name").alias(
                                "worst_performing"))
    j = asc.join(desc, on=col("rnk") == col("rnk_d"))
    j = j.join(i1, on=col("asc_item") == col("i_item_sk"))
    j = j.join(i2, on=col("desc_item") == col("i2_sk"))
    return (j.select("rnk", "best_performing", "worst_performing")
            .sort("rnk").limit(100))


def q44_pandas(t):
    ss = t["store_sales"]
    ss = ss[ss.ss_store_sk == 4][["ss_item_sk", "ss_net_profit"]]
    avg_p = ss.groupby("ss_item_sk", as_index=False).agg(
        rank_col=("ss_net_profit", "mean"))
    avg_p["rnk"] = avg_p.rank_col.rank(method="min").astype("int64")
    avg_p["rnk_d"] = avg_p.rank_col.rank(
        method="min", ascending=False).astype("int64")
    asc = avg_p[avg_p.rnk <= 10][["rnk", "ss_item_sk"]].rename(
        columns={"ss_item_sk": "asc_item"})
    desc = avg_p[avg_p.rnk_d <= 10][["rnk_d", "ss_item_sk"]].rename(
        columns={"ss_item_sk": "desc_item"})
    j = asc.merge(desc, left_on="rnk", right_on="rnk_d")
    it = t["item"]
    j = j.merge(it[["i_item_sk", "i_product_name"]].rename(
        columns={"i_product_name": "best_performing"}),
        left_on="asc_item", right_on="i_item_sk")
    j = j.merge(it[["i_item_sk", "i_product_name"]].rename(
        columns={"i_item_sk": "i2_sk",
                 "i_product_name": "worst_performing"}),
        left_on="desc_item", right_on="i2_sk")
    return (j[["rnk", "best_performing", "worst_performing"]]
            .sort_values("rnk").head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q45 — web sales by zip/city: listed zips OR listed items
# ---------------------------------------------------------------------------


_Q45_ZIPS = ["10000", "10037", "10074", "10111", "10148"]


def q45(dfs):
    ws = dfs["web_sales"].select("ws_item_sk", "ws_bill_customer_sk",
                                 "ws_sold_date_sk", "ws_sales_price")
    c = dfs["customer"].select("c_customer_sk", "c_current_addr_sk")
    ca = dfs["customer_address"].select("ca_address_sk", "ca_city",
                                        "ca_zip")
    it = dfs["item"].select("i_item_sk", "i_item_id")
    sub = (dfs["item"].filter(col("i_item_sk").isin(2, 3, 5, 7, 11, 13,
                                                    17, 19, 23, 29))
           .select(col("i_item_id").alias("sub_item_id")).distinct())
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_qoy") == lit(2)))
         .select("d_date_sk"))
    j = ws.join(c, on=col("ws_bill_customer_sk") == col("c_customer_sk"))
    j = j.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"))
    j = j.join(d, on=col("ws_sold_date_sk") == col("d_date_sk"))
    j = j.join(it, on=col("ws_item_sk") == col("i_item_sk"))
    j = j.join(sub, on=col("i_item_id") == col("sub_item_id"),
               how="left")
    zips = col("ca_zip").substr(1, 5).isin(*_Q45_ZIPS)
    j = j.filter(zips | col("sub_item_id").is_not_null())
    return (j.group_by("ca_zip", "ca_city")
            .agg(("sum", "ws_sales_price", "total"))
            .sort("ca_zip", "ca_city").limit(100))


def q45_pandas(t):
    it = t["item"]
    sub = it[it.i_item_sk.isin([2, 3, 5, 7, 11, 13, 17, 19, 23,
                                29])].i_item_id.unique()
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_qoy == 2)][["d_date_sk"]]
    j = t["web_sales"].merge(
        t["customer"][["c_customer_sk", "c_current_addr_sk"]],
        left_on="ws_bill_customer_sk", right_on="c_customer_sk")
    j = j.merge(t["customer_address"][["ca_address_sk", "ca_city",
                                       "ca_zip"]],
                left_on="c_current_addr_sk", right_on="ca_address_sk")
    j = j.merge(dd, left_on="ws_sold_date_sk", right_on="d_date_sk")
    j = j.merge(it[["i_item_sk", "i_item_id"]],
                left_on="ws_item_sk", right_on="i_item_sk")
    j = j[j.ca_zip.str[:5].isin(_Q45_ZIPS) | j.i_item_id.isin(sub)]
    g = j.groupby(["ca_zip", "ca_city"], as_index=False).agg(
        total=("ws_sales_price", "sum"))
    return (g.sort_values(["ca_zip", "ca_city"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q56 / q60 — 3-channel item revenue for a color set / category
# ---------------------------------------------------------------------------


def _3chan_by_item(dfs, item_filter_df):
    def chan(fact, item_col, date_col, addr_col, price_col):
        it = dfs["item"].select("i_item_sk", "i_item_id")
        it = it.join(item_filter_df,
                     on=col("i_item_id") == col("flt_item_id"),
                     how="left_semi")
        d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                    & (col("d_moy") == lit(2)))
             .select("d_date_sk"))
        ca = (dfs["customer_address"]
              .filter(col("ca_gmt_offset") == lit(-5.0))
              .select("ca_address_sk"))
        f = dfs[fact].select(item_col, date_col, addr_col, price_col)
        j = f.join(d, on=col(date_col) == col("d_date_sk"))
        j = j.join(ca, on=col(addr_col) == col("ca_address_sk"))
        j = j.join(it, on=col(item_col) == col("i_item_sk"))
        return (j.group_by("i_item_id")
                .agg(("sum", price_col, "total_sales"))
                .select("i_item_id", "total_sales"))

    ss = chan("store_sales", "ss_item_sk", "ss_sold_date_sk",
              "ss_addr_sk", "ss_ext_sales_price")
    cs = chan("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
              "cs_bill_addr_sk", "cs_ext_sales_price")
    ws = chan("web_sales", "ws_item_sk", "ws_sold_date_sk",
              "ws_bill_addr_sk", "ws_ext_sales_price")
    u = ss.union(cs).union(ws)
    return (u.group_by("i_item_id")
            .agg(("sum", "total_sales", "total_sales"))
            .sort("total_sales", "i_item_id").limit(100))


def q56(dfs):
    flt = (dfs["item"].filter(col("i_color").isin("plum", "puff",
                                                  "misty"))
           .select(col("i_item_id").alias("flt_item_id")).distinct())
    return _3chan_by_item(dfs, flt)


def q60(dfs):
    flt = (dfs["item"].filter(col("i_category") == lit("Music"))
           .select(col("i_item_id").alias("flt_item_id")).distinct())
    return _3chan_by_item(dfs, flt)


def _3chan_by_item_pd(t, item_ids):
    def chan(fact, item_col, date_col, addr_col, price_col):
        it = t["item"]
        itt = it[it.i_item_id.isin(item_ids)][["i_item_sk", "i_item_id"]]
        d = t["date_dim"]
        dd = d[(d.d_year == 2000) & (d.d_moy == 2)][["d_date_sk"]]
        ca = t["customer_address"]
        caa = ca[ca.ca_gmt_offset == -5.0][["ca_address_sk"]]
        j = t[fact][[item_col, date_col, addr_col, price_col]].merge(
            dd, left_on=date_col, right_on="d_date_sk")
        j = j.merge(caa, left_on=addr_col, right_on="ca_address_sk")
        j = j.merge(itt, left_on=item_col, right_on="i_item_sk")
        g = j.groupby("i_item_id", as_index=False)[price_col].sum()
        return g.rename(columns={price_col: "total_sales"})

    u = pd.concat([
        chan("store_sales", "ss_item_sk", "ss_sold_date_sk", "ss_addr_sk",
             "ss_ext_sales_price"),
        chan("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
             "cs_bill_addr_sk", "cs_ext_sales_price"),
        chan("web_sales", "ws_item_sk", "ws_sold_date_sk",
             "ws_bill_addr_sk", "ws_ext_sales_price")],
        ignore_index=True)
    g = u.groupby("i_item_id", as_index=False).total_sales.sum()
    return (g.sort_values(["total_sales", "i_item_id"])
            .head(100).reset_index(drop=True))


def q56_pandas(t):
    it = t["item"]
    ids = it[it.i_color.isin(["plum", "puff", "misty"])].i_item_id.unique()
    return _3chan_by_item_pd(t, ids)


def q60_pandas(t):
    it = t["item"]
    ids = it[it.i_category == "Music"].i_item_id.unique()
    return _3chan_by_item_pd(t, ids)


# ---------------------------------------------------------------------------
# q69 — store-only customers' demographics (anti web/catalog)
# ---------------------------------------------------------------------------


def q69(dfs):
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_moy") >= lit(1))
                                & (col("d_moy") <= lit(3)))
         .select("d_date_sk"))
    ss_c = (dfs["store_sales"].select("ss_customer_sk", "ss_sold_date_sk")
            .join(d, on=col("ss_sold_date_sk") == col("d_date_sk"),
                  how="left_semi").select("ss_customer_sk"))
    ws_c = (dfs["web_sales"]
            .select("ws_bill_customer_sk", "ws_sold_date_sk")
            .join(d, on=col("ws_sold_date_sk") == col("d_date_sk"),
                  how="left_semi").select("ws_bill_customer_sk"))
    cs_c = (dfs["catalog_sales"]
            .select("cs_bill_customer_sk", "cs_sold_date_sk")
            .join(d, on=col("cs_sold_date_sk") == col("d_date_sk"),
                  how="left_semi").select("cs_bill_customer_sk"))
    ca = (dfs["customer_address"].filter(col("ca_state").isin(
        "TX", "OH", "KY")).select("ca_address_sk"))
    c = dfs["customer"].select("c_customer_sk", "c_current_addr_sk",
                               "c_current_cdemo_sk")
    c = c.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    c = c.join(ss_c, on=col("c_customer_sk") == col("ss_customer_sk"),
               how="left_semi")
    c = c.join(ws_c, on=col("c_customer_sk") == col("ws_bill_customer_sk"),
               how="left_anti")
    c = c.join(cs_c, on=col("c_customer_sk") == col("cs_bill_customer_sk"),
               how="left_anti")
    cd = dfs["customer_demographics"].select(
        "cd_demo_sk", "cd_gender", "cd_marital_status",
        "cd_education_status", "cd_purchase_estimate", "cd_credit_rating")
    j = c.join(cd, on=col("c_current_cdemo_sk") == col("cd_demo_sk"))
    g = (j.group_by("cd_gender", "cd_marital_status",
                    "cd_education_status", "cd_purchase_estimate",
                    "cd_credit_rating")
         .agg(("count", "*", "cnt1")))
    return (g.sort("cd_gender", "cd_marital_status",
                   "cd_education_status", "cd_purchase_estimate",
                   "cd_credit_rating").limit(100))


def q69_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy >= 1) & (d.d_moy <= 3)][
        ["d_date_sk"]]
    ss_c = t["store_sales"][t["store_sales"].ss_sold_date_sk.isin(
        dd.d_date_sk)].ss_customer_sk.unique()
    ws_c = t["web_sales"][t["web_sales"].ws_sold_date_sk.isin(
        dd.d_date_sk)].ws_bill_customer_sk.unique()
    cs_c = t["catalog_sales"][t["catalog_sales"].cs_sold_date_sk.isin(
        dd.d_date_sk)].cs_bill_customer_sk.unique()
    ca = t["customer_address"]
    caa = ca[ca.ca_state.isin(["TX", "OH", "KY"])].ca_address_sk
    c = t["customer"]
    c = c[c.c_current_addr_sk.isin(caa) & c.c_customer_sk.isin(ss_c)
          & ~c.c_customer_sk.isin(ws_c) & ~c.c_customer_sk.isin(cs_c)]
    j = c.merge(t["customer_demographics"],
                left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
    g = j.groupby(["cd_gender", "cd_marital_status",
                   "cd_education_status", "cd_purchase_estimate",
                   "cd_credit_rating"], as_index=False).agg(
        cnt1=("cd_demo_sk", "size"))
    return (g.sort_values(["cd_gender", "cd_marital_status",
                           "cd_education_status", "cd_purchase_estimate",
                           "cd_credit_rating"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q71 — brand revenue by hour across 3 channels (time_dim join)
# ---------------------------------------------------------------------------


def q71(dfs):
    it = (dfs["item"].filter(col("i_manager_id") == lit(1))
          .select("i_item_sk", "i_brand_id", "i_brand"))
    d = (dfs["date_dim"].filter((col("d_year") == lit(2000))
                                & (col("d_moy") == lit(12)))
         .select("d_date_sk"))

    def chan(fact, price_col, item_col, date_col, time_col):
        f = dfs[fact].select(item_col, date_col, time_col, price_col)
        j = f.join(d, on=col(date_col) == col("d_date_sk"))
        return j.select(col(price_col).alias("ext_price"),
                        col(item_col).alias("sold_item_sk"),
                        col(time_col).alias("time_sk"))

    u = chan("web_sales", "ws_ext_sales_price", "ws_item_sk",
             "ws_sold_date_sk", "ws_sold_time_sk")
    u = u.union(chan("catalog_sales", "cs_ext_sales_price", "cs_item_sk",
                     "cs_sold_date_sk", "cs_sold_time_sk"))
    u = u.union(chan("store_sales", "ss_ext_sales_price", "ss_item_sk",
                     "ss_sold_date_sk", "ss_sold_time_sk"))
    tm = (dfs["time_dim"].filter(col("t_hour").isin(8, 9, 19, 20))
          .select("t_time_sk", "t_hour", "t_minute"))
    j = u.join(it, on=col("sold_item_sk") == col("i_item_sk"))
    j = j.join(tm, on=col("time_sk") == col("t_time_sk"))
    g = (j.group_by("i_brand_id", "i_brand", "t_hour", "t_minute")
         .agg(("sum", "ext_price", "ext_price")))
    return (g.sort("-ext_price", "i_brand_id", "t_hour", "t_minute")
            .limit(100))


def q71_pandas(t):
    it = t["item"]
    itt = it[it.i_manager_id == 1][["i_item_sk", "i_brand_id", "i_brand"]]
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy == 12)][["d_date_sk"]]

    def chan(fact, price_col, item_col, date_col, time_col):
        j = t[fact][[item_col, date_col, time_col, price_col]].merge(
            dd, left_on=date_col, right_on="d_date_sk")
        return pd.DataFrame({"ext_price": j[price_col],
                             "sold_item_sk": j[item_col],
                             "time_sk": j[time_col]})

    u = pd.concat([
        chan("web_sales", "ws_ext_sales_price", "ws_item_sk",
             "ws_sold_date_sk", "ws_sold_time_sk"),
        chan("catalog_sales", "cs_ext_sales_price", "cs_item_sk",
             "cs_sold_date_sk", "cs_sold_time_sk"),
        chan("store_sales", "ss_ext_sales_price", "ss_item_sk",
             "ss_sold_date_sk", "ss_sold_time_sk")], ignore_index=True)
    tm = t["time_dim"]
    tmm = tm[tm.t_hour.isin([8, 9, 19, 20])][["t_time_sk", "t_hour",
                                              "t_minute"]]
    j = u.merge(itt, left_on="sold_item_sk", right_on="i_item_sk")
    j = j.merge(tmm, left_on="time_sk", right_on="t_time_sk")
    g = j.groupby(["i_brand_id", "i_brand", "t_hour", "t_minute"],
                  as_index=False).agg(ext_price=("ext_price", "sum"))
    return (g.sort_values(["ext_price", "i_brand_id", "t_hour",
                           "t_minute"],
                          ascending=[False, True, True, True])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q90 — web am/pm order ratio
# ---------------------------------------------------------------------------


def q90(dfs):
    ws = dfs["web_sales"].select("ws_sold_time_sk", "ws_ship_hdemo_sk",
                                 "ws_web_page_sk")
    hd = (dfs["household_demographics"]
          .filter(col("hd_dep_count") == lit(2)).select("hd_demo_sk"))
    wp = (dfs["web_page"].filter((col("wp_char_count") >= lit(4000))
                                 & (col("wp_char_count") <= lit(5200)))
          .select("wp_web_page_sk"))
    tm = dfs["time_dim"].select("t_time_sk", "t_hour")
    j = ws.join(hd, on=col("ws_ship_hdemo_sk") == col("hd_demo_sk"),
                how="left_semi")
    j = j.join(wp, on=col("ws_web_page_sk") == col("wp_web_page_sk"),
               how="left_semi")
    j = j.join(tm, on=col("ws_sold_time_sk") == col("t_time_sk"))
    g = j.agg(
        ("sum", CaseWhen([(col("t_hour").isin(8, 9), lit(1))]), "amc"),
        ("sum", CaseWhen([(col("t_hour").isin(19, 20), lit(1))]), "pmc"))
    return g.select((col("amc") / col("pmc")).alias("am_pm_ratio"))


def q90_pandas(t):
    hd = t["household_demographics"]
    hdd = hd[hd.hd_dep_count == 2].hd_demo_sk
    wp = t["web_page"]
    wpp = wp[(wp.wp_char_count >= 4000)
             & (wp.wp_char_count <= 5200)].wp_web_page_sk
    j = t["web_sales"]
    j = j[j.ws_ship_hdemo_sk.isin(hdd) & j.ws_web_page_sk.isin(wpp)]
    j = j.merge(t["time_dim"][["t_time_sk", "t_hour"]],
                left_on="ws_sold_time_sk", right_on="t_time_sk")
    amc = float((j.t_hour.isin([8, 9])).sum())
    pmc = float((j.t_hour.isin([19, 20])).sum())
    return pd.DataFrame({"am_pm_ratio": [amc / pmc]})


# ---------------------------------------------------------------------------
# q94 — multi-warehouse web orders never returned
# ---------------------------------------------------------------------------


def q94(dfs):
    ws = dfs["web_sales"].select(
        "ws_order_number", "ws_ship_date_sk", "ws_ship_addr_sk",
        "ws_web_site_sk", "ws_warehouse_sk", "ws_ext_ship_cost",
        "ws_net_profit")
    d = (dfs["date_dim"].filter((col("d_date_sk") >= lit(730))
                                & (col("d_date_sk") <= lit(790)))
         .select("d_date_sk"))
    ca = (dfs["customer_address"].filter(col("ca_state") == lit("TX"))
          .select("ca_address_sk"))
    web = (dfs["web_site"].filter(col("web_company_name") == lit("pri"))
           .select("web_site_sk"))
    multi_wh = (dfs["web_sales"]
                .select("ws_order_number", "ws_warehouse_sk")
                .group_by("ws_order_number")
                .agg(("count_distinct", "ws_warehouse_sk", "nwh"))
                .filter(col("nwh") > lit(1))
                .select(col("ws_order_number").alias("mw_order")))
    wr = dfs["web_returns"].select(
        col("wr_order_number").alias("ret_order"))
    j = ws.join(d, on=col("ws_ship_date_sk") == col("d_date_sk"),
                how="left_semi")
    j = j.join(ca, on=col("ws_ship_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    j = j.join(web, on=col("ws_web_site_sk") == col("web_site_sk"),
               how="left_semi")
    j = j.join(multi_wh, on=col("ws_order_number") == col("mw_order"),
               how="left_semi")
    j = j.join(wr, on=col("ws_order_number") == col("ret_order"),
               how="left_anti")
    return j.agg(("count_distinct", "ws_order_number", "order_count"),
                 ("sum", "ws_ext_ship_cost", "total_shipping_cost"),
                 ("sum", "ws_net_profit", "total_net_profit"))


def q94_pandas(t):
    ws = t["web_sales"]
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= 730) & (d.d_date_sk <= 790)].d_date_sk
    ca = t["customer_address"]
    caa = ca[ca.ca_state == "TX"].ca_address_sk
    web = t["web_site"]
    webb = web[web.web_company_name == "pri"].web_site_sk
    nwh = ws.groupby("ws_order_number").ws_warehouse_sk.nunique()
    multi = nwh[nwh > 1].index
    j = ws[ws.ws_ship_date_sk.isin(dd) & ws.ws_ship_addr_sk.isin(caa)
           & ws.ws_web_site_sk.isin(webb)
           & ws.ws_order_number.isin(multi)
           & ~ws.ws_order_number.isin(t["web_returns"].wr_order_number)]
    return pd.DataFrame({
        "order_count": [j.ws_order_number.nunique()],
        # min_count=1: SQL SUM over zero rows is NULL, not 0.
        "total_shipping_cost": [j.ws_ext_ship_cost.sum(min_count=1)],
        "total_net_profit": [j.ws_net_profit.sum(min_count=1)]})


QUERIES_EXT2 = {
    "q2": (q2, q2_pandas),
    "q11": (q11, q11_pandas),
    "q12": (q12, q12_pandas),
    "q18": (q18, q18_pandas),
    "q30": (q30, q30_pandas),
    "q31": (q31, q31_pandas),
    "q33": (q33, q33_pandas),
    "q59": (q59, q59_pandas),
    "q74": (q74, q74_pandas),
    "q84": (q84, q84_pandas),
    "q86": (q86, q86_pandas),
    "q21": (q21, q21_pandas),
    "q22": (q22, q22_pandas),
    "q37": (q37, q37_pandas),
    "q38": (q38, q38_pandas),
    "q39": (q39, q39_pandas),
    "q54": (q54, q54_pandas),
    "q62": (q62, q62_pandas),
    "q82": (q82, q82_pandas),
    "q87": (q87, q87_pandas),
    "q92": (q92, q92_pandas),
    "q99": (q99, q99_pandas),
    "q35": (q35, q35_pandas),
    "q44": (q44, q44_pandas),
    "q45": (q45, q45_pandas),
    "q56": (q56, q56_pandas),
    "q60": (q60, q60_pandas),
    "q69": (q69, q69_pandas),
    "q71": (q71, q71_pandas),
    "q90": (q90, q90_pandas),
    "q94": (q94, q94_pandas),
}
