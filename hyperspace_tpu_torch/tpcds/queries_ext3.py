"""Round-5 TPC-DS completion: the final 26 queries (q4 q5 q8 q9 q10 q14
q16 q23 q24 q40 q47 q49 q51 q57 q58 q66 q72 q75 q76 q77 q78 q80 q83 q85
q91 q95) — with these the engine runs ALL 99 TPC-DS queries end to end
three ways (rules on / rules off / pandas oracle), completing the
reference serde's all-TPC-DS property (`index/serde/package.scala:46-49`)
at the ENGINE level.

Shapes follow the official queries over this generator's reduced schema
(`generator.py`); where an official column is absent the closest
generated measure substitutes CONSISTENTLY in engine and oracle (e.g.
ss_coupon_amt stands in for ss_ext_discount_amt in q4's profit formula).
Idioms newly covered here: 3-channel year-over-year growth chains with
>2-way self-joins (q4/q74), channel rollup reports (q5/q77/q80),
zip-prefix INTERSECT (q8), projection-level scalar subqueries (q9),
OR-of-EXISTS via channel union (q10), cross-channel frequent-item and
best-customer filters (q14/q23), paired-purchase self joins (q24/q64),
monthly-deviation series with neighbor self-joins standing in for
LAG/LEAD (q47/q57), windowed cumulative medians (q51), rank-of-ratio
windows (q49), shipping pivot reports (q66), inventory week-over-week
(q72), channel-vs-returns anti semantics (q78/q87), and multi-warehouse
shipment probes (q95/q94)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from hyperspace_tpu_torch.plan.expr import CaseWhen, col, lit
from hyperspace_tpu_torch.tpcds.queries_ext import _rollup_union


def _sum_case(cond, value, alias):
    return ("sum", CaseWhen([(cond, value)]), alias)


# ---------------------------------------------------------------------------
# q4 — 3-channel year-over-year growth (the q11 family's full form)
# ---------------------------------------------------------------------------


def _q4_channel(dfs, table, date_col, cust_col, formula_cols, tag):
    prefix = {"store_sales": "ss", "catalog_sales": "cs",
              "web_sales": "ws"}[table]
    a, b, c2, d2 = formula_cols
    s = dfs[table].select(
        col(cust_col).alias("cust_sk"), col(date_col).alias("sold_date"),
        ((col(a) - col(b) + col(c2) - col(d2)) / lit(2.0)).alias("profit"))
    dd = dfs["date_dim"].select("d_date_sk", "d_year")
    j = s.join(dd, on=col("sold_date") == col("d_date_sk"))
    cust = dfs["customer"].select(
        col("c_customer_sk").alias("cc_sk"), "c_customer_id",
        "c_first_name", "c_last_name")
    j = j.join(cust, on=col("cust_sk") == col("cc_sk"))
    return (j.group_by("c_customer_id", "c_first_name", "c_last_name",
                       "d_year")
            .agg(("sum", "profit", f"year_total_{tag}")))


def q4(dfs):
    st = _q4_channel(dfs, "store_sales", "ss_sold_date_sk",
                     "ss_customer_sk",
                     ("ss_ext_list_price", "ss_ext_wholesale_cost",
                      "ss_ext_sales_price", "ss_coupon_amt"), "s")
    ct = _q4_channel(dfs, "catalog_sales", "cs_sold_date_sk",
                     "cs_bill_customer_sk",
                     ("cs_ext_list_price", "cs_ext_discount_amt",
                      "cs_ext_sales_price", "cs_coupon_amt"), "c")
    wt = _q4_channel(dfs, "web_sales", "ws_sold_date_sk",
                     "ws_bill_customer_sk",
                     ("ws_ext_list_price", "ws_ext_discount_amt",
                      "ws_ext_sales_price", "ws_ext_wholesale_cost"), "w")

    def year(df2, yr, tag, keep_names=False):
        cols = [col("c_customer_id").alias(f"id_{tag}"),
                col(f"year_total_{df2._tag}").alias(f"total_{tag}")]
        if keep_names:
            cols += ["c_first_name", "c_last_name"]
        return df2.filter(col("d_year") == lit(yr)).select(*cols)

    # tag the channel frames so `year` can pick the right total column
    st._tag, ct._tag, wt._tag = "s", "c", "w"
    s1 = year(st, 1999, "s1", keep_names=True)
    s2 = year(st, 2000, "s2")
    c1 = year(ct, 1999, "c1")
    c2_ = year(ct, 2000, "c2")
    w1 = year(wt, 1999, "w1")
    w2 = year(wt, 2000, "w2")
    j = s1.join(s2, on=col("id_s1") == col("id_s2"))
    j = j.join(c1, on=col("id_s1") == col("id_c1"))
    j = j.join(c2_, on=col("id_s1") == col("id_c2"))
    j = j.join(w1, on=col("id_s1") == col("id_w1"))
    j = j.join(w2, on=col("id_s1") == col("id_w2"))
    j = j.filter((col("total_s1") > lit(0)) & (col("total_c1") > lit(0))
                 & (col("total_w1") > lit(0)))
    j = j.filter((col("total_c2") / col("total_c1"))
                 > (col("total_s2") / col("total_s1")))
    j = j.filter((col("total_c2") / col("total_c1"))
                 > (col("total_w2") / col("total_w1")))
    return (j.select(col("id_s1").alias("customer_id"), "c_first_name",
                     "c_last_name")
            .sort("customer_id", "c_first_name", "c_last_name").limit(100))


def _q4_pd_channel(t, table, date_col, cust_col, formula_cols):
    a, b, c2, d2 = formula_cols
    s = t[table].copy()
    s["profit"] = (s[a] - s[b] + s[c2] - s[d2]) / 2.0
    d = t["date_dim"][["d_date_sk", "d_year"]]
    j = s.merge(d, left_on=date_col, right_on="d_date_sk")
    cust = t["customer"][["c_customer_sk", "c_customer_id", "c_first_name",
                          "c_last_name"]]
    j = j.merge(cust, left_on=cust_col, right_on="c_customer_sk")
    return j.groupby(["c_customer_id", "c_first_name", "c_last_name",
                      "d_year"], as_index=False).agg(
        year_total=("profit", "sum"))


def q4_pandas(t):
    st = _q4_pd_channel(t, "store_sales", "ss_sold_date_sk",
                        "ss_customer_sk",
                        ("ss_ext_list_price", "ss_ext_wholesale_cost",
                         "ss_ext_sales_price", "ss_coupon_amt"))
    ct = _q4_pd_channel(t, "catalog_sales", "cs_sold_date_sk",
                        "cs_bill_customer_sk",
                        ("cs_ext_list_price", "cs_ext_discount_amt",
                         "cs_ext_sales_price", "cs_coupon_amt"))
    wt = _q4_pd_channel(t, "web_sales", "ws_sold_date_sk",
                        "ws_bill_customer_sk",
                        ("ws_ext_list_price", "ws_ext_discount_amt",
                         "ws_ext_sales_price", "ws_ext_wholesale_cost"))

    def yr(df, y):
        return df[df.d_year == y].set_index("c_customer_id").year_total

    s1, s2 = yr(st, 1999), yr(st, 2000)
    c1, c2_ = yr(ct, 1999), yr(ct, 2000)
    w1, w2 = yr(wt, 1999), yr(wt, 2000)
    ids = s1[s1 > 0].index
    ids = ids.intersection(c1[c1 > 0].index).intersection(w1[w1 > 0].index)
    ids = ids.intersection(s2.index).intersection(c2_.index) \
             .intersection(w2.index)
    keep = [i for i in ids
            if (c2_[i] / c1[i] > s2[i] / s1[i])
            and (c2_[i] / c1[i] > w2[i] / w1[i])]
    names = (t["customer"].drop_duplicates("c_customer_id")
             .set_index("c_customer_id"))
    out = pd.DataFrame({
        "customer_id": keep,
        "c_first_name": [names.c_first_name[i] for i in keep],
        "c_last_name": [names.c_last_name[i] for i in keep]})
    return (out.sort_values(["customer_id", "c_first_name", "c_last_name"])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q5 — channel sales/returns/profit ROLLUP report
# ---------------------------------------------------------------------------

_Q5_LO, _Q5_HI = 731, 744  # 14-day report window


def q5(dfs):
    dd = (dfs["date_dim"]
          .filter((col("d_date_sk") >= lit(_Q5_LO))
                  & (col("d_date_sk") <= lit(_Q5_HI)))
          .select("d_date_sk"))

    def channel(sales, s_date, s_id, s_sales, s_profit,
                rets, r_date, r_id, r_ret, r_loss, dim, dim_sk, dim_id,
                label):
        s = dfs[sales].select(
            col(s_date).alias("date_sk"), col(s_id).alias("id_sk"),
            col(s_sales).alias("sales_price"),
            col(s_profit).alias("profit"),
            (col(s_sales) * lit(0.0)).alias("return_amt"),
            (col(s_sales) * lit(0.0)).alias("net_loss"))
        r = dfs[rets].select(
            col(r_date).alias("date_sk"), col(r_id).alias("id_sk"),
            (col(r_ret) * lit(0.0)).alias("sales_price"),
            (col(r_ret) * lit(0.0)).alias("profit"),
            col(r_ret).alias("return_amt"), col(r_loss).alias("net_loss"))
        u = s.union(r)
        u = u.join(dd, on=col("date_sk") == col("d_date_sk"))
        dmf = dfs[dim].select(col(dim_sk).alias("dim_sk"),
                              col(dim_id).alias("id"))
        u = u.join(dmf, on=col("id_sk") == col("dim_sk"))
        return (u.group_by("id")
                .agg(("sum", "sales_price", "sales"),
                     ("sum", "return_amt", "returns_"),
                     ("sum", col("profit") - col("net_loss"), "profit"))
                .with_column("channel", lit(label)))

    st = channel("store_sales", "ss_sold_date_sk", "ss_store_sk",
                 "ss_ext_sales_price", "ss_net_profit",
                 "store_returns", "sr_returned_date_sk", "sr_store_sk",
                 "sr_return_amt", "sr_net_loss",
                 "store", "s_store_sk", "s_store_id", "store channel")
    ct = channel("catalog_sales", "cs_sold_date_sk", "cs_catalog_page_sk",
                 "cs_ext_sales_price", "cs_net_profit",
                 "catalog_returns", "cr_returned_date_sk",
                 "cr_catalog_page_sk", "cr_return_amount", "cr_net_loss",
                 "catalog_page", "cp_catalog_page_sk",
                 "cp_catalog_page_id", "catalog channel")
    wt = channel("web_sales", "ws_sold_date_sk", "ws_web_site_sk",
                 "ws_ext_sales_price", "ws_net_profit",
                 "web_returns", "wr_returned_date_sk", "wr_web_page_sk",
                 "wr_return_amt", "wr_net_loss",
                 "web_site", "web_site_sk", "web_site_id", "web channel")
    # web returns key on web_page in the official query; this generator's
    # wr carries wr_web_page_sk (reduced schema) — the web channel's
    # returns roll up under the page's site via the same id join shape.
    u = st.union(ct).union(wt)
    roll = _rollup_union(u, [("channel", "string"), ("id", "string")],
                         {"sales": ("sum", "sales"),
                          "returns_": ("sum", "returns_"),
                          "profit": ("sum", "profit")}, u.session)
    return (roll.select("channel", "id", "sales", "returns_", "profit")
            .sort("channel", "id").limit(100))


def q5_pandas(t):
    lo, hi = _Q5_LO, _Q5_HI

    def channel(sales, s_date, s_id, s_sales, s_profit,
                rets, r_date, r_id, r_ret, r_loss, dim, dim_sk, dim_id,
                label):
        s = t[sales]
        s = s[(s[s_date] >= lo) & (s[s_date] <= hi)]
        r = t[rets]
        r = r[(r[r_date] >= lo) & (r[r_date] <= hi)]
        dimt = t[dim][[dim_sk, dim_id]]
        sj = s.merge(dimt, left_on=s_id, right_on=dim_sk)
        rj = r.merge(dimt, left_on=r_id, right_on=dim_sk)
        sa = sj.groupby(dim_id).agg(sales=(s_sales, "sum"),
                                    profit=(s_profit, "sum"))
        ra = rj.groupby(dim_id).agg(returns_=(r_ret, "sum"),
                                    net_loss=(r_loss, "sum"))
        m = sa.join(ra, how="outer").fillna(0.0)
        m["profit"] = m["profit"] - m["net_loss"]
        m = m.drop(columns=["net_loss"]).reset_index(names="id")
        m["channel"] = label
        return m

    st = channel("store_sales", "ss_sold_date_sk", "ss_store_sk",
                 "ss_ext_sales_price", "ss_net_profit",
                 "store_returns", "sr_returned_date_sk", "sr_store_sk",
                 "sr_return_amt", "sr_net_loss",
                 "store", "s_store_sk", "s_store_id", "store channel")
    ct = channel("catalog_sales", "cs_sold_date_sk", "cs_catalog_page_sk",
                 "cs_ext_sales_price", "cs_net_profit",
                 "catalog_returns", "cr_returned_date_sk",
                 "cr_catalog_page_sk", "cr_return_amount", "cr_net_loss",
                 "catalog_page", "cp_catalog_page_sk",
                 "cp_catalog_page_id", "catalog channel")
    wt = channel("web_sales", "ws_sold_date_sk", "ws_web_site_sk",
                 "ws_ext_sales_price", "ws_net_profit",
                 "web_returns", "wr_returned_date_sk", "wr_web_page_sk",
                 "wr_return_amt", "wr_net_loss",
                 "web_site", "web_site_sk", "web_site_id", "web channel")
    u = pd.concat([st, ct, wt], ignore_index=True)
    leaf = u.groupby(["channel", "id"], as_index=False).agg(
        sales=("sales", "sum"), returns_=("returns_", "sum"),
        profit=("profit", "sum"))
    mid = u.groupby("channel", as_index=False).agg(
        sales=("sales", "sum"), returns_=("returns_", "sum"),
        profit=("profit", "sum"))
    mid["id"] = np.nan
    top = pd.DataFrame({"channel": [np.nan], "id": [np.nan],
                        "sales": [u.sales.sum()],
                        "returns_": [u.returns_.sum()],
                        "profit": [u.profit.sum()]})
    out = pd.concat([leaf, mid, top], ignore_index=True)
    # ORDER BY ASC places NULL subtotal rows FIRST (Spark semantics, which
    # the engine's SortExec follows).
    return (out[["channel", "id", "sales", "returns_", "profit"]]
            .sort_values(["channel", "id"], na_position="first")
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q8 — store sales where store zip-3 matches (list INTERSECT preferred
# customers' zips)
# ---------------------------------------------------------------------------

_Q8_ZIPS = ["356", "354", "350", "358", "352"]


def q8(dfs):
    zip_list = (dfs["customer_address"]
                .select(col("ca_zip").substr(1, 3).alias("zip3"))
                .filter(col("zip3").isin(*[lit(z) for z in _Q8_ZIPS]))
                .distinct())
    pref = (dfs["customer"].filter(col("c_preferred_cust_flag") == lit("Y"))
            .select("c_current_addr_sk"))
    pref_zips = (pref.join(dfs["customer_address"].select(
        "ca_address_sk", "ca_zip"),
        on=col("c_current_addr_sk") == col("ca_address_sk"))
        .select(col("ca_zip").substr(1, 3).alias("zip3"))
        .distinct())
    zips = zip_list.intersect(pref_zips)
    zips = zips.select(col("zip3").alias("match_zip3"))
    ss = dfs["store_sales"].select("ss_store_sk", "ss_sold_date_sk",
                                   "ss_net_profit")
    dd = (dfs["date_dim"]
          .filter((col("d_year") == lit(2000)) & (col("d_qoy") == lit(1)))
          .select("d_date_sk"))
    j = ss.join(dd, on=col("ss_sold_date_sk") == col("d_date_sk"))
    st = dfs["store"].select("s_store_sk", "s_store_name",
                             col("s_zip").substr(1, 3).alias("s_zip3"))
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.join(zips, on=col("s_zip3") == col("match_zip3"),
               how="left_semi")
    return (j.group_by("s_store_name")
            .agg(("sum", "ss_net_profit", "net_profit"))
            .sort("s_store_name").limit(100))


def q8_pandas(t):
    ca = t["customer_address"]
    zip3 = ca.ca_zip.str[:3]
    in_list = set(zip3[zip3.isin(_Q8_ZIPS)])
    cust = t["customer"]
    pref = cust[cust.c_preferred_cust_flag == "Y"]
    pj = pref.merge(ca[["ca_address_sk", "ca_zip"]],
                    left_on="c_current_addr_sk", right_on="ca_address_sk")
    pref_zips = set(pj.ca_zip.str[:3])
    match = in_list & pref_zips
    ss = t["store_sales"]
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_qoy == 1)].d_date_sk
    j = ss[ss.ss_sold_date_sk.isin(dd)]
    st = t["store"].copy()
    st["s_zip3"] = st.s_zip.str[:3]
    j = j.merge(st[["s_store_sk", "s_store_name", "s_zip3"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j[j.s_zip3.isin(match)]
    return (j.groupby("s_store_name", as_index=False)
            .agg(net_profit=("ss_net_profit", "sum"))
            .sort_values("s_store_name").head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q9 — CASE over bucket-count scalar subqueries, projected from reason
# ---------------------------------------------------------------------------


def q9(dfs):
    ss = dfs["store_sales"]

    def bucket(lo, hi, i):
        rng_f = ((col("ss_quantity") >= lit(lo))
                 & (col("ss_quantity") <= lit(hi)))
        cnt = ss.filter(rng_f).agg(("count", "*", "cnt")).as_scalar()
        then = ss.filter(rng_f).agg(
            ("avg", "ss_ext_tax", "a")).as_scalar()
        els = ss.filter(rng_f).agg(
            ("avg", "ss_net_profit", "a")).as_scalar()
        return CaseWhen([(cnt > lit(20_000 * i), then)],
                        otherwise=els).alias(f"bucket{i}")

    r = dfs["reason"].filter(col("r_reason_sk") == lit(1))
    return r.select(*[bucket(1 + 20 * (i - 1), 20 * i, i)
                      for i in range(1, 6)])


def q9_pandas(t):
    ss = t["store_sales"]
    out = {}
    for i in range(1, 6):
        lo, hi = 1 + 20 * (i - 1), 20 * i
        b = ss[(ss.ss_quantity >= lo) & (ss.ss_quantity <= hi)]
        if len(b) > 20_000 * i:
            out[f"bucket{i}"] = [b.ss_ext_tax.mean()]
        else:
            out[f"bucket{i}"] = [b.ss_net_profit.mean()]
    return pd.DataFrame(out)


# ---------------------------------------------------------------------------
# q10 — county customers active in store AND (web OR catalog), by
# demographics
# ---------------------------------------------------------------------------


def q10(dfs):
    dd = (dfs["date_dim"]
          .filter((col("d_year") == lit(2000)) & (col("d_moy") >= lit(1))
                  & (col("d_moy") <= lit(4)))
          .select("d_date_sk"))
    ss_c = (dfs["store_sales"].select("ss_customer_sk", "ss_sold_date_sk")
            .join(dd, on=col("ss_sold_date_sk") == col("d_date_sk"),
                  how="left_semi")
            .select(col("ss_customer_sk").alias("active_sk")))
    ws_c = (dfs["web_sales"]
            .select("ws_bill_customer_sk", "ws_sold_date_sk")
            .join(dd, on=col("ws_sold_date_sk") == col("d_date_sk"),
                  how="left_semi")
            .select(col("ws_bill_customer_sk").alias("other_sk")))
    cs_c = (dfs["catalog_sales"]
            .select("cs_bill_customer_sk", "cs_sold_date_sk")
            .join(dd, on=col("cs_sold_date_sk") == col("d_date_sk"),
                  how="left_semi")
            .select(col("cs_bill_customer_sk").alias("other_sk")))
    either = ws_c.union(cs_c)  # OR of the two EXISTS
    c = dfs["customer"].select("c_customer_sk", "c_current_addr_sk",
                               "c_current_cdemo_sk")
    ca = (dfs["customer_address"]
          .filter(col("ca_county").isin(lit("Walker County"),
                                        lit("Richland County"),
                                        lit("Gaines County")))
          .select("ca_address_sk"))
    j = c.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    j = j.join(ss_c, on=col("c_customer_sk") == col("active_sk"),
               how="left_semi")
    j = j.join(either, on=col("c_customer_sk") == col("other_sk"),
               how="left_semi")
    cd = dfs["customer_demographics"]
    j = j.join(cd, on=col("c_current_cdemo_sk") == col("cd_demo_sk"))
    return (j.group_by("cd_gender", "cd_marital_status",
                       "cd_education_status", "cd_purchase_estimate",
                       "cd_credit_rating")
            .agg(("count", "*", "cnt"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status",
                  "cd_purchase_estimate", "cd_credit_rating").limit(100))


def q10_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy >= 1) & (d.d_moy <= 4)].d_date_sk
    ss = t["store_sales"]
    ss_c = set(ss[ss.ss_sold_date_sk.isin(dd)].ss_customer_sk)
    ws = t["web_sales"]
    ws_c = set(ws[ws.ws_sold_date_sk.isin(dd)].ws_bill_customer_sk)
    cs = t["catalog_sales"]
    cs_c = set(cs[cs.cs_sold_date_sk.isin(dd)].cs_bill_customer_sk)
    ca = t["customer_address"]
    counties = ca[ca.ca_county.isin(["Walker County", "Richland County",
                                     "Gaines County"])].ca_address_sk
    c = t["customer"]
    j = c[c.c_current_addr_sk.isin(counties)
          & c.c_customer_sk.isin(ss_c)
          & c.c_customer_sk.isin(ws_c | cs_c)]
    j = j.merge(t["customer_demographics"], left_on="c_current_cdemo_sk",
                right_on="cd_demo_sk")
    keys = ["cd_gender", "cd_marital_status", "cd_education_status",
            "cd_purchase_estimate", "cd_credit_rating"]
    return (j.groupby(keys, as_index=False).agg(cnt=("c_customer_sk",
                                                     "count"))
            .sort_values(keys).head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q16 — catalog orders from county call centers: shipped in window,
# multi-warehouse, never returned (q94's catalog twin)
# ---------------------------------------------------------------------------


def q16(dfs):
    cs = dfs["catalog_sales"].select(
        "cs_order_number", "cs_ship_date_sk", "cs_ship_addr_sk",
        "cs_call_center_sk", "cs_warehouse_sk", "cs_ext_ship_cost",
        "cs_net_profit")
    d = (dfs["date_dim"].filter((col("d_date_sk") >= lit(760))
                                & (col("d_date_sk") <= lit(820)))
         .select("d_date_sk"))
    ca = (dfs["customer_address"].filter(col("ca_state") == lit("CA"))
          .select("ca_address_sk"))
    cc = (dfs["call_center"]
          .filter(col("cc_county").isin(lit("Williamson County"),
                                        lit("Walker County")))
          .select("cc_call_center_sk"))
    multi_wh = (dfs["catalog_sales"]
                .select("cs_order_number", "cs_warehouse_sk")
                .group_by("cs_order_number")
                .agg(("count_distinct", "cs_warehouse_sk", "nwh"))
                .filter(col("nwh") > lit(1))
                .select(col("cs_order_number").alias("mw_order")))
    cr = dfs["catalog_returns"].select(
        col("cr_order_number").alias("ret_order"))
    j = cs.join(d, on=col("cs_ship_date_sk") == col("d_date_sk"),
                how="left_semi")
    j = j.join(ca, on=col("cs_ship_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    j = j.join(cc, on=col("cs_call_center_sk") == col("cc_call_center_sk"),
               how="left_semi")
    j = j.join(multi_wh, on=col("cs_order_number") == col("mw_order"),
               how="left_semi")
    j = j.join(cr, on=col("cs_order_number") == col("ret_order"),
               how="left_anti")
    return j.agg(("count_distinct", "cs_order_number", "order_count"),
                 ("sum", "cs_ext_ship_cost", "total_shipping_cost"),
                 ("sum", "cs_net_profit", "total_net_profit"))


def q16_pandas(t):
    cs = t["catalog_sales"]
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= 760) & (d.d_date_sk <= 820)].d_date_sk
    ca = t["customer_address"]
    caa = ca[ca.ca_state == "CA"].ca_address_sk
    cc = t["call_center"]
    ccc = cc[cc.cc_county.isin(["Williamson County",
                                "Walker County"])].cc_call_center_sk
    nwh = cs.groupby("cs_order_number").cs_warehouse_sk.nunique()
    multi = nwh[nwh > 1].index
    j = cs[cs.cs_ship_date_sk.isin(dd) & cs.cs_ship_addr_sk.isin(caa)
           & cs.cs_call_center_sk.isin(ccc)
           & cs.cs_order_number.isin(multi)
           & ~cs.cs_order_number.isin(
               t["catalog_returns"].cr_order_number)]
    return pd.DataFrame({
        "order_count": [j.cs_order_number.nunique()],
        "total_shipping_cost": [j.cs_ext_ship_cost.sum(min_count=1)],
        "total_net_profit": [j.cs_net_profit.sum(min_count=1)]})


# ---------------------------------------------------------------------------
# q40 — catalog sales value before/after a date by warehouse/item, with
# returns netted out
# ---------------------------------------------------------------------------

_Q40_SPLIT = 800


def q40(dfs):
    cs = dfs["catalog_sales"].select("cs_order_number", "cs_item_sk",
                                     "cs_sold_date_sk", "cs_warehouse_sk",
                                     "cs_sales_price")
    cr = dfs["catalog_returns"].select(
        col("cr_order_number").alias("r_order"),
        col("cr_item_sk").alias("r_item"), "cr_refunded_cash")
    j = cs.join(cr, on=(col("cs_order_number") == col("r_order"))
                & (col("cs_item_sk") == col("r_item")), how="left_outer")
    w = dfs["warehouse"].select("w_warehouse_sk", "w_state")
    j = j.join(w, on=col("cs_warehouse_sk") == col("w_warehouse_sk"))
    it = (dfs["item"]
          .filter((col("i_current_price") >= lit(0.99))
                  & (col("i_current_price") <= lit(1.49)))
          .select("i_item_sk", "i_item_id"))
    j = j.join(it, on=col("cs_item_sk") == col("i_item_sk"))
    dd = (dfs["date_dim"]
          .filter((col("d_date_sk") >= lit(_Q40_SPLIT - 30))
                  & (col("d_date_sk") <= lit(_Q40_SPLIT + 30)))
          .select("d_date_sk"))
    j = j.join(dd, on=col("cs_sold_date_sk") == col("d_date_sk"))
    value = (col("cs_sales_price")
             - CaseWhen([(col("cr_refunded_cash").is_not_null(),
                          col("cr_refunded_cash"))], otherwise=lit(0.0)))
    before = CaseWhen([(col("cs_sold_date_sk") < lit(_Q40_SPLIT), value)])
    after = CaseWhen([(col("cs_sold_date_sk") >= lit(_Q40_SPLIT), value)])
    return (j.group_by("w_state", "i_item_id")
            .agg(("sum", before, "sales_before"),
                 ("sum", after, "sales_after"))
            .sort("w_state", "i_item_id").limit(100))


def q40_pandas(t):
    cs = t["catalog_sales"]
    cr = t["catalog_returns"][["cr_order_number", "cr_item_sk",
                               "cr_refunded_cash"]]
    j = cs.merge(cr, how="left",
                 left_on=["cs_order_number", "cs_item_sk"],
                 right_on=["cr_order_number", "cr_item_sk"])
    j = j.merge(t["warehouse"][["w_warehouse_sk", "w_state"]],
                left_on="cs_warehouse_sk", right_on="w_warehouse_sk")
    it = t["item"]
    it = it[(it.i_current_price >= 0.99) & (it.i_current_price <= 1.49)]
    j = j.merge(it[["i_item_sk", "i_item_id"]], left_on="cs_item_sk",
                right_on="i_item_sk")
    j = j[(j.cs_sold_date_sk >= _Q40_SPLIT - 30)
          & (j.cs_sold_date_sk <= _Q40_SPLIT + 30)]
    value = j.cs_sales_price - j.cr_refunded_cash.fillna(0.0)
    j = j.assign(
        sales_before=value.where(j.cs_sold_date_sk < _Q40_SPLIT),
        sales_after=value.where(j.cs_sold_date_sk >= _Q40_SPLIT))
    # SQL SUM over an all-NULL group is NULL, not 0 (matches the engine).
    return (j.groupby(["w_state", "i_item_id"], as_index=False)
            .agg(sales_before=("sales_before",
                               lambda s: s.sum(min_count=1)),
                 sales_after=("sales_after",
                              lambda s: s.sum(min_count=1)))
            .sort_values(["w_state", "i_item_id"]).head(100)
            .reset_index(drop=True))


QUERIES_EXT3: Dict[str, tuple] = {
    "q4": (q4, q4_pandas),
    "q5": (q5, q5_pandas),
    "q8": (q8, q8_pandas),
    "q9": (q9, q9_pandas),
    "q10": (q10, q10_pandas),
    "q16": (q16, q16_pandas),
    "q40": (q40, q40_pandas),
}


# ---------------------------------------------------------------------------
# q47 / q57 — monthly sales deviating from the partition average, with
# prior/next month via rank self-joins (LAG/LEAD expressed relationally)
# ---------------------------------------------------------------------------


def _q47_v1(dfs, sales, date_col, sk_col, measure, extra_dims):
    """Monthly sums + partition avg + month rank for q47 (store dims) /
    q57 (call-center dims). `extra_dims` = [(dim_df_name, dim_sk, dim join
    col, [dim out cols])]."""
    dim_join_cols = [join_col for _, _, join_col, _ in extra_dims]
    s = dfs[sales].select(col(date_col).alias("date_sk"),
                          col(sk_col).alias("item_sk"),
                          col(measure).alias("amt"), *dim_join_cols)
    dd = dfs["date_dim"].select("d_date_sk", "d_year", "d_moy")
    j = s.join(dd, on=col("date_sk") == col("d_date_sk"))
    it = dfs["item"].select("i_item_sk", "i_category", "i_brand")
    j = j.join(it, on=col("item_sk") == col("i_item_sk"))
    dim_cols = []
    for dim, dim_sk, join_col, out_cols in extra_dims:
        dmf = dfs[dim].select(dim_sk, *out_cols)
        j = j.join(dmf, on=col(join_col) == col(dim_sk))
        dim_cols.extend(out_cols)
    part = ["i_category", "i_brand"] + dim_cols
    sums = (j.group_by(*part, "d_year", "d_moy")
            .agg(("sum", "amt", "sum_sales")))
    v1 = sums.window(part + ["d_year"],
                     avg_monthly_sales=("avg", "sum_sales"))
    v1 = v1.window(part, order_by=["d_year", "d_moy"], rn=("rank", "*"))
    return v1, part


def _q47_build(dfs, sales, date_col, sk_col, join_extra, measure):
    v1, part = _q47_v1(dfs, sales, date_col, sk_col, measure, join_extra)
    # LAG/LEAD as rank-offset self-joins: the offset is projected into a
    # column first (equi-joins compare columns directly).
    lag = v1.select(*[col(c).alias(f"lag_{c}") for c in part],
                    (col("rn") + lit(1)).alias("lag_rn"),
                    col("sum_sales").alias("psum"))
    lead = v1.select(*[col(c).alias(f"lead_{c}") for c in part],
                     (col("rn") - lit(1)).alias("lead_rn"),
                     col("sum_sales").alias("nsum"))
    j = v1.filter((col("d_year") == lit(2000))
                  & (col("avg_monthly_sales") > lit(0)))
    onl = None
    for c in part:
        e = col(c) == col(f"lag_{c}")
        onl = e if onl is None else (onl & e)
    onl = onl & (col("rn") == col("lag_rn"))
    j = j.join(lag, on=onl)
    onr = None
    for c in part:
        e = col(c) == col(f"lead_{c}")
        onr = e if onr is None else (onr & e)
    onr = onr & (col("rn") == col("lead_rn"))
    j = j.join(lead, on=onr)
    dev = (col("sum_sales") - col("avg_monthly_sales"))
    j = j.filter((dev / col("avg_monthly_sales") > lit(0.1))
                 | (dev / col("avg_monthly_sales") < lit(-0.1)))
    return (j.select(*part, "d_year", "d_moy", "sum_sales",
                     "avg_monthly_sales", "psum", "nsum")
            .sort(*part, "d_year", "d_moy").limit(100))


def q47(dfs):
    return _q47_build(
        dfs, "store_sales", "ss_sold_date_sk", "ss_item_sk",
        [("store", "s_store_sk", "ss_store_sk",
          ["s_store_name", "s_company_name"])], "ss_sales_price")


def _q47_pd(t, sales, date_col, sk_col, store_merge, measure):
    s = t[sales]
    d = t["date_dim"][["d_date_sk", "d_year", "d_moy"]]
    j = s.merge(d, left_on=date_col, right_on="d_date_sk")
    it = t["item"][["i_item_sk", "i_category", "i_brand"]]
    j = j.merge(it, left_on=sk_col, right_on="i_item_sk")
    dim_cols = []
    for dim, dim_sk, join_col, out_cols in store_merge:
        j = j.merge(t[dim][[dim_sk] + out_cols], left_on=join_col,
                    right_on=dim_sk)
        dim_cols.extend(out_cols)
    part = ["i_category", "i_brand"] + dim_cols
    sums = j.groupby(part + ["d_year", "d_moy"], as_index=False).agg(
        sum_sales=(measure, "sum"))
    sums["avg_monthly_sales"] = sums.groupby(
        part + ["d_year"]).sum_sales.transform("mean")
    sums = sums.sort_values(part + ["d_year", "d_moy"])
    sums["rn"] = sums.groupby(part).cumcount() + 1
    lag = sums[part + ["rn", "sum_sales"]].rename(
        columns={"sum_sales": "psum", "rn": "lag_rn"})
    lead = sums[part + ["rn", "sum_sales"]].rename(
        columns={"sum_sales": "nsum", "rn": "lead_rn"})
    v = sums[(sums.d_year == 2000) & (sums.avg_monthly_sales > 0)]
    lag = lag.assign(rn=lag.lag_rn + 1)
    lead = lead.assign(rn=lead.lead_rn - 1)
    j2 = v.merge(lag, on=part + ["rn"]).merge(lead, on=part + ["rn"])
    dev = (j2.sum_sales - j2.avg_monthly_sales) / j2.avg_monthly_sales
    j2 = j2[(dev > 0.1) | (dev < -0.1)]
    out = j2[part + ["d_year", "d_moy", "sum_sales", "avg_monthly_sales",
                     "psum", "nsum"]]
    return (out.sort_values(part + ["d_year", "d_moy"]).head(100)
            .reset_index(drop=True))


def q47_pandas(t):
    return _q47_pd(t, "store_sales", "ss_sold_date_sk", "ss_item_sk",
                   [("store", "s_store_sk", "ss_store_sk",
                     ["s_store_name", "s_company_name"])],
                   "ss_sales_price")


def q57(dfs):
    return _q47_build(
        dfs, "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
        [("call_center", "cc_call_center_sk", "cs_call_center_sk",
          ["cc_name"])], "cs_sales_price")


def q57_pandas(t):
    return _q47_pd(t, "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                   [("call_center", "cc_call_center_sk",
                     "cs_call_center_sk", ["cc_name"])], "cs_sales_price")


# ---------------------------------------------------------------------------
# q49 — worst return ratios per channel, rank-of-ratio windows, union
# ---------------------------------------------------------------------------


def _q49_channel(dfs, label, sales, s_item, s_order, s_date, s_qty, s_paid,
                 rets, r_item, r_order, r_qty, r_amt):
    s = dfs[sales].select(
        col(s_item).alias("item"), col(s_order).alias("order_"),
        col(s_date).alias("date_sk"), col(s_qty).alias("qty"),
        col(s_paid).alias("paid"))
    r = dfs[rets].select(
        col(r_item).alias("r_item"), col(r_order).alias("r_order"),
        col(r_qty).alias("ret_qty"), col(r_amt).alias("ret_amt"))
    dd = (dfs["date_dim"]
          .filter((col("d_year") == lit(2000)) & (col("d_moy") == lit(12)))
          .select("d_date_sk"))
    j = s.join(dd, on=col("date_sk") == col("d_date_sk"), how="left_semi")
    j = j.filter((col("qty") > lit(0)) & (col("paid") > lit(0)))
    j = j.join(r, on=(col("order_") == col("r_order"))
               & (col("item") == col("r_item")), how="left_outer")
    coal_q = CaseWhen([(col("ret_qty").is_not_null(), col("ret_qty"))],
                      otherwise=lit(0))
    coal_a = CaseWhen([(col("ret_amt").is_not_null(), col("ret_amt"))],
                      otherwise=lit(0.0))
    g = (j.group_by("item")
         .agg(("sum", coal_q, "ret_q"), ("sum", "qty", "qty_sum"),
              ("sum", coal_a, "ret_a"), ("sum", "paid", "paid_sum")))
    g = g.with_column("return_ratio",
                      col("ret_q") / col("qty_sum"))
    g = g.with_column("currency_ratio",
                      col("ret_a") / col("paid_sum"))
    g = g.with_column("one", lit(1))
    g = g.window(["one"], order_by=["return_ratio"],
                 return_rank=("dense_rank", "*"))
    g = g.window(["one"], order_by=["currency_ratio"],
                 currency_rank=("dense_rank", "*"))
    g = g.filter((col("return_rank") <= lit(10))
                 | (col("currency_rank") <= lit(10)))
    return g.select(lit(label).alias("channel"), "item",
                    "return_ratio", "return_rank", "currency_rank")


def q49(dfs):
    w = _q49_channel(dfs, "web", "web_sales", "ws_item_sk",
                     "ws_order_number", "ws_sold_date_sk", "ws_quantity",
                     "ws_net_paid", "web_returns", "wr_item_sk",
                     "wr_order_number", "wr_return_quantity",
                     "wr_return_amt")
    c = _q49_channel(dfs, "catalog", "catalog_sales", "cs_item_sk",
                     "cs_order_number", "cs_sold_date_sk", "cs_quantity",
                     "cs_net_paid", "catalog_returns", "cr_item_sk",
                     "cr_order_number", "cr_return_quantity",
                     "cr_return_amount")
    s = _q49_channel(dfs, "store", "store_sales", "ss_item_sk",
                     "ss_ticket_number", "ss_sold_date_sk", "ss_quantity",
                     "ss_net_paid", "store_returns", "sr_item_sk",
                     "sr_ticket_number", "sr_return_quantity",
                     "sr_return_amt")
    u = w.union(c).union(s).distinct()
    return (u.sort("channel", "return_rank", "currency_rank", "item")
            .limit(100))


def _q49_pd_channel(t, label, sales, s_item, s_order, s_date, s_qty,
                    s_paid, rets, r_item, r_order, r_qty, r_amt):
    s = t[sales]
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_moy == 12)].d_date_sk
    j = s[s[s_date].isin(dd) & (s[s_qty] > 0) & (s[s_paid] > 0)]
    r = t[rets][[r_item, r_order, r_qty, r_amt]]
    j = j.merge(r, how="left", left_on=[s_order, s_item],
                right_on=[r_order, r_item])
    g = j.groupby(s_item).agg(
        ret_q=(r_qty, lambda x: x.fillna(0).sum()),
        qty_sum=(s_qty, "sum"),
        ret_a=(r_amt, lambda x: x.fillna(0).sum()),
        paid_sum=(s_paid, "sum"))
    # fillna-inside-agg misses rows where the LEFT side had no match at
    # all (NaN group contributions are dropped); recompute robustly:
    g["ret_q"] = j.assign(v=j[r_qty].fillna(0)).groupby(s_item).v.sum()
    g["ret_a"] = j.assign(v=j[r_amt].fillna(0.0)).groupby(s_item).v.sum()
    g = g.reset_index(names="item")
    g["return_ratio"] = g.ret_q / g.qty_sum
    g["currency_ratio"] = g.ret_a / g.paid_sum
    g["return_rank"] = g.return_ratio.rank(method="dense").astype(int)
    g["currency_rank"] = g.currency_ratio.rank(method="dense").astype(int)
    g = g[(g.return_rank <= 10) | (g.currency_rank <= 10)]
    g = g.assign(channel=label)
    return g[["channel", "item", "return_ratio", "return_rank",
              "currency_rank"]]


def q49_pandas(t):
    w = _q49_pd_channel(t, "web", "web_sales", "ws_item_sk",
                        "ws_order_number", "ws_sold_date_sk",
                        "ws_quantity", "ws_net_paid", "web_returns",
                        "wr_item_sk", "wr_order_number",
                        "wr_return_quantity", "wr_return_amt")
    c = _q49_pd_channel(t, "catalog", "catalog_sales", "cs_item_sk",
                        "cs_order_number", "cs_sold_date_sk",
                        "cs_quantity", "cs_net_paid", "catalog_returns",
                        "cr_item_sk", "cr_order_number",
                        "cr_return_quantity", "cr_return_amount")
    s = _q49_pd_channel(t, "store", "store_sales", "ss_item_sk",
                        "ss_ticket_number", "ss_sold_date_sk",
                        "ss_quantity", "ss_net_paid", "store_returns",
                        "sr_item_sk", "sr_ticket_number",
                        "sr_return_quantity", "sr_return_amt")
    u = pd.concat([w, c, s], ignore_index=True).drop_duplicates()
    return (u.sort_values(["channel", "return_rank", "currency_rank",
                           "item"]).head(100).reset_index(drop=True))


QUERIES_EXT3.update({
    "q47": (q47, q47_pandas),
    "q49": (q49, q49_pandas),
    "q57": (q57, q57_pandas),
})


# ---------------------------------------------------------------------------
# q51 — web vs store cumulative daily revenue per item (running-sum +
# running-max windows over a FULL OUTER join)
# ---------------------------------------------------------------------------


def q51(dfs):
    dd = (dfs["date_dim"]
          .filter((col("d_month_seq") >= lit(24))
                  & (col("d_month_seq") <= lit(27)))
          .select("d_date_sk"))

    def daily(sales, item, date, price, tag):
        s = dfs[sales].select(col(item).alias(f"{tag}_item"),
                              col(date).alias("date_sk"),
                              col(price).alias("price"))
        s = s.join(dd, on=col("date_sk") == col("d_date_sk"),
                   how="left_semi")
        g = (s.group_by(f"{tag}_item", "date_sk")
             .agg(("sum", "price", f"{tag}_day")))
        return g.window([f"{tag}_item"], order_by=["date_sk"],
                        **{f"{tag}_cume": ("sum", f"{tag}_day")}) \
                .select(f"{tag}_item", col("date_sk").alias(f"{tag}_date"),
                        f"{tag}_cume")

    web = daily("web_sales", "ws_item_sk", "ws_sold_date_sk",
                "ws_sales_price", "web")
    store = daily("store_sales", "ss_item_sk", "ss_sold_date_sk",
                  "ss_sales_price", "store")
    j = web.join(store, on=(col("web_item") == col("store_item"))
                 & (col("web_date") == col("store_date")),
                 how="full_outer")
    item_sk = CaseWhen([(col("web_item").is_not_null(), col("web_item"))],
                       otherwise=col("store_item"))
    date_sk = CaseWhen([(col("web_date").is_not_null(), col("web_date"))],
                       otherwise=col("store_date"))
    j = j.select(item_sk.alias("item_sk"), date_sk.alias("d_date_sk2"),
                 "web_cume", "store_cume")
    j = j.window(["item_sk"], order_by=["d_date_sk2"],
                 web_cumulative=("max", "web_cume"),
                 store_cumulative=("max", "store_cume"))
    j = j.filter(col("web_cumulative") > col("store_cumulative"))
    return (j.select("item_sk", "d_date_sk2", "web_cumulative",
                     "store_cumulative")
            .sort("item_sk", "d_date_sk2").limit(100))


def q51_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 24) & (d.d_month_seq <= 27)].d_date_sk

    def daily(sales, item, date, price, tag):
        s = t[sales]
        s = s[s[date].isin(dd)]
        g = (s.groupby([item, date], as_index=False)
             .agg(day=(price, "sum"))
             .rename(columns={item: f"{tag}_item", date: f"{tag}_date"}))
        g = g.sort_values([f"{tag}_item", f"{tag}_date"])
        g[f"{tag}_cume"] = g.groupby(f"{tag}_item").day.cumsum()
        return g[[f"{tag}_item", f"{tag}_date", f"{tag}_cume"]]

    web = daily("web_sales", "ws_item_sk", "ws_sold_date_sk",
                "ws_sales_price", "web")
    store = daily("store_sales", "ss_item_sk", "ss_sold_date_sk",
                  "ss_sales_price", "store")
    j = web.merge(store, how="outer",
                  left_on=["web_item", "web_date"],
                  right_on=["store_item", "store_date"])
    j["item_sk"] = j.web_item.fillna(j.store_item)
    j["d_date_sk2"] = j.web_date.fillna(j.store_date)
    j = j.sort_values(["item_sk", "d_date_sk2"], kind="stable")
    # SQL MAX OVER skips NULLs and carries the running max through them;
    # pandas cummax leaves NaN at NaN rows — forward-fill per partition.
    j["web_cumulative"] = j.groupby("item_sk").web_cume.cummax()
    j["web_cumulative"] = j.groupby("item_sk").web_cumulative.ffill()
    j["store_cumulative"] = j.groupby("item_sk").store_cume.cummax()
    j["store_cumulative"] = j.groupby("item_sk").store_cumulative.ffill()
    j = j[j.web_cumulative > j.store_cumulative]
    out = j[["item_sk", "d_date_sk2", "web_cumulative",
             "store_cumulative"]]
    return (out.sort_values(["item_sk", "d_date_sk2"]).head(100)
            .reset_index(drop=True))


# ---------------------------------------------------------------------------
# q58 — items with balanced revenue across all three channels for one
# report week (scalar-subquery week lookup)
# ---------------------------------------------------------------------------

_Q58_DATE = 740


def q58(dfs):
    # Official q58 brackets one report WEEK via a date_dim subquery; this
    # generator's weekly density is too thin for 3-channel overlap, so
    # the same scalar-subquery shape looks up the date's MONTH (and the
    # balance band widens 0.9/1.1 -> 0.7/1.3), oracle in lockstep.
    month = (dfs["date_dim"].filter(col("d_date_sk") == lit(_Q58_DATE))
             .select("d_month_seq").as_scalar())
    wk_days = (dfs["date_dim"].filter(col("d_month_seq") == month)
               .select("d_date_sk"))

    def rev(sales, item, date, price, tag):
        s = dfs[sales].select(col(item).alias("item_sk"),
                              col(date).alias("date_sk"),
                              col(price).alias("price"))
        s = s.join(wk_days, on=col("date_sk") == col("d_date_sk"),
                   how="left_semi")
        it = dfs["item"].select("i_item_sk", "i_item_id")
        s = s.join(it, on=col("item_sk") == col("i_item_sk"))
        return (s.group_by("i_item_id")
                .agg(("sum", "price", f"{tag}_rev"))
                .select(col("i_item_id").alias(f"{tag}_id"),
                        f"{tag}_rev"))

    ss = rev("store_sales", "ss_item_sk", "ss_sold_date_sk",
             "ss_ext_sales_price", "ss")
    cs = rev("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
             "cs_ext_sales_price", "cs")
    ws = rev("web_sales", "ws_item_sk", "ws_sold_date_sk",
             "ws_ext_sales_price", "ws")
    j = ss.join(cs, on=col("ss_id") == col("cs_id"))
    j = j.join(ws, on=col("ss_id") == col("ws_id"))
    avg3 = ((col("ss_rev") + col("cs_rev") + col("ws_rev")) / lit(3.0))
    j = j.with_column("rev_avg", avg3)
    for c in ("ss_rev", "cs_rev", "ws_rev"):
        j = j.filter((col(c) >= col("rev_avg") * lit(0.7))
                     & (col(c) <= col("rev_avg") * lit(1.3)))
    return (j.select(col("ss_id").alias("item_id"), "ss_rev", "cs_rev",
                     "ws_rev", "rev_avg")
            .sort("item_id", "ss_rev").limit(100))


def q58_pandas(t):
    d = t["date_dim"]
    month = d[d.d_date_sk == _Q58_DATE].d_month_seq.iloc[0]
    wk_days = d[d.d_month_seq == month].d_date_sk

    def rev(sales, item, date, price, tag):
        s = t[sales]
        s = s[s[date].isin(wk_days)]
        it = t["item"][["i_item_sk", "i_item_id"]]
        s = s.merge(it, left_on=item, right_on="i_item_sk")
        return (s.groupby("i_item_id", as_index=False)
                .agg(**{f"{tag}_rev": (price, "sum")}))

    ss = rev("store_sales", "ss_item_sk", "ss_sold_date_sk",
             "ss_ext_sales_price", "ss")
    cs = rev("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
             "cs_ext_sales_price", "cs")
    ws = rev("web_sales", "ws_item_sk", "ws_sold_date_sk",
             "ws_ext_sales_price", "ws")
    j = ss.merge(cs, on="i_item_id").merge(ws, on="i_item_id")
    j["rev_avg"] = (j.ss_rev + j.cs_rev + j.ws_rev) / 3.0
    for c in ("ss_rev", "cs_rev", "ws_rev"):
        j = j[(j[c] >= 0.7 * j.rev_avg) & (j[c] <= 1.3 * j.rev_avg)]
    j = j.rename(columns={"i_item_id": "item_id"})
    return (j[["item_id", "ss_rev", "cs_rev", "ws_rev", "rev_avg"]]
            .sort_values(["item_id", "ss_rev"]).head(100)
            .reset_index(drop=True))


# ---------------------------------------------------------------------------
# q66 — warehouse 12-month shipping pivot over web + catalog, by carrier
# ---------------------------------------------------------------------------


def _q66_channel(dfs, sales, date_col, time_col, sm_col, wh_col, price,
                 qty):
    s = dfs[sales].select(col(date_col).alias("date_sk"),
                          col(time_col).alias("time_sk"),
                          col(sm_col).alias("sm_sk"),
                          col(wh_col).alias("wh_sk"),
                          col(price).alias("price"),
                          col(qty).alias("qty"))
    dd = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk", "d_moy"))
    s = s.join(dd, on=col("date_sk") == col("d_date_sk"))
    # time keys are seconds-of-day in this generator: the official
    # t_hour-window time_dim join expresses directly as a range filter.
    s = s.filter((col("time_sk") >= lit(9 * 3600))
                 & (col("time_sk") < lit(18 * 3600)))
    sm = (dfs["ship_mode"]
          .filter(col("sm_carrier").isin("UPS", "FedEx"))
          .select("sm_ship_mode_sk"))
    s = s.join(sm, on=col("sm_sk") == col("sm_ship_mode_sk"),
               how="left_semi")
    w = dfs["warehouse"].select("w_warehouse_sk", "w_warehouse_name",
                                "w_warehouse_sq_ft", "w_city", "w_county",
                                "w_state", "w_country")
    s = s.join(w, on=col("wh_sk") == col("w_warehouse_sk"))
    aggs = []
    for m in range(1, 13):
        aggs.append(_sum_case(col("d_moy") == lit(m),
                              col("price") * col("qty"), f"m{m}_sales"))
    return (s.group_by("w_warehouse_name", "w_warehouse_sq_ft", "w_city",
                       "w_county", "w_state", "w_country")
            .agg(*aggs))


def q66(dfs):
    ws = _q66_channel(dfs, "web_sales", "ws_sold_date_sk",
                      "ws_sold_time_sk", "ws_ship_mode_sk",
                      "ws_warehouse_sk", "ws_ext_sales_price",
                      "ws_quantity")
    cs = _q66_channel(dfs, "catalog_sales", "cs_sold_date_sk",
                      "cs_sold_time_sk", "cs_ship_mode_sk",
                      "cs_warehouse_sk", "cs_sales_price", "cs_quantity")
    u = ws.union(cs)
    keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
            "w_state", "w_country"]
    aggs = [("sum", f"m{m}_sales", f"m{m}_sales") for m in range(1, 13)]
    return (u.group_by(*keys).agg(*aggs)
            .sort("w_warehouse_name").limit(100))


def _q66_pd_channel(t, sales, date_col, time_col, sm_col, wh_col, price,
                    qty):
    s = t[sales]
    d = t["date_dim"]
    dd = d[d.d_year == 2000][["d_date_sk", "d_moy"]]
    s = s.merge(dd, left_on=date_col, right_on="d_date_sk")
    s = s[(s[time_col] >= 9 * 3600) & (s[time_col] < 18 * 3600)]
    sm = t["ship_mode"]
    smm = sm[sm.sm_carrier.isin(["UPS", "FedEx"])].sm_ship_mode_sk
    s = s[s[sm_col].isin(smm)]
    w = t["warehouse"]
    s = s.merge(w, left_on=wh_col, right_on="w_warehouse_sk")
    keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
            "w_state", "w_country"]
    val = s[price] * s[qty]
    for m in range(1, 13):
        s[f"m{m}_sales"] = val.where(s.d_moy == m)
    return s.groupby(keys, as_index=False).agg(
        **{f"m{m}_sales": (f"m{m}_sales", lambda x: x.sum(min_count=1))
           for m in range(1, 13)})


def q66_pandas(t):
    ws = _q66_pd_channel(t, "web_sales", "ws_sold_date_sk",
                         "ws_sold_time_sk", "ws_ship_mode_sk",
                         "ws_warehouse_sk", "ws_ext_sales_price",
                         "ws_quantity")
    cs = _q66_pd_channel(t, "catalog_sales", "cs_sold_date_sk",
                         "cs_sold_time_sk", "cs_ship_mode_sk",
                         "cs_warehouse_sk", "cs_sales_price",
                         "cs_quantity")
    u = pd.concat([ws, cs], ignore_index=True)
    keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
            "w_state", "w_country"]
    out = u.groupby(keys, as_index=False).agg(
        **{f"m{m}_sales": (f"m{m}_sales",
                           lambda x: x.sum(min_count=1))
           for m in range(1, 13)})
    return (out.sort_values("w_warehouse_name").head(100)
            .reset_index(drop=True))


QUERIES_EXT3.update({
    "q51": (q51, q51_pandas),
    "q58": (q58, q58_pandas),
    "q66": (q66, q66_pandas),
})


# ---------------------------------------------------------------------------
# q72 — catalog orders vs inventory in the order's week (promo split)
# ---------------------------------------------------------------------------


def q72(dfs):
    cs = dfs["catalog_sales"].select(
        "cs_item_sk", "cs_sold_date_sk", "cs_ship_date_sk", "cs_promo_sk",
        "cs_bill_customer_sk", "cs_quantity", "cs_order_number")
    d1 = dfs["date_dim"].select("d_date_sk", "d_week_seq")
    j = cs.join(d1, on=col("cs_sold_date_sk") == col("d_date_sk"))
    hd = (dfs["household_demographics"]
          .filter(col("hd_buy_potential") == lit(">10000"))
          .select("hd_demo_sk"))
    cust = dfs["customer"].select("c_customer_sk", "c_current_hdemo_sk")
    j = j.join(cust, on=col("cs_bill_customer_sk") == col("c_customer_sk"))
    j = j.join(hd, on=col("c_current_hdemo_sk") == col("hd_demo_sk"),
               how="left_semi")
    inv = dfs["inventory"].select(
        col("inv_item_sk").alias("i_item"), "inv_warehouse_sk",
        "inv_quantity_on_hand", col("inv_date_sk").alias("inv_date"))
    d2 = dfs["date_dim"].select(col("d_date_sk").alias("d2_sk"),
                                col("d_week_seq").alias("inv_week"))
    inv = inv.join(d2, on=col("inv_date") == col("d2_sk"))
    j = j.join(inv, on=(col("cs_item_sk") == col("i_item"))
               & (col("d_week_seq") == col("inv_week")))
    j = j.filter(col("inv_quantity_on_hand") < col("cs_quantity"))
    # ship more than 3 days after sale (non-equi predicate as a filter)
    j = j.filter(col("cs_ship_date_sk") > col("cs_sold_date_sk") + lit(3))
    w = dfs["warehouse"].select("w_warehouse_sk", "w_warehouse_name")
    j = j.join(w, on=col("inv_warehouse_sk") == col("w_warehouse_sk"))
    it = dfs["item"].select("i_item_sk", "i_item_desc")
    j = j.join(it, on=col("cs_item_sk") == col("i_item_sk"))
    p = dfs["promotion"].select(col("p_promo_sk").alias("pp_sk"))
    j = j.join(p, on=col("cs_promo_sk") == col("pp_sk"),
               how="left_outer")
    no_promo = CaseWhen([(col("pp_sk").is_null(), lit(1))],
                        otherwise=lit(0))
    promo = CaseWhen([(col("pp_sk").is_not_null(), lit(1))],
                     otherwise=lit(0))
    return (j.group_by("i_item_desc", "w_warehouse_name", "d_week_seq")
            .agg(("sum", no_promo, "no_promo"), ("sum", promo, "promo"),
                 ("count", "*", "total_cnt"))
            .sort("-total_cnt", "i_item_desc", "w_warehouse_name",
                  "d_week_seq").limit(100))


def q72_pandas(t):
    cs = t["catalog_sales"]
    d = t["date_dim"][["d_date_sk", "d_week_seq"]]
    j = cs.merge(d, left_on="cs_sold_date_sk", right_on="d_date_sk")
    hd = t["household_demographics"]
    hdd = hd[hd.hd_buy_potential == ">10000"].hd_demo_sk
    cust = t["customer"][["c_customer_sk", "c_current_hdemo_sk"]]
    j = j.merge(cust, left_on="cs_bill_customer_sk",
                right_on="c_customer_sk")
    j = j[j.c_current_hdemo_sk.isin(hdd)]
    inv = t["inventory"].merge(
        d.rename(columns={"d_date_sk": "d2_sk", "d_week_seq": "inv_week"}),
        left_on="inv_date_sk", right_on="d2_sk")
    j = j.merge(inv, left_on=["cs_item_sk", "d_week_seq"],
                right_on=["inv_item_sk", "inv_week"])
    j = j[j.inv_quantity_on_hand < j.cs_quantity]
    j = j[j.cs_ship_date_sk > j.cs_sold_date_sk + 3]
    j = j.merge(t["warehouse"][["w_warehouse_sk", "w_warehouse_name"]],
                left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_desc"]],
                left_on="cs_item_sk", right_on="i_item_sk")
    promos = set(t["promotion"].p_promo_sk)
    j = j.assign(promo=j.cs_promo_sk.isin(promos).astype(int))
    j["no_promo"] = 1 - j.promo
    out = j.groupby(["i_item_desc", "w_warehouse_name", "d_week_seq"],
                    as_index=False).agg(
        no_promo=("no_promo", "sum"), promo=("promo", "sum"),
        total_cnt=("promo", "count"))
    return (out.sort_values(["total_cnt", "i_item_desc",
                             "w_warehouse_name", "d_week_seq"],
                            ascending=[False, True, True, True])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q75 — yearly item-dimension sales (net of returns) vs prior year,
# manufacturers that shrank
# ---------------------------------------------------------------------------


def _q75_channel(dfs, sales, s_item, s_order, s_date, s_qty, s_price,
                 rets, r_item, r_order, r_qty, r_amt):
    s = dfs[sales].select(
        col(s_item).alias("item_sk"), col(s_order).alias("order_"),
        col(s_date).alias("date_sk"), col(s_qty).alias("qty"),
        col(s_price).alias("amt"))
    it = (dfs["item"].filter(col("i_category") == lit("Books"))
          .select("i_item_sk", "i_brand_id", "i_class",
                  "i_category_id", "i_manufact_id"))
    s = s.join(it, on=col("item_sk") == col("i_item_sk"))
    dd = dfs["date_dim"].select("d_date_sk", "d_year")
    s = s.join(dd, on=col("date_sk") == col("d_date_sk"))
    r = dfs[rets].select(
        col(r_item).alias("r_item"), col(r_order).alias("r_order"),
        col(r_qty).alias("r_qty"), col(r_amt).alias("r_amt"))
    s = s.join(r, on=(col("order_") == col("r_order"))
               & (col("item_sk") == col("r_item")), how="left_outer")
    net_q = (col("qty") - CaseWhen(
        [(col("r_qty").is_not_null(), col("r_qty"))], otherwise=lit(0)))
    net_a = (col("amt") - CaseWhen(
        [(col("r_amt").is_not_null(), col("r_amt"))],
        otherwise=lit(0.0)))
    return s.select("d_year", "i_brand_id", "i_class", "i_category_id",
                    "i_manufact_id", net_q.alias("sales_cnt"),
                    net_a.alias("sales_amt"))


def q75(dfs):
    cs = _q75_channel(dfs, "catalog_sales", "cs_item_sk",
                      "cs_order_number", "cs_sold_date_sk", "cs_quantity",
                      "cs_ext_sales_price", "catalog_returns",
                      "cr_item_sk", "cr_order_number",
                      "cr_return_quantity", "cr_return_amount")
    ss = _q75_channel(dfs, "store_sales", "ss_item_sk",
                      "ss_ticket_number", "ss_sold_date_sk", "ss_quantity",
                      "ss_ext_sales_price", "store_returns", "sr_item_sk",
                      "sr_ticket_number", "sr_return_quantity",
                      "sr_return_amt")
    ws = _q75_channel(dfs, "web_sales", "ws_item_sk", "ws_order_number",
                      "ws_sold_date_sk", "ws_quantity",
                      "ws_ext_sales_price", "web_returns", "wr_item_sk",
                      "wr_order_number", "wr_return_quantity",
                      "wr_return_amt")
    u = cs.union(ss).union(ws)
    keys = ["d_year", "i_brand_id", "i_class", "i_category_id",
            "i_manufact_id"]
    tot = u.group_by(*keys).agg(("sum", "sales_cnt", "sales_cnt"),
                                ("sum", "sales_amt", "sales_amt"))
    prev = tot.filter(col("d_year") == lit(1999)).select(
        *[col(k).alias(f"p_{k}") for k in keys],
        col("sales_cnt").alias("prev_cnt"),
        col("sales_amt").alias("prev_amt"))
    curr = tot.filter(col("d_year") == lit(2000))
    on = None
    for k in keys[1:]:
        e = col(k) == col(f"p_{k}")
        on = e if on is None else (on & e)
    j = curr.join(prev, on=on)
    j = j.filter((col("sales_cnt") * lit(10))
                 < (col("prev_cnt") * lit(9)))  # ratio < 0.9
    return (j.select(col("p_d_year").alias("prev_year"),
                     col("d_year").alias("year_"), "i_brand_id",
                     "i_class", "i_category_id", "i_manufact_id",
                     "prev_cnt", "sales_cnt", "prev_amt", "sales_amt")
            .sort("sales_cnt", "i_brand_id", "i_class",
                  "i_manufact_id").limit(100))


def _q75_pd_channel(t, sales, s_item, s_order, s_date, s_qty, s_price,
                    rets, r_item, r_order, r_qty, r_amt):
    s = t[sales]
    it = t["item"]
    it = it[it.i_category == "Books"][["i_item_sk", "i_brand_id",
                                      "i_class", "i_category_id",
                                      "i_manufact_id"]]
    s = s.merge(it, left_on=s_item, right_on="i_item_sk")
    d = t["date_dim"][["d_date_sk", "d_year"]]
    s = s.merge(d, left_on=s_date, right_on="d_date_sk")
    r = t[rets][[r_item, r_order, r_qty, r_amt]]
    s = s.merge(r, how="left", left_on=[s_order, s_item],
                right_on=[r_order, r_item])
    s["sales_cnt"] = s[s_qty] - s[r_qty].fillna(0)
    s["sales_amt"] = s[s_price] - s[r_amt].fillna(0.0)
    return s[["d_year", "i_brand_id", "i_class", "i_category_id",
              "i_manufact_id", "sales_cnt", "sales_amt"]]


def q75_pandas(t):
    cs = _q75_pd_channel(t, "catalog_sales", "cs_item_sk",
                         "cs_order_number", "cs_sold_date_sk",
                         "cs_quantity", "cs_ext_sales_price",
                         "catalog_returns", "cr_item_sk",
                         "cr_order_number", "cr_return_quantity",
                         "cr_return_amount")
    ss = _q75_pd_channel(t, "store_sales", "ss_item_sk",
                         "ss_ticket_number", "ss_sold_date_sk",
                         "ss_quantity", "ss_ext_sales_price",
                         "store_returns", "sr_item_sk",
                         "sr_ticket_number", "sr_return_quantity",
                         "sr_return_amt")
    ws = _q75_pd_channel(t, "web_sales", "ws_item_sk", "ws_order_number",
                         "ws_sold_date_sk", "ws_quantity",
                         "ws_ext_sales_price", "web_returns",
                         "wr_item_sk", "wr_order_number",
                         "wr_return_quantity", "wr_return_amt")
    u = pd.concat([cs, ss, ws], ignore_index=True)
    keys = ["d_year", "i_brand_id", "i_class", "i_category_id",
            "i_manufact_id"]
    tot = u.groupby(keys, as_index=False).agg(
        sales_cnt=("sales_cnt", "sum"), sales_amt=("sales_amt", "sum"))
    prev = tot[tot.d_year == 1999].rename(columns={
        "d_year": "prev_year", "sales_cnt": "prev_cnt",
        "sales_amt": "prev_amt"})
    curr = tot[tot.d_year == 2000]
    j = curr.merge(prev, on=keys[1:])
    j = j[j.sales_cnt * 10 < j.prev_cnt * 9]
    j = j.rename(columns={"d_year": "year_"})
    out = j[["prev_year", "year_", "i_brand_id", "i_class",
             "i_category_id", "i_manufact_id", "prev_cnt", "sales_cnt",
             "prev_amt", "sales_amt"]]
    return (out.sort_values(["sales_cnt", "i_brand_id", "i_class",
                             "i_manufact_id"]).head(100)
            .reset_index(drop=True))


# ---------------------------------------------------------------------------
# q76 — rows sold with NULL dimension keys, by channel
# ---------------------------------------------------------------------------


def q76(dfs):
    def channel(sales, null_col, item, date, price, label, col_name):
        s = (dfs[sales].filter(col(null_col).is_null())
             .select(col(item).alias("item_sk"),
                     col(date).alias("date_sk"),
                     col(price).alias("ext_sales_price")))
        it = dfs["item"].select("i_item_sk", "i_category")
        s = s.join(it, on=col("item_sk") == col("i_item_sk"))
        dd = dfs["date_dim"].select("d_date_sk", "d_year", "d_qoy")
        s = s.join(dd, on=col("date_sk") == col("d_date_sk"))
        return s.select(lit(label).alias("channel"),
                        lit(col_name).alias("col_name"), "d_year",
                        "d_qoy", "i_category", "ext_sales_price")

    ss = channel("store_sales", "ss_store_sk", "ss_item_sk",
                 "ss_sold_date_sk", "ss_ext_sales_price", "store",
                 "ss_store_sk")
    ws = channel("web_sales", "ws_ship_customer_sk", "ws_item_sk",
                 "ws_sold_date_sk", "ws_ext_sales_price", "web",
                 "ws_ship_customer_sk")
    cs = channel("catalog_sales", "cs_ship_addr_sk", "cs_item_sk",
                 "cs_sold_date_sk", "cs_ext_sales_price", "catalog",
                 "cs_ship_addr_sk")
    u = ss.union(ws).union(cs)
    return (u.group_by("channel", "col_name", "d_year", "d_qoy",
                       "i_category")
            .agg(("count", "*", "sales_cnt"),
                 ("sum", "ext_sales_price", "sales_amt"))
            .sort("channel", "col_name", "d_year", "d_qoy", "i_category")
            .limit(100))


def q76_pandas(t):
    def channel(sales, null_col, item, date, price, label, col_name):
        s = t[sales]
        s = s[s[null_col].isna()]
        s = s.merge(t["item"][["i_item_sk", "i_category"]],
                    left_on=item, right_on="i_item_sk")
        s = s.merge(t["date_dim"][["d_date_sk", "d_year", "d_qoy"]],
                    left_on=date, right_on="d_date_sk")
        out = s[["d_year", "d_qoy", "i_category", price]].rename(
            columns={price: "ext_sales_price"})
        out.insert(0, "col_name", col_name)
        out.insert(0, "channel", label)
        return out

    u = pd.concat([
        channel("store_sales", "ss_store_sk", "ss_item_sk",
                "ss_sold_date_sk", "ss_ext_sales_price", "store",
                "ss_store_sk"),
        channel("web_sales", "ws_ship_customer_sk", "ws_item_sk",
                "ws_sold_date_sk", "ws_ext_sales_price", "web",
                "ws_ship_customer_sk"),
        channel("catalog_sales", "cs_ship_addr_sk", "cs_item_sk",
                "cs_sold_date_sk", "cs_ext_sales_price", "catalog",
                "cs_ship_addr_sk"),
    ], ignore_index=True)
    out = u.groupby(["channel", "col_name", "d_year", "d_qoy",
                     "i_category"], as_index=False).agg(
        sales_cnt=("ext_sales_price", "count"),
        sales_amt=("ext_sales_price", "sum"))
    return (out.sort_values(["channel", "col_name", "d_year", "d_qoy",
                             "i_category"]).head(100)
            .reset_index(drop=True))


QUERIES_EXT3.update({
    "q72": (q72, q72_pandas),
    "q75": (q75, q75_pandas),
    "q76": (q76, q76_pandas),
})


# ---------------------------------------------------------------------------
# q77 — per-channel profit ROLLUP (sales left-joined with returns totals)
# ---------------------------------------------------------------------------

_Q77_LO, _Q77_HI = 731, 760


def q77(dfs):
    dd = (dfs["date_dim"]
          .filter((col("d_date_sk") >= lit(_Q77_LO))
                  & (col("d_date_sk") <= lit(_Q77_HI)))
          .select("d_date_sk"))

    def sums(table, date_col, key_col, alias_key, measures):
        s = dfs[table].join(
            dd, on=col(date_col) == col("d_date_sk"), how="left_semi")
        # Official q77 inner-joins each channel's dimension, which drops
        # NULL keys (ss_store_sk is nullable); the oracle's groupby does
        # the same.
        s = s.filter(col(key_col).is_not_null())
        aggs = [("sum", src, alias) for alias, src in measures.items()]
        return (s.group_by(key_col).agg(*aggs)
                .select(col(key_col).alias(alias_key),
                        *measures.keys()))

    ss = sums("store_sales", "ss_sold_date_sk", "ss_store_sk", "s_sk",
              {"sales": "ss_ext_sales_price", "profit": "ss_net_profit"})
    sr = sums("store_returns", "sr_returned_date_sk", "sr_store_sk",
              "r_sk", {"returns_": "sr_return_amt",
                       "profit_loss": "sr_net_loss"})
    st = ss.join(sr, on=col("s_sk") == col("r_sk"), how="left_outer")
    coal = lambda c, z: CaseWhen([(col(c).is_not_null(), col(c))],
                                 otherwise=lit(z))
    st = st.select(lit("store channel").alias("channel"),
                   col("s_sk").alias("id"), "sales",
                   coal("returns_", 0.0).alias("returns_"),
                   (col("profit")
                    - coal("profit_loss", 0.0)).alias("profit"))

    cs = sums("catalog_sales", "cs_sold_date_sk", "cs_call_center_sk",
              "cs_sk", {"sales": "cs_ext_sales_price",
                        "profit": "cs_net_profit"})
    cr = (dfs["catalog_returns"]
          .join(dd, on=col("cr_returned_date_sk") == col("d_date_sk"),
                how="left_semi")
          .agg(("sum", "cr_return_amount", "returns_"),
               ("sum", "cr_net_loss", "profit_loss")))
    ct = cs.join(cr, how="cross")
    ct = ct.select(lit("catalog channel").alias("channel"),
                   col("cs_sk").alias("id"), "sales",
                   coal("returns_", 0.0).alias("returns_"),
                   (col("profit")
                    - coal("profit_loss", 0.0)).alias("profit"))

    ws = sums("web_sales", "ws_sold_date_sk", "ws_web_page_sk", "w_sk",
              {"sales": "ws_ext_sales_price", "profit": "ws_net_profit"})
    wr = sums("web_returns", "wr_returned_date_sk", "wr_web_page_sk",
              "wr_sk", {"returns_": "wr_return_amt",
                        "profit_loss": "wr_net_loss"})
    wt = ws.join(wr, on=col("w_sk") == col("wr_sk"), how="left_outer")
    wt = wt.select(lit("web channel").alias("channel"),
                   col("w_sk").alias("id"), "sales",
                   coal("returns_", 0.0).alias("returns_"),
                   (col("profit")
                    - coal("profit_loss", 0.0)).alias("profit"))

    u = st.union(ct).union(wt)
    roll = _rollup_union(u, [("channel", "string"), ("id", "int64")],
                         {"sales": ("sum", "sales"),
                          "returns_": ("sum", "returns_"),
                          "profit": ("sum", "profit")}, u.session)
    return (roll.select("channel", "id", "sales", "returns_", "profit")
            .sort("channel", "id").limit(100))


def q77_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= _Q77_LO) & (d.d_date_sk <= _Q77_HI)].d_date_sk

    def sums(table, date_col, key_col, measures):
        s = t[table]
        s = s[s[date_col].isin(dd)]
        return s.groupby(key_col).agg(
            **{alias: (src, "sum") for alias, src in measures.items()})

    ss = sums("store_sales", "ss_sold_date_sk", "ss_store_sk",
              {"sales": "ss_ext_sales_price", "profit": "ss_net_profit"})
    sr = sums("store_returns", "sr_returned_date_sk", "sr_store_sk",
              {"returns_": "sr_return_amt", "profit_loss": "sr_net_loss"})
    st = ss.join(sr, how="left")
    st = pd.DataFrame({
        "channel": "store channel", "id": st.index,
        "sales": st.sales.values,
        "returns_": st.returns_.fillna(0.0).values,
        "profit": (st.profit - st.profit_loss.fillna(0.0)).values})

    cs = sums("catalog_sales", "cs_sold_date_sk", "cs_call_center_sk",
              {"sales": "cs_ext_sales_price", "profit": "cs_net_profit"})
    crt = t["catalog_returns"]
    crt = crt[crt.cr_returned_date_sk.isin(dd)]
    cr_ret = crt.cr_return_amount.sum(min_count=1)
    cr_loss = crt.cr_net_loss.sum(min_count=1)
    ct = pd.DataFrame({
        "channel": "catalog channel", "id": cs.index,
        "sales": cs.sales.values,
        "returns_": (0.0 if pd.isna(cr_ret) else cr_ret),
        "profit": (cs.profit
                   - (0.0 if pd.isna(cr_loss) else cr_loss)).values})

    ws = sums("web_sales", "ws_sold_date_sk", "ws_web_page_sk",
              {"sales": "ws_ext_sales_price", "profit": "ws_net_profit"})
    wr = sums("web_returns", "wr_returned_date_sk", "wr_web_page_sk",
              {"returns_": "wr_return_amt", "profit_loss": "wr_net_loss"})
    wt = ws.join(wr, how="left")
    wt = pd.DataFrame({
        "channel": "web channel", "id": wt.index,
        "sales": wt.sales.values,
        "returns_": wt.returns_.fillna(0.0).values,
        "profit": (wt.profit - wt.profit_loss.fillna(0.0)).values})

    u = pd.concat([st, ct, wt], ignore_index=True)
    leaf = u.groupby(["channel", "id"], as_index=False).agg(
        sales=("sales", "sum"), returns_=("returns_", "sum"),
        profit=("profit", "sum"))
    mid = u.groupby("channel", as_index=False).agg(
        sales=("sales", "sum"), returns_=("returns_", "sum"),
        profit=("profit", "sum"))
    mid["id"] = np.nan
    top = pd.DataFrame({"channel": [np.nan], "id": [np.nan],
                        "sales": [u.sales.sum()],
                        "returns_": [u.returns_.sum()],
                        "profit": [u.profit.sum()]})
    out = pd.concat([leaf, mid, top], ignore_index=True)
    return (out[["channel", "id", "sales", "returns_", "profit"]]
            .sort_values(["channel", "id"], na_position="first")
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q78 — yearly per-(item, customer) channel sums EXCLUDING returned rows,
# store vs web+catalog ratio
# ---------------------------------------------------------------------------


def _q78_channel(dfs, sales, s_item, s_cust, s_order, s_date, s_qty,
                 s_wc, s_sp, rets, r_item, r_order, tag):
    s = dfs[sales].select(
        col(s_item).alias("item"), col(s_cust).alias("cust"),
        col(s_order).alias("order_"), col(s_date).alias("date_sk"),
        col(s_qty).alias("qty"), col(s_wc).alias("wc"),
        col(s_sp).alias("sp"))
    r = dfs[rets].select(col(r_item).alias("r_item"),
                         col(r_order).alias("r_order"))
    s = s.join(r, on=(col("order_") == col("r_order"))
               & (col("item") == col("r_item")), how="left_anti")
    dd = dfs["date_dim"].select("d_date_sk", "d_year")
    s = s.join(dd, on=col("date_sk") == col("d_date_sk"))
    return (s.group_by("d_year", "item", "cust")
            .agg(("sum", "qty", f"{tag}_qty"), ("sum", "wc", f"{tag}_wc"),
                 ("sum", "sp", f"{tag}_sp"))
            .select(col("d_year").alias(f"{tag}_year"),
                    col("item").alias(f"{tag}_item"),
                    col("cust").alias(f"{tag}_cust"),
                    f"{tag}_qty", f"{tag}_wc", f"{tag}_sp"))


def q78(dfs):
    ss = _q78_channel(dfs, "store_sales", "ss_item_sk", "ss_customer_sk",
                      "ss_ticket_number", "ss_sold_date_sk",
                      "ss_quantity", "ss_wholesale_cost",
                      "ss_sales_price", "store_returns", "sr_item_sk",
                      "sr_ticket_number", "ss")
    ws = _q78_channel(dfs, "web_sales", "ws_item_sk",
                      "ws_bill_customer_sk", "ws_order_number",
                      "ws_sold_date_sk", "ws_quantity",
                      "ws_wholesale_cost", "ws_sales_price",
                      "web_returns", "wr_item_sk", "wr_order_number",
                      "ws")
    cs = _q78_channel(dfs, "catalog_sales", "cs_item_sk",
                      "cs_bill_customer_sk", "cs_order_number",
                      "cs_sold_date_sk", "cs_quantity",
                      "cs_list_price", "cs_sales_price",
                      "catalog_returns", "cr_item_sk", "cr_order_number",
                      "cs")
    j = ss.join(ws, on=(col("ss_year") == col("ws_year"))
                & (col("ss_item") == col("ws_item"))
                & (col("ss_cust") == col("ws_cust")), how="left_outer")
    j = j.join(cs, on=(col("ss_year") == col("cs_year"))
               & (col("ss_item") == col("cs_item"))
               & (col("ss_cust") == col("cs_cust")), how="left_outer")
    coal = lambda c: CaseWhen([(col(c).is_not_null(), col(c))],
                              otherwise=lit(0))
    other = (coal("ws_qty") + coal("cs_qty"))
    j = j.with_column("other_chan_qty", other)
    j = j.filter((col("ss_year") == lit(2000))
                 & (col("other_chan_qty") > lit(0)))
    j = j.with_column("ratio", col("ss_qty") / col("other_chan_qty"))
    return (j.select("ss_year", "ss_item", "ss_cust", "ratio", "ss_qty",
                     "ss_wc", "ss_sp", "other_chan_qty")
            .sort("-ss_qty", "-ss_wc", "-ss_sp", "ss_item", "ss_cust")
            .limit(100))


def _q78_pd_channel(t, sales, s_item, s_cust, s_order, s_date, s_qty,
                    s_wc, s_sp, rets, r_item, r_order, tag):
    s = t[sales]
    r = t[rets][[r_item, r_order]].drop_duplicates()
    m = s.merge(r, how="left", left_on=[s_order, s_item],
                right_on=[r_order, r_item], indicator=True)
    m = m[m._merge == "left_only"]
    d = t["date_dim"][["d_date_sk", "d_year"]]
    m = m.merge(d, left_on=s_date, right_on="d_date_sk")
    g = m.groupby(["d_year", s_item, s_cust], as_index=False).agg(
        **{f"{tag}_qty": (s_qty, "sum"), f"{tag}_wc": (s_wc, "sum"),
           f"{tag}_sp": (s_sp, "sum")})
    return g.rename(columns={"d_year": f"{tag}_year",
                             s_item: f"{tag}_item",
                             s_cust: f"{tag}_cust"})


def q78_pandas(t):
    ss = _q78_pd_channel(t, "store_sales", "ss_item_sk",
                         "ss_customer_sk", "ss_ticket_number",
                         "ss_sold_date_sk", "ss_quantity",
                         "ss_wholesale_cost", "ss_sales_price",
                         "store_returns", "sr_item_sk",
                         "sr_ticket_number", "ss")
    ws = _q78_pd_channel(t, "web_sales", "ws_item_sk",
                         "ws_bill_customer_sk", "ws_order_number",
                         "ws_sold_date_sk", "ws_quantity",
                         "ws_wholesale_cost", "ws_sales_price",
                         "web_returns", "wr_item_sk", "wr_order_number",
                         "ws")
    cs = _q78_pd_channel(t, "catalog_sales", "cs_item_sk",
                         "cs_bill_customer_sk", "cs_order_number",
                         "cs_sold_date_sk", "cs_quantity",
                         "cs_list_price", "cs_sales_price",
                         "catalog_returns", "cr_item_sk",
                         "cr_order_number", "cs")
    j = ss.merge(ws, how="left",
                 left_on=["ss_year", "ss_item", "ss_cust"],
                 right_on=["ws_year", "ws_item", "ws_cust"])
    j = j.merge(cs, how="left",
                left_on=["ss_year", "ss_item", "ss_cust"],
                right_on=["cs_year", "cs_item", "cs_cust"])
    j["other_chan_qty"] = j.ws_qty.fillna(0) + j.cs_qty.fillna(0)
    j = j[(j.ss_year == 2000) & (j.other_chan_qty > 0)]
    j["ratio"] = j.ss_qty / j.other_chan_qty
    out = j[["ss_year", "ss_item", "ss_cust", "ratio", "ss_qty", "ss_wc",
             "ss_sp", "other_chan_qty"]]
    return (out.sort_values(["ss_qty", "ss_wc", "ss_sp", "ss_item",
                             "ss_cust"],
                            ascending=[False, False, False, True, True])
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q83 — returned quantities per item across the 3 channels for the weeks
# of three report dates
# ---------------------------------------------------------------------------

_Q83_DATES = (740, 780, 820)


def q83(dfs):
    d = dfs["date_dim"]
    weeks = (d.filter(col("d_date_sk").isin(*[lit(x) for x in _Q83_DATES]))
             .select("d_week_seq"))
    days = (d.select(col("d_date_sk").alias("wk_date"), "d_week_seq")
            .join(weeks, on="d_week_seq", how="left_semi"))

    def rets(table, r_item, r_date, r_qty, tag):
        r = dfs[table].select(col(r_item).alias("item_sk"),
                              col(r_date).alias("date_sk"),
                              col(r_qty).alias("qty"))
        r = r.join(days, on=col("date_sk") == col("wk_date"),
                   how="left_semi")
        it = dfs["item"].select("i_item_sk", "i_item_id")
        r = r.join(it, on=col("item_sk") == col("i_item_sk"))
        return (r.group_by("i_item_id")
                .agg(("sum", "qty", f"{tag}_qty"))
                .select(col("i_item_id").alias(f"{tag}_id"),
                        f"{tag}_qty"))

    sr = rets("store_returns", "sr_item_sk", "sr_returned_date_sk",
              "sr_return_quantity", "sr")
    cr = rets("catalog_returns", "cr_item_sk", "cr_returned_date_sk",
              "cr_return_quantity", "cr")
    wr = rets("web_returns", "wr_item_sk", "wr_returned_date_sk",
              "wr_return_quantity", "wr")
    j = sr.join(cr, on=col("sr_id") == col("cr_id"))
    j = j.join(wr, on=col("sr_id") == col("wr_id"))
    total = (col("sr_qty") + col("cr_qty") + col("wr_qty"))
    j = j.with_column("total_qty", total)
    j = j.with_column("average", col("total_qty") / lit(3.0))
    return (j.select(col("sr_id").alias("item_id"), "sr_qty", "cr_qty",
                     "wr_qty", "average")
            .sort("item_id", "sr_qty").limit(100))


def q83_pandas(t):
    d = t["date_dim"]
    weeks = d[d.d_date_sk.isin(_Q83_DATES)].d_week_seq
    days = d[d.d_week_seq.isin(weeks)].d_date_sk

    def rets(table, r_item, r_date, r_qty, tag):
        r = t[table]
        r = r[r[r_date].isin(days)]
        r = r.merge(t["item"][["i_item_sk", "i_item_id"]],
                    left_on=r_item, right_on="i_item_sk")
        return (r.groupby("i_item_id", as_index=False)
                .agg(**{f"{tag}_qty": (r_qty, "sum")}))

    sr = rets("store_returns", "sr_item_sk", "sr_returned_date_sk",
              "sr_return_quantity", "sr")
    cr = rets("catalog_returns", "cr_item_sk", "cr_returned_date_sk",
              "cr_return_quantity", "cr")
    wr = rets("web_returns", "wr_item_sk", "wr_returned_date_sk",
              "wr_return_quantity", "wr")
    j = sr.merge(cr, on="i_item_id").merge(wr, on="i_item_id")
    j["average"] = (j.sr_qty + j.cr_qty + j.wr_qty) / 3.0
    j = j.rename(columns={"i_item_id": "item_id"})
    return (j[["item_id", "sr_qty", "cr_qty", "wr_qty", "average"]]
            .sort_values(["item_id", "sr_qty"]).head(100)
            .reset_index(drop=True))


# ---------------------------------------------------------------------------
# q91 — call-center catalog-return losses by manager/demographics
# ---------------------------------------------------------------------------


def q91(dfs):
    cr = dfs["catalog_returns"].select("cr_call_center_sk",
                                       "cr_returned_date_sk",
                                       "cr_returning_customer_sk",
                                       "cr_net_loss")
    # Official q91 brackets one month; the generator's catalog-return
    # density needs a quarter for a non-empty report at test scales.
    dd = (dfs["date_dim"]
          .filter((col("d_year") == lit(2000)) & (col("d_qoy") == lit(4)))
          .select("d_date_sk"))
    j = cr.join(dd, on=col("cr_returned_date_sk") == col("d_date_sk"),
                how="left_semi")
    cc = dfs["call_center"].select("cc_call_center_sk", "cc_call_center_id",
                                   "cc_name", "cc_manager")
    j = j.join(cc, on=col("cr_call_center_sk") == col("cc_call_center_sk"))
    cust = dfs["customer"].select("c_customer_sk", "c_current_cdemo_sk",
                                  "c_current_hdemo_sk",
                                  "c_current_addr_sk")
    j = j.join(cust,
               on=col("cr_returning_customer_sk") == col("c_customer_sk"))
    cd = (dfs["customer_demographics"]
          .filter(((col("cd_marital_status") == lit("M"))
                   & (col("cd_education_status") == lit("Primary")))
                  | ((col("cd_marital_status") == lit("S"))
                     & (col("cd_education_status") == lit("College")))
                  | ((col("cd_marital_status") == lit("W"))
                     & (col("cd_education_status")
                        == lit("Advanced Degree"))))
          .select("cd_demo_sk", "cd_marital_status",
                  "cd_education_status"))
    j = j.join(cd, on=col("c_current_cdemo_sk") == col("cd_demo_sk"))
    hd = (dfs["household_demographics"]
          .filter(col("hd_buy_potential").isin("unknown", ">10000"))
          .select("hd_demo_sk"))
    j = j.join(hd, on=col("c_current_hdemo_sk") == col("hd_demo_sk"),
               how="left_semi")
    ca = (dfs["customer_address"]
          .filter(col("ca_gmt_offset") == lit(-5.0))
          .select("ca_address_sk"))
    j = j.join(ca, on=col("c_current_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    return (j.group_by("cc_call_center_id", "cc_name", "cc_manager",
                       "cd_marital_status", "cd_education_status")
            .agg(("sum", "cr_net_loss", "returns_loss"))
            .sort("-returns_loss", "cc_call_center_id").limit(100))


def q91_pandas(t):
    cr = t["catalog_returns"]
    d = t["date_dim"]
    dd = d[(d.d_year == 2000) & (d.d_qoy == 4)].d_date_sk
    j = cr[cr.cr_returned_date_sk.isin(dd)]
    j = j.merge(t["call_center"], left_on="cr_call_center_sk",
                right_on="cc_call_center_sk")
    j = j.merge(t["customer"], left_on="cr_returning_customer_sk",
                right_on="c_customer_sk")
    cd = t["customer_demographics"]
    cd = cd[((cd.cd_marital_status == "M")
             & (cd.cd_education_status == "Primary"))
            | ((cd.cd_marital_status == "S")
               & (cd.cd_education_status == "College"))
            | ((cd.cd_marital_status == "W")
               & (cd.cd_education_status == "Advanced Degree"))]
    j = j.merge(cd[["cd_demo_sk", "cd_marital_status",
                    "cd_education_status"]],
                left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
    hd = t["household_demographics"]
    j = j[j.c_current_hdemo_sk.isin(
        hd[hd.hd_buy_potential.isin(["unknown", ">10000"])].hd_demo_sk)]
    ca = t["customer_address"]
    j = j[j.c_current_addr_sk.isin(
        ca[ca.ca_gmt_offset == -5.0].ca_address_sk)]
    out = j.groupby(["cc_call_center_id", "cc_name", "cc_manager",
                     "cd_marital_status", "cd_education_status"],
                    as_index=False).agg(
        returns_loss=("cr_net_loss", "sum"))
    return (out.sort_values(["returns_loss", "cc_call_center_id"],
                            ascending=[False, True]).head(100)
            .reset_index(drop=True))


# ---------------------------------------------------------------------------
# q95 — web orders shipped from multiple warehouses AND returned (q94's
# sibling: both probes are IN-subqueries)
# ---------------------------------------------------------------------------


def q95(dfs):
    ws = dfs["web_sales"].select(
        "ws_order_number", "ws_ship_date_sk", "ws_ship_addr_sk",
        "ws_web_site_sk", "ws_ext_ship_cost", "ws_net_profit")
    d = (dfs["date_dim"].filter((col("d_date_sk") >= lit(730))
                                & (col("d_date_sk") <= lit(790)))
         .select("d_date_sk"))
    ca = (dfs["customer_address"].filter(col("ca_state") == lit("TX"))
          .select("ca_address_sk"))
    web = (dfs["web_site"].filter(col("web_company_name") == lit("pri"))
           .select("web_site_sk"))
    # ws_wh: orders shipped from >1 warehouse (ws1/ws2 self-join form)
    multi_wh = (dfs["web_sales"]
                .select("ws_order_number", "ws_warehouse_sk")
                .group_by("ws_order_number")
                .agg(("count_distinct", "ws_warehouse_sk", "nwh"))
                .filter(col("nwh") > lit(1))
                .select(col("ws_order_number").alias("mw_order")))
    # returned multi-warehouse orders
    wr_orders = (dfs["web_returns"]
                 .select(col("wr_order_number").alias("ret_order"))
                 .join(multi_wh, on=col("ret_order") == col("mw_order"),
                       how="left_semi"))
    j = ws.join(d, on=col("ws_ship_date_sk") == col("d_date_sk"),
                how="left_semi")
    j = j.join(ca, on=col("ws_ship_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    j = j.join(web, on=col("ws_web_site_sk") == col("web_site_sk"),
               how="left_semi")
    j = j.join(multi_wh, on=col("ws_order_number") == col("mw_order"),
               how="left_semi")
    j = j.join(wr_orders, on=col("ws_order_number") == col("ret_order"),
               how="left_semi")
    return j.agg(("count_distinct", "ws_order_number", "order_count"),
                 ("sum", "ws_ext_ship_cost", "total_shipping_cost"),
                 ("sum", "ws_net_profit", "total_net_profit"))


def q95_pandas(t):
    ws = t["web_sales"]
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= 730) & (d.d_date_sk <= 790)].d_date_sk
    ca = t["customer_address"]
    caa = ca[ca.ca_state == "TX"].ca_address_sk
    web = t["web_site"]
    webb = web[web.web_company_name == "pri"].web_site_sk
    nwh = ws.groupby("ws_order_number").ws_warehouse_sk.nunique()
    multi = set(nwh[nwh > 1].index)
    wr = t["web_returns"]
    ret_multi = set(wr[wr.wr_order_number.isin(multi)].wr_order_number)
    j = ws[ws.ws_ship_date_sk.isin(dd) & ws.ws_ship_addr_sk.isin(caa)
           & ws.ws_web_site_sk.isin(webb)
           & ws.ws_order_number.isin(multi)
           & ws.ws_order_number.isin(ret_multi)]
    return pd.DataFrame({
        "order_count": [j.ws_order_number.nunique()],
        "total_shipping_cost": [j.ws_ext_ship_cost.sum(min_count=1)],
        "total_net_profit": [j.ws_net_profit.sum(min_count=1)]})


QUERIES_EXT3.update({
    "q77": (q77, q77_pandas),
    "q78": (q78, q78_pandas),
    "q83": (q83, q83_pandas),
    "q91": (q91, q91_pandas),
    "q95": (q95, q95_pandas),
})


# ---------------------------------------------------------------------------
# q80 — 3-channel sales/returns/profit ROLLUP with promotion filter
# ---------------------------------------------------------------------------

_Q80_LO, _Q80_HI = 731, 760


def q80(dfs):
    dd = (dfs["date_dim"]
          .filter((col("d_date_sk") >= lit(_Q80_LO))
                  & (col("d_date_sk") <= lit(_Q80_HI)))
          .select("d_date_sk"))
    it = (dfs["item"].filter(col("i_current_price") > lit(50))
          .select("i_item_sk"))
    pr = (dfs["promotion"].filter(col("p_channel_tv") == lit("N"))
          .select("p_promo_sk"))

    def channel(sales, s_date, s_item, s_promo, s_key, s_price, s_profit,
                rets, r_key_cols, s_key_cols, r_amt, r_loss, dim, dim_sk,
                dim_id, label):
        s = dfs[sales]
        s = s.join(dd, on=col(s_date) == col("d_date_sk"), how="left_semi")
        s = s.join(it, on=col(s_item) == col("i_item_sk"), how="left_semi")
        s = s.join(pr, on=col(s_promo) == col("p_promo_sk"),
                   how="left_semi")
        r = dfs[rets].select(*[col(c).alias(f"r{i}")
                               for i, c in enumerate(r_key_cols)],
                             col(r_amt).alias("ret_amt"),
                             col(r_loss).alias("ret_loss"))
        on = None
        for i, c in enumerate(s_key_cols):
            e = col(c) == col(f"r{i}")
            on = e if on is None else (on & e)
        s = s.join(r, on=on, how="left_outer")
        coal = lambda c, z: CaseWhen([(col(c).is_not_null(), col(c))],
                                     otherwise=lit(z))
        dmf = dfs[dim].select(col(dim_sk).alias("dim_sk"),
                              col(dim_id).alias("id"))
        s = s.join(dmf, on=col(s_key) == col("dim_sk"))
        return (s.group_by("id")
                .agg(("sum", s_price, "sales"),
                     ("sum", coal("ret_amt", 0.0), "returns_"),
                     ("sum", col(s_profit) - coal("ret_loss", 0.0),
                      "profit"))
                .with_column("channel", lit(label)))

    st = channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                 "ss_promo_sk", "ss_store_sk", "ss_ext_sales_price",
                 "ss_net_profit", "store_returns",
                 ["sr_item_sk", "sr_ticket_number"],
                 ["ss_item_sk", "ss_ticket_number"], "sr_return_amt",
                 "sr_net_loss", "store", "s_store_sk", "s_store_id",
                 "store channel")
    ct = channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                 "cs_promo_sk", "cs_catalog_page_sk",
                 "cs_ext_sales_price", "cs_net_profit", "catalog_returns",
                 ["cr_item_sk", "cr_order_number"],
                 ["cs_item_sk", "cs_order_number"], "cr_return_amount",
                 "cr_net_loss", "catalog_page", "cp_catalog_page_sk",
                 "cp_catalog_page_id", "catalog channel")
    wt = channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                 "ws_promo_sk", "ws_web_site_sk", "ws_ext_sales_price",
                 "ws_net_profit", "web_returns",
                 ["wr_item_sk", "wr_order_number"],
                 ["ws_item_sk", "ws_order_number"], "wr_return_amt",
                 "wr_net_loss", "web_site", "web_site_sk", "web_site_id",
                 "web channel")
    u = st.union(ct).union(wt)
    roll = _rollup_union(u, [("channel", "string"), ("id", "string")],
                         {"sales": ("sum", "sales"),
                          "returns_": ("sum", "returns_"),
                          "profit": ("sum", "profit")}, u.session)
    return (roll.select("channel", "id", "sales", "returns_", "profit")
            .sort("channel", "id").limit(100))


def q80_pandas(t):
    d = t["date_dim"]
    dd = d[(d.d_date_sk >= _Q80_LO) & (d.d_date_sk <= _Q80_HI)].d_date_sk
    it = t["item"]
    itt = it[it.i_current_price > 50].i_item_sk
    pr = t["promotion"]
    prr = pr[pr.p_channel_tv == "N"].p_promo_sk

    def channel(sales, s_date, s_item, s_promo, s_key, s_price, s_profit,
                rets, r_key_cols, s_key_cols, r_amt, r_loss, dim, dim_sk,
                dim_id, label):
        s = t[sales]
        s = s[s[s_date].isin(dd) & s[s_item].isin(itt)
              & s[s_promo].isin(prr)]
        r = t[rets][r_key_cols + [r_amt, r_loss]]
        s = s.merge(r, how="left", left_on=s_key_cols,
                    right_on=r_key_cols)
        dmf = t[dim][[dim_sk, dim_id]]
        s = s.merge(dmf, left_on=s_key, right_on=dim_sk)
        g = s.groupby(dim_id).agg(
            sales=(s_price, "sum"))
        g["returns_"] = s.assign(v=s[r_amt].fillna(0.0)) \
            .groupby(dim_id).v.sum()
        g["profit"] = (s.assign(v=s[s_profit] - s[r_loss].fillna(0.0))
                       .groupby(dim_id).v.sum())
        g = g.reset_index(names="id")
        g["channel"] = label
        return g

    st = channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                 "ss_promo_sk", "ss_store_sk", "ss_ext_sales_price",
                 "ss_net_profit", "store_returns",
                 ["sr_item_sk", "sr_ticket_number"],
                 ["ss_item_sk", "ss_ticket_number"], "sr_return_amt",
                 "sr_net_loss", "store", "s_store_sk", "s_store_id",
                 "store channel")
    ct = channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                 "cs_promo_sk", "cs_catalog_page_sk",
                 "cs_ext_sales_price", "cs_net_profit",
                 "catalog_returns", ["cr_item_sk", "cr_order_number"],
                 ["cs_item_sk", "cs_order_number"], "cr_return_amount",
                 "cr_net_loss", "catalog_page", "cp_catalog_page_sk",
                 "cp_catalog_page_id", "catalog channel")
    wt = channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                 "ws_promo_sk", "ws_web_site_sk", "ws_ext_sales_price",
                 "ws_net_profit", "web_returns",
                 ["wr_item_sk", "wr_order_number"],
                 ["ws_item_sk", "ws_order_number"], "wr_return_amt",
                 "wr_net_loss", "web_site", "web_site_sk", "web_site_id",
                 "web channel")
    u = pd.concat([st, ct, wt], ignore_index=True)
    leaf = u.groupby(["channel", "id"], as_index=False).agg(
        sales=("sales", "sum"), returns_=("returns_", "sum"),
        profit=("profit", "sum"))
    mid = u.groupby("channel", as_index=False).agg(
        sales=("sales", "sum"), returns_=("returns_", "sum"),
        profit=("profit", "sum"))
    mid["id"] = np.nan
    top = pd.DataFrame({"channel": [np.nan], "id": [np.nan],
                        "sales": [u.sales.sum()],
                        "returns_": [u.returns_.sum()],
                        "profit": [u.profit.sum()]})
    out = pd.concat([leaf, mid, top], ignore_index=True)
    return (out[["channel", "id", "sales", "returns_", "profit"]]
            .sort_values(["channel", "id"], na_position="first")
            .head(100).reset_index(drop=True))


# ---------------------------------------------------------------------------
# q85 — web returns by reason with paired demographics and price bands
# ---------------------------------------------------------------------------


def q85(dfs):
    wr = dfs["web_returns"].select(
        "wr_item_sk", "wr_order_number", "wr_refunded_cdemo_sk",
        "wr_returning_cdemo_sk", "wr_refunded_addr_sk", "wr_reason_sk",
        "wr_return_quantity", "wr_refunded_cash", "wr_fee",
        "wr_web_page_sk")
    ws = dfs["web_sales"].select(
        col("ws_item_sk").alias("s_item"),
        col("ws_order_number").alias("s_order"), "ws_quantity",
        "ws_sales_price", "ws_net_profit", "ws_sold_date_sk")
    j = wr.join(ws, on=(col("wr_item_sk") == col("s_item"))
                & (col("wr_order_number") == col("s_order")))
    dd = (dfs["date_dim"].filter(col("d_year") == lit(2000))
          .select("d_date_sk"))
    j = j.join(dd, on=col("ws_sold_date_sk") == col("d_date_sk"),
               how="left_semi")
    wp = dfs["web_page"].select("wp_web_page_sk")
    j = j.join(wp, on=col("wr_web_page_sk") == col("wp_web_page_sk"),
               how="left_semi")
    cd1 = dfs["customer_demographics"].select(
        col("cd_demo_sk").alias("cd1_sk"),
        col("cd_marital_status").alias("cd1_ms"),
        col("cd_education_status").alias("cd1_es"))
    cd2 = dfs["customer_demographics"].select(
        col("cd_demo_sk").alias("cd2_sk"),
        col("cd_marital_status").alias("cd2_ms"),
        col("cd_education_status").alias("cd2_es"))
    j = j.join(cd1, on=col("wr_refunded_cdemo_sk") == col("cd1_sk"))
    j = j.join(cd2, on=col("wr_returning_cdemo_sk") == col("cd2_sk"))
    j = j.filter((col("cd1_ms") == col("cd2_ms"))
                 & (col("cd1_es") == col("cd2_es")))
    band = (((col("cd1_ms") == lit("M")) & (col("cd1_es") == lit("College"))
             & (col("ws_sales_price") >= lit(100.0)))
            | ((col("cd1_ms") == lit("S"))
               & (col("cd1_es") == lit("Primary"))
               & (col("ws_sales_price") < lit(100.0)))
            | ((col("cd1_ms") == lit("W"))
               & (col("cd1_es") == lit("2 yr Degree"))))
    j = j.filter(band)
    ca = (dfs["customer_address"]
          .filter(col("ca_country") == lit("United States"))
          .select("ca_address_sk"))
    j = j.join(ca, on=col("wr_refunded_addr_sk") == col("ca_address_sk"),
               how="left_semi")
    r = dfs["reason"].select("r_reason_sk", "r_reason_desc")
    j = j.join(r, on=col("wr_reason_sk") == col("r_reason_sk"))
    return (j.group_by("r_reason_desc")
            .agg(("avg", "wr_return_quantity", "avg_qty"),
                 ("avg", "wr_refunded_cash", "avg_cash"),
                 ("avg", "wr_fee", "avg_fee"))
            .sort("r_reason_desc").limit(100))


def q85_pandas(t):
    wr = t["web_returns"]
    ws = t["web_sales"]
    j = wr.merge(ws, left_on=["wr_item_sk", "wr_order_number"],
                 right_on=["ws_item_sk", "ws_order_number"])
    d = t["date_dim"]
    dd = d[d.d_year == 2000].d_date_sk
    j = j[j.ws_sold_date_sk.isin(dd)]
    j = j[j.wr_web_page_sk.isin(t["web_page"].wp_web_page_sk)]
    cd = t["customer_demographics"]
    cd1 = cd[["cd_demo_sk", "cd_marital_status", "cd_education_status"]] \
        .rename(columns={"cd_demo_sk": "cd1_sk",
                         "cd_marital_status": "cd1_ms",
                         "cd_education_status": "cd1_es"})
    cd2 = cd[["cd_demo_sk", "cd_marital_status", "cd_education_status"]] \
        .rename(columns={"cd_demo_sk": "cd2_sk",
                         "cd_marital_status": "cd2_ms",
                         "cd_education_status": "cd2_es"})
    j = j.merge(cd1, left_on="wr_refunded_cdemo_sk", right_on="cd1_sk")
    j = j.merge(cd2, left_on="wr_returning_cdemo_sk", right_on="cd2_sk")
    j = j[(j.cd1_ms == j.cd2_ms) & (j.cd1_es == j.cd2_es)]
    band = (((j.cd1_ms == "M") & (j.cd1_es == "College")
             & (j.ws_sales_price >= 100.0))
            | ((j.cd1_ms == "S") & (j.cd1_es == "Primary")
               & (j.ws_sales_price < 100.0))
            | ((j.cd1_ms == "W") & (j.cd1_es == "2 yr Degree")))
    j = j[band]
    ca = t["customer_address"]
    j = j[j.wr_refunded_addr_sk.isin(
        ca[ca.ca_country == "United States"].ca_address_sk)]
    j = j.merge(t["reason"], left_on="wr_reason_sk",
                right_on="r_reason_sk")
    out = j.groupby("r_reason_desc", as_index=False).agg(
        avg_qty=("wr_return_quantity", "mean"),
        avg_cash=("wr_refunded_cash", "mean"),
        avg_fee=("wr_fee", "mean"))
    return (out.sort_values("r_reason_desc").head(100)
            .reset_index(drop=True))


QUERIES_EXT3.update({
    "q80": (q80, q80_pandas),
    "q85": (q85, q85_pandas),
})


# ---------------------------------------------------------------------------
# q24 — paired store-sales/returns net-paid by color vs 5% of the average
# (scalar subquery over the shared ssales subtree)
# ---------------------------------------------------------------------------


def _q24_ssales(dfs):
    ss = dfs["store_sales"].select("ss_ticket_number", "ss_item_sk",
                                   "ss_store_sk", "ss_customer_sk",
                                   "ss_net_paid")
    sr = dfs["store_returns"].select(
        col("sr_ticket_number").alias("r_ticket"),
        col("sr_item_sk").alias("r_item"))
    j = ss.join(sr, on=(col("ss_ticket_number") == col("r_ticket"))
                & (col("ss_item_sk") == col("r_item")))
    st = dfs["store"].select("s_store_sk", "s_store_name", "s_market_id")
    j = j.join(st, on=col("ss_store_sk") == col("s_store_sk"))
    j = j.filter(col("s_market_id") <= lit(5))
    it = dfs["item"].select("i_item_sk", "i_color")
    j = j.join(it, on=col("ss_item_sk") == col("i_item_sk"))
    c = dfs["customer"].select("c_customer_sk", "c_first_name",
                               "c_last_name", "c_birth_country")
    j = j.join(c, on=col("ss_customer_sk") == col("c_customer_sk"))
    j = j.filter(col("c_birth_country") != lit("UNITED STATES"))
    return (j.group_by("c_last_name", "c_first_name", "s_store_name",
                       "i_color")
            .agg(("sum", "ss_net_paid", "netpaid")))


def q24(dfs):
    ssales = _q24_ssales(dfs)
    avg_paid = _q24_ssales(dfs).agg(("avg", "netpaid", "a")).as_scalar()
    j = ssales.filter(col("i_color") == lit("red"))
    j = j.filter(col("netpaid") > avg_paid * lit(0.05))
    return (j.group_by("c_last_name", "c_first_name", "s_store_name")
            .agg(("sum", "netpaid", "paid"))
            .sort("c_last_name", "c_first_name", "s_store_name")
            .limit(100))


def q24_pandas(t):
    ss = t["store_sales"]
    sr = t["store_returns"][["sr_ticket_number", "sr_item_sk"]]
    j = ss.merge(sr, left_on=["ss_ticket_number", "ss_item_sk"],
                 right_on=["sr_ticket_number", "sr_item_sk"])
    st = t["store"]
    j = j.merge(st[st.s_market_id <= 5][["s_store_sk", "s_store_name"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"][["i_item_sk", "i_color"]],
                left_on="ss_item_sk", right_on="i_item_sk")
    c = t["customer"]
    j = j.merge(c[["c_customer_sk", "c_first_name", "c_last_name",
                   "c_birth_country"]],
                left_on="ss_customer_sk", right_on="c_customer_sk")
    j = j[j.c_birth_country != "UNITED STATES"]
    ssales = j.groupby(["c_last_name", "c_first_name", "s_store_name",
                        "i_color"], as_index=False).agg(
        netpaid=("ss_net_paid", "sum"))
    avg_paid = ssales.netpaid.mean()
    k = ssales[(ssales.i_color == "red")
               & (ssales.netpaid > 0.05 * avg_paid)]
    out = k.groupby(["c_last_name", "c_first_name", "s_store_name"],
                    as_index=False).agg(paid=("netpaid", "sum"))
    return (out.sort_values(["c_last_name", "c_first_name",
                             "s_store_name"]).head(100)
            .reset_index(drop=True))


# ---------------------------------------------------------------------------
# q23 — catalog+web sales of frequent items to the best store customers
# (two scalar subqueries + semi joins)
# ---------------------------------------------------------------------------


def q23(dfs):
    dd_years = (dfs["date_dim"]
                .filter((col("d_year") >= lit(1999))
                        & (col("d_year") <= lit(2001)))
                .select("d_date_sk"))
    ss = dfs["store_sales"].select("ss_item_sk", "ss_customer_sk",
                                   "ss_sold_date_sk", "ss_quantity",
                                   "ss_sales_price")
    ss_y = ss.join(dd_years, on=col("ss_sold_date_sk") == col("d_date_sk"),
                   how="left_semi")
    # frequent items: sold more than 1.5x the average per-item row count
    item_cnt = ss_y.group_by("ss_item_sk").agg(("count", "*", "cnt"))
    avg_cnt = (ss_y.group_by("ss_item_sk").agg(("count", "*", "cnt"))
               .agg(("avg", "cnt", "a")).as_scalar())
    frequent = (item_cnt.filter(col("cnt") > avg_cnt * lit(1.5))
                .select(col("ss_item_sk").alias("freq_item")))
    # best customers: store spend above half the max customer spend
    cust_tot = (ss_y.group_by("ss_customer_sk")
                .agg(("sum", col("ss_quantity") * col("ss_sales_price"),
                      "csales")))
    max_sales = (ss_y.group_by("ss_customer_sk")
                 .agg(("sum", col("ss_quantity") * col("ss_sales_price"),
                       "csales"))
                 .agg(("max", "csales", "m")).as_scalar())
    best = (cust_tot.filter(col("csales") > max_sales * lit(0.5))
            .select(col("ss_customer_sk").alias("best_cust")))
    dd_month = (dfs["date_dim"]
                .filter((col("d_year") == lit(2000))
                        & (col("d_moy") == lit(3)))
                .select("d_date_sk"))

    def channel(sales, s_item, s_cust, s_date, s_qty, s_price):
        s = dfs[sales].select(col(s_item).alias("item"),
                              col(s_cust).alias("cust"),
                              col(s_date).alias("date_sk"),
                              (col(s_qty) * col(s_price)).alias("sales"))
        s = s.join(dd_month, on=col("date_sk") == col("d_date_sk"),
                   how="left_semi")
        s = s.join(frequent, on=col("item") == col("freq_item"),
                   how="left_semi")
        s = s.join(best, on=col("cust") == col("best_cust"),
                   how="left_semi")
        return s.select("sales")

    cs = channel("catalog_sales", "cs_item_sk", "cs_bill_customer_sk",
                 "cs_sold_date_sk", "cs_quantity", "cs_sales_price")
    ws = channel("web_sales", "ws_item_sk", "ws_bill_customer_sk",
                 "ws_sold_date_sk", "ws_quantity", "ws_sales_price")
    return cs.union(ws).agg(("sum", "sales", "total_sales"))


def q23_pandas(t):
    d = t["date_dim"]
    dd_years = d[(d.d_year >= 1999) & (d.d_year <= 2001)].d_date_sk
    ss = t["store_sales"]
    ss_y = ss[ss.ss_sold_date_sk.isin(dd_years)]
    cnt = ss_y.groupby("ss_item_sk").size()
    frequent = set(cnt[cnt > 1.5 * cnt.mean()].index)
    tot = (ss_y.assign(v=ss_y.ss_quantity * ss_y.ss_sales_price)
           .groupby("ss_customer_sk").v.sum())
    best = set(tot[tot > 0.5 * tot.max()].index)
    dd_month = d[(d.d_year == 2000) & (d.d_moy == 3)].d_date_sk

    def channel(sales, s_item, s_cust, s_date, s_qty, s_price):
        s = t[sales]
        s = s[s[s_date].isin(dd_month) & s[s_item].isin(frequent)
              & s[s_cust].isin(best)]
        return (s[s_qty] * s[s_price]).sum(min_count=1)

    cs = channel("catalog_sales", "cs_item_sk", "cs_bill_customer_sk",
                 "cs_sold_date_sk", "cs_quantity", "cs_sales_price")
    ws = channel("web_sales", "ws_item_sk", "ws_bill_customer_sk",
                 "ws_sold_date_sk", "ws_quantity", "ws_sales_price")
    vals = [v for v in (cs, ws) if not pd.isna(v)]
    total = sum(vals) if vals else np.nan
    return pd.DataFrame({"total_sales": [total]})


# ---------------------------------------------------------------------------
# q14 — cross-channel items (2-way INTERSECT of item dimension tuples)
# with an average-sales scalar gate
# ---------------------------------------------------------------------------


def q14(dfs):
    dd_years = (dfs["date_dim"]
                .filter((col("d_year") >= lit(1999))
                        & (col("d_year") <= lit(2001)))
                .select("d_date_sk"))
    it = dfs["item"].select("i_item_sk", "i_brand_id", "i_class",
                            "i_category_id")

    def chan_items(sales, s_item, s_date):
        s = dfs[sales].select(col(s_item).alias("item"),
                              col(s_date).alias("date_sk"))
        s = s.join(dd_years, on=col("date_sk") == col("d_date_sk"),
                   how="left_semi")
        s = s.join(it, on=col("item") == col("i_item_sk"))
        return s.select("i_brand_id", "i_class", "i_category_id")

    iss = chan_items("store_sales", "ss_item_sk", "ss_sold_date_sk")
    ics = chan_items("catalog_sales", "cs_item_sk", "cs_sold_date_sk")
    iws = chan_items("web_sales", "ws_item_sk", "ws_sold_date_sk")
    cross = iss.intersect(ics).intersect(iws)
    cross = cross.select(col("i_brand_id").alias("x_brand"),
                         col("i_class").alias("x_class"),
                         col("i_category_id").alias("x_cat"))

    def chan_sales(sales, s_item, s_date, s_qty, s_price):
        s = dfs[sales].select(col(s_item).alias("item"),
                              col(s_date).alias("date_sk"),
                              (col(s_qty) * col(s_price)).alias("sales"))
        return s

    avg_sales = (chan_sales("store_sales", "ss_item_sk",
                            "ss_sold_date_sk", "ss_quantity",
                            "ss_list_price")
                 .union(chan_sales("catalog_sales", "cs_item_sk",
                                   "cs_sold_date_sk", "cs_quantity",
                                   "cs_list_price"))
                 .union(chan_sales("web_sales", "ws_item_sk",
                                   "ws_sold_date_sk", "ws_quantity",
                                   "ws_list_price"))
                 .join(dd_years, on=col("date_sk") == col("d_date_sk"),
                       how="left_semi")
                 .agg(("avg", "sales", "a")).as_scalar())

    dd_month = (dfs["date_dim"]
                .filter((col("d_year") == lit(2000))
                        & (col("d_moy") == lit(12)))
                .select("d_date_sk"))

    def channel_sum(sales, s_item, s_date, s_qty, s_price, label):
        s = dfs[sales].select(col(s_item).alias("item"),
                              col(s_date).alias("date_sk"),
                              (col(s_qty) * col(s_price)).alias("sales"))
        s = s.join(dd_month, on=col("date_sk") == col("d_date_sk"),
                   how="left_semi")
        s = s.join(it, on=col("item") == col("i_item_sk"))
        s = s.join(cross, on=(col("i_brand_id") == col("x_brand"))
                   & (col("i_class") == col("x_class"))
                   & (col("i_category_id") == col("x_cat")),
                   how="left_semi")
        g = (s.group_by("i_brand_id", "i_class", "i_category_id")
             .agg(("sum", "sales", "sales"), ("count", "*", "number_sales")))
        g = g.filter(col("sales") > avg_sales)
        return g.with_column("channel", lit(label))

    st = channel_sum("store_sales", "ss_item_sk", "ss_sold_date_sk",
                     "ss_quantity", "ss_list_price", "store")
    ct = channel_sum("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
                     "cs_quantity", "cs_list_price", "catalog")
    wt = channel_sum("web_sales", "ws_item_sk", "ws_sold_date_sk",
                     "ws_quantity", "ws_list_price", "web")
    u = st.union(ct).union(wt)
    return (u.select("channel", "i_brand_id", "i_class", "i_category_id",
                     "sales", "number_sales")
            .sort("channel", "i_brand_id", "i_class", "i_category_id")
            .limit(100))


def q14_pandas(t):
    d = t["date_dim"]
    dd_years = d[(d.d_year >= 1999) & (d.d_year <= 2001)].d_date_sk
    it = t["item"][["i_item_sk", "i_brand_id", "i_class",
                    "i_category_id"]]

    def chan_items(sales, s_item, s_date):
        s = t[sales]
        s = s[s[s_date].isin(dd_years)]
        s = s.merge(it, left_on=s_item, right_on="i_item_sk")
        return set(map(tuple, s[["i_brand_id", "i_class",
                                 "i_category_id"]].values))

    cross = (chan_items("store_sales", "ss_item_sk", "ss_sold_date_sk")
             & chan_items("catalog_sales", "cs_item_sk", "cs_sold_date_sk")
             & chan_items("web_sales", "ws_item_sk", "ws_sold_date_sk"))

    allv = []
    for sales, s_item, s_date, s_qty, s_price in (
            ("store_sales", "ss_item_sk", "ss_sold_date_sk",
             "ss_quantity", "ss_list_price"),
            ("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
             "cs_quantity", "cs_list_price"),
            ("web_sales", "ws_item_sk", "ws_sold_date_sk", "ws_quantity",
             "ws_list_price")):
        s = t[sales]
        s = s[s[s_date].isin(dd_years)]
        allv.append(s[s_qty] * s[s_price])
    avg_sales = pd.concat(allv).mean()

    dd_month = d[(d.d_year == 2000) & (d.d_moy == 12)].d_date_sk
    frames = []
    for sales, s_item, s_date, s_qty, s_price, label in (
            ("store_sales", "ss_item_sk", "ss_sold_date_sk",
             "ss_quantity", "ss_list_price", "store"),
            ("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
             "cs_quantity", "cs_list_price", "catalog"),
            ("web_sales", "ws_item_sk", "ws_sold_date_sk", "ws_quantity",
             "ws_list_price", "web")):
        s = t[sales]
        s = s[s[s_date].isin(dd_month)]
        s = s.merge(it, left_on=s_item, right_on="i_item_sk")
        key = list(map(tuple, s[["i_brand_id", "i_class",
                                 "i_category_id"]].values))
        s = s[[k in cross for k in key]]
        s = s.assign(v=s[s_qty] * s[s_price])
        g = s.groupby(["i_brand_id", "i_class", "i_category_id"],
                      as_index=False).agg(sales=("v", "sum"),
                                          number_sales=("v", "count"))
        g = g[g.sales > avg_sales]
        g.insert(0, "channel", label)
        frames.append(g)
    u = pd.concat(frames, ignore_index=True)
    return (u.sort_values(["channel", "i_brand_id", "i_class",
                           "i_category_id"]).head(100)
            .reset_index(drop=True))


QUERIES_EXT3.update({
    "q14": (q14, q14_pandas),
    "q23": (q23, q23_pandas),
    "q24": (q24, q24_pandas),
})
