"""Frozen copy of the pandas oracles; plain NumPy and pandas, with nothing of the program imported of
`hyperspace_tpu_torch/tpch/queries.py` at commit 4cd0f12.

Split mechanically from the source module, function bodies unchanged;
the benchmark's yardstick, not to be edited with the port.
"""

from __future__ import annotations

import datetime
import pandas as pd


def normalize_result(df: pd.DataFrame) -> pd.DataFrame:
    """THE result-normalization contract the 3-way equality checks use
    (tests + bench): stringify non-str object columns (date objects),
    sort by every column, widen numerics to float64."""
    out = df.copy()
    for c in out.columns:
        if out[c].dtype == object and len(out) and not isinstance(
                out[c].iloc[0], str):
            out[c] = out[c].astype(str)
    out = out.sort_values(list(out.columns)).reset_index(drop=True)
    return out.astype({c: "float64" for c in out.columns
                       if out[c].dtype.kind in "fi"})


def _date(y, m, d):
    return datetime.date(y, m, d)


def _year(s):
    return pd.to_datetime(s).dt.year


def q1_pandas(t):
    li = t["lineitem"]
    li = li[li.l_shipdate <= _date(1998, 9, 2)].copy()
    li["disc_price"] = li.l_extendedprice * (1 - li.l_discount)
    li["charge"] = li.disc_price * (1 + li.l_tax)
    g = li.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size")).reset_index()
    return g.sort_values(["l_returnflag", "l_linestatus"]) \
        .reset_index(drop=True)


def q2_pandas(t):
    part = t["part"]
    part = part[(part.p_size == 15)
                & part.p_type.str.endswith("BRASS")][
        ["p_partkey", "p_mfgr"]]
    region = t["region"][t["region"].r_name == "EUROPE"][["r_regionkey"]]
    nation = t["nation"].merge(region, left_on="n_regionkey",
                               right_on="r_regionkey")[
        ["n_nationkey", "n_name"]]
    supp = t["supplier"].merge(nation, left_on="s_nationkey",
                               right_on="n_nationkey")
    ps = t["partsupp"].merge(supp, left_on="ps_suppkey",
                             right_on="s_suppkey")
    mincost = ps.groupby("ps_partkey", as_index=False).agg(
        min_cost=("ps_supplycost", "min"))
    j = part.merge(ps, left_on="p_partkey", right_on="ps_partkey")
    j = j.merge(mincost, on="ps_partkey")
    j = j[j.ps_supplycost == j.min_cost]
    return (j[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
               "s_address", "s_phone", "s_comment"]]
            .sort_values(["s_acctbal", "n_name", "s_name", "p_partkey"],
                         ascending=[False, True, True, True])
            .head(100).reset_index(drop=True))


def q3_pandas(t):
    cust = t["customer"]
    cust = cust[cust.c_mktsegment == "BUILDING"][["c_custkey"]]
    orders = t["orders"]
    orders = orders[orders.o_orderdate < _date(1995, 3, 15)]
    li = t["lineitem"]
    li = li[li.l_shipdate > _date(1995, 3, 15)].copy()
    li["revenue"] = li.l_extendedprice * (1 - li.l_discount)
    j = orders.merge(cust, left_on="o_custkey", right_on="c_custkey")
    j = li.merge(j, left_on="l_orderkey", right_on="o_orderkey")
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False).agg(revenue=("revenue", "sum"))
    return (g.sort_values(["revenue", "o_orderdate", "l_orderkey"],
                          ascending=[False, True, True])
            .head(10).reset_index(drop=True)
            [["l_orderkey", "o_orderdate", "o_shippriority", "revenue"]])


def q4_pandas(t):
    orders = t["orders"]
    orders = orders[(orders.o_orderdate >= _date(1993, 7, 1))
                    & (orders.o_orderdate < _date(1993, 10, 1))]
    li = t["lineitem"]
    late = li[li.l_commitdate < li.l_receiptdate].l_orderkey.unique()
    j = orders[orders.o_orderkey.isin(late)]
    g = j.groupby("o_orderpriority", as_index=False).agg(
        order_count=("o_orderkey", "size"))
    return g.sort_values("o_orderpriority").reset_index(drop=True)


def q5_pandas(t):
    region = t["region"][t["region"].r_name == "ASIA"][["r_regionkey"]]
    nation = t["nation"].merge(region, left_on="n_regionkey",
                               right_on="r_regionkey")[
        ["n_nationkey", "n_name"]]
    orders = t["orders"]
    orders = orders[(orders.o_orderdate >= _date(1994, 1, 1))
                    & (orders.o_orderdate < _date(1995, 1, 1))]
    j = orders.merge(t["customer"], left_on="o_custkey",
                     right_on="c_custkey")
    j = t["lineitem"].merge(j, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(t["supplier"], left_on=["l_suppkey", "c_nationkey"],
                right_on=["s_suppkey", "s_nationkey"])
    j = j.merge(nation, left_on="s_nationkey", right_on="n_nationkey")
    j = j.assign(revenue=j.l_extendedprice * (1 - j.l_discount))
    g = j.groupby("n_name", as_index=False).agg(revenue=("revenue", "sum"))
    return g.sort_values("revenue", ascending=False).reset_index(drop=True)


def q6_pandas(t):
    li = t["lineitem"]
    m = ((li.l_shipdate >= _date(1994, 1, 1))
         & (li.l_shipdate < _date(1995, 1, 1))
         & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
         & (li.l_quantity < 24))
    return pd.DataFrame(
        {"revenue": [(li[m].l_extendedprice * li[m].l_discount).sum()]})


def q7_pandas(t):
    n = t["nation"][t["nation"].n_name.isin(["FRANCE", "GERMANY"])]
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _date(1995, 1, 1))
            & (li.l_shipdate <= _date(1996, 12, 31))]
    j = li.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    j = j.merge(n[["n_nationkey", "n_name"]], left_on="s_nationkey",
                right_on="n_nationkey")
    j = j.merge(n[["n_nationkey", "n_name"]], left_on="c_nationkey",
                right_on="n_nationkey", suffixes=("", "_r"))
    j = j[j.n_name != j.n_name_r].copy()
    j["supp_nation"] = j.n_name
    j["cust_nation"] = j.n_name_r
    j["l_year"] = _year(j.l_shipdate)
    j["volume"] = j.l_extendedprice * (1 - j.l_discount)
    g = j.groupby(["supp_nation", "cust_nation", "l_year"],
                  as_index=False).agg(revenue=("volume", "sum"))
    return g.sort_values(["supp_nation", "cust_nation", "l_year"]) \
        .reset_index(drop=True)


def q8_pandas(t):
    region = t["region"][t["region"].r_name == "AMERICA"][["r_regionkey"]]
    n1 = t["nation"].merge(region, left_on="n_regionkey",
                           right_on="r_regionkey")[["n_nationkey"]]
    part = t["part"][t["part"].p_type == "ECONOMY ANODIZED STEEL"][
        ["p_partkey"]]
    orders = t["orders"]
    orders = orders[(orders.o_orderdate >= _date(1995, 1, 1))
                    & (orders.o_orderdate <= _date(1996, 12, 31))]
    j = t["lineitem"].merge(part, left_on="l_partkey",
                            right_on="p_partkey")
    j = j.merge(orders, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    j = j.merge(n1, left_on="c_nationkey", right_on="n_nationkey")
    j = j.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(t["nation"][["n_nationkey", "n_name"]],
                left_on="s_nationkey", right_on="n_nationkey")
    j = j.assign(o_year=_year(j.o_orderdate),
                 volume=j.l_extendedprice * (1 - j.l_discount))
    g = j.groupby("o_year", as_index=False).apply(
        lambda x: pd.Series({
            "mkt_share": (x[x.n_name == "BRAZIL"].volume.sum()
                          / x.volume.sum())}), include_groups=False)
    return g.sort_values("o_year").reset_index(drop=True)


def q9_pandas(t):
    part = t["part"][t["part"].p_name.str.contains("green")][["p_partkey"]]
    j = t["lineitem"].merge(part, left_on="l_partkey",
                            right_on="p_partkey")
    j = j.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(t["partsupp"], left_on=["l_suppkey", "l_partkey"],
                right_on=["ps_suppkey", "ps_partkey"])
    j = j.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    j = j.assign(nation=j.n_name, o_year=_year(j.o_orderdate),
                 amount=j.l_extendedprice * (1 - j.l_discount)
                 - j.ps_supplycost * j.l_quantity)
    g = j.groupby(["nation", "o_year"], as_index=False).agg(
        sum_profit=("amount", "sum"))
    return g.sort_values(["nation", "o_year"],
                         ascending=[True, False]).reset_index(drop=True)


def q10_pandas(t):
    orders = t["orders"]
    orders = orders[(orders.o_orderdate >= _date(1993, 10, 1))
                    & (orders.o_orderdate < _date(1994, 1, 1))]
    li = t["lineitem"]
    li = li[li.l_returnflag == "R"]
    j = li.merge(orders, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    j = j.merge(t["nation"], left_on="c_nationkey", right_on="n_nationkey")
    j = j.assign(revenue=j.l_extendedprice * (1 - j.l_discount))
    g = j.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone",
                   "n_name", "c_address", "c_comment"],
                  as_index=False).agg(revenue=("revenue", "sum"))
    return (g.sort_values(["revenue", "c_custkey"],
                          ascending=[False, True])
            .head(20).reset_index(drop=True)
            [["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
              "c_address", "c_comment", "revenue"]])


def q11_pandas(t):
    nation = t["nation"][t["nation"].n_name == "GERMANY"][["n_nationkey"]]
    supp = t["supplier"].merge(nation, left_on="s_nationkey",
                               right_on="n_nationkey")[["s_suppkey"]]
    ps = t["partsupp"].merge(supp, left_on="ps_suppkey",
                             right_on="s_suppkey")
    ps = ps.assign(value=ps.ps_supplycost * ps.ps_availqty)
    g = ps.groupby("ps_partkey", as_index=False).agg(
        value=("value", "sum"))
    g = g[g.value > ps.value.sum() * 0.0001]
    return g.sort_values(["value", "ps_partkey"],
                         ascending=[False, True]).reset_index(drop=True)


def q12_pandas(t):
    li = t["lineitem"]
    li = li[li.l_shipmode.isin(["MAIL", "SHIP"])
            & (li.l_commitdate < li.l_receiptdate)
            & (li.l_shipdate < li.l_commitdate)
            & (li.l_receiptdate >= _date(1994, 1, 1))
            & (li.l_receiptdate < _date(1995, 1, 1))]
    j = li.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    hi = j.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    j = j.assign(high_line_count=hi.astype(int),
                 low_line_count=(~hi).astype(int))
    g = j.groupby("l_shipmode", as_index=False).agg(
        high_line_count=("high_line_count", "sum"),
        low_line_count=("low_line_count", "sum"))
    return g.sort_values("l_shipmode").reset_index(drop=True)


def q13_pandas(t):
    orders = t["orders"]
    orders = orders[~orders.o_comment.str.match(
        ".*special.*requests.*")][["o_orderkey", "o_custkey"]]
    j = t["customer"][["c_custkey"]].merge(
        orders, left_on="c_custkey", right_on="o_custkey", how="left")
    per = j.groupby("c_custkey", as_index=False).agg(
        c_count=("o_orderkey", "count"))
    g = per.groupby("c_count", as_index=False).agg(
        custdist=("c_custkey", "size"))
    return g.sort_values(["custdist", "c_count"],
                         ascending=[False, False]).reset_index(drop=True)


def q14_pandas(t):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _date(1995, 9, 1))
            & (li.l_shipdate < _date(1995, 10, 1))]
    j = li.merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    vol = j.l_extendedprice * (1 - j.l_discount)
    promo = vol[j.p_type.str.startswith("PROMO")].sum()
    return pd.DataFrame({"promo_revenue": [100.0 * promo / vol.sum()]})


def q15_pandas(t):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _date(1996, 1, 1))
            & (li.l_shipdate < _date(1996, 4, 1))]
    li = li.assign(vol=li.l_extendedprice * (1 - li.l_discount))
    rev = li.groupby("l_suppkey", as_index=False).agg(
        total_revenue=("vol", "sum"))
    top = rev[rev.total_revenue == rev.total_revenue.max()]
    j = top.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    return (j[["s_suppkey", "s_name", "s_address", "s_phone",
               "total_revenue"]].sort_values("s_suppkey")
            .reset_index(drop=True))


def q16_pandas(t):
    part = t["part"]
    part = part[(part.p_brand != "Brand#45")
                & ~part.p_type.str.startswith("MEDIUM POLISHED")
                & part.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])]
    bad = t["supplier"][t["supplier"].s_comment.str.match(
        ".*Customer.*Complaints.*")].s_suppkey
    ps = t["partsupp"][~t["partsupp"].ps_suppkey.isin(bad)]
    j = ps.merge(part, left_on="ps_partkey", right_on="p_partkey")
    g = j.groupby(["p_brand", "p_type", "p_size"], as_index=False).agg(
        supplier_cnt=("ps_suppkey", "nunique"))
    return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                         ascending=[False, True, True, True]) \
        .reset_index(drop=True)


def q17_pandas(t):
    part = t["part"]
    part = part[(part.p_brand == "Brand#23")
                & (part.p_container == "MED BOX")][["p_partkey"]]
    li = t["lineitem"]
    avg_qty = li.groupby("l_partkey", as_index=False).agg(
        avg_qty=("l_quantity", "mean"))
    j = li.merge(part, left_on="l_partkey", right_on="p_partkey")
    j = j.merge(avg_qty, on="l_partkey")
    j = j[j.l_quantity < 0.2 * j.avg_qty]
    return pd.DataFrame({"avg_yearly": [j.l_extendedprice.sum() / 7.0]})


def q18_pandas(t):
    li = t["lineitem"]
    sums = li.groupby("l_orderkey", as_index=False).agg(
        sum_qty=("l_quantity", "sum"))
    big = sums[sums.sum_qty > 300].l_orderkey
    orders = t["orders"][t["orders"].o_orderkey.isin(big)]
    j = orders.merge(t["customer"], left_on="o_custkey",
                     right_on="c_custkey")
    j = li.merge(j, left_on="l_orderkey", right_on="o_orderkey")
    g = j.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                   "o_totalprice"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"))
    return (g.sort_values(["o_totalprice", "o_orderdate", "o_orderkey"],
                          ascending=[False, True, True])
            .head(100).reset_index(drop=True))


def q19_pandas(t):
    li = t["lineitem"]
    li = li[li.l_shipmode.isin(["AIR", "REG AIR"])
            & (li.l_shipinstruct == "DELIVER IN PERSON")]
    j = li.merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    b1 = ((j.p_brand == "Brand#12")
          & j.p_container.isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
          & j.l_quantity.between(1, 11) & j.p_size.between(1, 5))
    b2 = ((j.p_brand == "Brand#23")
          & j.p_container.isin(["MED BAG", "MED BOX", "MED PKG",
                                "MED PACK"])
          & j.l_quantity.between(10, 20) & j.p_size.between(1, 10))
    b3 = ((j.p_brand == "Brand#34")
          & j.p_container.isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
          & j.l_quantity.between(20, 30) & j.p_size.between(1, 15))
    j = j[b1 | b2 | b3]
    return pd.DataFrame({"revenue": [
        (j.l_extendedprice * (1 - j.l_discount)).sum()]})


def q20_pandas(t):
    part = t["part"][t["part"].p_name.str.startswith("forest")][
        ["p_partkey"]]
    li = t["lineitem"]
    li = li[(li.l_shipdate >= _date(1994, 1, 1))
            & (li.l_shipdate < _date(1995, 1, 1))]
    half = li.groupby(["l_partkey", "l_suppkey"], as_index=False).agg(
        qty_sum=("l_quantity", "sum"))
    ps = t["partsupp"][t["partsupp"].ps_partkey.isin(part.p_partkey)]
    j = ps.merge(half, left_on=["ps_partkey", "ps_suppkey"],
                 right_on=["l_partkey", "l_suppkey"])
    j = j[j.ps_availqty > 0.5 * j.qty_sum]
    nation = t["nation"][t["nation"].n_name == "CANADA"][["n_nationkey"]]
    supp = t["supplier"][t["supplier"].s_suppkey.isin(j.ps_suppkey)]
    supp = supp.merge(nation, left_on="s_nationkey",
                      right_on="n_nationkey")
    return (supp[["s_name", "s_address"]].sort_values("s_name")
            .reset_index(drop=True))


def q21_pandas(t):
    li = t["lineitem"]
    n_supp = li.groupby("l_orderkey").l_suppkey.nunique()
    late = li[li.l_receiptdate > li.l_commitdate]
    n_late = late.groupby("l_orderkey").l_suppkey.nunique()
    orders = set(t["orders"][t["orders"].o_orderstatus == "F"].o_orderkey)
    j = late[late.l_orderkey.isin(orders)].copy()
    j = j[j.l_orderkey.map(n_supp).ge(2)
          & j.l_orderkey.map(n_late).eq(1)]
    nation = t["nation"][t["nation"].n_name == "SAUDI ARABIA"]
    supp = t["supplier"].merge(nation, left_on="s_nationkey",
                               right_on="n_nationkey")
    j = j.merge(supp, left_on="l_suppkey", right_on="s_suppkey")
    g = j.groupby("s_name", as_index=False).agg(
        numwait=("l_orderkey", "size"))
    return (g.sort_values(["numwait", "s_name"], ascending=[False, True])
            .head(100).reset_index(drop=True))


def q22_pandas(t):
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cust = t["customer"].copy()
    cust["cntrycode"] = cust.c_phone.str[:2]
    cust = cust[cust.cntrycode.isin(codes)]
    avg_bal = cust[cust.c_acctbal > 0.0].c_acctbal.mean()
    cust = cust[cust.c_acctbal > avg_bal]
    cust = cust[~cust.c_custkey.isin(t["orders"].o_custkey)]
    g = cust.groupby("cntrycode", as_index=False).agg(
        numcust=("c_custkey", "size"), totacctbal=("c_acctbal", "sum"))
    return g.sort_values("cntrycode").reset_index(drop=True)


ORACLES = {
    "q1": q1_pandas,
    "q2": q2_pandas,
    "q3": q3_pandas,
    "q4": q4_pandas,
    "q5": q5_pandas,
    "q6": q6_pandas,
    "q7": q7_pandas,
    "q8": q8_pandas,
    "q9": q9_pandas,
    "q10": q10_pandas,
    "q11": q11_pandas,
    "q12": q12_pandas,
    "q13": q13_pandas,
    "q14": q14_pandas,
    "q15": q15_pandas,
    "q16": q16_pandas,
    "q17": q17_pandas,
    "q18": q18_pandas,
    "q19": q19_pandas,
    "q20": q20_pandas,
    "q21": q21_pandas,
    "q22": q22_pandas,
}
