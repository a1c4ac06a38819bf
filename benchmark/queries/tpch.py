"""Frozen copy of the query builders (on the port's DataFrame API) and the index definitions of
`hyperspace_tpu_torch/tpch/queries.py` at commit 4cd0f12.

Split mechanically from the source module, function bodies unchanged;
the benchmark's yardstick, not to be edited with the port.
"""

from __future__ import annotations

from hyperspace_tpu_torch.plan.expr import col, lit, when
from benchmark.data.tpch import days


def _volume():
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


def _year_expr(name: str):
    """EXTRACT(year) over a date32 column as a CASE chain (data years are
    1992..1998)."""
    e = when(col(name) < lit(days(1993, 1, 1)), 1992)
    for y in range(1993, 1999):
        e = e.when(col(name) < lit(days(y + 1, 1, 1)), y)
    return e.otherwise(1999)


def q1(dfs):
    li = dfs["lineitem"].filter(
        col("l_shipdate") <= lit(days(1998, 9, 2)))
    disc = _volume()
    charge = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
              * (lit(1.0) + col("l_tax")))
    return (li.group_by("l_returnflag", "l_linestatus").agg(
        ("sum", "l_quantity", "sum_qty"),
        ("sum", "l_extendedprice", "sum_base_price"),
        ("sum", disc, "sum_disc_price"),
        ("sum", charge, "sum_charge"),
        ("avg", "l_quantity", "avg_qty"),
        ("avg", "l_extendedprice", "avg_price"),
        ("avg", "l_discount", "avg_disc"),
        ("count", "*", "count_order"))
        .sort("l_returnflag", "l_linestatus"))


def q2(dfs):
    part = (dfs["part"]
            .filter((col("p_size") == lit(15))
                    & col("p_type").like("%BRASS"))
            .select("p_partkey", "p_mfgr"))
    region = dfs["region"].filter(col("r_name") == lit("EUROPE")) \
        .select("r_regionkey")
    nation = dfs["nation"].select("n_nationkey", "n_name", "n_regionkey")
    nation = nation.join(region, on=col("n_regionkey") == col("r_regionkey")) \
        .select("n_nationkey", "n_name")
    supp = dfs["supplier"].select(
        "s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone",
        "s_acctbal", "s_comment")
    supp = supp.join(nation, on=col("s_nationkey") == col("n_nationkey")) \
        .select("s_suppkey", "s_name", "s_address", "s_phone", "s_acctbal",
                "s_comment", "n_name")
    ps = dfs["partsupp"].select("ps_partkey", "ps_suppkey", "ps_supplycost")
    ps_eu = ps.join(supp, on=col("ps_suppkey") == col("s_suppkey"))
    mincost = (ps_eu.group_by("ps_partkey")
               .agg(("min", "ps_supplycost", "min_cost")))
    j = part.join(ps_eu, on=col("p_partkey") == col("ps_partkey"))
    j = j.join(mincost, on=(col("ps_partkey") == col("ps_partkey"))
               & (col("ps_supplycost") == col("min_cost")))
    return (j.select("s_acctbal", "s_name", "n_name", "p_partkey",
                     "p_mfgr", "s_address", "s_phone", "s_comment")
            .sort("-s_acctbal", "n_name", "s_name", "p_partkey")
            .limit(100))


def q3(dfs):
    cust = dfs["customer"].filter(
        col("c_mktsegment") == lit("BUILDING")).select("c_custkey")
    orders = dfs["orders"].filter(
        col("o_orderdate") < lit(days(1995, 3, 15))).select(
        "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority")
    li = dfs["lineitem"].filter(
        col("l_shipdate") > lit(days(1995, 3, 15))).select(
        "l_orderkey", "l_extendedprice", "l_discount")
    j = orders.join(cust, on=col("o_custkey") == col("c_custkey"))
    j = li.join(j, on=col("l_orderkey") == col("o_orderkey"))
    return (j.group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(("sum", _volume(), "revenue"))
            .sort("-revenue", "o_orderdate", "l_orderkey").limit(10))


def q4(dfs):
    orders = dfs["orders"].filter(
        (col("o_orderdate") >= lit(days(1993, 7, 1)))
        & (col("o_orderdate") < lit(days(1993, 10, 1)))).select(
        "o_orderkey", "o_orderpriority")
    late = dfs["lineitem"].filter(
        col("l_commitdate") < col("l_receiptdate")).select("l_orderkey")
    j = orders.join(late, on=col("o_orderkey") == col("l_orderkey"),
                    how="left_semi")
    return (j.group_by("o_orderpriority")
            .agg(("count", "*", "order_count")).sort("o_orderpriority"))


def q5(dfs):
    region = dfs["region"].filter(col("r_name") == lit("ASIA")) \
        .select("r_regionkey")
    nation = dfs["nation"].join(
        region, on=col("n_regionkey") == col("r_regionkey")).select(
        "n_nationkey", "n_name")
    orders = dfs["orders"].filter(
        (col("o_orderdate") >= lit(days(1994, 1, 1)))
        & (col("o_orderdate") < lit(days(1995, 1, 1)))).select(
        "o_orderkey", "o_custkey")
    cust = dfs["customer"].select("c_custkey", "c_nationkey")
    li = dfs["lineitem"].select("l_orderkey", "l_suppkey",
                                "l_extendedprice", "l_discount")
    supp = dfs["supplier"].select("s_suppkey", "s_nationkey")
    j = orders.join(cust, on=col("o_custkey") == col("c_custkey"))
    j = li.join(j, on=col("l_orderkey") == col("o_orderkey"))
    j = j.join(supp, on=(col("l_suppkey") == col("s_suppkey"))
               & (col("c_nationkey") == col("s_nationkey")))
    j = j.join(nation, on=col("s_nationkey") == col("n_nationkey"))
    return (j.group_by("n_name").agg(("sum", _volume(), "revenue"))
            .sort("-revenue"))


def q6(dfs):
    li = dfs["lineitem"].filter(
        (col("l_shipdate") >= lit(days(1994, 1, 1)))
        & (col("l_shipdate") < lit(days(1995, 1, 1)))
        & col("l_discount").between(lit(0.05), lit(0.07))
        & (col("l_quantity") < lit(24)))
    return li.agg(("sum", col("l_extendedprice") * col("l_discount"),
                   "revenue"))


def q7(dfs):
    pair = col("n_name").isin("FRANCE", "GERMANY")
    n1 = dfs["nation"].filter(pair).select("n_nationkey", "n_name")
    n2 = dfs["nation"].filter(pair).select("n_nationkey", "n_name")
    li = dfs["lineitem"].filter(
        col("l_shipdate").between(lit(days(1995, 1, 1)),
                                  lit(days(1996, 12, 31)))).select(
        "l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice",
        "l_discount")
    j = li.join(dfs["supplier"].select("s_suppkey", "s_nationkey"),
                on=col("l_suppkey") == col("s_suppkey"))
    j = j.join(dfs["orders"].select("o_orderkey", "o_custkey"),
               on=col("l_orderkey") == col("o_orderkey"))
    j = j.join(dfs["customer"].select("c_custkey", "c_nationkey"),
               on=col("o_custkey") == col("c_custkey"))
    j = j.join(n1, on=col("s_nationkey") == col("n_nationkey"))
    j = j.join(n2, on=col("c_nationkey") == col("n_nationkey"))
    # Only FR/DE rows survive, so "pair in {(FR,DE),(DE,FR)}" == inequality.
    j = j.filter(col("n_name") != col("n_name_r"))
    j = j.select(col("n_name").alias("supp_nation"),
                 col("n_name_r").alias("cust_nation"),
                 _year_expr("l_shipdate").alias("l_year"),
                 _volume().alias("volume"))
    return (j.group_by("supp_nation", "cust_nation", "l_year")
            .agg(("sum", "volume", "revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def q8(dfs):
    region = dfs["region"].filter(col("r_name") == lit("AMERICA")) \
        .select("r_regionkey")
    n1 = dfs["nation"].join(
        region, on=col("n_regionkey") == col("r_regionkey")).select(
        "n_nationkey")
    n2 = dfs["nation"].select("n_nationkey", "n_name")
    part = dfs["part"].filter(
        col("p_type") == lit("ECONOMY ANODIZED STEEL")).select("p_partkey")
    orders = dfs["orders"].filter(
        col("o_orderdate").between(lit(days(1995, 1, 1)),
                                   lit(days(1996, 12, 31)))).select(
        "o_orderkey", "o_custkey", "o_orderdate")
    li = dfs["lineitem"].select("l_orderkey", "l_partkey", "l_suppkey",
                                "l_extendedprice", "l_discount")
    j = li.join(part, on=col("l_partkey") == col("p_partkey"))
    j = j.join(orders, on=col("l_orderkey") == col("o_orderkey"))
    j = j.join(dfs["customer"].select("c_custkey", "c_nationkey"),
               on=col("o_custkey") == col("c_custkey"))
    j = j.join(n1, on=col("c_nationkey") == col("n_nationkey"))
    j = j.join(dfs["supplier"].select("s_suppkey", "s_nationkey"),
               on=col("l_suppkey") == col("s_suppkey"))
    j = j.join(n2, on=col("s_nationkey") == col("n_nationkey"))
    j = j.select(_year_expr("o_orderdate").alias("o_year"),
                 _volume().alias("volume"), "n_name")
    brazil = when(col("n_name") == lit("BRAZIL"), col("volume")) \
        .otherwise(0.0)
    g = j.group_by("o_year").agg(("sum", brazil, "brazil_volume"),
                                 ("sum", "volume", "total_volume"))
    return (g.select("o_year",
                     (col("brazil_volume") / col("total_volume"))
                     .alias("mkt_share")).sort("o_year"))


def q9(dfs):
    part = dfs["part"].filter(col("p_name").like("%green%")) \
        .select("p_partkey")
    li = dfs["lineitem"].select("l_orderkey", "l_partkey", "l_suppkey",
                                "l_quantity", "l_extendedprice",
                                "l_discount")
    j = li.join(part, on=col("l_partkey") == col("p_partkey"))
    j = j.join(dfs["supplier"].select("s_suppkey", "s_nationkey"),
               on=col("l_suppkey") == col("s_suppkey"))
    j = j.join(dfs["partsupp"].select("ps_partkey", "ps_suppkey",
                                      "ps_supplycost"),
               on=(col("l_suppkey") == col("ps_suppkey"))
               & (col("l_partkey") == col("ps_partkey")))
    j = j.join(dfs["orders"].select("o_orderkey", "o_orderdate"),
               on=col("l_orderkey") == col("o_orderkey"))
    j = j.join(dfs["nation"].select("n_nationkey", "n_name"),
               on=col("s_nationkey") == col("n_nationkey"))
    amount = (_volume()
              - col("ps_supplycost") * col("l_quantity"))
    j = j.select(col("n_name").alias("nation"),
                 _year_expr("o_orderdate").alias("o_year"),
                 amount.alias("amount"))
    return (j.group_by("nation", "o_year")
            .agg(("sum", "amount", "sum_profit"))
            .sort("nation", "-o_year"))


def q10(dfs):
    orders = dfs["orders"].filter(
        (col("o_orderdate") >= lit(days(1993, 10, 1)))
        & (col("o_orderdate") < lit(days(1994, 1, 1)))).select(
        "o_orderkey", "o_custkey")
    li = dfs["lineitem"].filter(col("l_returnflag") == lit("R")).select(
        "l_orderkey", "l_extendedprice", "l_discount")
    j = li.join(orders, on=col("l_orderkey") == col("o_orderkey"))
    j = j.join(dfs["customer"].select(
        "c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey",
        "c_address", "c_comment"),
        on=col("o_custkey") == col("c_custkey"))
    j = j.join(dfs["nation"].select("n_nationkey", "n_name"),
               on=col("c_nationkey") == col("n_nationkey"))
    return (j.group_by("c_custkey", "c_name", "c_acctbal", "c_phone",
                       "n_name", "c_address", "c_comment")
            .agg(("sum", _volume(), "revenue"))
            .sort("-revenue", "c_custkey").limit(20))


def q11(dfs):
    nation = dfs["nation"].filter(col("n_name") == lit("GERMANY")) \
        .select("n_nationkey")
    supp = dfs["supplier"].select("s_suppkey", "s_nationkey").join(
        nation, on=col("s_nationkey") == col("n_nationkey")).select(
        "s_suppkey")
    ps = dfs["partsupp"].select("ps_partkey", "ps_suppkey",
                                "ps_supplycost", "ps_availqty")
    ps_de = ps.join(supp, on=col("ps_suppkey") == col("s_suppkey"))
    value = col("ps_supplycost") * col("ps_availqty")
    per_part = (ps_de.group_by("ps_partkey").agg(("sum", value, "value")))
    total = ps_de.agg(("sum", value, "total_value"))
    j = per_part.join(total, how="cross")
    j = j.filter(col("value") > col("total_value") * lit(0.0001))
    return j.select("ps_partkey", "value").sort("-value", "ps_partkey")


def q12(dfs):
    li = dfs["lineitem"].filter(
        col("l_shipmode").isin("MAIL", "SHIP")
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= lit(days(1994, 1, 1)))
        & (col("l_receiptdate") < lit(days(1995, 1, 1)))).select(
        "l_orderkey", "l_shipmode")
    j = li.join(dfs["orders"].select("o_orderkey", "o_orderpriority"),
                on=col("l_orderkey") == col("o_orderkey"))
    high = when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), 1) \
        .otherwise(0)
    low = when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), 0) \
        .otherwise(1)
    return (j.group_by("l_shipmode")
            .agg(("sum", high, "high_line_count"),
                 ("sum", low, "low_line_count")).sort("l_shipmode"))


def q13(dfs):
    orders = dfs["orders"].filter(
        ~col("o_comment").like("%special%requests%")).select(
        "o_orderkey", "o_custkey")
    cust = dfs["customer"].select("c_custkey")
    j = cust.join(orders, on=col("c_custkey") == col("o_custkey"),
                  how="left_outer")
    per_cust = (j.group_by("c_custkey")
                .agg(("count", "o_orderkey", "c_count")))
    return (per_cust.group_by("c_count")
            .agg(("count", "*", "custdist"))
            .sort("-custdist", "-c_count"))


def q14(dfs):
    li = dfs["lineitem"].filter(
        (col("l_shipdate") >= lit(days(1995, 9, 1)))
        & (col("l_shipdate") < lit(days(1995, 10, 1)))).select(
        "l_partkey", "l_extendedprice", "l_discount")
    j = li.join(dfs["part"].select("p_partkey", "p_type"),
                on=col("l_partkey") == col("p_partkey"))
    promo = when(col("p_type").like("PROMO%"), _volume()).otherwise(0.0)
    g = j.agg(("sum", promo, "promo"), ("sum", _volume(), "total"))
    return g.select((lit(100.0) * col("promo") / col("total"))
                    .alias("promo_revenue"))


def q15(dfs):
    li = dfs["lineitem"].filter(
        (col("l_shipdate") >= lit(days(1996, 1, 1)))
        & (col("l_shipdate") < lit(days(1996, 4, 1)))).select(
        "l_suppkey", "l_extendedprice", "l_discount")
    revenue = (li.group_by("l_suppkey")
               .agg(("sum", _volume(), "total_revenue")))
    top = revenue.agg(("max", "total_revenue", "max_revenue"))
    j = revenue.join(top,
                     on=col("total_revenue") == col("max_revenue"))
    j = j.join(dfs["supplier"].select("s_suppkey", "s_name", "s_address",
                                      "s_phone"),
               on=col("l_suppkey") == col("s_suppkey"))
    return (j.select("s_suppkey", "s_name", "s_address", "s_phone",
                     "total_revenue").sort("s_suppkey"))


def q16(dfs):
    part = dfs["part"].filter(
        (col("p_brand") != lit("Brand#45"))
        & ~col("p_type").like("MEDIUM POLISHED%")
        & col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9)).select(
        "p_partkey", "p_brand", "p_type", "p_size")
    bad_supp = dfs["supplier"].filter(
        col("s_comment").like("%Customer%Complaints%")).select("s_suppkey")
    ps = dfs["partsupp"].select("ps_partkey", "ps_suppkey")
    ps = ps.join(bad_supp, on=col("ps_suppkey") == col("s_suppkey"),
                 how="left_anti")
    j = ps.join(part, on=col("ps_partkey") == col("p_partkey"))
    return (j.group_by("p_brand", "p_type", "p_size")
            .agg(("count_distinct", "ps_suppkey", "supplier_cnt"))
            .sort("-supplier_cnt", "p_brand", "p_type", "p_size"))


def q17(dfs):
    part = dfs["part"].filter(
        (col("p_brand") == lit("Brand#23"))
        & (col("p_container") == lit("MED BOX"))).select("p_partkey")
    li = dfs["lineitem"].select("l_partkey", "l_quantity",
                                "l_extendedprice")
    avg_qty = (li.group_by("l_partkey")
               .agg(("avg", "l_quantity", "avg_qty")))
    j = li.join(part, on=col("l_partkey") == col("p_partkey"))
    j = j.join(avg_qty, on=col("l_partkey") == col("l_partkey"))
    j = j.filter(col("l_quantity") < col("avg_qty") * lit(0.2))
    g = j.agg(("sum", "l_extendedprice", "total"))
    return g.select((col("total") / lit(7.0)).alias("avg_yearly"))


def q18(dfs):
    li = dfs["lineitem"].select("l_orderkey", "l_quantity")
    big = (li.group_by("l_orderkey").agg(("sum", "l_quantity", "sum_qty"))
           .having(col("sum_qty") > lit(300)).select("l_orderkey"))
    orders = dfs["orders"].select("o_orderkey", "o_custkey", "o_orderdate",
                                  "o_totalprice")
    orders = orders.join(big, on=col("o_orderkey") == col("l_orderkey"),
                         how="left_semi")
    j = orders.join(dfs["customer"].select("c_custkey", "c_name"),
                    on=col("o_custkey") == col("c_custkey"))
    j = li.join(j, on=col("l_orderkey") == col("o_orderkey"))
    return (j.group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                       "o_totalprice")
            .agg(("sum", "l_quantity", "sum_qty"))
            .sort("-o_totalprice", "o_orderdate", "o_orderkey").limit(100))


def q19(dfs):
    li = dfs["lineitem"].filter(
        col("l_shipmode").isin("AIR", "REG AIR")
        & (col("l_shipinstruct") == lit("DELIVER IN PERSON"))).select(
        "l_partkey", "l_quantity", "l_extendedprice", "l_discount")
    part = dfs["part"].select("p_partkey", "p_brand", "p_container",
                              "p_size")
    j = li.join(part, on=col("l_partkey") == col("p_partkey"))
    b1 = ((col("p_brand") == lit("Brand#12"))
          & col("p_container").isin("SM CASE", "SM BOX", "SM PACK",
                                    "SM PKG")
          & col("l_quantity").between(lit(1), lit(11))
          & col("p_size").between(lit(1), lit(5)))
    b2 = ((col("p_brand") == lit("Brand#23"))
          & col("p_container").isin("MED BAG", "MED BOX", "MED PKG",
                                    "MED PACK")
          & col("l_quantity").between(lit(10), lit(20))
          & col("p_size").between(lit(1), lit(10)))
    b3 = ((col("p_brand") == lit("Brand#34"))
          & col("p_container").isin("LG CASE", "LG BOX", "LG PACK",
                                    "LG PKG")
          & col("l_quantity").between(lit(20), lit(30))
          & col("p_size").between(lit(1), lit(15)))
    j = j.filter(b1 | b2 | b3)
    return j.agg(("sum", _volume(), "revenue"))


def q20(dfs):
    part = dfs["part"].filter(col("p_name").like("forest%")) \
        .select("p_partkey")
    li = dfs["lineitem"].filter(
        (col("l_shipdate") >= lit(days(1994, 1, 1)))
        & (col("l_shipdate") < lit(days(1995, 1, 1)))).select(
        "l_partkey", "l_suppkey", "l_quantity")
    half = (li.group_by("l_partkey", "l_suppkey")
            .agg(("sum", "l_quantity", "qty_sum")))
    ps = dfs["partsupp"].select("ps_partkey", "ps_suppkey", "ps_availqty")
    ps = ps.join(part, on=col("ps_partkey") == col("p_partkey"),
                 how="left_semi")
    j = ps.join(half, on=(col("ps_partkey") == col("l_partkey"))
                & (col("ps_suppkey") == col("l_suppkey")))
    j = j.filter(col("ps_availqty") > col("qty_sum") * lit(0.5))
    supp = dfs["supplier"].select("s_suppkey", "s_name", "s_address",
                                  "s_nationkey")
    supp = supp.join(j.select("ps_suppkey"),
                     on=col("s_suppkey") == col("ps_suppkey"),
                     how="left_semi")
    nation = dfs["nation"].filter(col("n_name") == lit("CANADA")) \
        .select("n_nationkey")
    supp = supp.join(nation, on=col("s_nationkey") == col("n_nationkey"))
    return supp.select("s_name", "s_address").sort("s_name")


def q21(dfs):
    li = dfs["lineitem"].select("l_orderkey", "l_suppkey", "l_commitdate",
                                "l_receiptdate")
    # Per order: distinct suppliers overall and among LATE lines. The
    # official EXISTS l2 == ">= 2 distinct suppliers"; NOT EXISTS l3 ==
    # "exactly 1 distinct supplier among late lines" (l1 is late, so that
    # one supplier is l1's).
    n_supp = (li.group_by("l_orderkey")
              .agg(("count_distinct", "l_suppkey", "n_supp")))
    late = li.filter(col("l_receiptdate") > col("l_commitdate"))
    n_late = (late.group_by("l_orderkey")
              .agg(("count_distinct", "l_suppkey", "n_late_supp")))
    orders = dfs["orders"].filter(col("o_orderstatus") == lit("F")) \
        .select("o_orderkey")
    j = late.select("l_orderkey", "l_suppkey").join(
        orders, on=col("l_orderkey") == col("o_orderkey"), how="left_semi")
    j = j.join(n_supp, on=col("l_orderkey") == col("l_orderkey"))
    j = j.join(n_late, on=col("l_orderkey") == col("l_orderkey"))
    j = j.filter((col("n_supp") >= lit(2)) & (col("n_late_supp") == lit(1)))
    supp = dfs["supplier"].select("s_suppkey", "s_name", "s_nationkey")
    nation = dfs["nation"].filter(col("n_name") == lit("SAUDI ARABIA")) \
        .select("n_nationkey")
    supp = supp.join(nation, on=col("s_nationkey") == col("n_nationkey"))
    j = j.join(supp, on=col("l_suppkey") == col("s_suppkey"))
    return (j.group_by("s_name").agg(("count", "*", "numwait"))
            .sort("-numwait", "s_name").limit(100))


def q22(dfs):
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cust = dfs["customer"].select(
        col("c_phone").substr(1, 2).alias("cntrycode"), "c_acctbal",
        "c_custkey")
    cust = cust.filter(col("cntrycode").isin(*codes))
    pos_avg = (cust.filter(col("c_acctbal") > lit(0.0))
               .agg(("avg", "c_acctbal", "avg_bal")))
    cust = cust.join(pos_avg, how="cross")
    cust = cust.filter(col("c_acctbal") > col("avg_bal"))
    orders = dfs["orders"].select("o_custkey")
    cust = cust.join(orders, on=col("c_custkey") == col("o_custkey"),
                     how="left_anti")
    return (cust.group_by("cntrycode")
            .agg(("count", "*", "numcust"), ("sum", "c_acctbal", "totacctbal"))
            .sort("cntrycode"))


# (index name, table, (indexed, included), used by) — the hot equi-join
# pairs (lineitem<->orders on the order key; lineitem<->part on the part
# key) plus the shipdate filter index q1/q6 can cover.
_INDEX_DEFS = [
    ("tpch_li_ord", "lineitem", (["l_orderkey"],
     ["l_suppkey", "l_extendedprice", "l_discount", "l_quantity",
      "l_shipdate", "l_returnflag"]),
     ("q3", "q5", "q7", "q10", "q18")),
    ("tpch_ord_key", "orders", (["o_orderkey"],
     ["o_custkey", "o_orderdate", "o_shippriority", "o_totalprice",
      "o_orderpriority"]),
     ("q3", "q5", "q7", "q10", "q12", "q18")),
    ("tpch_li_part", "lineitem", (["l_partkey"],
     ["l_suppkey", "l_quantity", "l_extendedprice", "l_discount",
      "l_shipdate", "l_shipmode", "l_shipinstruct"]),
     ("q8", "q9", "q14", "q17", "q19")),
    ("tpch_part_key", "part", (["p_partkey"],
     ["p_brand", "p_type", "p_size", "p_container", "p_name", "p_mfgr"]),
     ("q8", "q9", "q14", "q17", "q19")),
    ("tpch_li_ship", "lineitem", (["l_shipdate"],
     ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
      "l_returnflag", "l_linestatus"]),
     ("q1", "q6")),
]


BUILDERS = {
    "q1": q1,
    "q2": q2,
    "q3": q3,
    "q4": q4,
    "q5": q5,
    "q6": q6,
    "q7": q7,
    "q8": q8,
    "q9": q9,
    "q10": q10,
    "q11": q11,
    "q12": q12,
    "q13": q13,
    "q14": q14,
    "q15": q15,
    "q16": q16,
    "q17": q17,
    "q18": q18,
    "q19": q19,
    "q20": q20,
    "q21": q21,
    "q22": q22,
}
