"""Copied from `hyperspace_tpu_torch/tpch/generator.py` at commit 4cd0f12
and brought to the TPC-H specification's row counts and columns: the
benchmark's data generator, not to be edited with the port. Against the
copy: `part` has 2,000 rows per unit of scale (200,000 at SF1) and
`partsupp` four times that, `lineitem` has 1 to 7 lines per order (each
count equally often), `o_orderkey` is sparse (the first 8 of every 32
keys), and `l_comment`, `p_comment`, `ps_comment` and `n_comment` are
written.

Deterministic TPC-H generator.

All 8 tables with every column of the specification, at a row scale
controlled by `scale` (scale=1.0 ~ SF0.01). Value distributions are
synthetic but respect the official join topology and value grammars the
query predicates probe: every (l_partkey, l_suppkey) pair exists in
partsupp, o_orderstatus is derived from the order's line statuses, phone
country codes are `10 + nationkey` (q22), p_type is the official
<quality> <finish> <metal> grammar (q2/q8/q16 LIKE probes), a third of
customers never order (q22's anti join), and some order/supplier comments
carry the `%special%requests%` / `%Customer%Complaints%` needles
(q13/q16). The comments no query reads are drawn from a seeded pool of
texts of the specification's lengths.

Everything is seeded: same scale, same seed, same bytes. Dates are arrow
date32. `scale=100` gives SF1's row counts (150,000 customers, 1,500,000
orders, 5,999,995 `lineitem` rows).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict

import numpy as np

_EPOCH = datetime.date(1970, 1, 1)


def days(y: int, m: int, d: int) -> int:
    """date32 value (days since epoch) of a calendar date."""
    return (datetime.date(y, m, d) - _EPOCH).days


_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# The official 25 nations with their region keys.
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

_QUALITIES = ["ECONOMY", "STANDARD", "PROMO", "MEDIUM", "LARGE", "SMALL"]
_FINISHES = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_METALS = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONTAINERS = ["%s %s" % (a, b)
               for a in ("SM", "MED", "LG", "JUMBO", "WRAP")
               for b in ("CASE", "BOX", "BAG", "PKG", "JAR", "PACK",
                         "CAN", "DRUM")]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
               "5-LOW"]
_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
             "TAKE BACK RETURN"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "blanched", "blue", "blush", "brown", "burlywood", "burnished",
           "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
           "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
           "firebrick", "floral", "forest", "frosted", "gainsboro",
           "ghost", "goldenrod", "green", "grey", "honeydew", "hot",
           "indian", "ivory", "khaki", "lace", "lavender"]


_WORDS = ("furiously", "quickly", "carefully", "blithely", "slyly", "fluffily",
          "final", "regular", "express", "pending", "ironic", "special",
          "bold", "even", "silent", "unusual", "packages", "deposits",
          "accounts", "foxes", "ideas", "theodolites", "pinto", "beans",
          "instructions", "dependencies", "platelets", "asymptotes",
          "courts", "dolphins", "sleep", "wake", "haggle", "nag", "use",
          "boost", "affix", "detect", "integrate", "cajole", "among",
          "across", "above", "along", "after", "about", "the", "of")


def _texts(rng, pa, n: int, lo: int, hi: int, pool: int = 4096):
    """`n` texts of `lo` to `hi` characters, words drawn from a seeded pool
    of `pool` texts (the specification's comment lengths)."""
    texts = []
    for length in rng.integers(lo, hi + 1, pool):
        words = []
        while len(" ".join(words)) < length:
            words.append(_WORDS[rng.integers(len(_WORDS))])
        text = " ".join(words)[:length]
        texts.append(text[:-1] + "s" if text.endswith(" ") else text)
    return pa.array(texts).take(pa.array(rng.integers(0, pool, n)))


def generate(out_dir: str, scale: float = 1.0,
             seed: int = 20260730) -> Dict[str, str]:
    """Write the 8 tables as parquet dirs under `out_dir`; returns
    {table: path}. Idempotent for a given (out_dir, scale, seed)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    text_rng = np.random.default_rng([seed, 7])
    n_part = max(int(2000 * scale), 100)
    n_supp = max(int(100 * scale), 40)
    n_cust = max(int(1500 * scale), 300)
    n_ord = n_cust * 10

    tables: Dict[str, dict] = {}
    tables["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(_REGIONS),
        "r_comment": np.array(["" for _ in _REGIONS]),
    }
    tables["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.array([n for n, _ in _NATIONS]),
        "n_regionkey": np.asarray([r for _, r in _NATIONS],
                                  dtype=np.int64),
        "n_comment": _texts(text_rng, pa, 25, 31, 114),
    }

    # Round-robin nations (7 coprime with 25 -> full cycle): every nation
    # has suppliers at any scale, so the nation-probing queries
    # (q7 FR/DE, q11 DE, q20 CA, q21 SA) never see an empty side.
    s_nation = ((np.arange(n_supp) * 7) % 25).astype(np.int64)
    tables["supplier"] = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": np.array(["Supplier#%09d" % i for i in range(1, n_supp + 1)]),
        "s_address": np.array(["addr s%d" % i for i in range(n_supp)]),
        "s_nationkey": s_nation,
        "s_phone": np.array(["%02d-%03d-%03d-%04d"
                             % (10 + k, 100 + 7 * i % 900,
                                100 + 13 * i % 900, 1000 + 17 * i % 9000)
                             for i, k in enumerate(s_nation)]),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        # Every 13th supplier carries the q16 complaints needle.
        "s_comment": np.array([
            "x Customer stuff Complaints y" if i % 13 == 0
            else "supplier note %d" % i for i in range(n_supp)]),
    }

    c_nation = ((np.arange(n_cust) * 11) % 25).astype(np.int64)
    tables["customer"] = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.array(["Customer#%09d" % i
                            for i in range(1, n_cust + 1)]),
        "c_address": np.array(["addr c%d" % i for i in range(n_cust)]),
        "c_nationkey": c_nation,
        "c_phone": np.array(["%02d-%03d-%03d-%04d"
                             % (10 + k, 100 + 11 * i % 900,
                                100 + 23 * i % 900, 1000 + 29 * i % 9000)
                             for i, k in enumerate(c_nation)]),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": np.array([_SEGMENTS[i % 5] for i in range(n_cust)]),
        "c_comment": np.array(["customer note %d" % i
                               for i in range(n_cust)]),
    }

    p_name = np.array([" ".join([
        _COLORS[(3 * i) % len(_COLORS)], _COLORS[(7 * i + 1) % len(_COLORS)],
        _COLORS[(11 * i + 2) % len(_COLORS)]]) for i in range(n_part)])
    p_type = np.array(["%s %s %s" % (_QUALITIES[i % 6],
                                     _FINISHES[(i // 6) % 5],
                                     _METALS[(i // 30) % 5])
                       for i in range(n_part)])
    p_container = np.array([_CONTAINERS[i % len(_CONTAINERS)]
                            for i in range(n_part)])
    p_size = (1 + np.arange(n_part) % 50).astype(np.int64)
    # The (brand, container, size) triples q17/q19 probe cannot co-occur
    # through the 25/40/50 cycles (shared factors make the residues
    # incompatible) — plant each bracket on a slice of its brand's parts:
    # i=5 mod 25 is Brand#12, 11 mod 25 Brand#23, 17 mod 25 Brand#34.
    idx = np.arange(n_part)
    for residue, container, size in ((5, "SM PACK", 3),
                                     (11, "MED BOX", 7),
                                     (17, "LG BOX", 9)):
        m = idx % 100 == residue
        p_container[m] = container
        p_size[m] = size
    tables["part"] = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": p_name,
        "p_mfgr": np.array(["Manufacturer#%d" % (1 + i % 5)
                            for i in range(n_part)]),
        "p_brand": np.array(["Brand#%d%d" % (1 + i % 5, 1 + (i // 5) % 5)
                             for i in range(n_part)]),
        "p_type": p_type,
        # Deterministic 1..50 cycle (q2 BRASS+15, q16's size list) with
        # the q17/q19 bracket plants above.
        "p_size": p_size,
        "p_container": p_container,
        "p_retailprice": np.round(900 + rng.uniform(0, 1200, n_part), 2),
        "p_comment": _texts(text_rng, pa, n_part, 5, 22),
    }

    # partsupp: each part supplied by 4 suppliers (official fanout).
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_supp = np.zeros(n_part * 4, dtype=np.int64)
    for j in range(4):
        ps_supp[j::4] = 1 + (np.arange(n_part) * 7 + j * (n_supp // 4 + 1)) \
            % n_supp
    # Dedup within a part (small n_supp could collide): nudge duplicates.
    ps_supp = ps_supp.reshape(n_part, 4)
    for j in range(1, 4):
        same = (ps_supp[:, j:j + 1] == ps_supp[:, :j]).any(axis=1)
        while same.any():
            ps_supp[same, j] = ps_supp[same, j] % n_supp + 1
            same = (ps_supp[:, j:j + 1] == ps_supp[:, :j]).any(axis=1)
    # q20's chain (forest part -> CANADA supplier with excess stock) must
    # be non-degenerate at every scale: give each forest-named part one
    # CANADA supplier (linear supplier formulas collapse to one supplier
    # set for all i = 22 mod 40 parts, which can miss CANADA entirely).
    canada_key = next(k for k, (n_, _r) in enumerate(_NATIONS)
                      if n_ == "CANADA")
    canada_supp = 1 + int(np.nonzero(s_nation == canada_key)[0][0])
    forest = np.nonzero(np.char.startswith(p_name.astype(str),
                                           "forest"))[0]
    ps_supp = ps_supp.reshape(n_part, 4)
    for i in forest:
        if canada_supp not in ps_supp[i]:
            ps_supp[i, 0] = canada_supp
    ps_supp = ps_supp.reshape(-1)
    tables["partsupp"] = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": (500 + rng.integers(0, 9500,
                                           n_part * 4)).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_part * 4), 2),
        "ps_comment": _texts(text_rng, pa, n_part * 4, 49, 198),
    }

    # orders: only the first 2/3 of customers ever order (q22's anti join
    # needs order-less customers).
    ordering_cust = np.arange(1, max(2 * n_cust // 3, 1) + 1)
    o_cust = rng.choice(ordering_cust, n_ord).astype(np.int64)
    lo, hi = days(1992, 1, 1), days(1998, 8, 2)
    o_date = rng.integers(lo, hi + 1, n_ord).astype(np.int32)
    # Sparse keys, as the specification's: the first 8 of every 32.
    o_idx = np.arange(n_ord, dtype=np.int64)
    o_key = (o_idx // 8) * 32 + o_idx % 8 + 1
    tables["orders"] = {
        "o_orderkey": o_key,
        "o_custkey": o_cust,
        "o_orderdate": o_date,
        "o_orderpriority": np.array([_PRIORITIES[i % 5]
                                     for i in range(n_ord)]),
        "o_clerk": np.array(["Clerk#%09d" % (1 + i % 1000)
                             for i in range(n_ord)]),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        # Every 11th order carries the q13 needle.
        "o_comment": np.array([
            "was special handling requests done" if i % 11 == 0
            else "order note %d" % i for i in range(n_ord)]),
    }

    # lineitem: 1..7 lines per order, each count equally often in an
    # order drawn from the seed (every seed writes as many lines);
    # (partkey, suppkey) drawn FROM partsupp so q9's ps join always resolves.
    n_lines_per = rng.permutation(np.arange(n_ord) % 7 + 1)
    n_li = int(n_lines_per.sum())
    l_oidx = np.repeat(o_idx, n_lines_per)
    l_order = o_key[l_oidx]
    l_odate = np.repeat(o_date, n_lines_per)
    ps_pick = rng.integers(0, n_part * 4, n_li)
    l_part = ps_part[ps_pick]
    l_supp = ps_supp[ps_pick]
    l_qty = (1 + rng.integers(0, 50, n_li)).astype(np.int64)
    price = np.round(rng.uniform(900, 2100, n_li), 2)
    l_ship = (l_odate + rng.integers(1, 122, n_li)).astype(np.int32)
    l_commit = (l_odate + rng.integers(30, 91, n_li)).astype(np.int32)
    l_receipt = (l_ship + rng.integers(1, 31, n_li)).astype(np.int32)
    cutoff = days(1995, 6, 17)
    l_status = np.where(l_ship > cutoff, "O", "F")
    l_return = np.where(l_receipt <= cutoff,
                        np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    linenumber = np.concatenate([np.arange(1, k + 1)
                                 for k in n_lines_per]).astype(np.int64)
    tables["lineitem"] = {
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": linenumber,
        "l_quantity": l_qty,
        "l_extendedprice": np.round(l_qty * price / 10.0, 2),
        "l_discount": np.round(rng.integers(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(rng.integers(0, 9, n_li) / 100.0, 2),
        "l_returnflag": l_return,
        "l_linestatus": l_status,
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": np.array([_INSTRUCT[i % 4] for i in range(n_li)]),
        "l_shipmode": np.array([_MODES[i % 7] for i in range(n_li)]),
        "l_comment": _texts(text_rng, pa, n_li, 10, 43),
    }

    # o_totalprice / o_orderstatus derived from the lines (official
    # consistency): status F iff every line F, O iff every line O, else P.
    per_order_price = np.zeros(n_ord)
    np.add.at(per_order_price, l_oidx,
              tables["lineitem"]["l_extendedprice"])
    f_cnt = np.zeros(n_ord, dtype=np.int64)
    np.add.at(f_cnt, l_oidx, (l_status == "F").astype(np.int64))
    status = np.where(f_cnt == n_lines_per, "F",
                      np.where(f_cnt == 0, "O", "P"))
    tables["orders"]["o_totalprice"] = np.round(per_order_price, 2)
    tables["orders"]["o_orderstatus"] = status

    date_cols = {"o_orderdate", "l_shipdate", "l_commitdate",
                 "l_receiptdate"}
    paths: Dict[str, str] = {}
    for name, cols in tables.items():
        path = os.path.join(out_dir, name)
        paths[name] = path
        if os.path.isdir(path) and os.listdir(path):
            continue  # already generated (deterministic)
        os.makedirs(path, exist_ok=True)
        arrays = {}
        for cname, values in cols.items():
            if isinstance(values, pa.Array):
                arrays[cname] = values
            elif cname in date_cols:
                arrays[cname] = pa.array(values.astype(np.int32),
                                         type=pa.date32())
            else:
                arrays[cname] = pa.array(values)
        pq.write_table(pa.table(arrays), os.path.join(path,
                                                      "part-0.parquet"))
    return paths
