"""The analytic plan nodes and operators of the port, on the CPU.

- Aggregate, Sort and Limit serialize in one package and load in the
  other;
- the planner: Limit over Sort is one TopK, a subtree used twice is one
  ReusedSubplan whose child executes once, a cross join refuses a product
  over its row guard and reads one column of a side the output does not
  use;
- the filter and join rules still fire under Aggregate, Sort and Limit,
  and an Aggregate over a bare Filter(Scan) reads the source when the
  index does not cover every scan column, as in the JAX package;
- the DataFrame verbs (`with_column`, `distinct`, `having`, the
  GroupedData shorthands) against numpy, on both lanes.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.plan import serde as jserde

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch.engine.physical import (CrossJoinExec, LimitExec,
                                                  ReusedExec, SortExec,
                                                  TopKExec, plan_physical)
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import serde as tserde
from hyperspace_tpu_torch.plan.expr import col, lit

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

N = 6000


@pytest.fixture(params=["host", "torch"])
def lake(request, tmp_path, monkeypatch):
    """A 6,000-row source (key, g, v, s) and a 4-bucket covering index on
    `key`, on the host lane or (min.device.rows = 0) the torch lane."""
    rng = np.random.default_rng(9)
    table = pa.table({
        "key": rng.integers(0, 500, N).astype(np.int64),
        "g": rng.integers(0, 4, N).astype(np.int64),
        "v": rng.standard_normal(N),
        "s": rng.choice(np.array(["x", "y", "z"]), N),
    })
    (tmp_path / "src").mkdir()
    pq.write_table(table, str(tmp_path / "src" / "part-0.parquet"))
    conf = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
            "spark.hyperspace.index.num.buckets": "4"}
    if request.param == "torch":
        conf["spark.hyperspace.execution.min.device.rows"] = "0"
        from hyperspace_tpu_torch.io import builder
        monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    sess = ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")
    hs = ths.Hyperspace(sess)
    df = sess.read_parquet(str(tmp_path / "src"))
    hs.create_index(df, ths.IndexConfig("pk", ["key"], ["g", "v", "s"]))
    cols = {c: table.column(c).to_numpy() for c in table.column_names}
    return sess, df, cols


def _index_names(sess, frame):
    return sorted({leaf.index_name for leaf in
                   sess.optimize(frame.plan).collect_leaves()
                   if leaf.index_name})


def test_serde_round_trip_across_packages(lake):
    sess, df, _ = lake
    frame = (df.filter(col("key") < lit(100))
             .group_by("g").agg(("sum", col("v") * lit(2.0), "tv"),
                                ("count_distinct", "s", "ds"))
             .sort("-tv", "g").limit(3))
    text = tserde.plan_to_json(frame.plan)
    jplan = jserde.plan_from_json(text)
    assert jplan.to_dict() == frame.plan.to_dict()
    back = tserde.plan_from_json(jserde.plan_to_json(jplan))
    assert back.to_dict() == frame.plan.to_dict()
    assert back.schema.names == ["g", "tv", "ds"]


def test_limit_over_sort_plans_as_topk(lake):
    sess, df, _ = lake
    topk = plan_physical(df.sort("-v").limit(5).plan, conf=sess.conf)
    assert isinstance(topk, TopKExec) and topk.keys == ["-v"]
    assert isinstance(plan_physical(df.limit(5).plan, conf=sess.conf),
                      LimitExec)
    assert isinstance(plan_physical(df.sort("g", "-v").plan,
                                    conf=sess.conf), SortExec)


def test_sort_and_topk_results(lake):
    sess, df, cols = lake
    order = np.lexsort((-cols["v"], cols["g"]))
    got = df.sort("g", "-v").collect()
    assert np.array_equal(got.column("v").to_numpy(), cols["v"][order])
    top = df.sort("g", "-v").limit(7).collect()
    assert np.array_equal(top.column("v").to_numpy(), cols["v"][order[:7]])
    assert df.limit(4).count() == 4


def test_shared_subtree_is_one_reused_node_executed_once(lake):
    sess, df, cols = lake
    per_g = df.group_by("g").agg(("sum", "v", "total"))
    frame = per_g.join(per_g, on="g").select("g", "total", "total_r")
    phys = plan_physical(frame.plan, conf=sess.conf)
    reused = {id(n): n for n in phys.collect()
              if isinstance(n, ReusedExec)}
    assert len(reused) == 1
    table, metrics = frame.collect(with_metrics=True)
    assert [o.name for o in metrics.operators].count("Aggregate") == 1
    shared = [o for o in metrics.operators if o.name == "ReusedSubplan"]
    assert len(shared) == 2 and [o.detail.get("reused")
                                 for o in shared] == [None, True]
    want = {g: cols["v"][cols["g"] == g].sum() for g in range(4)}
    got = table.to_pydict()
    for g, a, b in zip(got["g"], got["total"], got["total_r"]):
        assert a == b and abs(a - want[g]) <= 1e-9 * max(1.0, abs(a))


def test_cross_join_guard_and_one_column_floor(lake, monkeypatch):
    sess, df, cols = lake
    avg = df.agg(("avg", "v", "mean_v"))
    above = (df.join(avg, how="cross")
             .filter(col("v") > col("mean_v")).select("key"))
    assert above.count() == int((cols["v"] > cols["v"].mean()).sum())
    # The right side feeds no output column: it still reads one column,
    # so the product keeps every left row.
    assert df.select("key").join(df.select("g"), how="cross") \
        .select("key").limit(10).count() == 10
    monkeypatch.setattr(CrossJoinExec, "MAX_ROWS", N * 2)
    with pytest.raises(HyperspaceException, match="refusing"):
        df.join(df.select("g"), how="cross").count()


def test_rules_fire_under_aggregate_sort_and_limit(lake, tmp_path):
    sess, df, cols = lake
    # A second source with a column `w` that its index `pkw` does not
    # include: an Aggregate over a bare Filter(Scan) reads the source, as
    # in the JAX package — the filter rule judges a bare Filter(Scan) on
    # every scan column, not on the aggregate's.
    wide = pa.table({**{c: cols[c] for c in ("key", "g", "v", "s")},
                     "w": np.arange(N, dtype=np.int64)})
    (tmp_path / "wide").mkdir()
    pq.write_table(wide, str(tmp_path / "wide" / "part-0.parquet"))
    wdf = sess.read_parquet(str(tmp_path / "wide"))
    ths.Hyperspace(sess).create_index(
        wdf, ths.IndexConfig("pkw", ["key"], ["g", "v"]))
    sess.enable_hyperspace()
    narrow = df.filter(col("key") < lit(250))
    frames = {
        "aggregate_over_bare_filter": wdf.filter(col("key") < lit(250))
        .group_by("g").agg(("sum", "v", "t")),
        "aggregate": narrow.select("g", "v").group_by("g").agg(
            ("count", "*", "n")),
        "sort": narrow.select("key", "v").sort("-v"),
        "limit": narrow.select("key", "v").limit(5),
        "topk": narrow.select("key", "v").sort("v").limit(5),
    }
    for name, frame in frames.items():
        want_read = [] if name == "aggregate_over_bare_filter" else ["pk"]
        assert _index_names(sess, frame) == want_read, name
    got = frames["aggregate_over_bare_filter"].sort("g").collect()
    mask = cols["key"] < 250
    want = [cols["v"][mask & (cols["g"] == g)].sum() for g in range(4)]
    assert np.allclose(got.column("t").to_numpy(), want, rtol=1e-12)
    # A join of two covered, linear sides under an Aggregate, a Sort and a
    # Limit: both sides read the index.
    left = df.select("key", "v")
    right = df.select("key", "g")
    joined = left.join(right, on="key")
    for frame in (joined.group_by("g").agg(("sum", "v", "t")),
                  joined.sort("-v").limit(3), joined.limit(3)):
        assert _index_names(sess, frame) == ["pk"]
    sess.disable_hyperspace()


def test_dataframe_verbs(lake):
    sess, df, cols = lake
    doubled = df.with_column("v", col("v") * lit(2.0))
    assert doubled.columns == df.columns
    assert np.allclose(doubled.collect().column("v").to_numpy(),
                       cols["v"] * 2)
    extra = df.with_column("w", col("key") + lit(1))
    assert extra.columns == df.columns + ["w"]
    assert df.select("g", "s").distinct().count() == len(
        set(zip(cols["g"], cols["s"])))
    counts = df.group_by("g").count().having(col("count") > lit(0))
    assert sorted(counts.collect().column("count").to_pylist()) == sorted(
        np.bincount(cols["g"]).tolist())
    grouped = df.group_by("g")
    for verb, fn in (("sum", np.sum), ("avg", np.mean), ("min", np.min),
                     ("max", np.max)):
        got = getattr(grouped, verb)("v").sort("g").collect()
        want = [fn(cols["v"][cols["g"] == g]) for g in range(4)]
        assert np.allclose(got.column(f"{verb}_v").to_numpy(), want,
                           rtol=1e-12), verb
