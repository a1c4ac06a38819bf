"""The counters on the port's index path: `rules.queries_served` (a query
a rule served from at least one index, counted once), the bucketed
lane's `join.bucketed.*` and its `join:bucketed` span, and
`join.broadcast.calls` / `.fallbacks` (a broadcast join whose keys left
the direct-address table for the counting join). A dense build side runs
inside a fused stage, which counts the call; a wide one declines the
stage's table and runs the eager join, which counts call and fallback."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import telemetry

N_FACT, N_DIM = 3000, 400


@pytest.fixture
def lake(tmp_path):
    rng = np.random.default_rng(11)
    dense = np.arange(N_DIM, dtype=np.int64)
    tables = {
        "fact": pa.table({"key": rng.integers(0, N_DIM + 50,
                                              N_FACT).astype(np.int64),
                          "v": rng.random(N_FACT)}),
        "dim": pa.table({"key": dense, "name": [f"n{i}" for i in dense]}),
        # Keys 100,000 apart: a key range past the direct-address
        # table's 2**24 slots.
        "wide": pa.table({"key": dense * 100_000,
                          "name": [f"w{i}" for i in dense]}),
    }
    for name, table in tables.items():
        (tmp_path / name).mkdir()
        pq.write_table(table, str(tmp_path / name / "part-0.parquet"))
    return tmp_path


def _session(root, **extra):
    conf = {"spark.hyperspace.warehouse.dir": str(root / "wh"),
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.distribution.enabled": "false",
            "spark.hyperspace.index.num.buckets": "8"}
    conf.update(extra)
    sess = ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")
    dfs = {t: sess.read_parquet(str(root / t)) for t in ("fact", "dim",
                                                        "wide")}
    return sess, dfs


def _indexed(root, **extra):
    sess, dfs = _session(root, **extra)
    hs = ths.Hyperspace(sess)
    hs.create_index(dfs["fact"], ths.IndexConfig("factIdx", ["key"], ["v"]))
    hs.create_index(dfs["dim"], ths.IndexConfig("dimIdx", ["key"],
                                                ["name"]))
    sess.enable_hyperspace()
    return sess, dfs


def _delta(run):
    """The registry's counters that `run()` moved, by how much."""
    reg = telemetry.get_registry()
    before = reg.counters_dict()
    out = run()
    after = reg.counters_dict()
    moved = {k: v - before.get(k, 0.0) for k, v in after.items()
             if v != before.get(k, 0.0)}
    return moved, out


def _join(dfs, right="dim", how="inner"):
    return dfs["fact"].join(dfs[right], on=ths.col("key") == ths.col("key"),
                            how=how)


def _want(lake, right, how):
    import pandas as pd
    fact = pq.read_table(str(lake / "fact")).to_pandas()
    dim = pq.read_table(str(lake / right)).to_pandas()
    if how in ("left_semi", "left_anti"):
        hit = fact.key.isin(dim.key)
        return int((hit if how == "left_semi" else ~hit).sum())
    return len(pd.merge(fact, dim, on="key",
                        how="left" if how == "left_outer" else "inner"))


def test_a_served_query_counts_once_and_an_unindexed_one_not_at_all(lake):
    sess, dfs = _indexed(lake)
    moved, table = _delta(lambda: _join(dfs).collect())
    assert table.num_rows == _want(lake, "dim", "inner")
    # Two indexes served the join; the query counts once.
    assert moved["rules.served.factIdx"] == 1
    assert moved["rules.served.dimIdx"] == 1
    assert moved["rules.queries_served"] == 1
    moved, _ = _delta(lambda: dfs["wide"].filter(
        ths.col("key") > 5).collect())
    assert "rules.queries_served" not in moved
    assert not any(k.startswith("rules.served.") for k in moved)
    sess.disable_hyperspace()
    moved, _ = _delta(lambda: _join(dfs).collect())
    assert "rules.queries_served" not in moved


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi",
                                 "left_anti"])
def test_bucketed_counters_count_the_bucketed_lane(lake, how):
    sess, dfs = _indexed(lake, **{
        "spark.hyperspace.broadcast.threshold": "-1"})
    frame = _join(dfs, how=how)
    moved, (table, qm) = _delta(lambda: frame.collect(with_metrics=True))
    assert table.num_rows == _want(lake, "dim", how)
    assert moved["join.bucketed.calls"] == 1
    assert moved["join.bucketed.rows_in"] == N_FACT + N_DIM
    assert moved["join.bucketed.s"] > 0
    spans = [s for s in qm.spans if s.name == "join:bucketed"]
    assert len(spans) == 1 and spans[0].layer == "operators"
    assert spans[0].wall_s == pytest.approx(moved["join.bucketed.s"],
                                            abs=1e-6)


@pytest.mark.parametrize("threshold", ["-1", "10485760"])
def test_other_join_lanes_leave_the_bucketed_counters(lake, threshold):
    """Rules off: the global sort-merge join (broadcast off) or the
    broadcast join (the default threshold) runs, and counts nothing of
    the bucketed lane."""
    sess, dfs = _session(lake, **{
        "spark.hyperspace.broadcast.threshold": threshold})
    moved, table = _delta(lambda: _join(dfs).collect())
    assert table.num_rows == _want(lake, "dim", "inner")
    assert not any(k.startswith("join.bucketed.") for k in moved)
    assert ("join.broadcast.calls" in moved) == (threshold != "-1")


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi"])
@pytest.mark.parametrize("right,fallbacks", [("dim", 0), ("wide", 1)])
def test_a_wide_key_range_falls_back_and_is_counted(lake, how, right,
                                                    fallbacks):
    sess, dfs = _session(lake)
    moved, table = _delta(lambda: _join(dfs, right, how).collect())
    assert table.num_rows == _want(lake, right, how)
    assert moved["join.broadcast.calls"] == 1
    assert moved.get("join.broadcast.fallbacks", 0) == fallbacks
