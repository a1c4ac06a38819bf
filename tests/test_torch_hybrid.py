"""Hybrid scan through both packages, on the CPU.

An index whose source changed since its build serves filters and joins
as its data UNION the appended files, minus the rows of deleted files
(lineage-enabled indexes). The same seeded lake, made with numpy, goes
through `hyperspace_tpu` and `hyperspace_tpu_torch`:

- hybrid joins of type inner, left_outer, right_outer and full_outer,
  with the hybrid index on the left or on the right, on the port's host
  and torch lanes: the optimized plan holds the Union, the physical plan
  has the JAX package's joins (the join distributed over the Union
  where the join type allows it, else one bucketed join with the
  appended branch re-bucketed by an Exchange), and the rows equal the
  JAX package's, the rules-off query's and, for the inner join, numpy's;
- hybrid filters over appends and lineage-excluded deletes, both lanes;
- `concat_batches`, which the Union runs: host and torch inputs, string
  columns re-unified through one dictionary, nullable columns.

Rows compare exactly in one canonical order: hybrid scan only moves rows.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu.engine.physical import plan_physical as jplan_physical
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plan import nodes as jnodes

import hyperspace_tpu_torch as ths
# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.engine.physical import plan_physical
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops.cuda import partition_kernel
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plan import nodes as tnodes

CPU = torch.device("cpu")
BUCKETS = 8
HOWS = ("inner", "left_outer", "right_outer", "full_outer")


def _rows(table):
    cols = table.column_names
    ordered = table.sort_by([(c, "ascending") for c in cols])
    return [ordered.column(c).to_pylist() for c in cols]


def _side(rng, n, payload, id_start):
    return pa.table({
        "k": rng.integers(0, 300, n).astype(np.int64),
        "id": np.arange(id_start, id_start + n, dtype=np.int64),
        payload: rng.random(n)})


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """Two sources, `a` and `b`, each indexed by both packages at 8
    buckets on `k`; then one file appended to `a`. Its index is stale:
    the rules serve it through hybrid scan."""
    root = tmp_path_factory.mktemp("hybrid_lake")
    rng = np.random.default_rng(17)
    tables = {}
    for name, payload, n in (("a", "x", 3000), ("b", "y", 2000)):
        os.makedirs(root / name)
        base = _side(rng, n, payload, 0)
        pq.write_table(base.slice(0, n // 2), str(root / name / "p0.parquet"))
        pq.write_table(base.slice(n // 2), str(root / name / "p1.parquet"))
        tables[name] = [base]
    conf = {"spark.hyperspace.index.num.buckets": str(BUCKETS),
            "spark.hyperspace.distribution.enabled": "false",
            "spark.hyperspace.broadcast.threshold": "-1",
            "spark.hyperspace.index.hybridscan.enabled": "true"}
    jsess = JSession(jhs.HyperspaceConf(
        {**conf, "spark.hyperspace.warehouse.dir": str(root / "jwh")}))
    tsess = ths.HyperspaceSession(ths.HyperspaceConf(
        {**conf, "spark.hyperspace.warehouse.dir": str(root / "twh")}),
        device="cpu")
    for sess, pkg in ((jsess, jhs), (tsess, ths)):
        hs = pkg.Hyperspace(sess)
        hs.create_index(sess.read_parquet(str(root / "a")),
                        pkg.IndexConfig("aIdx", ["k"], ["id", "x"]))
        hs.create_index(sess.read_parquet(str(root / "b")),
                        pkg.IndexConfig("bIdx", ["k"], ["id", "y"]))
    extra = _side(rng, 700, "x", 10_000)
    pq.write_table(extra, str(root / "a" / "p2.parquet"))
    tables["a"].append(extra)
    return {"root": root, "conf": conf, "jsess": jsess,
            "tables": {k: pa.concat_tables(v) for k, v in tables.items()}}


def _port_session(lake, lane):
    extra = ({"spark.hyperspace.execution.min.device.rows": "0"}
             if lane == "torch" else {})
    return ths.HyperspaceSession(ths.HyperspaceConf({
        **lake["conf"], **extra,
        "spark.hyperspace.warehouse.dir": str(lake["root"] / "twh")}),
        device="cpu")


def _join(sess, root, hybrid, how):
    """The hybrid side `a` on the `hybrid` side of the join, `b` (whose
    index is fresh) on the other."""
    a = sess.read_parquet(str(root / "a")).select("k", "id", "x")
    b = sess.read_parquet(str(root / "b")).select("k", "y")
    left, right = (a, b) if hybrid == "left" else (b, a)
    return left.join(right, on="k", how=how)


def _unions(plan, nodes):
    found = []
    plan.transform_up(lambda n: (found.append(n), n)[1]
                      if isinstance(n, nodes.Union) else n)
    return len(found)


def _joins(physical):
    """The plan's joins with their modes (bucketed or global). The JAX
    planner may route a side shared by two branches through one reused
    node; the port plans it per branch, so only the joins compare."""
    return sorted(line.strip(" +-") for line in
                  physical.tree_string().splitlines()
                  if "SortMergeJoin" in line)


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("hybrid", ["left", "right"])
@pytest.mark.parametrize("how", HOWS)
def test_hybrid_join_equals_jax(lake, how, hybrid, lane):
    root, jsess = lake["root"], lake["jsess"]
    jsess.enable_hyperspace()
    jframe = _join(jsess, root, hybrid, how)
    jplan = jsess.optimize(jframe.plan)
    assert _unions(jplan, jnodes) == 1
    jphys = jplan_physical(jplan, conf=jsess.conf)
    expected = _rows(jframe.collect())

    sess = _port_session(lake, lane)
    sess.enable_hyperspace()
    frame = _join(sess, root, hybrid, how)
    plan = sess.optimize(frame.plan)
    assert _unions(plan, tnodes) == 1
    roots = [r for leaf in plan.collect_leaves() for r in leaf.root_paths]
    assert sum("v__=0" in r for r in roots) == 2
    phys = plan_physical(plan, conf=sess.conf)
    assert _joins(phys) == _joins(jphys)
    # Where the join distributes over the hybrid side's Union, the index
    # branch keeps the bucketed join; where it does not, one bucketed join
    # reads the appended branch through an Exchange inside the Union.
    distributes = (how in ("inner", "left_outer") if hybrid == "left"
                   else how in ("inner", "right_outer"))
    tree = phys.tree_string()
    assert (tree.index("Union") < tree.index("SortMergeJoin")) \
        == distributes, tree
    assert f"bucketed({BUCKETS})" in tree
    before = partition_kernel.partition_ids_and_histogram.launches
    table, metrics = frame.collect(with_metrics=True)
    # On the CPU the Exchange runs the partition kernel's plain version.
    assert partition_kernel.partition_ids_and_histogram.launches == before
    assert _rows(table) == expected
    assert [op.name for op in metrics.operators].count("Union") >= 1

    sess.disable_hyperspace()
    assert _rows(_join(sess, root, hybrid, how).collect()) == expected
    if how == "inner":
        a = lake["tables"]["a"].to_pandas()[["k", "id", "x"]]
        b = lake["tables"]["b"].to_pandas()[["k", "y"]]
        left, right = (a, b) if hybrid == "left" else (b, a)
        oracle = left.merge(right, on="k", suffixes=("", "_r"))
        got = _rows(table)
        assert len(got[0]) == len(oracle)
        assert sorted(got[table.column_names.index("k")]) \
            == sorted(oracle["k"].tolist())


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_hybrid_point_filter_equals_jax(lake, lane):
    """A bucket-pruned point filter over the stale index: the pruned index
    bucket (host lane below min.device.rows) UNION the appended file."""
    root, jsess = lake["root"], lake["jsess"]
    key = int(lake["tables"]["a"].column("k")[0].as_py())

    def query(sess, E):
        return (sess.read_parquet(str(root / "a"))
                .filter(E.col("k") == E.lit(key)).select("id", "x"))

    jsess.enable_hyperspace()
    expected = _rows(query(jsess, JE).collect())
    sess = _port_session(lake, lane)
    sess.enable_hyperspace()
    frame = query(sess, TE)
    plan = sess.optimize(frame.plan)
    assert _unions(plan, tnodes) == 1
    tree = plan_physical(plan, conf=sess.conf).tree_string()
    assert f"prunedBuckets=1/{BUCKETS}" in tree
    assert _rows(frame.collect()) == expected
    want = lake["tables"]["a"].filter(
        pa.compute.equal(lake["tables"]["a"].column("k"), key))
    assert _rows(frame.collect()) == _rows(want.select(["id", "x"]))


def test_hybrid_disabled_reads_the_source(lake):
    sess = ths.HyperspaceSession(ths.HyperspaceConf({
        **lake["conf"], "spark.hyperspace.index.hybridscan.enabled": "false",
        "spark.hyperspace.warehouse.dir": str(lake["root"] / "twh")}),
        device="cpu")
    sess.enable_hyperspace()
    plan = sess.optimize(_join(sess, lake["root"], "left", "inner").plan)
    assert _unions(plan, tnodes) == 0
    assert not any("v__=" in r for leaf in plan.collect_leaves()
                   for r in leaf.root_paths)


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_lineage_hybrid_join_and_filter_equal_jax(tmp_path, lane):
    """Lineage-enabled indexes over a source that lost one file and gained
    another: the index branch excludes the deleted file's rows by
    `_hs_file_id`, the appended file rides the Union."""
    src = tmp_path / "src"
    os.makedirs(src)
    rng = np.random.default_rng(5)
    for i in range(3):
        pq.write_table(_side(rng, 400, "x", 1000 * i),
                       str(src / f"part-{i}.parquet"))
    conf = {"spark.hyperspace.index.num.buckets": "4",
            "spark.hyperspace.distribution.enabled": "false",
            "spark.hyperspace.broadcast.threshold": "-1",
            "spark.hyperspace.index.lineage.enabled": "true",
            "spark.hyperspace.index.hybridscan.enabled": "true"}
    if lane == "torch":
        conf["spark.hyperspace.execution.min.device.rows"] = "0"
    jsess = JSession(jhs.HyperspaceConf(
        {**conf, "spark.hyperspace.warehouse.dir": str(tmp_path / "jwh")}))
    tsess = ths.HyperspaceSession(ths.HyperspaceConf(
        {**conf, "spark.hyperspace.warehouse.dir": str(tmp_path / "twh")}),
        device="cpu")
    for sess, pkg in ((jsess, jhs), (tsess, ths)):
        hs = pkg.Hyperspace(sess)
        df = sess.read_parquet(str(src))
        hs.create_index(df, pkg.IndexConfig("l", ["k"], ["id"]))
        hs.create_index(df, pkg.IndexConfig("r", ["k"], ["x"]))
    os.remove(src / "part-1.parquet")
    pq.write_table(_side(rng, 300, "x", 7000), str(src / "part-7.parquet"))

    def queries(sess, E):
        df = sess.read_parquet(str(src))
        return (df.select("k", "id").join(df.select("k", "x"), on="k",
                                          how="left_outer"),
                df.filter(E.col("k") == E.lit(11)).select("id"))

    jsess.enable_hyperspace()
    tsess.enable_hyperspace()
    for jframe, frame in zip(queries(jsess, JE), queries(tsess, TE)):
        plan = tsess.optimize(frame.plan)
        assert "_hs_file_id" in repr(plan.tree_string())
        assert _unions(plan, tnodes) >= 1
        got = _rows(frame.collect())
        assert got == _rows(jframe.collect())
        assert "_hs_file_id" not in frame.collect().column_names
        assert all(i // 1000 != 1 for i in got[frame.plan.schema.names
                                               .index("id")])
        tsess.disable_hyperspace()
        assert _rows(frame.collect()) == got
        tsess.enable_hyperspace()


# -- concat_batches -----------------------------------------------------------


def _strings_table(rng, n, words):
    return pa.table({
        "s": pa.array([None if x == 0 else words[x % len(words)]
                       for x in rng.integers(0, 40, n)]),
        "v": pa.array(rng.integers(-9, 9, n).astype(np.int64),
                      mask=rng.random(n) < 0.2),
        "f": rng.random(n)})


@pytest.mark.parametrize("lanes", [("host", "host"), ("host", "torch"),
                                   ("torch", "host"), ("torch", "torch")])
def test_concat_batches_equals_jax(lanes):
    rng = np.random.default_rng(3)
    tables = [_strings_table(rng, 300, ["ant", "bee", "cat"]),
              _strings_table(rng, 200, ["bee", "dog", "eel", "fox"])]
    got = tcol.concat_batches([
        tcol.from_arrow(t, device=None if lane == "host" else CPU)
        for t, lane in zip(tables, lanes)])
    assert got.is_host == (lanes == ("host", "host"))
    want = jcol.concat_batches([jcol.from_arrow(t) for t in tables])
    assert tcol.to_arrow(got).equals(jcol.to_arrow(want))
    s = got.column("s")
    assert list(s.dictionary) == sorted(set(s.dictionary))
    assert tcol.to_arrow(got).equals(pa.concat_tables(tables))
