"""The Quick Start loop through both packages, on the CPU.

50,000 rows with `bench.py`'s schema plus one string column, 16 buckets.
Each package builds the covering index in its own warehouse; the bucket
files must be equal, and three index-served filters (a bucket-pruned point
lookup, a range over an included column, an IN list) must give the same
rows in `hyperspace_tpu_torch`, in `hyperspace_tpu` and in a numpy oracle.
Then each package serves the other's index.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl
from hyperspace_tpu.io import builder as jbuilder
from hyperspace_tpu.plan import expr as JE

import hyperspace_tpu_torch as ths
# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.io import builder as tbuilder
from hyperspace_tpu_torch.plan import expr as TE

N = 50_000
BUCKETS = 16
INDEX = "qsIdx"


def _source_table():
    rng = np.random.default_rng(42)
    return pa.table({
        "key": rng.integers(0, N // 4, N).astype(np.int64),
        "k2": rng.integers(0, 100, N).astype(np.int64),
        "id": np.arange(N, dtype=np.int64),
        "score": rng.random(N).astype(np.float64),
        "name": pa.array([f"name{int(x)}" for x in
                          rng.integers(0, 300, N)]),
    })


def _conf(cls, warehouse):
    # One device for both: the JAX package would otherwise shard the build
    # over the test session's virtual CPU mesh (a port session on the
    # CPU sees one device unless `parallel.virtual` sets a mesh).
    return cls({"spark.hyperspace.warehouse.dir": str(warehouse),
                "spark.hyperspace.index.num.buckets": str(BUCKETS),
                "spark.hyperspace.execution.min.device.rows": "0",
                "spark.hyperspace.distribution.enabled": "false"})


def _queries(E, table):
    """(name, build(df) -> DataFrame, numpy row mask, output columns)."""
    key = table.column("key").to_numpy()
    k2 = table.column("k2").to_numpy()
    score = table.column("score").to_numpy()
    hit = int(key[0])
    picks = [int(key[i]) for i in (5, 17, 99)]
    return [
        ("point",
         lambda df: df.filter((E.col("key") == E.lit(hit))
                              & (E.col("k2") < E.lit(50)))
         .select("id", "score"),
         (key == hit) & (k2 < 50), ["id", "score"]),
        ("range",
         lambda df: df.filter((E.col("key") >= E.lit(100))
                              & (E.col("key") < E.lit(2500))
                              & (E.col("score") > E.lit(0.75)))
         .select("key", "id", "name"),
         (key >= 100) & (key < 2500) & (score > 0.75),
         ["key", "id", "name"]),
        ("in",
         lambda df: df.filter(E.col("key").isin(*picks))
         .select("id", "k2", "name"),
         np.isin(key, picks), ["id", "k2", "name"]),
    ]


def _sorted_rows(table, columns):
    return sorted(zip(*[table.column(c).to_pylist() for c in columns]))


def _oracle(table, mask, columns):
    return sorted(zip(*[table.column(c).to_numpy(zero_copy_only=False)[mask]
                        .tolist() for c in columns]))


def _roots(plan):
    return [p for leaf in plan.collect_leaves() for p in leaf.root_paths]


def _version_dir(warehouse):
    return os.path.join(str(warehouse), "indexes", INDEX, "v__=0")


def _bucket_files(warehouse):
    path = _version_dir(warehouse)
    return sorted(f for f in os.listdir(path) if f.endswith(".parquet"))


@pytest.fixture(params=["host", "device"])
def built(request, tmp_path_factory, monkeypatch):
    """Both packages' indexes over one source, built on `lane`."""
    if request.param == "device":
        monkeypatch.setattr(jbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
        monkeypatch.setattr(tbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
    root = tmp_path_factory.mktemp(f"qs_{request.param}")
    table = _source_table()
    os.makedirs(root / "src")
    pq.write_table(table.slice(0, N // 2), str(root / "src" / "a.parquet"))
    pq.write_table(table.slice(N // 2), str(root / "src" / "b.parquet"))

    jsess = JSession(_conf(jhs.HyperspaceConf, root / "jwh"))
    jdf = jsess.read_parquet(str(root / "src"))
    jhs.Hyperspace(jsess).create_index(
        jdf, jhs.IndexConfig(INDEX, ["key"], ["k2", "id", "score", "name"]))

    tsess = ths.HyperspaceSession(_conf(ths.HyperspaceConf, root / "twh"),
                                  device="cpu")
    tdf = tsess.read_parquet(str(root / "src"))
    ths.Hyperspace(tsess).create_index(
        tdf, ths.IndexConfig(INDEX, ["key"], ["k2", "id", "score", "name"]))
    return {"root": root, "table": table, "jsess": jsess, "jdf": jdf,
            "tsess": tsess, "tdf": tdf}


def test_index_files_equal(built):
    jwh, twh = built["root"] / "jwh", built["root"] / "twh"
    names = _bucket_files(jwh)
    assert names and names == _bucket_files(twh)
    for name in names:
        expected = pq.read_table(os.path.join(_version_dir(jwh), name))
        got = pq.read_table(os.path.join(_version_dir(twh), name))
        assert got.equals(expected), name


def test_index_served_filters_agree(built):
    table = built["table"]
    built["jsess"].enable_hyperspace()
    built["tsess"].enable_hyperspace()
    for (name, tq, mask, cols), (_, jq, _, _) in zip(
            _queries(TE, table), _queries(JE, table)):
        tframe = tq(built["tdf"])
        roots = _roots(built["tsess"].optimize(tframe.plan))
        assert any("v__=" in r for r in roots), (name, roots)
        expected = _oracle(table, mask, cols)
        assert expected, name
        assert _sorted_rows(tframe.collect(), cols) == expected, name
        assert _sorted_rows(jq(built["jdf"]).collect(), cols) == expected, \
            name


def test_point_filter_prunes_to_one_bucket(built):
    built["tsess"].enable_hyperspace()
    table = built["table"]
    _, tq, _, _ = _queries(TE, table)[0]
    _, metrics = tq(built["tdf"]).collect(with_metrics=True)
    (scan,) = [op for op in metrics.operators if op.name == "Scan"]
    assert scan.detail["buckets_scanned"] == 1
    assert scan.detail["buckets_total"] == BUCKETS


def test_disable_hyperspace_reads_the_source(built):
    sess, table = built["tsess"], built["table"]
    _, tq, mask, cols = _queries(TE, table)[0]
    frame = tq(built["tdf"])
    sess.enable_hyperspace().disable_hyperspace()
    roots = _roots(sess.optimize(frame.plan))
    assert roots == [str(built["root"] / "src")]
    assert _sorted_rows(frame.collect(), cols) == _oracle(table, mask, cols)


def test_port_serves_the_jax_index(built):
    """A port session over the JAX package's warehouse serves from its
    index."""
    root, table = built["root"], built["table"]
    sess = ths.HyperspaceSession(_conf(ths.HyperspaceConf, root / "jwh"),
                                 device="cpu").enable_hyperspace()
    df = sess.read_parquet(str(root / "src"))
    for name, tq, mask, cols in _queries(TE, table):
        frame = tq(df)
        roots = _roots(sess.optimize(frame.plan))
        assert any(r.startswith(str(root / "jwh")) and "v__=" in r
                   for r in roots), (name, roots)
        assert _sorted_rows(frame.collect(), cols) == \
            _oracle(table, mask, cols), name


def test_jax_reads_the_port_log_entry(built):
    root = built["root"]
    port = IndexLogManagerImpl(
        str(root / "twh" / "indexes" / INDEX)).get_latest_log()
    ref = IndexLogManagerImpl(
        str(root / "jwh" / "indexes" / INDEX)).get_latest_log()
    assert port.state == ref.state == "ACTIVE"
    assert port.indexed_columns == ref.indexed_columns == ["key"]
    assert port.included_columns == ref.included_columns
    assert port.num_buckets == ref.num_buckets == BUCKETS
    assert port.schema_json == ref.schema_json
    assert port.source_file_list() == ref.source_file_list()
    assert port.signature().value == ref.signature().value
