"""The 22 TPC-H queries through the port, on the CPU, against the JAX
package and the pandas oracle.

One seeded lake (scale 0.3, 8 buckets — the size of `tests/test_tpch.py`)
serves the JAX package and two sessions of the port: its host lane (the
default `min.device.rows`, so these small tables stay in numpy) and its
torch lane (`min.device.rows = 0` and every index built on the device
lane, so each operator runs on torch tensors on the CPU). Each query's
port result, rules on and rules off, must equal the JAX package's rules-on
result (float64 within rtol=1e-9: sums add in another order) and the
pandas oracle (rtol=1e-6, atol=1e-9, the bounds of `tests/test_tpch.py`).
Rules-on plans must read the covering indexes their filters and joins
can use, and each rules-on optimized logical plan must equal the JAX
package's, roots masked.
"""

import filecmp
import os

import pandas as pd
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu.tpch import QUERIES as JQUERIES
from hyperspace_tpu.tpch import generate as jgenerate
from hyperspace_tpu.tpch.queries import create_indexes as jcreate_indexes

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch.io import builder
from hyperspace_tpu_torch.tpch import QUERIES, generate
from hyperspace_tpu_torch.tpch.queries import (create_indexes,
                                               normalize_result)
from torch_suites import optimized_plan_texts

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

SCALE = 0.3
BUCKETS = "8"

# The indexes each rules-on plan reads, as in the JAX package: the join
# rule serves the joins whose two sides are linear and covered (the other
# queries join a non-linear side, or need a lineitem column no index
# includes); the filter rule never fires on q1/q6's Aggregate(Filter(Scan))
# — a bare Filter(Scan) is judged on every source column, and no index
# covers lineitem's.
INDEXES_READ = {
    "q10": ["tpch_li_ord", "tpch_ord_key"],
    "q18": ["tpch_li_ord", "tpch_ord_key"],
    "q14": ["tpch_li_part", "tpch_part_key"],
    "q17": ["tpch_li_part", "tpch_part_key"],
    "q19": ["tpch_li_part", "tpch_part_key"],
}


def _port_session(root, lane, paths):
    conf = {"spark.hyperspace.warehouse.dir": os.path.join(root, lane),
            "spark.hyperspace.index.num.buckets": BUCKETS}
    if lane == "torch":
        conf["spark.hyperspace.execution.min.device.rows"] = "0"
    sess = ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")
    dfs = {name: sess.read_parquet(path) for name, path in paths.items()}
    saved = builder.BUILD_MIN_DEVICE_ROWS
    if lane == "torch":
        builder.BUILD_MIN_DEVICE_ROWS = 0
    try:
        create_indexes(ths.Hyperspace(sess), dfs)
    finally:
        builder.BUILD_MIN_DEVICE_ROWS = saved
    return sess, dfs


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_torch"))
    paths = generate(os.path.join(root, "data"), scale=SCALE)
    jpaths = jgenerate(os.path.join(root, "jax_data"), scale=SCALE)
    jsess = jhs.HyperspaceSession(jhs.HyperspaceConf({
        "hyperspace.warehouse.dir": os.path.join(root, "jax_wh"),
        "spark.hyperspace.index.num.buckets": BUCKETS}))
    jdfs = {name: jsess.read_parquet(path) for name, path in paths.items()}
    jcreate_indexes(jhs.Hyperspace(jsess), jdfs)
    pdfs = {name: pq.read_table(os.path.join(path, "part-0.parquet"))
            .to_pandas() for name, path in paths.items()}
    return {"root": root, "paths": paths, "jax_paths": jpaths,
            "jax": (jsess, jdfs),
            "pandas": pdfs,
            "host": _port_session(root, "host", paths),
            "torch": _port_session(root, "torch", paths)}


def test_generator_writes_the_jax_packages_bytes(lake):
    for name, path in lake["paths"].items():
        assert filecmp.cmp(os.path.join(path, "part-0.parquet"),
                           os.path.join(lake["jax_paths"][name],
                                        "part-0.parquet"), shallow=False)


@pytest.mark.parametrize("name", list(QUERIES))
def test_optimized_plan_equals_jax(lake, name):
    got, want = optimized_plan_texts(name, lake["host"], lake["jax"],
                                     QUERIES, JQUERIES, lake["root"])
    assert got == want


def _same(got: pd.DataFrame, want: pd.DataFrame, **tol):
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(normalize_result(got),
                                  normalize_result(want), check_dtype=False,
                                  check_exact=False, **tol)


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_query_equals_jax_and_oracle(lake, name, lane):
    sess, dfs = lake[lane]
    build, oracle = QUERIES[name]
    expected = oracle(lake["pandas"])
    assert len(expected) > 0, f"{name}: oracle returned no rows"
    jsess, jdfs = lake["jax"]
    jsess.enable_hyperspace()
    try:
        jax_on = JQUERIES[name][0](jdfs).to_pandas()
    finally:
        jsess.disable_hyperspace()

    sess.enable_hyperspace()
    try:
        frame = build(dfs)
        read = sorted({leaf.index_name for leaf in
                       sess.optimize(frame.plan).collect_leaves()
                       if leaf.index_name})
        table, metrics = frame.collect(with_metrics=True)
        got_on = table.to_pandas()
    finally:
        sess.disable_hyperspace()
    got_off = build(dfs).to_pandas()

    assert read == INDEXES_READ.get(name, [])
    if lane == "torch":
        host_ops = [o.name for o in metrics.operators
                    if o.name in ("Aggregate", "SortMergeJoin")
                    and o.detail.get("lane") == "host"]
        assert host_ops == []
    for got in (got_on, got_off):
        _same(got, jax_on, rtol=1e-9, atol=1e-12)
        _same(got, expected, rtol=1e-6, atol=1e-9)
