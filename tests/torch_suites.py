"""Helpers shared by the port's TPC-H and TPC-DS parity tests.

- `plan_text`: an optimized logical plan as text, every scalar subquery's
  optimized plan appended, with the warehouse and lake roots replaced by
  placeholders — so the port's plan and the JAX package's compare as
  strings.
- `tpcds_lake`: one seeded TPC-DS lake (scale 0.05, 8 buckets — the size
  of `tests/test_tpcds.py`) with the 13 indexes of `create_indexes` built
  by the JAX package and by two sessions of the port: its host lane (the
  default `min.device.rows`) and its torch lane (`min.device.rows = 0`
  and every index built on the device lane).
- `same`: the result comparison of `tests/test_tpcds.py` (rows sorted,
  numbers as float64); `same_rows`: Arrow tables equal row for row, bit
  for bit.
- `jax_counters_restored` and `jax_counters_guard`: the JAX package's
  registry (counters, gauges and histograms) restored around a block,
  and the autouse module fixture every `tests/test_torch_*.py` that
  runs the JAX package imports.
"""

import os
from contextlib import contextmanager

import pandas as pd
import pyarrow.parquet as pq
import pytest


def _metric_state(metric):
    """A restorable copy of one JAX registry metric's state."""
    from hyperspace_tpu.telemetry.registry import Histogram

    if isinstance(metric, Histogram):
        return ("histogram", dict(metric._buckets), metric.count,
                metric.sum, metric.min, metric.max)
    return ("value", metric._value)


def _restore_metric(metric, state) -> None:
    if state[0] == "histogram":
        _kind, buckets, count, total, low, high = state
        with metric._lock:
            metric._buckets = dict(buckets)
            metric.count, metric.sum = count, total
            metric.min, metric.max = low, high
    else:
        metric.set(state[1])


@contextmanager
def jax_counters_restored():
    """Leave the JAX package's registry as it was: counters, gauges and
    histograms. A port parity test runs JAX scenarios in the same worker
    process as the JAX package's own suites, which read that
    process-wide registry: `tests/test_tenancy.py` compares 6-decimal
    rounded deltas of `device.dispatch.seconds`, which an extra
    fractional part can tip; `tests/test_alerts.py`'s clean lap fires
    `breaker_open` on a first window whose `resilience.breaker.opened`
    is already above 0 (the sampler diffs a fresh ring against 0); and
    `tests/test_advisor.py`'s contention cases rank a skipping candidate
    first once the `skipping.measured_prune_fraction` histogram holds
    served skipping queries (the advisor scores with the measured mean
    instead of its conf assumption). Every metric the block moved goes
    back to its state before it, and a metric it created is removed
    (`tests/test_ops_server.py` holds every `compile.*.flops` counter
    present above 0)."""
    from hyperspace_tpu import telemetry

    reg = telemetry.get_registry()

    def metrics():
        with reg._lock:
            return dict(reg._metrics)

    before = {name: (m, _metric_state(m)) for name, m in metrics().items()}
    try:
        yield
    finally:
        for name, metric in metrics().items():
            if name not in before:
                with reg._lock:
                    reg._metrics.pop(name, None)
                continue
            original, state = before[name]
            if metric is not original:
                with reg._lock:
                    reg._metrics[name] = original
                metric = original
            if _metric_state(metric) != state:
                _restore_metric(metric, state)


@pytest.fixture(scope="module", autouse=True)
def jax_counters_guard():
    """`jax_counters_restored` around a whole test module. Module scope:
    it is set up before the module's other fixtures (which may build JAX
    lakes) and restores after the module's last test, so the JAX
    package's suites that share the worker find the registry as they
    left it."""
    with jax_counters_restored():
        yield


def same_rows(a, b, signed_zero=True):
    """Equal Arrow tables, row for row: the same column names, nulls in
    the same places, every value bit-equal (NaN included; -0.0 apart
    from 0.0 unless `signed_zero` is False)."""
    import numpy as np
    import pyarrow as pa

    assert a.schema.names == b.schema.names
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        assert x.type == y.type, name
        assert x.is_null().equals(y.is_null()), name
        if pa.types.is_floating(x.type):
            xs = x.fill_null(0).to_numpy()
            ys = y.fill_null(0).to_numpy()
            if not signed_zero:
                xs, ys = xs + 0.0, ys + 0.0  # -0.0 + 0.0 is 0.0
            np.testing.assert_array_equal(xs.view(np.int64),
                                          ys.view(np.int64), err_msg=name)
        else:
            assert x.to_pylist() == y.to_pylist(), name


TPCDS_SCALE = 0.05
BUCKETS = "8"


def plan_text(plan, scalar_subqueries, roots) -> str:
    """`plan.tree_string()` plus the tree of each scalar subquery's
    optimized plan, recursively; each `(path, placeholder)` of `roots`
    replaced."""
    text = plan.tree_string()
    for i, sub in enumerate(scalar_subqueries(plan)):
        text += (f"\n[scalar subquery {i}]\n"
                 + plan_text(sub.execution_plan(), scalar_subqueries, ()))
    for path, placeholder in roots:
        text = text.replace(path, placeholder)
    return text


def optimized_plan_texts(name, port, jax, queries, jqueries, root):
    """(port text, JAX text) of query `name`'s rules-on optimized plan.
    `port`/`jax` are (session, dfs) pairs whose warehouses are
    `<root>/<lane>` and `<root>/jax_wh`."""
    from hyperspace_tpu.engine.executor import _scalar_subqueries as jsubs

    from hyperspace_tpu_torch.engine.executor import (
        _scalar_subqueries as tsubs)

    (sess, dfs), (jsess, jdfs) = port, jax
    sess.enable_hyperspace()
    jsess.enable_hyperspace()
    try:
        got = sess.optimize(queries[name][0](dfs).plan)
        want = jsess.optimize(jqueries[name][0](jdfs).plan)
    finally:
        sess.disable_hyperspace()
        jsess.disable_hyperspace()
    return (plan_text(got, tsubs, [(os.path.join(root, "host"), "<WH>")]),
            plan_text(want, jsubs, [(os.path.join(root, "jax_wh"),
                                     "<WH>")]))


def _port_session(root, lane, paths):
    import hyperspace_tpu_torch as ths
    from hyperspace_tpu_torch.io import builder
    from hyperspace_tpu_torch.tpcds.queries import create_indexes

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


def tpcds_lake(root: str, jax_data: bool = False) -> dict:
    """The lake, its sessions and the pandas tables; `jax_data` also
    writes the JAX package's generator output beside the port's (for the
    byte comparison)."""
    import hyperspace_tpu as jhs
    from hyperspace_tpu.tpcds import generate as jgenerate
    from hyperspace_tpu.tpcds.queries import create_indexes as jcreate

    from hyperspace_tpu_torch.tpcds import generate

    paths = generate(os.path.join(root, "data"), scale=TPCDS_SCALE)
    jpaths = (jgenerate(os.path.join(root, "jax_data"), scale=TPCDS_SCALE)
              if jax_data else None)
    jsess = jhs.HyperspaceSession(jhs.HyperspaceConf({
        "hyperspace.warehouse.dir": os.path.join(root, "jax_wh"),
        "spark.hyperspace.index.num.buckets": BUCKETS}))
    jdfs = {name: jsess.read_parquet(path) for name, path in paths.items()}
    jcreate(jhs.Hyperspace(jsess), jdfs)
    pdfs = {name: pq.read_table(os.path.join(path, "part-0.parquet"))
            .to_pandas() for name, path in paths.items()}
    return {"root": root, "paths": paths, "jax_paths": jpaths,
            "jax": (jsess, jdfs), "pandas": pdfs,
            "host": _port_session(root, "host", paths),
            "torch": _port_session(root, "torch", paths),
            "jax_results": {}}


def norm(df: pd.DataFrame) -> pd.DataFrame:
    out = df.sort_values(list(df.columns)).reset_index(drop=True)
    return out.astype({c: "float64" for c in out.columns
                       if out[c].dtype.kind in "fi"})


def same(got: pd.DataFrame, want: pd.DataFrame, **tol) -> None:
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(norm(got), norm(want), check_dtype=False,
                                  check_exact=False, **tol)


# Operators that must not run on a host batch on the torch lane.
DEVICE_OPERATORS = ("Window", "Intersect", "Except", "Aggregate",
                    "SortMergeJoin")


def check_tpcds_query(lake, name, lane, queries, jqueries) -> None:
    """Query `name` through the port's `lane`, rules on and off, equals
    the pandas oracle and the JAX package's rules-on result; on the torch
    lane no Window, set operation, Aggregate or SortMergeJoin ran on a
    host batch."""
    sess, dfs = lake[lane]
    build, oracle = queries[name]
    expected = oracle(lake["pandas"])
    assert len(expected) > 0, f"{name}: oracle returned no rows"
    if name not in lake["jax_results"]:
        jsess, jdfs = lake["jax"]
        jsess.enable_hyperspace()
        try:
            lake["jax_results"][name] = jqueries[name][0](jdfs).to_pandas()
        finally:
            jsess.disable_hyperspace()
    jax_on = lake["jax_results"][name]

    sess.enable_hyperspace()
    try:
        table, metrics = build(dfs).collect(with_metrics=True)
        got_on = table.to_pandas()
    finally:
        sess.disable_hyperspace()
    got_off = build(dfs).to_pandas()

    if lane == "torch":
        host_ops = [o.name for o in metrics.operators
                    if o.name in DEVICE_OPERATORS
                    and o.detail.get("lane") == "host"]
        assert host_ops == []
    for got in (got_on, got_off):
        same(got, jax_on, rtol=1e-9, atol=1e-12)
        same(got, expected, rtol=1e-6)
