"""The port's SPMD join lane in the engine against the JAX package's, on
the CPU: a bucketed `SortMergeJoinExec` over born-sharded indexes through
the rules (`engine/physical.py`: `_try_spmd`, `_run_spmd` and the
`execute_sharded` hooks of Scan, Filter, Project and Exchange).

Both packages build the same indexes on 8 shards (the JAX package on the
conftest's 8 virtual CPU devices, the port on `virtual.ensure_devices(8)`,
reset after every test) over one seeded lake: a 16-bucket left index on an
int64 key with nulls and one on a string key, and right indexes at 16
buckets (warehouse "eq") and at 8 (warehouse "mm": the coarser right side
re-buckets between shards). For every join type the port's rows equal the
JAX package's and the rules-off rows, bit for bit after one canonical sort,
and the port's join ran the `spmd` lane with no `spmd.fallbacks`.
`distribution.spmd.enabled=false` runs the single-device join; a warm
repeat moves nothing over the link; right-only skew swaps sides for an
inner join and declines for an outer one.

One difference is by design: the JAX package's Exchange has no sharded
form, so its engine declines the lane for the mismatched pair and joins
on one device; the port re-buckets in the mesh. The rows are the same;
`test_engine_lane_and_counters_against_jax` states how the lanes and
counters differ.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from torch_suites import jax_counters_guard  # noqa: E402,F401

from hyperspace_tpu import telemetry as jax_telemetry
from hyperspace_tpu.config import HyperspaceConf as JConf
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.facade import Hyperspace as JHyperspace
from hyperspace_tpu.index.index_config import IndexConfig as JIndexConfig

torch.set_num_threads(1)

import hyperspace_tpu_torch as ths  # noqa: E402
from hyperspace_tpu_torch import telemetry  # noqa: E402
from hyperspace_tpu_torch.io import segcache  # noqa: E402
from hyperspace_tpu_torch.parallel import virtual  # noqa: E402


@pytest.fixture(autouse=True)
def _virtual_mesh():
    yield
    virtual.reset()


JOIN_TYPES = ("inner", "left_outer", "right_outer", "full_outer",
              "left_semi", "left_anti")


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """Two sources and, per package, born-sharded indexes built on 8
    shards: a 16-bucket left index on `key` and on `s`, and right
    indexes at 16 buckets (warehouse "eq") and at 8 (warehouse "mm")."""
    root = tmp_path_factory.mktemp("spmd_lake")
    rng = np.random.default_rng(23)
    n, m = 3000, 2000
    os.makedirs(root / "l")
    os.makedirs(root / "r")
    pq.write_table(pa.table({
        "key": pa.array(rng.integers(0, 500, n).astype(np.int64),
                        mask=rng.random(n) < 0.03),
        "id": np.arange(n, dtype=np.int64),
        "s": pa.array([None if i % 13 == 0 else f"v{int(x)}"
                       for i, x in enumerate(rng.integers(0, 300, n))])}),
        str(root / "l" / "p.parquet"))
    pq.write_table(pa.table({
        "key": rng.integers(0, 500, m).astype(np.int64),
        "val": rng.random(m),
        "s": pa.array([f"v{int(x)}" for x in rng.integers(0, 300, m)])}),
        str(root / "r" / "p.parquet"))
    virtual.ensure_devices(8, device="cpu")
    try:
        for pkg, Session, Conf, Hs, Config in (
                ("jax", JSession, JConf, JHyperspace, JIndexConfig),
                ("port", ths.HyperspaceSession, ths.HyperspaceConf,
                 ths.Hyperspace, ths.IndexConfig)):
            for wh, rbuckets in (("eq", 16), ("mm", 8)):
                sess, hs = _session(pkg, root, wh)
                left = sess.read_parquet(str(root / "l"))
                right = sess.read_parquet(str(root / "r"))
                hs.create_index(left, Config("lk", ["key"], ["id"]))
                if wh == "eq":
                    hs.create_index(left, Config("ls", ["s"], ["id"]))
                    hs.create_index(right, Config("rs", ["s"], ["val"]))
                sess.conf.set("spark.hyperspace.index.num.buckets",
                              str(rbuckets))
                hs.create_index(right, Config("rk", ["key"], ["val"]))
    finally:
        virtual.reset()
    return root


def _session(pkg, root, wh, **extra):
    settings = {"spark.hyperspace.warehouse.dir": str(root / pkg / wh),
                "spark.hyperspace.index.num.buckets": "16",
                "spark.hyperspace.execution.min.device.rows": "0",
                "spark.hyperspace.broadcast.threshold": "-1",
                "spark.hyperspace.distribution.enabled": "true", **extra}
    if pkg == "jax":
        sess = JSession(JConf(settings))
        return sess, JHyperspace(sess)
    sess = ths.HyperspaceSession(ths.HyperspaceConf(settings), device="cpu")
    return sess, ths.Hyperspace(sess)


def _query(sess, lake, how, key):
    left = sess.read_parquet(str(lake / "l"))
    right = sess.read_parquet(str(lake / "r"))
    if how in ("left_semi", "left_anti"):
        return (left.select(key, "id").join(right.select(key), on=key,
                                            how=how), [key, "id"])
    return (left.select(key, "id").join(right.select(key, "val"), on=key,
                                        how=how), ["id", "val"])


def _rows(frame, cols):
    table = (frame.to_pandas() if hasattr(frame, "to_pandas")
             else frame.collect().to_pandas())
    return table.sort_values(cols, na_position="first") \
        .reset_index(drop=True)


_COUNTERS = ("mesh.spmd.join_execs", "spmd.fallbacks",
             "mesh.spmd.repartition_execs")


def _engine_run(lake, wh, how, key, **extra):
    """Rules on, per package: the rows ("jax", "port"), the
    SortMergeJoin operators' lanes ("jax_lanes", "lanes") and the
    counter deltas ("jax_deltas", "deltas"); and the port's rules-off
    rows ("off")."""
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "port":
            virtual.ensure_devices(8, device="cpu")
            reg = telemetry.get_registry()
        else:
            reg = jax_telemetry.get_registry()
        tag = "" if pkg == "port" else "jax_"
        sess, _hs = _session(pkg, lake, wh, **extra)
        frame, cols = _query(sess, lake, how, key)
        sess.enable_hyperspace()
        c0 = {k: reg.counter(k).value for k in _COUNTERS}
        table, metrics = frame.collect(with_metrics=True)
        out[tag + "deltas"] = {k: reg.counter(k).value - c0[k]
                               for k in _COUNTERS}
        out[tag + "lanes"] = [o.detail.get("lane")
                              for o in metrics.operators
                              if o.name == "SortMergeJoin"]
        out[pkg] = table.to_pandas().sort_values(
            cols, na_position="first").reset_index(drop=True)
        if pkg == "port":
            sess.disable_hyperspace()
            out["off"] = _rows(frame, cols)
    return out


@pytest.mark.parametrize("wh", ["eq", "mm"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_engine_join_runs_the_spmd_lane(lake, wh, how):
    """Every join type over born-sharded indexes runs the SPMD lane with
    no fallback — a mismatched pair (16 against 8 buckets) too, its
    right side re-bucketed between shards — and gives the JAX package's
    rows and the rules-off rows."""
    got = _engine_run(lake, wh, how, "key")
    assert got["lanes"] == ["spmd"]
    assert got["deltas"]["mesh.spmd.join_execs"] == 1
    assert got["deltas"]["spmd.fallbacks"] == 0
    assert got["deltas"]["mesh.spmd.repartition_execs"] == (wh == "mm")
    pd.testing.assert_frame_equal(got["port"], got["off"],
                                  check_dtype=False)
    pd.testing.assert_frame_equal(got["port"], got["jax"],
                                  check_dtype=False)


@pytest.mark.parametrize("how", ["inner", "left_semi"])
@pytest.mark.parametrize("wh", ["eq", "mm"])
def test_engine_lane_and_counters_against_jax(lake, wh, how):
    """Where the two engines part, stated: a co-bucketed pair runs the
    SPMD lane in both, with the same counter deltas. For the mismatched
    pair the JAX engine declines (its Exchange has no sharded form: one
    `spmd.fallbacks`, reason right-not-shardable) and joins on one
    device, where the port re-buckets in the mesh and stays on the lane
    with no fallback. The rows are equal either way."""
    got = _engine_run(lake, wh, how, "key")
    assert got["lanes"] == ["spmd"]
    assert got["deltas"] == {"mesh.spmd.join_execs": 1,
                             "spmd.fallbacks": 0,
                             "mesh.spmd.repartition_execs": int(wh == "mm")}
    if wh == "eq":
        assert got["jax_lanes"] == got["lanes"]
        assert got["jax_deltas"] == got["deltas"]
    else:
        assert got["jax_lanes"] == ["device"]
        assert got["jax_deltas"] == {"mesh.spmd.join_execs": 0,
                                     "spmd.fallbacks": 1,
                                     "mesh.spmd.repartition_execs": 0}
    pd.testing.assert_frame_equal(got["port"], got["jax"],
                                  check_dtype=False)


@pytest.mark.parametrize("how", ["inner", "full_outer", "left_anti"])
def test_engine_string_join_runs_the_spmd_lane(lake, how):
    got = _engine_run(lake, "eq", how, "s")
    assert got["lanes"] == ["spmd"]
    assert got["deltas"]["spmd.fallbacks"] == 0
    pd.testing.assert_frame_equal(got["port"], got["off"],
                                  check_dtype=False)
    pd.testing.assert_frame_equal(got["port"], got["jax"],
                                  check_dtype=False)


def test_engine_warm_join_is_link_free(lake):
    """A warm repeat of the SPMD join reads every shard from the segment
    cache: no H2D chunk, segment hits advancing; string remap tables
    from the cache too."""
    virtual.ensure_devices(8, device="cpu")
    sess, _hs = _session("port", lake, "eq")
    sess.enable_hyperspace()
    segcache.clear()
    reg = telemetry.get_registry()
    names = ("link.h2d.chunks", "cache.segments.hits",
             "spmd.strings.remap_cache_hits")
    for key in ("key", "s"):
        frame, cols = _query(sess, lake, "inner", key)
        cold = _rows(frame, cols)
        c1 = {k: reg.counter(k).value for k in names}
        warm = _rows(frame, cols)
        c2 = {k: reg.counter(k).value for k in names}
        pd.testing.assert_frame_equal(cold, warm)
        assert c2["link.h2d.chunks"] == c1["link.h2d.chunks"]
        assert c2["cache.segments.hits"] > c1["cache.segments.hits"]
        if key == "s":
            assert c2["spmd.strings.remap_cache_hits"] > \
                c1["spmd.strings.remap_cache_hits"]


def test_spmd_disabled_runs_the_single_device_join(lake):
    got = _engine_run(lake, "mm", "inner", "key", **{
        "spark.hyperspace.distribution.spmd.enabled": "false"})
    assert got["deltas"]["mesh.spmd.join_execs"] == 0
    assert got["deltas"]["spmd.fallbacks"] == 0
    assert got["lanes"] == ["device"]
    pd.testing.assert_frame_equal(got["port"], got["jax"],
                                  check_dtype=False)


def test_engine_right_only_skew_swaps_sides(tmp_path):
    """Right-side-only skew: an inner join swaps roles and stays on the
    lane (`mesh.spmd.side_swapped`); a left_outer join over the same
    shape declines (`spmd.fallbacks`, reason subshard-right). Both equal
    the JAX package's rows and rules off."""
    rng = np.random.default_rng(19)
    os.makedirs(tmp_path / "left")
    os.makedirs(tmp_path / "right")
    pq.write_table(pa.table({"k": rng.integers(0, 4096, 2000)
                             .astype(np.int64), "v": rng.random(2000)}),
                   str(tmp_path / "left" / "part-0.parquet"))
    n = 24_000
    pq.write_table(pa.table({"k": np.where(
        rng.random(n) < 0.9, 7, rng.integers(0, 4096, n)).astype(np.int64),
        "w": rng.random(n)}), str(tmp_path / "right" / "part-0.parquet"))
    reg = telemetry.get_registry()
    rows = {}
    for pkg, Config in (("jax", JIndexConfig), ("port", ths.IndexConfig)):
        virtual.ensure_devices(8, device="cpu")
        sess, hs = _session(pkg, tmp_path, "w", **{
            "spark.hyperspace.index.num.buckets": "8"})
        left = sess.read_parquet(str(tmp_path / "left"))
        right = sess.read_parquet(str(tmp_path / "right"))
        hs.create_index(left, Config("swl", ["k"], ["v"]))
        hs.create_index(right, Config("swr", ["k"], ["w"]))
        for how in ("inner", "left_outer"):
            q = left.join(right, on="k", how=how)
            sess.enable_hyperspace()
            c0 = {k: reg.counter(k).value for k in (
                "mesh.spmd.side_swapped", "spmd.fallbacks")}
            got = _rows(q, ["k", "v", "w"])
            c1 = {k: reg.counter(k).value for k in c0}
            sess.disable_hyperspace()
            pd.testing.assert_frame_equal(got, _rows(q, ["k", "v", "w"]))
            rows[(pkg, how)] = got
            if pkg == "port":
                swapped = c1["mesh.spmd.side_swapped"] - \
                    c0["mesh.spmd.side_swapped"]
                fell = c1["spmd.fallbacks"] - c0["spmd.fallbacks"]
                assert (swapped, fell) == ((1, 0) if how == "inner"
                                           else (0, 1))
    for how in ("inner", "left_outer"):
        pd.testing.assert_frame_equal(rows[("port", how)],
                                      rows[("jax", how)], check_dtype=False)


def test_engine_skewed_exchange_side_declines_before_reading(tmp_path,
                                                             monkeypatch):
    """A mismatched pair whose coarser, re-bucketed side is hot-bucket
    skewed leaves the lane from its footer lengths: one `spmd.fallbacks`
    (right-not-shardable, as the JAX engine declines every mismatched
    pair), no sub-shard read and no sharded read of that side. The rows
    equal the JAX package's and rules off."""
    rng = np.random.default_rng(29)
    os.makedirs(tmp_path / "left")
    os.makedirs(tmp_path / "right")
    pq.write_table(pa.table({"k": rng.integers(0, 4096, 2000)
                             .astype(np.int64), "v": rng.random(2000)}),
                   str(tmp_path / "left" / "part-0.parquet"))
    n = 24_000
    pq.write_table(pa.table({"k": np.where(
        rng.random(n) < 0.9, 7, rng.integers(0, 4096, n)).astype(np.int64),
        "w": rng.random(n)}), str(tmp_path / "right" / "part-0.parquet"))
    from hyperspace_tpu_torch.parallel import spmd as tspmd
    read_columns = []

    def read_sharded(per_shard_files, lengths, columns, *args, **kw):
        read_columns.append(tuple(columns))
        return real_read(per_shard_files, lengths, columns, *args, **kw)

    real_read = tspmd.read_sharded
    monkeypatch.setattr(tspmd, "read_sharded", read_sharded)
    reg = telemetry.get_registry()
    names = ("spmd.fallbacks", "mesh.spmd.subshard_reads",
             "mesh.spmd.join_execs")
    rows = {}
    for pkg, Config in (("jax", JIndexConfig), ("port", ths.IndexConfig)):
        virtual.ensure_devices(8, device="cpu")
        sess, hs = _session(pkg, tmp_path, "x", **{
            "spark.hyperspace.index.num.buckets": "8"})
        left = sess.read_parquet(str(tmp_path / "left"))
        right = sess.read_parquet(str(tmp_path / "right"))
        hs.create_index(left, Config("xl", ["k"], ["v"]))
        sess.conf.set("spark.hyperspace.index.num.buckets", "4")
        hs.create_index(right, Config("xr", ["k"], ["w"]))
        q = left.join(right, on="k", how="inner")
        sess.enable_hyperspace()
        c0 = {k: reg.counter(k).value for k in names}
        rows[pkg] = _rows(q, ["k", "v", "w"])
        c1 = {k: reg.counter(k).value for k in names}
        sess.disable_hyperspace()
        pd.testing.assert_frame_equal(rows[pkg], _rows(q, ["k", "v", "w"]))
        if pkg == "port":
            delta = {k: c1[k] - c0[k] for k in names}
            assert delta == {"spmd.fallbacks": 1,
                             "mesh.spmd.subshard_reads": 0,
                             "mesh.spmd.join_execs": 0}
            # The left side is the only sharded read.
            assert [c for c in read_columns if "w" in c] == []
            assert any("v" in c for c in read_columns)
    pd.testing.assert_frame_equal(rows["port"], rows["jax"],
                                  check_dtype=False)


# -- read replicas: routing through the scheduler ------------------------------

SLICES = {"spark.hyperspace.distribution.slices": "2"}


@pytest.fixture
def routers():
    """Both packages' replica routers and schedulers fresh, before and
    after: the router is process state, like the virtual mesh."""
    from hyperspace_tpu.engine import scheduler as jsched
    from hyperspace_tpu.parallel import replica as jreplica

    from hyperspace_tpu_torch.engine import scheduler as tsched
    from hyperspace_tpu_torch.parallel import replica as treplica

    def fresh():
        jreplica.reset_router()
        treplica.reset_router()
        jsched.set_scheduler(jsched.QueryScheduler())
        tsched.set_scheduler(tsched.QueryScheduler())

    fresh()
    yield {"jax": jreplica, "port": treplica}
    fresh()


def _gauges(reg, n=2):
    return [reg.gauge(f"serve.replica.{i}.admitted_bytes").value
            for i in range(n)]


@pytest.mark.parametrize("wh", ["eq", "mm"])
def test_engine_multislice_replica_routing(lake, routers, wh):
    """On a 2-slice topology the scheduler routes every collect to a
    replica slice (`serve.replica.<i>.routed`, `metrics.replica`, the
    per-replica admitted-byte gauges), the join runs on the routed
    slice's 4-shard submesh (re-bucketing there for the mismatched
    pair), and 4 concurrent clients get the rules-off rows and the JAX
    package's, bit for bit."""
    import threading

    got = {}
    for pkg in ("jax", "port"):
        if pkg == "port":
            virtual.ensure_devices(8, device="cpu")
        reg = (telemetry if pkg == "port" else jax_telemetry).get_registry()
        sess, _hs = _session(pkg, lake, wh, **SLICES)
        frame, cols = _query(sess, lake, "inner", "key")
        sess.disable_hyperspace()
        off = _rows(frame, cols)
        sess.enable_hyperspace()
        names = [f"serve.replica.{i}.routed" for i in (0, 1)]
        c0 = [reg.counter(k).value for k in names]
        r0 = reg.counter("mesh.spmd.repartition_execs").value
        results, metrics, errors = [], [], []

        def client():
            try:
                table, m = frame.collect(with_metrics=True)
                results.append(table.to_pandas().sort_values(
                    cols, na_position="first").reset_index(drop=True))
                metrics.append(m)
            except Exception as exc:  # pragma: no cover - fail loudly
                errors.append(exc)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        routed = [reg.counter(k).value - c for k, c in zip(names, c0)]
        assert sum(routed) == 4, (pkg, routed)
        assert all(m.replica in (0, 1) for m in metrics)
        assert sorted(m.replica for m in metrics) == sorted(
            sum(([i] * int(r) for i, r in enumerate(routed)), []))
        assert _gauges(reg) == [0, 0]
        for frame_ in results:
            pd.testing.assert_frame_equal(frame_, off, check_dtype=False)
        got[pkg] = (results[0], metrics)
        if pkg == "port":
            # The mismatched pair re-buckets on the routed slice, once
            # per collect.
            assert reg.counter("mesh.spmd.repartition_execs").value \
                - r0 == (4 if wh == "mm" else 0)
    pd.testing.assert_frame_equal(got["port"][0], got["jax"][0],
                                  check_dtype=False)
    for m in got["port"][1]:
        assert m.to_dict()["replica"] == m.replica
        assert [e["replica"] for e in m.events_of("serve", "replica")] == [
            m.replica]
        joins = m.events_of("mesh", "join")
        assert [e["shards"] for e in joins] == [4]
        assert [o.detail.get("lane") for o in m.operators
                if o.name == "SortMergeJoin"] == ["spmd"]


def _bucket_of(value, buckets=16):
    from hyperspace_tpu_torch.ops.host_hash import host_bucket_ids

    return int(host_bucket_ids([np.asarray([value], dtype=np.int64)],
                               ["int64"], buckets)[0])


def test_router_equals_jax_router(lake, routers):
    """Both packages run the same point filters, so their flight rings
    hold the same Scan `bucket_ids`; then `hot_buckets`, `_plan_buckets`,
    `_cold_pin` and `route` agree for hot, cold, unclassified and
    range-straddling hints, and with fewer slices than `min.slices`."""
    from hyperspace_tpu.engine.scheduler import QueryScheduler as JSched
    from hyperspace_tpu.telemetry import flight as jflight

    from hyperspace_tpu_torch.engine.scheduler import QueryScheduler
    from hyperspace_tpu_torch.telemetry import flight as tflight

    by_bucket = {}
    for v in range(500):
        by_bucket.setdefault(_bucket_of(v), v)
    lo = [b for b in sorted(by_bucket) if b < 8]
    hi = [b for b in sorted(by_bucket) if b >= 8]
    hot_a, hot_b, warm = lo[0], lo[1], hi[0]
    cold_lo, cold_hi = lo[-1], hi[-1]
    reads = [hot_a] * 4 + [hot_b] * 3 + [warm]
    virtual.ensure_devices(8, device="cpu")
    answers = {}
    for pkg in ("jax", "port"):
        (jflight if pkg == "jax" else tflight).get_recorder().clear()
        routers[pkg].reset_router()
        sess, _hs = _session(pkg, lake, "eq", **SLICES)
        sess.enable_hyperspace()
        col = ths.col if pkg == "port" else _jcol
        left = sess.read_parquet(str(lake / "l"))

        def point(*buckets):
            values = [by_bucket[b] for b in buckets]
            cond = (col("key") == values[0] if len(values) == 1
                    else col("key").isin(*values))
            return left.filter(cond).select("key", "id")

        for b in reads:
            point(b).collect()
        # A fresh mine, the same way on both sides: a new router reads
        # the whole ring from sequence 0.
        routers[pkg].reset_router()
        router = routers[pkg].get_router()
        sched = JSched() if pkg == "jax" else QueryScheduler()
        plans = {"hot": point(hot_a), "cold_lo": point(cold_lo),
                 "cold_hi": point(cold_hi),
                 "straddle": point(cold_lo, cold_hi),
                 "cold_pair": point(cold_lo, lo[-2]),
                 "unclassified": left.select("key", "id")}
        out = {}
        for name, df in plans.items():
            plan = sess.optimize(df.plan)
            hints = routers[pkg]._plan_buckets(plan)
            out[name] = {
                "hints": (None if hints is None else
                          sorted((sorted(ids), nb)
                                 for ids, nb in hints.values())),
                "pin": router._cold_pin(hints, sess.conf, 2),
                "route": router.route(plan, sess.conf, sched)}
            if hints:
                root, = hints
                out[name]["hot"] = sorted(router.hot_buckets(root, 0.5))
        out["routed"] = router.routed_counts()
        few = _session(pkg, lake, "eq", **dict(SLICES, **{
            "spark.hyperspace.distribution.replication.min.slices":
                "4"}))[0]
        out["few_slices"] = router.route(plans["hot"].plan, few.conf, sched)
        off = _session(pkg, lake, "eq", **dict(SLICES, **{
            "spark.hyperspace.distribution.replication.enabled":
                "false"}))[0]
        out["replication_off"] = router.route(plans["hot"].plan, off.conf,
                                              sched)
        answers[pkg] = out
    assert answers["port"] == answers["jax"]
    got = answers["port"]
    assert got["hot"]["hot"] == sorted({hot_a, hot_b})
    assert got["hot"]["pin"] is None
    assert got["cold_lo"]["pin"] == got["cold_lo"]["route"] == 0
    assert got["cold_hi"]["pin"] == got["cold_hi"]["route"] == 1
    assert got["cold_pair"]["pin"] == 0
    assert got["straddle"]["pin"] is None
    assert got["unclassified"]["hints"] is None
    assert got["few_slices"] is None and got["replication_off"] is None


def _jcol(name):
    from hyperspace_tpu.plan.expr import col
    return col(name)


def test_per_replica_admission_equals_jax(lake, routers, monkeypatch):
    """An idle replica always admits; a busy one refuses past
    `budget // n_replicas`; the `serve.replica.<i>.admitted_bytes`
    gauges follow every grant and release back to 0 — in both
    packages alike — and a query cancelled after its admission leaves
    every gauge at 0."""
    from hyperspace_tpu.engine import scheduler as jsched
    from hyperspace_tpu.exceptions import QueryCancelledError as JCancel
    from hyperspace_tpu.utils import faults as jfaults

    from hyperspace_tpu_torch.engine import scheduler as tsched
    from hyperspace_tpu_torch.exceptions import QueryCancelledError
    from hyperspace_tpu_torch.utils import faults as tfaults

    budget = 1000
    # budget // 2 = 500 a replica. e3 and e5 fit the whole budget but
    # not their replica's share; after the release, f2 finds replica 1
    # idle and admits past its share.
    steps = [("e1", 0, 400), ("e2", 1, 300), ("e3", 0, 200),
             ("e4", 0, 100), ("e5", 1, 250), ("e6", 1, 200), None,
             ("f1", 0, 100), ("f2", 1, 800), None]
    trail = {}
    for pkg, mod, tel in (("jax", jsched, jax_telemetry),
                          ("port", tsched, telemetry)):
        sched = mod.QueryScheduler()
        monkeypatch.setattr(sched, "_live_device_bytes", lambda: 0)
        reg = tel.get_registry()
        ents, log = {}, []
        for step in steps:
            if step is None:
                for qid in sorted(ents):
                    sched._release(ents.pop(qid))
                    log.append((qid, "released", _gauges(reg),
                                sched.replica_inflight()))
                continue
            qid, rep, size = step
            ent = mod._QueryEntry(qid, mod.Deadline(qid, None), size, None)
            ent.replica, ent.n_replicas = rep, 2
            with sched._cv:
                fits = sched._fits(ent, budget)
                if fits:
                    sched._grant(ent, reg)
                    ents[qid] = ent
            log.append((qid, fits, _gauges(reg),
                        sched.replica_inflight()))
        trail[pkg] = log
    assert trail["port"] == trail["jax"]
    decisions = [(q, f) for q, f, *_ in trail["port"] if f != "released"]
    assert decisions == [("e1", True), ("e2", True), ("e3", False),
                         ("e4", True), ("e5", False), ("e6", True),
                         ("f1", True), ("f2", True)]
    assert trail["port"][5][2] == [500, 500]
    assert trail["port"][-1][2:] == ([0, 0], {})

    # Cancelled after admission, in the collect itself.
    virtual.ensure_devices(8, device="cpu")
    for pkg, mod, tel, faults, cancelled in (
            ("jax", jsched, jax_telemetry, jfaults, JCancel),
            ("port", tsched, telemetry, tfaults, QueryCancelledError)):
        sess, _hs = _session(pkg, lake, "eq", **SLICES)
        sess.enable_hyperspace()
        frame, _cols = _query(sess, lake, "inner", "key")
        sched = mod.get_scheduler()
        real_fire = faults.fire

        def fire(op, *args, _sched=sched, _real=real_fire, **kw):
            if op == "scheduler.run":
                seen = _sched.replica_inflight()
                assert sum(seen.values()) == 1, seen
                for qid in _sched.active_queries():
                    _sched.cancel(qid)
            return _real(op, *args, **kw)

        monkeypatch.setattr(faults, "fire", fire)
        with pytest.raises(cancelled):
            frame.collect()
        monkeypatch.setattr(faults, "fire", real_fire)
        reg = tel.get_registry()
        assert _gauges(reg) == [0, 0]
        assert sched.replica_inflight() == {}
        assert sched.replica_admitted_bytes() == {}
