"""The port's born-sharded SPMD execution (`parallel/spmd.py`) against the
JAX package's, on the CPU: the join, the re-bucket, the skew plans, the
segment cache's keyed fill and the stage-to-stage pipeline (strings,
filters, aggregates and LIKE: `test_torch_spmd_strings.py`; the engine's
lane: `test_torch_spmd_engine.py`).

The JAX side runs on the conftest's 8 virtual CPU devices (`make_mesh(n)`
and `make_mesh(n, dcn_size=d)`); the port side on n virtual CPU shards
(`parallel.virtual.ensure_devices(n)`), reset after every test. The same
seeded tables go through both packages' mesh build and born-sharded
placement (`tests/torch_spmd.py`), then through each function: the
sharded join (inner, left_outer, full_outer) and the semi and anti joins
at 1, 2, 4 and 8 shards, flat and (dcn, shard), co-bucketed and with the
right side at another bucket count (the in-mesh re-bucket); the skewed
joins; `repartition_sharded` and the warm two-stage pipeline.

Every result equals pandas; where a case also runs the JAX package (every
function at least once; the rest port-only, since the JAX package's own
suite holds it to pandas there) the two packages' rows are equal.
Tolerances: keys, ids and float64 payload values compared exactly (as
their shortest round-trip text, so bit for bit); float64 aggregates
within rtol 1e-9. Rows are compared after one canonical sort: neither
package promises an order for the SPMD lane.
"""

import os
import sys
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch
from torch_suites import jax_counters_guard  # noqa: E402,F401
from torch_spmd import (AGG_RTOL, BOTH, CPU, SPMD, agg_specs,
                        born_sharded_files, built, check_joins, counter,
                        frame_of, meshes, numeric_table, oracle, pairs)

from hyperspace_tpu import telemetry as jax_telemetry
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.io import parquet as jparquet
from hyperspace_tpu.ops.bucketed_join import \
    assemble_join_output as jassemble
from hyperspace_tpu.parallel import spmd as jspmd

torch.set_num_threads(1)

from hyperspace_tpu_torch import telemetry  # noqa: E402
from hyperspace_tpu_torch.io import columnar as tcol  # noqa: E402
from hyperspace_tpu_torch.io import parquet as tparquet  # noqa: E402
from hyperspace_tpu_torch.io import segcache  # noqa: E402
from hyperspace_tpu_torch.ops.bucketed_join import \
    assemble_join_output as tassemble  # noqa: E402
from hyperspace_tpu_torch.parallel import spmd as tspmd  # noqa: E402
from hyperspace_tpu_torch.parallel import virtual  # noqa: E402


@pytest.fixture(autouse=True)
def _virtual_mesh():
    yield
    virtual.reset()


# -- the join, co-bucketed and re-bucketed ------------------------------------

@pytest.mark.parametrize("n_dev,pkgs", [(1, ("port",)), (2, ("port",)),
                                        (4, ("port",)), (8, BOTH)])
def test_join_bit_identity_across_device_counts(n_dev, pkgs):
    """Every join equals pandas at every shard count (and the JAX
    package's at 8, its own suite holding it to pandas at the rest)."""
    jm, tm = meshes(n_dev)
    lt, rt = numeric_table(1200, 1), numeric_table(500, 2)
    left, right = built(lt, 16, jm, tm, pkgs), built(rt, 16, jm, tm, pkgs)
    before = counter("mesh.spmd.join_execs")
    check_joins(lt, rt, left, right)
    assert counter("mesh.spmd.join_execs") == before + 5


@pytest.mark.parametrize("slices,ici,pkgs", [(2, 4, BOTH),
                                             (4, 2, ("port",))])
def test_multislice_join_bit_identity(slices, ici, pkgs):
    jm, tm = meshes(slices * ici, slices)
    lt, rt = numeric_table(1200, 1), numeric_table(500, 2)
    check_joins(lt, rt, built(lt, 16, jm, tm, pkgs),
                built(rt, 16, jm, tm, pkgs))


@pytest.mark.parametrize("n_dev,slices,pkgs", [
    (8, 1, BOTH), (4, 1, ("port",)), (8, 2, BOTH), (8, 4, ("port",))])
def test_mismatched_bucket_counts_rebucket_in_the_mesh(n_dev, slices, pkgs,
                                                        monkeypatch):
    """The right side at HALF the bucket count re-buckets between shards
    through the hash wrapper (its plain version here), once per shard;
    every join equals pandas and the JAX package's; on a 2-axis mesh
    the exchange bytes split between ICI and DCN, each row crossing DCN
    at most once."""
    from hyperspace_tpu_torch.ops.cuda import hash_kernel

    jm, tm = meshes(n_dev, slices if slices > 1 else None)
    lt, rt = numeric_table(900, 3), numeric_table(400, 4)
    left, right = built(lt, 16, jm, tm, pkgs), built(rt, 8, jm, tm, pkgs)
    calls = []
    real = hash_kernel.hash_lanes_to_buckets

    def spy(lanes, num_buckets):
        calls.append((tuple(lanes.shape), num_buckets))
        return real(lanes, num_buckets)

    monkeypatch.setattr(hash_kernel, "hash_lanes_to_buckets", spy)
    reg = telemetry.get_registry()
    links = ("spmd.repartition.ici.bytes", "spmd.repartition.dcn.bytes")
    before = {k: reg.counter(k).value for k in links}
    check_joins(lt, rt, left, right, hows=("inner",))
    moved = {k: reg.counter(k).value - before[k] for k in links}
    # One inner join and two membership joins, each one call per shard.
    assert calls == [((2, right["port"][0].rows_per_shard), 16)] \
        * (3 * n_dev)
    assert moved[links[0]] > 0
    if slices > 1:
        assert moved[links[1]] > 0
        assert moved[links[1]] / (moved[links[0]] + moved[links[1]]) <= 0.6
    else:
        assert moved[links[1]] == 0
    port = {"port": left["port"]}
    check_joins(lt, rt, port, right, hows=("left_outer", "full_outer"),
                anti=())


def test_skewed_join_is_exact_without_a_retry():
    """A hot key whose expansion blows past the JAX first-attempt
    capacity (factor 0.01): the JAX package retries at doubled capacity;
    the port sizes each shard exactly and has no capacity to give. Both
    equal pandas."""
    jm, tm = meshes(4)
    n = 2000
    rng = np.random.default_rng(9)
    lt = pa.table({"k": np.where(rng.random(n) < 0.7, 7,
                                 rng.integers(0, 64, n)).astype(np.int64),
                   "v": rng.random(n)})
    rt = pa.table({"k": np.where(rng.random(300) < 0.5, 7,
                                 rng.integers(0, 64, 300)).astype(np.int64),
                   "v": rng.random(300)})
    left, right = built(lt, 16, jm, tm), built(rt, 16, jm, tm)
    jspmd._CAP_MEMO.clear()
    want = oracle(lt, rt, "inner")
    jreg = jax_telemetry.get_registry()
    retries = jreg.counter("mesh.spmd.overflow_retries").value
    for pkg in ("jax", "port"):
        lsh, rsh = left[pkg][0], right[pkg][0]
        extra = {"capacity_factor": 0.01} if pkg == "jax" else {}
        li, ri = SPMD[pkg].sharded_join_indices(lsh, rsh, ["k"], ["k"],
                                                **extra)
        pd.testing.assert_frame_equal(pairs(lsh.batch, rsh.batch, li, ri),
                                      want, obj=pkg)
    jspmd._CAP_MEMO.clear()
    assert jreg.counter("mesh.spmd.overflow_retries").value > retries


def test_pad_blowup_guard_and_subshard_plan_equal_jax():
    lengths = np.zeros(16, dtype=np.int64)
    lengths[3] = 1 << 17
    lengths[4:] = 1
    even = np.full(16, 1 << 13, dtype=np.int64)
    for case in (lengths, even):
        assert tspmd.pad_blowup(case, 8) == jspmd.pad_blowup(case, 8)
    assert tspmd.pad_blowup(lengths, 8) and not tspmd.pad_blowup(even, 8)
    schema = pa.schema([("k", pa.int64()), ("s", pa.string()),
                        ("v", pa.float64())])
    assert tspmd.supports_sharded(tcol.from_arrow(
        schema.empty_table()).schema) is jspmd.supports_sharded(
        jcol.from_arrow(schema.empty_table()).schema) is True
    skewed = np.asarray([3, 0, 120, 5, 2, 0, 7, 1], dtype=np.int64)
    for hist in (skewed, lengths, even):
        for n in (2, 4, 8):
            t, j = tspmd.subshard_plan(hist, n), jspmd.subshard_plan(hist, n)
            assert (t.num_buckets, t.n_shards, t.segments,
                    t.bucket_spans) == (j.num_buckets, j.n_shards,
                                        j.segments, j.bucket_spans)
    plan = tspmd.subshard_plan(skewed, 4)
    cum = np.concatenate([[0], np.cumsum(skewed)])
    assert plan.segments[0][0] == 0 and plan.segments[-1][1] == cum[-1]
    for (lo, hi), (b_lo, b_hi) in zip(plan.segments, plan.bucket_spans):
        for row in range(lo, hi):
            b = int(np.searchsorted(cum, row, side="right")) - 1
            assert b_lo <= b < b_hi


def test_skewed_key_subshard_join_equals_jax(tmp_path):
    """A hot key holding most rows trips `pad_blowup`: the skewed side
    reads as row-balanced virtual sub-shards (`plan_skew_read`), the
    other side aligned (`plan_aligned_read`); inner, left_outer, semi
    and anti equal pandas and the JAX package's."""
    jm, tm = meshes(8)
    rng = np.random.default_rng(11)
    n = 24_000
    lt = pa.table({"k": np.where(rng.random(n) < 0.9, 7,
                                 rng.integers(0, 4096, n)).astype(np.int64),
                   "v": rng.random(n)})
    rt = pa.table({"k": np.concatenate([np.full(3, 7), rng.integers(
        0, 4096, 300)]).astype(np.int64), "v": rng.random(303)})
    ldata = born_sharded_files(tmp_path, "l", lt, 16, jm, tm)
    rdata = born_sharded_files(tmp_path, "r", rt, 16, jm, tm)
    sides, plans = {}, {}
    for pkg, parquet, mesh in (("jax", jparquet, jm),
                               ("port", tparquet, tm)):
        spmd = SPMD[pkg]
        l_root, l_lengths, l_built = ldata[pkg]
        r_root, r_lengths, r_built = rdata[pkg]
        assert spmd.pad_blowup(l_lengths, 8)
        plan, l_specs = spmd.plan_skew_read(parquet.bucket_files(l_root),
                                            l_lengths, 8)
        r_specs = spmd.plan_aligned_read(parquet.bucket_files(r_root),
                                         r_lengths, plan)
        cols = [f.name for f in l_built.schema.fields]
        lsh = spmd.read_sharded([], l_lengths, cols, l_built.schema, mesh,
                                shard_specs=l_specs, split_plan=plan)
        rsh = spmd.read_sharded([], r_lengths, cols, r_built.schema, mesh,
                                shard_specs=r_specs)
        assert lsh.split_plan is plan
        assert lsh.rows_per_shard * 8 <= 2 * n
        sides[pkg] = ((lsh, None), (rsh, None))
        plans[pkg] = (plan.segments, plan.bucket_spans, [
            ([os.path.basename(f) for f in files], skip, rows)
            for files, skip, rows in l_specs + r_specs])
    assert plans["port"] == plans["jax"]
    assert sides["port"][0][0].rows_per_shard == \
        sides["jax"][0][0].rows_per_shard
    check_joins(lt, rt, {p: s[0] for p, s in sides.items()},
                {p: s[1] for p, s in sides.items()},
                hows=("inner", "left_outer"))


def test_segcache_get_or_fill_single_flight_and_invalidation():
    """Per-range entries ride the index-FSM hooks: a commit of a new
    version under the root drops them. Under a shortened switch interval
    16 threads asking for one key run ONE fill and all get its payload;
    a generic payload never demotes to the host tier."""
    cache = segcache.SegmentCache(budget_bytes=1 << 30)
    ref = segcache.SegmentRef("idx", "/tmp/idx_root", 0, "mc")
    fills = []
    gate = threading.Event()

    def fill():
        fills.append(1)
        gate.wait(5)
        return {"columns": {}, "rows": 1}, 1024

    key = ref.key + (("spmd", 0, 4, 4, 10),)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(cache.get_or_fill(key, fill, ref=ref)))
        for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(fills) == 1, "single-flight violated"
    assert len(results) == 16 and all(r is results[0] for r in results)
    assert cache.get_or_fill(key, fill, ref=ref) is results[0]
    assert len(fills) == 1
    cache.invalidate_index("/tmp/idx_root", keep_version=1)
    cache.get_or_fill(key, fill, ref=ref)
    assert len(fills) == 2
    # Evicting a generic payload drops it (no host copy to promote).
    small = segcache.SegmentCache(budget_bytes=1500, host_budget_bytes=1 << 20)
    small.get_or_fill(("a",), fill)
    small.get_or_fill(("b",), fill)
    snap = small.snapshot()
    assert snap["entries"] == 1 and snap["host_entries"] == 0


# -- repartition and the stage-to-stage pipeline -----------------------------

@pytest.mark.parametrize("slices", [1, 2])
def test_repartition_sharded_routes_all_rows(slices):
    """Every row survives the re-bucket and lands on its bucket's owner;
    a join over the re-bucketed layout equals the JAX package's."""
    from hyperspace_tpu_torch.ops.hash_partition import bucket_ids

    jm, tm = meshes(8, slices if slices > 1 else None)
    table = numeric_table(1000, 31)
    rt = numeric_table(500, 32)
    right = built(rt, 16, jm, tm)
    results = {}
    for pkg, col, kw in (("jax", jcol, {}), ("port", tcol, {"device": CPU})):
        batch = col.from_arrow(table, **kw)
        mesh = jm if pkg == "jax" else tm
        sh = SPMD[pkg].repartition_sharded(batch, ["k"], 16, mesh)
        assert sh.num_rows == 1000 and sh.lengths is None
        li, ri = SPMD[pkg].sharded_join_indices(sh, right[pkg][0], ["k"],
                                                ["k"])
        results[pkg] = pairs(sh.batch, right[pkg][0].batch, li, ri)
        if pkg == "port":
            for s, (shard, valid) in enumerate(zip(sh.shards, sh.row_valid)):
                ids = bucket_ids(shard, ["k"], 16)[valid]
                assert (ids.to(torch.int64) * 8 // 16 == s).all()
    pd.testing.assert_frame_equal(results["port"], results["jax"])
    pd.testing.assert_frame_equal(results["port"], oracle(table, rt,
                                                          "inner"))


def test_warm_two_stage_join_has_no_d2h_between_stages():
    """join -> re-bucket -> join -> re-bucket stays on the devices: a
    warm run records no D2H transfer until the aggregate, whose partial
    tables are the result's materialization (the port fetches them
    through the transfer engine); the result equals the JAX package's."""
    jm, tm = meshes(8)
    lt, rt = numeric_table(1500, 21), numeric_table(700, 22)
    left, right = built(lt, 16, jm, tm), built(rt, 16, jm, tm)

    def stages(pkg):
        spmd, assemble = SPMD[pkg], (jassemble if pkg == "jax"
                                     else tassemble)
        mesh = jm if pkg == "jax" else tm
        lsh, rsh = left[pkg][0], right[pkg][0]
        li, ri = spmd.sharded_join_indices(lsh, rsh, ["k"], ["k"])
        joined = assemble(lsh.batch, rsh.batch, li, ri, how="inner")
        stage2 = spmd.repartition_sharded(joined, ["k"], 16, mesh)
        li2, ri2 = spmd.sharded_join_indices(stage2, rsh, ["k"], ["k"])
        j2 = assemble(stage2.batch, rsh.batch, li2, ri2, how="inner",
                      columns=["k", "v", "v_r"])
        return spmd.repartition_sharded(j2, ["k"], 16, mesh)

    def aggregate(pkg, stage3):
        specs, out_schema = agg_specs(pkg, lt)
        return frame_of(SPMD[pkg].sharded_group_aggregate(
            stage3, ["k"], specs[:2], out_schema.select(
                ["k", "cnt", "sv"])), ["k"])

    cold = aggregate("port", stages("port"))
    reg = telemetry.get_registry()
    before = {k: reg.counter(k).value for k in ("link.d2h.chunks",
                                                "link.d2h.bytes")}
    stage3 = stages("port")
    assert {k: reg.counter(k).value for k in before} == before, \
        "a stage crossed D2H"
    warm = aggregate("port", stage3)
    pd.testing.assert_frame_equal(cold, warm)
    pd.testing.assert_frame_equal(warm, aggregate("jax", stages("jax")),
                                  check_dtype=False, check_exact=False,
                                  rtol=AGG_RTOL)


# -- read replicas: slice submeshes, residency, routing under chaos ----------


def _slice_reads(pkg, files, mesh, slice_idx, version=0):
    """Both sides of `files` ({tag: {package: (root, lengths, built)}})
    read born-sharded onto slice `slice_idx`'s submesh of `mesh` through
    that package's segment cache."""
    if pkg == "jax":
        from hyperspace_tpu.io import segcache as cache_mod
        from hyperspace_tpu.parallel.mesh import bucket_ranges, slice_submesh
        parquet = jparquet
    else:
        from hyperspace_tpu_torch.io import segcache as cache_mod
        from hyperspace_tpu_torch.parallel.mesh import (bucket_ranges,
                                                        slice_submesh)
        parquet = tparquet
    sub = slice_submesh(mesh, slice_idx)
    out = []
    for tag, per_pkg in files.items():
        root, lengths, b = per_pkg[pkg]
        per_bucket = parquet.bucket_files(root)
        per_shard = [[f for bk in range(lo, hi)
                      for f in per_bucket.get(bk, [])]
                     for lo, hi in bucket_ranges(len(lengths), len(
                         sub.devices))]
        ref = cache_mod.SegmentRef(index_name=f"rep_{tag}", index_root=root,
                                   version=version, bucket="all")
        out.append(SPMD[pkg].read_sharded(
            per_shard, lengths, [f.name for f in b.schema.fields],
            b.schema, sub, base_ref=ref))
    return out


def _k_below(pkg, bound):
    if pkg == "jax":
        from hyperspace_tpu.plan.expr import col, lit
    else:
        from hyperspace_tpu_torch.plan.expr import col, lit
    return col("k") < lit(bound)


def test_replica_scope_confines_distribution_mesh_like_jax():
    """Under `replica_scope(1)` on a 2 x 4 topology every distribution
    decision sees slice 1's flat 4-shard submesh, whose tag is the JAX
    package's device ids 4..7."""
    from hyperspace_tpu.config import HyperspaceConf as JConf
    from hyperspace_tpu.parallel import context as jcontext
    from hyperspace_tpu.parallel import mesh as jmesh

    from hyperspace_tpu_torch.config import HyperspaceConf as TConf
    from hyperspace_tpu_torch.parallel import context as tcontext
    from hyperspace_tpu_torch.parallel import mesh as tmesh

    virtual.ensure_devices(8, device="cpu")
    settings = {"spark.hyperspace.distribution.enabled": "true",
                "spark.hyperspace.distribution.slices": "2"}
    jconf = JConf(dict(settings))
    tconf = TConf(dict(settings, **{"spark.hyperspace.device": "cpu"}))
    full = tcontext.distribution_mesh(tconf)
    assert tmesh.dcn_size(full) == 2 and tmesh.total_shards(full) == 8
    assert tmesh.mesh_device_tag(full) == jmesh.mesh_device_tag(
        jcontext.distribution_mesh(jconf)) == tuple(range(8))
    for idx in (0, 1):
        with tcontext.replica_scope(idx), jcontext.replica_scope(idx):
            sub = tcontext.distribution_mesh(tconf)
            jsub = jcontext.distribution_mesh(jconf)
            assert tmesh.total_shards(sub) == 4
            assert tmesh.mesh_device_tag(sub) == jmesh.mesh_device_tag(
                jsub) == tuple(range(4 * idx, 4 * idx + 4))
    assert tcontext.active_replica() is None


def test_replica_residency_coherent_under_refresh(tmp_path):
    """Two replica slices fill INDEPENDENT cache entries for the same
    bucket ranges (device-tagged keys, no aliasing), a committed version
    sweeps BOTH, and the re-reads serve the same rows — in both
    packages, with the same residency map."""
    from hyperspace_tpu.io import segcache as jsegcache

    jm, tm = meshes(8, 2)
    table = numeric_table(1600, 17)
    files = {"rep": born_sharded_files(tmp_path, "rep", table, 16, jm, tm)}
    results = {}
    for pkg, mesh, cache_mod in (("jax", jm, jsegcache),
                                 ("port", tm, segcache)):
        cache_mod.clear()
        cache = cache_mod.get_cache()
        root = files["rep"][pkg][0]

        def read(idx):
            sh, = _slice_reads(pkg, files, mesh, idx)
            return frame_of(SPMD[pkg].sharded_filter(sh, _k_below(pkg, 60)))

        r0, r1 = read(0), read(1)
        pd.testing.assert_frame_equal(r0, r1)
        residency = cache.replica_residency(root)
        assert residency == {(0, 1, 2, 3): 4, (4, 5, 6, 7): 4}, (pkg,
                                                                 residency)
        cache.invalidate_index(root, keep_version=1)
        assert cache.replica_residency(root) == {}
        pd.testing.assert_frame_equal(read(0), r0)
        pd.testing.assert_frame_equal(read(1), r0)
        assert len(cache.replica_residency(root)) == 2
        results[pkg] = r0
        cache_mod.clear()
    pd.testing.assert_frame_equal(results["port"], results["jax"])
    want = table.to_pandas()
    assert len(results["port"]) == int((want["k"] < 60).sum())


def test_least_loaded_routing_distribution_under_chaos(tmp_path):
    """8 clients x 4 routed joins on a 2 x 4 topology: the router balances
    them (no replica past 70 %), every join equals pandas and the JAX
    package's, with transient faults injected at the Parquet seam of the
    cold per-shard fills (retried by the io policy)."""
    from hyperspace_tpu_torch.config import HyperspaceConf as TConf
    from hyperspace_tpu_torch.engine.scheduler import QueryScheduler
    from hyperspace_tpu_torch.parallel import replica
    from hyperspace_tpu_torch.utils import faults

    conf = TConf({"spark.hyperspace.distribution.enabled": "true",
                  "spark.hyperspace.distribution.slices": "2",
                  "spark.hyperspace.device": "cpu"})
    jm, tm = meshes(8, 2)
    lt, rt = numeric_table(1000, 19), numeric_table(400, 20)
    files = {tag: born_sharded_files(tmp_path, tag, t, 16, jm, tm)
             for tag, t in (("l", lt), ("r", rt))}
    want = oracle(lt, rt, "inner")
    jl, jr = _slice_reads("jax", files, jm, 0)
    jli, jri = jspmd.sharded_join_indices(jl, jr, ["k"], ["k"])
    pd.testing.assert_frame_equal(pairs(jl.batch, jr.batch, jli, jri), want)

    replica.reset_router()
    router = replica.get_router()
    sched = QueryScheduler()
    segcache.clear()
    tparquet.clear_read_cache()
    inj = faults.install(faults.FaultInjector([faults.FaultRule(
        "parquet.read", kind="transient", probability=0.3, times=8)]))
    results, errors = [], []

    def client():
        try:
            for _ in range(4):
                rep = router.route(None, conf, sched)
                assert rep in (0, 1)
                lsh, rsh = _slice_reads("port", files, tm, rep)
                li, ri = tspmd.sharded_join_indices(lsh, rsh, ["k"], ["k"])
                results.append(pairs(lsh.batch, rsh.batch, li, ri))
        except Exception as exc:  # pragma: no cover - fail loudly
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        faults.uninstall()
        replica.reset_router()
        segcache.clear()
    assert not errors, errors
    assert len(results) == 32
    for frame in results:
        pd.testing.assert_frame_equal(frame, want)
    routed = router.routed_counts()
    assert sum(routed.values()) == 32
    assert max(routed.values()) / 32 <= 0.70, routed
    assert inj.fired("parquet.read") > 0, "the chaos seam never fired"


def test_read_pool_fills_concurrently_with_the_serial_rows(tmp_path):
    """The per-shard fills run on the dedicated `hs-spmd-read` pool and
    give the rows of the one-by-one fill; the pool drains and comes back
    on the next read."""
    _jm, tm = meshes(8, 2)
    table = numeric_table(2000, 41)
    files = {"pool": born_sharded_files(tmp_path, "pool", table, 16, _jm,
                                        tm)}
    segcache.clear()
    names = set()
    real = tspmd._fill_device_shard

    def spy(*args, **kwargs):
        names.add(threading.current_thread().name)
        return real(*args, **kwargs)

    tspmd._fill_device_shard = spy
    try:
        sh, = _slice_reads("port", files, tm, 1)
    finally:
        tspmd._fill_device_shard = real
    assert names and all(n.startswith("hs-spmd-read") for n in names)
    pooled = frame_of(sh.batch)
    tspmd.shutdown_read_pool()
    segcache.clear()
    again, = _slice_reads("port", files, tm, 1)
    pd.testing.assert_frame_equal(frame_of(again.batch), pooled)
    segcache.clear()


def test_device_spans_give_per_shard_tracks_like_jax():
    """With tracing on, the mesh build and the SPMD join put one span per
    shard on the mesh process, carrying each shard's rows (built rows,
    joined pairs), with the JAX package's names, tracks and row counts."""
    from hyperspace_tpu.telemetry import trace as jtrace

    from hyperspace_tpu_torch.telemetry import trace as ttrace

    jm, tm = meshes(8)
    lt, rt = numeric_table(1200, 51), numeric_table(500, 52)
    tracks = {}
    for pkg, trace in (("jax", jtrace), ("port", ttrace)):
        trace.disable_tracing()
        tracer = trace.enable_tracing()
        try:
            sides = [built(t, 16, jm, tm, (pkg,) if pkg == "port" else BOTH)
                     for t in (lt, rt)]
            lsh, rsh = sides[0][pkg][0], sides[1][pkg][0]
            SPMD[pkg].sharded_join_indices(lsh, rsh, ["k"], ["k"])
            events = [e for e in tracer.events if e["pid"] == trace.PID_MESH]
            meta = [e for e in tracer._metadata_events()
                    if e["pid"] == trace.PID_MESH]
        finally:
            trace.disable_tracing()
        tracks[pkg] = ([(e["name"], e["tid"], e["args"]["rows"])
                        for e in events], meta)
    assert tracks["port"] == tracks["jax"]
    names = [n for n, _t, _r in tracks["port"][0]]
    assert names[:8] == [f"build [dev{d}]" for d in range(8)]
    assert names[-8:] == [f"join [dev{d}]" for d in range(8)]
    assert sum(r for n, _t, r in tracks["port"][0][:8]) == 1200


def test_filter_and_repartition_ride_the_device_seam():
    """The sharded filter and the repartition are device-seam entries
    (`mesh.spmd_filter`, `mesh.spmd_repartition`) with a modeled cost."""
    from hyperspace_tpu_torch.telemetry import compilation

    jm, tm = meshes(4)
    table = numeric_table(800, 61)
    sh = built(table, 16, jm, tm, ("port",))["port"][0]
    rec = telemetry.QueryMetrics("seam")
    with telemetry.recording(rec):
        tspmd.sharded_filter(sh, _k_below("port", 40))
        tspmd.repartition_sharded(tcol.from_arrow(table, device=CPU),
                                  ["k"], 8, tm)
    rec.finish()
    costs = compilation.entry_point_costs()
    for name in ("mesh.spmd_filter", "mesh.spmd_repartition"):
        flops, nbytes = costs[name]
        assert flops > 0 and nbytes > 0, name
