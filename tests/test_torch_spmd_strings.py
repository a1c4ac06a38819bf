"""The port's born-sharded SPMD execution (`parallel/spmd.py`) against the
JAX package's, on the CPU: string keys (the global dictionaries, the
rank-remap tables, the value-hash re-bucket, a warm repeat served from
the segment cache), the sharded filter and group aggregate, and the LIKE
mask. Same meshes, tables and tolerances as `test_torch_spmd.py`
(`tests/torch_spmd.py`): strings and float64 payload values compared
exactly, float64 aggregates within rtol 1e-9, rows after one canonical
sort.
"""

import pandas as pd
import pytest
import torch
from torch_suites import jax_counters_guard  # noqa: E402,F401
from torch_spmd import (AGG_RTOL, BOTH, SPMD, agg_specs, born_sharded_files,
                        built, check_joins, frame_of, meshes, numeric_table,
                        oracle, pairs, string_table)

from hyperspace_tpu.engine.compiler import apply_filter as japply_filter
from hyperspace_tpu.io import builder as jbuilder
from hyperspace_tpu.io import parquet as jparquet
from hyperspace_tpu.ops.aggregate import group_aggregate as jgroup_aggregate
from hyperspace_tpu.plan import expr as JE

torch.set_num_threads(1)

from hyperspace_tpu_torch import telemetry  # noqa: E402
from hyperspace_tpu_torch.engine.compiler import \
    apply_filter as tapply_filter  # noqa: E402
from hyperspace_tpu_torch.io import builder as tbuilder  # noqa: E402
from hyperspace_tpu_torch.io import parquet as tparquet  # noqa: E402
from hyperspace_tpu_torch.io import segcache  # noqa: E402
from hyperspace_tpu_torch.ops.aggregate import \
    group_aggregate as tgroup_aggregate  # noqa: E402
from hyperspace_tpu_torch.parallel import spmd as tspmd  # noqa: E402
from hyperspace_tpu_torch.parallel import virtual  # noqa: E402
from hyperspace_tpu_torch.plan import expr as TE  # noqa: E402


@pytest.fixture(autouse=True)
def _virtual_mesh():
    yield
    virtual.reset()


# -- filter, aggregate, LIKE --------------------------------------------------

@pytest.mark.parametrize("kind,n_dev,slices", [
    ("numeric", 2, 1), ("numeric", 8, 2), ("string", 8, 1),
    ("string", 8, 4)])
def test_filter_and_aggregate_bit_identity(kind, n_dev, slices):
    jm, tm = meshes(n_dev, slices if slices > 1 else None)
    table = (numeric_table(2000, 7) if kind == "numeric"
             else string_table(1500, 11, keyspace=60, null_frac=0.05))
    sides = built(table, 16, jm, tm)
    if kind == "numeric":
        preds = [lambda E: E.col("k") < E.lit(60)]
    else:
        preds = [lambda E: E.col("k") < E.lit("key0000030"),
                 lambda E: E.col("k") == E.lit("key0000007"),
                 lambda E: E.col("k").isin("key0000001", "key0000002",
                                           "no-such-key")]
    for make in preds:
        got = {}
        for pkg, E, apply in (("jax", JE, japply_filter),
                              ("port", TE, tapply_filter)):
            sh, b = sides[pkg]
            got[pkg] = frame_of(SPMD[pkg].sharded_filter(sh, make(E)))
            pd.testing.assert_frame_equal(got[pkg], frame_of(apply(b,
                                                                 make(E))))
        pd.testing.assert_frame_equal(got["port"], got["jax"])
    aggs = {}
    for pkg, single in (("jax", jgroup_aggregate),
                        ("port", tgroup_aggregate)):
        sh, b = sides[pkg]
        specs, out_schema = agg_specs(pkg, table)
        aggs[pkg] = frame_of(SPMD[pkg].sharded_group_aggregate(
            sh, ["k"], specs, out_schema), ["k"])
        pd.testing.assert_frame_equal(
            aggs[pkg], frame_of(single(b, ["k"], specs, out_schema), ["k"]),
            check_dtype=False, check_exact=False, rtol=AGG_RTOL)
    pd.testing.assert_frame_equal(aggs["port"], aggs["jax"],
                                  check_dtype=False, check_exact=False,
                                  rtol=AGG_RTOL)


def test_filter_over_a_narrowed_layout_and_aggregate_of_it():
    """A Filter narrows `row_valid` without moving rows; the sharded
    aggregate over that layout reads the masks (the engine's
    Filter-under-join shape) and equals the single-device aggregate."""
    jm, tm = meshes(4)
    table = numeric_table(3000, 17)
    sh, b = built(table, 16, jm, tm)["port"]
    pred = TE.col("v") > TE.lit(0.5)
    narrowed = sh.narrowed(sh.shards, [
        v & (s.column("v").data > 0.5)
        for s, v in zip(sh.shards, sh.row_valid)], keep_lengths=False)
    assert narrowed.num_rows == int((table.column("v").to_numpy()
                                     > 0.5).sum())
    specs, out_schema = agg_specs("port", table)
    got = frame_of(tspmd.sharded_group_aggregate(narrowed, ["k"], specs,
                                               out_schema), ["k"])
    want = frame_of(tgroup_aggregate(tapply_filter(b, pred), ["k"], specs,
                                   out_schema), ["k"])
    pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                  check_exact=False, rtol=AGG_RTOL)


def test_sharded_filter_like_mask_warm_link_free():
    """LIKE over the sharded layout: the dictionary mask is made once,
    cached, and a warm repeat moves nothing over the link with
    `spmd.strings.like_mask_cache_hits` advancing; rows equal the JAX
    package's and the host regex path's."""
    jm, tm = meshes(4)
    table = string_table(1200, 13, keyspace=90, null_frac=0.05)
    sides = built(table, 16, jm, tm)
    segcache.clear()
    want = None
    for pkg, E, apply in (("jax", JE, japply_filter),
                          ("port", TE, tapply_filter)):
        sh, b = sides[pkg]
        pred = E.col("k").like("key00000_%")
        plain = frame_of(apply(b, pred))
        cold = frame_of(SPMD[pkg].sharded_filter(sh, pred))
        reg = telemetry.get_registry()
        c0 = dict(reg.counters_dict())
        warm = frame_of(SPMD[pkg].sharded_filter(sh, pred))
        c1 = dict(reg.counters_dict())
        for frame in (cold, warm):
            pd.testing.assert_frame_equal(frame, plain)
        if want is not None:
            pd.testing.assert_frame_equal(warm, want)
        want = warm
    assert c1.get("link.h2d.chunks", 0) == c0.get("link.h2d.chunks", 0)
    assert c1.get("spmd.strings.like_mask_cache_hits", 0) > \
        c0.get("spmd.strings.like_mask_cache_hits", 0)
    mask = tspmd.string_like_mask(sides["port"][1].column("k"),
                                  "key000000.", torch.device("cpu"))
    assert mask.dtype == torch.bool and int(mask.sum()) == 10


# -- strings ------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,slices,pkgs", [
    (1, 1, ("port",)), (2, 1, ("port",)), (4, 1, BOTH), (8, 1, ("port",)),
    (8, 2, BOTH)])
def test_string_join_bit_identity(n_dev, slices, pkgs):
    """String keys, NULLs included: rank remaps make two dictionaries
    comparable; equals pandas at every shape (and the JAX package's)."""
    jm, tm = meshes(n_dev, slices if slices > 1 else None)
    lt = string_table(900, 5, null_frac=0.08)
    rt = string_table(400, 6)
    check_joins(lt, rt, built(lt, 16, jm, tm, pkgs),
                built(rt, 16, jm, tm, pkgs))


def test_string_high_cardinality_and_value_hash_rebucket():
    """Nearly one dictionary entry per row still joins exactly, and a
    right side at another bucket count re-buckets by dictionary VALUE
    hash (the rank lanes are pair-local and must not route)."""
    jm, tm = meshes(4)
    lt = string_table(1200, 31, keyspace=1 << 12)
    rt = string_table(600, 32, keyspace=1 << 12)
    left = built(lt, 16, jm, tm)
    check_joins(lt, rt, left, built(rt, 16, jm, tm), hows=("inner",))
    check_joins(lt, rt, left, built(rt, 8, jm, tm),
                hows=("inner", "full_outer"))


def test_string_warm_repeat_serves_dictionaries_and_remaps_from_cache(
        tmp_path):
    """A born-sharded string read and join a second time: the global
    dictionaries and the remap tables come from the segment cache (no
    H2D chunk, `spmd.strings.remap_cache_hits` advancing), the range
    record holds one dictionary per shard, and both packages give the
    same rows."""
    from hyperspace_tpu.io.segcache import SegmentRef as JRef

    from hyperspace_tpu_torch.io.segcache import SegmentRef as TRef

    jm, tm = meshes(4)
    lt = string_table(800, 41, keyspace=120, null_frac=0.05)
    rt = string_table(300, 42, keyspace=120)
    data = {"l": born_sharded_files(tmp_path, "l", lt, 16, jm, tm),
            "r": born_sharded_files(tmp_path, "r", rt, 16, jm, tm)}
    for pkg, builder in (("jax", jbuilder), ("port", tbuilder)):
        layout = builder.read_shard_layout(data["l"][pkg][0])
        assert len(layout["dictionaries"]["k"]) == 4
    segcache.clear()
    results = {}
    for pkg, parquet, mesh, Ref in (("jax", jparquet, jm, JRef),
                                    ("port", tparquet, tm, TRef)):
        spmd = SPMD[pkg]

        def read(tag):
            root, lengths, b = data[tag][pkg]
            per_bucket = parquet.bucket_files(root)
            per_shard = [[f for bk in range(lo, hi)
                          for f in per_bucket.get(bk, [])]
                         for lo, hi in [(0, 4), (4, 8), (8, 12), (12, 16)]]
            ref = Ref(index_name=f"str_{tag}", index_root=root, version=0,
                      bucket="t")
            return spmd.read_sharded(per_shard, lengths,
                                     [f.name for f in b.schema.fields],
                                     b.schema, mesh, base_ref=ref)

        def join_once():
            lsh, rsh = read("l"), read("r")
            li, ri = spmd.sharded_join_indices(lsh, rsh, ["k"], ["k"])
            return pairs(lsh.batch, rsh.batch, li, ri)

        cold = join_once()
        c0 = dict(telemetry.get_registry().counters_dict())
        warm = join_once()
        c1 = dict(telemetry.get_registry().counters_dict())
        pd.testing.assert_frame_equal(cold, warm)
        results[pkg] = warm
    assert c1.get("link.h2d.chunks", 0) == c0.get("link.h2d.chunks", 0)
    assert c1.get("link.h2d.bytes", 0) == c0.get("link.h2d.bytes", 0)
    assert c1.get("spmd.strings.remap_cache_hits", 0) >= \
        c0.get("spmd.strings.remap_cache_hits", 0) + 3
    pd.testing.assert_frame_equal(results["port"], results["jax"])
    pd.testing.assert_frame_equal(results["port"],
                                  oracle(lt, rt, "inner"))
