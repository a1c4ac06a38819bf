"""The port's sketch kernels and sketch blobs against the JAX package's,
on the CPU.

`hyperspace_tpu_torch/ops/sketch.py` on both of its lanes — numpy (the
host lane) and torch tensors (the device lane, here on the CPU) — takes
the same seeded columns as the JAX package's host lane and its device
lane (XLA on the CPU): int, float (NaN included), bool and string
columns, with and without nulls. Bloom words must be bit-identical, zone
values and counts exact, Z-order permutations equal. Then the
`_hs_sketches` blob: the per-file rows each package writes for one lake
are equal, and each package loads and prunes with the other's blob.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
import hyperspace_tpu_torch as ths
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.index import sketch as jsketch_io
from hyperspace_tpu.io import columnar as jcolumnar
from hyperspace_tpu.ops import sketch as jsketch
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plan.rules import skipping as jskipping
from hyperspace_tpu.plan.schema import Schema as JSchema
from hyperspace_tpu_torch.index import sketch as tsketch_io
from hyperspace_tpu_torch.io import columnar as tcolumnar
from hyperspace_tpu_torch.ops import sketch as tsketch
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plan.rules import skipping as tskipping
from hyperspace_tpu_torch.plan.schema import Schema as TSchema

torch.set_num_threads(1)

N = 3000
DTYPES = ("int64", "int32", "float64", "float32", "bool", "string")


def _values(dtype, rng, n=N):
    if dtype == "int64":
        return pa.array(rng.integers(-2**40, 2**40, n), type=pa.int64())
    if dtype == "int32":
        return pa.array(rng.integers(-1000, 1000, n).astype(np.int32))
    if dtype in ("float64", "float32"):
        v = rng.normal(0, 100, n)
        v[rng.random(n) < 0.05] = np.nan
        v[rng.random(n) < 0.02] = 0.0
        v[rng.random(n) < 0.02] = -0.0
        return pa.array(v.astype(dtype))
    if dtype == "bool":
        return pa.array(rng.random(n) < 0.3)
    return pa.array([f"k{int(v)}" for v in rng.integers(0, 400, n)])


def _with_nulls(arr, rng, p=0.1):
    mask = rng.random(len(arr)) < p
    return pa.array([None if m else v
                     for v, m in zip(arr.to_pylist(), mask)], type=arr.type)


def _table(dtype, nulls, seed=11):
    rng = np.random.default_rng(seed)
    arr = _values(dtype, rng)
    if nulls:
        arr = _with_nulls(arr, rng)
    return pa.table({"c": arr})


def _four_lanes(t):
    """(label, sketch module, column) for the JAX host and device lanes
    and the port's host and torch lanes."""
    js, ts = JSchema.from_arrow(t.schema), TSchema.from_arrow(t.schema)
    return [
        ("jax-host", jsketch,
         jcolumnar.from_arrow(t, js, device=False).column("c")),
        ("jax-device", jsketch,
         jcolumnar.from_arrow(t, js, device=True).column("c")),
        ("torch-host", tsketch,
         tcolumnar.from_arrow(t, ts, device=None).column("c")),
        ("torch-device", tsketch,
         tcolumnar.from_arrow(t, ts,
                              device=torch.device("cpu")).column("c")),
    ]


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_zones_equal_jax(dtype, nulls):
    lanes = _four_lanes(_table(dtype, nulls))
    want = lanes[0][1].zones(lanes[0][2])
    assert want["ok"] > 0
    for label, mod, column in lanes[1:]:
        got = mod.zones(column)
        assert got == want, (label, got, want)
        assert type(got["min"]) is type(want["min"]), label


@pytest.mark.parametrize("nbits", [256, 4096, 65536])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bloom_words_equal_jax(dtype, nulls, nbits):
    lanes = _four_lanes(_table(dtype, nulls))
    want = lanes[0][1].bloom_build(lanes[0][2], nbits)
    assert want.dtype == np.uint32 and len(want) == nbits // 32
    for label, mod, column in lanes[1:]:
        got = np.asarray(mod.bloom_build(column, nbits))
        assert got.dtype == np.uint32, label
        assert np.array_equal(got, want), label


def test_zones_of_an_all_null_or_nan_column_are_none():
    """A zone whose ok-set is empty reports None bounds on every lane,
    as the JAX package does; a column of NaNs counts them."""
    for arr in (pa.array([None, None, None], type=pa.int64()),
                pa.array([float("nan"), float("nan")]),
                pa.array([None, None], type=pa.string())):
        lanes = _four_lanes(pa.table({"c": arr}))
        want = lanes[0][1].zones(lanes[0][2])
        assert want["min"] is None and want["max"] is None
        assert want["has_nan"] == (arr.type == pa.float64())
        for label, mod, column in lanes[1:]:
            assert mod.zones(column) == want, label


@pytest.mark.parametrize("dtype,values", [
    ("int64", [0, -1, 2**40 + 7, -2**63, 2**63 - 1]),
    ("int32", [0, -5, 2**31 - 1]),
    ("float64", [0.0, -0.0, 1.5, -1e300, float("nan"), float("inf")]),
    ("float32", [0.0, 3.25, -7.5]),
    ("bool", [True, False]),
    ("string", ["", "k7", "ünïcode", "x" * 100]),
    ("date32", [0, 19000]),
])
def test_probe_hash_pair_equals_jax(dtype, values):
    for v in values:
        assert tsketch.probe_hash_pair(v, dtype) == \
            jsketch.probe_hash_pair(v, dtype), (dtype, v)
    for bad in ("text", 2**70) if dtype == "int64" else ():
        with pytest.raises(ths.HyperspaceException):
            tsketch.probe_hash_pair(bad, dtype)
        with pytest.raises(jhs.HyperspaceException):
            jsketch.probe_hash_pair(bad, dtype)


def test_bloom_probe_and_sizing_equal_jax():
    for rows in (1, 100, 10_000, 1_048_576, 10**9):
        for fpp in (0.5, 0.01, 1e-9):
            assert tsketch.bloom_num_bits(rows, fpp, 64 * 1024) == \
                jsketch.bloom_num_bits(rows, fpp, 64 * 1024)
    t = _table("int64", True)
    words = tsketch.bloom_build(
        tcolumnar.from_arrow(t, TSchema.from_arrow(t.schema),
                             device=torch.device("cpu")).column("c"), 2048)
    rng = np.random.default_rng(5)
    for v in rng.integers(-2**40, 2**40, 200).tolist():
        pair = tsketch.probe_hash_pair(v, "int64")
        assert tsketch.bloom_maybe_contains(words, *pair) == \
            jsketch.bloom_maybe_contains(words, *pair)
    for v in t.column("c").drop_null().to_pylist()[:200]:
        assert tsketch.bloom_maybe_contains(
            words, *tsketch.probe_hash_pair(v, "int64"))


@pytest.mark.parametrize("columns", [
    ["a"], ["a", "b"], ["s", "f"], ["b", "a", "s", "f"], ["g", "a"]])
def test_zorder_permutation_equals_jax(columns):
    rng = np.random.default_rng(9)
    n = 2000
    t = pa.table({
        "a": _with_nulls(pa.array(rng.integers(0, 50, n)), rng),
        "b": pa.array(rng.permutation(n).astype(np.int64)),
        "s": _with_nulls(pa.array([f"s{int(v)}"
                                   for v in rng.integers(0, 30, n)]), rng),
        "f": pa.array(np.where(rng.random(n) < 0.05, np.nan,
                               rng.normal(0, 1, n))),
        "g": pa.array(rng.random(n) < 0.5),
    })
    jb = jcolumnar.from_arrow(t, JSchema.from_arrow(t.schema), device=False)
    tb = tcolumnar.from_arrow(t, TSchema.from_arrow(t.schema), device=None)
    want = jsketch.zorder_permutation(jb, columns)
    got = tsketch.zorder_permutation(tb, columns)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


# -- the blob ---------------------------------------------------------------


def _lake(src, files=5, rows=400):
    """Key-clustered files with every sketched kind, nulls included."""
    os.makedirs(src)
    rng = np.random.default_rng(17)
    for i in range(files):
        t = pa.table({
            "key": np.arange(i * rows, (i + 1) * rows, dtype=np.int64),
            "f": pa.array(np.where(rng.random(rows) < 0.05, np.nan,
                                   rng.normal(i * 10, 3, rows))),
            "s": _with_nulls(pa.array([f"s{i}_{int(v)}" for v in
                                       rng.integers(0, 20, rows)]), rng),
            "g": pa.array(rng.integers(-9, 9, rows).astype(np.int32)),
            "b": pa.array(rng.random(rows) < 0.5),
        })
        pq.write_table(t, os.path.join(src, f"part-{i}.parquet"))


SKETCHED = ["key", "f", "s", "g", "b"]


def _jax_session(root, **conf):
    return JSession(jhs.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": os.path.join(root, "wh"),
        "spark.hyperspace.distribution.enabled": "false", **conf}))


def _torch_session(root, **conf):
    return ths.HyperspaceSession(ths.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": os.path.join(root, "wh"),
        **conf}), device="cpu")


def _blob(sess, pkg, name):
    manager = pkg.Hyperspace.get_context(sess).index_collection_manager
    entry = [e for e in manager.get_indexes(["ACTIVE"]) if e.name == name][0]
    return os.path.join(entry.content.root, "_hs_sketches")


def _rows(path):
    table = pq.read_table(path)
    return table.schema.metadata, table.to_pydict()


@pytest.mark.parametrize("jax_lane,torch_lane", [
    ("host", "host"), ("device", "torch")])
def test_blob_rows_equal_jax(tmp_path, jax_lane, torch_lane):
    """Both packages sketch one lake: the blobs' per-file rows and
    metadata are equal (same paths and stamps: the files are shared),
    each lane of the port against each of the JAX package's."""
    src = str(tmp_path / "src")
    _lake(src)
    jconf = ({"spark.hyperspace.execution.min.device.rows": "0"}
             if jax_lane == "device" else {})
    tconf = ({"spark.hyperspace.execution.min.device.rows": "0"}
             if torch_lane == "torch" else {})
    jsess = _jax_session(str(tmp_path / "jax"), **jconf)
    tsess = _torch_session(str(tmp_path / "torch"), **tconf)
    jhs.Hyperspace(jsess).create_index(
        jsess.read_parquet(src), jhs.DataSkippingIndexConfig("sk", SKETCHED))
    ths.Hyperspace(tsess).create_index(
        tsess.read_parquet(src), ths.DataSkippingIndexConfig("sk", SKETCHED))
    jmeta, jrows = _rows(_blob(jsess, jhs, "sk"))
    tmeta, trows = _rows(_blob(tsess, ths, "sk"))
    assert tmeta == jmeta
    assert trows.keys() == jrows.keys()
    for column in jrows:
        assert trows[column] == jrows[column], column
    assert all(len(b) > 0 for b in trows["bloom_0"])


def test_blobs_cross_both_ways(tmp_path):
    """Each package loads the other's blob to the same FileSketch
    facts, and prunes the same files with it."""
    src = str(tmp_path / "src")
    _lake(src)
    jsess = _jax_session(str(tmp_path / "jax"))
    tsess = _torch_session(str(tmp_path / "torch"))
    jhs.Hyperspace(jsess).create_index(
        jsess.read_parquet(src), jhs.DataSkippingIndexConfig("sk", SKETCHED))
    ths.Hyperspace(tsess).create_index(
        tsess.read_parquet(src), ths.DataSkippingIndexConfig("sk", SKETCHED))
    jdir = os.path.dirname(_blob(jsess, jhs, "sk"))
    tdir = os.path.dirname(_blob(tsess, ths, "sk"))
    files = sorted(tsess.read_parquet(src).plan.files())
    preds = [
        lambda E: E.col("key") == E.lit(850),
        lambda E: (E.col("key") >= E.lit(390)) & (E.col("key") < E.lit(410)),
        lambda E: E.col("s") == E.lit("s3_4"),
        lambda E: E.col("f") > E.lit(35.0),
        lambda E: E.col("g").isin(100, 200) | E.col("key").is_null(),
    ]
    for blob_dir in (jdir, tdir):
        t_set = tsketch_io.load_sketches(blob_dir)
        j_set = jsketch_io.load_sketches(blob_dir)
        assert t_set.columns == j_set.columns == SKETCHED
        assert t_set.dtypes == j_set.dtypes
        assert t_set.blooms_usable and j_set.blooms_usable
        assert sorted(t_set.files) == sorted(j_set.files) == files
        for path, tf in t_set.files.items():
            jf = j_set.files[path]
            assert (tf.size, tf.stamp, tf.rows, tf.bucket) == \
                (jf.size, jf.stamp, jf.rows, jf.bucket)
            for name, tc in tf.columns.items():
                jc = jf.columns[name]
                assert (tc.dtype, tc.min, tc.max, tc.nulls, tc.ok,
                        tc.has_nan) == (jc.dtype, jc.min, jc.max, jc.nulls,
                                        jc.ok, jc.has_nan)
                assert np.array_equal(tc.bloom, jc.bloom)
        pruned_any = False
        for pred in preds:
            got = tskipping.prune_files(pred(TE), files, t_set)
            assert got == jskipping.prune_files(pred(JE), files, j_set)
            pruned_any |= bool(got[1])
        assert pruned_any
    tsketch_io.clear_sketch_cache()
    jsketch_io.clear_sketch_cache()


def test_port_serves_and_refreshes_a_jax_built_index(tmp_path):
    """A skipping index the JAX package built is served by the port
    (the rules-on plan reads the files the JAX plan reads), refreshed by
    the port, and the port's blob is then served by the JAX package."""
    src = str(tmp_path / "src")
    _lake(src)
    wh = str(tmp_path)
    jsess, tsess = _jax_session(wh), _torch_session(wh)
    jhs.Hyperspace(jsess).create_index(
        jsess.read_parquet(src), jhs.DataSkippingIndexConfig("sk", ["key"]))

    def plan_files(sess, E):
        sess.enable_hyperspace()
        try:
            df = sess.read_parquet(src)
            q = df.filter(E.col("key") < E.lit(700)).select("key", "s")
            (leaf,) = q._optimized_plan().collect_leaves()
            rows = q.collect().num_rows
        finally:
            sess.disable_hyperspace()
        return sorted(leaf.files()), rows

    want = plan_files(jsess, JE)
    assert len(want[0]) == 2 and want[1] == 700
    assert plan_files(tsess, TE) == want
    pq.write_table(pa.table({
        "key": np.arange(5000, 5100, dtype=np.int64),
        "f": np.zeros(100), "s": pa.array(["n"] * 100),
        "g": np.zeros(100, dtype=np.int32), "b": np.zeros(100, dtype=bool)}),
        os.path.join(src, "part-9.parquet"))
    ths.Hyperspace(tsess).refresh_index("sk", mode="incremental")
    detail = ths.telemetry.get_registry().last_action_report()["detail"]
    assert detail["files_sketched"] == 1 and detail["files_carried"] == 5
    # The JAX session's catalog cache predates the port's commit.
    jhs.Hyperspace.get_context(jsess).index_collection_manager.clear_cache()
    assert plan_files(jsess, JE) == plan_files(tsess, TE) == want
