"""The port's mesh-sharded build and born-sharded index against the JAX
package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices (`make_mesh(8)`
and the 2 x 4 `make_mesh(8, dcn_size=2)`); the port side on 8 virtual
CPU shards (`parallel.virtual.ensure_devices(8)`), reset after every
test. The same seeded tables go through both:

- `distributed_build`: the built rows (in order) and the per-bucket
  lengths are exactly equal, for int64, float64, nullable and string
  keys and for a hot bucket (every row one key);
- `Hyperspace.create_index` with `distribution.enabled=true`: the file
  names, the SHA-256 of every file, the `_shard_layout.json` bytes (the
  per-range dictionaries, a capped range recorded as null) and the log
  entry's `shardLayout` are equal; and every bucket file's bytes equal
  the port's single-device build of the same index;
- a rules-on join over two born-sharded indexes gives the JAX package's
  rows, both packages on their SPMD join lane (the port's with no
  `spmd.fallbacks`).
"""

import glob
import hashlib
import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
from torch_suites import same_rows
import torch

from hyperspace_tpu.config import HyperspaceConf as JConf
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.facade import Hyperspace as JHyperspace
from hyperspace_tpu.index.index_config import IndexConfig as JIndexConfig
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops.build import build_sorted as jbuild_sorted
from hyperspace_tpu.parallel.build import distributed_build as jbuild
from hyperspace_tpu.parallel.mesh import make_mesh as jmake_mesh
from hyperspace_tpu.plan import expr as JE

torch.set_num_threads(1)

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.io import builder as tbuilder
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops.cuda import hash_kernel
from hyperspace_tpu_torch.parallel import virtual
from hyperspace_tpu_torch.parallel.build import distributed_build as tbuild
from hyperspace_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from hyperspace_tpu_torch.plan import expr as TE


@pytest.fixture(autouse=True)
def _virtual_mesh():
    virtual.ensure_devices(8, device="cpu")
    yield
    virtual.reset()


def _table(kind, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if kind == "int64":
        return pa.table({"k": rng.integers(0, max(1, n // 4), n)
                         .astype(np.int64), "x": x}), ["k"]
    if kind == "float64":
        pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0,
                         2.5, 1e300], dtype=np.float64)
        return pa.table({"k": pool[rng.integers(0, len(pool), n)],
                         "i": np.arange(n, dtype=np.int64)}), ["k"]
    if kind == "nullable":
        return pa.table({
            "k": pa.array(rng.integers(-700, 700, n).astype(np.int64),
                          mask=rng.random(n) < 0.1),
            "x": pa.array(x, mask=rng.random(n) < 0.2)}), ["k"]
    if kind == "string":
        return pa.table({
            "s": pa.array([None if i % 31 == 0 else "v%d" % (i % 53)
                           for i in range(n)], type=pa.string()),
            "a": rng.integers(-50, 50, n).astype(np.int32),
            "x": x}), ["s", "a"]
    if kind == "hot":
        return pa.table({"k": np.full(n, 7, dtype=np.int64),
                         "v": np.arange(n, dtype=np.float64)}), ["k"]
    raise AssertionError(kind)


@pytest.mark.parametrize("dcn", [None, 2])
@pytest.mark.parametrize("kind,n,buckets", [
    ("int64", 3001, 16), ("int64", 5, 8), ("float64", 2000, 13),
    ("nullable", 2500, 16), ("string", 2222, 16), ("hot", 800, 16)])
def test_distributed_build_equals_jax(kind, n, buckets, dcn):
    table, keys = _table(kind, n, seed=n + buckets)
    jbuilt, jlengths = jbuild(jcol.from_arrow(table), keys, buckets,
                              jmake_mesh(8, dcn_size=dcn))
    before = hash_kernel.hash_lanes_to_buckets.launches
    tbuilt, tlengths = tbuild(tcol.from_arrow(table), keys, buckets,
                              tmake_mesh(8, dcn_size=dcn))
    # On the CPU the wrapper runs its plain version and counts nothing.
    assert hash_kernel.hash_lanes_to_buckets.launches == before
    np.testing.assert_array_equal(tlengths, np.asarray(jlengths))
    assert tlengths.dtype == np.int64 and int(tlengths.sum()) == n
    if kind == "float64":
        # The JAX package's mesh build returns -0.0 keys as 0.0 (its
        # single-device build keeps them); the port keeps the source's
        # bits, so it equals the JAX single-device build bit for bit and
        # the JAX mesh build up to the sign of zero.
        single, _starts, _ends = jbuild_sorted(jcol.from_arrow(table), keys,
                                               buckets)
        same_rows(tcol.to_arrow(tbuilt), jcol.to_arrow(single))
        same_rows(tcol.to_arrow(tbuilt), jcol.to_arrow(jbuilt),
                   signed_zero=False)
    else:
        same_rows(tcol.to_arrow(tbuilt), jcol.to_arrow(jbuilt))
    if kind == "hot":
        assert int(tlengths.max()) == n


def test_distributed_build_counters():
    table, keys = _table("int64", 999, seed=1)
    reg = telemetry.get_registry()
    before = reg.counters_dict()
    tbuild(tcol.from_arrow(table), keys, 16, tmake_mesh(8))
    after = reg.counters_dict()
    assert after["mesh.build.execs"] - before.get("mesh.build.execs", 0) \
        == 1
    assert after["mesh.build.overflow_retries"] == 0
    assert "mesh.build.sync_s" in after and "mesh.build.dispatch_s" in after


def _write_source(root, n, seed, files=3):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n // 4, n).astype(np.int64)
    # Few names per shard, a different few on each: the per-range
    # dictionaries fall on both sides of the entry cap.
    cols = {
        "key": key,
        "k2": rng.integers(0, 100, n).astype(np.int64),
        "id": np.arange(n, dtype=np.int64),
        "score": rng.random(n),
        "name": pa.array([None if i % 17 == 0
                          else (f"n{k}" if k < 48 else "common")
                          for i, k in enumerate(key.tolist())],
                         type=pa.string()),
    }
    os.makedirs(root)
    step = -(-n // files)
    for i in range(files):
        part = pa.table({k: v[i * step:(i + 1) * step]
                         for k, v in cols.items()})
        pq.write_table(part, os.path.join(root, f"part-{i}.parquet"))
    return pa.table(cols)


def _settings(warehouse, buckets, extra):
    return {"spark.hyperspace.warehouse.dir": str(warehouse),
            "spark.hyperspace.index.num.buckets": str(buckets),
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.broadcast.threshold": "-1", **extra}


def _jax(warehouse, buckets, extra):
    sess = JSession(JConf(_settings(warehouse, buckets, extra)))
    return sess, JHyperspace(sess)


def _port(warehouse, buckets, extra):
    sess = ths.HyperspaceSession(
        ths.HyperspaceConf(_settings(warehouse, buckets, extra)),
        device="cpu")
    return sess, ths.Hyperspace(sess)


def _files(root):
    """SHA-256 of every file of a version dir; the `_committed` marker
    holds its commit time, so only its presence is compared."""
    out = {os.path.basename(p): hashlib.sha256(open(p, "rb").read())
           .hexdigest()
           for p in glob.glob(os.path.join(root, "*"))
           if os.path.isfile(p)}
    assert "_committed" in out
    out["_committed"] = "present"
    return out


def _latest_entry(system_path, name):
    logs = os.path.join(system_path, name, "_hyperspace_log")
    ids = sorted(int(f) for f in os.listdir(logs) if f.isdigit())
    with open(os.path.join(logs, str(ids[-1]))) as f:
        return json.load(f)


DIST = {"spark.hyperspace.distribution.enabled": "true",
        "spark.hyperspace.distribution.dictionary.max.entries": "6"}


@pytest.mark.parametrize("slices", [1, 2])
def test_born_sharded_index_equals_jax(tmp_path, slices):
    src = str(tmp_path / "src")
    _write_source(src, 20_000, seed=5)
    extra = dict(DIST, **{"spark.hyperspace.distribution.slices":
                          str(slices)})
    cfg = ("bsIdx", ["key"], ["k2", "id", "score", "name"])
    js, jh = _jax(tmp_path / "jwh", 16, extra)
    jh.create_index(js.read_parquet(src), JIndexConfig(*cfg))
    ts, th = _port(tmp_path / "twh", 16, extra)
    th.create_index(ts.read_parquet(src), ths.IndexConfig(*cfg))
    single, sh = _port(tmp_path / "single", 16, {
        "spark.hyperspace.distribution.enabled": "false"})
    sh.create_index(single.read_parquet(src), ths.IndexConfig(*cfg))

    jroot = os.path.join(js.conf.system_path, "bsIdx", "v__=0")
    troot = os.path.join(ts.conf.system_path, "bsIdx", "v__=0")
    sroot = os.path.join(single.conf.system_path, "bsIdx", "v__=0")
    tfiles = _files(troot)
    assert tfiles == _files(jroot)
    parts = sorted(f for f in tfiles if f.endswith(".parquet"))
    assert all(re.fullmatch(r"part-\d{5}-s\d{2}\.parquet", f)
               for f in parts)
    assert {f[-10:-8] for f in parts} == {"%02d" % s for s in range(8)}

    layout = json.loads(open(os.path.join(troot, "_shard_layout.json"))
                        .read())
    assert layout["numShards"] == 8 and layout["numSlices"] == slices
    ranges = layout["dictionaries"]["name"]
    assert any(r is None for r in ranges)       # over the cap of 6
    assert any(r is not None for r in ranges)
    assert layout == tbuilder.write_shard_layout(
        str(tmp_path / "again"), 16, 8,
        dictionaries=layout["dictionaries"], n_slices=slices)

    tentry = _latest_entry(ts.conf.system_path, "bsIdx")
    jentry = _latest_entry(js.conf.system_path, "bsIdx")
    assert tentry["extra"]["shardLayout"] == jentry["extra"]["shardLayout"]
    assert "dictionaries" not in tentry["extra"]["shardLayout"]
    assert tentry["extra"]["shardLayout"]["dictionaryEntries"]["name"] == [
        len(r) if r is not None else -1 for r in ranges]
    assert "shardLayout" not in _latest_entry(single.conf.system_path,
                                              "bsIdx")["extra"]
    from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
    assert IndexLogEntry.from_dict(tentry).shard_layout == \
        tentry["extra"]["shardLayout"]

    # Every bucket's file equals the single-device build's, byte for byte.
    sfiles = _files(sroot)
    by_bucket = {f[:10]: h for f, h in tfiles.items()
                 if f.endswith(".parquet")}
    assert by_bucket == {f[:10]: h for f, h in sfiles.items()
                         if f.endswith(".parquet")}


def test_born_sharded_join_equals_jax(tmp_path):
    """Rules on, two born-sharded indexes: the port's SPMD join reads the
    `-sNN` files shard by shard, with no fallback, and gives the JAX
    package's rows."""
    left_src, right_src = str(tmp_path / "l"), str(tmp_path / "r")
    _write_source(left_src, 12_000, seed=7)
    rng = np.random.default_rng(8)
    os.makedirs(right_src)
    pq.write_table(pa.table({
        "key": rng.integers(0, 3000, 6000).astype(np.int64),
        "val": rng.random(6000)}), os.path.join(right_src, "r.parquet"))

    results = []
    for make, E, Config in ((_jax, JE, JIndexConfig),
                            (_port, TE, ths.IndexConfig)):
        sess, hs = make(tmp_path / ("wh%d" % len(results)), 8, DIST)
        left = sess.read_parquet(left_src)
        right = sess.read_parquet(right_src)
        hs.create_index(left, Config("jl", ["key"], ["id"]))
        hs.create_index(right, Config("jr", ["key"], ["val"]))
        sess.enable_hyperspace()
        query = (left.select("key", "id")
                 .join(right.select("key", "val"), on="key"))
        roots = [p for leaf in sess.optimize(query.plan).collect_leaves()
                 for p in leaf.root_paths]
        assert roots and all("v__=" in r for r in roots)
        if hasattr(query, "to_pandas"):
            table = query.to_pandas()
        else:
            reg = telemetry.get_registry()
            fallbacks = reg.counter("spmd.fallbacks").value
            joins = reg.counter("mesh.spmd.join_execs").value
            collected, metrics = query.collect(with_metrics=True)
            table = collected.to_pandas()
            assert [o.detail.get("lane") for o in metrics.operators
                    if o.name == "SortMergeJoin"] == ["spmd"]
            assert reg.counter("mesh.spmd.join_execs").value == joins + 1
            assert reg.counter("spmd.fallbacks").value == fallbacks
        results.append(table.sort_values(["id", "val"])
                       .reset_index(drop=True)[["key", "id", "val"]])
    assert len(results[0]) > 0
    assert results[0].equals(results[1])
