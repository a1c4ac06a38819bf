"""Shared pieces of the port's SPMD parity tests
(`tests/test_torch_spmd.py`, `tests/test_torch_spmd_strings.py`): the
meshes of both packages, seeded tables built on them and placed
born-sharded, the joined rows as exact text, and the pandas oracles."""

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from hyperspace_tpu.io import builder as jbuilder
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.parallel import spmd as jspmd
from hyperspace_tpu.parallel.build import distributed_build as jbuild
from hyperspace_tpu.parallel.mesh import make_mesh as jmake_mesh
from hyperspace_tpu.plan.nodes import AggSpec as JAggSpec
from hyperspace_tpu.plan.nodes import Aggregate as JAggregate
from hyperspace_tpu.plan.nodes import Scan as JScan
from hyperspace_tpu.plan.schema import Schema as JSchema

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.io import builder as tbuilder
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.parallel import spmd as tspmd
from hyperspace_tpu_torch.parallel import virtual
from hyperspace_tpu_torch.parallel.build import \
    distributed_build as tbuild
from hyperspace_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from hyperspace_tpu_torch.plan.nodes import AggSpec as TAggSpec
from hyperspace_tpu_torch.plan.nodes import Aggregate as TAggregate
from hyperspace_tpu_torch.plan.nodes import Scan as TScan
from hyperspace_tpu_torch.plan.schema import Schema as TSchema

CPU = torch.device("cpu")
AGG_RTOL = 1e-9


def meshes(n, dcn=None):
    """(JAX mesh, port mesh) of n shards; dcn > 1 makes them 2-axis."""
    virtual.ensure_devices(n, device="cpu")
    return jmake_mesh(n, dcn_size=dcn), tmake_mesh(n, dcn_size=dcn)


def numeric_table(n, seed, keyspace=None):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, keyspace or max(4, n // 8), n).astype(np.int64),
        "v": rng.random(n)})


def string_table(n, seed, keyspace=80, null_frac=0.0):
    rng = np.random.default_rng(seed)
    keys = [f"key{int(x):07d}" for x in rng.integers(0, keyspace, n)]
    if null_frac:
        keys = [None if r < null_frac else k
                for k, r in zip(keys, rng.random(n))]
    return pa.table({"k": pa.array(keys, type=pa.string()),
                     "v": rng.random(n)})


BOTH = ("jax", "port")


def built(table, buckets, jmesh, tmesh, pkgs=BOTH):
    """{package: (sharded, built)} of one table built on that package's
    mesh at `buckets` buckets, keyed on `k` (per-bucket lengths equal)."""
    out = {}
    if "jax" in pkgs:
        jb, jl = jbuild(jcol.from_arrow(table), ["k"], buckets, jmesh)
        out["jax"] = (jspmd.shard_bucket_ordered(jb, jl, jmesh), jb)
    tb, tl = tbuild(tcol.from_arrow(table, device=CPU), ["k"], buckets,
                    tmesh)
    out["port"] = (tspmd.shard_bucket_ordered(tb, tl, tmesh), tb)
    if "jax" in pkgs:
        assert np.array_equal(np.asarray(jl), tl)
    return out


SPMD = {"jax": jspmd, "port": tspmd}


def values(batch, name):
    """A column's values as exact text ("~null" for a null)."""
    col = batch.column(name)
    data = np.asarray(col.data)
    if col.dictionary is not None:
        data = np.asarray(col.dictionary)[data]
    text = np.asarray([str(x) for x in data.tolist()], dtype=object)
    if col.validity is not None:
        text = np.where(np.asarray(col.validity), text, "~null")
    return text


def pairs(lbatch, rbatch, li, ri):
    """The joined (lk, lv, rk, rv) rows as exact text, canonically
    sorted; "~none" on the unmatched side of an outer row."""
    cols = {}
    for side, batch, idx in (("l", lbatch, li), ("r", rbatch, ri)):
        idx = np.asarray(idx).astype(np.int64)
        for name in ("k", "v"):
            vals = values(batch, name)
            got = (vals[np.clip(idx, 0, None)] if len(vals)
                   else np.full(len(idx), "~none", dtype=object))
            cols[side + name] = np.where(idx >= 0, got, "~none")
    frame = pd.DataFrame(cols).astype(object)
    return frame.sort_values(list(frame.columns)).reset_index(drop=True)


def oracle(lt, rt, how):
    """pandas over the source tables: null keys match nothing."""
    def frame(t, p):
        k = t.column("k").to_pylist()
        return pd.DataFrame({
            p + "k": ["~null" if x is None else str(x) for x in k],
            p + "v": [str(x) for x in t.column("v").to_pylist()],
            "j": [f"~{p}{i}" if x is None else str(x)
                  for i, x in enumerate(k)]})

    merged = frame(lt, "l").merge(frame(rt, "r"), on="j", how={
        "inner": "inner", "left_outer": "left",
        "full_outer": "outer"}[how]).drop(columns="j").fillna("~none")
    merged = merged.astype(object)
    return merged.sort_values(list(merged.columns)).reset_index(drop=True)


def membership_oracle(lt, rt, anti):
    lk = lt.column("k").to_pylist()
    rk = {x for x in rt.column("k").to_pylist() if x is not None}
    hit = np.asarray([x is not None and x in rk for x in lk])
    keep = ~hit if anti else hit
    return sorted(("~null" if k is None else str(k), str(v))
                  for k, v, h in zip(lk, lt.column("v").to_pylist(), keep)
                  if h)


def members(lbatch, idx):
    idx = np.asarray(idx).astype(np.int64)
    return sorted(zip(values(lbatch, "k")[idx].tolist(),
                      values(lbatch, "v")[idx].tolist()))


def check_joins(lt, rt, left, right, hows=("inner", "left_outer",
                                            "full_outer"), anti=(False, True)):
    """Every join type through each package in `left` equals pandas."""
    for how in hows:
        want = oracle(lt, rt, how)
        for pkg in left:
            lsh, rsh = left[pkg][0], right[pkg][0]
            li, ri = SPMD[pkg].sharded_join_indices(lsh, rsh, ["k"], ["k"],
                                                    how=how)
            pd.testing.assert_frame_equal(
                pairs(lsh.batch, rsh.batch, li, ri), want, obj=(pkg, how))
    for is_anti in anti:
        want = membership_oracle(lt, rt, is_anti)
        for pkg in left:
            lsh, rsh = left[pkg][0], right[pkg][0]
            idx = SPMD[pkg].sharded_semi_anti_indices(lsh, rsh, ["k"], ["k"],
                                                      anti=is_anti)
            assert members(lsh.batch, idx) == want, (pkg, is_anti)


def counter(name):
    return telemetry.get_registry().counters_dict().get(name, 0)


def born_sharded_files(tmp_path, tag, table, buckets, jm, tm):
    """Both packages' born-sharded index files of `table` under
    tmp/<pkg>-<tag>: (root, lengths, built) per package."""
    out = {}
    for pkg, build, col, builder, mesh, kw in (
            ("jax", jbuild, jcol, jbuilder, jm, {}),
            ("port", tbuild, tcol, tbuilder, tm, {"device": CPU})):
        b, lengths = build(col.from_arrow(table, **kw), ["k"], buckets,
                           mesh)
        root = str(tmp_path / f"{pkg}-{tag}")
        builder.write_bucket_ordered(b, lengths, buckets, root, mesh=mesh)
        out[pkg] = (root, np.asarray(lengths), b)
    return out


def agg_specs(pkg, table):
    Schema, Aggregate, AggSpec, Scan = (
        (JSchema, JAggregate, JAggSpec, JScan) if pkg == "jax"
        else (TSchema, TAggregate, TAggSpec, TScan))
    specs = [AggSpec("count", "*", "cnt"), AggSpec("sum", "v", "sv"),
             AggSpec("min", "v", "mn"), AggSpec("max", "v", "mx")]
    schema = Schema.from_arrow(table.schema)
    return specs, Aggregate(["k"], specs, Scan(["/nx"], schema)).schema


def frame_of(batch, cols=None):
    """A batch of either package as a canonically sorted DataFrame."""
    table = (tcol.to_arrow(batch) if isinstance(batch, tcol.ColumnBatch)
             else jcol.to_arrow(batch))
    frame = table.to_pandas()
    return frame.sort_values(cols or list(frame.columns)) \
        .reset_index(drop=True)
