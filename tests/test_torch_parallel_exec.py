"""The port's sharded filter and group aggregate against the JAX
package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices (`make_mesh(8)`
and the 2 x 4 mesh); the port side on 8 virtual CPU shards, reset after
every test. The same seeded tables go through both:

- `distributed_filter` equals JAX `distributed_filter` and the port's
  `apply_filter` bit for bit, including row counts the shard count does
  not divide;
- `distributed_group_aggregate` equals the JAX function: integers
  exactly (int64 sums near 2^62), floats within rtol 1e-9; through the
  engine, `count_distinct` stays on one device;
- the `mesh.*` counters a distributed build, filter and aggregate move
  are the JAX package's, and a fused stage over a source that would
  distribute reports the JAX package's `mesh-distribution` trigger.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
from torch_suites import same_rows
import torch

from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu.config import HyperspaceConf as JConf
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.facade import Hyperspace as JHyperspace
from hyperspace_tpu.index.index_config import IndexConfig as JIndexConfig
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.parallel.aggregate import (
    distributed_group_aggregate as jagg)
from hyperspace_tpu.parallel.mesh import make_mesh as jmake_mesh
from hyperspace_tpu.parallel.scan import distributed_filter as jfilter
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plan import nodes as jnodes
from hyperspace_tpu.plan.schema import Schema as JSchema

torch.set_num_threads(1)

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.engine.compiler import apply_filter
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.parallel import virtual
from hyperspace_tpu_torch.parallel.aggregate import (
    distributed_group_aggregate as tagg)
from hyperspace_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from hyperspace_tpu_torch.parallel.scan import distributed_filter as tfilter
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plan import nodes as tnodes
from hyperspace_tpu_torch.plan.schema import Schema as TSchema

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _virtual_mesh():
    virtual.ensure_devices(8, device="cpu")
    yield
    virtual.reset()


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 300, n).astype(np.int64),
        "g": rng.integers(0, 37, n).astype(np.int32),
        "x": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
        "s": pa.array([None if i % 23 == 0 else "w%d" % (i % 61)
                       for i in range(n)], type=pa.string()),
        "big": rng.integers(-2**50, 2**50, n).astype(np.int64),
    })


PREDICATES = {
    "int_range": lambda E: (E.col("k") >= E.lit(40)) & (E.col("k") < E.lit(90)),
    "float_nullable": lambda E: E.col("x") > E.lit(0.25),
    "string_eq": lambda E: E.col("s") == E.lit("w7"),
    "or_in": lambda E: (E.col("g") == E.lit(3)) | E.col("k").isin(1, 2, 250),
    "none": lambda E: E.col("k") < E.lit(-1),
}


@pytest.mark.parametrize("dcn", [None, 2])
@pytest.mark.parametrize("n", [1001, 8, 3])
@pytest.mark.parametrize("pred", sorted(PREDICATES))
def test_distributed_filter_equals_jax_and_apply_filter(pred, n, dcn):
    table = _table(n, seed=n)
    want_jax = jcol.to_arrow(jfilter(jcol.from_arrow(table),
                                     PREDICATES[pred](JE),
                                     jmake_mesh(8, dcn_size=dcn)))
    mesh = tmake_mesh(8, dcn_size=dcn)
    for device in (None, CPU):  # a host batch and a torch batch
        batch = tcol.from_arrow(table, device=device)
        got = tfilter(batch, PREDICATES[pred](TE), mesh)
        assert not got.is_host
        got = tcol.to_arrow(got)
        same_rows(got, want_jax)
        same_rows(got, tcol.to_arrow(apply_filter(batch,
                                                   PREDICATES[pred](TE))))


SPECS = [("count", "*", "cnt"), ("count", "x", "cx"), ("sum", "big", "sb"),
         ("sum", "k", "sk"), ("avg", "x", "ax"), ("min", "big", "mnb"),
         ("max", "x", "mxx"), ("min", "s", "ms"), ("stddev", "x", "sdx")]


def _aggregate(pkg, table, groups, specs, mesh):
    col, nodes, Schema, agg = pkg
    schema = Schema.from_arrow(table.schema)
    specs = [nodes.AggSpec(*s) for s in specs]
    out_schema = nodes.Aggregate(groups, specs,
                                 nodes.Scan(["/nx"], schema)).schema
    return col.to_arrow(agg(col.from_arrow(table), groups, specs,
                            out_schema, mesh)).to_pandas()


JAX = (jcol, jnodes, JSchema, jagg)
PORT = (tcol, tnodes, TSchema, tagg)


@pytest.mark.parametrize("dcn", [None, 2])
@pytest.mark.parametrize("groups", [["g"], ["s", "g"], ["k"]])
def test_distributed_group_aggregate_equals_jax(groups, dcn):
    table = _table(5003, seed=11)
    specs = [s for s in SPECS if s[0] != "min" or s[1] != "s"]
    want = _aggregate(JAX, table, groups, specs,
                      jmake_mesh(8, dcn_size=dcn))
    got = _aggregate(PORT, table, groups, specs,
                     tmake_mesh(8, dcn_size=dcn))
    want = want.sort_values(groups).reset_index(drop=True)
    got = got.sort_values(groups).reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    for name in ("cnt", "cx", "sb", "sk", "mnb") + tuple(groups):
        assert got[name].tolist() == want[name].tolist(), name
    pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                  check_exact=False, rtol=1e-9)


def test_distributed_aggregate_int64_exact_near_2_62():
    """int64 sums, minima and maxima past 2^53 stay exact (the JAX
    package's `test_distributed_aggregate_int64_exact`, at 2^62)."""
    big = (1 << 62) - 5
    table = pa.table({"g": np.array([0, 1] * 8, dtype=np.int64),
                      "y": np.array([big // 8 + i for i in range(16)],
                                    dtype=np.int64)})
    specs = [("sum", "y", "sy"), ("min", "y", "mny"), ("max", "y", "mxy")]
    want = _aggregate(JAX, table, ["g"], specs, jmake_mesh(8))
    got = _aggregate(PORT, table, ["g"], specs, tmake_mesh(8))
    y = table.column("y").to_numpy()
    for g in (0, 1):
        rows = y[g::2]
        assert int(got.sy[g]) == int(want.sy[g]) == sum(int(v) for v in rows)
        assert int(got.mny[g]) == int(rows.min())
        assert int(got.mxy[g]) == int(rows.max())


def _counters(reg, prefix="mesh."):
    return {k: v for k, v in reg.counters_dict().items()
            if k.startswith(prefix)}


def _moved(before, after):
    return {k for k, v in after.items() if v != before.get(k, 0)}


def _write_lake(root, n=9000):
    rng = np.random.default_rng(3)
    os.makedirs(root)
    pq.write_table(pa.table({
        "key": rng.integers(0, 2000, n).astype(np.int64),
        "k2": rng.integers(0, 50, n).astype(np.int64),
        "id": np.arange(n, dtype=np.int64),
        "score": rng.random(n)}), os.path.join(root, "part-0.parquet"))


def _scenario(make, E, Config, src, reg):
    """Build, a rules-on filter (fused) and a group aggregate with
    count_distinct, then one without; returns (moved mesh counters after
    each step, fusion lane triggers, aggregate results)."""
    sess, hs = make()
    df = sess.read_parquet(src)
    steps = []
    before = reg()
    hs.create_index(df, Config("ix", ["key"], ["k2", "id", "score"]))
    steps.append(_moved(before, reg()))
    sess.enable_hyperspace()
    before = reg()
    q = df.filter(E.col("key") < E.lit(700)).select("id", "score")
    table, metrics = q.collect(with_metrics=True)
    steps.append(_moved(before, reg()))
    triggers = sorted({e.get("trigger")
                       for e in metrics.events_of("fusion", "lane")})
    sess.disable_hyperspace()
    before = reg()
    distinct = (df.group_by("k2")
                .agg(("count_distinct", "key", "dk"), ("sum", "id", "si"))
                .collect().to_pandas())
    steps.append(_moved(before, reg()))
    before = reg()
    plain = (df.group_by("k2").agg(("count", "*", "c"), ("sum", "id", "si"),
                                   ("stddev", "score", "sd"))
             .collect().to_pandas())
    steps.append(_moved(before, reg()))
    return (steps, triggers, table.num_rows,
            distinct.sort_values("k2").reset_index(drop=True),
            plain.sort_values("k2").reset_index(drop=True))


def test_mesh_counters_and_fusion_trigger_equal_jax(tmp_path):
    src = str(tmp_path / "src")
    _write_lake(src)
    settings = {"spark.hyperspace.index.num.buckets": "16",
                "spark.hyperspace.execution.min.device.rows": "0",
                "spark.hyperspace.distribution.enabled": "true",
                "spark.hyperspace.distribution.spmd.enabled": "false"}

    def jax_session():
        sess = JSession(JConf(dict(settings, **{
            "spark.hyperspace.warehouse.dir": str(tmp_path / "j")})))
        return sess, JHyperspace(sess)

    def port_session():
        sess = ths.HyperspaceSession(ths.HyperspaceConf(dict(settings, **{
            "spark.hyperspace.warehouse.dir": str(tmp_path / "t")})),
            device="cpu")
        return sess, ths.Hyperspace(sess)

    jreg = jtelemetry.get_registry()
    treg = telemetry.get_registry()
    want = _scenario(jax_session, JE, JIndexConfig, src,
                     lambda: _counters(jreg))
    got = _scenario(port_session, TE, ths.IndexConfig, src,
                    lambda: _counters(treg))
    assert got[0] == want[0]
    assert "mesh.build.execs" in got[0][0]
    assert "mesh.filter.execs" in got[0][1]
    assert "mesh.aggregate.execs" not in got[0][2]   # count_distinct
    assert "mesh.aggregate.execs" in got[0][3]
    assert got[1] == want[1] and "mesh-distribution" in got[1]
    assert got[2] == want[2] > 0
    pd.testing.assert_frame_equal(got[3], want[3], check_dtype=False)
    pd.testing.assert_frame_equal(got[4], want[4], check_dtype=False,
                                  check_exact=False, rtol=1e-9)
