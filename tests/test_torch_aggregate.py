"""Group-by aggregation through both packages, on the CPU.

The same seeded tables go through the JAX package's
`ops/aggregate.group_aggregate` and the port's, for every function (count
of rows and of values, count_distinct, sum, avg, stddev, min, max) over
int, float, string and nullable inputs, grouped by 0 to 6 key columns —
from one 32-bit lane up to the hashed phase A (>= 5 lanes) — with all-null
groups and empty inputs. The port's host lane must give the JAX host
lane's rows, its torch lane (torch on the CPU) the JAX device lane's, in
the same row order: integers, counts, strings and validity exactly,
float64 within rtol=1e-9 (the order of addition differs between the
segment reductions). A hash forced to collide must take the exact
fallback.
"""

import math

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import aggregate as jagg
from hyperspace_tpu.plan import nodes as jnodes

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import aggregate as tagg
from hyperspace_tpu_torch.ops import hash_partition
from hyperspace_tpu_torch.ops.keys import column_sort_lanes
from hyperspace_tpu_torch.plan import nodes as tnodes

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-9


def _table(n: int, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng([seed, n])
    k32 = rng.integers(0, 7, n).astype(np.int32)
    # group 6 of `k32` holds only nulls in the nullable value columns
    all_null = k32 == 6
    null = (rng.random(n) < 0.2) | all_null
    words = np.array(["ant", "bee", "cat", "dog", "eel"])
    return pa.table({
        "k32": k32,
        "k64": rng.choice(np.array([-(1 << 35), 0, 9, 1 << 40],
                                   dtype=np.int64), n),
        "s": rng.choice(words, n),
        "ng": pa.array(rng.integers(0, 3, n).astype(np.int64),
                       mask=rng.random(n) < 0.1),
        "fk": rng.choice(np.array([-0.0, 0.0, 1.5, -2.25]), n),
        "ns": pa.array(rng.choice(words, n), mask=rng.random(n) < 0.1),
        "iv": rng.integers(-1000, 1000, n).astype(np.int64),
        "i32v": rng.integers(-50, 50, n).astype(np.int32),
        "fv": rng.standard_normal(n) * 1e3,
        "niv": pa.array(rng.integers(-9, 9, n).astype(np.int64), mask=null),
        "nfv": pa.array(rng.standard_normal(n), mask=null),
        "nsv": pa.array(rng.choice(words, n), mask=null),
    })


AGGS = [("count", "*", "n_rows"), ("count", "niv", "n_niv"),
        ("count_distinct", "nsv", "d_nsv"), ("count_distinct", "fk", "d_fk"),
        ("count_distinct", "niv", "d_niv"),
        ("sum", "iv", "sum_iv"), ("sum", "i32v", "sum_i32v"),
        ("sum", "fv", "sum_fv"), ("sum", "niv", "sum_niv"),
        ("sum", "nfv", "sum_nfv"),
        ("avg", "iv", "avg_iv"), ("avg", "nfv", "avg_nfv"),
        ("stddev", "fv", "sd_fv"), ("stddev", "niv", "sd_niv"),
        ("min", "i32v", "min_i32v"), ("min", "nfv", "min_nfv"),
        ("max", "iv", "max_iv"), ("max", "niv", "max_niv")]

GROUPINGS = ([], ["k32"], ["s"], ["k32", "s"], ["ng"], ["fk", "k32"],
             ["k32", "s", "ng"], ["k32", "s", "ng", "fk", "ns", "k64"])


def _schema_of(pkg_nodes, batch_schema, group, aggs):
    class _Child:
        schema = batch_schema
    specs = [pkg_nodes.AggSpec(*a) for a in aggs]
    return specs, pkg_nodes.Aggregate(group, specs, _Child()).schema


def _jax(table, group, aggs, lane):
    batch = jcol.from_arrow(table, device=lane == "device")
    specs, schema = _schema_of(jnodes, batch.schema, group, aggs)
    return jcol.to_arrow(jagg.group_aggregate(batch, group, specs, schema))


def _port(table, group, aggs, lane):
    batch = (tcol.from_arrow(table) if lane == "host"
             else tcol.from_arrow(table, device=CPU))
    specs, schema = _schema_of(tnodes, batch.schema, group, aggs)
    out = tagg.group_aggregate(batch, group, specs, schema)
    if table.num_rows:
        assert out.is_host == (lane == "host")
    return tcol.to_arrow(out)


def _assert_same(got: pa.Table, want: pa.Table):
    """Same columns and rows in the same order: exact for everything but
    float64 values, which agree within RTOL."""
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert [v is None for v in g] == [v is None for v in w], name
            for a, b in zip(g, w):
                if a is not None:
                    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-12), \
                        (name, a, b)
        else:
            assert g == w, name


_JAX_LANE = {"host": "host", "torch": "device"}


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("group", GROUPINGS, ids=lambda g: "+".join(g)
                         or "global")
@pytest.mark.parametrize("n", [1, 1000, 20_000])
def test_group_aggregate_equals_jax(n, group, lane):
    table = _table(n)
    _assert_same(_port(table, group, AGGS, lane),
                 _jax(table, group, AGGS, _JAX_LANE[lane]))


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("group", [[], ["k32"], ["k32", "s", "ng"]],
                         ids=lambda g: "+".join(g) or "global")
def test_empty_input_equals_jax(group, lane):
    """Zero rows: a global aggregate is one row (counts 0, the rest null),
    a grouped one has no rows."""
    table = _table(0)
    got = _port(table, group, AGGS, lane)
    _assert_same(got, _jax(table, group, AGGS, "device"))
    assert got.num_rows == (0 if group else 1)


def test_all_null_groups_are_null_and_counts_zero():
    table = _table(5000)
    for lane in ("host", "torch"):
        out = _port(table, ["k32"], AGGS, lane).to_pydict()
        six = out["k32"].index(6)
        assert out["n_niv"][six] == 0 and out["d_nsv"][six] == 0
        for name in ("sum_niv", "sum_nfv", "avg_nfv", "sd_niv", "min_nfv",
                     "max_niv"):
            assert out[name][six] is None, (lane, name)
        assert out["sum_iv"][six] is not None


def test_wide_groupings_take_the_hashed_phase():
    batch = tcol.from_arrow(_table(100), device=CPU)
    lanes = [lane for name in GROUPINGS[-2]
             for lane in column_sort_lanes(batch.column(name))]
    assert len(lanes) >= tagg.HASH_GROUP_MIN_LANES
    narrow = [lane for name in GROUPINGS[3]
              for lane in column_sort_lanes(batch.column(name))]
    assert len(narrow) < tagg.HASH_GROUP_MIN_LANES


def test_forced_hash_collision_takes_the_exact_fallback(monkeypatch):
    """A hash that maps every row to one value splits groups inside one
    equal-hash run: the collision check fires and the exact sort re-runs,
    giving the narrow path's groups."""
    table = _table(3000)
    group = ["k32", "s", "ng"]
    monkeypatch.setattr(tagg, "HASH_GROUP_MIN_LANES", 99)
    exact = _port(table, group, AGGS, "torch")
    monkeypatch.setattr(tagg, "HASH_GROUP_MIN_LANES", 5)
    monkeypatch.setattr(hash_partition, "dual_hash64",
                        lambda lanes: torch.zeros_like(lanes[0],
                                                       dtype=torch.int64))
    batch = tcol.from_arrow(table, device=CPU)
    lanes = [lane for name in group
             for lane in column_sort_lanes(batch.column(name))]
    assert int(tagg._group_phase_a_hashed(lanes)[2]) & 1
    _assert_same(_port(table, group, AGGS, "torch"), exact)


def test_distinct_is_an_aggregate_without_outputs():
    table = _table(2000)
    for lane in ("host", "torch"):
        got = _port(table, ["k32", "s"], [], lane)
        want = _jax(table, ["k32", "s"], [], _JAX_LANE[lane])
        _assert_same(got, want)
        assert got.num_rows == len({(a, b) for a, b in zip(
            table.column("k32").to_pylist(), table.column("s").to_pylist())})


def test_string_sum_is_refused():
    for lane in ("host", "torch"):
        with pytest.raises(HyperspaceException, match="string column"):
            _port(_table(10), ["k32"], [("sum", "s", "x")], lane)


def test_float_sums_repeat_bit_for_bit():
    table = _table(20_000)
    runs = [_port(table, ["k32"], [("sum", "fv", "t"), ("avg", "nfv", "a")],
                  "torch") for _ in range(2)]
    assert runs[0].equals(runs[1])
