"""ORDER BY and top-k through both packages, on the CPU.

The same seeded tables go through the JAX package's `ops/sort.py` and the
port's: `sort_batch` and `topk_batch` over int32, int64, float64 (with
-0.0, infinities and NaN), string and nullable keys, ascending and
descending mixes of one to four keys, at 0 to 70,000 rows. The port's host
lane (numpy) must give the JAX host lane's rows and the port's torch lane
(torch on the CPU) the JAX device lane's, in exactly the same order —
every table carries a row id, so ties must keep their input order. Top-k
also keeps the JAX package's residency contract, and its candidate-cap
fallback (forced by lowering `TOPK_CANDIDATE_CAP` in both packages) gives
the same rows on the device.
"""

import math

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import sort as jsort

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import sort as tsort

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = (0, 1, 127, 4097, 70_000)
KEY_SETS = (
    ["i32"],
    ["-i64"],
    ["f64"],
    ["-f64", "small"],
    ["s", "-small"],
    ["ni64"],
    ["-ns", "ni64"],
    ["small", "-ns", "f64", "-i32"],
)
_SPECIAL = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1e300, -1e-300,
                     2.5, -2.5])


def _table(n: int) -> pa.Table:
    rng = np.random.default_rng([11, n])
    null = rng.random(n) < 0.15
    wide = rng.choice(np.array([-(1 << 40), -7, 0, 3, (1 << 33) + 1,
                                (1 << 62)], dtype=np.int64), n)
    f64 = np.where(rng.random(n) < 0.5, rng.choice(_SPECIAL, n),
                   np.round(rng.standard_normal(n), 1))
    words = np.array(["", "a", "ab", "b", "zz", "Z", "mm"])
    return pa.table({
        "id": np.arange(n, dtype=np.int64),
        "small": rng.integers(0, 5, n).astype(np.int64),
        "i32": rng.integers(-40, 40, n).astype(np.int32),
        "i64": wide,
        "f64": f64,
        "s": rng.choice(words, n),
        "ni64": pa.array(wide, mask=null),
        "ns": pa.array(rng.choice(words, n), mask=rng.random(n) < 0.2),
    })


def _rows(table: pa.Table):
    """Columns as lists, NaN spelled out so that equal rows compare
    equal."""
    def norm(v):
        return "nan" if isinstance(v, float) and math.isnan(v) else v
    return {c: [norm(v) for v in table.column(c).to_pylist()]
            for c in table.column_names}


_JAX_CACHE = {}


def _jax(kind, n, keys, lane, k=None):
    """The JAX package's rows for one case (memoized: both port lanes
    compare with the same JAX runs)."""
    key = (kind, n, tuple(keys), lane, k)
    if key not in _JAX_CACHE:
        batch = jcol.from_arrow(_table(n), device=lane == "device")
        out = (jsort.sort_batch(batch, keys) if kind == "sort"
               else jsort.topk_batch(batch, keys, k))
        _JAX_CACHE[key] = _rows(jcol.to_arrow(out))
    return _JAX_CACHE[key]


def _port_batch(n, lane):
    return (tcol.from_arrow(_table(n)) if lane == "host"
            else tcol.from_arrow(_table(n), device=CPU))


_JAX_LANE = {"host": "host", "torch": "device"}


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("keys", KEY_SETS, ids=",".join)
@pytest.mark.parametrize("n", SIZES)
def test_sort_batch_equals_jax_exact_order(n, keys, lane):
    out = tsort.sort_batch(_port_batch(n, lane), keys)
    assert out.is_host == (lane == "host")
    assert _rows(tcol.to_arrow(out)) == _jax("sort", n, keys,
                                             _JAX_LANE[lane])


def test_descending_puts_nulls_last_and_nan_first():
    """Spark's null placement: ascending nulls first, descending nulls
    last; NaN orders above +inf, so it leads a descending sort."""
    t = pa.table({"x": pa.array([1.0, None, 2.0, -0.0]),
                  "y": [float("nan"), float("inf"), 1.0, -0.0]})
    for lane in ("host", "torch"):
        b = (tcol.from_arrow(t) if lane == "host"
             else tcol.from_arrow(t, device=CPU))

        def column(keys, name):
            return tcol.to_arrow(tsort.sort_batch(b, keys)).column(
                name).to_pylist()
        assert column(["x"], "x") == [None, -0.0, 1.0, 2.0]
        assert column(["-x"], "x") == [2.0, 1.0, -0.0, None]
        desc = column(["-y"], "y")
        assert math.isnan(desc[0]) and desc[1:] == [math.inf, 1.0, -0.0]


TOPK_KEYS = (["-f64", "id"], ["s", "-small", "id"], ["-ni64", "i32"],
             ["small"])


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("keys", TOPK_KEYS, ids=",".join)
@pytest.mark.parametrize("n,k", [(1, 0), (1, 5), (4097, 0), (4097, 7),
                                 (4097, 100), (4097, 5000), (70_000, 10)])
def test_topk_batch_equals_jax_and_keeps_residency(n, k, keys, lane):
    batch = _port_batch(n, lane)
    out = tsort.topk_batch(batch, keys, k)
    assert _rows(tcol.to_arrow(out)) == _jax("topk", n, keys,
                                             _JAX_LANE[lane], k)
    # The JAX package's residency contract: a host input stays on the
    # host; a device input comes out on the host from the threshold path,
    # and stays on the device when k = 0 or k covers every row.
    threshold_path = lane == "torch" and 0 < k < n
    assert out.is_host == (lane == "host" or threshold_path)
    # identical to the first k rows of the full sort
    full = tcol.to_arrow(tsort.sort_batch(batch, keys)).slice(0, k)
    assert _rows(tcol.to_arrow(out)) == _rows(full)


def test_topk_candidate_cap_fallback_sorts_on_the_device(monkeypatch):
    """With the cap lowered, a low-cardinality leading key leaves far more
    than 4k candidates: both packages take the full sort, and the port's
    output stays on the device with a telemetry event."""
    import hyperspace_tpu.ops.sort as jmod

    n, k, keys = 4097, 10, ["small", "-f64", "id"]
    monkeypatch.setattr(jmod, "TOPK_CANDIDATE_CAP", 0)
    monkeypatch.setattr(tsort, "TOPK_CANDIDATE_CAP", 0)
    jout = jsort.topk_batch(jcol.from_arrow(_table(n)), keys, k)
    assert not jout.is_host
    metrics = telemetry.QueryMetrics()
    with telemetry.recording(metrics):
        out = tsort.topk_batch(_port_batch(n, "torch"), keys, k)
    assert not out.is_host
    assert _rows(tcol.to_arrow(out)) == _rows(jcol.to_arrow(jout))
    (event,) = metrics.events_of("topk", "candidate-cap-fallback")
    assert event["n"] == k and event["candidates"] > 4 * k


def test_topk_ties_at_the_threshold_keep_input_order():
    """Every row shares one prefix: the candidate set is the whole batch
    and the stable finish keeps the first k rows by id."""
    t = pa.table({"a": np.zeros(1000, dtype=np.int64),
                  "id": np.arange(1000, dtype=np.int64)})
    out = tsort.topk_batch(tcol.from_arrow(t, device=CPU), ["a"], 3)
    assert tcol.to_arrow(out).column("id").to_pylist() == [0, 1, 2]
