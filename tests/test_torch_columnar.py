"""The PyTorch port's columnar layer against the JAX package's, on the CPU.

One Arrow table with nulls in every column kind, made from a seed with
numpy, is decoded by both packages. Payloads, validity masks, sorted string
dictionaries and their (hi, lo) value hashes must be identical, and every
residence change (host lane -> device lane -> host lane, batch -> tree ->
batch, take, select) must give back the same rows.
"""

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.io import columnar as tcol

CPU = torch.device("cpu")
N = 257


def _table():
    rng = np.random.default_rng(11)
    nulls = rng.random(N) < 0.25
    words = [None if m else f"w{int(x)}ü" for x, m in
             zip(rng.integers(0, 40, N), nulls)]
    # Nullable int64 values stay within 2**53: both packages decode a
    # nullable integer column through float64 (pyarrow's `to_numpy`).
    return pa.table({
        "i64": pa.array(rng.integers(-2**53, 2**53, N), mask=nulls),
        "i32": pa.array(rng.integers(-2**31, 2**31, N).astype(np.int32)),
        "f64": pa.array(rng.standard_normal(N), mask=rng.random(N) < 0.1),
        "s": pa.array(words),
    })


def _np(x):
    return None if x is None else np.asarray(
        x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_same_column(tc, jc):
    assert tc.dtype == jc.dtype
    assert np.array_equal(_np(tc.data), _np(jc.data))
    assert (tc.validity is None) == (jc.validity is None)
    if jc.validity is not None:
        assert np.array_equal(_np(tc.validity), _np(jc.validity))
    if jc.dictionary is not None:
        assert list(tc.dictionary) == list(jc.dictionary)
        for th, jh in zip(tc.dict_hashes, jc.dict_hashes):
            assert np.array_equal(_np(th).astype(np.uint32),
                                  _np(jh).astype(np.uint32))


@pytest.mark.parametrize("lane", ["host", "device"])
def test_from_arrow_matches_jax(lane):
    table = _table()
    jbatch = jcol.from_arrow(table, device=lane == "device")
    tbatch = tcol.from_arrow(table, device=CPU if lane == "device" else None)
    assert tbatch.is_host == (lane == "host")
    for name in table.column_names:
        _assert_same_column(tbatch.column(name), jbatch.column(name))
    assert tcol.to_arrow(tbatch).equals(jcol.to_arrow(jbatch))
    assert tcol.to_arrow(tbatch).equals(table)


def test_residence_round_trips_keep_rows():
    table = _table()
    host = tcol.from_arrow(table)
    device = tcol.host_batch_to_device(host, CPU)
    assert not device.is_host
    back = tcol.batch_to_host(device)
    assert back.is_host
    assert tcol.to_arrow(device).equals(table)
    assert tcol.to_arrow(back).equals(table)
    for name in table.column_names:
        _assert_same_column(back.column(name), host.column(name))

    tree, aux = tcol.batch_to_tree(device)
    rebuilt = tcol.tree_to_batch(tree, device.schema, aux)
    assert tcol.to_arrow(rebuilt).equals(table)


def test_take_and_select_match_jax():
    table = _table()
    idx = np.random.default_rng(5).permutation(N)[:100]
    jout = jcol.to_arrow(jcol.from_arrow(table).select(["s", "i64"])
                         .take(idx))
    tout = tcol.to_arrow(tcol.from_arrow(table, device=CPU)
                         .select(["s", "i64"]).take(torch.from_numpy(idx)))
    assert tout.equals(jout)
