"""The PyTorch port's bucket hash against the JAX package's, bit for bit.

The same inputs, made from a seed with numpy, go through
`hyperspace_tpu` (its Pallas hash kernel in interpret mode, and
`hash_partition.bucket_ids`) and through `hyperspace_tpu_torch` on the CPU
(the plain version of the CUDA kernel, `bucket_ids`, `dual_hash64`). The
on-disk bucket layout depends on this identity, so the tolerance is zero.
"""

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import hash_partition as jhp
from hyperspace_tpu.ops import keys as jkeys
from hyperspace_tpu.ops.pallas.hash_kernel import \
    hash_lanes_to_buckets as pallas_hash

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import hash_partition as thp
from hyperspace_tpu_torch.ops import keys as tkeys
from hyperspace_tpu_torch.ops.cuda import hash_kernel as tkernel
from hyperspace_tpu_torch.ops.host_hash import host_bucket_ids

CPU = torch.device("cpu")
SIZES = (1, 127, 129, 4097, 70_000)
BUCKETS = (8, 16, 64, 200, 1024)


def _floats(rng, n):
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.25],
                       dtype=np.float64)
    payload_nan = np.array([0x7FF8000000000001, 0xFFF8000000000002],
                           dtype=np.uint64).view(np.float64)
    pool = np.concatenate([special, payload_nan,
                           rng.normal(size=16) * 1e300])
    return pool[rng.integers(0, len(pool), n)]


def _table(kind, n, rng):
    """(arrow table, key columns) for one key shape."""
    if kind == "int32":
        return pa.table({"k": rng.integers(-2**31, 2**31, n)
                         .astype(np.int32)}), ["k"]
    if kind == "int64":
        return pa.table({"k": rng.integers(-2**62, 2**62, n)
                         .astype(np.int64)}), ["k"]
    if kind == "float64":
        return pa.table({"k": _floats(rng, n)}), ["k"]
    if kind == "string":
        return pa.table({"k": pa.array([f"w{int(x)}é" for x in
                                        rng.integers(0, 211, n)])}), ["k"]
    if kind == "nullable":
        vals = rng.integers(-2**40, 2**40, n).astype(np.int64)
        mask = rng.random(n) < 0.2
        strs = [None if m else f"s{int(v) % 50}" for v, m in zip(vals, mask)]
        return pa.table({"k": pa.array(vals, mask=mask),
                         "s": pa.array(strs)}), ["k", "s"]
    if kind == "three_columns":
        return pa.table({
            "a": rng.integers(0, 100, n).astype(np.int32),
            "b": rng.integers(-2**60, 2**60, n).astype(np.int64),
            "s": pa.array([f"v{int(x)}" for x in rng.integers(0, 30, n)]),
        }), ["a", "b", "s"]
    raise AssertionError(kind)


KINDS = ("int32", "int64", "float64", "string", "nullable", "three_columns")
CASES = [(kind, n, BUCKETS[(i + j) % len(BUCKETS)])
         for i, kind in enumerate(KINDS) for j, n in enumerate(SIZES)]


@pytest.mark.parametrize("kind,n,num_buckets", CASES)
def test_bucket_ids_match_jax(kind, n, num_buckets):
    rng = np.random.default_rng([KINDS.index(kind), n])
    table, keys = _table(kind, n, rng)
    jbatch = jcol.from_arrow(table)
    tbatch = tcol.from_arrow(table, device=CPU)

    expected = np.asarray(jhp.bucket_ids(jbatch, keys, num_buckets))
    jlanes = [lane for k in keys
              for lane in jhp.column_hash_lanes(jbatch.column(k))]
    pallas = np.asarray(pallas_hash(jlanes, num_buckets, interpret=True))
    assert (pallas == expected).all()

    tlanes = [lane for k in keys
              for lane in thp.column_hash_lanes(tbatch.column(k))]
    plain = tkernel.hash_lanes_to_buckets(tkernel.stack_lanes(tlanes),
                                          num_buckets)
    assert plain.dtype == torch.int32
    assert (plain.numpy() == expected).all()
    assert (thp.bucket_ids(tbatch, keys, num_buckets).numpy()
            == expected).all()
    assert (thp.batch_hash32(tbatch, keys).numpy()
            == np.asarray(jhp.batch_hash32(jbatch, keys)).astype(np.int64)
            ).all()

    # dual_hash64 over the sort lanes: the same 64-bit pattern.
    jsort = [lane for k in keys
             for lane in jkeys.column_sort_lanes(jbatch.column(k))]
    tsort = [lane for k in keys
             for lane in tkeys.column_sort_lanes(tbatch.column(k))]
    jdual = np.asarray(jhp.dual_hash64(jsort))
    tdual = thp.dual_hash64(tsort).numpy().view(np.uint64)
    assert (tdual == jdual).all()

    if kind in ("int32", "int64", "float64", "string", "three_columns"):
        # The host mirror (bucket pruning) agrees with both.
        dtypes = [jbatch.schema.field(k).dtype for k in keys]
        host = host_bucket_ids([table.column(k).to_numpy() for k in keys],
                               dtypes, num_buckets)
        assert (host == expected).all()


@pytest.mark.parametrize("pattern", [0, 0xFFFFFFFF])
@pytest.mark.parametrize("n_lanes", [1, 2, 3])
def test_constant_lanes_match_pallas(pattern, n_lanes):
    """Lanes of all zeros and of all 0xFFFFFFFF: the masked int64 chain
    and the int32 bit-pattern transport must not lose the top bit."""
    import jax.numpy as jnp

    n = 4097
    jlanes = [jnp.full(n, pattern, dtype=jnp.uint32)] * n_lanes
    expected = np.asarray(pallas_hash(jlanes, 200, interpret=True))
    tlanes = [torch.full((n,), pattern, dtype=torch.int64)] * n_lanes
    got = tkernel.hash_lanes_to_buckets(tkernel.stack_lanes(tlanes), 200)
    assert (got.numpy() == expected).all()
    assert (thp.flat_hash32(tlanes).numpy()
            == np.asarray(jhp.flat_hash32(jlanes)).astype(np.int64)).all()


def test_float_keys_normalize_zero_and_nan():
    """-0.0 hashes and sorts as +0.0; every NaN as one canonical NaN."""
    vals = np.array([0.0, -0.0, np.nan], dtype=np.float64)
    nans = np.array([0x7FF8000000000001, 0xFFF0000000000001],
                    dtype=np.uint64).view(np.float64)
    data = torch.from_numpy(np.concatenate([vals, nans]))
    lanes = tkeys.key_lanes(data)
    h = thp.flat_hash32(lanes).numpy()
    assert h[0] == h[1]
    assert h[2] == h[3] == h[4]
    for lane in lanes:
        assert lane[2] == lane[3] == lane[4]


def test_wrapper_checks_its_input():
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    with pytest.raises(HyperspaceException):
        tkernel.hash_lanes_to_buckets(torch.zeros(5, dtype=torch.int32), 8)
    with pytest.raises(HyperspaceException):
        tkernel.hash_lanes_to_buckets(torch.zeros((1, 5),
                                                  dtype=torch.int64), 8)
    with pytest.raises(HyperspaceException):
        tkernel.hash_lanes_to_buckets(torch.zeros((1, 5),
                                                  dtype=torch.int32), 0)
    with pytest.raises(HyperspaceException):
        tkernel.stack_lanes([])


def test_cpu_tensor_takes_the_plain_version():
    """A CPU tensor runs the plain version and counts no launch."""
    before = tkernel.hash_lanes_to_buckets.launches
    lanes = torch.arange(10, dtype=torch.int32).reshape(1, 10)
    out = tkernel.hash_lanes_to_buckets(lanes, 8)
    assert (out == tkernel.hash_lanes_to_buckets_reference(lanes, 8)).all()
    assert tkernel.hash_lanes_to_buckets.launches == before
