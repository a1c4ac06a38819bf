"""The port's partition function against the JAX package's Pallas kernel.

`hyperspace_tpu_torch.ops.cuda.partition_kernel` computes, in one pass,
each row's bucket id (THE hash identity) and the per-bucket row counts; on
the CPU it runs its plain version. The same inputs, made from a seed with
numpy, go through the JAX package's `batch_partition(..., interpret=True)`
(the Pallas kernel in interpret mode). Ids and lengths are integers, so the
tolerance is zero. Then the port's Exchange on the CPU against the same
function and against the JAX package's Exchange.
"""

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops.pallas.partition_kernel import \
    batch_partition as pallas_partition

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops.cuda import hash_kernel, partition_kernel

CPU = torch.device("cpu")
N = 70_000  # crosses several of the TPU kernel's 256x128 tiles, ragged tail


def _table():
    rng = np.random.default_rng(41)
    return pa.table({
        "k": rng.integers(-2**60, 2**60, N).astype(np.int64),
        "s": pa.array(["w%d" % (i % 211) for i in range(N)]),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.mark.parametrize("cols,num_buckets",
                         [(["k"], 64), (["k", "s"], 200), (["s"], 16)])
def test_partition_matches_pallas_interpret(table, cols, num_buckets):
    ids_j, lengths_j = pallas_partition(jcol.from_arrow(table), cols,
                                        num_buckets, interpret=True)
    ids_j, lengths_j = np.asarray(ids_j), np.asarray(lengths_j)
    before = partition_kernel.partition_ids_and_histogram.launches
    ids, lengths = partition_kernel.batch_partition(
        tcol.from_arrow(table, device=CPU), cols, num_buckets)
    assert ids.dtype == torch.int32 and lengths.dtype == torch.int64
    assert (ids.numpy() == ids_j).all()
    assert (lengths.numpy() == lengths_j).all()
    assert int(lengths.sum()) == N
    # A CPU tensor takes the plain version and counts no launch.
    assert partition_kernel.partition_ids_and_histogram.launches == before


@pytest.mark.parametrize("n", [1, 127, 129, 4097])
@pytest.mark.parametrize("n_lanes", [1, 2, 4, 6])
def test_reference_is_hash_then_bincount(n, n_lanes):
    """The plain version equals the hash kernel's plain version followed by
    a histogram, with the all-zero and all-ones rows included."""
    rng = np.random.default_rng([n, n_lanes])
    host = rng.integers(-2**31, 2**31, (n_lanes, n)).astype(np.int32)
    if n >= 4:
        host[:, 0] = 0
        host[:, 1] = -1
    lanes = torch.from_numpy(host)
    for num_buckets in (8, 64, 200, 1024):
        ids, lengths = partition_kernel.partition_ids_and_histogram(
            lanes, num_buckets)
        want = hash_kernel.hash_lanes_to_buckets_reference(lanes,
                                                           num_buckets)
        assert (ids == want).all()
        assert (lengths.numpy()
                == np.bincount(want.numpy(), minlength=num_buckets)).all()
        assert int(lengths.sum()) == n


def test_wrapper_checks_its_input():
    lanes = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(HyperspaceException):
        partition_kernel.partition_ids_and_histogram(
            lanes, partition_kernel.MAX_KERNEL_BUCKETS + 1)
    with pytest.raises(HyperspaceException):
        partition_kernel.partition_ids_and_histogram(lanes, 0)
    with pytest.raises(HyperspaceException):
        partition_kernel.partition_ids_and_histogram(
            torch.zeros((1, 5), dtype=torch.int64), 8)
    with pytest.raises(HyperspaceException):
        partition_kernel.batch_partition(
            tcol.from_arrow(pa.table({"k": [1, 2]}), device=CPU), [], 8)


@pytest.mark.parametrize("num_buckets", [200, 2048])
@pytest.mark.parametrize("lane", ["host", "torch"])
def test_exchange_groups_rows_like_jax(table, num_buckets, lane):
    """The Exchange's output (rows grouped by bucket, stable within a
    bucket) and lengths equal the JAX package's, on both lanes and on
    both sides of the fused-kernel bucket-count route."""
    from hyperspace_tpu.engine.physical import ExchangeExec as JExchange
    from hyperspace_tpu_torch.engine.physical import ExchangeExec

    jbatch, jlengths = JExchange(["k", "s"], num_buckets, None).partition(
        jcol.from_arrow(table, device=False))
    tbatch = (tcol.from_arrow(table) if lane == "host"
              else tcol.from_arrow(table, device=CPU))
    out, lengths = ExchangeExec(["k", "s"], num_buckets, None).partition(
        tbatch)
    assert out.is_host == (lane == "host")
    assert lengths.dtype == np.int64
    assert (lengths == np.asarray(jlengths)).all()
    assert tcol.to_arrow(out).equals(jcol.to_arrow(jbatch))
