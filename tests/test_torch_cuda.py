"""`hyperspace_tpu_torch` on a CUDA card: the hand-written kernel against
its plain version, and the card's build and filter lanes against the CPU's.

Marked `cuda`; each test skips where there is no card. On the machine
with the card (which has no JAX, so the JAX-loading conftest is skipped):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from hyperspace_tpu_torch.io import builder, columnar
from hyperspace_tpu_torch.ops.cuda import hash_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 129, 70_000, 1 << 20])
@pytest.mark.parametrize("n_lanes", [1, 2, 5])
def test_kernel_equals_plain_version(card, n, n_lanes):
    rng = np.random.default_rng([n, n_lanes])
    host = rng.integers(-2**31, 2**31, (n_lanes, n)).astype(np.int32)
    lanes = torch.from_numpy(host).to(card)
    before = hash_kernel.hash_lanes_to_buckets.launches
    for num_buckets in (8, 200, 1024):
        got = hash_kernel.hash_lanes_to_buckets(lanes, num_buckets)
        torch.cuda.synchronize()
        want = hash_kernel.hash_lanes_to_buckets_reference(
            torch.from_numpy(host), num_buckets)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert (got.cpu() == want).all()
    assert hash_kernel.hash_lanes_to_buckets.launches == before + 3


def _table(n):
    rng = np.random.default_rng(5)
    return pa.table({
        "k": rng.integers(0, n // 4, n).astype(np.int64),
        "s": pa.array([None if i % 29 == 0 else f"v{i % 61}"
                       for i in range(n)]),
        "x": rng.standard_normal(n)})


def test_card_build_writes_the_cpu_layout(card, tmp_path, monkeypatch):
    monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    table = _table(20_000)
    before = hash_kernel.hash_lanes_to_buckets.launches
    for keys in (["k"], ["k", "s"]):
        gpu_dir = str(tmp_path / f"gpu_{len(keys)}")
        cpu_dir = str(tmp_path / f"cpu_{len(keys)}")
        builder.write_bucketed_table(table, keys, 16, gpu_dir, device=card)
        builder.write_bucketed_table(table, keys, 16, cpu_dir,
                                     device=torch.device("cpu"))
        names = sorted(os.listdir(gpu_dir))
        assert names == sorted(os.listdir(cpu_dir))
        for name in names:
            assert pq.read_table(os.path.join(gpu_dir, name)).equals(
                pq.read_table(os.path.join(cpu_dir, name)))
    assert hash_kernel.hash_lanes_to_buckets.launches == before + 2


def test_card_filter_equals_cpu_filter(card):
    from hyperspace_tpu_torch.engine.compiler import apply_filter
    from hyperspace_tpu_torch.plan.expr import col, lit

    table = _table(50_000)
    cond = ((col("k") >= lit(100)) & (col("x") > lit(0.5))) \
        | (col("s") == lit("v7"))
    gpu = apply_filter(columnar.from_arrow(table, device=card), cond)
    cpu = apply_filter(columnar.from_arrow(table,
                                           device=torch.device("cpu")),
                       cond)
    assert gpu.device.type == "cuda"
    assert columnar.to_arrow(gpu).equals(columnar.to_arrow(cpu))
