"""Bucket ids and per-bucket lengths in one pass — the wrapper of the CUDA
kernel `csrc/partition_histogram.cu`, which replaces the JAX package's
Pallas kernel `ops/pallas/partition_kernel.py::partition_ids_and_histogram`.

The Exchange (`engine/physical.ExchangeExec`) needs both the per-row bucket
id (THE hash identity, `ops/hash_partition.flat_hash32`, modulo the bucket
count) and the per-bucket row counts. The kernel reads the lanes once and
produces both; it is bounded by device-memory bytes.

`partition_ids_and_histogram_reference` is the plain torch version: the
hash kernel's plain version, then `torch.bincount`. The wrapper takes it
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.ops.cuda.hash_kernel import (
    HASH_OPS_PER_LANE, _check as _check_lanes,
    hash_lanes_to_buckets_reference, stack_lanes)
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

# Bucket counts up to this take the fused kernel (its shared-memory
# histogram is 4 * B bytes); above it the Exchange takes the two-pass path
# (hash kernel, then `torch.bincount`). The JAX package routes at the same
# count (`ops/pallas/partition_kernel.py::MAX_KERNEL_BUCKETS`).
MAX_KERNEL_BUCKETS = 1024


def _check(lanes: torch.Tensor, num_buckets: int) -> None:
    _check_lanes(lanes, num_buckets)
    if int(num_buckets) > MAX_KERNEL_BUCKETS:
        raise HyperspaceException(
            f"partition_ids_and_histogram takes at most {MAX_KERNEL_BUCKETS} "
            f"buckets, got {num_buckets}.")


def partition_ids_and_histogram_reference(
        lanes: torch.Tensor, num_buckets: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: (int32 ids [n], int64 lengths [B])."""
    _check(lanes, num_buckets)
    ids = hash_lanes_to_buckets_reference(lanes, num_buckets)
    return ids, torch.bincount(ids, minlength=int(num_buckets))


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from hyperspace_tpu_torch.ops.cuda import build

        fn = build.load("partition_histogram").hs_partition_ids_and_histogram
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def partition_cost(lanes: torch.Tensor, num_buckets: int):
    """Modeled (operations, bytes accessed) of one call, for the device
    seam: the lanes read once, the int32 ids and the int64 lengths
    written once, n·(4L+4) + 8B bytes; the hash's operations plus one
    histogram increment per row."""
    n_lanes, n = int(lanes.shape[0]), int(lanes.shape[1])
    return ((HASH_OPS_PER_LANE * n_lanes + 1) * n,
            n * (4 * n_lanes + 4) + 8 * int(num_buckets))


def _partition_ids_and_histogram(lanes: torch.Tensor, num_buckets: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lanes: contiguous [L, n] int32 tensor of uint32 bit patterns (see
    `stack_lanes`). Returns (int32 ids [n] in [0, num_buckets), int64
    lengths [num_buckets]) on the lanes' device. A CUDA tensor launches the
    kernel (and counts one launch); a CPU tensor runs the plain version."""
    _check(lanes, num_buckets)
    if lanes.device.type == "cpu":
        return partition_ids_and_histogram_reference(lanes, num_buckets)
    if lanes.device.type != "cuda":
        raise HyperspaceException(
            f"partition_ids_and_histogram: unsupported device {lanes.device}")
    if not lanes.is_contiguous():
        raise HyperspaceException("partition lanes must be contiguous [L, n].")
    n_lanes, n = int(lanes.shape[0]), int(lanes.shape[1])
    ids = torch.empty(n, dtype=torch.int32, device=lanes.device)
    lengths = torch.zeros(int(num_buckets), dtype=torch.int64,
                          device=lanes.device)
    if n == 0:
        return ids, lengths
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(lanes.device).cuda_stream
    with torch.cuda.device(lanes.device):
        status = fn(lanes.data_ptr(), n_lanes, n, int(num_buckets),
                    ids.data_ptr(), lengths.data_ptr(), stream)
    from hyperspace_tpu_torch.ops.cuda.build import check
    check(status, "partition_ids_and_histogram")
    partition_ids_and_histogram.launches += 1
    return ids, lengths


# The entry point, through the device seam (see hash_kernel).
partition_ids_and_histogram = instrumented_device(
    "cuda.partition_ids_and_histogram", _partition_ids_and_histogram,
    cost=partition_cost)
partition_ids_and_histogram.launches = 0


def batch_lanes(batch, key_columns: Sequence[str]) -> torch.Tensor:
    """The key columns' hash-input lanes (`column_hash_lanes`, in key
    order) of a device-lane ColumnBatch, as one [L, n] int32 buffer."""
    from hyperspace_tpu_torch.ops.hash_partition import column_hash_lanes

    if not key_columns:
        raise HyperspaceException("Hash partitioning requires key columns.")
    lanes: List[torch.Tensor] = []
    for name in key_columns:
        lanes.extend(column_hash_lanes(batch.column(name)))
    return stack_lanes(lanes)


def batch_partition(batch, key_columns: Sequence[str], num_buckets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ColumnBatch (device lane) -> (bucket ids, lengths) through the fused
    kernel."""
    return partition_ids_and_histogram(batch_lanes(batch, key_columns),
                                       num_buckets)
