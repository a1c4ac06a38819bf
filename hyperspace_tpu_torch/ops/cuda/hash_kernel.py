"""Bucket ids from uint32 key lanes — the wrapper of the CUDA kernel
`csrc/hash_buckets.cu`, which replaces the JAX package's Pallas kernel
`ops/pallas/hash_kernel.py::hash_lanes_to_buckets`.

The kernel computes THE hash identity (`ops/hash_partition.flat_hash32`)
modulo `num_buckets`; the on-disk bucket layout depends on it bit for bit.
It is bounded by device-memory bytes (each lane read once, each id written
once) and keeps the whole fmix32/hash_combine chain in uint32 registers.

`hash_lanes_to_buckets_reference` is the plain torch version of the same
function. The wrapper takes it only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

_MAX_BUCKETS = (1 << 31) - 1

# 32-bit integer operations per key lane per row: fmix32 (two multiplies,
# three shift-xors) and the boost hash_combine step.
HASH_OPS_PER_LANE = 20


def stack_lanes(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Key lanes (any integer dtype, each holding a 32-bit pattern) as the
    kernel's one contiguous [L, n] int32 buffer. Values outside int32 wrap
    to their low 32 bits, which is the uint32 pattern the hash reads."""
    if not lanes:
        raise HyperspaceException("hash_lanes_to_buckets needs >= 1 lane.")
    return torch.stack([lane.to(torch.int32) for lane in lanes])


def _check(lanes: torch.Tensor, num_buckets: int) -> None:
    if not isinstance(lanes, torch.Tensor) or lanes.dim() != 2:
        raise HyperspaceException(
            "hash_lanes_to_buckets takes one [L, n] int32 tensor "
            "(see stack_lanes).")
    if lanes.dtype != torch.int32:
        raise HyperspaceException(
            f"hash lanes must be int32 bit patterns, got {lanes.dtype}.")
    if lanes.shape[0] < 1:
        raise HyperspaceException("hash_lanes_to_buckets needs >= 1 lane.")
    if not 1 <= int(num_buckets) <= _MAX_BUCKETS:
        raise HyperspaceException(f"num_buckets out of range: {num_buckets}")


def hash_lanes_to_buckets_reference(lanes: torch.Tensor,
                                    num_buckets: int) -> torch.Tensor:
    """Plain torch version: int64 arithmetic masked to 32 bits
    (`ops/hash_partition.flat_hash32`), then the unsigned modulo."""
    from hyperspace_tpu_torch.ops.hash_partition import flat_hash32

    _check(lanes, num_buckets)
    h = flat_hash32(list(lanes.unbind(0)))
    return torch.remainder(h, int(num_buckets)).to(torch.int32)


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from hyperspace_tpu_torch.ops.cuda import build

        fn = build.load("hash_buckets").hs_hash_lanes_to_buckets
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def hash_cost(lanes: torch.Tensor, num_buckets: int):
    """Modeled (operations, bytes accessed) of one call, for the device
    seam (`telemetry/compilation.py`): each of the L int32 lanes read
    once and the int32 ids written once, n·(4L+4) bytes; 20 integer
    operations per lane per row."""
    n_lanes, n = int(lanes.shape[0]), int(lanes.shape[1])
    return HASH_OPS_PER_LANE * n_lanes * n, n * (4 * n_lanes + 4)


def _hash_lanes_to_buckets(lanes: torch.Tensor,
                           num_buckets: int) -> torch.Tensor:
    """lanes: contiguous [L, n] int32 tensor of uint32 bit patterns (lane 0
    seeds the hash, further lanes hash-combine). Returns int32 [n] bucket
    ids in [0, num_buckets), on the lanes' device. A CUDA tensor launches
    the kernel (and counts one launch); a CPU tensor runs the plain
    version."""
    _check(lanes, num_buckets)
    if lanes.device.type == "cpu":
        return hash_lanes_to_buckets_reference(lanes, num_buckets)
    if lanes.device.type != "cuda":
        raise HyperspaceException(
            f"hash_lanes_to_buckets: unsupported device {lanes.device}")
    if not lanes.is_contiguous():
        raise HyperspaceException("hash lanes must be contiguous [L, n].")
    n_lanes, n = int(lanes.shape[0]), int(lanes.shape[1])
    out = torch.empty(n, dtype=torch.int32, device=lanes.device)
    if n == 0:
        return out
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(lanes.device).cuda_stream
    with torch.cuda.device(lanes.device):
        status = fn(lanes.data_ptr(), n_lanes, n, int(num_buckets),
                    out.data_ptr(), stream)
    from hyperspace_tpu_torch.ops.cuda.build import check
    check(status, "hash_lanes_to_buckets")
    hash_lanes_to_buckets.launches += 1
    return out


# The entry point, through the device seam: device seconds and modeled
# bytes per call. `.launches` counts kernel launches (CUDA tensors only).
hash_lanes_to_buckets = instrumented_device(
    "cuda.hash_lanes_to_buckets", _hash_lanes_to_buckets, cost=hash_cost)
hash_lanes_to_buckets.launches = 0
