"""Hash partitioning on tensors: column values -> bucket ids.

Bucket ids are computed with 32-bit murmur-style mixing over the key
columns' 32-bit lanes (`ops/keys.py`); rows are then grouped by one stable
sort (`ops/build.py`). This module is the plain torch statement of THE
hash identity; the build's hot path runs the same chain in the CUDA kernel
`csrc/hash_buckets.cu` (`ops/cuda/hash_kernel.py`).

Hash identity rules (shared bit for bit with the JAX package, because the
on-disk bucket layout depends on them):
- Numeric columns hash their *bit pattern* (int64 is mixed as two 32-bit
  halves; floats through their order-preserving bit transform).
- String columns hash their *value* via the per-dictionary-entry hashes
  computed at encode time (`io/columnar.py`), gathered by code — stable
  across batches with different dictionaries.
- Nulls hash to 0.

Torch on the CPU has no uint32 shifts, adds or remainders, so the chain
runs in int64 masked to 32 bits after every step. Multiplies split the
32-bit constant into 16-bit halves so no product reaches 2^63.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn
from hyperspace_tpu_torch.ops.keys import MASK32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): each partial product stays
    below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on a uint32 value held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _combine(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """boost-style hash_combine on uint32 values held in int64."""
    return h1 ^ ((h2 + 0x9E3779B9 + ((h1 << 6) & MASK32) + (h1 >> 2))
                 & MASK32)


def _u32(lane: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of a 32-bit lane, as int64."""
    return lane.to(torch.int64) & MASK32


def flat_hash32(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """THE hash identity: fmix32 of the first lane, then hash-combine of
    each further lane's fmix32, over the FLAT concatenation of all key
    columns' lanes in key order. Returns the uint32 hash as int64. The
    CUDA kernel (`csrc/hash_buckets.cu`) and the host mirror
    (`ops/host_hash.py`) MUST agree with it — on-disk bucket layout
    depends on it."""
    h = _fmix32(_u32(lanes[0]))
    for lane in lanes[1:]:
        h = _combine(h, _fmix32(_u32(lane)))
    return h


def _as_u32(lane: torch.Tensor) -> torch.Tensor:
    """Order-preserving uint32 form (as int64) of a sort lane: signed
    (int32) lanes are biased by 2^31, unsigned ones pass through."""
    if lane.dtype == torch.bool:
        return lane.to(torch.int64)
    if lane.dtype in (torch.int8, torch.int16, torch.int32):
        return _u32(lane) ^ 0x80000000
    return _u32(lane)


def dual_hash64(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """u64 hash per row from two independent 32-bit mixes over the
    order-preserving uint32 forms of the given sort lanes — the hash
    identity of the JAX package's hashed group/match fast paths. Returned
    as int64 holding the same 64-bit pattern (h1 << 32 | h2)."""
    u0 = _as_u32(lanes[0])
    h1 = _fmix32(u0)
    h2 = _fmix32(u0 ^ 0x6A09E667)
    for lane in lanes[1:]:
        u = _as_u32(lane)
        h1 = _combine(h1, _fmix32(u))
        h2 = _combine(h2, _fmix32(u ^ 0x6A09E667))
    # h1 as signed 32-bit, so the shift stays inside int64
    h1 = h1 - ((h1 >> 31) << 32)
    return (h1 << 32) | h2


def column_hash_lanes(col: DeviceColumn) -> List[torch.Tensor]:
    """The column's hash-input lanes (32-bit lanes, `ops/keys.py`
    convention). Strings contribute their gathered per-dictionary-entry
    value hashes (hi, lo); numerics their order-preserving key lanes.
    Null rows contribute all-zero lanes."""
    from hyperspace_tpu_torch.ops.keys import key_lanes

    if col.is_string:
        hi, lo = col.dict_hashes
        codes = col.data.to(torch.int64)
        lanes = [hi[codes], lo[codes]]
    else:
        lanes = key_lanes(col.data)
    if col.validity is not None:
        lanes = [torch.where(col.validity, lane, torch.zeros_like(lane))
                 for lane in lanes]
    return lanes


def batch_hash32(batch: ColumnBatch, key_columns: Sequence[str]
                 ) -> torch.Tensor:
    """Combined per-row uint32 hash (as int64) over the key columns, in
    order."""
    if not key_columns:
        raise HyperspaceException("Hash partitioning requires key columns.")
    lanes: List[torch.Tensor] = []
    for name in key_columns:
        lanes.extend(column_hash_lanes(batch.column(name)))
    return flat_hash32(lanes)


def bucket_ids(batch: ColumnBatch, key_columns: Sequence[str],
               num_buckets: int) -> torch.Tensor:
    """Per-row bucket assignment in [0, num_buckets) as int32."""
    h = batch_hash32(batch, key_columns)
    return torch.remainder(h, int(num_buckets)).to(torch.int32)
