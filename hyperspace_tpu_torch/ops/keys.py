"""Sort-key transforms: everything becomes 32-bit lanes, order preserved.

Sorting and hashing decompose every key column into one or two 32-bit
lanes whose lexicographic order equals the source order, exactly as the
JAX package does (the on-disk layout depends on the lanes):

- int64  -> (hi: signed 32-bit — sign order preserved,
             lo: unsigned 32-bit — unsigned order of the low word)
- float64 -> order-preserving bit transform (negatives: all bits flipped;
             positives: sign bit set) -> 64 bits -> (hi, lo) unsigned
- float32 -> same transform -> one unsigned lane
- int32/int16/int8/bool/date32 -> one signed lane
- string -> dictionary code (int32; order-preserving by construction)

Torch has no full uint32 arithmetic, so a lane's dtype carries its
signedness: a SIGNED lane is an int32 tensor; an UNSIGNED lane is an int64
tensor holding the zero-extended value in [0, 2^32). Sorting either dtype
orders rows as the 32-bit lane does, and `lane & 0xFFFFFFFF` (in int64) is
the uint32 bit pattern the hash reads. `ops/hash_partition.py` mixes the
same lanes, so hashing and sorting share one decomposition.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import DeviceColumn

MASK32 = 0xFFFFFFFF


def _float_order_bits(data: torch.Tensor) -> torch.Tensor:
    """IEEE total-order transform as an int64 tensor of the unsigned
    result's bit pattern (float64: all 64 bits; float32: zero-extended).

    Floats are normalized first — -0.0 -> +0.0 and every NaN bit pattern
    -> one canonical quiet NaN — so sort order, bucket hash, and key
    identity agree with numeric equality on every lane (NaNs group
    together and sort last)."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    data = torch.where(data == 0, zero, data)
    data = torch.where(torch.isnan(data),
                       torch.full((), float("nan"), dtype=data.dtype,
                                  device=data.device), data)
    if data.dtype == torch.float64:
        bits = data.view(torch.int64)
        # negative (sign bit set): flip every bit; else set the sign bit
        return torch.where(bits < 0, ~bits, bits ^ torch.iinfo(torch.int64).min)
    bits = data.view(torch.int32).to(torch.int64) & MASK32
    return torch.where(bits >= 1 << 31, bits ^ MASK32, bits | (1 << 31))


def key_lanes(data: torch.Tensor) -> List[torch.Tensor]:
    """Decompose one key tensor into order-preserving 32-bit lanes (int32
    = signed lane, int64 = zero-extended unsigned lane)."""
    dtype = data.dtype
    if dtype == torch.int64:
        return [(data >> 32).to(torch.int32), data & MASK32]
    if dtype == torch.float64:
        bits = _float_order_bits(data)
        return [(bits >> 32) & MASK32, bits & MASK32]
    if dtype == torch.float32:
        return [_float_order_bits(data)]
    if dtype in (torch.bool, torch.int8, torch.int16, torch.int32):
        return [data.to(torch.int32)]
    return [data]


def column_sort_lanes(col: DeviceColumn) -> List[torch.Tensor]:
    """32-bit sort lanes for a column; validity (nulls-first) leads."""
    lanes: List[torch.Tensor] = []
    if col.validity is not None:
        lanes.append(col.validity)
    lanes.extend(key_lanes(col.data))
    return lanes


def lexsort_permutation(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation over `operands` (primary key
    first), as int64 row indices: one stable `torch.sort` per operand,
    least significant first, each pass gathering the keys through the
    permutation so far. The composition equals one stable multi-key sort
    (the JAX package's `lax.sort(..., num_keys=k, is_stable=True)`)."""
    n = operands[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for lane in reversed(operands):
        key = lane[perm]
        if key.dtype == torch.bool:
            key = key.to(torch.int32)
        order = torch.sort(key, stable=True).indices
        perm = perm[order]
    return perm


def staged_sort(operands: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(permutation, sorted operands): the stable lexicographic sort of
    `operands` (primary key first) — the JAX package's `_staged_sort`,
    whose chunked LSD passes become `lexsort_permutation`'s one stable
    pass per operand."""
    perm = lexsort_permutation(operands)
    return perm, [op[perm] for op in operands]


def host_dense_group_ids(keys) -> Tuple[np.ndarray, np.ndarray]:
    """Stable dense group encoding on the host: a stable sort over the
    key arrays (primary key first), then adjacent-difference ids in
    sorted order. Returns (perm, sorted_group_ids); original-order ids
    are `out[perm] = sorted_group_ids`. The permutation comes from the
    native radix lane when the keys decompose to packable lanes, else
    `np.lexsort`. Both are stable and agree for int/bool/string keys;
    float keys only agree up to NaN placement (the native lane orders by
    the normalized total-order bits, np.lexsort puts every NaN last), as
    in the JAX package. Group CONTENT is the same either way."""
    keys = [np.asarray(k) for k in keys]
    perm = None
    n = len(keys[0]) if keys else 0
    if keys and n:
        from hyperspace_tpu_torch import native
        lanes: Optional[List] = []
        for k in keys:
            if k.dtype == np.object_ or k.dtype.kind == "U":
                lanes = None
                break
            lanes.extend(host_key_lanes(k))
        if lanes is not None:
            perm = native.key_sort_perm(n, lanes)
    if perm is None:
        perm = np.lexsort(tuple(reversed(keys)))
    n = len(perm)
    differs = np.zeros(n, dtype=np.int32)
    for k in keys:
        ks = k[perm]
        differs[1:] |= (ks[1:] != ks[:-1]).astype(np.int32)
    return perm, np.cumsum(differs, dtype=np.int32)


def host_key_lanes(data) -> List:
    """Host (numpy) mirror of `key_lanes` with the JAX package's lane
    dtypes (int32 signed, uint32 unsigned), for the adaptive host lane."""
    dtype = data.dtype
    if dtype == np.int64:
        return [(data >> 32).astype(np.int32),
                (data & 0xFFFFFFFF).astype(np.uint32)]
    if dtype == np.float64:
        from hyperspace_tpu_torch.ops.host_hash import _float_order_bits
        bits = _float_order_bits(data, np.uint64, 64)
        return [(bits >> np.uint64(32)).astype(np.uint32),
                (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    if dtype == np.float32:
        from hyperspace_tpu_torch.ops.host_hash import _float_order_bits
        return [_float_order_bits(data, np.uint32, 32)]
    if dtype == np.bool_:
        return [data.astype(np.int32)]
    if dtype in (np.int8, np.int16, np.int32):
        return [data.astype(np.int32)]
    return [data]


def host_column_sort_lanes(col: DeviceColumn) -> List:
    lanes: List = []
    if col.validity is not None:
        lanes.append(col.validity)
    lanes.extend(host_key_lanes(col.data))
    return lanes
