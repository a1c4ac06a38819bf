"""Index-build core on tensors: hash -> bucket -> one stable sort.

The build computes, on the device, each row's bucket id from its key
columns (the CUDA kernel `csrc/hash_buckets.cu` on the card) and one
stable (bucket, *keys) sort permutation over the KEY columns only; the
host applies the permutation to the payload and writes one file per
bucket (`io/builder.py`). Sort keys ride 32-bit lanes (`ops/keys.py`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from hyperspace_tpu_torch.io.columnar import ColumnBatch, batch_to_tree
from hyperspace_tpu_torch.ops import keys as keymod


def _tree_hash_lanes(entry: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Hash-input lanes of one column tree entry (mirrors
    `ops/hash_partition.column_hash_lanes` on raw tensors): strings gather
    their dictionary value hashes; numerics decompose into 32-bit key
    lanes; null rows contribute all-zero lanes. A `lo32` entry is the
    narrow transport of an int64 column whose hi lane is provably zero
    (host-checked range): the hash still mixes the canonical [hi, lo]
    lane chain — hi synthesized as zeros — so bucket ids are
    bit-identical to the wide path."""
    if "lo32" in entry:
        lo = entry["lo32"]
        return [torch.zeros_like(lo), lo]
    data = entry["data"]
    if "hash_hi" in entry:
        codes = data.to(torch.int64)
        lanes = [entry["hash_hi"][codes], entry["hash_lo"][codes]]
    else:
        lanes = keymod.key_lanes(data)
    if "validity" in entry:
        lanes = [torch.where(entry["validity"], lane, torch.zeros_like(lane))
                 for lane in lanes]
    return lanes


def _entry_sort_lanes(entry: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    if "lo32" in entry:
        # hi lane is constant zero -> order is fully determined by lo,
        # an unsigned lane: widen it to int64 (zero-extended) to sort.
        return [entry["lo32"].to(torch.int64) & keymod.MASK32]
    lanes: List[torch.Tensor] = []
    if "validity" in entry:
        lanes.append(entry["validity"])
    lanes.extend(keymod.key_lanes(entry["data"]))
    return lanes


def _tree_bucket_ids(tree, key_names: Sequence[str],
                     num_buckets: int) -> torch.Tensor:
    """Per-row int32 bucket ids over the FLAT lane chain (THE hash
    identity, `ops/hash_partition.flat_hash32`). On a CUDA tensor this
    launches the hand-written kernel; on the CPU its plain version runs."""
    from hyperspace_tpu_torch.ops.cuda.hash_kernel import (
        hash_lanes_to_buckets, stack_lanes)

    lanes: List[torch.Tensor] = []
    for name in key_names:
        lanes.extend(_tree_hash_lanes(tree[name]))
    return hash_lanes_to_buckets(stack_lanes(lanes), num_buckets)


def _perm_core(key_tree, key_names: Sequence[str], num_buckets: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Permutation-only build core: hash + ONE stable (bucket, *keys) sort
    over the KEY columns. Returns (int64 row permutation, per-bucket
    starts, per-bucket ends), all on the keys' device. The payload never
    touches the device."""
    bucket = _tree_bucket_ids(key_tree, key_names, num_buckets)
    operands = [bucket]
    for name in key_names:
        operands.extend(_entry_sort_lanes(key_tree[name]))
    perm = keymod.lexsort_permutation(operands)
    sorted_bucket = bucket[perm]
    buckets = torch.arange(num_buckets, dtype=torch.int32,
                           device=bucket.device)
    starts = torch.searchsorted(sorted_bucket, buckets, right=False)
    ends = torch.searchsorted(sorted_bucket, buckets, right=True)
    return perm, starts, ends


def permutation_from_tree(key_tree, key_names: Sequence[str],
                          num_buckets: int):
    """As `build_permutation` over an already-staged key tree."""
    return _perm_core(key_tree, tuple(key_names), num_buckets)


def build_permutation(batch: ColumnBatch, key_columns: Sequence[str],
                      num_buckets: int):
    """Device-computed sort permutation for a bucketed build. `batch` only
    needs the key columns resident. Returns (perm, starts, ends): the
    permutation gives the rows in (bucket, *keys) order; starts/ends are
    each bucket's row range in that order."""
    key_names = tuple(batch.schema.field(c).name for c in key_columns)
    tree, _aux = batch_to_tree(batch.select(key_names))
    return permutation_from_tree(tree, key_names, num_buckets)
