"""Stable multi-key (lexicographic) sort, and top-k (ORDER BY + LIMIT).

Every sort key decomposes to 32-bit order-preserving lanes
(`ops/keys.py`); the lanes sort as one stable lexicographic sort — on the
device lane as stable `torch.sort` passes, least significant lane first
(`keys.lexsort_permutation`, the JAX package's one multi-operand
`lax.sort`); on the host lane with `np.lexsort` — and the permutation is
gathered across every payload column.

Order semantics: ascending, nulls first (validity participates as the
leading sub-key for nullable columns; False < True places nulls ahead).
A descending key inverts the unsigned bits of each of its lanes — the
validity lane too, which puts nulls last (Spark's default for descending
keys). String columns sort by dictionary code, which is order-preserving
because dictionaries are sorted at encode time (`io/columnar.py`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import ColumnBatch, batch_to_host
from hyperspace_tpu_torch.ops.keys import MASK32
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device


def _as_u32(lane):
    """Order-preserving unsigned 32-bit form of a sort lane: numpy uint32
    on the host lane; on the device lane an int64 tensor holding the
    value in [0, 2^32) (`ops/keys.py` lane convention). Signed lanes
    reinterpret their bits and flip the sign bit."""
    if isinstance(lane, np.ndarray):
        if lane.dtype == np.bool_:
            return lane.astype(np.uint32)
        if np.issubdtype(lane.dtype, np.signedinteger):
            return lane.astype(np.int32).view(np.uint32) \
                ^ np.uint32(0x80000000)
        return lane.astype(np.uint32)
    from hyperspace_tpu_torch.ops.hash_partition import _as_u32 as _u32
    return _u32(lane)


def _descend(lane):
    """A sort lane's DESCENDING-order equivalent: its unsigned
    order-preserving form with every bit inverted. Applied to the validity
    lane too, which flips null placement to nulls-last."""
    if isinstance(lane, np.ndarray):
        return ~_as_u32(lane)
    return _as_u32(lane) ^ MASK32


def _key_operands(batch: ColumnBatch, by: Sequence[str]) -> List:
    """The sort lanes of the `by` specs, in order, descending ones
    inverted (host or device lanes, following the batch)."""
    from hyperspace_tpu_torch.ops.keys import (column_sort_lanes,
                                               host_column_sort_lanes)
    from hyperspace_tpu_torch.plan.nodes import sort_direction
    lanes_of = host_column_sort_lanes if batch.is_host else column_sort_lanes
    operands = []
    for spec in by:
        name, desc = sort_direction(spec)
        lanes = lanes_of(batch.column(name))
        if desc:
            lanes = [_descend(lane) for lane in lanes]
        operands.extend(lanes)
    return operands


def sort_permutation(batch: ColumnBatch, by: Sequence[str]):
    """Stable lexicographic sort permutation by `by` columns. Host-lane
    batches sort on the host — the native radix lane, else `np.lexsort`
    (both stable, the same permutation) — and return a numpy int32
    permutation; device batches a tensor of row indices."""
    operands = _key_operands(batch, by)
    if batch.is_host:
        # Native radix lane first (the C++ kernel is stable over packed
        # u64 words, like lexsort).
        from hyperspace_tpu_torch import native
        perm = native.key_sort_perm(batch.num_rows, operands)
        if perm is not None:
            return perm
        # np.lexsort's primary key is the LAST operand.
        return np.lexsort(tuple(reversed(operands))).astype(np.int32)
    from hyperspace_tpu_torch.ops.keys import lexsort_permutation
    return lexsort_permutation(operands)


def sort_batch(batch: ColumnBatch, by: Sequence[str]) -> ColumnBatch:
    return batch.take(sort_permutation(batch, by))


# ---------------------------------------------------------------------------
# Top-k (ORDER BY + LIMIT collapsed): the full wide sort is wasted work
# when only k rows survive. The device path builds ONE packed 64-bit
# prefix of the first two sort lanes, finds the k-th smallest prefix,
# keeps the candidate rows (every true top-k row has prefix <= that
# threshold, since > means at least k rows order strictly before it), and
# finishes with an exact full-key host sort of the small candidate set.
# Ties only ever grow the candidate set, never drop a winner.
# ---------------------------------------------------------------------------

# Candidate sets beyond this fall back to the full sort (low-cardinality
# leading keys: the threshold no longer prunes).
TOPK_CANDIDATE_CAP = 1 << 21


def _topk_threshold_cost(prefix: torch.Tensor, k: int):
    """Modeled (operations, bytes accessed) for the device seam: the
    int64 prefix read once, the bool mask and the int64 count written
    once; one comparison and one add per row (the k-selection's own
    comparisons are not modeled)."""
    n = int(prefix.numel())
    return 2 * n, 8 * n + n + 8


@instrumented_device("sort.topk_threshold", cost=_topk_threshold_cost)
def _topk_threshold(prefix: torch.Tensor, k: int):
    """(mask, count) for rows whose packed prefix is <= the k-th smallest
    prefix value. `prefix` holds unsigned 64-bit values with the sign bit
    flipped, so signed int64 order is the unsigned order."""
    thresh = torch.topk(prefix, k, largest=False, sorted=False).values.max()
    mask = prefix <= thresh
    return mask, mask.sum()


def topk_batch(batch: ColumnBatch, by: Sequence[str], n: int) -> ColumnBatch:
    """First `n` rows of `batch` ordered by `by` (stable, identical to
    sort_batch(...)[:n]).

    Residency contract (downstream lane selection keys on `is_host`):
    - host input -> HOST output (pure numpy path);
    - device input, threshold path -> HOST output: the candidate set is
      pulled to the host for the exact full-key finish, and at <= n +
      ties rows re-uploading it would only pay the link again;
    - device input, candidate-cap fallback (low-cardinality prefix; see
      TOPK_CANDIDATE_CAP) -> DEVICE output from the full device sort.
    The fallback is recorded as a telemetry event
    (`topk.candidate-cap-fallback`) so lane surprises stay diagnosable."""
    if n == 0:
        return batch.take(np.empty(0, dtype=np.int32) if batch.is_host
                          else torch.empty(0, dtype=torch.int64,
                                           device=batch.device))
    if batch.num_rows <= n:
        return sort_batch(batch, by)
    if batch.is_host:
        return batch.take(sort_permutation(batch, by)[:n])

    # Only the first two prefix lanes are consumed; building every lane of
    # a wide ORDER BY would waste dispatches.
    operands = _key_operands(batch, list(by)[:2])
    # (u0 << 32 | u1) with its sign bit flipped, built without overflow:
    # the high word biased into the signed range, the low word OR-ed in.
    prefix = (_as_u32(operands[0]) - (1 << 31)) << 32
    if len(operands) > 1:
        prefix = prefix | _as_u32(operands[1])
    mask, count_dev = _topk_threshold(prefix, n)
    count = int(count_dev)  # the one sizing sync
    if count > max(TOPK_CANDIDATE_CAP, 4 * n):
        from hyperspace_tpu_torch import telemetry
        telemetry.event("topk", "candidate-cap-fallback",
                        candidates=count, n=n, rows=batch.num_rows,
                        residency="device")
        full = sort_batch(batch, by)
        return full.take(torch.arange(n, device=batch.device))
    cand = batch_to_host(batch.take(torch.nonzero(mask).squeeze(1)))
    return cand.take(sort_permutation(cand, by)[:n])
