"""Bucketed sort-merge join over concat-in-bucket-order sides.

Both sides hash-bucket by the same keys (THE bucket hash identity), so
equal key tuples always share a bucket and the GLOBAL match set equals the
per-bucket one. The device lane therefore runs the global counting join
(`ops/join.counting_join_batch_indices`): one flat sort + cumulative
counting, no per-bucket loop, skew-immune by construction. The host lane
keeps the per-bucket `searchsorted` over the already-sorted index layout
(`ops/join.host_bucketed_join_indices`).

SQL null semantics ride the join's null-marker lane: null keys match
nothing. In outer joins an index of -1 gathers as a null row
(`_gather_side`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn


def bucketed_join_indices(left: ColumnBatch, right: ColumnBatch,
                          l_lengths: np.ndarray, r_lengths: np.ndarray,
                          left_keys: Sequence[str],
                          right_keys: Sequence[str],
                          how: str = "inner") -> Tuple:
    """Join row-index pairs for two sides stored concat-in-bucket-order with
    the given per-bucket lengths. `how` is inner or left_outer (unmatched
    left rows appear once with right index -1). numpy pairs on the host
    lane, int64 tensors on the device lane."""
    from hyperspace_tpu_torch.ops.join import (counting_join_batch_indices,
                                               host_bucketed_join_indices)

    if left.is_host and right.is_host:
        empty = np.zeros(0, dtype=np.int32)
        if left.num_rows == 0 or (right.num_rows == 0 and how != "left_outer"):
            return empty, empty
        if right.num_rows == 0:
            return (np.arange(left.num_rows, dtype=np.int32),
                    np.full(left.num_rows, -1, dtype=np.int32))
        return host_bucketed_join_indices(
            left, right, np.asarray(l_lengths), np.asarray(r_lengths),
            left_keys, right_keys, how=how)
    return counting_join_batch_indices(left, right, left_keys, right_keys,
                                       how=how)


def _gather_side(batch: ColumnBatch, idx, names, may_unmatch: bool = True):
    """Gather `names` columns of rows by index; index -1 (unmatched outer
    row) yields null. `may_unmatch=False` (inner-join sides) skips the
    unmatched handling."""
    narrowed = batch.select(names)
    if not may_unmatch or idx.shape[0] == 0:
        return narrowed.take(idx)
    unmatched = idx < 0
    clipped = (np.clip(idx, 0, None) if isinstance(idx, np.ndarray)
               else torch.clamp(idx, min=0))
    out = narrowed.take(clipped)
    columns = {}
    for name, col in out.columns.items():
        validity = (col.validity & ~unmatched
                    if col.validity is not None else ~unmatched)
        columns[name] = DeviceColumn(col.data, col.dtype, validity,
                                     col.dictionary, col.dict_hashes)
    return ColumnBatch(out.schema, columns)


def join_output_plan(left_schema, right_schema, columns):
    """THE join output-naming contract: [(out_name, side, src, dtype)]
    where side is "l"/"r". Left names are kept; right-side collisions get
    a `_r` suffix; `columns` (lowered OUTPUT names) late-projects. A
    consumer needing no columns at all still needs the row count, which a
    ColumnBatch carries only through its columns — one is kept."""
    left_names = {f.name.lower() for f in left_schema.fields}
    plan = []
    for f in left_schema.fields:
        if columns is None or f.name.lower() in columns:
            plan.append((f.name, "l", f.name, f.dtype))
    for f in right_schema.fields:
        out = f.name if f.name.lower() not in left_names else f.name + "_r"
        if columns is None or out.lower() in columns:
            plan.append((out, "r", f.name, f.dtype))
    if not plan:
        f = left_schema.fields[0]
        plan.append((f.name, "l", f.name, f.dtype))
    return plan


def assemble_join_output(left: ColumnBatch, right: ColumnBatch,
                         li, ri, how: str = "left_outer",
                         columns=None) -> ColumnBatch:
    """Gather both sides by index pairs into the joined batch; -1 on either
    side (unmatched outer row) yields null columns for that side. `how`
    statically bounds which sides can hold -1, so no data-dependent sync
    is needed. `columns` (lowered OUTPUT names) enables late projection:
    only the listed output columns are gathered."""
    from hyperspace_tpu_torch.plan.schema import Field, Schema

    plan = join_output_plan(left.schema, right.schema, columns)
    lwanted = [src for _, side, src, _ in plan if side == "l"]
    rwanted = [src for _, side, src, _ in plan if side == "r"]
    left_out = _gather_side(left, li, lwanted,
                            may_unmatch=how in ("right_outer", "full_outer"))
    right_out = _gather_side(right, ri, rwanted,
                             may_unmatch=how in ("left_outer", "full_outer"))
    fields = []
    out_columns = {}
    for out, side, src, dtype in plan:
        if side == "l":
            fields.append(Field(out, dtype,
                                left.schema.field(src).nullable
                                or how in ("right_outer", "full_outer")))
            out_columns[out] = left_out.columns[src]
        else:
            fields.append(Field(out, dtype, True))
            out_columns[out] = right_out.columns[src]
    return ColumnBatch(Schema(fields), out_columns)


def bucketed_sort_merge_join(left: ColumnBatch, right: ColumnBatch,
                             l_lengths: np.ndarray, r_lengths: np.ndarray,
                             left_keys: Sequence[str],
                             right_keys: Sequence[str],
                             how: str = "inner",
                             columns=None) -> ColumnBatch:
    """Full bucketed join over concat-in-bucket-order sides. full_outer =
    the left_outer expansion plus one appended row per unmatched right
    row (both sides share one hash layout, so membership is global)."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.ops.join import (_cat_pair,
                                               unmatched_right_from_indices)

    telemetry.annotate(join_buckets=len(np.asarray(l_lengths)),
                       left_rows=left.num_rows, right_rows=right.num_rows)
    if how == "right_outer":
        ri, li = bucketed_join_indices(right, left, r_lengths, l_lengths,
                                       right_keys, left_keys,
                                       how="left_outer")
    else:
        li, ri = bucketed_join_indices(
            left, right, l_lengths, r_lengths, left_keys, right_keys,
            how="left_outer" if how == "full_outer" else how)
        if how == "full_outer":
            li, ri = _cat_pair(li, ri, unmatched_right_from_indices(
                ri, right.num_rows))
    return assemble_join_output(left, right, li, ri, how=how,
                                columns=columns)
