"""Group-by aggregation: sort-based segment reductions.

The reference leaves aggregation to Spark SQL's hash/sort aggregates; here
groups are formed by ONE stable multi-key sort of the group-key lanes
(`ops/keys.py`), segments by adjacent differences, and every aggregate
reduces contiguous segments — one host sync (the group count) sizes the
output. Wide groupings sort one 64-bit hash lane instead and fall back to
the full sort when a hash collision splits a group.

Reductions are deterministic: the same query over the same data gives the
same bits on every run. Integer sums, counts, min and max are exact, so
their scatter order cannot show; float64 sums and means reduce each
contiguous segment with `torch.segment_reduce`, which adds in a fixed
order (no atomics).

SQL null semantics: sum/min/max/avg ignore null inputs; count(col) counts
non-null; count(*) counts rows; a group whose inputs are all null yields
null (validity False) for sum/min/max/avg and 0 for count.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import (HOST_NP_DTYPES, ColumnBatch,
                                              DeviceColumn)
from hyperspace_tpu_torch.plan.nodes import AggSpec
from hyperspace_tpu_torch.plan.schema import Schema

_TORCH_OF = {"int64": torch.int64, "float64": torch.float64,
             "int32": torch.int32, "float32": torch.float32,
             "int8": torch.int8, "int16": torch.int16, "bool": torch.bool,
             "date32": torch.int32, "timestamp": torch.int64,
             "string": torch.int32}

_INT64_SIGN = -(1 << 63)

# Wide groupings pay one stable sort pass per lane. From this lane count
# up the HASHED phase sorts ONE 64-bit hash lane instead and verifies that
# no collision split a group (fallback: the full sort). A 64-bit hash over
# ~10^7 rows makes the fallback astronomically rare; correctness never
# depends on it.
HASH_GROUP_MIN_LANES = 5


def _segment_ids(sorted_lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sorted-space segment ids: the running count of rows whose lanes
    differ from the previous row's."""
    n = sorted_lanes[0].shape[0]
    differs = torch.zeros(n, dtype=torch.int64, device=sorted_lanes[0].device)
    for k in sorted_lanes:
        differs[1:] |= (k[1:] != k[:-1]).to(torch.int64)
    return torch.cumsum(differs, 0)


def _group_phase_a(operands):
    """(sort permutation, sorted-space segment ids) of the group-key lanes:
    a stable lexicographic sort, then adjacent-difference segmenting over
    the sorted lanes."""
    from hyperspace_tpu_torch.ops.keys import staged_sort

    perm, sorted_ops = staged_sort(operands)
    return perm, _segment_ids(sorted_ops)


def _group_phase_a_hashed(operands):
    """(perm, segment ids, packed) via ONE 64-bit hash-lane sort. Equal
    keys share a hash, so a stable hash sort puts every group in one
    contiguous run unless two DIFFERENT keys collide; the collision flag is
    set iff a full-lane group boundary falls INSIDE an equal-hash run —
    exactly the split-group case. `packed` carries (num_segments - 1,
    collision) in one int64 scalar so the caller's sizing sync is a single
    read. The hash is unsigned: its int64 bit pattern sorts in unsigned
    order once the sign bit is flipped."""
    from hyperspace_tpu_torch.ops.hash_partition import dual_hash64

    h = dual_hash64(operands) ^ _INT64_SIGN
    perm = torch.sort(h, stable=True).indices
    segment_ids = _segment_ids([k[perm] for k in operands])
    h_s = h[perm]
    boundary = segment_ids[1:] != segment_ids[:-1]
    collision = torch.any(boundary & (h_s[1:] == h_s[:-1]))
    packed = segment_ids[-1] * 2 + collision.to(torch.int64)
    return perm, segment_ids, packed


def _segment_sum_float(values: torch.Tensor, lengths: torch.Tensor):
    """Per-segment float64 sums of contiguous segments, in a fixed order
    on every run."""
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)


def _empty_result(batch: ColumnBatch, group_columns: Sequence[str],
                  aggregates: Sequence[AggSpec],
                  out_schema: Schema) -> ColumnBatch:
    """Aggregation over zero rows, in the batch's residence. SQL: a GLOBAL
    aggregate over zero rows is ONE row — count/count_distinct 0,
    everything else NULL (the cross-join scalar-assembly queries rely on
    this); a grouped one is zero rows."""
    host = batch.is_host
    device = batch.device

    def zeros(n, dtype):
        if host:
            return np.zeros(n, dtype=HOST_NP_DTYPES[dtype])
        return torch.zeros(n, dtype=_TORCH_OF[dtype], device=device)

    columns: Dict[str, DeviceColumn] = {}
    if not group_columns:
        for spec in aggregates:
            f = out_schema.field(spec.alias)
            if (spec.column != "*" and batch.column(spec.column).is_string
                    and spec.func not in ("count", "count_distinct")):
                raise HyperspaceException(
                    f"Aggregate {spec.func} over string column "
                    f"{spec.column} is not supported.")
            if spec.func in ("count", "count_distinct"):
                columns[f.name] = DeviceColumn(zeros(1, "int64"), "int64")
            else:
                columns[f.name] = DeviceColumn(zeros(1, f.dtype), f.dtype,
                                               validity=zeros(1, "bool"))
        return ColumnBatch(out_schema, columns)
    group_names = {batch.schema.field(c).name for c in group_columns}
    for f in out_schema.fields:
        src = batch.column(f.name) if f.name in group_names else None
        columns[f.name] = DeviceColumn(
            data=zeros(0, f.dtype), dtype=f.dtype,
            dictionary=src.dictionary if src is not None else None,
            dict_hashes=src.dict_hashes if src is not None else None)
    return ColumnBatch(out_schema, columns)


def group_aggregate(batch: ColumnBatch, group_columns: Sequence[str],
                    aggregates: Sequence[AggSpec],
                    out_schema: Schema) -> ColumnBatch:
    """Group `batch` by `group_columns` and compute `aggregates` (plain
    column inputs, or "*" for count) into `out_schema`: group keys first,
    then one column per aggregate. Host batches aggregate with numpy,
    device batches with torch on their device. Groups come out in
    sorted-key order (hash order for wide groupings on the device)."""
    n = batch.num_rows
    if n == 0:
        return _empty_result(batch, group_columns, aggregates, out_schema)
    if batch.is_host:
        return _host_group_aggregate(batch, group_columns, aggregates,
                                     out_schema)
    from hyperspace_tpu_torch.ops.keys import column_sort_lanes

    device = batch.device
    if group_columns:
        operands: List[torch.Tensor] = []
        for name in group_columns:
            operands.extend(column_sort_lanes(batch.column(name)))
        if len(operands) >= HASH_GROUP_MIN_LANES:
            perm, segment_ids, packed = _group_phase_a_hashed(operands)
            with telemetry.span("sync:aggregate.groups", "device_wait"):
                packed = int(packed)  # the one host sync
            if packed & 1:  # a hash collision split a group: exact re-run
                perm, segment_ids = _group_phase_a(operands)
                with telemetry.span("sync:aggregate.groups",
                                    "device_wait"):
                    num_groups = int(segment_ids[-1]) + 1
            else:
                num_groups = (packed >> 1) + 1
        else:
            perm, segment_ids = _group_phase_a(operands)
            with telemetry.span("sync:aggregate.groups", "device_wait"):
                num_groups = int(segment_ids[-1]) + 1  # the one host sync
        sorted_batch = batch.take(perm)
        # The representative row (first of each segment) carries the keys.
        firsts = torch.searchsorted(
            segment_ids, torch.arange(num_groups, device=device))
    else:
        segment_ids = torch.zeros(n, dtype=torch.int64, device=device)
        num_groups = 1
        sorted_batch = batch
        firsts = torch.zeros(1, dtype=torch.int64, device=device)
    # bincount sizes its output from the ids' maximum: a host read.
    with telemetry.span("sync:aggregate.bincount", "device_wait"):
        rows_per_group = torch.bincount(segment_ids, minlength=num_groups)

    columns: Dict[str, DeviceColumn] = {}
    for name in group_columns:
        src = sorted_batch.column(name)
        f = batch.schema.field(name)
        columns[f.name] = DeviceColumn(
            data=src.data[firsts], dtype=src.dtype,
            validity=(src.validity[firsts]
                      if src.validity is not None else None),
            dictionary=src.dictionary, dict_hashes=src.dict_hashes)

    def segment_sum_int(values):
        return torch.zeros(num_groups, dtype=torch.int64,
                           device=device).index_add_(0, segment_ids, values)

    for spec in aggregates:
        out_field = out_schema.field(spec.alias)
        if spec.func == "count" and spec.column == "*":
            columns[out_field.name] = DeviceColumn(rows_per_group, "int64")
            continue
        src = sorted_batch.column(spec.column)
        if src.is_string and spec.func not in ("count", "count_distinct"):
            raise HyperspaceException(
                f"Aggregate {spec.func} over string column {spec.column} "
                "is not supported.")
        valid = src.validity
        counts = (rows_per_group if valid is None
                  else segment_sum_int(valid.to(torch.int64)))
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=device)
        if spec.func == "count":
            columns[out_field.name] = DeviceColumn(counts, "int64")
            continue
        if spec.func == "count_distinct":
            # Distinct non-null values per group: ONE more stable sort keyed
            # (segment, invalid-last, *value lanes), then count run starts
            # at valid rows. Strings count by dictionary code (dictionaries
            # are sorted+unique, so code identity is value identity); nulls
            # sort after the valid block so a shared masked value can never
            # swallow a valid run start.
            from hyperspace_tpu_torch.ops.keys import staged_sort
            lanes = column_sort_lanes(src)
            invalid = (~valid).to(torch.int32)
            _, (seg_s, inv_s, *lanes_s) = staged_sort(
                [segment_ids, invalid, *lanes])
            differs = seg_s[1:] != seg_s[:-1]
            for lane in lanes_s:
                differs = differs | (lane[1:] != lane[:-1])
            run_start = torch.cat([differs.new_ones(1), differs])
            columns[out_field.name] = DeviceColumn(
                torch.zeros(num_groups, dtype=torch.int64,
                            device=device).index_add_(
                    0, seg_s, (run_start & (inv_s == 0)).to(torch.int64)),
                "int64")
            continue
        values = src.data
        validity_out = counts > 0
        if spec.func in ("sum", "avg"):
            if out_field.dtype == "float64":
                x = torch.where(valid, values, 0).to(torch.float64)
                total = _segment_sum_float(x, rows_per_group)
            else:
                total = segment_sum_int(
                    torch.where(valid, values, 0).to(torch.int64))
            data = (total if spec.func == "sum"
                    else total.to(torch.float64) / counts.clamp(min=1))
        elif spec.func == "stddev":
            # Sample stddev (SQL stddev_samp) via TWO passes: per-group
            # mean, then squared deviations — the one-pass sum-of-squares
            # identity catastrophically cancels in float64 when
            # mean^2 >> variance. Null when fewer than 2 non-null inputs.
            x = torch.where(valid, values, 0).to(torch.float64)
            cnt = counts.to(torch.float64)
            mu = _segment_sum_float(x, rows_per_group) / cnt.clamp(min=1)
            dev = torch.where(valid, x - mu[segment_ids], 0.0)
            var = (_segment_sum_float(dev * dev, rows_per_group)
                   / (cnt - 1).clamp(min=1))
            data = torch.sqrt(var.clamp(min=0.0))
            validity_out = counts > 1
        else:  # min / max: exact, so scatter order cannot show
            lo, hi = _dtype_range(values.dtype)
            fill = hi if spec.func == "min" else lo
            data = torch.full((num_groups,), fill, dtype=values.dtype,
                              device=device).scatter_reduce_(
                0, segment_ids,
                torch.where(valid, values,
                            torch.full((), fill, dtype=values.dtype,
                                       device=device)),
                "amin" if spec.func == "min" else "amax")
        # Validity is attached unconditionally: deciding with a check of
        # `validity_out` would cost one more sync per aggregate; an
        # all-True mask is semantically identical.
        columns[out_field.name] = DeviceColumn(
            data.to(_TORCH_OF[out_field.dtype]), out_field.dtype,
            validity=validity_out)
    return ColumnBatch(out_schema, columns)


def _dtype_range(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf"), float("inf")
    if dtype == torch.bool:
        return False, True
    info = torch.iinfo(dtype)
    return info.min, info.max


def _host_group_aggregate(batch: ColumnBatch,
                          group_columns: Sequence[str],
                          aggregates: Sequence[AggSpec],
                          out_schema: Schema) -> ColumnBatch:
    """Host-lane (numpy) mirror of the device aggregation: same grouping
    (stable lexicographic sort, nulls first) and the same SQL null
    semantics, with contiguous-segment `ufunc.reduceat` reductions."""
    from hyperspace_tpu_torch.ops.keys import (host_column_sort_lanes,
                                               host_dense_group_ids)

    n = batch.num_rows
    if group_columns:
        operands = []
        for name in group_columns:
            operands.extend(host_column_sort_lanes(batch.column(name)))
        perm, segment_ids = host_dense_group_ids(operands)
        perm = perm.astype(np.int32)
        num_groups = int(segment_ids[-1]) + 1
        sorted_batch = batch.take(perm)
        starts = np.searchsorted(segment_ids, np.arange(num_groups),
                                 side="left")
    else:
        segment_ids = np.zeros(n, dtype=np.int32)
        num_groups = 1
        sorted_batch = batch
        starts = np.zeros(1, dtype=np.int64)

    columns = {}
    for name in group_columns:
        src = sorted_batch.column(name)
        f = batch.schema.field(name)
        columns[f.name] = DeviceColumn(
            data=np.asarray(src.data)[starts], dtype=src.dtype,
            validity=(np.asarray(src.validity)[starts]
                      if src.validity is not None else None),
            dictionary=src.dictionary, dict_hashes=src.dict_hashes)

    for spec in aggregates:
        out_field = out_schema.field(spec.alias)
        if spec.func == "count" and spec.column == "*":
            data = np.bincount(segment_ids,
                               minlength=num_groups).astype(np.int64)
            columns[out_field.name] = DeviceColumn(data, "int64")
            continue
        src = sorted_batch.column(spec.column)
        if src.is_string and spec.func not in ("count", "count_distinct"):
            raise HyperspaceException(
                f"Aggregate {spec.func} over string column {spec.column} "
                "is not supported.")
        valid = (np.asarray(src.validity) if src.validity is not None
                 else np.ones(n, dtype=bool))
        counts = np.bincount(segment_ids, weights=valid,
                             minlength=num_groups).astype(np.int64)
        if spec.func == "count":
            columns[out_field.name] = DeviceColumn(counts, "int64")
            continue
        if spec.func == "count_distinct":
            # Mirror of the device lane: lexsort (segment, invalid-last,
            # *value lanes), count run starts at valid rows.
            lanes = [np.asarray(lane)
                     for lane in host_column_sort_lanes(src)]
            inv = (~valid).astype(np.int8)
            order = np.lexsort(tuple(reversed(
                [segment_ids, inv] + lanes)))
            seg_s = segment_ids[order]
            differs = seg_s[1:] != seg_s[:-1]
            for lane in lanes:
                lane_s = lane[order]
                differs = differs | (lane_s[1:] != lane_s[:-1])
            run_start = np.concatenate([[True], differs])
            data = np.bincount(
                seg_s, weights=(run_start & valid[order]),
                minlength=num_groups).astype(np.int64)
            columns[out_field.name] = DeviceColumn(data, "int64")
            continue
        values = np.asarray(src.data)
        validity_out = counts > 0
        if spec.func in ("sum", "avg"):
            acc = (np.float64 if out_field.dtype == "float64" else np.int64)
            total = np.add.reduceat(
                np.where(valid, values, 0).astype(acc), starts)
            data = (total if spec.func == "sum"
                    else total.astype(np.float64) / np.maximum(counts, 1))
        elif spec.func == "stddev":
            # Two-pass shifted variance; see the device lane for why the
            # one-pass identity is numerically unsafe.
            x = np.where(valid, values, 0).astype(np.float64)
            cnt = counts.astype(np.float64)
            mu = np.add.reduceat(x, starts) / np.maximum(cnt, 1)
            dev = np.where(valid, x - mu[segment_ids], 0.0)
            var = np.add.reduceat(dev * dev, starts) / np.maximum(
                cnt - 1, 1)
            data = np.sqrt(np.maximum(var, 0.0))
            validity_out = counts > 1
        elif spec.func == "min":
            big = (np.inf if np.issubdtype(values.dtype, np.floating)
                   else np.iinfo(values.dtype).max)
            data = np.minimum.reduceat(np.where(valid, values, big), starts)
        else:  # max
            small = (-np.inf if np.issubdtype(values.dtype, np.floating)
                     else np.iinfo(values.dtype).min)
            data = np.maximum.reduceat(np.where(valid, values, small), starts)
        columns[out_field.name] = DeviceColumn(
            data.astype(HOST_NP_DTYPES[out_field.dtype]), out_field.dtype,
            validity=validity_out)
    return ColumnBatch(out_schema, columns)
