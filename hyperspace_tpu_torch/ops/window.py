"""Window functions over partitions: rank / dense_rank / row_number and
aggregates (sum/avg/min/max/count), appended as columns with the input
row order preserved.

The reference delegates windows to Spark SQL; here they compile to the
same sorted-segment machinery aggregation uses: ONE stable sort keyed
(partition lanes, order lanes), segment ids from partition-lane change
flags, rank family via cumulative max/sum over tie-run flags, partition
aggregates as segment reductions broadcast back through the segment ids,
and an inverse permutation restoring input order. Host batches run the
numpy lane (the JAX package's host mirror, line for line); device
batches stay torch tensors on their device end to end.

Frames follow SQL/Spark defaults: an aggregate WITHOUT order_by is
whole-partition; WITH order_by it is the running frame
`RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW` — cumulative over
the partition, peers (order-key ties) included. Running sum/avg/count
ride a segment-rebased cumsum; running min/max and float sums a
segmented log-step (Hillis-Steele) prefix scan, on both lanes; the
peer-run last index maps the row frame onto the RANGE frame.

SQL semantics: NULL is its own partition/peer value (validity rides the
sort lanes); aggregates skip NULL inputs; a frame with zero non-null
inputs yields NULL for sum/avg/min/max and 0 for count.

Determinism: integer results (ranks, counts, integer sums, min/max) are
exact. Float64 partition sums reduce contiguous segments in a fixed order
(`torch.segment_reduce`); running float sums add along the doubling scan's
fixed tree — the same tree on both lanes, so the host and device lanes
give the same bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import (HOST_NP_DTYPES, ColumnBatch,
                                              DeviceColumn)
from hyperspace_tpu_torch.plan.schema import Schema

RANK_FUNCS = ("rank", "dense_rank", "row_number")
AGG_FUNCS = ("sum", "avg", "min", "max", "count")


def window_compute(batch: ColumnBatch, partition_by: Sequence[str],
                   order_by: Sequence[str], specs,
                   out_schema: Schema) -> ColumnBatch:
    """`specs` are AggSpec-shaped (func, column, alias). Returns `batch`
    with one appended column per spec, rows in the INPUT order."""
    if batch.is_host:
        return _host_window(batch, partition_by, order_by, specs, out_schema)
    return _device_window(batch, partition_by, order_by, specs, out_schema)


def _check_input(spec, src) -> None:
    if src is not None and src.is_string and spec.func != "count":
        raise HyperspaceException(
            f"Window {spec.func} over string column {spec.column} "
            "is not supported.")


# ---------------------------------------------------------------------------
# Device lane: torch tensors on the batch's device.
# ---------------------------------------------------------------------------

def _device_window(batch: ColumnBatch, partition_by, order_by, specs,
                   out_schema: Schema) -> ColumnBatch:
    from hyperspace_tpu_torch.ops.aggregate import (_TORCH_OF, _dtype_range,
                                                    _segment_sum_float)
    from hyperspace_tpu_torch.ops.keys import column_sort_lanes
    from hyperspace_tpu_torch.ops.sort import sort_permutation
    from hyperspace_tpu_torch.plan.nodes import sort_direction

    n = batch.num_rows
    device = batch.device
    if n == 0:
        columns = dict(batch.columns)
        for spec in specs:
            f = out_schema.field(spec.alias)
            columns[f.name] = DeviceColumn(
                torch.zeros(0, dtype=_TORCH_OF.get(f.dtype, torch.int64),
                            device=device), f.dtype)
        return ColumnBatch(out_schema, columns)

    by = list(partition_by) + list(order_by)
    iota = torch.arange(n, dtype=torch.int64, device=device)
    perm = sort_permutation(batch, by) if by else iota
    sorted_batch = batch.take(perm)

    def change_flags(names):
        """True where any of `names`'s sort lanes differ from the previous
        sorted row (a '-' descending prefix does not matter for
        equality)."""
        changed = torch.zeros(n - 1, dtype=torch.bool, device=device)
        for spec_name in names:
            name, _ = sort_direction(spec_name)
            for lane in column_sort_lanes(sorted_batch.column(name)):
                changed |= lane[1:] != lane[:-1]
        return changed

    first = torch.ones(1, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    seg_flag = torch.cat([first, change_flags(partition_by)])
    seg_ids = torch.cumsum(seg_flag.to(torch.int64), 0) - 1
    # First row index of each row's segment, broadcast per row.
    seg_first = torch.cummax(torch.where(seg_flag, iota, zero), 0).values

    agg_needed = [s for s in specs if s.func in AGG_FUNCS]
    running = bool(order_by) and bool(agg_needed)
    rank_needed = any(s.func in RANK_FUNCS and s.func != "row_number"
                      for s in specs)
    if rank_needed or running:
        peer_flag = torch.cat([first, change_flags(by)])
        run_first = torch.cummax(torch.where(peer_flag, iota, zero),
                                 0).values
    if rank_needed:
        dense = torch.cumsum(peer_flag.to(torch.int64), 0)
    if running:
        # Last sorted index of each row's peer run: the next peer-run
        # start (a reversed cumulative min over start positions, shifted)
        # minus one.
        starts = torch.where(peer_flag, iota, torch.full_like(iota, n))
        suffmin = torch.flip(torch.cummin(torch.flip(starts, [0]), 0).values,
                             [0])
        run_last = torch.cat([suffmin[1:], starts.new_full((1,), n)]) - 1

    if agg_needed and not running:
        num_segs = int(seg_ids[-1]) + 1  # one host sync, shared by all specs
        lengths = torch.bincount(seg_ids, minlength=num_segs)

        def seg_sum(x):
            if x.dtype.is_floating_point:
                return _segment_sum_float(x, lengths)
            return torch.zeros(num_segs, dtype=x.dtype,
                               device=device).index_add_(0, seg_ids, x)

        def seg_extreme(x, func):
            lo, hi = _dtype_range(x.dtype)
            return torch.full((num_segs,), hi if func == "min" else lo,
                              dtype=x.dtype, device=device).scatter_reduce_(
                0, seg_ids, x, "amin" if func == "min" else "amax")

    out_sorted = {}
    for spec in specs:
        if spec.func == "row_number":
            out_sorted[spec.alias] = DeviceColumn(iota - seg_first + 1,
                                                  "int64")
            continue
        if spec.func == "rank":
            out_sorted[spec.alias] = DeviceColumn(run_first - seg_first + 1,
                                                  "int64")
            continue
        if spec.func == "dense_rank":
            out_sorted[spec.alias] = DeviceColumn(
                dense - dense[seg_first] + 1, "int64")
            continue
        f = out_schema.field(spec.alias)
        out_dtype = _TORCH_OF.get(f.dtype, torch.int64)
        src = sorted_batch.column(spec.column) if spec.column != "*" else None
        _check_input(spec, src)
        if running:
            if spec.func == "count" and spec.column == "*":
                out_sorted[spec.alias] = DeviceColumn(
                    run_last - seg_first + 1, "int64")
                continue
            valid = (src.validity if src.validity is not None
                     else torch.ones(n, dtype=torch.bool, device=device))
            rcounts = _running_sum(valid.to(torch.int64), seg_first)[run_last]
            if spec.func == "count":
                out_sorted[spec.alias] = DeviceColumn(rcounts, "int64")
                continue
            values = src.data
            if spec.func in ("sum", "avg"):
                acc = (torch.float64 if (f.dtype == "float64"
                                         or spec.func == "avg")
                       else torch.int64)
                masked = torch.where(valid, values, 0).to(acc)
                # Integer sums: exact global-cumsum rebase. Float sums:
                # segmented scan — rebasing subtracts the WHOLE preceding
                # prefix, which cancels catastrophically when an earlier
                # partition's magnitude dwarfs this one's values.
                if acc == torch.int64:
                    row_sum = _running_sum(masked, seg_first)
                else:
                    row_sum = _running_scan(masked, seg_ids, "add")
                rtotal = row_sum[run_last]
                r = (rtotal if spec.func == "sum"
                     else rtotal.to(torch.float64) / rcounts.clamp(min=1))
            else:
                lo, hi = _dtype_range(values.dtype)
                fill = torch.full((), hi if spec.func == "min" else lo,
                                  dtype=values.dtype, device=device)
                r = _running_scan(torch.where(valid, values, fill), seg_ids,
                                  spec.func)[run_last]
            out_sorted[spec.alias] = DeviceColumn(
                r.to(out_dtype), f.dtype, validity=rcounts > 0)
            continue
        # Whole-partition: segment-reduce, broadcast back.
        if spec.func == "count" and spec.column == "*":
            out_sorted[spec.alias] = DeviceColumn(lengths[seg_ids], "int64")
            continue
        valid = (src.validity if src.validity is not None
                 else torch.ones(n, dtype=torch.bool, device=device))
        counts = seg_sum(valid.to(torch.int64))
        if spec.func == "count":
            out_sorted[spec.alias] = DeviceColumn(counts[seg_ids], "int64")
            continue
        values = src.data
        if spec.func in ("sum", "avg"):
            acc = torch.float64 if f.dtype == "float64" else torch.int64
            total = seg_sum(torch.where(valid, values, 0).to(acc))
            per_seg = (total if spec.func == "sum"
                       else total.to(torch.float64) / counts.clamp(min=1))
        else:
            lo, hi = _dtype_range(values.dtype)
            fill = torch.full((), hi if spec.func == "min" else lo,
                              dtype=values.dtype, device=device)
            per_seg = seg_extreme(torch.where(valid, values, fill), spec.func)
        out_sorted[spec.alias] = DeviceColumn(
            per_seg[seg_ids].to(out_dtype), f.dtype,
            validity=(counts > 0)[seg_ids])

    # Inverse permutation: out[perm[i]] = sorted_val[i].
    inv = torch.empty(n, dtype=torch.int64, device=device)
    inv[perm] = iota
    columns = dict(batch.columns)
    for spec in specs:
        col = out_sorted[spec.alias]
        f = out_schema.field(spec.alias)
        columns[f.name] = DeviceColumn(
            col.data[inv], col.dtype,
            validity=None if col.validity is None else col.validity[inv])
    return ColumnBatch(out_schema, columns)


def _running_sum(x: torch.Tensor, seg_first: torch.Tensor) -> torch.Tensor:
    """Segment-rebased INCLUSIVE cumsum: at sorted row i, the sum of x
    over [segment start, i]. Exact for integer accumulators (one global
    cumsum minus the value just before each segment's start)."""
    g = torch.cumsum(x, 0)
    return g - (g[seg_first] - x[seg_first])


def _running_scan(x: torch.Tensor, seg_ids: torch.Tensor,
                  func: str) -> torch.Tensor:
    """Segmented inclusive prefix min/max/sum: log-step (Hillis-Steele)
    passes, each combining a row with the row `k` before it when both lie
    in one segment — ceil(log2 n) passes of `torch.where`. Values are
    never offset by segment id (floats have no room for it)."""
    op = {"min": torch.minimum, "max": torch.maximum, "add": torch.add}[func]
    n = x.shape[0]
    out = x.clone()
    k = 1
    while k < n:
        same = torch.zeros(n, dtype=torch.bool, device=x.device)
        same[k:] = seg_ids[k:] == seg_ids[:-k]
        prev = torch.cat([out[:k], out[:-k]])
        out = torch.where(same, op(out, prev), out)
        k *= 2
    return out


# ---------------------------------------------------------------------------
# Host lane: numpy, the JAX package's host mirror line for line.
# ---------------------------------------------------------------------------

def _host_window(batch: ColumnBatch, partition_by, order_by, specs,
                 out_schema: Schema) -> ColumnBatch:
    from hyperspace_tpu_torch.ops.keys import host_column_sort_lanes
    from hyperspace_tpu_torch.ops.sort import sort_permutation
    from hyperspace_tpu_torch.plan.nodes import sort_direction

    n = batch.num_rows
    if n == 0:
        columns = dict(batch.columns)
        for spec in specs:
            f = out_schema.field(spec.alias)
            columns[f.name] = DeviceColumn(
                np.zeros(0, dtype=HOST_NP_DTYPES.get(f.dtype, np.int64)),
                f.dtype)
        return ColumnBatch(out_schema, columns)

    by = list(partition_by) + list(order_by)
    perm = sort_permutation(batch, by) if by else np.arange(n,
                                                            dtype=np.int32)
    sorted_batch = batch.take(perm)

    def change_flags(names):
        changed = np.zeros(max(n - 1, 0), dtype=bool)
        for spec_name in names:
            name, _ = sort_direction(spec_name)
            for lane in host_column_sort_lanes(sorted_batch.column(name)):
                lane = np.asarray(lane)
                changed = changed | (lane[1:] != lane[:-1])
        return changed

    first = np.ones(1, dtype=bool)
    seg_flag = np.concatenate([first, change_flags(partition_by)])
    seg_ids = (np.cumsum(seg_flag.astype(np.int32)) - 1).astype(np.int32)
    iota = np.arange(n, dtype=np.int64)
    seg_first = np.maximum.accumulate(np.where(seg_flag, iota, 0))

    agg_needed = [s for s in specs if s.func in AGG_FUNCS]
    running = bool(order_by) and bool(agg_needed)
    rank_needed = any(s.func in RANK_FUNCS and s.func != "row_number"
                      for s in specs)
    if rank_needed or running:
        peer_flag = np.concatenate([first, change_flags(by)])
        run_first = np.maximum.accumulate(np.where(peer_flag, iota, 0))
    if rank_needed:
        dense = np.cumsum(peer_flag.astype(np.int64))
    if running:
        starts = np.where(peer_flag, iota, n)
        suffmin = np.minimum.accumulate(starts[::-1])[::-1]
        run_last = np.concatenate(
            [suffmin[1:], np.full(1, n, dtype=starts.dtype)]) - 1
    if agg_needed and not running:
        # seg_ids are sorted-contiguous, so reduceat applies — and keeps
        # int64 sums exact.
        seg_starts = np.searchsorted(seg_ids, np.arange(int(seg_ids[-1]) + 1),
                                     "left")

    out_sorted = {}
    for spec in specs:
        if spec.func == "row_number":
            out_sorted[spec.alias] = DeviceColumn(
                (iota - seg_first + 1).astype(np.int64), "int64")
            continue
        if spec.func == "rank":
            out_sorted[spec.alias] = DeviceColumn(
                (run_first - seg_first + 1).astype(np.int64), "int64")
            continue
        if spec.func == "dense_rank":
            out_sorted[spec.alias] = DeviceColumn(
                (dense - dense[seg_first] + 1).astype(np.int64), "int64")
            continue
        f = out_schema.field(spec.alias)
        out_np = HOST_NP_DTYPES.get(f.dtype, np.int64)
        src = sorted_batch.column(spec.column) if spec.column != "*" else None
        _check_input(spec, src)
        if running:
            if spec.func == "count" and spec.column == "*":
                out_sorted[spec.alias] = DeviceColumn(
                    (run_last - seg_first + 1).astype(np.int64), "int64")
                continue
            valid = (np.asarray(src.validity) if src.validity is not None
                     else np.ones(n, dtype=bool))
            rcounts = _host_running_sum(valid.astype(np.int64),
                                        seg_first)[run_last]
            if spec.func == "count":
                out_sorted[spec.alias] = DeviceColumn(rcounts, "int64")
                continue
            values = np.asarray(src.data)
            if spec.func in ("sum", "avg"):
                acc = np.float64 if (f.dtype == "float64"
                                     or spec.func == "avg") else np.int64
                masked = np.where(valid, values, 0).astype(acc)
                if acc is np.int64:
                    row_sum = _host_running_sum(masked, seg_first)
                else:
                    row_sum = _host_running_scan(masked, seg_ids, "add")
                rtotal = row_sum[run_last]
                r = (rtotal if spec.func == "sum"
                     else rtotal.astype(np.float64) / np.maximum(rcounts, 1))
            else:
                fill = _host_fill(values.dtype, spec.func)
                r = _host_running_scan(np.where(valid, values, fill),
                                       seg_ids, spec.func)[run_last]
            out_sorted[spec.alias] = DeviceColumn(
                r.astype(out_np), f.dtype, validity=rcounts > 0)
            continue
        if spec.func == "count" and spec.column == "*":
            per_seg = np.add.reduceat(np.ones(n, dtype=np.int64), seg_starts)
            out_sorted[spec.alias] = DeviceColumn(per_seg[seg_ids], "int64")
            continue
        valid = (np.asarray(src.validity) if src.validity is not None
                 else np.ones(n, dtype=bool))
        counts = np.add.reduceat(valid.astype(np.int64), seg_starts)
        if spec.func == "count":
            out_sorted[spec.alias] = DeviceColumn(counts[seg_ids], "int64")
            continue
        values = np.asarray(src.data)
        if spec.func in ("sum", "avg"):
            acc = np.float64 if f.dtype == "float64" else np.int64
            total = np.add.reduceat(np.where(valid, values, 0).astype(acc),
                                    seg_starts)
            per_seg = (total if spec.func == "sum"
                       else total.astype(np.float64) / np.maximum(counts, 1))
        else:
            ufunc = np.minimum if spec.func == "min" else np.maximum
            per_seg = ufunc.reduceat(
                np.where(valid, values, _host_fill(values.dtype, spec.func)),
                seg_starts)
        out_sorted[spec.alias] = DeviceColumn(
            per_seg[seg_ids].astype(out_np), f.dtype,
            validity=(counts > 0)[seg_ids])

    inv = np.empty(n, dtype=np.int32)
    inv[np.asarray(perm)] = np.arange(n, dtype=np.int32)
    columns = dict(batch.columns)
    for spec in specs:
        col = out_sorted[spec.alias]
        f = out_schema.field(spec.alias)
        columns[f.name] = DeviceColumn(
            col.data[inv], col.dtype,
            validity=None if col.validity is None else col.validity[inv])
    return ColumnBatch(out_schema, columns)


def _host_fill(dtype, func: str):
    """The identity of min (the type's largest value) or max (its
    smallest) for a numpy dtype."""
    if dtype.kind == "f":
        return np.inf if func == "min" else -np.inf
    info = np.iinfo(dtype)
    return info.max if func == "min" else info.min


def _host_running_sum(x: np.ndarray, seg_first: np.ndarray) -> np.ndarray:
    g = np.cumsum(x)
    return g - (g[seg_first] - x[seg_first])


def _host_running_scan(x: np.ndarray, seg_ids: np.ndarray,
                       func: str) -> np.ndarray:
    op = {"min": np.minimum, "max": np.maximum, "add": np.add}[func]
    n = x.shape[0]
    out = np.asarray(x).copy()
    k = 1
    while k < n:
        same = np.concatenate([np.zeros(k, dtype=bool),
                               seg_ids[k:] == seg_ids[:-k]])
        prev = np.concatenate([out[:k], out[:-k]])
        out = np.where(same, op(out, prev), out)
        k *= 2
    return out
