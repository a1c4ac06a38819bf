"""Mesh-sharded group-by aggregation: partial aggregation per shard, one
small combine on the host.

The reference delegates aggregation to Spark's partial/final aggregate
pairs over the cluster; the JAX package runs SPMD partials under
`shard_map` into fixed-capacity slot tables. The port's controller runs
each shard's partials on that shard's device, sized exactly (one host
read of every shard's group count takes the place of the JAX overflow
check). Shards split rows exactly as the JAX package does
(`parallel/scan.shard_batch`), so float sums group the same way. Only
the per-shard partials cross to the host, where numpy merges them by key
— combinable forms: count/sum -> sum, min/max -> min/max, avg -> (sum,
count), stddev -> (count, sum, M2) merged by the exact variance
decomposition  M2_tot = sum M2_i + sum cnt_i (mean_i - anchor)^2  with
the anchor at the global mean (the JAX `_combine_partials`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn
from hyperspace_tpu_torch.ops.keys import lexsort_permutation
from hyperspace_tpu_torch.parallel.mesh import Mesh, total_shards
from hyperspace_tpu_torch.parallel.scan import shard_batch
from hyperspace_tpu_torch.plan.nodes import AggSpec
from hyperspace_tpu_torch.plan.schema import Schema
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device


def _sorted_segments(lanes: List[torch.Tensor], valid: torch.Tensor):
    """(perm, seg, valid_sorted): the stable sort of one shard's rows by
    [invalid, *lanes] — padding rows last — and each sorted row's local
    group id."""
    perm = lexsort_permutation([~valid, *lanes])
    n = valid.shape[0]
    differs = torch.zeros(n, dtype=torch.int64, device=valid.device)
    for k in (~valid, *lanes):
        ks = k[perm]
        differs[1:] |= (ks[1:] != ks[:-1]).to(torch.int64)
    return perm, torch.cumsum(differs, 0), valid[perm]


def _shard_partials(lanes, valid, values, specs_meta, perm, seg,
                    valid_sorted, groups: int) -> Dict[str, torch.Tensor]:
    """One shard's [groups] partial tables. `values[j]` is the (data,
    mask) pair of spec j (None for count(*))."""
    n = valid.shape[0]
    dev = valid.device
    slot = torch.where(valid_sorted, seg,
                       torch.full_like(seg, groups))

    def seg_sum(x):
        out = torch.zeros(groups + 1, dtype=x.dtype, device=dev)
        return out.index_add_(0, slot, x)[:groups]

    def seg_reduce(x, how, fill):
        out = torch.full((groups + 1,), fill, dtype=x.dtype, device=dev)
        return out.scatter_reduce_(0, slot, x, how,
                                   include_self=True)[:groups]

    firsts = torch.searchsorted(
        seg, torch.arange(groups, dtype=seg.dtype, device=dev))
    firsts = torch.clamp(firsts, 0, max(n - 1, 0))
    out = {f"key{i}": lane[perm][firsts] for i, lane in enumerate(lanes)}
    out["rows"] = seg_sum(valid_sorted.to(torch.int64))
    out["first_perm"] = perm[firsts]
    for j, (func, _nullable) in enumerate(specs_meta):
        if func == "count_star":
            continue  # rows covers it
        data, mask = values[j]
        v = data[perm]
        m = mask[perm] & valid_sorted
        cnt = seg_sum(m.to(torch.int64))
        out[f"cnt{j}"] = cnt
        if func == "count":
            continue
        # Integer aggregates accumulate in int64 — float64 would lose
        # exactness past 2^53.
        is_float = v.dtype.is_floating_point
        acc = torch.float64 if is_float else torch.int64
        if func in ("sum", "avg"):
            out[f"s1{j}"] = seg_sum(torch.where(m, v, 0).to(acc))
        elif func == "min":
            big = (float("inf") if is_float
                   else torch.iinfo(torch.int64).max)
            out[f"mn{j}"] = seg_reduce(
                torch.where(m, v.to(acc), big), "amin", big)
        elif func == "max":
            small = (float("-inf") if is_float
                     else torch.iinfo(torch.int64).min)
            out[f"mx{j}"] = seg_reduce(
                torch.where(m, v.to(acc), small), "amax", small)
        elif func == "stddev":
            x = torch.where(m, v, 0).to(torch.float64)
            s1 = seg_sum(x)
            mu = s1 / torch.clamp(cnt.to(torch.float64), min=1)
            centre = mu[torch.clamp(slot, 0, max(groups - 1, 0))]
            dev_x = torch.where(m, x - centre, 0.0)
            out[f"s1{j}"] = s1
            out[f"m2{j}"] = seg_sum(dev_x * dev_x)
    return out


def _group_count(seg: torch.Tensor, valid_sorted: torch.Tensor):
    """A shard's number of groups among its valid rows (which sort
    first): the segment starts that hold a valid row."""
    starts = torch.ones_like(valid_sorted)
    starts[1:] = seg[1:] != seg[:-1]
    return (starts & valid_sorted).sum()


def _partials_step(valids: List[torch.Tensor], lanes: List[List],
                   values: List[List], specs_meta: Tuple
                   ) -> Tuple[List[Dict[str, np.ndarray]], float]:
    """Every shard's sort and segment ids, one host read of every
    shard's group count, then every shard's partial tables, fetched to
    the host. `valids` are the per-shard row masks (`shard_batch`'s, or
    a born-sharded batch's, which any filter may have narrowed).
    Returns (per-shard partials, count-read seconds)."""
    sorted_ = [_sorted_segments(ln, v) for ln, v in zip(lanes, valids)]
    home = valids[0].device
    t0 = time.perf_counter()
    groups = torch.stack([_group_count(seg, valid).to(home)
                          for _perm, seg, valid in sorted_]).tolist()
    sync_s = time.perf_counter() - t0
    parts = [_shard_partials(lanes[s], valids[s], values[s], specs_meta,
                             perm, seg, valid_sorted, int(groups[s]))
             for s, (perm, seg, valid_sorted) in enumerate(sorted_)]
    from hyperspace_tpu_torch.io import transfer

    engine = transfer.get_engine()
    for part in parts:
        engine.prefetch(*part.values())
    return [{k: engine.fetch(v) for k, v in part.items()}
            for part in parts], sync_s


partials_step = instrumented_device("mesh.aggregate_step", _partials_step)


def distributed_group_aggregate(batch: ColumnBatch,
                                group_columns: Sequence[str],
                                aggregates: Sequence[AggSpec],
                                out_schema: Schema, mesh: Mesh,
                                pre_sharded=None) -> ColumnBatch:
    """Partial aggregation over the mesh + host combine; the result is a
    host batch. Requires at least one group column (global aggregates
    are cheap on one device).

    `pre_sharded` = (per-shard batches, per-shard row masks) of a
    born-sharded input (`parallel/spmd.py`) skips the placement: the
    partials read the resident shards, and `batch` is their flat
    concatenation (shard s's row i is row s*C + i), from which the
    representative group rows are gathered."""
    if not group_columns:
        raise HyperspaceException(
            "distributed aggregation requires group columns")
    from hyperspace_tpu_torch import telemetry
    n_shards = total_shards(mesh)
    reg = telemetry.get_registry()
    reg.counter("mesh.aggregate.execs").inc()
    reg.counter("mesh.aggregate.overflow_retries")  # registered; never moves
    telemetry.event("mesh", "aggregate", shards=n_shards,
                    rows=batch.num_rows, groups=len(group_columns))
    with telemetry.span("mesh:aggregate", "mesh", rows=batch.num_rows,
                        shards=n_shards):
        return _distributed_group_aggregate(
            batch, group_columns, aggregates, out_schema, mesh, reg,
            pre_sharded)


def _distributed_group_aggregate(batch, group_columns, aggregates,
                                 out_schema, mesh, reg, pre_sharded):
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.ops.keys import column_sort_lanes

    shards, row_valid = (pre_sharded if pre_sharded is not None
                         else shard_batch(batch, mesh))
    specs_meta = []
    for spec in aggregates:
        if spec.func == "count" and spec.column == "*":
            specs_meta.append(("count_star", False))
            continue
        col = batch.column(spec.column)
        if col.is_string and spec.func != "count":
            raise HyperspaceException(
                f"Aggregate {spec.func} over string column {spec.column}")
        specs_meta.append((spec.func, col.validity is not None))
    lanes, values = [], []
    for shard, valid in zip(shards, row_valid):
        shard_lanes = []
        for name in group_columns:
            shard_lanes.extend(column_sort_lanes(shard.column(name)))
        lanes.append(shard_lanes)
        shard_values = []
        for spec, (func, _n) in zip(aggregates, specs_meta):
            if func == "count_star":
                shard_values.append(None)
                continue
            col = shard.column(spec.column)
            shard_values.append((col.data, col.validity
                                 if col.validity is not None
                                 else torch.ones_like(valid)))
        values.append(shard_values)
    parts, sync_s = partials_step(row_valid, lanes, values,
                                  tuple(specs_meta))
    reg.counter("mesh.aggregate.sync_s").inc(sync_s)
    telemetry.add_seconds("mesh.sync_s", sync_s)
    local = int(row_valid[0].shape[0])
    return _combine_partials(batch, parts, group_columns, aggregates,
                             specs_meta, out_schema,
                             len(lanes[0]), local)


def _combine_partials(batch, parts, group_columns, aggregates, specs_meta,
                      out_schema, num_lanes, local):
    from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES as _HOST_NP
    from hyperspace_tpu_torch.ops.keys import host_dense_group_ids

    def cat(name):
        return np.concatenate([p[name] for p in parts])

    rows = cat("rows")
    used = rows > 0  # an empty shard contributes no group
    keys = [cat(f"key{i}")[used] for i in range(num_lanes)]
    order, seg = host_dense_group_ids(keys)
    num_groups = int(seg[-1]) + 1 if len(seg) else 0
    starts = np.searchsorted(seg, np.arange(num_groups), side="left")

    def fold(name):
        return cat(name)[used][order]

    # Representative original row per group (for the group-key VALUES):
    # shard s's local index i is global row s*local + i.
    first_global = np.concatenate([
        p["first_perm"].astype(np.int64) + s * local
        for s, p in enumerate(parts)])[used][order]
    group_first = np.minimum(first_global[starts], batch.num_rows - 1)
    if batch.is_host:
        rep = batch.take(group_first)
    else:
        rep = batch.take(torch.as_tensor(group_first, device=batch.device))

    columns = {}
    for name in group_columns:
        src = rep.column(name)
        f = batch.schema.field(name)
        columns[f.name] = DeviceColumn(
            data=_host(src.data), dtype=src.dtype,
            validity=(_host(src.validity)
                      if src.validity is not None else None),
            dictionary=src.dictionary,
            dict_hashes=(tuple(_host(h).astype(np.uint32)
                               for h in src.dict_hashes)
                         if src.dict_hashes is not None else None))

    rows_sorted = rows[used][order]
    for j, spec in enumerate(aggregates):
        out_field = out_schema.field(spec.alias)
        if specs_meta[j][0] == "count_star":
            data = np.add.reduceat(rows_sorted, starts).astype(np.int64)
            columns[out_field.name] = DeviceColumn(data, "int64")
            continue
        cnt = fold(f"cnt{j}")
        cnt_tot = np.add.reduceat(cnt, starts).astype(np.int64)
        if spec.func == "count":
            columns[out_field.name] = DeviceColumn(cnt_tot, "int64")
            continue
        validity_out = cnt_tot > 0
        safe_cnt = np.maximum(cnt_tot.astype(np.float64), 1)
        if spec.func in ("sum", "avg"):
            s1_tot = np.add.reduceat(fold(f"s1{j}"), starts)
            data = s1_tot if spec.func == "sum" else s1_tot / safe_cnt
        elif spec.func == "min":
            data = np.minimum.reduceat(fold(f"mn{j}"), starts)
        elif spec.func == "max":
            data = np.maximum.reduceat(fold(f"mx{j}"), starts)
        else:  # stddev: exact variance decomposition around the global mean
            s1 = fold(f"s1{j}")
            m2 = fold(f"m2{j}")
            s1_tot = np.add.reduceat(s1, starts)
            anchor = s1_tot / safe_cnt
            cnt_f = cnt.astype(np.float64)
            shard_mean = np.divide(s1, np.maximum(cnt_f, 1))
            shift = cnt_f * (shard_mean
                             - np.repeat(anchor, np.diff(
                                 np.append(starts, len(s1))))) ** 2
            m2_tot = np.add.reduceat(m2 + shift, starts)
            data = np.sqrt(np.maximum(
                m2_tot / np.maximum(safe_cnt - 1, 1), 0.0))
            validity_out = cnt_tot > 1
        columns[out_field.name] = DeviceColumn(
            data.astype(_HOST_NP[out_field.dtype]), out_field.dtype,
            validity=validity_out)
    return ColumnBatch(out_schema, columns)


def _host(arr):
    return arr if isinstance(arr, np.ndarray) else arr.cpu().numpy()
