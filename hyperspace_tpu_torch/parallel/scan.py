"""Mesh-sharded predicate scan.

Reference rationale: `FilterIndexRule.scala:112-120` replaces the
relation with NO BucketSpec so the engine parallelizes the scan freely —
the filter path's parallelism axis is rows, not buckets. Here rows are
split over the mesh's shards (`shard_batch`) and the compiled predicate
runs on each shard; the controller reads every shard's selected count in
one sync, then each shard compacts its own rows and the pieces are
concatenated in shard order — so the result equals the single-device
`engine.compiler.apply_filter` bit for bit.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn
from hyperspace_tpu_torch.parallel.mesh import Mesh, total_shards


def _replicas(hashes, devices) -> Dict[torch.device, Tuple]:
    """One (hi, lo) int64 copy of a dictionary's value hashes per
    distinct device (host uint32 pairs widen, as `host_batch_to_device`
    does)."""
    out = {}
    for dev in devices:
        if dev in out:
            continue
        if isinstance(hashes[0], np.ndarray):
            out[dev] = tuple(torch.from_numpy(h.astype(np.int64)).to(dev)
                             for h in hashes)
        else:
            out[dev] = tuple(h.to(dev, non_blocking=True) for h in hashes)
    return out


def shard_batch(batch: ColumnBatch, mesh: Mesh
                ) -> Tuple[List[ColumnBatch], List[torch.Tensor]]:
    """Pad rows to a multiple of the shard count and split them: shard s
    holds rows `[s*L, (s+1)*L)` of the padded batch on `mesh.devices[s]`
    (the JAX package's row sharding). Returns (per-shard batches,
    per-shard row_valid masks) — padding rows are invalid and the caller
    excludes them.

    Host columns pad in numpy and cross the link through the transfer
    engine's sharded `put` (every shard's copy issued before the first
    wait, one h2d record per column); device columns pad on their device
    and each shard's slice moves with a non-blocking `.to`."""
    from hyperspace_tpu_torch.io import transfer

    n = batch.num_rows
    n_shards = total_shards(mesh)
    local = -(-n // n_shards)
    pad = local * n_shards - n
    engine = transfer.get_engine()

    def place(arr, fill) -> List[torch.Tensor]:
        if isinstance(arr, np.ndarray):
            if pad:
                arr = np.concatenate(
                    [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])
            return engine.put(arr, device=mesh)
        if pad:
            arr = torch.cat([arr, torch.full((pad,) + tuple(arr.shape[1:]),
                                             fill, dtype=arr.dtype,
                                             device=arr.device)])
        return [arr[s * local:(s + 1) * local].to(dev, non_blocking=True)
                for s, dev in enumerate(mesh.devices)]

    with telemetry.span("mesh:place", "mesh", rows=n, shards=n_shards):
        per_shard: List[Dict[str, DeviceColumn]] = [
            {} for _ in range(n_shards)]
        for name, col in batch.columns.items():
            data = place(col.data, 0)
            validity = (place(col.validity, False)
                        if col.validity is not None else [None] * n_shards)
            hashes = (_replicas(col.dict_hashes, mesh.devices)
                      if col.dict_hashes is not None else None)
            for s, dev in enumerate(mesh.devices):
                per_shard[s][name] = DeviceColumn(
                    data=data[s], dtype=col.dtype, validity=validity[s],
                    dictionary=col.dictionary,
                    dict_hashes=hashes[dev] if hashes is not None else None)
        row_valid = place(np.ones(n, dtype=bool), False)
    return [ColumnBatch(batch.schema, cols) for cols in per_shard], row_valid


def _compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The ascending indices of `mask`'s `count` True rows, without a
    host sync (the count is already known): each kept row scatters its
    index to its rank; dropped rows land in one spare slot."""
    if count == 0:
        return torch.zeros(0, dtype=torch.int64, device=mask.device)
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask, rank, torch.full_like(rank, count))
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


def concat_shards(pieces: List[ColumnBatch], schema,
                  home: torch.device) -> ColumnBatch:
    """Per-shard batches of one schema (shared dictionaries) concatenated
    in shard order on `home`."""
    columns = {}
    for f in schema.fields:
        cols = [p.columns[f.name] for p in pieces]
        first = cols[0]
        data = torch.cat([c.data.to(home, non_blocking=True) for c in cols])
        validity = (torch.cat([c.validity.to(home, non_blocking=True)
                               for c in cols])
                    if first.validity is not None else None)
        hashes = (tuple(h.to(home) for h in first.dict_hashes)
                  if first.dict_hashes is not None else None)
        columns[f.name] = DeviceColumn(data=data, dtype=first.dtype,
                                       validity=validity,
                                       dictionary=first.dictionary,
                                       dict_hashes=hashes)
    return ColumnBatch(schema, columns)


def distributed_filter(batch: ColumnBatch, expression,
                       mesh: Mesh) -> ColumnBatch:
    """Filter `batch` on the mesh; the result equals the single-device
    `engine.compiler.apply_filter` bit for bit and lies on the mesh's
    first device. The predicate runs shard by shard; one host sync reads
    every shard's count; the compaction gathers stay shard-local."""
    from hyperspace_tpu_torch.engine.compiler import compile_predicate

    n_shards = total_shards(mesh)
    home = mesh.devices[0]
    reg = telemetry.get_registry()
    with telemetry.span("mesh:filter", "mesh", rows=batch.num_rows,
                        shards=n_shards):
        shards, row_valid = shard_batch(batch, mesh)
        masks = [compile_predicate(expression, shard) & valid
                 for shard, valid in zip(shards, row_valid)]
        t0 = time.perf_counter()
        counts = torch.stack([m.sum().to(home) for m in masks]).tolist()
        sync_s = time.perf_counter() - t0
        count = int(sum(counts))
        reg.counter("mesh.filter.execs").inc()
        reg.counter("mesh.filter.sync_s").inc(sync_s)
        telemetry.add_seconds("mesh.sync_s", sync_s)
        telemetry.event("mesh", "filter", shards=n_shards,
                        rows=batch.num_rows, selected=count)
        pieces = [shard.take(_compact(mask, int(c)))
                  for shard, mask, c in zip(shards, masks, counts)]
        return concat_shards(pieces, batch.schema, home)
