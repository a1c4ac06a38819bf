"""Mesh-sharded index build: the replacement for the build-time shuffle.

Reference equivalent: `df.repartition(numBuckets, indexedCols)` — a
Spark block-shuffle exchange (`actions/CreateActionBase.scala:110-111`).
The JAX package expresses it as one `lax.all_to_all` inside `shard_map`
with a fixed per-peer capacity and an overflow retry. The port is a
single controller over a list of shards (`parallel/mesh.py`), so the
exchange is explicit and sized at run time — no capacity, no retry:

per source shard (local rows):
1. bucket id = THE hash of the key lanes % num_buckets — on a card the
   hand-written hash kernel (`ops/build._tree_bucket_ids`);
2. owner shard = bucket * n_shards // num_buckets (contiguous ranges);
3. one stable sort by destination peer groups the rows per peer;
4. the rows split into per-peer slabs by exact counts (one host read of
   every shard's counts) and each slab moves with
   `.to(peer, non_blocking=True)`;
5. each destination concatenates what it received in source-shard order
   (`all_to_all`'s `concat_axis=0` order), then
6. one local stable (bucket, *keys) sort orders every bucket run.

Source shards hold consecutive global rows and every hop keeps source
order, so equal keys keep their global row order: the built rows equal
the single-device build's. On a 2-axis (dcn, shard) mesh the route is
HIERARCHICAL, one stage per axis: first to the owner's position within
the source's slice, then to the owner's slice.

`distribution.capacity.factor` has no work to do here; it is accepted
and recorded on the dispatch span, and `mesh.build.overflow_retries`
stays registered at 0 so the JAX package's counters read the same.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import (ColumnBatch, batch_to_tree,
                                              tree_to_batch)
from hyperspace_tpu_torch.ops import keys as keymod
from hyperspace_tpu_torch.ops.build import _entry_sort_lanes, _tree_bucket_ids
from hyperspace_tpu_torch.parallel.mesh import (Mesh, bucket_ranges,
                                                dcn_size, ici_size,
                                                total_shards)
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

# Tree leaves that move with their rows; the dictionary value hashes
# (`hash_hi`/`hash_lo`) are per-device replicas and stay put.
_ROW_LEAVES = ("data", "validity")


def _route_stage(shards: List[Dict], dests: List[torch.Tensor],
                 groups: List[List[int]], n_peers: int,
                 devices: Sequence[torch.device]) -> Tuple[List[Dict], float]:
    """One exchange within each group of flat shards: a source at any
    position of group g sends its rows with `dests` value p to the
    group's p-th shard, and a row with `dests` value `n_peers` goes
    nowhere (the SPMD join's padding rows). `shards[s]` is {name: {leaf:
    tensor}} plus "__bucket__". Returns (received shards, seconds of the
    one host read of the per-peer counts)."""
    home = devices[0]
    perms = [torch.sort(d, stable=True).indices for d in dests]
    counts = [torch.bincount(d, minlength=n_peers + 1) for d in dests]
    t0 = time.perf_counter()
    table = torch.stack([c.to(home) for c in counts]).tolist()
    sync_s = time.perf_counter() - t0

    def slabs(src: int, arr: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return torch.split(arr[perms[src]], table[src])

    received: List[Dict] = [None] * len(shards)
    for group in groups:
        parts: List[Dict] = [dict() for _ in group]
        for src in group:
            moved = {"__bucket__": slabs(src, shards[src]["__bucket__"])}
            for name, entry in shards[src].items():
                if name == "__bucket__":
                    continue
                moved[name] = {leaf: slabs(src, entry[leaf])
                               for leaf in _ROW_LEAVES if leaf in entry}
            for p, dst in enumerate(group):
                dev = devices[dst]
                out = parts[p]
                out.setdefault("__bucket__", []).append(
                    moved["__bucket__"][p].to(dev, non_blocking=True))
                for name, leaves in moved.items():
                    if name == "__bucket__":
                        continue
                    slot = out.setdefault(name, {})
                    for leaf, pieces in leaves.items():
                        slot.setdefault(leaf, []).append(
                            pieces[p].to(dev, non_blocking=True))
        for p, dst in enumerate(group):
            shard = {"__bucket__": torch.cat(parts[p]["__bucket__"])}
            for name, entry in shards[dst].items():
                if name == "__bucket__":
                    continue
                new = {leaf: torch.cat(parts[p][name][leaf])
                       for leaf in _ROW_LEAVES if leaf in entry}
                for leaf, value in entry.items():
                    if leaf not in _ROW_LEAVES:
                        new[leaf] = value  # the device's hash replica
                shard[name] = new
            received[dst] = shard
    return received, sync_s


def _build_step(valids: List[torch.Tensor], trees: List[Dict],
                key_names: Tuple[str, ...], num_buckets: int, mesh: Mesh,
                num_rows: int) -> Tuple[List[Dict], float]:
    """Every shard's bucket ids, the route (one stage per mesh axis) and
    each shard's local (bucket, *keys) sort. `valids` are the per-shard
    row masks of `shard_batch`, whose padding rows are the tail of the
    `num_rows` real ones. Returns (per-shard trees in local (bucket,
    keys) order with "__bucket__", count-read seconds)."""
    n_total = total_shards(mesh)
    n_ici = ici_size(mesh)
    n_dcn = dcn_size(mesh)
    devices = mesh.devices
    local = int(valids[0].shape[0])
    shards = []
    for s, tree in enumerate(trees):
        bucket = _tree_bucket_ids(tree, key_names, num_buckets)
        # Padding rows never route: keep the shard's real rows only.
        rows = min(local, max(0, num_rows - s * local))
        shard = {"__bucket__": bucket[:rows].to(torch.int64)}
        for name, entry in tree.items():
            shard[name] = {leaf: (value[:rows] if leaf in _ROW_LEAVES
                                  else value)
                           for leaf, value in entry.items()}
        shards.append(shard)

    def owner(shard):
        # Contiguous-range ownership (mesh.bucket_owner) in int64.
        return shard["__bucket__"] * n_total // num_buckets

    # Stage 1: to the owner's position within the source's slice.
    groups = [list(range(d * n_ici, (d + 1) * n_ici)) for d in range(n_dcn)]
    shards, sync_s = _route_stage(shards, [owner(s) % n_ici for s in shards],
                                  groups, n_ici, devices)
    if n_dcn > 1:
        # Stage 2: to the owner's slice; the position is already final.
        groups = [list(range(i, n_total, n_ici)) for i in range(n_ici)]
        shards, more_s = _route_stage(
            shards, [owner(s) // n_ici for s in shards], groups, n_dcn,
            devices)
        sync_s += more_s

    out = []
    for shard in shards:
        operands = [shard["__bucket__"]]
        for name in key_names:
            operands.extend(_entry_sort_lanes(shard[name]))
        perm = keymod.lexsort_permutation(operands)
        ordered = {"__bucket__": shard["__bucket__"][perm]}
        for name, entry in shard.items():
            if name == "__bucket__":
                continue
            ordered[name] = {leaf: (value[perm] if leaf in _ROW_LEAVES
                                    else value)
                             for leaf, value in entry.items()}
        out.append(ordered)
    return out, sync_s


build_step = instrumented_device("mesh.build_step", _build_step)


def distributed_build(batch: ColumnBatch, key_columns: Sequence[str],
                      num_buckets: int, mesh: Mesh,
                      capacity_factor: float = 2.0):
    """Run the mesh-sharded build. Returns (ColumnBatch of every row in
    global (bucket, keys) order on the mesh's first device, per-bucket
    lengths np.int64[num_buckets]) — the JAX package's pair.

    A host batch is placed shard by shard straight from host memory
    (`parallel/scan.shard_batch`, the transfer engine's sharded put)."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.parallel.scan import concat_shards, shard_batch

    n_shards = total_shards(mesh)
    key_names = tuple(batch.schema.field(c).name for c in key_columns)
    n = batch.num_rows
    home = mesh.devices[0]
    reg = telemetry.get_registry()
    reg.counter("mesh.build.overflow_retries")  # registered; never moves

    shards, valids = shard_batch(batch, mesh)
    trees = [batch_to_tree(shard)[0] for shard in shards]
    tracer = telemetry.tracer()
    span_ts = time.time_ns() if tracer is not None else 0
    t0 = time.perf_counter()
    with telemetry.span("mesh:build:dispatch", "mesh", shards=n_shards,
                        rows=n, capacity_factor=capacity_factor):
        built, sync_s = build_step(valids, trees, key_names, num_buckets,
                                   mesh, n)
    reg.counter("mesh.build.dispatch_s").inc(
        time.perf_counter() - t0 - sync_s)
    reg.counter("mesh.build.sync_s").inc(sync_s)
    telemetry.add_seconds("mesh.sync_s", sync_s)

    aux = {f.name: batch.columns[f.name].dictionary
           for f in batch.schema.fields}
    pieces = [tree_to_batch({k: v for k, v in tree.items()
                             if k != "__bucket__"}, batch.schema, aux)
              for tree in built]
    final = concat_shards(pieces, batch.schema, home)
    lengths = torch.stack([
        torch.bincount(tree["__bucket__"], minlength=num_buckets).to(home)
        for tree in built]).sum(0).cpu().numpy().astype(np.int64)

    shard_rows = [int(lengths[lo:hi].sum())
                  for lo, hi in bucket_ranges(num_buckets, n_shards)]
    for rows in shard_rows:
        reg.histogram("mesh.build.shard_rows").observe(rows)
    reg.counter("mesh.build.execs").inc()
    telemetry.event("mesh", "build", shards=n_shards, rows=n,
                    buckets=num_buckets, shard_rows=shard_rows)
    if tracer is not None:
        # Per-shard tracks: the rows each shard built show its skew.
        tracer.device_spans("build", span_ts, shard_rows,
                            buckets=num_buckets)
    return final, lengths
