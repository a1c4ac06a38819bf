"""Distribution: one controller over a mesh of shards, and the batched
multi-query programs.

- `mesh.py` — the `Mesh` (an ordered tuple of `torch.device`s in flat
  shard order, 1 or 2 axes) and THE contiguous bucket-range ownership
  map; `virtual.py` — the visible device list and the virtual mesh (n
  shards on one device); `context.py` — the distribution policy
  (`should_distribute`), the JAX package's unchanged.
- `build.py` — the mesh-sharded index build (per-shard hash kernel, the
  per-peer slab exchange, the local sort); the index is born sharded
  (`io/builder.write_bucket_ordered`).
- `scan.py` — row sharding (`shard_batch`) and the sharded filter;
  `aggregate.py` — per-shard partial group aggregates and their host
  combine.
- `spmd.py` — born-sharded execution: the `ShardedBatch` layout, the
  sharded read through the segment cache (global string dictionaries,
  virtual sub-shards for hot buckets), the per-shard counting join with
  its in-mesh re-bucket through the hash kernel, the sharded filter,
  aggregate and repartition (`SortMergeJoinExec`'s SPMD lane and the
  `execute_sharded` hooks in `engine/physical.py`), and the inter-query
  batched predicate (`batched_predicate_masks`).

- `replica.py` — read replicas: on a multi-slice topology the
  scheduler routes each collect to one slice (least loaded, or a cold
  range's home slice) and runs it on that slice's flat submesh
  (`context.replica_scope`); `mesh.mesh_device_tag` keeps the slices'
  segment-cache entries and dispatch locks apart.

Every module of the JAX package's `parallel/` has its counterpart here.
There is no `torch.distributed`: every shard is a tensor of this
process.
"""
