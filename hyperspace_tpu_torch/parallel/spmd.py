"""Born-sharded SPMD execution: bucket-range-sharded inputs read, joined,
filtered and aggregated shard by shard, and the inter-query batched
predicate lane.

A committed covering index built on a mesh is BORN SHARDED: flat shard s
of an n-shard mesh owns the contiguous bucket range `bucket_ranges(B,
n)[s]` and its rows sit in `part-NNNNN-sSS.parquet` files
(`io/builder.write_bucket_ordered`). `read_sharded` decodes each shard's
range onto `mesh.devices[s]` through the segment cache (one
`get_or_fill` entry per shard: a warm read moves nothing over the link),
and the operators run on the shards where they lie. Equal keys hash to
one bucket and one bucket lives on one shard, so the sort-merge join is
a per-shard counting match with no bucket lane.

The design is the port's single controller (`parallel/mesh.py`): a
`ShardedBatch` is one padded ColumnBatch and one `row_valid` mask per
shard; an exchange moves exact per-peer slabs with `.to(peer)`
(`parallel/build._route_stage`). Where the JAX package traces one
jitted `shard_map` program per join with a STATIC per-shard output
capacity, an on-device overflow flag and a doubling retry (XLA shapes
are static), the port sizes every shard's output exactly from ONE host
read of all shards' counts per join (and one per exchange stage), so:

- no row is ever dropped and nothing is retried: the port ignores
  `spark.hyperspace.distribution.capacity.factor` (the key stays in the
  conf for parity with the JAX package) and has no
  `mesh.spmd.overflow_retries` counter;
- `_join_capacity` is the JAX first-attempt bound, the exact per-shard
  pair bound from the two bucket histograms; here it checks the exact
  sizes;
- the JAX `_route_cap`, `_prefix_index` and `_gather_prefixes` have no
  counterpart: slabs are cut by exact counts, and each shard's output is
  exact, so the result is the concatenation of the shards' outputs;
- the JAX `mesh.spmd_gather` / `mesh.spmd_gather_i32` device entries
  have no counterpart: the port concatenates the shards' exact outputs
  on the mesh's first device. The device seam's mesh entries here are
  `mesh.spmd_join`, `mesh.spmd_filter` and `mesh.spmd_repartition`;
- `spmd.repartition.{ici,dcn}.bytes` count the rows each exchange stage
  actually routes (every slab, the one a shard keeps included) times
  the bytes a routed row carries, where the JAX package counts its
  padded send buffers.

Layout (`ShardedBatch`): shard s's rows are its bucket range's rows,
padded to the common capacity C (`rows_per_shard`) with `row_valid` False
at the tail. THE FLAT PADDED ROW SPACE that join indices address is the
shards in shard order: shard s's row i is flat row s*C + i;
`ShardedBatch.batch` materializes it as one ColumnBatch on the mesh's
first device, and join outputs gather from it
(`ops/bucketed_join.assemble_join_output`).

Strings are first-class. Each bucket range of a mesh build records its
sorted dictionary in `_shard_layout.json`; a read unifies them into one
global sorted dictionary (cached per version) and remaps each shard's
codes into it on the host before placement, so every shard holds
globally comparable int32 codes. A join of two sides with different
dictionaries maps both sides' codes to pair-merged ranks through
`string_remap_tables` (cached by content); a side that must re-bucket
routes by its dictionary VALUE hashes, the build's bucket identity, not
by the ranks. `string_like_mask` serves LIKE as a cached per-dictionary
membership mask.

The re-bucket (`_repartition_lanes`): when the two sides' bucket counts
differ, the right side's key lanes (with null flags and original flat
row ids) move to the shards that own their buckets under the left's
count. Each shard's target bucket ids come from the hand-written hash
kernel (`ops/cuda/hash_kernel.hash_lanes_to_buckets`, THE hash identity;
its plain version on a CPU tensor), the owner from `mesh.bucket_owner`;
payload never moves, the output gathers it by id. A flat mesh makes one
exchange; a (dcn, shard) mesh two, ICI within the slice then DCN across,
as the build's exchange does.

The inter-query batched predicate lane (`engine/batcher.py` is its only
caller): K concurrent point/filter queries over one shared scan differ
only in their predicate CONSTANTS once they share an execution
signature. `batched_predicate_masks` evaluates all K predicates in ONE
call through the device seam (`instrumented_device("serve.batch")`): the
constants ride [K, T] lanes (K padded to a power-of-two bucket by the
batcher) and the result is a [K, N] boolean mask matrix that stays where
the columns live. Term semantics mirror `engine/compiler.py`'s
definite-truth masks exactly for the supported shapes — numeric
comparisons against literals, integer IN lists, and IS [NOT] NULL — so a
batched member's rows are bit-identical to its solo run:

- a float literal is compared in the column's own float width (numpy's
  weak-scalar promotion on the solo path), an int literal against a
  float column likewise in the column's width;
- an int column against a float literal is compared in float64;
- an int column against an int literal is compared in int64 (exact at
  any width);
- an `in` term checks the column (lifted to int64) against its padded
  value lane (padding repeats a real value, harmless for membership);
- a column with a validity mask is false wherever it is null;
- a constants-free shape (only null-ness terms) evaluates as one row
  and is broadcast to [K, N].
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn
from hyperspace_tpu_torch.ops import keys as keymod
from hyperspace_tpu_torch.parallel.mesh import (Mesh, bucket_owner,
                                                bucket_ranges, dcn_size,
                                                ici_size, mesh_device_list,
                                                mesh_device_tag,
                                                shard_row_segments,
                                                total_shards)
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

__all__ = ["PAD_BLOWUP_FACTOR", "ShardedBatch", "SubshardPlan",
           "batched_predicate_masks", "count_string_predicate_lookups",
           "dispatch_guard", "pad_blowup", "plan_aligned_read",
           "plan_skew_read", "read_sharded", "repartition_sharded",
           "routing_lanes", "shard_bucket_ordered", "sharded_filter",
           "shutdown_read_pool",
           "sharded_group_aggregate", "sharded_join_indices",
           "sharded_semi_anti_indices", "spmd_fallback",
           "string_like_mask", "string_remap_tables", "subshard_plan",
           "supports_sharded"]

# Born-sharded skew guard: when padding every shard to the hottest
# shard's rows would out-size the true rows by more than this, the read
# splits the hot range into virtual sub-shards (`subshard_plan`).
PAD_BLOWUP_FACTOR = 4

# The join's per-row marker lane: valid keys of both sides share 0 so
# they interleave by key; null keys and padding rows form their own runs
# and match nothing.
_VALID, _NULL_L, _NULL_R, _PAD_L, _PAD_R = 0, 1, 2, 3, 4


@dataclass
class ShardedBatch:
    """A born-sharded batch (module docstring): `shards[s]` on
    `mesh.devices[s]` holds its bucket range's rows padded to
    `rows_per_shard` (C), `row_valid[s]` marks the real ones. `lengths`
    (per-bucket row counts) is None for layouts whose histogram never
    reached the host (repartitioned or filtered). `split_plan` is set
    when the rows were cut into equal row segments inside hot buckets
    (virtual sub-shards): keys then no longer co-locate by shard, so a
    join reads its other side ALIGNED to the plan."""

    shards: List[ColumnBatch]
    row_valid: List[torch.Tensor]
    mesh: Mesh
    rows_per_shard: int
    num_buckets: int
    lengths: Optional[np.ndarray] = None
    split_plan: Optional["SubshardPlan"] = None
    _flat: Optional[ColumnBatch] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        return total_shards(self.mesh)

    @property
    def schema(self):
        return self.shards[0].schema

    @property
    def num_rows(self) -> int:
        """TRUE row count (padding excluded): from the histogram when
        known, else one read of every shard's valid count."""
        if self.lengths is not None:
            return int(self.lengths.sum())
        home = self.mesh.devices[0]
        return int(sum(torch.stack([v.sum().to(home)
                                    for v in self.row_valid]).tolist()))

    @property
    def batch(self) -> ColumnBatch:
        """The flat padded row space as one ColumnBatch on the mesh's
        first device (shard s's row i at s*C + i); made once."""
        if self._flat is None:
            from hyperspace_tpu_torch.parallel.scan import concat_shards
            self._flat = concat_shards(self.shards, self.schema,
                                       self.mesh.devices[0])
        return self._flat

    def narrowed(self, shards: List[ColumnBatch],
                 row_valid: List[torch.Tensor],
                 keep_lengths: bool) -> "ShardedBatch":
        """The same layout with new per-shard columns or masks (Project,
        Filter): rows never move, so the split plan carries over."""
        return dataclasses.replace(
            self, shards=shards, row_valid=row_valid,
            lengths=self.lengths if keep_lengths else None, _flat=None)


def supports_sharded(schema) -> bool:
    """Whether a schema fits the born-sharded layout. Strings are
    first-class (per-range dictionaries); only a dtype outside the
    engine's host-lane map declines."""
    from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES
    return all(f.dtype in HOST_NP_DTYPES for f in schema.fields)


def spmd_fallback(reason: str) -> None:
    """Record a decline of the born-sharded SPMD lane while a mesh was
    available (`spmd.fallbacks` and a query event). A decline is a
    routing answer: the join runs single-device."""
    telemetry.get_registry().counter("spmd.fallbacks").inc()
    telemetry.event("spmd", "fallback", reason=reason)


def count_string_predicate_lookups(expression, batch: ColumnBatch) -> None:
    """`spmd.strings.dict_lookups`: one per string column a predicate
    resolves literals against on the SPMD lane (the compiler's
    code-space binary searches)."""
    try:
        refs = expression.references()
    except Exception:
        return
    n = 0
    for r in refs:
        try:
            if batch.column(r).is_string:
                n += 1
        except Exception:
            continue
    if n:
        telemetry.get_registry().counter(
            "spmd.strings.dict_lookups").inc(n)


def pad_blowup(lengths, n_shards: int) -> bool:
    """True when padding every shard to the hottest shard's row count
    would blow the layout far past the true rows (the caller splits the
    hot range into virtual sub-shards, `subshard_plan`)."""
    segs = shard_row_segments(lengths, n_shards)
    C = max(1, max(e - s for s, e in segs))
    rows = int(np.asarray(lengths).sum())
    return C * n_shards > max(PAD_BLOWUP_FACTOR * rows, 1 << 16)


# ---------------------------------------------------------------------------
# Virtual sub-shards: hot-bucket skew without leaving the SPMD lane
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SubshardPlan:
    """Row-balanced virtual sub-shards over a skewed bucket histogram.

    When one bucket range is hot enough that whole-bucket ownership
    would pad the layout past `PAD_BLOWUP_FACTOR` x the true rows, the
    skewed side's bucket-ordered row space is cut into EQUAL row
    segments instead: cuts may fall inside a hot bucket, so its rows
    span several consecutive shards.

    Splitting breaks per-shard key co-location, so a join over the split
    side reads its OTHER side aligned to this plan: `bucket_spans[s]` is
    the bucket interval intersecting shard s's row segment, and the
    aligned read places ALL of those buckets' rows on shard s (a split
    bucket's other-side rows are replicated onto every covering shard).
    Each split-side row then meets every matching row locally and lives
    on exactly one shard, so inner, left_outer, semi and anti results
    equal the unsplit join's (full_outer needs unmatched-right
    uniqueness and stays off this lane)."""

    num_buckets: int
    n_shards: int
    segments: tuple      # per-shard (row_lo, row_hi) into the row space
    bucket_spans: tuple  # per-shard (b_lo, b_hi) intersecting buckets


def subshard_plan(lengths, n_shards: int) -> SubshardPlan:
    """The deterministic split plan for a skewed histogram: equal row
    segments (±1) with their covering bucket intervals."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    per = -(-max(total, 1) // n_shards)
    cum = np.concatenate([[0], np.cumsum(lengths)])
    segments = []
    spans = []
    for s in range(n_shards):
        lo, hi = min(s * per, total), min((s + 1) * per, total)
        segments.append((lo, hi))
        if hi <= lo:
            spans.append((0, 0))
            continue
        # buckets b with cum[b] < hi and cum[b+1] > lo
        b_lo = int(np.searchsorted(cum, lo, side="right")) - 1
        b_hi = int(np.searchsorted(cum, hi, side="left"))
        spans.append((max(b_lo, 0), min(b_hi, len(lengths))))
    return SubshardPlan(len(lengths), n_shards, tuple(segments),
                        tuple(spans))


def _file_cuts(per_bucket: dict, num_buckets: int):
    """Ordered (bucket, file) pairs over the bucket-ordered file list,
    their footer row counts and the cumulative row offsets — the
    geometry both sub-shard read planners slice against."""
    from hyperspace_tpu_torch.io import parquet

    ordered = [(b, f) for b in range(num_buckets)
               for f in per_bucket.get(b, [])]
    counts = parquet.file_row_counts([f for _, f in ordered])
    cum = np.concatenate([[0], np.cumsum(np.asarray(counts,
                                                    dtype=np.int64))])
    return ordered, counts, cum


def plan_skew_read(per_bucket: dict, lengths, n_shards: int):
    """(plan, shard_specs) for the SKEWED side: shard s reads rows
    [lo, hi) of the bucket-ordered file list — the covering files and a
    (skip, take) window, so a file holding a cut decodes once per
    touching shard but places only its slice."""
    lengths = np.asarray(lengths, dtype=np.int64)
    plan = subshard_plan(lengths, n_shards)
    ordered, _counts, cum = _file_cuts(per_bucket, len(lengths))
    specs = []
    for lo, hi in plan.segments:
        if hi <= lo:
            specs.append(((), 0, 0))
            continue
        f_lo = int(np.searchsorted(cum, lo, side="right")) - 1
        f_hi = int(np.searchsorted(cum, hi, side="left"))
        files = tuple([f for _b, f in ordered[f_lo:f_hi]])
        specs.append((files, lo - int(cum[f_lo]), hi - lo))
    return plan, specs


def plan_aligned_read(per_bucket: dict, lengths, plan: SubshardPlan):
    """shard_specs for the side ALIGNED to a split plan: shard s holds
    every row of the buckets intersecting the plan's shard-s segment
    (buckets on a cut are replicated onto each covering shard)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)])
    specs = []
    for b_lo, b_hi in plan.bucket_spans:
        files = tuple([f for b in range(b_lo, b_hi)
                       for f in per_bucket.get(b, [])])
        specs.append((files, 0, int(cum[b_hi] - cum[b_lo])))
    return specs


# ---------------------------------------------------------------------------
# Layout construction and the born-sharded read
# ---------------------------------------------------------------------------


def _padded(arr, lo: int, hi: int, C: int, device, engine):
    """Rows [lo, hi) of a host or device array, zero-padded to C rows,
    on `device` (a host array crosses the link once, through the
    transfer engine)."""
    if isinstance(arr, np.ndarray):
        out = np.zeros((C,) + arr.shape[1:], dtype=arr.dtype)
        out[:hi - lo] = arr[lo:hi]
        return engine.put(out, device=device)
    out = torch.zeros((C,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[:hi - lo] = arr[lo:hi]
    return out.to(device, non_blocking=True)


def shard_bucket_ordered(batch: ColumnBatch, lengths,
                         mesh: Mesh) -> ShardedBatch:
    """Place a bucket-ordered batch (`lengths` rows per bucket) into the
    born-sharded layout: shard s takes its bucket range's rows, padded
    to the common capacity, on `mesh.devices[s]`."""
    from hyperspace_tpu_torch.io import transfer
    from hyperspace_tpu_torch.parallel.scan import _replicas

    lengths = np.asarray(lengths, dtype=np.int64)
    segs = shard_row_segments(lengths, total_shards(mesh))
    C = max(1, max(hi - lo for lo, hi in segs))
    engine = transfer.get_engine()
    hashes = {name: _replicas(col.dict_hashes, mesh.devices)
              for name, col in batch.columns.items()
              if col.dict_hashes is not None}
    shards, valids = [], []
    for (lo, hi), dev in zip(segs, mesh.devices):
        cols = {}
        for name, col in batch.columns.items():
            validity = (_padded(col.validity, lo, hi, C, dev, engine)
                        if col.validity is not None else None)
            cols[name] = DeviceColumn(
                _padded(col.data, lo, hi, C, dev, engine), col.dtype,
                validity, col.dictionary,
                hashes[name][dev] if name in hashes else None)
        shards.append(ColumnBatch(batch.schema, cols))
        valids.append(torch.arange(C, device=dev) < hi - lo)
    return ShardedBatch(shards, valids, mesh, C, len(lengths),
                        lengths=lengths)


def _build_global_dicts(files: List[str], str_fields: Sequence[str],
                        schema) -> dict:
    """The GLOBAL sorted dictionary (and its value hashes) of each string
    column of a born-sharded version: the union of the per-range
    dictionaries the mesh build recorded in `_shard_layout.json` (no
    data read), or — for a version without the record, or a range past
    `distribution.dictionary.max.entries` — one host read of the string
    columns."""
    import os

    from hyperspace_tpu_torch.io.columnar import _string_hash64

    out: dict = {}
    if not files:
        for name in str_fields:
            empty = np.asarray([], dtype=str)
            out[name] = {"dictionary": empty,
                         "hashes": _string_hash64(empty)}
        return out

    remaining = list(str_fields)
    roots = {os.path.dirname(f) for f in files}
    if len(roots) == 1:
        from hyperspace_tpu_torch.io.builder import read_shard_layout
        layout = read_shard_layout(next(iter(roots)))
        recorded = (layout or {}).get("dictionaries") or {}
        for name in list(remaining):
            ranges = recorded.get(name)
            if ranges is None or any(r is None for r in ranges):
                continue  # no whole record: derive from the files
            merged = np.unique(np.concatenate(
                [np.asarray(r, dtype=str) for r in ranges]
                + [np.asarray([], dtype=str)]))
            out[name] = {"dictionary": merged,
                         "hashes": _string_hash64(merged)}
            remaining.remove(name)

    if remaining:
        from hyperspace_tpu_torch.io import columnar, parquet
        table = parquet.read_table(files, columns=remaining)
        for name in remaining:
            _codes, dictionary, hashes, _validity = \
                columnar._encode_strings_arrow(table.column(name))
            out[name] = {"dictionary": dictionary, "hashes": hashes}
    return out


def _resolve_global_dicts(per_shard_files: List[List[str]],
                          str_fields: Sequence[str], schema, base_ref,
                          conf, budget, cache) -> dict:
    """The global dictionaries, cached per committed version and column
    set (warm queries never re-read or re-merge them:
    `spmd.strings.remap_cache_hits`)."""
    all_files = [f for files in per_shard_files for f in files]
    if base_ref is None:
        return _build_global_dicts(all_files, str_fields, schema)
    filled: List[bool] = []

    def fill():
        filled.append(True)
        payload = _build_global_dicts(all_files, str_fields, schema)
        nbytes = sum(int(e["dictionary"].nbytes) + int(e["hashes"].nbytes)
                     for e in payload.values())
        return payload, max(nbytes, 1)

    key = base_ref.key + (("spmd-dicts", tuple(str_fields)),)
    payload = cache.get_or_fill(key, fill, ref=base_ref, conf=conf,
                                budget=budget)
    if not filled:
        telemetry.get_registry().counter(
            "spmd.strings.remap_cache_hits").inc()
    return payload


def _remap_to_global(host: ColumnBatch, global_dicts: dict) -> ColumnBatch:
    """Swap each string column's LOCAL codes for codes in the global
    dictionary (on the host, before placement). Fails loudly if a valid
    local value is missing from the global dictionary: both derive from
    the same committed files, so a miss means the record and the data
    disagree."""
    for name, col in host.columns.items():
        if not col.is_string:
            continue
        g = global_dicts[name]["dictionary"]
        local = np.asarray(col.dictionary)
        if len(g):
            remap = np.searchsorted(g, local).astype(np.int32)
            found = g[np.clip(remap, 0, len(g) - 1)] == local
        else:
            remap = np.zeros(len(local), dtype=np.int32)
            found = np.zeros(len(local), dtype=bool)
        codes = np.asarray(col.data)
        used = codes if col.validity is None else codes[col.validity]
        if len(used) and not found[used].all():
            raise HyperspaceException(
                f"Born-sharded read: string column {name!r} holds values "
                "absent from the version's global dictionary — the "
                "recorded per-range dictionaries and the data disagree.")
        safe = np.where(found, remap, 0).astype(np.int32)
        host.columns[name] = DeviceColumn(
            data=safe[codes], dtype="string", validity=col.validity,
            dictionary=col.dictionary, dict_hashes=col.dict_hashes)
    return host


def _files_digest(files) -> str:
    """Compact stable identity of an ordered file tuple, for the
    sub-shard cache keys."""
    h = hashlib.sha1()
    for f in files:
        h.update(str(f).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def read_sharded(per_shard_files: List[List[str]], lengths,
                 columns: Sequence[str], schema, mesh: Mesh,
                 base_ref=None, conf=None, budget=None,
                 shard_specs=None,
                 split_plan: Optional[SubshardPlan] = None
                 ) -> ShardedBatch:
    """Born-sharded read: shard s's bucket-range files decode and land
    on `mesh.devices[s]` through the segment cache — one `get_or_fill`
    entry per shard, keyed by the version (`base_ref`), the range, the
    capacity and the mesh's devices, so a warm read is a cache hit per
    shard that touches neither Parquet nor the link.

    `shard_specs` overrides the whole-bucket segmentation with explicit
    per-shard (files, skip_rows, n_rows) windows (the virtual-sub-shard
    reads, `plan_skew_read` / `plan_aligned_read`); `split_plan` is
    stamped onto the result so the join knows the layout is row-balanced,
    not bucket-aligned."""
    from hyperspace_tpu_torch.io import segcache

    lengths = np.asarray(lengths, dtype=np.int64)
    n_shards = total_shards(mesh)
    if shard_specs is None:
        segs = shard_row_segments(lengths, n_shards)
        ranges = bucket_ranges(len(lengths), n_shards)
        shard_specs = [(tuple(per_shard_files[s]), 0,
                        segs[s][1] - segs[s][0]) for s in range(n_shards)]
        key_tags = [("spmd", lo, hi, n_shards) for lo, hi in ranges]
        out_lengths = lengths
        windowed = False
    else:
        if len(shard_specs) != n_shards:
            raise HyperspaceException(
                f"shard_specs covers {len(shard_specs)} shards; the mesh "
                f"has {n_shards}.")
        # The window coordinates alone do not say WHICH files shard s's
        # window slices (the plans depend on the other join side's
        # histogram): the file-tuple digest pins the key to the bytes.
        key_tags = [("spmd-sub", spec[1], spec[2], n_shards, s,
                     _files_digest(spec[0]))
                    for s, spec in enumerate(shard_specs)]
        out_lengths = None
        windowed = True
    C = max(1, max(spec[2] for spec in shard_specs))
    devices = mesh_device_list(mesh)
    # The device tag last: `SegmentCache.replica_residency` reads it
    # there. The device names keep a CPU and a card mesh apart.
    dev_tag = (tuple([str(d) for d in devices]), mesh_device_tag(mesh))
    cols = tuple(columns)
    schema_json = schema.to_json()
    cache = segcache.get_cache()

    out_schema = schema.select(cols)
    str_fields = tuple([f.name for f in out_schema.fields
                        if f.dtype == "string"])
    global_dicts = None
    if str_fields:
        all_files = list(dict.fromkeys(
            f for spec in shard_specs for f in spec[0]))
        global_dicts = _resolve_global_dicts([all_files], str_fields,
                                             schema, base_ref, conf,
                                             budget, cache)

    def fill_one(s: int):
        files, skip, rows = shard_specs[s]

        def fill():
            return _fill_device_shard(list(files), cols, schema, rows, C,
                                      devices[s], global_dicts=global_dicts,
                                      skip=skip, windowed=windowed)

        if base_ref is None:
            return fill()[0]
        key = base_ref.key + (key_tags[s] + (C,) + dev_tag, cols,
                              schema_json)
        return cache.get_or_fill(key, fill, ref=base_ref, conf=conf,
                                 budget=budget)

    # Concurrent per-shard fills: shard s+1's Parquet decode overlaps
    # shard s's copies (each fill itself pipelines through
    # `TransferEngine.put_group`). The fan-out rides a DEDICATED pool,
    # not `parquet.io_executor()`: the fills submit to that shared pool
    # and block, so fanning out on it would deadlock it against itself.
    payloads = list(_read_pool().map(telemetry.propagating(fill_one),
                                     range(n_shards)))

    shards, valids = [], []
    for s, (payload, dev) in enumerate(zip(payloads, devices)):
        cols_out = {}
        for f in out_schema.fields:
            entry = payload["columns"][f.name]
            validity = entry.get("validity")
            if validity is None and any(
                    p["columns"][f.name].get("validity") is not None
                    for p in payloads):
                validity = torch.ones(C, dtype=torch.bool, device=dev)
            dictionary = hashes = None
            if f.dtype == "string":
                dictionary = global_dicts[f.name]["dictionary"]
                hashes = (entry["hash_hi"], entry["hash_lo"])
            cols_out[f.name] = DeviceColumn(entry["data"], f.dtype,
                                            validity, dictionary, hashes)
        shards.append(ColumnBatch(out_schema, cols_out))
        valids.append(torch.arange(C, device=dev) < shard_specs[s][2])
    return ShardedBatch(shards, valids, mesh, C, len(lengths),
                        lengths=out_lengths, split_plan=split_plan)


_pool = None
_pool_lock = threading.Lock()


def _read_pool():
    """The lazy fan-out pool of the per-shard fills (one per process,
    drained at exit). Distinct from `parquet.io_executor()` on purpose:
    the fills block on that pool."""
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                import atexit
                from concurrent.futures import ThreadPoolExecutor

                _pool = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="hs-spmd-read")
                atexit.register(shutdown_read_pool)
    return _pool


def shutdown_read_pool(wait: bool = True) -> None:
    """Drain and stop the fill pool (idempotent; made again on the next
    born-sharded read)."""
    global _pool
    pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown(wait=wait)


def _fill_device_shard(files: List[str], cols, schema, rows: int, C: int,
                       device, global_dicts=None, skip: int = 0,
                       windowed: bool = False) -> Tuple[dict, int]:
    """Cold fill of one shard's bucket range: Parquet decode, pad to the
    common capacity on the host, place every column on THIS shard's
    device through the transfer engine's fill lane. String columns
    decode to their local dictionary and remap to the global codes on
    the host; each shard also holds the global dictionary's value hashes
    (the re-bucket's hash lanes). A sub-shard window (`skip` > 0 or
    `rows` short of the decoded count) slices the decoded table first.
    Returns (payload, resident bytes)."""
    from hyperspace_tpu_torch.io import columnar, parquet, transfer
    from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES, _split_hashes
    from hyperspace_tpu_torch.io.segcache import _array_nbytes

    out_schema = schema.select(cols)
    host = None
    if files and rows:
        table = parquet.read_table(files, columns=list(cols))
        if table.num_rows < skip + rows or (not windowed
                                            and table.num_rows != rows):
            raise HyperspaceException(
                f"Born-sharded read expected {rows} rows (skip {skip}), "
                f"decoded {table.num_rows} — footer metadata and data "
                f"disagree.")
        if skip or table.num_rows != rows:
            table = table.slice(skip, rows)
        host = columnar.from_arrow(table, out_schema)
        if global_dicts:
            host = _remap_to_global(host, global_dicts)
    entries = []
    for f in out_schema.fields:
        if host is None:  # an empty range: an all-padding shard
            entry = {"data": np.zeros(C, dtype=HOST_NP_DTYPES[f.dtype])}
        else:
            col = host.columns[f.name]
            data = np.zeros((C,) + col.data.shape[1:], dtype=col.data.dtype)
            data[:rows] = col.data
            entry = {"data": data}
            if col.validity is not None:
                v = np.zeros(C, dtype=bool)
                v[:rows] = col.validity
                entry["validity"] = v
        if f.dtype == "string":
            hi, lo = _split_hashes(global_dicts[f.name]["hashes"])
            entry["hash_hi"] = transfer.HostCast(hi, np.int64)
            entry["hash_lo"] = transfer.HostCast(lo, np.int64)
        entries.append(entry)
    placed = transfer.get_engine().put_group(
        [functools.partial(dict, e) for e in entries], device=device,
        tag="fill")
    payload = {"columns": {f.name: p for f, p in zip(out_schema.fields,
                                                     placed)},
               "rows": rows}
    nbytes = sum(_array_nbytes(v) for p in placed for v in p.values())
    return payload, max(nbytes, 1)


# ---------------------------------------------------------------------------
# String seams: remap tables, LIKE masks, the join's key plan
# ---------------------------------------------------------------------------


def _dict_fingerprint(dictionary) -> tuple:
    """Content identity of a sorted dictionary (entry count and md5 of
    the packed values): the cache key of the remap tables and masks.
    Two versions with identical dictionaries share one entry."""
    d = np.ascontiguousarray(np.asarray(dictionary))
    return (int(d.shape[0]), hashlib.md5(d.tobytes()).hexdigest())


def string_remap_tables(lcol: DeviceColumn, rcol: DeviceColumn,
                        conf=None, device=None):
    """THE dictionary-remap constructor of the SPMD join: the int32
    local-code -> pair-merged-rank tables that make two sides' string
    codes mutually comparable, built once on the host from the two
    dictionaries (no string bytes cross the link), placed on `device`
    and cached by content in the segment cache. Warm repeats serve them
    from the cache (`spmd.strings.remap_cache_hits`). Returns (left
    table, right table)."""
    from hyperspace_tpu_torch.io import segcache, transfer

    key = ("spmd-remap", _dict_fingerprint(lcol.dictionary),
           _dict_fingerprint(rcol.dictionary), str(device))
    filled: List[bool] = []

    def fill():
        filled.append(True)
        merged = np.unique(np.concatenate([np.asarray(lcol.dictionary),
                                           np.asarray(rcol.dictionary)]))
        ra = np.searchsorted(merged, lcol.dictionary).astype(np.int32)
        rb = np.searchsorted(merged, rcol.dictionary).astype(np.int32)
        engine = transfer.get_engine()
        payload = {"l": engine.put(ra, device=device),
                   "r": engine.put(rb, device=device)}
        return payload, max(int(ra.nbytes) + int(rb.nbytes), 1)

    payload = segcache.get_cache().get_or_fill(key, fill, conf=conf)
    if not filled:
        telemetry.get_registry().counter(
            "spmd.strings.remap_cache_hits").inc()
    return payload["l"], payload["r"]


def string_like_mask(col: DeviceColumn, pattern_regex: str, device,
                     conf=None):
    """THE device-side LIKE lane for dictionary-encoded strings: a
    boolean mask over the column's sorted dictionary — mask[code] is
    whether dictionary[code] matches — computed ONCE on the host (an
    anchored regex over the distinct values), placed on `device` once,
    and cached by content in the segment cache like the remap tables. A
    filter then evaluates LIKE as one gather by code; warm repeats serve
    the mask from the cache (`spmd.strings.like_mask_cache_hits`) with
    no regex work and no link traffic."""
    import re as _re

    from hyperspace_tpu_torch.io import segcache, transfer

    key = ("spmd-like", _dict_fingerprint(col.dictionary), pattern_regex,
           str(device))
    filled: List[bool] = []

    def fill():
        filled.append(True)
        rx = _re.compile(pattern_regex, _re.DOTALL)
        mask = np.asarray([rx.fullmatch(str(v)) is not None
                           for v in np.asarray(col.dictionary)], dtype=bool)
        return ({"mask": transfer.get_engine().put(mask, device=device)},
                max(int(mask.nbytes), 1))

    payload = segcache.get_cache().get_or_fill(key, fill, conf=conf)
    if not filled:
        telemetry.get_registry().counter(
            "spmd.strings.like_mask_cache_hits").inc()
    return payload["mask"]


def _string_key_plan(left: ShardedBatch, right: ShardedBatch,
                     left_keys: Sequence[str], right_keys: Sequence[str],
                     conf=None) -> Dict[int, Dict]:
    """Per string key position, {device: (left table, right table)} — the
    rank-remap tables on each distinct device of the mesh."""
    plan: Dict[int, Dict] = {}
    devices = list(dict.fromkeys(left.mesh.devices))
    for i, (lk, rk) in enumerate(zip(left_keys, right_keys)):
        lcol = left.shards[0].column(lk)
        rcol = right.shards[0].column(rk)
        if lcol.is_string != rcol.is_string:
            raise HyperspaceException(
                f"Join key type mismatch: {lk} vs {rk}")
        if lcol.is_string:
            plan[i] = {dev: string_remap_tables(lcol, rcol, conf=conf,
                                                device=dev)
                       for dev in devices}
    return plan


# ---------------------------------------------------------------------------
# The re-bucket between shards
# ---------------------------------------------------------------------------


def routing_lanes(sh: ShardedBatch, keys: Sequence[str],
                  dtypes: Optional[Sequence] = None) -> List[torch.Tensor]:
    """Shard by shard, the [L, C] int32 hash lanes that re-bucket `sh` by
    `keys` between shards: the build's bucket identity — a numeric key's
    32-bit lanes (in `dtypes[i]` when the join promoted it), a string
    key's dictionary VALUE hashes — with every lane of a null or
    padding row zeroed."""
    from hyperspace_tpu_torch.ops.cuda.hash_kernel import stack_lanes

    out = []
    for shard, valid in zip(sh.shards, sh.row_valid):
        lanes: List[torch.Tensor] = []
        bad = ~valid
        for i, name in enumerate(keys):
            col = shard.column(name)
            if col.is_string:
                hi, lo = col.dict_hashes
                if hi.numel():
                    codes = col.data.to(torch.int64).clamp(0,
                                                           hi.numel() - 1)
                    lanes.extend([hi[codes], lo[codes]])
                else:  # an all-null column: no values to hash
                    lanes.extend([torch.zeros_like(col.data)] * 2)
            else:
                data = col.data if dtypes is None else col.data.to(dtypes[i])
                lanes.extend(keymod.key_lanes(data))
            if col.validity is not None:
                bad = bad | ~col.validity
        out.append(stack_lanes([torch.where(bad, torch.zeros_like(lane),
                                            lane) for lane in lanes]))
    return out


def _route_slabs(mesh: Mesh):
    """The stages of one exchange on `mesh`: [(link, groups, n_peers,
    destination of an owner)]. A flat mesh is one stage over every
    shard; a (dcn, shard) mesh two axis-confined hops — ICI to the
    owner's position within the source's slice, then DCN to the owner's
    slice — so each hop changes one mesh coordinate, as the build's
    exchange does."""
    n_total, n_ici, n_dcn = total_shards(mesh), ici_size(mesh), dcn_size(mesh)
    stages = [("ici", [list(range(d * n_ici, (d + 1) * n_ici))
                       for d in range(n_dcn)], n_ici,
               lambda owner: owner % n_ici)]
    if n_dcn > 1:
        stages.append(("dcn", [list(range(i, n_total, n_ici))
                               for i in range(n_ici)], n_dcn,
                       lambda owner: owner // n_ici))
    return stages


def _record_repartition_bytes(link: str, shards: List[Dict],
                              per_row_bytes: int) -> None:
    """`spmd.repartition.<link>.bytes` += the rows one exchange stage
    routed (every slab, a shard's own included) times the bytes a routed
    row carries (module docstring)."""
    rows = sum(int(sh["__bucket__"].shape[0]) for sh in shards)
    telemetry.get_registry().counter(
        f"spmd.repartition.{link}.bytes").inc(rows * per_row_bytes)


def _route_local(shards: List[Dict], valids: List[torch.Tensor],
                 mesh: Mesh) -> Tuple[List[Dict], float]:
    """Move every valid row of every shard to the shard that owns it
    (`"__bucket__"` holds the owner) through the stages of
    `_route_slabs`; invalid rows go nowhere. `shards[s]` is {name:
    {"data": tensor}} plus "__bucket__", as `parallel/build._route_stage`
    takes it. Every hop keeps source order, so each destination holds
    its rows in ascending source (shard, row) order. Returns (received
    shards, seconds of the count reads)."""
    from hyperspace_tpu_torch.parallel.build import _route_stage

    per_row = shards[0]["__bucket__"].element_size() + sum(
        entry[leaf].element_size() for name, entry in shards[0].items()
        if name != "__bucket__" for leaf in ("data", "validity")
        if leaf in entry)
    sync_s = 0.0
    for stage, (link, groups, n_peers, dest) in enumerate(
            _route_slabs(mesh)):
        dests = [dest(sh["__bucket__"]) for sh in shards]
        if stage == 0:
            dests = [torch.where(v, d, torch.full_like(d, n_peers))
                     for d, v in zip(dests, valids)]
        shards, seconds = _route_stage(shards, dests, groups, n_peers,
                                       mesh.devices)
        sync_s += seconds
        _record_repartition_bytes(link, shards, per_row)
    return shards, sync_s


def _repartition_lanes(lanes: List[List[torch.Tensor]],
                       hash_lanes: List[torch.Tensor],
                       null: List[torch.Tensor], valid: List[torch.Tensor],
                       gid: List[torch.Tensor], num_buckets_to: int,
                       mesh: Mesh):
    """Re-bucket one side's KEY LANES (with null flags and original flat
    row ids) to `num_buckets_to`: shard s's stacked `hash_lanes[s]`
    (`routing_lanes`) go through the hash kernel for its target bucket
    ids, `mesh.bucket_owner` names each row's shard, and `_route_local`
    moves the valid rows there. The hash lanes route only; payload
    never moves. Returns per shard (lanes, null, gid) of the rows it
    now owns, and the count-read seconds."""
    from hyperspace_tpu_torch.ops.cuda.hash_kernel import (
        hash_lanes_to_buckets)

    n_shards = total_shards(mesh)
    shards = []
    for s in range(n_shards):
        bucket = hash_lanes_to_buckets(hash_lanes[s], num_buckets_to)
        shard = {"__bucket__": bucket_owner(bucket.to(torch.int64),
                                            num_buckets_to, n_shards),
                 "null": {"data": null[s]}, "gid": {"data": gid[s]}}
        for j, lane in enumerate(lanes[s]):
            shard[f"lane{j}"] = {"data": lane}
        shards.append(shard)
    routed, sync_s = _route_local(shards, valid, mesh)
    out = [([sh[f"lane{j}"]["data"] for j in range(len(lanes[0]))],
            sh["null"]["data"], sh["gid"]["data"]) for sh in routed]
    telemetry.get_registry().counter("mesh.spmd.repartition_execs").inc()
    return out, sync_s


# ---------------------------------------------------------------------------
# The match and the expansion
# ---------------------------------------------------------------------------


def _match_expand(l_lanes, l_marker, r_lanes, r_marker, left_outer: bool,
                  need_right: bool, membership: Optional[str]) -> Dict:
    """One shard's counting match over the concatenated [Cl + Cr]
    sequence: ONE stable sort by (marker, *lanes) — the JAX (pad, null,
    *lanes, side, slot) order, since left rows precede right rows and
    every pass is stable — then runs from adjacent differences and
    right-run brackets by cumulative counting (`ops/join`). Returns the
    sorted positions and, as 0-d tensors for the join's one count read,
    the shard's output `count` and unmatched-right `extra`."""
    from hyperspace_tpu_torch.ops.join import _run_bounds

    Cl = l_marker.shape[0]
    operands = [torch.cat([l_marker, r_marker])] + [
        torch.cat([a, b]) for a, b in zip(l_lanes, r_lanes)]
    perm, ops_s = keymod.staged_sort(operands)
    marker_s = ops_s[0]
    side_s = (perm >= Cl).to(torch.int64)
    differs = torch.zeros(perm.shape[0] - 1, dtype=torch.bool,
                          device=perm.device)
    for k in ops_s:
        differs |= k[1:] != k[:-1]
    run_first, run_last = _run_bounds(differs)
    R = torch.cumsum(side_s, 0)
    rights = R[run_last] - R[run_first] + side_s[run_first]
    is_left = (side_s == 0) & (marker_s != _PAD_L)
    out = {"perm": perm, "extra": torch.zeros((), dtype=torch.int64,
                                              device=perm.device)}
    if membership is not None:
        # Anti keeps null-key left rows (NOT EXISTS).
        hit = is_left & ((rights == 0) if membership == "anti"
                         else (rights > 0))
        out.update(hit=hit, count=hit.sum())
        return out
    counts = torch.where(is_left & (marker_s == _VALID), rights, 0)
    if left_outer:
        counts = torch.where(is_left, torch.clamp(counts, min=1), 0)
    out.update(counts=counts, starts=torch.cumsum(counts, 0) - counts,
               rights=rights, rstart=run_last - rights + 1,
               count=counts.sum())
    if need_right:
        lefts = run_last - run_first + 1 - rights
        un = ((side_s == 1) & (marker_s != _PAD_R)
              & ((marker_s == _NULL_R) | (lefts == 0)))
        out.update(un=un, extra=un.sum())
    return out


def _join_step(l_in, r_in, Cl: int, left_outer: bool, need_right: bool,
               membership: Optional[str], home):
    """Every shard's match, ONE host read of all shards' (count, extra),
    then every shard's exact expansion; the outputs concatenated in shard
    order on `home`. `l_in`/`r_in` are per shard (lanes, marker) and
    (lanes, marker, gid). Returns ((li, ri) | li, per-shard counts,
    count-read seconds)."""
    from hyperspace_tpu_torch.ops.join import _counting_expand
    from hyperspace_tpu_torch.parallel.scan import _compact

    matches = [_match_expand(ll, lm, rl, rm, left_outer, need_right,
                             membership)
               for (ll, lm), (rl, rm, _gid) in zip(l_in, r_in)]
    t0 = time.perf_counter()
    table = torch.stack([torch.stack([m["count"], m["extra"]]).to(home)
                         for m in matches]).tolist()
    sync_s = time.perf_counter() - t0
    counts = [int(c) for c, _e in table]
    li_parts, ri_parts, un_parts = [], [], []
    for s, (m, (count, extra)) in enumerate(zip(matches, table)):
        perm = m["perm"]
        gid = r_in[s][2]
        if membership is not None:
            pos = _compact(m["hit"], int(count))
            li_parts.append((perm[pos] + s * Cl).to(home))
            continue
        if count:
            li, ri = _counting_expand(m["counts"], m["starts"], m["rights"],
                                      m["rstart"], perm, int(count),
                                      left_outer)
            ri = (torch.where(ri >= 0, gid[torch.clamp(ri - Cl, min=0)], -1)
                  if gid.numel() else torch.full_like(ri, -1))
            li_parts.append((li + s * Cl).to(home))
            ri_parts.append(ri.to(home))
        if extra:
            pos = _compact(m["un"], int(extra))
            un_parts.append(gid[perm[pos] - Cl].to(home))

    def cat(parts):
        return (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.int64, device=home))

    if membership is not None:
        return cat(li_parts), counts, sync_s
    li, ri = cat(li_parts), cat(ri_parts)
    if un_parts:
        extra = cat(un_parts)
        li = torch.cat([li, torch.full_like(extra, -1)])
        ri = torch.cat([ri, extra])
    return (li, ri), counts, sync_s


join_step = instrumented_device("mesh.spmd_join", _join_step)


# Per-device dispatch serialization: concurrent serving queries on one
# mesh each drive every shard from their own thread; one reentrant lock
# per device-tag entry, taken in sorted order (cycle-free), keeps two
# queries' shard lists from interleaving, while queries over disjoint
# shard sets still run side by side.
_DEVICE_LOCKS: Dict[int, threading.RLock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


@contextlib.contextmanager
def dispatch_guard(mesh: Mesh):
    """THE per-device dispatch lock set of `mesh` (reentrant): held
    around a sharded join's reads, match and output assembly, and around
    the sharded filter, aggregate and repartition."""
    tag = mesh_device_tag(mesh)
    with _DEVICE_LOCKS_GUARD:
        locks = []
        for did in sorted(set(tag)):
            lock = _DEVICE_LOCKS.get(did)
            if lock is None:
                lock = threading.RLock()
                _DEVICE_LOCKS[did] = lock
            locks.append(lock)
    with contextlib.ExitStack() as stack:
        for lock in locks:
            stack.enter_context(lock)
        yield


def _join_capacity(left: ShardedBatch, right: ShardedBatch,
                   left_outer: bool) -> Optional[List[int]]:
    """The exact per-shard upper bound on a co-bucketed join's output —
    sum over the shard's buckets of l_b * r_b (+ l_b for outer) — when
    both bucket histograms are known, else None. The JAX package sizes
    its static capacity from it; here it checks the exact sizes."""
    if (left.lengths is None or right.lengths is None
            or len(left.lengths) != len(right.lengths)
            or left.split_plan is not None
            or right.split_plan is not None):
        return None
    ll = left.lengths.astype(np.int64)
    rl = right.lengths.astype(np.int64)
    per_bucket = ll * rl + (ll if left_outer else 0)
    return [int(per_bucket[lo:hi].sum())
            for lo, hi in bucket_ranges(len(ll), left.n_shards)]


def _shard_rows_attribution(left: ShardedBatch, right: ShardedBatch):
    """Per-shard TRUE input rows (the mesh telemetry's load-balance
    attribution): from the bucket histograms when known, else the
    padded per-shard capacities."""
    S = left.n_shards
    out = []
    for sh in (left, right):
        if sh.lengths is not None and sh.split_plan is None:
            segs = shard_row_segments(sh.lengths, S)
            out.append([e - s for s, e in segs])
        else:
            out.append([sh.rows_per_shard] * S)
    return [lr + rr for lr, rr in zip(*out)]


def _check_one_mesh(left: ShardedBatch, right: ShardedBatch):
    if left.mesh is not right.mesh and \
            mesh_device_list(left.mesh) != mesh_device_list(right.mesh):
        raise HyperspaceException("sharded join requires one mesh")


def _repartition_target(left: ShardedBatch,
                        right: ShardedBatch) -> Optional[int]:
    """The bucket count the right side re-buckets to (the left's), or
    None for co-bucketed sides. Flat and 2-axis meshes alike."""
    if right.num_buckets == left.num_buckets:
        return None
    return left.num_buckets


def _side_keys(sh: ShardedBatch, s: int, keys: Sequence[str], dtypes,
               remaps: Dict[int, Dict], side: int):
    """Shard s's match lanes and marker lane: string codes mapped
    through the pair's rank tables, numerics in the pair's common dtype;
    the marker says valid (0), null key (1 left / 2 right) or padding
    (3 / 4)."""
    shard, valid = sh.shards[s], sh.row_valid[s]
    dev = sh.mesh.devices[s]
    lanes: List[torch.Tensor] = []
    ok = None
    for i, name in enumerate(keys):
        col = shard.column(name)
        data = col.data
        if i in remaps:
            data = remaps[i][dev][side][data.to(torch.int64)]
        else:
            data = data.to(dtypes[i])
        lanes.extend(keymod.key_lanes(data))
        if col.validity is not None:
            ok = col.validity if ok is None else ok & col.validity
    null = torch.zeros_like(valid) if ok is None else ~ok
    marker = torch.where(
        ~valid, _PAD_R if side else _PAD_L,
        torch.where(null, _NULL_R if side else _NULL_L, _VALID)
    ).to(torch.int32)
    return lanes, marker, null


def _join_inputs(left: ShardedBatch, right: ShardedBatch,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 conf=None):
    """Per shard, the left (lanes, marker) and the right (lanes, marker,
    flat row ids): the right side re-bucketed between shards first when
    its bucket count differs (`_repartition_lanes`). Returns (l_in,
    r_in, count-read seconds of the exchange)."""
    if len(left_keys) != len(right_keys) or not left_keys:
        raise HyperspaceException("Join requires matching key column lists.")
    remaps = _string_key_plan(left, right, left_keys, right_keys, conf=conf)
    dtypes = [None if i in remaps else torch.promote_types(
        left.shards[0].column(lk).data.dtype,
        right.shards[0].column(rk).data.dtype)
        for i, (lk, rk) in enumerate(zip(left_keys, right_keys))]
    S = left.n_shards
    l_in = [_side_keys(left, s, left_keys, dtypes, remaps, 0)[:2]
            for s in range(S)]
    r_sides = [_side_keys(right, s, right_keys, dtypes, remaps, 1)
               for s in range(S)]
    Cr = right.rows_per_shard
    gids = [torch.arange(Cr, dtype=torch.int64, device=dev) + s * Cr
            for s, dev in enumerate(right.mesh.devices)]
    target = _repartition_target(left, right)
    if target is None:
        r_in = [(lanes, marker, gid)
                for (lanes, marker, _null), gid in zip(r_sides, gids)]
        return l_in, r_in, 0.0
    routed, sync_s = _repartition_lanes(
        [lanes for lanes, _m, _n in r_sides],
        routing_lanes(right, right_keys, dtypes), [n for *_x, n in r_sides],
        right.row_valid, gids, target, left.mesh)
    r_in = [(lanes, torch.where(null, _NULL_R, _VALID).to(torch.int32), gid)
            for lanes, null, gid in routed]
    return l_in, r_in, sync_s


def _run_join(left: ShardedBatch, right: ShardedBatch,
              left_keys: Sequence[str], right_keys: Sequence[str],
              how: str, conf):
    """The shared body of the pair and membership joins."""
    _check_one_mesh(left, right)
    mesh = left.mesh
    S = total_shards(mesh)
    membership = ({"left_semi": "semi", "left_anti": "anti"}.get(how))
    left_outer = how in ("left_outer", "full_outer")
    reg = telemetry.get_registry()
    tracer = telemetry.tracer()
    span_ts = tracer.now_us() if tracer is not None else 0.0
    with dispatch_guard(mesh), telemetry.span(
            "mesh:join:spmd", "mesh", how=how, shards=S):
        l_in, r_in, route_s = _join_inputs(left, right, left_keys,
                                           right_keys, conf)
        out, counts, sync_s = join_step(l_in, r_in, left.rows_per_shard,
                                        left_outer, how == "full_outer",
                                        membership, mesh.devices[0])
    bound = None if membership else _join_capacity(left, right, left_outer)
    if bound is not None and any(c > b for c, b in zip(counts, bound)):
        raise HyperspaceException(
            f"sharded join: shard outputs {counts} exceed the bucket "
            f"histograms' bound {bound}")
    sync_s += route_s
    reg.counter("mesh.join.sync_s").inc(sync_s)
    telemetry.add_seconds("mesh.sync_s", sync_s)
    reg.counter("mesh.join.execs").inc()
    reg.counter("mesh.spmd.join_execs").inc()
    shard_rows = _shard_rows_attribution(left, right)
    for rows in shard_rows:
        reg.histogram("mesh.join.shard_rows").observe(rows)
    telemetry.event("mesh", "join", how=membership or how, shards=S,
                    pairs=int(sum(counts)), lane="spmd",
                    shard_rows=shard_rows)
    if tracer is not None:
        # Per-shard tracks: each shard's output pairs show its skew.
        tracer.device_spans("join", span_ts, counts, how=membership or how)
    return out


def sharded_join_indices(left: ShardedBatch, right: ShardedBatch,
                         left_keys: Sequence[str],
                         right_keys: Sequence[str], how: str = "inner",
                         conf=None):
    """Join-pair indices over two born-sharded sides: per shard the
    counting match and its exact expansion, after an in-mesh re-bucket
    of the right side when the bucket counts differ. Returns (li, ri),
    int64 tensors on the mesh's first device indexing the two sides'
    FLAT padded row spaces (-1: the unmatched side of an outer row).
    `how`: inner / left_outer / full_outer (callers swap sides for
    right_outer). The output is sized exactly (module docstring)."""
    if how not in ("inner", "left_outer", "full_outer"):
        raise HyperspaceException(
            f"sharded join supports inner/left_outer/full_outer; "
            f"got {how}.")
    if left.split_plan is not None and how == "full_outer":
        # Replicated right rows break per-shard unmatched-right
        # uniqueness; callers route full_outer off the sub-shard lane.
        raise HyperspaceException(
            "virtual sub-shard joins support inner/left_outer only.")
    return _run_join(left, right, left_keys, right_keys, how, conf)


def sharded_semi_anti_indices(left: ShardedBatch, right: ShardedBatch,
                              left_keys: Sequence[str],
                              right_keys: Sequence[str],
                              anti: bool = False, conf=None):
    """LEFT SEMI / LEFT ANTI membership over born-sharded sides through
    the same per-shard match (anti emits null-key left rows — NOT EXISTS
    semantics). Returns int64 indices into the left flat padded space."""
    return _run_join(left, right, left_keys, right_keys,
                     "left_anti" if anti else "left_semi", conf)


# ---------------------------------------------------------------------------
# Stage to stage: repartition, filter, aggregate over the sharded layout
# ---------------------------------------------------------------------------


def _tree_bytes(trees) -> int:
    return sum(int(leaf.numel()) * leaf.element_size()
               for tree in trees for name, entry in tree.items()
               if name != "__bucket__" for leaf in entry.values()
               if isinstance(leaf, torch.Tensor))


def _repartition_cost(valids, trees, key_names, num_buckets, mesh):
    """Modeled (operations, bytes accessed) of one repartition: every
    lane read once and written once at its destination, one hash step
    per key lane and row plus the owner division."""
    rows = sum(int(v.shape[0]) for v in valids)
    return rows * (len(key_names) + 1), 2 * _tree_bytes(trees)


def _repartition_step(valids, trees, key_names, num_buckets, mesh):
    """Each shard's bucket ids through the hash kernel, their
    contiguous-range owners, then the exchange (`_route_local`).
    Returns (routed trees, seconds of the count reads)."""
    from hyperspace_tpu_torch.ops.build import _tree_bucket_ids

    n_shards = total_shards(mesh)
    for tree in trees:
        bucket = _tree_bucket_ids(tree, key_names, num_buckets)
        tree["__bucket__"] = bucket_owner(bucket.to(torch.int64),
                                          num_buckets, n_shards)
    return _route_local(trees, valids, mesh)


repartition_step = instrumented_device("mesh.spmd_repartition",
                                       _repartition_step,
                                       cost=_repartition_cost)


def repartition_sharded(batch: ColumnBatch, key_columns: Sequence[str],
                        num_buckets: int, mesh: Mesh) -> ShardedBatch:
    """Re-bucket a batch (a join output feeding the next join, say) into
    a born-sharded layout: rows split evenly over the shards
    (`parallel/scan.shard_batch`), each shard's bucket ids from the hash
    kernel, the contiguous-range owner, then the exchange of
    `_route_local` (one stage flat, ICI then DCN on a 2-axis mesh),
    which moves every column. Each shard keeps the rows it received in
    source order, padded to the largest shard's count; no per-bucket
    histogram is made."""
    from hyperspace_tpu_torch.io.columnar import batch_to_tree, tree_to_batch
    from hyperspace_tpu_torch.parallel.scan import shard_batch

    n_shards = total_shards(mesh)
    key_names = tuple([batch.schema.field(c).name for c in key_columns])
    with dispatch_guard(mesh):
        pieces, valids = shard_batch(batch, mesh)
        trees = []
        aux = {}
        for piece in pieces:
            tree, aux = batch_to_tree(piece)
            trees.append(tree)
        routed, sync_s = repartition_step(valids, trees, key_names,
                                          num_buckets, mesh)
    rows = [int(tree["__bucket__"].shape[0]) for tree in routed]
    C = max(1, max(rows))
    shards, row_valid = [], []
    for tree, n, dev in zip(routed, rows, mesh.devices):
        padded = {}
        for name, entry in tree.items():
            if name == "__bucket__":
                continue
            padded[name] = dict(entry)
            for leaf in ("data", "validity"):
                if leaf in entry:
                    value = entry[leaf]
                    out = torch.zeros((C,) + tuple(value.shape[1:]),
                                      dtype=value.dtype, device=dev)
                    out[:n] = value
                    padded[name][leaf] = out
        shards.append(tree_to_batch(padded, batch.schema, aux))
        row_valid.append(torch.arange(C, device=dev) < n)
    reg = telemetry.get_registry()
    reg.counter("mesh.spmd.repartition_execs").inc()
    reg.counter("mesh.join.sync_s").inc(sync_s)
    telemetry.add_seconds("mesh.sync_s", sync_s)
    telemetry.event("mesh", "repartition", shards=n_shards,
                    buckets=num_buckets, rows=batch.num_rows, lane="spmd")
    return ShardedBatch(shards, row_valid, mesh, C, num_buckets)


def _filter_cost(valids, shards, expression):
    """Modeled (operations, bytes accessed) of one sharded filter: each
    referenced column and the validity masks read once, the masks
    written once; one operation per referenced column and row."""
    refs = [r for r in expression.references()
            if r in shards[0].columns]
    rows = sum(int(v.shape[0]) for v in valids)
    read = sum(int(shard.columns[r].data.numel())
               * shard.columns[r].data.element_size()
               for shard in shards for r in refs)
    return rows * max(1, len(refs)), read + 2 * rows


def _filter_step(valids, shards, expression):
    """Each shard's compiled predicate under its validity mask."""
    from hyperspace_tpu_torch.engine.compiler import compile_predicate

    return [compile_predicate(expression, shard) & valid
            for shard, valid in zip(shards, valids)]


filter_step = instrumented_device("mesh.spmd_filter", _filter_step,
                                  cost=_filter_cost)


def sharded_filter(sh: ShardedBatch, expression) -> ColumnBatch:
    """Predicate scan over the born-sharded layout: each shard evaluates
    the compiled predicate with its validity mask, one read of every
    shard's selected count, each shard compacts its own rows, and the
    pieces concatenate in shard order on the mesh's first device — the
    single-device `apply_filter` over the flat rows, bit for bit."""
    from hyperspace_tpu_torch.parallel.scan import _compact, concat_shards

    reg = telemetry.get_registry()
    count_string_predicate_lookups(expression, sh.shards[0])
    home = sh.mesh.devices[0]
    with telemetry.span("mesh:filter", "mesh", shards=sh.n_shards), \
            dispatch_guard(sh.mesh):
        masks = filter_step(sh.row_valid, sh.shards, expression)
        t0 = time.perf_counter()
        counts = torch.stack([m.sum().to(home) for m in masks]).tolist()
        sync_s = time.perf_counter() - t0
        reg.counter("mesh.filter.execs").inc()
        reg.counter("mesh.filter.sync_s").inc(sync_s)
        telemetry.add_seconds("mesh.sync_s", sync_s)
        telemetry.event("mesh", "filter", shards=sh.n_shards,
                        selected=int(sum(counts)), lane="spmd")
        pieces = [shard.take(_compact(mask, int(c)))
                  for shard, mask, c in zip(sh.shards, masks, counts)]
        return concat_shards(pieces, sh.schema, home)


def sharded_group_aggregate(sh: ShardedBatch,
                            group_columns: Sequence[str], aggregates,
                            out_schema) -> ColumnBatch:
    """Group-by aggregation straight over the born-sharded layout: the
    per-shard partials read the resident shards and their validity
    masks, with no placement; only the small partial tables cross to the
    host for the combine (`parallel/aggregate.py`)."""
    from hyperspace_tpu_torch.parallel.aggregate import (
        distributed_group_aggregate)

    with dispatch_guard(sh.mesh):
        return distributed_group_aggregate(
            sh.batch, group_columns, aggregates, out_schema, sh.mesh,
            pre_sharded=(sh.shards, sh.row_valid))


# ---------------------------------------------------------------------------
# The inter-query batched predicate lane (module docstring)
# ---------------------------------------------------------------------------


# One shape term is a tuple:
#   ("cmp", op, col_index, lane)       lane: "i" (int64) | "f" (float64)
#   ("in", col_index, padded_len)      int lane, `padded_len` values
#   ("isnull"|"notnull", col_index)
_OPS = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


def _masks_cost(shape, datas, valids, iconst, fconst):
    """Modeled (operations, bytes accessed) for the device seam: every
    referenced column and validity mask read once, the [K, N] mask
    written once; one compare (plus one AND) per row, member and
    compared value."""
    n = int(datas[0].shape[0]) if datas else 0
    k = int(iconst.shape[0])
    read = sum(int(d.numel()) * d.element_size() for d in datas)
    read += sum(int(v.numel()) for v in valids if v is not None)
    ops = 0
    for term in shape:
        width = term[2] if term[0] == "in" else 1
        ops += 2 * n * k * width
    return ops, read + n * k


@instrumented_device("serve.batch", cost=_masks_cost)
def _evaluate(shape: tuple, datas: tuple, valids: tuple,
              iconst: torch.Tensor, fconst: torch.Tensor) -> torch.Tensor:
    """The stacked program over tensors that all live on one device."""
    total: Optional[torch.Tensor] = None
    ii = fi = 0
    for term in shape:
        kind = term[0]
        if kind == "cmp":
            _k, op, ci, lane = term
            data = datas[ci]
            if lane == "f":
                const = fconst[:, fi]
                fi += 1
            else:
                const = iconst[:, ii]
                ii += 1
            if data.dtype.is_floating_point:
                # Compare in the column's own float width (the solo
                # path's weak-scalar promotion).
                const = const.to(data.dtype)
            elif lane == "f":
                # Int column against a float literal: float64 on both
                # paths.
                data = data.to(torch.float64)
            else:
                # Integer compares are exact at any width; lift the
                # column to int64 so the [K] lane broadcasts without
                # narrowing the literal.
                data = data.to(torch.int64)
            m = _OPS[op](data[None, :], const[:, None])
        elif kind == "in":
            _k, ci, padded = term
            vals = iconst[:, ii:ii + padded]
            ii += padded
            data = datas[ci].to(torch.int64)[None, :]
            # One [K, N] compare per padded value (the JAX program's
            # [K, N, P] any() without materializing P copies).
            m = data == vals[:, 0:1]
            for p in range(1, padded):
                m |= data == vals[:, p:p + 1]
        elif kind == "isnull":
            _k, ci = term
            v = valids[ci]
            n = datas[ci].shape[0]
            m = (torch.zeros((1, n), dtype=torch.bool,
                             device=datas[ci].device)
                 if v is None else (~v)[None, :])
        else:  # notnull
            _k, ci = term
            v = valids[ci]
            n = datas[ci].shape[0]
            m = (torch.ones((1, n), dtype=torch.bool,
                            device=datas[ci].device)
                 if v is None else v[None, :])
        if kind in ("cmp", "in"):
            v = valids[term[2] if kind == "cmp" else term[1]]
            if v is not None:
                m = m & v[None, :]
        total = m if total is None else total & m
    # A constants-free shape evaluates as one [1, N] row — broadcast so
    # every member slices its own lane regardless.
    return total.expand(iconst.shape[0], total.shape[1])


def _as_tensor(arr, device: torch.device) -> torch.Tensor:
    """A tensor view of a column (read-only Arrow-owned numpy arrays
    included: the program never writes its inputs)."""
    if isinstance(arr, torch.Tensor):
        return arr
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def batched_predicate_masks(shape: tuple, datas: Sequence,
                            valids: Sequence, iconst, fconst) -> torch.Tensor:
    """THE batched-execution entry point: evaluate the K stacked
    predicates described by `shape` over the shared columns. `datas` is
    one array per referenced column (shape order indexes into it),
    `valids` the matching validity masks (None for a column without
    one), `iconst`/`fconst` the [K_bucket, T] padded constant lanes
    (int64 / float64). Columns are torch tensors on one device (the
    device lane) or numpy arrays (the host lane, evaluated with torch on
    the CPU). Returns the [K_bucket, N] boolean mask matrix on the
    columns' device; callers slice rows per member there."""
    device = next((d.device for d in datas if isinstance(d, torch.Tensor)),
                  torch.device("cpu"))
    datas_t = tuple([_as_tensor(d, device) for d in datas])
    valids_t = tuple([None if v is None else _as_tensor(v, device)
                      for v in valids])
    iconst_t = (iconst.to(device, torch.int64)
                if isinstance(iconst, torch.Tensor)
                else _as_tensor(np.asarray(iconst, dtype=np.int64), device))
    fconst_t = (fconst.to(device, torch.float64)
                if isinstance(fconst, torch.Tensor)
                else _as_tensor(np.asarray(fconst, dtype=np.float64),
                                device))
    return _evaluate(tuple(shape), datas_t, valids_t, iconst_t, fconst_t)
