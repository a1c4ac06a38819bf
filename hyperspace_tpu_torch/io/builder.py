"""The index build pipeline — the framework's hot data path.

Reference equivalent: `CreateActionBase.write` =
`df.select(indexed++included).repartition(numBuckets, indexedCols)
.write.saveWithBuckets(...)` (`actions/CreateActionBase.scala:99-120`) — a
distributed JVM shuffle + per-bucket sort + parquet encode.

Pipeline on one device:
1. decode the source parquet (host, pyarrow): the payload columns on a
   background thread, the key columns on the calling thread;
2. stage the KEY columns on the device through the transfer engine
   (`io/transfer.py`: pinned, chunked, asynchronous copies);
3. bucket ids from the hand-written hash kernel, then ONE stable
   (bucket, *keys) sort — this both groups rows by bucket and sorts within
   buckets (`ops/build.py`);
4. bucket boundaries via two searchsorted calls; the int64 permutation
   crosses back to the host in pieces cut at bucket boundaries, every
   piece's copy issued up front;
5. the host applies each piece of the permutation to the Arrow table, and
   one writer thread encodes one parquet file per bucket while the next
   piece is fetched and gathered.

Each phase's wall seconds on the calling thread accumulate in the process
registry as `build.phase.<decode|h2d|bucket_sort|d2h|write>_s` (device
phases end in a synchronize; `decode` counts the key decode plus the wait
for the payload thread, `write` the gathers plus the waits for the
writer).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar, parquet
from hyperspace_tpu_torch.plan.nodes import BucketSpec

BUILD_PHASES = ("decode", "h2d", "bucket_sort", "d2h", "write")


@contextmanager
def _phase(name: str, device: Optional[torch.device] = None):
    """Time one build phase into `build.phase.<name>_s`; a CUDA phase
    ends in a synchronize so its device work lands inside it."""
    from hyperspace_tpu_torch import telemetry

    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    telemetry.get_registry().counter(f"build.phase.{name}_s").inc(
        time.perf_counter() - t0)


def _bucket_pieces(starts, ends, count: int):
    """Up to `count` [b_lo, b_hi) bucket ranges of about equal rows,
    covering every bucket in order. A piece always ends at a bucket
    boundary, so no bucket is ever split between two pieces."""
    n_buckets = len(ends)
    total = int(ends[-1]) if n_buckets else 0
    cuts = [0]
    for k in range(1, count):
        b = int(np.searchsorted(ends, total * k // count, side="left")) + 1
        if cuts[-1] < b < n_buckets:
            cuts.append(b)
    cuts.append(n_buckets)
    return list(zip(cuts[:-1], cuts[1:]))


def _write_sorted_runs(table, perm, starts, ends, path: str,
                       file_suffix: Optional[str]) -> List[str]:
    """Apply the (bucket, *keys) sort permutation to the host table and
    write one file per non-empty bucket. `perm`, `starts` and `ends` are
    numpy arrays or tensors.

    A device permutation crosses in up to `d2h_chunk_count` pieces cut at
    bucket boundaries, and every piece's copy is issued up front
    (transfer-engine prefetch), so piece i+1 is in flight while piece i
    is gathered (Arrow `take`). Each bucket's parquet encode runs on the
    single writer thread while the next piece is fetched and gathered
    (one piece of write depth, so write order stays deterministic).
    Cutting at bucket boundaries keeps the layout of one file per
    bucket."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io import transfer
    from hyperspace_tpu_torch.utils import file_utils

    engine = transfer.get_engine()
    with _phase("d2h"):
        starts, ends = engine.fetch(starts), engine.fetch(ends)
    count = 1
    if isinstance(perm, torch.Tensor):
        count = engine.d2h_chunk_count(perm.numel() * perm.element_size())
    pieces = _bucket_pieces(starts, ends, count)
    views = [perm[int(starts[lo]):int(ends[hi - 1])] for lo, hi in pieces]
    engine.prefetch(*views)
    written: List[str] = []
    file_utils.create_directory(path)
    pending: List = []  # the last piece's in-flight writes

    def drain():
        for fut in pending:
            fut.result()
        pending.clear()

    from hyperspace_tpu_torch import telemetry

    t0 = time.perf_counter()
    fetch_s = 0.0
    try:
        for (lo, hi), view in zip(pieces, views):
            # Piece-boundary cancellation checkpoint: a cancelled query
            # (or a deadline-capped maintenance caller) stops WITHOUT
            # queueing further writes — the finally drain below leaves
            # already-submitted files landed, the partial-dir story the
            # `_committed` marker already makes crash-safe.
            telemetry.check_deadline("write")
            f0 = time.perf_counter()
            piece = engine.fetch(view)
            fetch_s += time.perf_counter() - f0
            if not len(piece):
                continue
            piece_table = table.take(pa.array(piece))
            offset = int(starts[lo])
            # The previous piece's encodes land before this piece's are
            # queued: single-writer FIFO keeps the write order serial.
            drain()
            for b in range(lo, hi):
                s, e = int(starts[b]), int(ends[b])
                if e <= s:
                    continue  # empty bucket -> no file (Spark parity)
                out = os.path.join(path,
                                   parquet.bucket_file_name(b, file_suffix))
                pending.append(_writer_pool().submit(
                    parquet.write_table,
                    piece_table.slice(s - offset, e - s), out))
                written.append(out)
    finally:
        drain()
        registry = _registry()
        registry.counter("build.phase.d2h_s").inc(fetch_s)
        registry.counter("build.phase.write_s").inc(
            time.perf_counter() - t0 - fetch_s)
    return written


def _registry():
    from hyperspace_tpu_torch import telemetry
    return telemetry.get_registry()


# Single-worker writer behind `_write_sorted_runs`: ONE lane keeps file
# writes in deterministic submission order while still overlapping a
# piece's parquet encode with the next piece's permutation fetch + Arrow
# gather. Lazy module-level pool — a per-build executor would churn a
# thread per maintenance action.
_writer = None
_writer_lock = threading.Lock()


def _writer_pool():
    global _writer
    if _writer is None:
        with _writer_lock:
            if _writer is None:
                from concurrent.futures import ThreadPoolExecutor
                _writer = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="hs-bucket-writer")
    return _writer


def shutdown_writer_pool(wait: bool = True) -> None:
    """Drain + stop the single-lane bucket writer (idempotent, lazily
    re-created; atexit hook — a queued parquet encode must land before
    interpreter teardown)."""
    global _writer
    with _writer_lock:
        pool, _writer = _writer, None
    if pool is not None:
        pool.shutdown(wait=wait)


import atexit as _atexit  # noqa: E402

_atexit.register(shutdown_writer_pool)


# Below this row count the build permutation is computed on the host
# (numpy): launching device work and moving the keys cannot pay off for
# small builds. Bucket assignment uses the host mirror of THE hash
# identity, so the on-disk layout is indistinguishable from a device build.
BUILD_MIN_DEVICE_ROWS = 1_000_000


def build_lane(rows: int, device: Optional[torch.device] = None) -> str:
    """Which permutation engine a HOST-resident build of `rows` rows
    takes for a session on `device`: "host-lexsort" (a small build, or no
    device and no native library), "native-host" (the C++ radix sort of
    `hyperspace_tpu_torch/native`, when the session's device is the CPU
    or absent and the library loads) or "device" (the hash kernel and the
    torch sort on the session's device). The JAX package routes every
    build of 1M to 2^31 rows to its native lane once its library loads —
    a choice made for a TPU behind a slow link; on a CUDA card the device
    lane keeps the build (`chip_smoke.py` times both permutations). Above
    2^31 rows the native lane's int32 permutation would wrap."""
    from hyperspace_tpu_torch import native

    if rows < BUILD_MIN_DEVICE_ROWS:
        return "host-lexsort"
    on_card = device is not None and torch.device(device).type == "cuda"
    if not on_card and rows < 1 << 31 and native.get_lib() is not None:
        return "native-host"
    return "host-lexsort" if device is None else "device"


def _host_lane_preferred(rows: int,
                         device: Optional[torch.device] = None) -> bool:
    return build_lane(rows, device) != "device"


def _host_build_permutation(table, names: Sequence[str], num_buckets: int):
    """Host (bucket, *keys) stable sort permutation + bucket boundaries,
    mirroring the device layout semantics: the native C++ radix sort when
    the library loads (`native.bucket_key_sort_perm`), numpy's lexsort
    otherwise — the same permutation either way."""
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.ops.host_hash import (host_column_hash_lanes,
                                                    host_flat_hash32)
    from hyperspace_tpu_torch.ops.keys import host_column_sort_lanes

    batch = columnar.from_arrow(table.select(names))
    hash_lanes: List = []
    for name in names:
        hash_lanes.extend(host_column_hash_lanes(batch.column(name)))
    bucket = (host_flat_hash32(hash_lanes)
              % np.uint32(num_buckets)).astype(np.int32)
    sort_lanes: List = []
    for name in names:
        sort_lanes.extend(host_column_sort_lanes(batch.column(name)))
    nat = native.bucket_key_sort_perm(bucket, num_buckets, sort_lanes)
    if nat is not None:
        return nat
    perm = np.lexsort(tuple(reversed([bucket] + sort_lanes)))
    sorted_bucket = bucket[perm]
    starts = np.searchsorted(sorted_bucket, np.arange(num_buckets), "left")
    ends = np.searchsorted(sorted_bucket, np.arange(num_buckets), "right")
    return perm.astype(np.int64), starts, ends


def _stage_key_tree(table, names: Sequence[str], device: torch.device):
    """Stage the key columns of a host Arrow table on `device` as a key
    tree for `ops.build.permutation_from_tree`, with narrow transport: a
    null-free int64 column whose values fit uint32 (host range check)
    ships HALF the bytes as a single `lo32` lane (its uint32 bit pattern
    in an int32 tensor) — hash identity and sort order are unchanged
    (`ops/build.py`). Every copy rides the transfer engine: chunked, cast
    into reused pinned staging buffers on the card."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io import transfer

    engine = transfer.get_engine()
    tree = {}
    wide = []
    for name in names:
        arr = table.column(name)
        chunk = (arr.combine_chunks() if hasattr(arr, "combine_chunks")
                 else arr)
        if pa.types.is_int64(chunk.type) and chunk.null_count == 0:
            vals = chunk.to_numpy(zero_copy_only=False)
            if len(vals) and vals.min() >= 0 and vals.max() < 1 << 32:
                # int64 -> int32 wraps: the uint32 bit pattern.
                tree[name] = {"lo32": engine.put(
                    transfer.HostCast(vals, np.int32), device)}
                continue
        wide.append(name)
    if wide:
        batch = columnar.from_arrow(table.select(wide), device=device)
        staged, _aux = columnar.batch_to_tree(batch)
        tree.update(staged)
    return tree


def write_bucketed_table(table, indexed_columns: Sequence[str],
                         num_buckets: int, path: str,
                         file_suffix: Optional[str] = None,
                         device: Optional[torch.device] = None
                         ) -> List[str]:
    """Bucketed build from a HOST Arrow table: only the key columns touch
    the device (hash + sort -> permutation); payload rows never cross.
    Builds below BUILD_MIN_DEVICE_ROWS, or with no `device`, take the host
    lane."""
    from hyperspace_tpu_torch.ops.build import permutation_from_tree

    if table.num_rows == 0:
        from hyperspace_tpu_torch.utils import file_utils
        file_utils.create_directory(path)
        return []
    by_lower = {n.lower(): n for n in table.column_names}
    missing = [c for c in indexed_columns if c.lower() not in by_lower]
    if missing:
        raise HyperspaceException(
            f"Column not found in table: {', '.join(missing)}")
    names = [by_lower[c.lower()] for c in indexed_columns]
    if device is None or _host_lane_preferred(table.num_rows, device):
        perm, starts, ends = _host_build_permutation(table, names,
                                                     num_buckets)
    else:
        with _phase("h2d", device):
            tree = _stage_key_tree(table, names, device)
        with _phase("bucket_sort", device):
            perm, starts, ends = permutation_from_tree(tree, names,
                                                       num_buckets)
    return _write_sorted_runs(table, perm, starts, ends, path, file_suffix)


def write_bucketed_from_files(files: Sequence[str],
                              column_names: Sequence[str],
                              key_names: Sequence[str], num_buckets: int,
                              path: str, device: Optional[torch.device],
                              lineage_ids=None,
                              file_suffix: Optional[str] = None
                              ) -> List[str]:
    """Build straight from parquet files (the plain-scan create path).
    On the device lane the build is PIPELINED: the payload-column decode
    starts on a background thread first, then the key columns decode,
    cross to the device and sort, so the payload decode overlaps the key
    decode, the key H2D and the device sort; `_write_sorted_runs` then
    overlaps the permutation D2H, the Arrow gather and the parquet
    encode. The host lanes read every column at once."""
    import pyarrow as pa

    from hyperspace_tpu_torch.ops.build import permutation_from_tree

    n = sum(parquet.file_row_counts(files))  # footers only, no decode
    if device is None or _host_lane_preferred(n, device):
        with _phase("decode"):
            table = parquet.read_table(files, columns=list(column_names))
            if lineage_ids is not None:
                table = append_lineage_column(table, files, lineage_ids)
        return write_bucketed_table(table, list(key_names), num_buckets,
                                    path, file_suffix=file_suffix,
                                    device=device)
    payload_names = [c for c in column_names if c not in key_names]
    payload: dict = {}
    payload_thread = None
    if payload_names:
        # pyarrow releases the GIL for the column decode.
        def _decode_payload():
            try:
                payload["table"] = parquet.read_table(
                    files, columns=payload_names)
            except BaseException as exc:  # surfaces at the join below
                payload["error"] = exc

        payload_thread = threading.Thread(target=_decode_payload,
                                          name="hs-payload-decode",
                                          daemon=True)
        payload_thread.start()
    with _phase("decode"):
        key_table = parquet.read_table(files, columns=list(key_names))
    with _phase("h2d", device):
        tree = _stage_key_tree(key_table, key_names, device)
    with _phase("bucket_sort", device):
        perm, starts, ends = permutation_from_tree(tree, key_names,
                                                   num_buckets)
    with _phase("decode"):
        if payload_thread is not None:
            payload_thread.join()
            if "error" in payload:
                raise payload["error"]
            ptable = payload["table"]
            table = pa.table({c: (key_table.column(c) if c in key_names
                                  else ptable.column(c))
                              for c in column_names})
        else:
            table = key_table.select(list(column_names))
        if lineage_ids is not None:
            table = append_lineage_column(table, files, lineage_ids)
    return _write_sorted_runs(table, perm, starts, ends, path, file_suffix)


def write_bucketed_batch(batch: columnar.ColumnBatch,
                         indexed_columns: Sequence[str],
                         num_buckets: int, path: str,
                         file_suffix: Optional[str] = None) -> List[str]:
    """Bucketed build from a batch already produced by a plan (device or
    host lane): the permutation is computed where the batch lives and
    applied host-side."""
    from hyperspace_tpu_torch.ops.build import build_permutation

    if batch.num_rows == 0:
        from hyperspace_tpu_torch.utils import file_utils
        file_utils.create_directory(path)
        return []
    table = columnar.to_arrow(batch)
    if batch.is_host:
        return write_bucketed_table(table, indexed_columns, num_buckets,
                                    path, file_suffix=file_suffix)
    perm, starts, ends = build_permutation(batch, indexed_columns,
                                           num_buckets)
    return _write_sorted_runs(table, perm, starts, ends, path, file_suffix)


def _plain_scan_source(plan) -> Optional[tuple]:
    """If the plan is just Project*(Scan) — the shape CreateAction.validate
    admits (reference `CreateAction.scala:42-62`) — return (files, scan
    schema); else None. Lets the build read payload straight from parquet
    on the host instead of round-tripping every column through the
    device."""
    from hyperspace_tpu_torch.plan.nodes import Project, Scan

    node = plan
    while isinstance(node, Project):
        node = node.child
    if isinstance(node, Scan) and node.bucket_spec is None:
        files = node.files()
        if files:
            return files, node.schema
    return None


SHARD_LAYOUT_FILE = "_shard_layout.json"


def write_shard_layout(path: str, num_buckets: int, n_shards: int,
                       dictionaries=None, n_slices: int = 1) -> dict:
    """Persist the born-sharded layout record next to the bucket spec:
    which contiguous bucket range each shard owns (THE map,
    `parallel/mesh.bucket_ranges`) and — for string columns — each
    range's sorted local dictionary (`dictionaries`: {column: [values per
    shard | None]}; None marks a range past the
    `distribution.dictionary.max.entries` cap). Version 3 records the
    (slice, device) hierarchy: `numSlices` and the slice-level
    `sliceBucketRanges`; a flat build records the 1-slice hierarchy.
    The record's bytes are the JAX package's."""
    import json

    from hyperspace_tpu_torch.parallel.mesh import (bucket_ranges,
                                                    slice_bucket_ranges)
    from hyperspace_tpu_torch.utils import file_utils, storage

    n_slices = max(1, int(n_slices))
    layout = {
        "version": 3,
        "numBuckets": num_buckets,
        "numShards": n_shards,
        "numSlices": n_slices,
        "bucketRanges": [[lo, hi]
                         for lo, hi in bucket_ranges(num_buckets,
                                                     n_shards)],
        "sliceBucketRanges": [
            [lo, hi] for lo, hi in slice_bucket_ranges(
                num_buckets, n_slices, n_shards // n_slices)],
    }
    if dictionaries:
        layout["dictionaries"] = dictionaries
    file_utils.create_file(storage.join(path, SHARD_LAYOUT_FILE),
                           json.dumps(layout, indent=2))
    return layout


def summarize_shard_layout(layout):
    """The log-entry form of a shard-layout record: per-range dictionary
    VALUES stay in `_shard_layout.json`; the entry carries per-range
    entry COUNTS (-1 = an over-cap range recorded as null)."""
    if not layout or "dictionaries" not in layout:
        return layout
    out = dict(layout)
    out["dictionaryEntries"] = {
        col: [len(r) if r is not None else -1 for r in ranges]
        for col, ranges in layout["dictionaries"].items()}
    del out["dictionaries"]
    return out


def _range_dictionaries(table, schema, lengths, num_buckets: int,
                        n_shards: int, max_entries: int):
    """{string column: [sorted per-range value list | None]} over the
    bucket-ordered Arrow table; a range whose distinct count exceeds
    `max_entries` records None."""
    from hyperspace_tpu_torch.parallel.mesh import shard_row_segments

    str_fields = [f.name for f in schema.fields if f.dtype == "string"]
    if not str_fields or max_entries <= 0:
        return None
    segs = shard_row_segments(np.asarray(lengths, dtype=np.int64),
                              n_shards)
    out = {}
    for name in str_fields:
        col = table.column(name)
        ranges = []
        for lo, hi in segs:
            chunk = col.slice(lo, hi - lo).drop_null()
            values = np.unique(np.asarray(
                chunk.to_numpy(zero_copy_only=False), dtype=str))
            ranges.append([str(v) for v in values]
                          if len(values) <= max_entries else None)
        out[name] = ranges
    return out


def read_shard_layout(path: str) -> Optional[dict]:
    """The layout record of a born-sharded version dir, or None for a
    single-device build."""
    import json

    from hyperspace_tpu_torch.utils import file_utils, storage

    p = storage.join(path, SHARD_LAYOUT_FILE)
    if not file_utils.exists(p):
        return None
    try:
        return json.loads(file_utils.read_contents(p))
    except (ValueError, OSError):
        return None


def write_bucket_ordered(batch: columnar.ColumnBatch, lengths,
                         num_buckets: int, path: str,
                         file_suffix: Optional[str] = None,
                         mesh=None,
                         dict_max_entries: Optional[int] = None
                         ) -> List[str]:
    """Write a batch already in bucket order (the distributed build's
    output) as bucketed parquet files, one per non-empty bucket.

    With `mesh` the index is BORN SHARDED: each flat shard's contiguous
    bucket range writes as that shard's files, named with the owning
    shard (`part-00003-s01.parquet`), and `_shard_layout.json` records
    the range map plus each range's sorted local string dictionaries.
    Each file's bytes equal the same bucket's file of a single-device
    build."""
    from hyperspace_tpu_torch.utils import file_utils

    table = columnar.to_arrow(batch)
    written: List[str] = []
    file_utils.create_directory(path)

    def write_range(bucket_lo: int, bucket_hi: int, offset: int,
                    suffix: Optional[str]) -> int:
        for b in range(bucket_lo, bucket_hi):
            count = int(lengths[b])
            if count > 0:
                out = os.path.join(path,
                                   parquet.bucket_file_name(b, suffix))
                parquet.write_table(table.slice(offset, count), out)
                written.append(out)
            offset += count
        return offset

    with _phase("write"):
        if mesh is None:
            write_range(0, num_buckets, 0, file_suffix)
            return written

        from hyperspace_tpu_torch.constants import (
            DISTRIBUTION_DICT_MAX_ENTRIES_DEFAULT)
        from hyperspace_tpu_torch.parallel.mesh import (bucket_ranges,
                                                        dcn_size,
                                                        total_shards)

        n_shards = total_shards(mesh)
        offset = 0
        for s, (lo, hi) in enumerate(bucket_ranges(num_buckets, n_shards)):
            offset = write_range(lo, hi, offset,
                                 f"{file_suffix or ''}s{s:02d}")
        cap = (dict_max_entries if dict_max_entries is not None
               else DISTRIBUTION_DICT_MAX_ENTRIES_DEFAULT)
        dictionaries = _range_dictionaries(table, batch.schema, lengths,
                                           num_buckets, n_shards, cap)
        write_shard_layout(path, num_buckets, n_shards,
                           dictionaries=dictionaries,
                           n_slices=dcn_size(mesh))
    return written


def lineage_schema(schema):
    """`schema` extended with the non-nullable int64 lineage column.
    Paired with `append_lineage_column` (below) so the LOGGED index schema
    and the WRITTEN data can never disagree on the column's shape."""
    from hyperspace_tpu_torch.constants import LINEAGE_COLUMN
    from hyperspace_tpu_torch.plan.schema import Field, Schema

    return Schema(list(schema.fields)
                  + [Field(LINEAGE_COLUMN, "int64", False)])


def append_lineage_column(table, files: Sequence[str], lineage_ids: dict):
    """Append the per-row `_hs_file_id` column to an Arrow table read by
    concatenating `files` in order: rows from file F carry lineage_ids[F]."""
    import pyarrow as pa

    from hyperspace_tpu_torch.constants import LINEAGE_COLUMN

    counts = parquet.file_row_counts(files)
    col = np.repeat(np.asarray([lineage_ids[f] for f in files],
                               dtype=np.int64), counts)
    return table.append_column(LINEAGE_COLUMN,
                               pa.array(col, type=pa.int64()))


def write_index(df, indexed_columns: Sequence[str],
                included_columns: Sequence[str], num_buckets: int,
                path: str, conf=None, lineage_ids=None) -> List[str]:
    """THE index build job (reference `CreateActionBase.scala:99-120`), on
    the device the session's conf names (`_torch_config.device_of`).

    When the distribution policy answers with a mesh
    (`parallel/context.should_distribute`) the build runs the
    mesh-sharded exchange (`parallel/build.distributed_build`) — the
    reference's cluster-wide `repartition(numBuckets, indexedCols)`
    shuffle (`CreateActionBase.scala:110-111`) — and the index is born
    sharded.

    `lineage_ids` ({source file path: id}, lineage-enabled builds) appends
    the per-row `_hs_file_id` column: rows read from file F carry
    lineage_ids[F]. Payload-only — bucket hash and sort keys are untouched.
    """
    from hyperspace_tpu_torch._torch_config import device_of
    from hyperspace_tpu_torch.engine.executor import execute_plan
    from hyperspace_tpu_torch.parallel.context import should_distribute

    device = device_of(conf)

    def build_distributed(mesh, batch):
        from hyperspace_tpu_torch.parallel.build import distributed_build

        built, lengths = distributed_build(
            batch, indexed_columns, num_buckets, mesh,
            capacity_factor=(conf.distribution_capacity_factor
                             if conf is not None else 2.0))
        return write_bucket_ordered(
            built, lengths, num_buckets, path, mesh=mesh,
            dict_max_entries=(conf.distribution_dict_max_entries
                              if conf is not None else None))

    columns = list(indexed_columns) + list(included_columns)
    source = _plain_scan_source(df.plan)
    if source is None and lineage_ids is not None:
        # CreateAction.validate admits only plain file scans, so this is a
        # programming error, not a user-reachable state.
        raise HyperspaceException(
            "Lineage requires a plain file-scan source.")
    if source is not None:
        files, scan_schema = source
        names = [scan_schema.field(c).name for c in columns]
        key_names = [scan_schema.field(c).name for c in indexed_columns]
        schema = scan_schema.select(columns)
        if lineage_ids is not None:
            schema = lineage_schema(schema)
        rows = sum(parquet.file_row_counts(files))  # footers only
        mesh = should_distribute(conf, rows)
        if mesh is not None:
            with _phase("decode"):
                table = parquet.read_table(files, columns=names)
                if lineage_ids is not None:
                    table = append_lineage_column(table, files, lineage_ids)
            # A host batch: each shard is placed straight from host
            # memory (the transfer engine's sharded put).
            written = build_distributed(
                mesh, columnar.from_arrow(table, schema))
        else:
            written = write_bucketed_from_files(
                files, names, key_names, num_buckets, path, device,
                lineage_ids=lineage_ids)
    else:
        batch = execute_plan(df.plan, projection=columns, conf=conf)
        schema = batch.schema
        mesh = should_distribute(conf, batch.num_rows)
        if mesh is not None:
            written = build_distributed(mesh, batch)
        else:
            written = write_bucketed_batch(batch, indexed_columns,
                                           num_buckets, path)
    spec = BucketSpec(num_buckets, tuple(indexed_columns),
                      tuple(indexed_columns))
    parquet.write_bucket_spec(path, spec, schema)
    return written


_MERGE_KEY_DTYPES = ("int64", "int32", "int16", "int8", "date32",
                     "timestamp", "bool")


def _merge_path_permutation(table, ordered, counts, names, schema,
                            num_buckets):
    """The compaction fast path: single null-free integer key -> a TRUE
    merge of each bucket's sorted runs (no re-sort of the base run,
    `ops/merge.host_merge_runs_permutation`). None when the shape doesn't
    qualify (multi-key, strings, floats — float lane order differs from
    raw order — or a nullable key); callers fall back to the bucket
    sort."""
    if len(names) != 1 or schema.field(names[0]).dtype not in \
            _MERGE_KEY_DTYPES:
        return None
    col = table.column(names[0])
    if col.null_count:
        return None
    from hyperspace_tpu_torch.ops.merge import host_merge_runs_permutation
    key = col.to_numpy(zero_copy_only=False)
    # run_bounds indexed by BUCKET ID (empty list for absent buckets) so
    # the writer's starts/ends line up with bucket file numbering.
    run_bounds = [[] for _ in range(num_buckets)]
    offset = 0
    for (b, _), c in zip(ordered, counts):
        run_bounds[b].append((offset, offset + c))
        offset += c
    return host_merge_runs_permutation(key, run_bounds)


def compact_index(prev_entry, out_path: str,
                  device: Optional[torch.device]):
    """Merge-compact the current data version's runs (base + incremental
    delta runs living side by side in one `v__=N` dir) into one
    fully-sorted file per bucket at `out_path` (OptimizeAction's op).
    Returns (files written, lane): "merge", "host-lexsort",
    "native-host" or "device" (`build_lane`).

    The permutation comes from the host merge fast path when the key
    qualifies, else from one stable (bucket, *keys) sort over every
    bucket at once — on the lane `build_lane` names: a CUDA `device` at
    or above BUILD_MIN_DEVICE_ROWS rows, the native radix sort on a CPU
    session, numpy below; the host streams the permuted payload out per
    bucket.
    """
    import re

    from hyperspace_tpu_torch.ops.merge import (bucket_sort_permutation,
                                                host_bucket_sort_permutation)
    from hyperspace_tpu_torch.plan.schema import Schema

    indexed = prev_entry.indexed_columns
    num_buckets = prev_entry.num_buckets
    per_bucket = dict(parquet.bucket_files(prev_entry.content.root))
    if not per_bucket:
        raise HyperspaceException("No index data files found to compact.")

    # ONE ordered read of every run, bucket-major, VERSION order within a
    # bucket: base runs (no delta suffix, chunk suffixes keep name order)
    # then delta runs by delta number — so equal keys keep their append
    # order and the stable sort reproduces the tie order a full rebuild
    # over (base files + appended files) produces.
    def run_order(path: str):
        name = os.path.basename(path)
        m = re.search(r"-delta(\d+)", name)
        return (int(m.group(1)) if m else 0, name)

    ordered = [(b, f) for b in sorted(per_bucket)
               for f in sorted(per_bucket[b], key=run_order)]
    with _phase("decode"):
        counts = parquet.file_row_counts([f for _, f in ordered])
        table = parquet.read_table([f for _, f in ordered])
    lengths = np.zeros(num_buckets, dtype=np.int64)
    for (b, _), c in zip(ordered, counts):
        lengths[b] += c
    schema = Schema.from_arrow(table.schema)
    names = [schema.field(c).name for c in indexed]

    merge_perm = _merge_path_permutation(table, ordered, counts, names,
                                         schema, num_buckets)
    if merge_perm is not None:
        lane = "merge"
        chunks, starts, ends = merge_perm
    elif device is None or _host_lane_preferred(table.num_rows, device):
        lane = build_lane(table.num_rows, device)
        with _phase("bucket_sort"):
            key_batch = columnar.from_arrow(table.select(names))
            chunks, starts, ends = host_bucket_sort_permutation(
                key_batch, names, lengths)
    else:
        lane = "device"
        with _phase("h2d", device):
            key_batch = columnar.from_arrow(table.select(names),
                                            device=device)
        with _phase("bucket_sort", device):
            chunks, starts, ends = bucket_sort_permutation(key_batch, names,
                                                           lengths)
    (perm,) = chunks
    written = _write_sorted_runs(table, perm, starts, ends, out_path,
                                 file_suffix=None)
    spec = BucketSpec(num_buckets, tuple(indexed), tuple(indexed))
    parquet.write_bucket_spec(out_path, spec, schema)
    return written, lane
