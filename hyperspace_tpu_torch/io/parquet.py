"""Parquet IO, including the bucketed index-data layout.

Layout parity with the reference's bucketed write
(`index/DataFrameWriterExtensions.scala:49-78`): one parquet file (set) per
bucket, hash-partitioned by the indexed columns and sorted within buckets.
Bucket id is encoded in the file name (`part-<bucket 5 digits>.parquet`) —
the read side maps file -> bucket from the name, like Spark's bucketed
tables — and a `_bucket_spec.json` sidecar makes index data dirs
self-describing.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, List, Optional, Sequence

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.utils import storage
from hyperspace_tpu_torch.plan.nodes import BucketSpec
from hyperspace_tpu_torch.plan.schema import Schema

BUCKET_FILE_RE = re.compile(r"part-(\d{5})(?:-[A-Za-z0-9]+)?\.parquet$")
BUCKET_SPEC_FILE = "_bucket_spec.json"

# Version of THE bucket hash identity (`ops/hash_partition` + float-lane
# normalization in `ops/keys.py`). Bumped whenever the row -> bucket map
# of existing layouts would change (v2: -0.0/NaN float normalization). A
# data dir written under a different version reports no bucket spec, so
# readers treat it as unbucketed (correct, just unaccelerated) instead of
# silently mis-bucketing point lookups and co-partitioned joins.
BUCKET_HASH_VERSION = 2


def bucket_file_name(bucket: int, suffix: Optional[str] = None) -> str:
    tag = f"-{suffix}" if suffix else ""
    return f"part-{bucket:05d}{tag}.parquet"


def bucket_of_file(path: str) -> Optional[int]:
    m = BUCKET_FILE_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def _read_one(path: str, cols):
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.utils import retry

    # partitioning=None: the index layout's `v__=N` version directories
    # LOOK like hive partitions, and newer pyarrow infers a synthetic
    # `v__` dictionary column from the path (even for single-file
    # reads) — which is not data, collides with files that were written
    # while such inference was active, and must never enter a batch.
    def read():
        if storage.is_url(path):
            fs, real = storage.get_fs(path)
            return pq.read_table(real, columns=cols, filesystem=fs,
                                 partitioning=None)
        return pq.read_table(path, columns=cols, partitioning=None)

    # Transient storage failures (connection resets, 5xx from object
    # stores) retry per the io.retry policy; a corrupt file or missing
    # path is permanent and raises through (index scans convert it into
    # graceful degradation upstream).
    return retry.call(read, operation=f"parquet.read:{path}")


# ONE shared IO executor for concurrent per-file reads and footer
# fetches (lazily created): the previous per-call
# ThreadPoolExecutor(8) spun up and tore down 8 threads on EVERY
# multi-file read — per-query thread churn on the hot scan path.
# Tasks never submit sub-tasks, so sharing cannot deadlock.
_io_pool = None
_io_pool_lock = threading.Lock()


def io_executor():
    global _io_pool
    if _io_pool is None:
        with _io_pool_lock:
            if _io_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                _io_pool = ThreadPoolExecutor(max_workers=8,
                                              thread_name_prefix="hs-io")
    return _io_pool


def shutdown_io_executor(wait: bool = True) -> None:
    """Tear the shared IO pool down (idempotent; lazily re-created by
    the next `io_executor()` call, so tests survive a mid-run
    shutdown). Registered atexit: before this, interpreter teardown
    left 8 idle `hs-io` threads to be reaped by the futures module's
    own exit hook with any queued work's ordering unobserved — now the
    pool drains deterministically."""
    global _io_pool
    with _io_pool_lock:
        pool, _io_pool = _io_pool, None
    if pool is not None:
        pool.shutdown(wait=wait)


import atexit as _atexit  # noqa: E402

_atexit.register(shutdown_io_executor)


def read_table(paths: Sequence[str], columns: Optional[Sequence[str]] = None):
    """Read one or more parquet files/dirs into a single Arrow table, in
    path order. Files are read concurrently (pyarrow releases the GIL);
    order is preserved by the map. `scheme://` paths read through their
    fsspec filesystem."""
    import pyarrow as pa

    if not paths:
        raise HyperspaceException("No parquet inputs to read.")
    cols = list(columns) if columns else None
    if len(paths) == 1:
        return _read_one(paths[0], cols)
    tables = list(io_executor().map(lambda p: _read_one(p, cols), paths))
    return pa.concat_tables(tables, promote_options="default")


def file_row_counts(paths: Sequence[str]) -> List[int]:
    """Per-file row counts from parquet footers (no data read)."""
    import pyarrow.parquet as pq

    def meta_rows(p):
        if storage.is_url(p):
            fs, real = storage.get_fs(p)
            with fs.open(real, "rb") as f:
                return pq.read_metadata(f).num_rows
        return pq.read_metadata(p).num_rows

    if len(paths) <= 1:
        return [meta_rows(p) for p in paths]
    return list(io_executor().map(meta_rows, paths))


def read_host_batch(paths: Sequence[str],
                    columns: Optional[Sequence[str]], schema):
    """Read parquet files into a HOST-lane ColumnBatch (numpy columns)."""
    from hyperspace_tpu_torch.io import columnar

    return columnar.from_arrow(read_table(paths, columns=columns), schema)


def write_table(table, path: str) -> None:
    """Write an index data file. Numeric columns skip parquet's
    dictionary-encoding attempt, and statistics are disabled for ALL
    columns: index rows are pre-sorted runs, the bucket layout (not page
    stats) prunes reads, and dropping both measured ~3x faster encodes
    with smaller files and ~25% faster reads. String columns keep
    dictionary encoding — they compress well and decode to the same Arrow
    dictionaries the device encoding consumes."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.utils import retry

    string_cols = [f.name for f in table.schema
                   if pa.types.is_string(f.type) or pa.types.is_large_string(f.type)
                   or pa.types.is_dictionary(f.type)]
    kwargs = dict(use_dictionary=string_cols or False,
                  write_statistics=False, compression="snappy")

    def write():
        if storage.is_url(path):
            fs, real = storage.get_fs(path)
            fs.makedirs(os.path.dirname(real), exist_ok=True)
            pq.write_table(table, real, filesystem=fs, **kwargs)
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pq.write_table(table, path, **kwargs)

    # A retried attempt rewrites the whole file — safe: version dirs are
    # private to their writing action until the commit marker lands.
    retry.call(write, operation=f"parquet.write:{path}")


def write_bucket_spec(directory: str, spec: BucketSpec, schema: Schema) -> None:
    from hyperspace_tpu_torch.utils import file_utils
    payload = json.dumps({"bucketSpec": spec.to_dict(),
                          "hashVersion": BUCKET_HASH_VERSION,
                          "schema": [fld.to_dict() for fld in schema.fields]},
                         indent=2)
    file_utils.create_file(storage.join(directory, BUCKET_SPEC_FILE), payload)


def read_bucket_spec(directory: str) -> Optional[BucketSpec]:
    from hyperspace_tpu_torch.utils import file_utils
    path = storage.join(directory, BUCKET_SPEC_FILE)
    if not file_utils.exists(path):
        return None
    payload = json.loads(file_utils.read_contents(path))
    if payload.get("hashVersion", 1) != BUCKET_HASH_VERSION:
        # Layout written under a different hash identity: expose it as
        # unbucketed so reads stay correct (no pruning/co-partitioning).
        return None
    return BucketSpec.from_dict(payload["bucketSpec"])


def bucket_map(files: Sequence[str]) -> Dict[int, List[str]]:
    """Group an EXPLICIT file listing by bucket id (files not carrying
    the bucket naming pattern are dropped). The snapshot-pinned scan
    path (`engine/physical.ScanExec._per_bucket_files`) derives bucket
    maps from its plan-time-frozen listing through this instead of
    re-listing the directory at execution."""
    out: Dict[int, List[str]] = {}
    for path in sorted(files, key=os.path.basename):
        bucket = bucket_of_file(path)
        if bucket is not None:
            out.setdefault(bucket, []).append(path)
    return out


def bucket_files(directory: str) -> Dict[int, List[str]]:
    """Map bucket id -> parquet files in a bucketed data dir (empty buckets
    have no files)."""
    out: Dict[int, List[str]] = {}
    from hyperspace_tpu_torch.utils import file_utils
    if not file_utils.is_dir(directory):
        return out
    for name in sorted(storage.listdir_names(directory)):
        bucket = bucket_of_file(name)
        if bucket is not None:
            out.setdefault(bucket, []).append(storage.join(directory, name))
    return out
