"""Source-file delta between an index's build-time capture and the
current lake listing.

Hybrid scan (`plan/rules/filter_index.py`, `plan/rules/join_index.py`)
and incremental refresh (`actions/refresh_incremental.py`) both answer the
same two questions — "which files were appended since the build?" and
"are the files captured at build time still byte-identical?" — so the
derivation lives here once.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Set, Tuple

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Scan


def split_current(entry: IndexLogEntry, current_files: Iterable[str]
                  ) -> Tuple[List[str], Set[str], Set[str]]:
    """(appended, missing, stored): current files not captured at build
    time (deduplicated — overlapping scan roots may list a file twice),
    captured files no longer listed (deleted/renamed — either disqualifies
    append-only serving), and the build-time capture itself."""
    stored = set(entry.source_file_list())
    current = set(current_files)
    appended = sorted(current - stored)
    missing = stored - current
    return appended, missing, stored


def classify_current(entry: IndexLogEntry, current_files: Iterable[str]):
    """Per-file delta classification for lineage-enabled indexes:
    (appended, deleted_ids, modified) where `appended` are current files
    not captured at build time, `deleted_ids` the lineage ids of captured
    files no longer listed, and `modified` captured files whose (size,
    stamp) identity changed in place. None when the entry carries no
    per-file stamps (pre-lineage builds fall back to the aggregate
    signature over `restricted_scan`).

    Unlike the aggregate path this works when captured files are GONE —
    survivors are verified individually, so hybrid scan can exclude the
    deleted files' rows instead of losing the index."""
    from hyperspace_tpu_torch.index.signature import file_stamp

    infos = entry.source_file_infos()
    if infos is None or not entry.has_lineage:
        return None
    current = set(current_files)
    appended = sorted(current - infos.keys())
    deleted_ids = sorted(fi.id for p, fi in infos.items()
                         if p not in current)
    modified = sorted(p for p, fi in infos.items() if p in current
                      and file_stamp(p) != (fi.size, fi.stamp))
    return appended, deleted_ids, modified


def restricted_scan(entry: IndexLogEntry, scan: Scan,
                    stored: Sequence[str]) -> Scan:
    """The scan narrowed to EXACTLY the build-time file set. Recomputing
    the signature over it and comparing with the stored one proves the
    captured files are untouched — a path-set check alone misses files
    rewritten in place with the same name."""
    return Scan(scan.root_paths, scan.schema, files=sorted(stored))
