"""Incremental refresh — index only the source delta.

The surveyed reference has full rebuild only (`RefreshAction`);
incremental refresh is its roadmap. Semantics:

- validate: state ACTIVE, and the source delta must be servable:
  * appends are always servable;
  * DELETIONS are servable when the previous version carries per-row
    lineage (`_hs_file_id` + per-file stamps, lineage-enabled builds) —
    the carried-forward runs are filtered per bucket, which preserves
    their sort order (no source re-read, no re-shuffle, no re-sort);
  * in-place rewrites are never servable — full refresh (surfaced in the
    error with the exact reason).
- op: the new `v__=N+1` dir carries every bucket run of the previous
  version forward (hard-links when no rows are dropped — zero-copy on
  posix; a lineage-filtered rewrite otherwise), then the build pipeline
  indexes ONLY the appended files on the session's device (the hash
  kernel at or above `io/builder.BUILD_MIN_DEVICE_ROWS` rows), writing
  per-bucket delta runs with a `-delta<N>` suffix into the same dir.
  Versions stay immutable + self-contained; readers handle multi-run
  buckets natively (the bucketed join matches globally, bucketed scans
  read every run of a bucket).
- `OptimizeAction` merge-compacts the runs back to one file per bucket.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Set, Tuple

from hyperspace_tpu_torch.actions.refresh import RefreshAction
from hyperspace_tpu_torch.exceptions import HyperspaceException


def _version_of(root: str) -> Optional[int]:
    """Committed `v__=N` parsed from a data root, or None."""
    import re

    from hyperspace_tpu_torch import constants
    m = re.search(re.escape(constants.INDEX_VERSION_DIRECTORY_PREFIX)
                  + r"=(\d+)$", os.path.basename(root.rstrip("/\\")))
    return int(m.group(1)) if m else None


def _link_or_copy(src: str, dst: str) -> None:
    from hyperspace_tpu_torch.utils import file_utils, storage
    if storage.is_url(src) or storage.is_url(dst):
        file_utils.save_byte_array(dst, file_utils.load_byte_array(src))
        return
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


class RefreshIncrementalAction(RefreshAction):
    """REFRESHING -> ACTIVE, writing only a source-delta update."""

    def _source_scans(self):
        from hyperspace_tpu_torch.plan.nodes import Scan
        return [leaf for leaf in self.df.plan.collect_leaves()
                if isinstance(leaf, Scan)]

    def _current_files(self) -> List[str]:
        return [f for scan in self._source_scans() for f in scan.files()]

    def source_delta(self) -> Tuple[List[str], List[int]]:
        """(appended files, deleted lineage ids) of the current listing vs
        the build-time capture. Per-file stamps (lineage-enabled previous
        version) classify every file individually — deletions become ids
        to exclude; without stamps only appends are servable (shared
        derivation: `index/source_delta.py`). Memoized for the action's
        lifetime: validate() and op() see ONE consistent snapshot and the
        per-file stat pass runs once, not once per phase."""
        cached = getattr(self, "_delta", None)
        if cached is not None:
            return cached
        from hyperspace_tpu_torch.index.source_delta import (
            classify_current, split_current)
        current = self._current_files()
        delta = classify_current(self.previous_entry, current)
        if delta is not None:
            appended, deleted_ids, modified = delta
            if modified:
                raise HyperspaceException(
                    "Incremental refresh cannot serve in-place rewrites; "
                    f"{len(modified)} indexed file(s) were modified — run "
                    "a full refresh. Modified: "
                    + ", ".join(sorted(modified)[:3]))
            self._delta = (appended, deleted_ids)
            return self._delta
        appended, missing, _stored = split_current(self.previous_entry,
                                                   current)
        if missing:
            raise HyperspaceException(
                "Incremental refresh without lineage supports appended "
                f"data only; {len(missing)} indexed file(s) were deleted "
                "or rewritten — run a full refresh (or recreate the index "
                "with spark.hyperspace.index.lineage.enabled=true to make "
                "deletions servable). Missing: "
                + ", ".join(sorted(missing)[:3]))
        self._delta = (appended, [])
        return self._delta

    def lineage_enabled(self) -> bool:
        """Lineage continues iff the previous version carries it — the
        conf cannot retrofit ids onto carried-forward runs, and dropping
        them would corrupt the per-file identity story mid-index."""
        prev = self.previous_entry
        return prev.has_lineage and prev.source_file_infos() is not None

    def _lineage_ids(self, files: List[str]) -> Optional[dict]:
        """Surviving files keep their build-time ids (their rows are
        carried forward verbatim); appended files get fresh ids past the
        previous maximum."""
        if not self.lineage_enabled():
            return None
        infos = self.previous_entry.source_file_infos()
        next_id = max((fi.id for fi in infos.values()), default=-1) + 1
        out = {}
        for f in files:
            if f in infos:
                out[f] = infos[f].id
            else:
                out[f] = next_id
                next_id += 1
        return out

    def validate(self) -> None:
        super().validate()
        if self._is_skipping():
            raise HyperspaceException(
                "The bucketed incremental-refresh path applies to "
                "covering indexes only; data-skipping indexes take the "
                "sketch-append delta path (mode='incremental' via the "
                "collection manager dispatches there by kind).")
        self.source_delta()  # raises on un-servable deltas
        if self.lineage_enabled():
            return  # classify_current verified every survivor per file
        # Pre-lineage path: a file rewritten in place keeps its path —
        # verify the previously indexed files are byte-identical by
        # recomputing the aggregate signature over exactly the stored set.
        from hyperspace_tpu_torch.index.signature import (
            SignatureProviderFactory)
        from hyperspace_tpu_torch.index.source_delta import restricted_scan
        stored_sig = self.previous_entry.signature()
        restricted = restricted_scan(
            self.previous_entry, self._source_scans()[-1],
            self.previous_entry.source_file_list())
        provider = SignatureProviderFactory.create(stored_sig.provider)
        if provider.signature(restricted) != stored_sig.value:
            raise HyperspaceException(
                "Incremental refresh supports appended data only; previously "
                "indexed files were modified in place — run a full refresh.")

    def _carry_previous_runs(self, out_dir: str,
                             deleted_ids: List[int]) -> Set[int]:
        """Bring the previous version's bucket runs into `out_dir`.
        Without deletions every run hard-links (zero-copy). With
        deletions, runs containing a deleted file's rows are rewritten
        with those rows filtered out — a pure mask on the lineage column,
        so the run's sort order (and therefore the whole bucketed layout)
        is preserved without touching a sort kernel. Returns the bucket
        ids whose CONTENT changed (rewritten or emptied runs)."""
        import numpy as np
        import pyarrow as pa

        from hyperspace_tpu_torch.constants import LINEAGE_COLUMN
        from hyperspace_tpu_torch.io import parquet

        prev_root = self.previous_entry.content.root
        deleted_arr = np.asarray(sorted(deleted_ids), dtype=np.int64)
        touched: Set[int] = set()
        for bucket, files in sorted(parquet.bucket_files(prev_root).items()):
            for f in files:
                dst = os.path.join(out_dir, os.path.basename(f))
                if not len(deleted_arr):
                    _link_or_copy(f, dst)
                    continue
                table = parquet.read_table([f])
                ids = table.column(LINEAGE_COLUMN).combine_chunks() \
                    .to_numpy(zero_copy_only=False)
                keep = ~np.isin(ids, deleted_arr)
                if keep.all():
                    _link_or_copy(f, dst)
                elif keep.any():
                    parquet.write_table(table.filter(pa.array(keep)), dst)
                    touched.add(int(bucket))
                else:
                    # Every row dropped -> no file (empty-bucket parity
                    # with the full build, which writes no file either).
                    touched.add(int(bucket))
        return touched

    def op(self) -> None:
        from hyperspace_tpu_torch._torch_config import device_of
        from hyperspace_tpu_torch.io import parquet
        from hyperspace_tpu_torch.io.builder import write_bucketed_from_files
        from hyperspace_tpu_torch.utils import file_utils

        out_dir = self.index_data_path
        prev_root = self.previous_entry.content.root
        appended, deleted_ids = self.source_delta()
        self.annotate_report(appended_files=len(appended),
                             deleted_lineage_ids=len(deleted_ids))
        file_utils.create_directory(out_dir)
        touched = self._carry_previous_runs(out_dir, deleted_ids)
        spec_path = os.path.join(prev_root, parquet.BUCKET_SPEC_FILE)
        if file_utils.exists(spec_path):
            _link_or_copy(spec_path,
                          os.path.join(out_dir, parquet.BUCKET_SPEC_FILE))
        # Bucket-scoped invalidation channel: the commit names exactly
        # the buckets whose bytes changed against the carried-from
        # version; everything else is hard-linked byte-identically, so
        # the segment cache rekeys those warm entries instead of
        # dropping them. `touched` is the same set object the delta
        # write below extends.
        prev_version = _version_of(prev_root)
        if prev_version is not None:
            self._touched_buckets = touched
            self._carried_from_version = prev_version
        if not appended:
            self.annotate_report(touched_buckets=sorted(touched))
            self.commit_data_version()
            self.stamp_stats()
            return  # metadata-only refresh (signature/file set catches up)
        cfg = self.index_config
        source_scan = self._source_scans()[-1]
        columns = cfg.indexed_columns + cfg.included_columns
        names = [source_scan.schema.field(c).name for c in columns]
        key_names = [source_scan.schema.field(c).name
                     for c in cfg.indexed_columns]
        # One shared {file: id} map per action (memoized over the FULL
        # current listing) — the same map the log entry's FileInfos are
        # built from, so appended rows can never be written under an id
        # that disagrees with the logged metadata.
        lineage_ids = self.lineage_id_map(self.df)
        delta_version = os.path.basename(out_dir).split("=")[-1]
        # The session's device: without it a delta of any size would
        # build on the host lane.
        written = write_bucketed_from_files(
            appended, names, key_names, self.num_buckets(), out_dir,
            device_of(self.conf), lineage_ids=lineage_ids,
            file_suffix=f"delta{delta_version}")
        for f in written:
            bucket = parquet.bucket_of_file(f)
            if bucket is None:
                # Unparseable delta name: the bucket set is no longer
                # provable — fall back to the full sweep.
                self._touched_buckets = self._carried_from_version = None
                break
            touched.add(bucket)
        self.annotate_report(delta_files_written=len(written),
                             delta_rows=sum(parquet.file_row_counts(
                                 appended)),
                             touched_buckets=sorted(touched))
        self.commit_data_version()
        self.stamp_stats()
