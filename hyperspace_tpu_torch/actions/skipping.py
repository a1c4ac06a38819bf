"""Create action for DATA-SKIPPING indexes — the second index kind
through the SAME log/action FSM as the covering index.

`CreateSkippingIndexAction` rides the transactional template
(`actions/base.py`): validate -> begin (CREATING) -> op -> end
(ACTIVE), the `v__=N` version dir finalized by the `_committed` marker
written LAST, lease-based crash recovery, OCC on log ids, action
reports — nothing kind-specific in the lifecycle. What differs is the
DATA the op writes:

- the per-source-file sketch blob (`index/sketch.py`: zone maps +
  blocked bloom filters, reductions on the adaptive host/device lane
  with device batches staged through the `TransferEngine`; the device
  lane is torch operations on the session's device), and
- optionally (config.zorder_by) a Z-ORDER clustered rewrite of the
  source rows under the same version dir (`zpart-NNNNN.parquet` —
  deliberately NOT the bucket naming pattern, the copy is clustered,
  not bucketed), whose per-file zones are tight by construction; the
  blob then sketches the COPY's files and the filter rule serves
  pruned reads from the copy.

`RefreshAction` (full rebuild) dispatches through the same build
functions when the previous entry's kind is DataSkippingIndex —
per-file sketches make a full re-sketch cheap. Under continuous ingest
the streaming path is `RefreshSkippingAppendAction` below (the
collection manager routes mode='incremental' there by kind): re-sketch
only appended/rewritten files, carry the previous blob's rows forward
(`index/sketch.append_file_sketches`), drop vanished files. Optimize
still declines skipping entries with a typed error (nothing compacted
to merge), as does the bucketed covering-delta path on direct
construction.

Commit also sweeps the SOURCE roots' host caches + footprint size
cache (`segcache.invalidate_source_paths`) — not just the index root
the generic commit hook covers — so the next plan-time prune and the
scans' size accounting see fresh source stamps instead of a stale-stamp
window.
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.index_config import DataSkippingIndexConfig
from hyperspace_tpu_torch.index.log_entry import (Content, DataSkippingIndex,
                                            Directory, Hdfs, IndexLogEntry,
                                            LogicalPlanFingerprint,
                                            NoOpFingerprint, PlanSource,
                                            Signature, Source)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.actions.create import CreateActionBase
from hyperspace_tpu_torch.actions.refresh import RefreshAction
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.plan.serde import plan_to_json

ZORDER_FILE_PREFIX = "zpart-"


def _resolve(schema, columns: List[str]) -> List[str]:
    missing = [c for c in columns if not schema.contains(c)]
    if missing:
        raise HyperspaceException(
            "Index config is not applicable to dataframe schema; "
            f"missing columns: {', '.join(missing)}")
    return [schema.field(c).name for c in columns]


def skipping_log_entry(df, config: DataSkippingIndexConfig, path: str,
                       signature_provider) -> IndexLogEntry:
    """The metadata record, mirroring the covering
    `get_index_log_entry`: logged source plan + file-based fingerprint
    + source file list, with a DataSkippingIndex derived dataset. The
    schema records the full source schema for Z-order builds (the copy
    carries every column) and just the sketched columns otherwise."""
    signature_value = signature_provider.signature(df.plan)
    if signature_value is None:
        raise HyperspaceException(
            "Cannot fingerprint source plan: unsupported relations "
            "present.")
    skipped = _resolve(df.schema, config.skipping_columns)
    zorder = _resolve(df.schema, config.zorder_by) if config.zorder_by \
        else []
    schema = df.schema if zorder else df.schema.select(skipped)
    source_file_list: List[str] = []
    for leaf in df.plan.collect_leaves():
        if isinstance(leaf, Scan):
            source_file_list.extend(leaf.files())
    return IndexLogEntry(
        name=config.index_name,
        derived_dataset=DataSkippingIndex(
            skipped_columns=skipped,
            sketch_types=list(config.sketch_types),
            schema_json=schema.to_json(),
            zorder_by=zorder),
        content=Content(root=path, directories=[]),
        source=Source(
            plan=PlanSource(
                raw_plan=plan_to_json(df.plan),
                fingerprint=LogicalPlanFingerprint(
                    [Signature(signature_provider.name(),
                               signature_value)])),
            data=[Hdfs(Content(root="", directories=[
                Directory(path="", files=source_file_list,
                          fingerprint=NoOpFingerprint())]))]),
        extra={})


def _write_zorder_copy(files: List[str], schema,
                       zorder_cols: List[str], path: str,
                       conf) -> List[str]:
    """Cluster the source rows by the Z-order interleave of
    `zorder_cols` and write them as `zpart-NNNNN.parquet` files under
    `path`. Returns the written paths (in z order)."""
    import os

    from hyperspace_tpu_torch import constants
    from hyperspace_tpu_torch.io import columnar, parquet
    from hyperspace_tpu_torch.ops.sketch import zorder_permutation
    from hyperspace_tpu_torch.utils import file_utils

    table = parquet.read_table(files)
    key_batch = columnar.from_arrow(
        table.select([schema.field(c).name for c in zorder_cols]),
        schema.select(zorder_cols), device=None)
    perm = zorder_permutation(key_batch, zorder_cols)
    import pyarrow as pa
    clustered = table.take(pa.array(perm))
    n_files = max(1, conf.skipping_zorder_files if conf is not None
                  else constants.SKIPPING_ZORDER_FILES_DEFAULT)
    n_files = min(n_files, max(1, table.num_rows))
    file_utils.create_directory(path)
    written: List[str] = []
    rows = table.num_rows
    for i in range(n_files):
        lo = (rows * i) // n_files
        hi = (rows * (i + 1)) // n_files
        if hi <= lo:
            continue
        out = os.path.join(path, f"{ZORDER_FILE_PREFIX}{i:05d}.parquet")
        parquet.write_table(clustered.slice(lo, hi - lo), out)
        written.append(out)
    return written


def build_skipping_data(df, config: DataSkippingIndexConfig, path: str,
                        conf) -> dict:
    """THE skipping build job: (optional) Z-order rewrite, then one
    sketch row per data file, persisted as the version dir's
    `_hs_sketches` blob. Returns action-report detail."""
    from hyperspace_tpu_torch.index import sketch as sketch_io
    from hyperspace_tpu_torch.utils import file_utils

    skipped = _resolve(df.schema, config.skipping_columns)
    source_files: List[str] = []
    for leaf in df.plan.collect_leaves():
        if isinstance(leaf, Scan):
            source_files.extend(leaf.files())
    detail = {"source_files": len(source_files),
              "sketched_columns": len(skipped)}
    if config.zorder_by:
        zorder = _resolve(df.schema, config.zorder_by)
        data_files = _write_zorder_copy(source_files, df.schema, zorder,
                                        path, conf)
        detail["zorder_files_written"] = len(data_files)
        schema = df.schema
    else:
        data_files = source_files
        file_utils.create_directory(path)
        schema = df.schema
    sketches = sketch_io.build_file_sketches(data_files, skipped, schema,
                                             conf)
    blob_bytes = sketch_io.write_sketches(path, sketches, skipped,
                                          schema, config.sketch_types)
    detail["files_sketched"] = len(sketches)
    detail["sketch_blob_bytes"] = blob_bytes
    return detail


def sweep_source_caches(df) -> int:
    """Invalidate the footprint size cache and the stamped host parquet
    caches under every SOURCE root of `df`'s plan (the commit-time
    other-half of the generic index-root sweep): the next plan-time
    prune and size accounting must see fresh stamps, not a pre-commit
    window. Returns how many roots were swept."""
    from hyperspace_tpu_torch.io import segcache

    roots: List[str] = []
    for leaf in df.plan.collect_leaves():
        if isinstance(leaf, Scan):
            roots.extend(leaf.root_paths)
    for root in roots:
        segcache.invalidate_source_paths(root)
    return len(roots)


class CreateSkippingIndexAction(CreateActionBase):
    """transient CREATING -> final ACTIVE, like CreateAction — only the
    data written differs (sketch blob +/- Z-order copy)."""

    transient_state = States.CREATING
    final_state = States.ACTIVE

    def __init__(self, df, index_config: DataSkippingIndexConfig,
                 log_manager: IndexLogManager,
                 data_manager: IndexDataManager, conf: HyperspaceConf):
        super().__init__(log_manager, data_manager, conf)
        self.df = df
        self.index_config = index_config
        self._entry: Optional[IndexLogEntry] = None

    def log_entry(self) -> IndexLogEntry:
        if self._entry is None:
            self._entry = skipping_log_entry(
                self.df, self.index_config, self.index_data_path,
                self._signature_provider())
        return IndexLogEntry.from_dict(self._entry.to_dict())

    def validate(self) -> None:
        self._recover_stale_writer()
        if not isinstance(self.df.plan, Scan):
            raise HyperspaceException(
                "Only creating a data-skipping index over a plain file "
                "scan is supported.")
        _resolve(self.df.schema, self.index_config.skipping_columns)
        if self.index_config.zorder_by:
            _resolve(self.df.schema, self.index_config.zorder_by)
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != States.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.index_config.index_name} "
                f"already exists (state {latest.state}).")

    def op(self) -> None:
        detail = build_skipping_data(self.df, self.index_config,
                                     self.index_data_path, self.conf)
        self.annotate_report(**detail)
        self.commit_data_version()
        self.annotate_report(source_roots_swept=sweep_source_caches(self.df))
        self.stamp_stats()


class RefreshSkippingAppendAction(RefreshAction):
    """Streaming refresh for data-skipping indexes: REFRESHING ->
    ACTIVE through the same FSM as every other maintenance action, but
    the op writes a DELTA blob build — re-sketch only the source files
    that appeared or were rewritten since the previous version, carry
    every still-identical file's row forward from the previous blob,
    drop rows for vanished files (per-file sketches make deletions
    trivially servable). The merged blob lands in the next `v__=N+1`
    version dir; in-flight pinned readers keep the old one.

    Z-ordered configs decline with a typed error: the clustered copy's
    zones are tight only over the FULL row set, so appends require a
    re-cluster — `mode='full'` — not a carry.
    """

    def validate(self) -> None:
        super().validate()
        if not self._is_skipping():
            raise HyperspaceException(
                "Sketch-append refresh only applies to data-skipping "
                "indexes; covering indexes take the bucketed delta path "
                "(the collection manager dispatches mode='incremental' "
                "by kind).")
        if self.index_config.zorder_by:
            raise HyperspaceException(
                "Sketch-append refresh does not apply to Z-ordered "
                "skipping indexes — the clustered copy must be "
                "re-clustered over the full row set; use mode='full'.")

    def op(self) -> None:
        from hyperspace_tpu_torch.index import sketch as sketch_io
        from hyperspace_tpu_torch.utils import file_utils

        cfg = self.index_config
        skipped = _resolve(self.df.schema, cfg.skipping_columns)
        source_files: List[str] = []
        for leaf in self.df.plan.collect_leaves():
            if isinstance(leaf, Scan):
                source_files.extend(leaf.files())
        out_dir = self.index_data_path
        file_utils.create_directory(out_dir)
        sketches, detail = sketch_io.append_file_sketches(
            self.previous_entry.content.root, source_files, skipped,
            self.df.schema, self.conf)
        blob_bytes = sketch_io.write_sketches(
            out_dir, sketches, skipped, self.df.schema, cfg.sketch_types)
        self.annotate_report(source_files=len(source_files),
                             sketched_columns=len(skipped),
                             sketch_blob_bytes=blob_bytes, **detail)
        self.commit_data_version()
        self.annotate_report(source_roots_swept=sweep_source_caches(self.df))
        self.stamp_stats()
