"""Create action + shared create/refresh machinery.

Parity: reference `actions/CreateActionBase.scala:31-121` and
`actions/CreateAction.scala:27-75`. The index build job — the reference's
`df.select(indexed++included).repartition(numBuckets, indexedCols)
.write.saveWithBuckets(...)` — becomes this framework's device build
pipeline: hash-partition + sort kernels over columnar batches, bucketed
parquet write (`io/builder.py`).
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch import constants
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import (Content, CoveringIndex, Directory,
                                            Hdfs, IndexLogEntry,
                                            LogicalPlanFingerprint,
                                            NoOpFingerprint, PlanSource,
                                            Signature, Source)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.index.signature import FileBasedSignatureProvider
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.plan.serde import plan_to_json


def index_data_stats(root: str) -> dict:
    """On-disk stats of an index data root: total bytes + row count (from
    parquet footers — no data read). Computed at build time and stored in
    the log entry so no query-time code needs a filesystem walk."""
    from hyperspace_tpu_torch.io import parquet
    from hyperspace_tpu_torch.utils.file_utils import get_directory_size

    size = int(get_directory_size(root))
    files = [f for per_bucket in parquet.bucket_files(root).values()
             for f in per_bucket]
    rows = int(sum(parquet.file_row_counts(files))) if files else 0
    return {"dataSizeBytes": size, "rowCount": rows}


class CreateActionBase(Action):
    """Shared machinery for Create/Refresh (reference `CreateActionBase.scala`)."""

    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager, conf: HyperspaceConf):
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.conf = conf
        self._data_version: Optional[int] = None

    @property
    def index_data_path(self) -> str:
        """Next free `v__=N` dir (reference `CreateActionBase.scala:31-36`).
        Allocated over ALL existing dirs — a crashed build's uncommitted
        dir is skipped, never written into — and memoized so every phase
        of this action sees the same target."""
        if self._data_version is None:
            self._data_version = self.data_manager.next_version_id()
        return self.data_manager.get_path(self._data_version)

    def commit_data_version(self) -> None:
        """Finalize the version dir this action wrote — the `_committed`
        marker is the build's LAST data write; until it lands the version
        is invisible to `get_latest_version_id` and the rules. Actions
        that carry a previous version's bucket runs forward (incremental
        refresh) set `_touched_buckets`/`_carried_from_version` first so
        the segment cache invalidates bucket-scoped instead of dropping
        the whole warm set."""
        if self._data_version is not None:
            touched = getattr(self, "_touched_buckets", None)
            carried = getattr(self, "_carried_from_version", None)
            if touched is not None and carried is not None:
                self.data_manager.commit(self._data_version,
                                         touched_buckets=touched,
                                         carried_from=carried)
            else:
                self.data_manager.commit(self._data_version)

    def _recover_stale_writer(self) -> None:
        """Lease-based crash recovery, run at the head of validate():
        when the latest log entry is TRANSIENT (a writer died between
        begin and end) and older than
        `spark.hyperspace.maintenance.lease.seconds`, run the Cancel FSM
        transition back to the last stable state so the crashed writer
        stops blocking the index forever. Within the lease the entry is
        presumed live and validation fails as before (exactly one writer
        may hold the transient slot)."""
        import time as _time

        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.actions.cancel import CancelAction
        from hyperspace_tpu_torch.constants import STABLE_STATES

        latest = self.log_manager.get_latest_log()
        if latest is None or latest.state in STABLE_STATES:
            return
        age_s = _time.time() - (latest.timestamp or 0) / 1000.0
        if age_s <= self.conf.maintenance_lease_seconds:
            return
        CancelAction(self.log_manager).run()
        telemetry.get_registry().counter("resilience.recoveries").inc()
        telemetry.event("resilience", "recovered",
                        index=getattr(latest, "name", None),
                        stale_state=latest.state, age_s=round(age_s, 3))
        # Cancel appended two log entries; drop every cached view of the
        # log so this action re-reads the recovered state.
        self._base_id = None
        self._latest_entry = None
        self._data_version = None
        for attr in ("_previous", "_entry", "_df", "_delta"):
            if hasattr(self, attr):
                setattr(self, attr, None)
        if hasattr(self, "_lineage_map"):  # sentinel-cached, so delete
            delattr(self, "_lineage_map")

    def num_buckets(self) -> int:
        return self.conf.num_buckets

    def _signature_provider(self):
        return FileBasedSignatureProvider()

    def source_files(self, df) -> List[str]:
        """All files of every Scan leaf (reference `CreateActionBase.scala:89-97`)."""
        files: List[str] = []
        for leaf in df.plan.collect_leaves():
            if isinstance(leaf, Scan):
                files.extend(leaf.files())
        return files

    def lineage_enabled(self) -> bool:
        """Per-row lineage opt-in (`spark.hyperspace.index.lineage.enabled`;
        extension — the reference's v0.2 direction)."""
        return (self.conf.get(constants.LINEAGE_ENABLED, "false")
                or "false").lower() == "true"

    def _lineage_ids(self, files: List[str]) -> Optional[dict]:
        """{source file path: stable lineage id} for this build, or None
        when lineage is off. Fresh builds number files 0..n-1; incremental
        refresh overrides this to keep surviving files' ids stable (their
        rows are carried forward verbatim)."""
        if not self.lineage_enabled():
            return None
        return {f: i for i, f in enumerate(files)}

    _LINEAGE_UNSET = object()

    def lineage_id_map(self, df) -> Optional[dict]:
        """THE build's {source file: lineage id} assignment, computed once
        per action over the full current source file list. The data write
        and the log entry's FileInfos must agree row-for-row, so both read
        this one memoized map — two independent `_lineage_ids` calls would
        only agree while every source is a single sorted Scan."""
        cached = getattr(self, "_lineage_map", self._LINEAGE_UNSET)
        if cached is not self._LINEAGE_UNSET:
            return cached
        self._lineage_map = self._lineage_ids(self.source_files(df))
        return self._lineage_map

    def get_index_log_entry(self, df, index_config: IndexConfig,
                            path: str) -> IndexLogEntry:
        """Build the full metadata record (reference `CreateActionBase.scala:38-87`):
        numBuckets from conf, schema of indexed+included columns, serialized
        source plan (the *logical* IR — like the reference logging the
        unanalyzed plan), fingerprint via the signature provider, and the
        source file list."""
        provider = self._signature_provider()
        signature_value = provider.signature(df.plan)
        if signature_value is None:
            raise HyperspaceException(
                "Cannot fingerprint source plan: unsupported relations present.")
        columns = index_config.indexed_columns + index_config.included_columns
        schema = df.schema.select(columns)
        source_file_list = self.source_files(df)
        lineage_ids = self.lineage_id_map(df)
        file_infos = None
        if lineage_ids is not None:
            from hyperspace_tpu_torch.index.log_entry import FileInfo
            from hyperspace_tpu_torch.index.signature import file_stamp
            from hyperspace_tpu_torch.io.builder import lineage_schema
            file_infos = []
            for f in source_file_list:
                stamp = file_stamp(f)
                if stamp is None:
                    raise HyperspaceException(
                        f"Cannot stat source file for lineage: {f}")
                file_infos.append(FileInfo(f, stamp[0], stamp[1],
                                           lineage_ids[f]))
            schema = lineage_schema(schema)
        entry = IndexLogEntry(
            name=index_config.index_name,
            derived_dataset=CoveringIndex(
                indexed_columns=list(index_config.indexed_columns),
                included_columns=list(index_config.included_columns),
                schema_json=schema.to_json(),
                num_buckets=self.num_buckets()),
            content=Content(root=path, directories=[]),
            source=Source(
                plan=PlanSource(
                    raw_plan=plan_to_json(df.plan),
                    fingerprint=LogicalPlanFingerprint(
                        [Signature(provider.name(), signature_value)])),
                data=[Hdfs(Content(root="", directories=[
                    Directory(path="", files=source_file_list,
                              fingerprint=NoOpFingerprint(),
                              file_infos=file_infos)]))]),
            extra={})
        return entry

    def write(self, df, index_config: IndexConfig, path: str) -> None:
        """THE index build job (reference `CreateActionBase.scala:99-120`).

        select(indexed ++ included) -> device hash-partition into numBuckets
        by indexed columns -> per-bucket sort by indexed columns -> bucketed
        parquet under `path`.
        """
        from hyperspace_tpu_torch.io.builder import write_index
        written = write_index(df, list(index_config.indexed_columns),
                              list(index_config.included_columns),
                              self.num_buckets(), path, conf=self.conf,
                              lineage_ids=self.lineage_id_map(df))
        self.annotate_report(files_written=len(written),
                             num_buckets=self.num_buckets(),
                             source_files=len(self.source_files(df)))

    def stamp_stats(self) -> None:
        """Persist the written index data's on-disk size and row count in
        the entry (`extra.stats`), measured ONCE at build/refresh time from
        the files just written. Query-time ranking
        (`FilterIndexRule._rank`) reads these instead of walking the data
        root per optimization pass — the reference keeps everything a rule
        decision needs inside the log entry the same way
        (`index/IndexLogEntry.scala:80-125`). Called at the end of every
        data-writing `op()`, before `end()` serializes the entry."""
        if self._entry is None:
            return
        stats = index_data_stats(self._entry.content.root)
        self._entry.extra["stats"] = stats
        # A born-sharded build leaves a `_shard_layout.json` record next
        # to the bucket spec (io/builder.write_bucket_ordered); lift it
        # into the log entry so readers know each shard's contiguous
        # bucket range without touching the data dir. A single-device
        # build carries no layout and the key stays absent.
        from hyperspace_tpu_torch.io.builder import (read_shard_layout,
                                                     summarize_shard_layout)
        layout = read_shard_layout(self._entry.content.root)
        if layout is not None:
            # Per-range string dictionary VALUES stay in the JSON file;
            # the entry carries per-range entry counts.
            self._entry.extra["shardLayout"] = \
                summarize_shard_layout(layout)
        else:
            self._entry.extra.pop("shardLayout", None)
        # The SAME numbers land in the action report: rows/bytes the
        # operation left on disk, measured once.
        self.annotate_report(rows=stats["rowCount"],
                             bytes=stats["dataSizeBytes"])


class CreateAction(CreateActionBase):
    """transient CREATING -> final ACTIVE (reference `CreateAction.scala:27-75`)."""

    def __init__(self, df, index_config: IndexConfig,
                 log_manager: IndexLogManager, data_manager: IndexDataManager,
                 conf: HyperspaceConf):
        super().__init__(log_manager, data_manager, conf)
        self.df = df
        self.index_config = index_config
        self._entry: Optional[IndexLogEntry] = None

    transient_state = States.CREATING
    final_state = States.ACTIVE

    def log_entry(self) -> IndexLogEntry:
        if self._entry is None:
            self._entry = self.get_index_log_entry(
                self.df, self.index_config, self.index_data_path)
        # A fresh copy per begin/end write so state mutation doesn't alias.
        return IndexLogEntry.from_dict(self._entry.to_dict())

    def validate(self) -> None:
        """Reference `CreateAction.scala:42-62`: source must be a plain file
        scan (no filter/project/join on top), index columns must exist in the
        source schema, and no non-DOESNOTEXIST index of the same name."""
        self._recover_stale_writer()
        if not isinstance(self.df.plan, Scan):
            raise HyperspaceException(
                "Only creating index over a plain file scan is supported.")
        schema = self.df.schema
        missing = [c for c in (self.index_config.indexed_columns
                               + self.index_config.included_columns)
                   if not schema.contains(c)]
        if missing:
            raise HyperspaceException(
                "Index config is not applicable to dataframe schema; "
                f"missing columns: {', '.join(missing)}")
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != States.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.index_config.index_name} "
                f"already exists (state {latest.state}).")

    def op(self) -> None:
        self.write(self.df, self.index_config, self.index_data_path)
        self.commit_data_version()
        self.stamp_stats()
