"""Versioned, JSON-serialized index metadata records.

Parity: reference `index/LogEntry.scala:22-47` (LogEntry base with mutable
id/state/timestamp/enabled and version-dispatched `fromJson`) and
`index/IndexLogEntry.scala:27-131` (the metadata tree: Content, CoveringIndex,
Signature, LogicalPlanFingerprint, plan source, HDFS source data, helpers).
The serialized shape (kind/properties nesting, version/id/state/timestamp/
enabled tail fields) follows the reference's spec pinned by
`index/IndexLogEntryTest.scala:33-91`, with `source.plan.kind == "Plan"`
holding this framework's own relational-IR JSON instead of a Kryo-serialized
Catalyst plan.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceException

VERSION = "0.1"


@dataclass
class NoOpFingerprint:
    """Placeholder directory fingerprint (reference `IndexLogEntry.scala:27-30`)."""

    kind: str = "NoOp"
    properties: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "properties": dict(self.properties)}

    @staticmethod
    def from_dict(d: dict) -> "NoOpFingerprint":
        return NoOpFingerprint(d.get("kind", "NoOp"), d.get("properties", {}))


@dataclass
class FileInfo:
    """Per-file identity stamp + lineage id (extension: the surveyed
    reference stores bare paths; per-file (size, stamp) records with stable
    ids are its v0.2 lineage direction — they let hybrid scan classify each
    current file as untouched / appended / deleted and serve queries over a
    source with deletions by excluding that file's index rows)."""

    name: str
    size: int
    stamp: str  # mtime_ns locally; mtime+etag/generation on object stores
    id: int

    def to_list(self) -> list:
        return [self.name, self.size, self.stamp, self.id]

    @staticmethod
    def from_list(x: list) -> "FileInfo":
        return FileInfo(x[0], int(x[1]), str(x[2]), int(x[3]))


@dataclass
class Directory:
    """A directory of index/source files (reference `IndexLogEntry.scala:33-36`).

    `file_infos` (optional) carries per-file stamps + lineage ids; when
    absent the serialized shape is byte-identical to the reference spec."""

    path: str
    files: List[str] = field(default_factory=list)
    fingerprint: NoOpFingerprint = field(default_factory=NoOpFingerprint)
    file_infos: Optional[List[FileInfo]] = None

    def to_dict(self) -> dict:
        d = {"path": self.path, "files": list(self.files),
             "fingerprint": self.fingerprint.to_dict()}
        if self.file_infos is not None:
            d["fileInfos"] = [fi.to_list() for fi in self.file_infos]
        return d

    @staticmethod
    def from_dict(d: dict) -> "Directory":
        infos = d.get("fileInfos")
        return Directory(d["path"], list(d.get("files", [])),
                         NoOpFingerprint.from_dict(d.get("fingerprint", {})),
                         None if infos is None
                         else [FileInfo.from_list(x) for x in infos])


@dataclass
class Content:
    """Root + directories of content (reference `IndexLogEntry.scala:33-36`)."""

    root: str
    directories: List[Directory] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"root": self.root,
                "directories": [x.to_dict() for x in self.directories]}

    @staticmethod
    def from_dict(d: dict) -> "Content":
        return Content(d.get("root", ""),
                       [Directory.from_dict(x) for x in d.get("directories", [])])


@dataclass
class CoveringIndex:
    """Derived-dataset spec (reference `IndexLogEntry.scala:39-47`).

    `schema_json` is the JSON-serialized schema of indexed+included columns
    (this framework's `plan/schema.py` format rather than Spark StructType).
    """

    indexed_columns: List[str]
    included_columns: List[str]
    schema_json: str
    num_buckets: int

    kind: str = "CoveringIndex"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {
                "columns": {
                    "indexed": list(self.indexed_columns),
                    "included": list(self.included_columns),
                },
                "schemaString": self.schema_json,
                "numBuckets": self.num_buckets,
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "CoveringIndex":
        p = d["properties"]
        return CoveringIndex(
            indexed_columns=list(p["columns"]["indexed"]),
            included_columns=list(p["columns"]["included"]),
            schema_json=p["schemaString"],
            num_buckets=int(p["numBuckets"]),
            kind=d.get("kind", "CoveringIndex"))

    @classmethod
    def _serde_sample(cls) -> "CoveringIndex":
        """A representative instance for the serde round-trip lint
        (`scripts/check_metrics_coverage.py::check_index_kind_serde`)."""
        return cls(["a"], ["b", "c"], "[]", 8)


@dataclass
class DataSkippingIndex:
    """Derived-dataset spec of a DATA-SKIPPING index (extension; the
    covering index's lightweight sibling — SURVEY §1's "hybrid scan +
    incremental refresh" ecosystem). The index data is a compact
    per-source-file sketch blob (min/max zone maps + blocked bloom
    filters, `index/sketch.py`), not a copy of the rows; `zorder_by`
    non-empty means the build ALSO wrote a Z-order-clustered rewrite of
    the source under the index root, which the filter rule can serve
    pruned reads from (`schema_json` then carries the full source
    schema; otherwise just the sketched columns)."""

    skipped_columns: List[str]
    sketch_types: List[str]
    schema_json: str
    zorder_by: List[str] = field(default_factory=list)

    kind: str = "DataSkippingIndex"

    # Catalog/summary surface shared with CoveringIndex (the manager's
    # IndexSummary rows read these off any derived dataset).
    @property
    def indexed_columns(self) -> List[str]:
        return list(self.skipped_columns)

    @property
    def included_columns(self) -> List[str]:
        return []

    @property
    def num_buckets(self) -> int:
        return 0  # sketch blobs are not bucketed

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {
                "columns": {"skipped": list(self.skipped_columns)},
                "sketchTypes": list(self.sketch_types),
                "zOrderBy": list(self.zorder_by),
                "schemaString": self.schema_json,
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "DataSkippingIndex":
        p = d["properties"]
        return DataSkippingIndex(
            skipped_columns=list(p["columns"]["skipped"]),
            sketch_types=list(p.get("sketchTypes", [])),
            schema_json=p["schemaString"],
            zorder_by=list(p.get("zOrderBy", [])),
            kind=d.get("kind", "DataSkippingIndex"))

    @classmethod
    def _serde_sample(cls) -> "DataSkippingIndex":
        """A representative instance for the serde round-trip lint
        (`scripts/check_metrics_coverage.py::check_index_kind_serde`)."""
        return cls(["a", "b"], ["zonemap", "bloom"], "[]", ["a", "b"])


# THE index-kind serde registry: `IndexLogEntry.from_dict` dispatches the
# `derivedDataset.kind` field through it, so a second index kind flows
# through the same log/action FSM as the covering index. Every class here
# must round-trip `from_dict(x.to_dict()) == x` and provide a
# `_serde_sample()` — `scripts/check_metrics_coverage.py` fails any
# index-kind class in this module that is missing from the registry or
# whose round-trip breaks.
DERIVED_DATASET_KINDS: Dict[str, Any] = {
    "CoveringIndex": CoveringIndex,
    "DataSkippingIndex": DataSkippingIndex,
}


def derived_dataset_from_dict(d: dict):
    kind = d.get("kind", "CoveringIndex")
    cls = DERIVED_DATASET_KINDS.get(kind)
    if cls is None:
        raise HyperspaceException(f"Unknown derived-dataset kind: {kind}")
    return cls.from_dict(d)


@dataclass
class Signature:
    """Provider-name + value pair (reference `IndexLogEntry.scala:50`)."""

    provider: str
    value: str

    def to_dict(self) -> dict:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_dict(d: dict) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclass
class LogicalPlanFingerprint:
    """Fingerprint of the source logical plan (reference `IndexLogEntry.scala:53-58`)."""

    signatures: List[Signature] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"kind": "LogicalPlan",
                "properties": {"signatures": [s.to_dict() for s in self.signatures]}}

    @staticmethod
    def from_dict(d: dict) -> "LogicalPlanFingerprint":
        sigs = d.get("properties", {}).get("signatures", [])
        return LogicalPlanFingerprint([Signature.from_dict(s) for s in sigs])


@dataclass
class PlanSource:
    """Serialized source plan (reference `SparkPlan` node, `IndexLogEntry.scala:61-66`;
    kind is "Plan" here because rawPlan holds this framework's relational-IR
    JSON, not a Spark plan)."""

    raw_plan: str
    fingerprint: LogicalPlanFingerprint

    kind: str = "Plan"

    def to_dict(self) -> dict:
        return {"kind": self.kind,
                "properties": {"rawPlan": self.raw_plan,
                               "fingerprint": self.fingerprint.to_dict()}}

    @staticmethod
    def from_dict(d: dict) -> "PlanSource":
        p = d["properties"]
        return PlanSource(p["rawPlan"],
                          LogicalPlanFingerprint.from_dict(p["fingerprint"]),
                          kind=d.get("kind", "Plan"))


@dataclass
class Hdfs:
    """Source data file listing (reference `Hdfs` node, `IndexLogEntry.scala:69-74`;
    kind string "HDFS" is kept for wire-format parity — content is any
    posix-visible file listing)."""

    content: Content
    kind: str = "HDFS"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "properties": {"content": self.content.to_dict()}}

    @staticmethod
    def from_dict(d: dict) -> "Hdfs":
        return Hdfs(Content.from_dict(d["properties"]["content"]),
                    kind=d.get("kind", "HDFS"))


@dataclass
class Source:
    """Plan + data provenance of an index (reference `IndexLogEntry.scala:77`)."""

    plan: PlanSource
    data: List[Hdfs] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"plan": self.plan.to_dict(), "data": [x.to_dict() for x in self.data]}

    @staticmethod
    def from_dict(d: dict) -> "Source":
        return Source(PlanSource.from_dict(d["plan"]),
                      [Hdfs.from_dict(x) for x in d.get("data", [])])


class LogEntry:
    """Base log record with mutable id/state/timestamp/enabled.

    Parity: reference `index/LogEntry.scala:22-47`; `from_json` dispatches on
    the `version` field.
    """

    def __init__(self, version: str = VERSION):
        self.version = version
        self.id: int = 0
        self.state: str = ""
        self.timestamp: int = int(time.time() * 1000)
        self.enabled: bool = True

    def _tail_dict(self) -> dict:
        return {"version": self.version, "id": self.id, "state": self.state,
                "timestamp": self.timestamp, "enabled": self.enabled}

    def _load_tail(self, d: dict) -> None:
        self.version = d.get("version", VERSION)
        self.id = int(d.get("id", 0))
        self.state = d.get("state", "")
        self.timestamp = int(d.get("timestamp", 0))
        self.enabled = bool(d.get("enabled", True))

    def to_dict(self) -> dict:
        return self._tail_dict()

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_json(text: str) -> "LogEntry":
        d = json.loads(text)
        version = d.get("version")
        if version != VERSION:
            raise HyperspaceException(f"Unsupported log entry version: {version}")
        if "name" in d:
            return IndexLogEntry.from_dict(d)
        entry = LogEntry()
        entry._load_tail(d)
        return entry


class IndexLogEntry(LogEntry):
    """The on-disk index spec (reference `index/IndexLogEntry.scala:80-125`)."""

    def __init__(self, name: str, derived_dataset,
                 content: Content, source: Source,
                 extra: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.name = name
        # Any registered index kind (DERIVED_DATASET_KINDS): CoveringIndex
        # or DataSkippingIndex.
        self.derived_dataset = derived_dataset
        self.content = content
        self.source = source
        self.extra: Dict[str, Any] = dict(extra or {})

    # Helpers (reference `IndexLogEntry.scala:96-124`).

    @property
    def kind(self) -> str:
        """The derived dataset's kind string — what the rewrite rules
        discriminate on ("CoveringIndex" / "DataSkippingIndex")."""
        return self.derived_dataset.kind

    @property
    def schema_json(self) -> str:
        return self.derived_dataset.schema_json

    @property
    def created(self) -> bool:
        from hyperspace_tpu_torch.constants import States
        return self.state == States.ACTIVE

    @property
    def indexed_columns(self) -> List[str]:
        return self.derived_dataset.indexed_columns

    @property
    def included_columns(self) -> List[str]:
        return self.derived_dataset.included_columns

    @property
    def num_buckets(self) -> int:
        return self.derived_dataset.num_buckets

    @property
    def shard_layout(self) -> Optional[Dict[str, Any]]:
        """The born-sharded layout record of this version's data
        (`io/builder.write_shard_layout`, lifted by `stamp_stats`):
        `numShards` and the per-shard contiguous `bucketRanges` the build
        wrote its per-shard parquet files under. None for single-device
        builds. Ownership always derives from the same map
        (`parallel/mesh.bucket_ranges`), so the record is provenance: a
        reader on any mesh size can consume the data."""
        layout = self.extra.get("shardLayout")
        return dict(layout) if isinstance(layout, dict) else None

    @property
    def raw_plan(self) -> str:
        return self.source.plan.raw_plan

    def plan(self):
        """Deserialize the logged relational plan (reference
        `IndexLogEntry.scala:112-116` deserializes rawPlan)."""
        from hyperspace_tpu_torch.plan.serde import plan_from_json
        return plan_from_json(self.source.plan.raw_plan)

    def signature(self) -> Signature:
        sigs = self.source.plan.fingerprint.signatures
        if len(sigs) != 1:
            raise HyperspaceException(
                "Expected exactly one signature, found: " + str(len(sigs)))
        return sigs[0]

    def source_file_list(self) -> List[str]:
        files: List[str] = []
        for hdfs in self.source.data:
            root = hdfs.content.root
            for directory in hdfs.content.directories:
                base = directory.path or root
                for f in directory.files:
                    files.append(f if "/" in f else (base.rstrip("/") + "/" + f if base else f))
        return files

    def source_file_infos(self) -> Optional[Dict[str, FileInfo]]:
        """{absolute path: FileInfo} when per-file lineage stamps were
        captured at build time (lineage-enabled builds); None otherwise
        (including partially-stamped entries, which are treated as
        stampless rather than trusted)."""
        out: Dict[str, FileInfo] = {}
        for hdfs in self.source.data:
            root = hdfs.content.root
            for directory in hdfs.content.directories:
                if directory.file_infos is None:
                    return None
                base = directory.path or root
                for fi in directory.file_infos:
                    path = (fi.name if "/" in fi.name else
                            (base.rstrip("/") + "/" + fi.name
                             if base else fi.name))
                    out[path] = fi
        return out if out else None

    @property
    def has_lineage(self) -> bool:
        """True when the index data carries the per-row lineage column."""
        from hyperspace_tpu_torch.constants import LINEAGE_COLUMN
        from hyperspace_tpu_torch.plan.schema import Schema
        return Schema.from_json(self.schema_json).contains(LINEAGE_COLUMN)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "derivedDataset": self.derived_dataset.to_dict(),
            "content": self.content.to_dict(),
            "source": self.source.to_dict(),
            "extra": dict(self.extra),
        }
        d.update(self._tail_dict())
        return d

    @staticmethod
    def from_dict(d: dict) -> "IndexLogEntry":
        entry = IndexLogEntry(
            name=d["name"],
            derived_dataset=derived_dataset_from_dict(d["derivedDataset"]),
            content=Content.from_dict(d["content"]),
            source=Source.from_dict(d["source"]),
            extra=d.get("extra", {}))
        entry._load_tail(d)
        return entry

    def __eq__(self, other) -> bool:
        if not isinstance(other, IndexLogEntry):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __hash__(self) -> int:
        return hash((self.name, self.id, self.state))
