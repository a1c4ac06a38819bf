from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    CoveringIndex,
    Directory,
    Hdfs,
    IndexLogEntry,
    LogEntry,
    LogicalPlanFingerprint,
    NoOpFingerprint,
    PlanSource,
    Signature,
    Source,
)

__all__ = [
    "IndexConfig",
    "Content",
    "CoveringIndex",
    "Directory",
    "Hdfs",
    "IndexLogEntry",
    "LogEntry",
    "LogicalPlanFingerprint",
    "NoOpFingerprint",
    "PlanSource",
    "Signature",
    "Source",
]
