"""Index catalog management: binds the lifecycle verbs to actions.

Parity: reference `index/IndexManager.scala:24-81` (trait),
`index/IndexCollectionManager.scala:26-173` (binding + catalog listing +
IndexSummary rows), `index/CachingIndexCollectionManager.scala:37-99`
(read-path caching; every mutating API clears the cache).
"""

from __future__ import annotations

import logging
import threading
from abc import ABC, abstractmethod
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Sequence

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.cache import Cache, IndexCacheFactory
from hyperspace_tpu_torch.utils import file_utils, storage
from hyperspace_tpu_torch.index.factories import (IndexDataManagerFactory,
                                            IndexLogManagerFactory)
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.path_resolver import PathResolver
from hyperspace_tpu_torch.actions.cancel import CancelAction
from hyperspace_tpu_torch.actions.create import CreateAction
from hyperspace_tpu_torch.actions.delete import DeleteAction
from hyperspace_tpu_torch.actions.optimize import OptimizeAction
from hyperspace_tpu_torch.actions.refresh import RefreshAction
from hyperspace_tpu_torch.actions.restore import RestoreAction
from hyperspace_tpu_torch.actions.vacuum import VacuumAction

logger = logging.getLogger(__name__)


@dataclass
class IndexSummary:
    """Catalog row (reference `IndexCollectionManager.scala:151-173`),
    including the source plan's pretty string (`queryPlan` — the field
    round 3 omitted)."""

    name: str
    indexed_columns: List[str]
    included_columns: List[str]
    num_buckets: int
    schema_json: str
    index_location: str
    query_plan: str
    state: str
    kind: str = "CoveringIndex"

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "indexedColumns": list(self.indexed_columns),
            "includedColumns": list(self.included_columns),
            "numBuckets": self.num_buckets,
            "schema": self.schema_json,
            "indexLocation": self.index_location,
            "queryPlan": self.query_plan,
            "state": self.state,
            "kind": self.kind,
        }


def summaries_for_roots(index_summaries: Sequence[IndexSummary],
                        roots: Sequence[str]) -> List[IndexSummary]:
    """Catalog entries whose data location matches any of the scan
    `roots` (scan equality is root-path containment, the reference's
    `PlanAnalyzer.scala:209-221` convention). Used by the explain "Indexes
    used" section."""
    import os

    def contains(parent: str, child: str) -> bool:
        parent = os.path.normpath(parent)
        child = os.path.normpath(child)
        return child == parent or child.startswith(parent + os.sep)

    used = []
    for summary in index_summaries:
        if any(contains(summary.index_location, root)
               or contains(root, summary.index_location)
               for root in roots):
            used.append(summary)
    return used


def _pretty_plan(entry: IndexLogEntry) -> str:
    """Pretty string of the LOGGED source plan (reference stores
    `df.queryExecution.optimizedPlan.toString`,
    `IndexCollectionManager.scala:151-173`). The log keeps the serialized
    logical IR; a corrupt/unparseable record degrades to empty rather
    than failing the whole catalog listing."""
    try:
        return entry.plan().tree_string()
    except Exception:
        return ""


class IndexManager(ABC):
    """Trait parity: reference `index/IndexManager.scala:24-81`."""

    @abstractmethod
    def indexes(self) -> List[IndexSummary]: ...

    @abstractmethod
    def create(self, df, index_config) -> None: ...

    @abstractmethod
    def delete(self, index_name: str) -> None: ...

    @abstractmethod
    def restore(self, index_name: str) -> None: ...

    @abstractmethod
    def vacuum(self, index_name: str) -> None: ...

    @abstractmethod
    def refresh(self, index_name: str, mode: str = "full") -> None: ...

    @abstractmethod
    def optimize(self, index_name: str) -> None: ...

    @abstractmethod
    def cancel(self, index_name: str) -> None: ...

    @abstractmethod
    def recover(self, index_name: str) -> bool: ...

    @abstractmethod
    def get_indexes(self, states: Optional[Sequence[str]] = None) -> List[IndexLogEntry]: ...


class IndexCollectionManager(IndexManager):
    def __init__(self, conf: HyperspaceConf,
                 log_manager_factory: Optional[IndexLogManagerFactory] = None,
                 data_manager_factory: Optional[IndexDataManagerFactory] = None,
                 path_resolver: Optional[PathResolver] = None):
        self.conf = conf
        self.log_manager_factory = log_manager_factory or IndexLogManagerFactory()
        self.data_manager_factory = data_manager_factory or IndexDataManagerFactory()
        self.path_resolver = path_resolver or PathResolver(conf)

    def _managers(self, index_name: str):
        path = self.path_resolver.get_index_path(index_name)
        return (self.log_manager_factory.create(path, conf=self.conf),
                self.data_manager_factory.create(path))

    def create(self, df, index_config) -> None:
        """`index_config` selects the index KIND: an `IndexConfig`
        builds a covering index, a `DataSkippingIndexConfig` builds the
        sketch-blob skipping kind — both through the same FSM."""
        log_manager, data_manager = self._managers(index_config.index_name)
        from hyperspace_tpu_torch.index.index_config import (
            DataSkippingIndexConfig)
        if isinstance(index_config, DataSkippingIndexConfig):
            from hyperspace_tpu_torch.actions.skipping import (
                CreateSkippingIndexAction)
            CreateSkippingIndexAction(df, index_config, log_manager,
                                      data_manager, self.conf).run()
            return
        CreateAction(df, index_config, log_manager, data_manager, self.conf).run()

    def delete(self, index_name: str) -> None:
        log_manager, _ = self._managers(index_name)
        DeleteAction(log_manager).run()

    def restore(self, index_name: str) -> None:
        log_manager, _ = self._managers(index_name)
        RestoreAction(log_manager).run()

    def vacuum(self, index_name: str) -> None:
        log_manager, data_manager = self._managers(index_name)
        VacuumAction(log_manager, data_manager, self.conf).run()

    def refresh(self, index_name: str, mode: str = "full") -> None:
        """mode 'full' rebuilds; mode 'incremental' dispatches on the
        index KIND recorded in the op log: covering indexes take the
        bucketed-delta path (RefreshIncrementalAction), data-skipping
        indexes the per-file sketch-append path
        (RefreshSkippingAppendAction) — both append-only streaming
        refreshes through the same FSM."""
        log_manager, data_manager = self._managers(index_name)
        if mode == "full":
            RefreshAction(log_manager, data_manager, self.conf).run()
        elif mode == "incremental":
            from hyperspace_tpu_torch.index.log_entry import (
                DataSkippingIndex)
            latest = log_manager.get_latest_log()
            if isinstance(latest, IndexLogEntry) and \
                    isinstance(latest.derived_dataset, DataSkippingIndex):
                from hyperspace_tpu_torch.actions.skipping import (
                    RefreshSkippingAppendAction)
                RefreshSkippingAppendAction(log_manager, data_manager,
                                            self.conf).run()
                return
            from hyperspace_tpu_torch.actions.refresh_incremental import (
                RefreshIncrementalAction)
            RefreshIncrementalAction(log_manager, data_manager,
                                     self.conf).run()
        else:
            raise HyperspaceException(
                f"Unknown refresh mode: {mode} (use 'full' or 'incremental').")

    def optimize(self, index_name: str) -> None:
        log_manager, data_manager = self._managers(index_name)
        OptimizeAction(log_manager, data_manager, self.conf).run()

    def cancel(self, index_name: str) -> None:
        log_manager, _ = self._managers(index_name)
        CancelAction(log_manager).run()

    def recover(self, index_name: str) -> bool:
        """Force crash recovery NOW, without waiting out the maintenance
        lease: if the index's latest log entry is transient (a writer
        died between begin and end), run the Cancel FSM transition back
        to the last stable state. Returns True iff a recovery ran; a
        stable index is a no-op (unlike `cancel`, which raises), so the
        call is safe to fire on suspicion."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.constants import STABLE_STATES

        log_manager, _ = self._managers(index_name)
        latest = log_manager.get_latest_log()
        if latest is None:
            raise HyperspaceException(f"No such index: {index_name}.")
        if latest.state in STABLE_STATES:
            return False
        CancelAction(log_manager).run()
        telemetry.get_registry().counter("resilience.recoveries").inc()
        telemetry.event("resilience", "recovered", index=index_name,
                        stale_state=latest.state, forced=True)
        return True

    def indexes(self) -> List[IndexSummary]:
        """All indexes not in DOESNOTEXIST, as summary rows (reference
        `IndexCollectionManager.scala:79-85`)."""
        out = []
        for entry in self.get_indexes():
            if entry.state == States.DOESNOTEXIST:
                continue
            out.append(IndexSummary(
                name=entry.name,
                indexed_columns=entry.indexed_columns,
                included_columns=entry.included_columns,
                num_buckets=entry.num_buckets,
                schema_json=entry.schema_json,
                index_location=entry.content.root,
                query_plan=_pretty_plan(entry),
                state=entry.state,
                kind=entry.kind))
        return out

    def indexes_df(self):
        """Catalog as a pandas DataFrame (the reference returns a Spark
        DataFrame from `hs.indexes`)."""
        import pandas as pd
        return pd.DataFrame([s.to_dict() for s in self.indexes()])

    def get_indexes(self, states: Optional[Sequence[str]] = None) -> List[IndexLogEntry]:
        """List every index dir under the system path, read each latest log,
        filter by state (reference `IndexCollectionManager.scala:87-105`)."""
        root = self.path_resolver.system_path
        if not file_utils.is_dir(root):
            return []
        entries: List[IndexLogEntry] = []
        for name in sorted(storage.listdir_names(root)):
            index_path = storage.join(root, name)
            if not file_utils.is_dir(index_path):
                continue
            log_manager = self.log_manager_factory.create(index_path,
                                                          conf=self.conf)
            try:
                entry = log_manager.get_latest_log()
            except HyperspaceException as exc:
                # One corrupt index must not take down the whole catalog.
                logger.warning("Skipping unreadable index at %s: %s",
                               index_path, exc)
                continue
            if isinstance(entry, IndexLogEntry):
                if states is None or entry.state in states:
                    entries.append(entry)
        return entries


class CachingIndexCollectionManager(IndexCollectionManager):
    """Caches `get_indexes`; mutating APIs clear the cache (reference
    `CachingIndexCollectionManager.scala:37-99`) before AND after they
    run. A listing that began before a clear is not cached: a query
    planning while a refresh is mid-flight reads the transient state, and
    caching that read after the refresh committed would hide the new
    version until the cache expired (the reference clears only before)."""

    def __init__(self, conf: HyperspaceConf, **kwargs):
        super().__init__(conf, **kwargs)
        self._cache: Cache = IndexCacheFactory().create(conf)
        self._generation = 0
        self._generation_lock = threading.Lock()

    def clear_cache(self) -> None:
        with self._generation_lock:
            self._generation += 1
            self._cache.clear()

    def get_indexes(self, states: Optional[Sequence[str]] = None) -> List[IndexLogEntry]:
        if states is None:
            cached = self._cache.get()
            if cached is not None:
                return cached
            generation = self._generation
            entries = super().get_indexes()
            with self._generation_lock:
                if generation == self._generation:
                    self._cache.set(entries)
            return entries
        return [e for e in self.get_indexes() if e.state in states]

    @contextmanager
    def _mutating(self):
        self.clear_cache()
        try:
            yield
        finally:
            self.clear_cache()

    def create(self, df, index_config) -> None:
        with self._mutating():
            super().create(df, index_config)

    def delete(self, index_name: str) -> None:
        with self._mutating():
            super().delete(index_name)

    def restore(self, index_name: str) -> None:
        with self._mutating():
            super().restore(index_name)

    def vacuum(self, index_name: str) -> None:
        with self._mutating():
            super().vacuum(index_name)

    def refresh(self, index_name: str, mode: str = "full") -> None:
        with self._mutating():
            super().refresh(index_name, mode)

    def optimize(self, index_name: str) -> None:
        with self._mutating():
            super().optimize(index_name)

    def cancel(self, index_name: str) -> None:
        with self._mutating():
            super().cancel(index_name)

    def recover(self, index_name: str) -> bool:
        with self._mutating():
            return super().recover(index_name)
