"""Refresh action — full rebuild from the logged plan.

Parity: reference `actions/RefreshAction.scala:23-78`: deserializes the
logged plan back into a dataframe (the Scan re-enumerates source files, so
appended/changed data is picked up), reuses the stored IndexConfig,
REFRESHING -> ACTIVE, `op()` writes into the next `v__=N+1` version dir.
Requires current state ACTIVE. A data-skipping entry takes the same FSM
with its own data job: a full re-sketch (plus the Z-order copy when the
entry has one), `actions/skipping.build_skipping_data`.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.actions.create import CreateActionBase
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager


class RefreshAction(CreateActionBase):
    transient_state = States.REFRESHING
    final_state = States.ACTIVE

    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager, conf: HyperspaceConf):
        super().__init__(log_manager, data_manager, conf)
        self._previous: Optional[IndexLogEntry] = None
        self._entry: Optional[IndexLogEntry] = None
        self._df = None

    @property
    def previous_entry(self) -> IndexLogEntry:
        """Reference `RefreshAction.scala:36-40`."""
        if self._previous is None:
            entry = self.log_manager.get_log(self.base_id)
            if not isinstance(entry, IndexLogEntry):
                raise HyperspaceException("No index log entry to refresh.")
            self._previous = entry
        return self._previous

    @property
    def df(self):
        """Re-derive the dataframe from the logged plan (reference
        `RefreshAction.scala:44-50`); re-lists source files."""
        if self._df is None:
            from hyperspace_tpu_torch.engine.dataframe import DataFrame
            self._df = DataFrame(self.previous_entry.plan())
        return self._df

    @property
    def index_config(self):
        """Reuse the stored config (reference `RefreshAction.scala:52-55`).
        The config TYPE follows the previous entry's kind — refreshing a
        DataSkippingIndex re-runs the sketch build through this same
        FSM action (per-file sketches make a full re-sketch cheap)."""
        prev = self.previous_entry
        from hyperspace_tpu_torch.index.log_entry import DataSkippingIndex
        if isinstance(prev.derived_dataset, DataSkippingIndex):
            from hyperspace_tpu_torch.index.index_config import (
                DataSkippingIndexConfig)
            dd = prev.derived_dataset
            return DataSkippingIndexConfig(prev.name, dd.skipped_columns,
                                           dd.sketch_types, dd.zorder_by)
        return IndexConfig(prev.name, prev.indexed_columns,
                           prev.included_columns)

    def num_buckets(self) -> int:
        """Keep the bucket count the index was created with, so a refresh
        can't silently change the join-compatibility key."""
        return self.previous_entry.num_buckets

    def lineage_enabled(self) -> bool:
        """Lineage is a property of the index once set at creation: a full
        refresh preserves it regardless of the current conf (turning it ON
        via conf for a rebuilt index is allowed — a rebuild rewrites every
        row, so fresh ids are consistent)."""
        return self.previous_entry.has_lineage or super().lineage_enabled()

    def validate(self) -> None:
        """Reference `RefreshAction.scala:64-70`: state must be ACTIVE."""
        self._recover_stale_writer()
        if self.previous_entry.state != States.ACTIVE:
            raise HyperspaceException(
                f"Refresh is only supported in {States.ACTIVE} state; "
                f"current state is {self.previous_entry.state}.")

    def _is_skipping(self) -> bool:
        from hyperspace_tpu_torch.index.index_config import (
            DataSkippingIndexConfig)
        return isinstance(self.index_config, DataSkippingIndexConfig)

    def log_entry(self) -> IndexLogEntry:
        if self._entry is None:
            if self._is_skipping():
                from hyperspace_tpu_torch.actions.skipping import (
                    skipping_log_entry)
                self._entry = skipping_log_entry(
                    self.df, self.index_config, self.index_data_path,
                    self._signature_provider())
            else:
                self._entry = self.get_index_log_entry(
                    self.df, self.index_config, self.index_data_path)
        return IndexLogEntry.from_dict(self._entry.to_dict())

    def op(self) -> None:
        """Reference `RefreshAction.scala:72-77` — rebuild into the next
        version dir; the old dir is retained for in-flight readers."""
        if self._is_skipping():
            from hyperspace_tpu_torch.actions.skipping import (
                build_skipping_data, sweep_source_caches)
            detail = build_skipping_data(self.df, self.index_config,
                                         self.index_data_path, self.conf)
            self.annotate_report(**detail)
            self.commit_data_version()
            self.annotate_report(
                source_roots_swept=sweep_source_caches(self.df))
            self.stamp_stats()
            return
        self.write(self.df, self.index_config, self.index_data_path)
        self.commit_data_version()
        self.stamp_stats()
