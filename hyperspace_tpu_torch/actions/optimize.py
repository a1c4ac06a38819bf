"""Optimize — merge-compaction of incremental index deltas.

The surveyed reference only has full rebuild (`RefreshAction`); its
roadmap requires incremental refresh + compaction. OptimizeAction
compacts the delta files written by incremental refresh into one sorted
run per bucket (`io/builder.compact_index`, `ops/merge.py`),
ACTIVE -> (OPTIMIZING) -> ACTIVE into the next `v__=N+1`.
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.actions.create import CreateActionBase
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager


class OptimizeAction(CreateActionBase):
    transient_state = States.OPTIMIZING
    final_state = States.ACTIVE

    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager, conf: HyperspaceConf):
        super().__init__(log_manager, data_manager, conf)
        self._previous: Optional[IndexLogEntry] = None
        self._entry: Optional[IndexLogEntry] = None

    @property
    def previous_entry(self) -> IndexLogEntry:
        if self._previous is None:
            entry = self.log_manager.get_log(self.base_id)
            if not isinstance(entry, IndexLogEntry):
                raise HyperspaceException("No index log entry to optimize.")
            self._previous = entry
        return self._previous

    def num_buckets(self) -> int:
        return self.previous_entry.num_buckets

    def validate(self) -> None:
        from hyperspace_tpu_torch.index.log_entry import DataSkippingIndex

        self._recover_stale_writer()
        if isinstance(self.previous_entry.derived_dataset,
                      DataSkippingIndex):
            raise HyperspaceException(
                "Optimize does not apply to data-skipping indexes: "
                "there are no incremental delta runs to compact.")
        if self.previous_entry.state != States.ACTIVE:
            raise HyperspaceException(
                f"Optimize is only supported in {States.ACTIVE} state; "
                f"current state is {self.previous_entry.state}.")

    def log_entry(self) -> IndexLogEntry:
        if self._entry is None:
            entry = IndexLogEntry.from_dict(self.previous_entry.to_dict())
            entry.content.root = self.index_data_path
            entry.content.directories = []
            entry.extra = dict(entry.extra)
            self._entry = entry
        return IndexLogEntry.from_dict(self._entry.to_dict())

    def op(self) -> None:
        from hyperspace_tpu_torch._torch_config import device_of
        from hyperspace_tpu_torch.io import parquet
        from hyperspace_tpu_torch.io.builder import compact_index

        runs_before = sum(
            len(files) for files in
            parquet.bucket_files(self.previous_entry.content.root).values())
        written, lane = compact_index(self.previous_entry,
                                      self.index_data_path,
                                      device_of(self.conf))
        self.annotate_report(runs_compacted=runs_before,
                             files_written=len(written), lane=lane)
        self.commit_data_version()
        self.stamp_stats()
