"""Hard delete: DELETED -> (VACUUMING) -> DOESNOTEXIST; removes all data
version directories latest -> 0, deferring behind in-flight pinned reads.

Parity: reference `actions/VacuumAction.scala:23-52`. The pin deferral
has no reference analog — Spark's file sources tolerate listing drift,
but our snapshot-pinned scans read a frozen file list and a concurrent
hard delete would otherwise yank files mid-query (see `index/pins.py`).
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.actions.base import Action


class _VersionPinnedError(HyperspaceException):
    """A data version is held by an in-flight snapshot-pinned read.

    Internal to the vacuum flow: classified retryable so the delete
    backs off (bounded, jittered) behind the reader, and caught after
    the budget to record a deferral instead of failing the vacuum.
    """


class VacuumAction(Action):
    transient_state = States.VACUUMING
    final_state = States.DOESNOTEXIST

    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager,
                 conf: Optional[HyperspaceConf] = None):
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.conf = conf

    def validate(self) -> None:
        state = self.latest_entry("vacuum").state
        if state != States.DELETED:
            raise HyperspaceException(
                f"Vacuum is only supported in {States.DELETED} state; "
                f"current state is {state}.")

    def log_entry(self) -> IndexLogEntry:
        return IndexLogEntry.from_dict(self.latest_entry("vacuum").to_dict())

    def _delete_version(self, version: int) -> bool:
        """Delete one version dir unless an in-flight read pins it.

        Backs off behind the pin with the shared retry policy (bounded
        attempts, jittered exponential delay — never a sleep-in-except);
        returns False when the version stayed pinned through the whole
        budget and the delete was deferred.
        """
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.index import pins
        from hyperspace_tpu_torch.utils import retry

        path = self.data_manager.get_path(version)

        def attempt() -> None:
            if pins.is_pinned(path):
                raise _VersionPinnedError(
                    f"Version dir {path} is pinned by an in-flight read; "
                    f"deferring the hard delete.")
            self.data_manager.delete(version)

        try:
            retry.call(attempt, operation=f"vacuum.delete.v{version}",
                       conf=self.conf, retryable=(_VersionPinnedError,))
            return True
        except _VersionPinnedError:
            telemetry.get_registry().counter(
                "resilience.vacuum.deferred").inc()
            return False

    def op(self) -> None:
        """Delete every data version dir that actually EXISTS, newest
        first (reference `VacuumAction.scala:45-51` walks a dense
        latest..0 range — but a sparse layout, a partially vacuumed
        index, or a crashed build's uncommitted dir must not abort the
        hard delete, and uncommitted partials are invisible to
        `get_latest_version_id` by design). Versions pinned by in-flight
        reads past the backoff budget are skipped — orphaned garbage is
        recoverable; a reader crashed mid-file is not."""
        versions = sorted(self.data_manager.all_version_ids(),
                          reverse=True)
        removed = deferred = 0
        for version in versions:
            if self._delete_version(version):
                removed += 1
            else:
                deferred += 1
        self.annotate_report(versions_removed=removed,
                             versions_deferred=deferred)
