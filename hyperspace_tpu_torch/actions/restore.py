"""Restore: DELETED -> (RESTORING) -> ACTIVE; metadata-only.

Parity: reference `actions/RestoreAction.scala:23-43`.
"""

from __future__ import annotations

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.actions.base import Action


class RestoreAction(Action):
    transient_state = States.RESTORING
    final_state = States.ACTIVE

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)

    def validate(self) -> None:
        state = self.latest_entry("restore").state
        if state != States.DELETED:
            raise HyperspaceException(
                f"Restore is only supported in {States.DELETED} state; "
                f"current state is {state}.")

    def log_entry(self) -> IndexLogEntry:
        return IndexLogEntry.from_dict(self.latest_entry("restore").to_dict())

    def op(self) -> None:
        """Metadata-only transition."""
