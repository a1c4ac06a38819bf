"""Soft delete: ACTIVE -> (DELETING) -> DELETED; metadata-only.

Parity: reference `actions/DeleteAction.scala:23-43`.
"""

from __future__ import annotations

from hyperspace_tpu_torch.constants import States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.actions.base import Action


class DeleteAction(Action):
    transient_state = States.DELETING
    final_state = States.DELETED

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)

    def validate(self) -> None:
        state = self.latest_entry("delete").state
        if state != States.ACTIVE:
            raise HyperspaceException(
                f"Delete is only supported in {States.ACTIVE} state; "
                f"current state is {state}.")

    def log_entry(self) -> IndexLogEntry:
        return IndexLogEntry.from_dict(self.latest_entry("delete").to_dict())

    def op(self) -> None:
        """Metadata-only transition — no data is touched."""
