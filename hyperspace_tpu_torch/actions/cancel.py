"""Cancel — crash recovery back to the last stable state.

Parity: reference `actions/CancelAction.scala:23-66`: only valid from
NON-stable states; the final state is the last stable log's state (a vacuum
interrupted mid-flight resolves to DOESNOTEXIST since data may be partially
deleted; no stable log at all also resolves to DOESNOTEXIST). `op()` is
empty — partial-file cleanup is deferred to vacuum, as in the reference.
"""

from __future__ import annotations

from hyperspace_tpu_torch.constants import STABLE_STATES, States
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.actions.base import Action


class CancelAction(Action):
    transient_state = States.CANCELLING

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)

    @property
    def final_state(self) -> str:
        """Reference `CancelAction.scala:43-52`."""
        stable = self.log_manager.get_latest_stable_log()
        if stable is None or stable.state == States.VACUUMING:
            return States.DOESNOTEXIST
        return stable.state

    def validate(self) -> None:
        """Reference `CancelAction.scala:54-60`: must be mid-operation."""
        state = self.latest_entry("cancel").state
        if state in STABLE_STATES:
            raise HyperspaceException(
                f"Cancel is not supported in {state} state.")

    def log_entry(self) -> IndexLogEntry:
        """Restore the last *stable* entry's metadata, not the in-flight
        transient one: a cancelled refresh must not leave content.root
        pointing at the partially-written new version dir. Falls back to the
        latest entry when no stable record exists (final state is then
        DOESNOTEXIST, so its content is never served)."""
        stable = self.log_manager.get_latest_stable_log()
        source = stable if isinstance(stable, IndexLogEntry) else self.latest_entry("cancel")
        return IndexLogEntry.from_dict(source.to_dict())

    def op(self) -> None:
        """No data movement; the FSM transition itself is the recovery."""
