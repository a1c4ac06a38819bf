"""Per-index operation log with optimistic concurrency.

Parity: reference `index/IndexLogManager.scala:32-157` — log lives at
`<indexRoot>/_hyperspace_log/<id>` (monotonically increasing integer
filenames) plus a `latestStable` copy. `write_log(id, entry)` fails if `<id>`
exists, else publishes atomically — exactly one concurrent writer wins an id
(the reference's temp-file + atomic-rename OCC, `IndexLogManager.scala:139-156`;
here `atomic_write_if_absent` in `util/file_utils.py`).
"""

from __future__ import annotations

import json
import os
from abc import ABC, abstractmethod
from typing import Optional

from hyperspace_tpu_torch import constants
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.index.log_entry import LogEntry
from hyperspace_tpu_torch.utils import storage
from hyperspace_tpu_torch.utils import file_utils
from hyperspace_tpu_torch.utils import retry


class IndexLogManager(ABC):
    """Trait parity: reference `index/IndexLogManager.scala:32-54`."""

    @abstractmethod
    def get_log(self, log_id: int) -> Optional[LogEntry]: ...

    @abstractmethod
    def get_latest_id(self) -> Optional[int]: ...

    @abstractmethod
    def get_latest_log(self) -> Optional[LogEntry]: ...

    @abstractmethod
    def get_latest_stable_log(self) -> Optional[LogEntry]: ...

    @abstractmethod
    def create_latest_stable_log(self, log_id: int) -> bool: ...

    @abstractmethod
    def delete_latest_stable_log(self) -> bool: ...

    @abstractmethod
    def write_log(self, log_id: int, entry: LogEntry) -> bool: ...

    # Action reports (observability sidecar, not part of the OCC
    # protocol): default no-ops so in-memory/test managers need not
    # care. `get_latest_id` only parses all-digit filenames, so the
    # `<id>.report.json` sidecars never perturb log-id resolution.

    def write_action_report(self, log_id: int, report: dict) -> bool:
        """Persist a structured action report next to log `<log_id>`."""
        return False

    def get_action_report(self, log_id: int) -> Optional[dict]:
        return None


class IndexLogManagerImpl(IndexLogManager):
    """Filesystem-backed impl (reference `index/IndexLogManager.scala:56-157`).

    `conf` (optional) carries `spark.hyperspace.single.writer`: on object
    stores with no create precondition, write_log RAISES unless that conf
    explicitly accepts check-then-create semantics."""

    def __init__(self, index_path: str, conf=None):
        self.index_path = index_path
        self.log_dir = os.path.join(index_path, constants.HYPERSPACE_LOG)
        self.conf = conf

    def _single_writer(self) -> bool:
        if self.conf is None:
            return False
        return (self.conf.get(constants.SINGLE_WRITER, "false")
                or "false").lower() == "true"

    def _path_for(self, log_id: int) -> str:
        return os.path.join(self.log_dir, str(log_id))

    def _read_entry(self, path: str) -> tuple[LogEntry, str]:
        """Read + parse a log file through the retry seam: transient IO
        errors retry per policy, and so do torn reads (on no-hardlink
        filesystems the OCC fallback publishes the filename before its
        contents — see file_utils.atomic_write_if_absent — so a parse
        failure may just mean the writer hasn't finished). A read that
        stays unparseable through the policy is a genuinely corrupt
        entry. ALL log-file reads must come through here, not just
        get_log."""

        def read():
            contents = file_utils.read_contents(path)
            return LogEntry.from_json(contents), contents

        try:
            return retry.call(read, operation=f"log.read:{path}",
                              policy=retry.policy_for(self.conf),
                              retryable=(json.JSONDecodeError, ValueError))
        except (json.JSONDecodeError, ValueError) as exc:
            raise HyperspaceException(
                f"Corrupt log entry at {path}: {exc}")

    def get_log(self, log_id: int) -> Optional[LogEntry]:
        path = self._path_for(log_id)
        if not file_utils.exists(path):
            return None
        entry, _ = self._read_entry(path)
        return entry

    def get_latest_id(self) -> Optional[int]:
        """Max numeric filename (reference `IndexLogManager.scala:80-89`)."""
        if not file_utils.is_dir(self.log_dir):
            return None
        ids = [int(name) for name in storage.listdir_names(self.log_dir)
               if name.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> Optional[LogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def get_latest_stable_log(self) -> Optional[LogEntry]:
        """Read `latestStable`, else scan ids downward for a stable state
        (reference `IndexLogManager.scala:91-110`)."""
        stable_path = os.path.join(self.log_dir, constants.LATEST_STABLE_LOG)
        if file_utils.exists(stable_path):
            entry, _ = self._read_entry(stable_path)
            return entry
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry = self.get_log(log_id)
            if entry is not None and entry.state in constants.STABLE_STATES:
                return entry
        return None

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Copy `<id>` -> `latestStable` (reference `IndexLogManager.scala:112-122`).

        The copy publishes ATOMICALLY (temp file + rename locally, one
        object put on stores): `latestStable` is rewritten in place, so a
        reader racing a plain streamed write could observe a torn JSON —
        the one log file the OCC torn-read retry does not protect (a torn
        id file means "writer still publishing"; a torn latestStable used
        to parse as corruption). Transient write failures retry per the
        io.retry policy."""
        source = self._path_for(log_id)
        if not file_utils.exists(source):
            return False
        entry, contents = self._read_entry(source)
        if entry.state not in constants.STABLE_STATES:
            return False
        stable_path = os.path.join(self.log_dir, constants.LATEST_STABLE_LOG)
        retry.call(lambda: file_utils.atomic_publish(stable_path, contents),
                   operation=f"log.latest_stable:{stable_path}",
                   policy=retry.policy_for(self.conf))
        # Index-FSM invalidation hook for the metadata-only terminal
        # transitions: publishing a DELETED/DOESNOTEXIST stable state
        # means the rules will not select this index again — its device
        # segments are released here. (Data-version bumps invalidate at
        # `IndexDataManager.commit`; this covers delete/vacuum-end.)
        if entry.state in (constants.States.DELETED,
                           constants.States.DOESNOTEXIST):
            from hyperspace_tpu_torch.io import segcache
            segcache.on_index_dropped(self.index_path)
        return True

    def delete_latest_stable_log(self) -> bool:
        """Reference `IndexLogManager.scala:124-137`."""
        path = os.path.join(self.log_dir, constants.LATEST_STABLE_LOG)
        if not file_utils.exists(path):
            return True
        try:
            file_utils.remove_file(path)
            return True
        except (OSError, FileNotFoundError):
            return False

    def write_log(self, log_id: int, entry: LogEntry) -> bool:
        if file_utils.exists(self._path_for(log_id)):
            return False
        entry.id = log_id
        # Transient failures retry. If a failed-looking attempt actually
        # landed the object (response lost), the retry reports False and
        # the action aborts as a conflict — leaving ITS OWN transient
        # entry as latest, which lease-based recovery (or recover_index)
        # unwinds; correctness of the OCC log is never at risk.
        return retry.call(
            lambda: file_utils.atomic_write_if_absent(
                self._path_for(log_id), entry.to_json(indent=2),
                single_writer=self._single_writer()),
            operation=f"log.write:{self._path_for(log_id)}",
            policy=retry.policy_for(self.conf))

    # -- action reports ---------------------------------------------------

    ACTION_REPORT_SUFFIX = ".report.json"

    def _report_path(self, log_id: int) -> str:
        return os.path.join(self.log_dir,
                            f"{log_id}{self.ACTION_REPORT_SUFFIX}")

    def write_action_report(self, log_id: int, report: dict) -> bool:
        """Persist the action report alongside the log entry it
        finalized. Best-effort: the log entry is already durable, a
        failed sidecar write must NEVER fail the action — and fsspec
        object-store backends raise library-specific errors (aiohttp
        client errors, botocore ClientError, ...), so the guard is ANY
        Exception, not just OSError. Transient failures get the standard
        retries first."""
        try:
            retry.call(
                lambda: file_utils.create_file(
                    self._report_path(log_id),
                    json.dumps(report, indent=2, default=str)),
                operation=f"log.report:{self._report_path(log_id)}",
                policy=retry.policy_for(self.conf))
            return True
        except Exception:
            return False

    def get_action_report(self, log_id: int) -> Optional[dict]:
        path = self._report_path(log_id)
        if not file_utils.exists(path):
            return None
        return json.loads(file_utils.read_contents(path))
