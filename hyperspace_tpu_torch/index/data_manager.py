"""Versioned index data directories with crash-consistent commits.

Parity: reference `index/IndexDataManager.scala:24-73` — index data lives in
`<indexRoot>/v__=<N>/` (Hive-partition-style naming); refresh writes N+1,
vacuum deletes all versions. Layout doc: reference
`docs/_docs/14-toh-indexes-on-the-lake.md:16-27`.

Crash consistency (extension): every data-writing action finalizes its
`v__=N` dir with a `_committed` marker written LAST (Delta-style). Readers
asking for the CURRENT version (`get_latest_version_id`) only see committed
dirs, so a build that crashed mid-write can never be served; writers asking
for the NEXT version (`next_version_id`) see ALL dirs, so a crashed build's
partial dir is skipped — never mixed into — and vacuum's hard delete
(`all_version_ids`) sweeps partial dirs with everything else.
"""

from __future__ import annotations

import json
import os
import time
from abc import ABC, abstractmethod
from typing import List, Optional

from hyperspace_tpu_torch import constants
from hyperspace_tpu_torch.utils import file_utils, storage


class IndexDataManager(ABC):
    """Trait parity: reference `index/IndexDataManager.scala:38-44`, plus
    the commit-marker protocol. The commit/enumeration methods have
    working defaults so metadata-only fakes stay three methods."""

    @abstractmethod
    def get_latest_version_id(self) -> Optional[int]:
        """Latest COMMITTED version — the serving contract."""

    @abstractmethod
    def get_path(self, version_id: int) -> str: ...

    @abstractmethod
    def delete(self, version_id: int) -> None: ...

    def all_version_ids(self) -> List[int]:
        """Every version that physically exists, committed or not —
        vacuum's hard-delete contract. Default derives a dense range from
        the latest id (fakes); the filesystem impl lists real dirs, so
        sparse/partially-vacuumed layouts enumerate correctly."""
        latest = self.get_latest_version_id()
        return list(range(latest + 1)) if latest is not None else []

    def next_version_id(self) -> int:
        """First version id no dir (committed OR partial) occupies — the
        writing contract; skipping partial dirs keeps a new build from
        mixing files with a crashed one's leftovers."""
        ids = self.all_version_ids()
        return (max(ids) + 1) if ids else 0

    def commit(self, version_id: int, touched_buckets=None,
               carried_from=None) -> None:
        """Finalize a fully-written version (no-op for fakes).
        `touched_buckets`/`carried_from` is the bucket-scoped
        invalidation channel: an incremental refresh that carried the
        previous version's runs forward names exactly the bucket ids it
        rewrote, so the segment cache keeps (rekeys) warm entries of
        every other bucket instead of dropping the whole set."""

    def is_committed(self, version_id: int) -> bool:
        return True


class IndexDataManagerImpl(IndexDataManager):
    def __init__(self, index_path: str):
        self.index_path = index_path

    def _version_dirs(self, committed_only: bool = False) -> List[int]:
        if not file_utils.is_dir(self.index_path):
            return []
        prefix = constants.INDEX_VERSION_DIRECTORY_PREFIX + "="
        out = []
        for name in storage.listdir_names(self.index_path):
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                version = int(name[len(prefix):])
                if committed_only and not self.is_committed(version):
                    continue
                out.append(version)
        return sorted(out)

    def get_latest_version_id(self) -> Optional[int]:
        """Latest `v__=N` dir carrying the commit marker (reference
        `IndexDataManager.scala:55-66`, hardened: a crashed build's
        partial dir is invisible here)."""
        versions = self._version_dirs(committed_only=True)
        return versions[-1] if versions else None

    def all_version_ids(self) -> List[int]:
        return self._version_dirs()

    def get_path(self, version_id: int) -> str:
        return os.path.join(
            self.index_path,
            f"{constants.INDEX_VERSION_DIRECTORY_PREFIX}={version_id}")

    def _marker_path(self, version_id: int) -> str:
        return os.path.join(self.get_path(version_id),
                            constants.INDEX_DATA_COMMIT_MARKER)

    def commit(self, version_id: int, touched_buckets=None,
               carried_from=None) -> None:
        """Write the `_committed` marker — the LAST write of a build; the
        version is served only after this lands. Committing is also THE
        cache-invalidation event for the version bump: every
        data-writing action (create/refresh/incremental/optimize)
        funnels through here, so the device segment cache and the
        stamped host caches learn about new bytes at exactly the
        boundary where they become servable. An incremental refresh
        passes `touched_buckets` + `carried_from` so the cache
        invalidates bucket-scoped."""
        file_utils.create_file(
            self._marker_path(version_id),
            json.dumps({"committedAtMs": int(time.time() * 1000)}))
        from hyperspace_tpu_torch.io import segcache
        segcache.on_version_committed(self.index_path, version_id,
                                      touched_buckets=touched_buckets,
                                      carried_from=carried_from)

    def is_committed(self, version_id: int) -> bool:
        return file_utils.exists(self._marker_path(version_id))

    def delete(self, version_id: int) -> None:
        file_utils.delete(self.get_path(version_id))
        # Vacuum's hard delete: the version's bytes are gone from disk,
        # so its segments must leave the device (and the host caches).
        from hyperspace_tpu_torch.io import segcache
        segcache.on_version_deleted(self.index_path, version_id)
