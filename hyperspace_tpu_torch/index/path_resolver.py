"""Index name -> filesystem path resolution.

Parity: reference `index/PathResolver.scala:30-100` — system path from conf
(default `<warehouse>/indexes`), `get_index_path(name)` enumerates the system
root for a case-insensitive match and falls back to `<root>/<name>` for
new indexes.
"""

from __future__ import annotations


from hyperspace_tpu_torch.utils import file_utils, storage

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.utils.name_utils import normalize_index_name


class PathResolver:
    def __init__(self, conf: HyperspaceConf):
        self._conf = conf

    @property
    def system_path(self) -> str:
        return self._conf.system_path

    def get_index_path(self, name: str) -> str:
        """Case-insensitive directory match (reference `PathResolver.scala:39-58`)."""
        normalized = normalize_index_name(name)
        root = self.system_path
        if file_utils.is_dir(root):
            for entry in sorted(storage.listdir_names(root)):
                if entry.lower() == normalized.lower():
                    return storage.join(root, entry)
        return storage.join(root, normalized)
