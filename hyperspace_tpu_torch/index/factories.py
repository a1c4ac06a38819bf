"""Dependency-injection seams for log/data managers.

Parity: reference `index/factories.scala:22-50` — the injection points tests
use to substitute fakes.
"""

from __future__ import annotations

from hyperspace_tpu_torch.index.data_manager import IndexDataManager, IndexDataManagerImpl
from hyperspace_tpu_torch.index.log_manager import IndexLogManager, IndexLogManagerImpl


class IndexLogManagerFactory:
    def create(self, index_path: str, conf=None) -> IndexLogManager:
        return IndexLogManagerImpl(index_path, conf=conf)


class IndexDataManagerFactory:
    def create(self, index_path: str) -> IndexDataManager:
        return IndexDataManagerImpl(index_path)
