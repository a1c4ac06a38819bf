"""Read-path cache for index metadata.

Parity: reference `index/Cache.scala:23-41` (Cache trait) and
`CreationTimeBasedIndexCache` (`index/CachingIndexCollectionManager.scala:117-160`)
expiring after `spark.hyperspace.index.cache.expiryDurationInSeconds`
(default 300 s), plus the factory seam (`index/IndexCacheFactory.scala:23-38`).
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Generic, Optional, TypeVar

from hyperspace_tpu_torch.config import HyperspaceConf

T = TypeVar("T")


class Cache(ABC, Generic[T]):
    @abstractmethod
    def get(self) -> Optional[T]: ...

    @abstractmethod
    def set(self, entry: T) -> None: ...

    @abstractmethod
    def clear(self) -> None: ...


class CreationTimeBasedCache(Cache[T]):
    """Single-entry expiring cache on `time.monotonic()` — wall-clock
    (`time.time()`) jumps from NTP steps or manual clock changes would
    prematurely expire (forward jump) or immortalize (backward jump)
    the entry; expiry is a DURATION, so it must ride the monotonic
    clock. Hit/miss/expiry counts land as `cache.index_metadata.*`."""

    def __init__(self, conf: HyperspaceConf):
        self._conf = conf
        self._entry: Optional[T] = None
        self._created_at: float = 0.0

    def get(self) -> Optional[T]:
        from hyperspace_tpu_torch.telemetry import memory as _mem
        if self._entry is None:
            _mem.cache_miss("index_metadata")
            return None
        if time.monotonic() - self._created_at \
                > self._conf.cache_expiry_seconds:
            _mem.cache_miss("index_metadata")
            _mem.cache_eviction("index_metadata")
            self.clear()
            return None
        _mem.cache_hit("index_metadata")
        return self._entry

    def set(self, entry: T) -> None:
        from hyperspace_tpu_torch.telemetry import memory as _mem
        self._entry = entry
        self._created_at = time.monotonic()
        _mem.cache_stats("index_metadata", None, 1)

    def clear(self) -> None:
        from hyperspace_tpu_torch.telemetry import memory as _mem
        self._entry = None
        self._created_at = 0.0
        _mem.cache_stats("index_metadata", None, 0)


class IndexCacheFactory:
    def create(self, conf: HyperspaceConf) -> Cache:
        return CreationTimeBasedCache(conf)
