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
    clock."""

    def __init__(self, conf: HyperspaceConf):
        self._conf = conf
        self._entry: Optional[T] = None
        self._created_at: float = 0.0

    def get(self) -> Optional[T]:
        if self._entry is None:
            return None
        if time.monotonic() - self._created_at \
                > self._conf.cache_expiry_seconds:
            self.clear()
            return None
        return self._entry

    def set(self, entry: T) -> None:
        self._entry = entry
        self._created_at = time.monotonic()

    def clear(self) -> None:
        self._entry = None
        self._created_at = 0.0


class IndexCacheFactory:
    def create(self, conf: HyperspaceConf) -> Cache:
        return CreationTimeBasedCache(conf)
