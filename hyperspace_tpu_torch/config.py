"""Config system.

The reference piggybacks on Spark `SQLConf` string keys declared in
`index/IndexConstants.scala:21-50` and read lazily at use sites
(`actions/CreateActionBase.scala:44-48`). Here `HyperspaceConf` is a small
string-keyed config owned by the session, with the same keys and defaults.
Both the `spark.hyperspace.*` spelling and a `hyperspace.*` short form are
accepted.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from hyperspace_tpu_torch import constants


def _canonical(key: str) -> str:
    if key.startswith("hyperspace."):
        return "spark." + key
    return key


class HyperspaceConf:
    """String-keyed configuration with lazy reads at use sites."""

    def __init__(self, conf: Optional[Dict[str, str]] = None):
        self._conf: Dict[str, str] = {}
        for k, v in (conf or {}).items():
            self.set(k, v)

    def set(self, key: str, value) -> "HyperspaceConf":
        self._conf[_canonical(key)] = str(value)
        return self

    def unset(self, key: str) -> "HyperspaceConf":
        self._conf.pop(_canonical(key), None)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(_canonical(key), default)

    def get_int(self, key: str, default: int) -> int:
        value = self.get(key)
        return int(value) if value is not None else default

    def contains(self, key: str) -> bool:
        return _canonical(key) in self._conf

    # Derived settings, mirroring reference defaulting rules.

    @property
    def warehouse_dir(self) -> str:
        return self.get(constants.WAREHOUSE_PATH,
                        os.path.join(os.getcwd(), constants.WAREHOUSE_PATH_DEFAULT))

    @property
    def system_path(self) -> str:
        """Index system root; default `<warehouse>/indexes`.

        Parity: reference `index/PathResolver.scala:65-69`.
        """
        configured = self.get(constants.INDEX_SYSTEM_PATH)
        if configured:
            return configured
        return os.path.join(self.warehouse_dir, constants.INDEXES_DIR)

    @property
    def num_buckets(self) -> int:
        return self.get_int(constants.INDEX_NUM_BUCKETS,
                            constants.INDEX_NUM_BUCKETS_DEFAULT)

    @property
    def min_device_rows(self) -> int:
        """Batches below this row count run on the host lane."""
        return self.get_int(constants.MIN_DEVICE_ROWS,
                            constants.MIN_DEVICE_ROWS_DEFAULT)

    @property
    def broadcast_threshold(self) -> int:
        """Join sides estimated under this many bytes broadcast as a
        direct-address table (`ops/broadcast_join.py`); <= 0 disables
        (Spark `autoBroadcastJoinThreshold` analog)."""
        return self.get_int(constants.BROADCAST_THRESHOLD,
                            constants.BROADCAST_THRESHOLD_DEFAULT)

    @property
    def io_retry_attempts(self) -> int:
        """Total tries (first call included) for transient storage-IO
        failures; see `utils/retry.py`."""
        return self.get_int(constants.IO_RETRY_ATTEMPTS,
                            constants.IO_RETRY_ATTEMPTS_DEFAULT)

    @property
    def io_retry_base_ms(self) -> float:
        """First backoff delay; doubles per retry (jittered)."""
        return float(self.get(constants.IO_RETRY_BASE_MS,
                              str(constants.IO_RETRY_BASE_MS_DEFAULT)))

    @property
    def io_retry_max_ms(self) -> float:
        """Backoff ceiling per retry."""
        return float(self.get(constants.IO_RETRY_MAX_MS,
                              str(constants.IO_RETRY_MAX_MS_DEFAULT)))

    @property
    def maintenance_lease_seconds(self) -> int:
        """Age past which a transient op-log entry is treated as a crashed
        writer and auto-recovered (Cancel FSM) by the next maintenance
        action; `Hyperspace.recover_index` forces it immediately."""
        return self.get_int(constants.MAINTENANCE_LEASE_SECONDS,
                            constants.MAINTENANCE_LEASE_SECONDS_DEFAULT)

    @property
    def cache_expiry_seconds(self) -> int:
        return self.get_int(
            constants.INDEX_CACHE_EXPIRY_DURATION_SECONDS,
            constants.INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT)

    @property
    def read_cache_bytes(self):
        """Host decoded-batch cache budget; None = env/process default.
        The cache itself is PROCESS-wide — a session that sets this
        governs the shared cache while its queries run, so sessions
        sharing a process should agree on it."""
        value = self.get(constants.READ_CACHE_BYTES_KEY)
        return int(value) if value is not None else None

    @property
    def device_cache_bytes(self):
        """Legacy spelling of the device segment-cache budget; kept as
        the fallback key for `segment_cache_bytes`."""
        value = self.get(constants.DEVICE_CACHE_BYTES_KEY)
        return int(value) if value is not None else None

    @property
    def segment_cache_bytes(self):
        """Device segment-cache budget (`io/segcache.py`); None = the
        legacy `cache.device.bytes` key, then the env/process default.
        Competes with join/sort working sets for device memory — lower
        it (or 0) when large queries run out of memory; 0 releases
        already-resident segments. Process-wide cache, same caveat as
        read_cache_bytes."""
        value = self.get(constants.SEGMENT_CACHE_BYTES_KEY)
        if value is not None:
            return int(value)
        return self.device_cache_bytes

    @property
    def segment_cache_host_bytes(self) -> int:
        """Host-RAM tier budget of the tiered segment cache
        (`io/segcache.py`): device-tier evictions demote into host
        memory up to this many bytes instead of dropping, and a later
        read re-promotes through the TransferEngine fill lane (H2D
        paid, parquet decode skipped). 0 (default) disables the tier."""
        return self.get_int(constants.SEGMENT_CACHE_HOST_BYTES_KEY,
                            constants.SEGMENT_CACHE_HOST_BYTES_DEFAULT)

    @property
    def segment_cache_pin_indexes(self) -> str:
        """Comma-separated index names whose cached segments are never
        evicted by byte pressure (invalidation still drops them)."""
        return self.get(constants.SEGMENT_CACHE_PIN_INDEXES, "") or ""

    @property
    def io_transfer_chunk_bytes(self) -> int:
        """Chunk granularity of pipelined H2D stagings
        (`io/transfer.py`)."""
        return self.get_int(constants.IO_TRANSFER_CHUNK_BYTES,
                            constants.IO_TRANSFER_CHUNK_BYTES_DEFAULT)

    @property
    def io_transfer_inflight_bytes(self) -> int:
        """Bound on bytes in flight across all outstanding puts."""
        return self.get_int(constants.IO_TRANSFER_INFLIGHT_BYTES,
                            constants.IO_TRANSFER_INFLIGHT_BYTES_DEFAULT)

    @property
    def io_transfer_threads(self) -> int:
        """Staging-pool width (decode/convert overlap with the link)."""
        return self.get_int(constants.IO_TRANSFER_THREADS,
                            constants.IO_TRANSFER_THREADS_DEFAULT)

    @property
    def io_transfer_acquire_timeout_ms(self) -> int:
        """Bound on a put's wait for in-flight-window headroom; <= 0
        waits forever."""
        return self.get_int(constants.IO_TRANSFER_ACQUIRE_TIMEOUT_MS,
                            constants.IO_TRANSFER_ACQUIRE_TIMEOUT_MS_DEFAULT)

    @property
    def skipping_enabled(self) -> bool:
        """Query-side gate on data-skipping pruning (`plan/rules/
        skipping.py`): "false" stops FilterIndexRule consulting sketch
        blobs (unpruned scans — correct, just unaccelerated). Build
        verbs ignore it."""
        return (self.get(constants.SKIPPING_ENABLED,
                         constants.SKIPPING_ENABLED_DEFAULT)
                or "true").lower() == "true"

    @property
    def skipping_bloom_fpp(self) -> float:
        """Target false-positive rate of the per-file blocked bloom
        filters; sizes the filter from the file's row count."""
        return float(self.get(constants.SKIPPING_BLOOM_FPP,
                              str(constants.SKIPPING_BLOOM_FPP_DEFAULT)))

    @property
    def skipping_bloom_max_bytes(self) -> int:
        """Per-file, per-column cap on bloom filter bytes — a huge file
        gets a degraded (higher-FPP) filter, never an unbounded blob."""
        return self.get_int(constants.SKIPPING_BLOOM_MAX_BYTES,
                            constants.SKIPPING_BLOOM_MAX_BYTES_DEFAULT)

    @property
    def skipping_zorder_files(self) -> int:
        """Output file count of the optional Z-order clustering rewrite
        at data-skipping build time (more files = tighter zones)."""
        return self.get_int(constants.SKIPPING_ZORDER_FILES,
                            constants.SKIPPING_ZORDER_FILES_DEFAULT)

    def copy(self) -> "HyperspaceConf":
        return HyperspaceConf(dict(self._conf))
