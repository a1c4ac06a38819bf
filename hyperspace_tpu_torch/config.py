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

    def copy(self) -> "HyperspaceConf":
        return HyperspaceConf(dict(self._conf))
