"""Framework exception types.

Parity: reference `HyperspaceException.scala:19` (single framework
exception), plus the typed scan-time signal the graceful-degradation
path keys on.
"""


class HyperspaceException(Exception):
    """Raised for all user-facing framework errors."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class IndexDataUnavailableError(HyperspaceException):
    """An index the optimizer selected turned out missing or unreadable
    at SCAN time (data root deleted out-of-band, files corrupt, storage
    failing past the retry policy). Raised only for rule-selected index
    scans — `DataFrame.collect` catches it and falls back to the
    source-data plan instead of failing the query, recording a
    `resilience.fallbacks` counter and a `degraded` decision event."""

    def __init__(self, message: str, index_name=None):
        super().__init__(message)
        self.index_name = index_name
