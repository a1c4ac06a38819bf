"""In-flight version-pin registry: vacuum-vs-read race safety.

A rule-selected index scan records the committed version directory and
its files at optimization time, but nothing in that stops
`VacuumAction` from deleting the directory while the read is mid-flight.
Two guarantees close the race:

1. **Defer behind the pin** — executing index scans register their
   version directories here for the duration of the read; vacuum checks
   `is_pinned` before each version delete and backs off (bounded,
   jittered, via `utils/retry.py`) while a reader holds the pin. A
   version still pinned after the backoff budget is *skipped*, not
   force-deleted — the directory becomes harmless garbage and the
   deferral is counted (`resilience.vacuum.deferred`).
2. **Typed surface** — if the delete wins anyway (pin registered after
   vacuum's check, or a different process vacuumed), the read fails
   inside `ScanExec`'s guard and surfaces as a typed
   `IndexDataUnavailableError`, which `DataFrame.collect` converts into
   a source-plan fallback. Never a raw mid-query `FileNotFoundError`.

The registry is process-wide (module-level) because pins must be
visible across sessions sharing a warehouse in one process. Refcounted:
concurrent readers of the same version each hold a pin; the path
unpins when the last releases.
"""

import contextlib
import os
import threading
from typing import Dict, Iterable, Iterator

_lock = threading.Lock()
_pins: Dict[str, int] = {}


def _norm(path: str) -> str:
    return os.path.normpath(str(path))


def pin(path: str) -> None:
    """Register one reader of `path` (a committed version directory)."""
    key = _norm(path)
    with _lock:
        _pins[key] = _pins.get(key, 0) + 1


def unpin(path: str) -> None:
    """Release one reader of `path`; no-op if it was never pinned."""
    key = _norm(path)
    with _lock:
        count = _pins.get(key, 0)
        if count <= 1:
            _pins.pop(key, None)
        else:
            _pins[key] = count - 1


def is_pinned(path: str) -> bool:
    """True while any in-flight read holds `path` pinned."""
    with _lock:
        return _pins.get(_norm(path), 0) > 0


@contextlib.contextmanager
def pinned(paths: Iterable[str]) -> Iterator[None]:
    """Hold pins on every path for the duration of the block."""
    held = [_norm(p) for p in paths]
    for p in held:
        pin(p)
    try:
        yield
    finally:
        for p in held:
            unpin(p)
