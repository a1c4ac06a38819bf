"""Per-object memo keyed by identity.

`IdentityMemo.get(obj, compute)` returns `compute()` for `obj`, computed
once while `obj` lives. The table holds `obj` by a weak reference, so it
never keeps an object alive: the entry drops itself when `obj` dies, and
a hit checks that the referent is still `obj`, so a newer object at a
reused `id` is computed anew. A memoised value is only as sound as the
object is immutable: callers memoise objects that are never written in
place.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Tuple


class IdentityMemo:
    """id(obj) -> (weak reference to obj, value), under one lock. The
    value is computed outside the lock (it may be slow); when two
    threads compute for one object, the first to store wins and both
    return its value. The lock is re-entrant: a referent can die, and
    its callback take the lock, while the same thread holds it."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: Dict[int, tuple] = {}

    def get(self, obj, compute: Callable[[], object]) -> Tuple[object, bool]:
        """(value, hit): `hit` says the value came from the memo and
        `compute` did not run."""
        key = id(obj)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0]() is obj:
                return ent[1], True
        value = compute()
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0]() is obj:
                return ent[1], False

            def _drop(ref, k=key):
                # Remove the entry only if the slot still holds this
                # reference: the id may belong to a newer object by the
                # time the callback fires.
                with self._lock:
                    cur = self._entries.get(k)
                    if cur is not None and cur[0] is ref:
                        del self._entries[k]

            try:
                ref = weakref.ref(obj, _drop)
            except TypeError:  # not weak-referenceable: pin it (rare)
                ref = (lambda o: (lambda: o))(obj)
            self._entries[key] = (ref, value)
        return value, False
