"""Hashing utilities.

Parity: reference `util/HashingUtils.scala:32` (`md5Hex`).
"""

import hashlib


def md5_hex(value: str) -> str:
    return hashlib.md5(value.encode("utf-8")).hexdigest()

