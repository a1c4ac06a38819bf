"""Index name normalization.

Parity: reference `util/IndexNameUtils.scala:31` (trim, spaces -> `_`).
"""


def normalize_index_name(name: str) -> str:
    return name.strip().replace(" ", "_")
