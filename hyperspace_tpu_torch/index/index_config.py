"""User-facing index specification.

Parity: reference `index/IndexConfig.scala:28-166` — name + indexed columns +
included columns; case-insensitive equality; rejects empty/duplicate/
overlapping columns; fluent builder (`index_by(...)`, `include(...)`).
"""

from __future__ import annotations

from typing import List, Sequence

from hyperspace_tpu_torch.exceptions import HyperspaceException


class IndexConfig:
    def __init__(self, index_name: str, indexed_columns: Sequence[str],
                 included_columns: Sequence[str] = ()):
        self.index_name = index_name
        self.indexed_columns: List[str] = list(indexed_columns)
        self.included_columns: List[str] = list(included_columns)
        self._validate()

    def _validate(self) -> None:
        if not self.index_name or not self.index_name.strip():
            raise HyperspaceException("Index name cannot be empty.")
        if not self.indexed_columns:
            raise HyperspaceException("Indexed columns cannot be empty.")
        lower_indexed = [c.lower() for c in self.indexed_columns]
        lower_included = [c.lower() for c in self.included_columns]
        if len(set(lower_indexed)) < len(lower_indexed):
            raise HyperspaceException("Duplicate indexed column names are not allowed.")
        if len(set(lower_included)) < len(lower_included):
            raise HyperspaceException("Duplicate included column names are not allowed.")
        if set(lower_indexed) & set(lower_included):
            raise HyperspaceException(
                "Duplicate column names in indexed/included columns are not allowed.")

    # Case-insensitive equality (reference `index/IndexConfig.scala:44-58`).
    def __eq__(self, other) -> bool:
        if not isinstance(other, IndexConfig):
            return NotImplemented
        return (self.index_name.lower() == other.index_name.lower()
                and [c.lower() for c in self.indexed_columns]
                == [c.lower() for c in other.indexed_columns]
                and sorted(c.lower() for c in self.included_columns)
                == sorted(c.lower() for c in other.included_columns))

    def __hash__(self) -> int:
        return hash((self.index_name.lower(),
                     tuple(c.lower() for c in self.indexed_columns),
                     tuple(sorted(c.lower() for c in self.included_columns))))

    def __repr__(self) -> str:
        return (f"IndexConfig(indexName={self.index_name}, "
                f"indexedColumns={self.indexed_columns}, "
                f"includedColumns={self.included_columns})")

    class Builder:
        """Fluent builder (reference `index/IndexConfig.scala:83-166`)."""

        def __init__(self):
            self._name: str | None = None
            self._indexed: List[str] = []
            self._included: List[str] = []

        def index_name(self, name: str) -> "IndexConfig.Builder":
            if self._name is not None:
                raise HyperspaceException("Index name is already set: " + self._name)
            if not name or not name.strip():
                raise HyperspaceException("Index name cannot be empty.")
            self._name = name
            return self

        def index_by(self, column: str, *columns: str) -> "IndexConfig.Builder":
            if self._indexed:
                raise HyperspaceException("Indexed columns are already set: "
                                          + ", ".join(self._indexed))
            self._indexed = [column, *columns]
            return self

        def include(self, column: str, *columns: str) -> "IndexConfig.Builder":
            if self._included:
                raise HyperspaceException("Included columns are already set: "
                                          + ", ".join(self._included))
            self._included = [column, *columns]
            return self

        def create(self) -> "IndexConfig":
            if self._name is None or not self._indexed:
                raise HyperspaceException(
                    "Index name and indexed columns are required.")
            return IndexConfig(self._name, self._indexed, self._included)

    @staticmethod
    def builder() -> "IndexConfig.Builder":
        return IndexConfig.Builder()


SKETCH_TYPES = ("zonemap", "bloom")
