"""User-facing index specification.

Parity: reference `index/IndexConfig.scala:28-166` — name + indexed columns +
included columns; case-insensitive equality; rejects empty/duplicate/
overlapping columns; fluent builder (`index_by(...)`, `include(...)`).
`DataSkippingIndexConfig` specifies the second index kind: per-file sketches
of chosen columns, optionally over a Z-order clustered copy.
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


class DataSkippingIndexConfig:
    """User-facing spec of a DATA-SKIPPING index (extension): which
    columns to sketch, which sketch types to build, and an optional
    multi-column Z-order clustering of the source at build time.

    `sketch_types`: "zonemap" (per-file min/max + null/NaN counts —
    serves eq/range/IN/null-ness refutation) and/or "bloom" (per-file
    blocked bloom filter over value hashes — serves eq/IN refutation
    inside wide zones). `zorder_by` non-empty additionally writes a
    Z-order-interleave-sorted rewrite of the source under the index
    root, which tightens every file's zones and lets the filter rule
    serve the query from the clustered copy."""

    def __init__(self, index_name: str, skipping_columns: Sequence[str],
                 sketch_types: Sequence[str] = SKETCH_TYPES,
                 zorder_by: Sequence[str] = ()):
        self.index_name = index_name
        self.skipping_columns: List[str] = list(skipping_columns)
        self.sketch_types: List[str] = list(sketch_types)
        self.zorder_by: List[str] = list(zorder_by)
        self._validate()

    def _validate(self) -> None:
        if not self.index_name or not self.index_name.strip():
            raise HyperspaceException("Index name cannot be empty.")
        if not self.skipping_columns:
            raise HyperspaceException("Skipping columns cannot be empty.")
        lower = [c.lower() for c in self.skipping_columns]
        if len(set(lower)) < len(lower):
            raise HyperspaceException(
                "Duplicate skipping column names are not allowed.")
        if not self.sketch_types:
            raise HyperspaceException(
                "At least one sketch type is required.")
        bad = [t for t in self.sketch_types if t not in SKETCH_TYPES]
        if bad:
            raise HyperspaceException(
                f"Unknown sketch type(s): {', '.join(bad)} "
                f"(supported: {', '.join(SKETCH_TYPES)}).")
        zlower = [c.lower() for c in self.zorder_by]
        if len(set(zlower)) < len(zlower):
            raise HyperspaceException(
                "Duplicate Z-order column names are not allowed.")

    def __eq__(self, other) -> bool:
        if not isinstance(other, DataSkippingIndexConfig):
            return NotImplemented
        return (self.index_name.lower() == other.index_name.lower()
                and [c.lower() for c in self.skipping_columns]
                == [c.lower() for c in other.skipping_columns]
                and sorted(self.sketch_types) == sorted(other.sketch_types)
                and [c.lower() for c in self.zorder_by]
                == [c.lower() for c in other.zorder_by])

    def __hash__(self) -> int:
        return hash((self.index_name.lower(),
                     tuple(c.lower() for c in self.skipping_columns),
                     tuple(sorted(self.sketch_types)),
                     tuple(c.lower() for c in self.zorder_by)))

    def __repr__(self) -> str:
        return (f"DataSkippingIndexConfig(indexName={self.index_name}, "
                f"skippingColumns={self.skipping_columns}, "
                f"sketchTypes={self.sketch_types}, "
                f"zOrderBy={self.zorder_by})")

    class Builder:
        """Fluent builder mirroring IndexConfig.Builder."""

        def __init__(self):
            self._name: str | None = None
            self._columns: List[str] = []
            self._sketches: List[str] = list(SKETCH_TYPES)
            self._zorder: List[str] = []

        def index_name(self, name: str) -> "DataSkippingIndexConfig.Builder":
            if self._name is not None:
                raise HyperspaceException(
                    "Index name is already set: " + self._name)
            if not name or not name.strip():
                raise HyperspaceException("Index name cannot be empty.")
            self._name = name
            return self

        def skip_by(self, column: str,
                    *columns: str) -> "DataSkippingIndexConfig.Builder":
            if self._columns:
                raise HyperspaceException(
                    "Skipping columns are already set: "
                    + ", ".join(self._columns))
            self._columns = [column, *columns]
            return self

        def sketches(self, *types: str) -> "DataSkippingIndexConfig.Builder":
            self._sketches = list(types)
            return self

        def zorder_by(self, column: str,
                      *columns: str) -> "DataSkippingIndexConfig.Builder":
            if self._zorder:
                raise HyperspaceException(
                    "Z-order columns are already set: "
                    + ", ".join(self._zorder))
            self._zorder = [column, *columns]
            return self

        def create(self) -> "DataSkippingIndexConfig":
            if self._name is None or not self._columns:
                raise HyperspaceException(
                    "Index name and skipping columns are required.")
            return DataSkippingIndexConfig(self._name, self._columns,
                                           self._sketches, self._zorder)

    @staticmethod
    def builder() -> "DataSkippingIndexConfig.Builder":
        return DataSkippingIndexConfig.Builder()
