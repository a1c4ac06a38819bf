"""Schema model for the relational IR.

The reference stores a Spark StructType JSON string in the index metadata
(`index/IndexLogEntry.scala:39-47`); this framework owns its schema type with
a stable JSON form, plus mappings to pyarrow and numpy dtypes for the
columnar substrate.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List

from hyperspace_tpu_torch.exceptions import HyperspaceException

# Canonical logical type names.
_TYPES = {
    "bool", "int8", "int16", "int32", "int64", "float32", "float64",
    "string", "date32", "timestamp",
}

_ARROW_TO_LOGICAL = {
    "bool": "bool",
    "int8": "int8", "int16": "int16", "int32": "int32", "int64": "int64",
    "uint8": "int16", "uint16": "int32", "uint32": "int64",
    "float": "float32", "double": "float64",
    "string": "string", "large_string": "string",
    "date32[day]": "date32",
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    nullable: bool = True

    def __post_init__(self):
        if self.dtype not in _TYPES:
            raise HyperspaceException(f"Unsupported field type: {self.dtype}")

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.dtype, "nullable": self.nullable}

    @staticmethod
    def from_dict(d: dict) -> "Field":
        return Field(d["name"], d["type"], d.get("nullable", True))


class Schema:
    def __init__(self, fields: Iterable[Field]):
        self.fields: List[Field] = list(fields)
        self._by_lower = {f.name.lower(): f for f in self.fields}

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        f = self._by_lower.get(name.lower())
        if f is None:
            raise HyperspaceException(f"Column not found in schema: {name}")
        return f

    def contains(self, name: str) -> bool:
        return name.lower() in self._by_lower

    def select(self, names: Iterable[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def to_json(self) -> str:
        return json.dumps({"type": "struct",
                           "fields": [f.to_dict() for f in self.fields]})

    @staticmethod
    def from_json(text: str) -> "Schema":
        d = json.loads(text)
        return Schema([Field.from_dict(f) for f in d["fields"]])

    def __eq__(self, other) -> bool:
        if not isinstance(other, Schema):
            return NotImplemented
        return self.fields == other.fields

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}:{f.dtype}" for f in self.fields)
        return f"Schema({inner})"

    @staticmethod
    def from_arrow(arrow_schema) -> "Schema":
        fields = []
        for f in arrow_schema:
            type_str = str(f.type)
            if type_str.startswith("timestamp"):
                logical = "timestamp"
            elif type_str.startswith("dictionary"):
                logical = "string"
            elif type_str.startswith("decimal"):
                logical = "float64"
            else:
                logical = _ARROW_TO_LOGICAL.get(type_str)
            if logical is None:
                raise HyperspaceException(f"Unsupported arrow type: {type_str}")
            fields.append(Field(f.name, logical, f.nullable))
        return Schema(fields)

    def to_arrow(self):
        import pyarrow as pa
        mapping = {
            "bool": pa.bool_(), "int8": pa.int8(), "int16": pa.int16(),
            "int32": pa.int32(), "int64": pa.int64(),
            "float32": pa.float32(), "float64": pa.float64(),
            "string": pa.string(), "date32": pa.date32(),
            "timestamp": pa.timestamp("us"),
        }
        return pa.schema([pa.field(f.name, mapping[f.dtype], f.nullable)
                          for f in self.fields])
