"""JSON (de)serialization helpers.

Parity: reference `util/JsonUtils.scala:34-44` (Jackson mapper with Scala
module). Here serializable metadata objects implement `to_dict`/`from_dict`;
these helpers pin the wire format.
"""

from __future__ import annotations

import json
from typing import Any


def to_json(obj: Any, indent: int | None = None) -> str:
    if hasattr(obj, "to_dict"):
        obj = obj.to_dict()
    return json.dumps(obj, indent=indent, sort_keys=False)


def from_json(text: str) -> Any:
    return json.loads(text)

