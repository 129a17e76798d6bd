"""JSON (de)serialization for the metadata model.

Parity: com/microsoft/hyperspace/util/JsonUtils.scala:27-45 (Jackson wrapper).
Here serde is hand-rolled over dataclass-style objects that implement
``to_json_dict``/``from_json_dict`` so the on-disk schema is explicit and
stable (the operation log is a persistence format, not a pickle).
"""

from __future__ import annotations

import json
from typing import Any


def to_json(obj: Any, indent: int | None = 2) -> str:
    """Serialize an object that exposes ``to_json_dict`` (or a plain dict)."""
    d = obj.to_json_dict() if hasattr(obj, "to_json_dict") else obj
    return json.dumps(d, indent=indent, sort_keys=True)


def from_json(text: str) -> Any:
    return json.loads(text)
