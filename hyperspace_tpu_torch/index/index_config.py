"""User-facing index specifications.

Parity: com/microsoft/hyperspace/index/IndexConfig.scala:28-165 —
case-insensitive equality, duplicate-column checks and a fluent builder —
plus DataSkippingIndexConfig for the sketch-index kind (index/sketches.py).
"""

from __future__ import annotations

from typing import Iterable, List

from ..exceptions import HyperspaceException


class IndexConfig:
    def __init__(
        self,
        index_name: str,
        indexed_columns: Iterable[str],
        included_columns: Iterable[str] = (),
    ):
        self.index_name = index_name
        self.indexed_columns: List[str] = list(indexed_columns)
        self.included_columns: List[str] = list(included_columns)
        if not self.index_name:
            raise HyperspaceException("Index name cannot be empty.")
        if not self.indexed_columns:
            raise HyperspaceException("Indexed columns cannot be empty.")
        # Duplicate checks are case-insensitive (IndexConfig.scala:40-60).
        low_indexed = [c.lower() for c in self.indexed_columns]
        low_included = [c.lower() for c in self.included_columns]
        if len(set(low_indexed)) != len(low_indexed):
            raise HyperspaceException("Duplicate indexed column names are not allowed.")
        if len(set(low_included)) != len(low_included):
            raise HyperspaceException("Duplicate included column names are not allowed.")
        if set(low_indexed) & set(low_included):
            raise HyperspaceException(
                "Duplicate column names in indexed/included columns are not allowed."
            )

    def __eq__(self, other: object) -> bool:
        """Case-insensitive; indexed order matters, included order doesn't
        (IndexConfig.scala:62-80)."""
        if not isinstance(other, IndexConfig):
            return False
        return (
            self.index_name.lower() == other.index_name.lower()
            and [c.lower() for c in self.indexed_columns]
            == [c.lower() for c in other.indexed_columns]
            and sorted(c.lower() for c in self.included_columns)
            == sorted(c.lower() for c in other.included_columns)
        )

    def __hash__(self) -> int:
        return hash(
            (
                self.index_name.lower(),
                tuple(c.lower() for c in self.indexed_columns),
                tuple(sorted(c.lower() for c in self.included_columns)),
            )
        )

    def __repr__(self) -> str:
        return (
            f"IndexConfig({self.index_name}, indexed={self.indexed_columns}, "
            f"included={self.included_columns})"
        )

    @staticmethod
    def builder() -> "IndexConfigBuilder":
        return IndexConfigBuilder()


class IndexConfigBuilder:
    """Fluent builder (IndexConfig.scala:88-165)."""

    def __init__(self) -> None:
        self._name: str = ""
        self._indexed: List[str] = []
        self._included: List[str] = []

    def index_name(self, name: str) -> "IndexConfigBuilder":
        if self._name:
            raise HyperspaceException("Index name is already set.")
        if not name:
            raise HyperspaceException("Index name cannot be empty.")
        self._name = name
        return self

    def index_by(self, *columns: str) -> "IndexConfigBuilder":
        if self._indexed:
            raise HyperspaceException("indexBy can only be called once.")
        if not columns:
            raise HyperspaceException("Indexed columns cannot be empty.")
        self._indexed = list(columns)
        return self

    def include(self, *columns: str) -> "IndexConfigBuilder":
        if self._included:
            raise HyperspaceException("include can only be called once.")
        if not columns:
            raise HyperspaceException("Included columns cannot be empty.")
        self._included = list(columns)
        return self

    def create(self) -> IndexConfig:
        return IndexConfig(self._name, self._indexed, self._included)


class DataSkippingIndexConfig:
    """Spec for a data-skipping index: a name plus one or more sketches
    (index/sketches.py). The sketch list is ordered; each names the source
    column it summarizes."""

    def __init__(self, index_name: str, sketches):
        from .sketches import SketchSpec

        self.index_name = index_name
        self.sketches = list(sketches)
        if not self.index_name:
            raise HyperspaceException("Index name cannot be empty.")
        if not self.sketches:
            raise HyperspaceException("At least one sketch is required.")
        for s in self.sketches:
            if not isinstance(s, SketchSpec):
                raise HyperspaceException(f"Not a sketch spec: {s!r}.")
        low = [(type(s).__name__, s.column.lower()) for s in self.sketches]
        if len(set(low)) != len(low):
            raise HyperspaceException(
                "Duplicate sketches (same kind and column) are not allowed."
            )
