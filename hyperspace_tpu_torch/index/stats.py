"""IndexStatistics: the user-facing summary of an index.

Parity: com/microsoft/hyperspace/index/IndexStatistics.scala:43-195 — a
summary row per index (name, columns, schema, state, location) plus
extended stats (file/byte counts incl. appended/deleted deltas).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .log_entry import IndexLogEntry


@dataclass
class IndexStatistics:
    name: str
    indexed_columns: List[str]
    included_columns: List[str]
    num_buckets: int
    schema: Dict[str, str]
    kind: str
    state: str
    index_location: Optional[str] = None
    # extended
    num_index_files: Optional[int] = None
    index_size_bytes: Optional[int] = None
    source_files: Optional[int] = None
    source_size_bytes: Optional[int] = None
    appended_files: Optional[int] = None
    deleted_files: Optional[int] = None
    properties: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def from_entry(entry: IndexLogEntry, extended: bool = False) -> "IndexStatistics":
        files = entry.content.files()
        loc = None
        if files:
            # common prefix up to the index dir (the v__= parent's parent)
            loc = str(files[0].rsplit("/", 2)[0])
        stats = IndexStatistics(
            name=entry.name,
            indexed_columns=list(entry.indexed_columns),
            included_columns=list(entry.included_columns),
            num_buckets=entry.num_buckets,
            schema=dict(entry.schema),
            kind=entry.derived_dataset.kind,
            state=entry.state,
            index_location=loc,
        )
        if extended:
            infos = entry.content.file_infos()
            stats.num_index_files = len(infos)
            stats.index_size_bytes = sum(f.size for f in infos)
            src = entry.source_file_infos()
            stats.source_files = len(src)
            stats.source_size_bytes = sum(f.size for f in src)
            upd = entry.source_update()
            stats.appended_files = (
                len(upd.appended_files.files()) if upd and upd.appended_files else 0
            )
            stats.deleted_files = (
                len(upd.deleted_files.files()) if upd and upd.deleted_files else 0
            )
            stats.properties = dict(entry.derived_dataset.properties)
        return stats

    def to_row(self) -> Dict[str, object]:
        """Summary columns (IndexStatistics.scala:64-71)."""
        return {
            "name": self.name,
            "indexedColumns": list(self.indexed_columns),
            "includedColumns": list(self.included_columns),
            "numBuckets": self.num_buckets,
            "schema": dict(self.schema),
            "indexLocation": self.index_location,
            "state": self.state,
        }
