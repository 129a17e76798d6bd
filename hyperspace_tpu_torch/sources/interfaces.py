"""Source-provider SPI: pluggable adapters describing file-based sources.

Parity: com/microsoft/hyperspace/index/sources/interfaces.scala:43-153
(FileBasedSourceProvider + builder). Providers answer, for a given source:
how to snapshot it into a FileRelation, how to re-snapshot it at refresh
time from a logged Relation, and how to enumerate (path → file id) lineage
pairs. Each call across providers must resolve to exactly one Some — the
manager enforces it (FileBasedSourceProviderManager.scala:153-182).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..index.log_entry import FileIdTracker, Relation
from .relation import FileRelation


class FileBasedSourceProvider:
    """SPI (interfaces.scala:61-153). Methods return None when this
    provider does not handle the given source."""

    def supports_format(self, file_format: str) -> bool:
        raise NotImplementedError

    def create_relation(
        self,
        root_paths: List[str],
        file_format: str,
        options: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
    ) -> Optional[FileRelation]:
        """Snapshot the source right now (interfaces.scala:75)."""
        raise NotImplementedError

    def refresh_relation(self, relation: Relation) -> Optional[FileRelation]:
        """Re-snapshot a logged relation's source (interfaces.scala:90)."""
        raise NotImplementedError

    def all_files(self, relation: FileRelation) -> Optional[List]:
        """Current leaf files of the relation (interfaces.scala:120)."""
        raise NotImplementedError

    def lineage_pairs(
        self, relation: FileRelation, tracker: FileIdTracker
    ) -> Optional[List[Tuple[str, int]]]:
        """(path, file id) pairs for the lineage column
        (interfaces.scala:142)."""
        raise NotImplementedError
