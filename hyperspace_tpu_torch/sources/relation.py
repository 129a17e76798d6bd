"""FileRelation: the descriptor of a file-based source a plan scans.

The analog of Spark's HadoopFsRelation/LogicalRelation at the altitude the
reference uses it (a bag of root paths + format + schema + options + the
concrete file snapshot). Carrying the file snapshot on the relation is what
lets rewrite rules and signature providers run without re-listing the
filesystem — the fabricated-metadata test seam of HyperspaceRuleSuite
(SURVEY.md §4) falls out for free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..index.log_entry import FileInfo
from ..storage.partitions import PartitionSpec


@dataclass
class FileRelation:
    root_paths: List[str]
    file_format: str
    schema: Dict[str, str]
    files: List[FileInfo]  # full-path FileInfos (the current snapshot)
    options: Dict[str, str] = field(default_factory=dict)
    # Physical format of the data files when it differs from the logical
    # source format — e.g. a versioned-lake table is format "vlt" but its
    # files are parquet (the analog of DeltaLakeFileBasedSource.
    # internalFileFormatName, DeltaLakeFileBasedSource.scala:120-126).
    internal_format: Optional[str] = None
    # Hive-style partition columns carried in directory names (see
    # storage.partitions). When set, ``schema`` already includes these
    # columns (file columns first, partition columns after — Spark's
    # ordering) and every read of this relation's files materializes them.
    partition_spec: Optional["PartitionSpec"] = None

    @property
    def read_format(self) -> str:
        return self.internal_format or self.file_format

    @property
    def column_names(self) -> List[str]:
        return list(self.schema.keys())

    def total_size(self) -> int:
        return sum(f.size for f in self.files)

    def describe(self) -> str:
        return f"{self.file_format}:{','.join(self.root_paths)}"
