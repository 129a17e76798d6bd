"""The index metadata model — the JSON schema of the operation log.

Parity: com/microsoft/hyperspace/index/IndexLogEntry.scala (686 LoC) and
LogEntry.scala:22-46 in the reference, redesigned as plain dataclasses with
explicit JSON serde (no Jackson). The on-disk schema is the contract: every
entry written by this module must round-trip byte-stably (golden test in
tests/test_log_entry.py mirrors IndexLogEntryTest.scala:75).

Structure (reference lines in parens):
  Content(root: Directory)                       (:43-113)
  Directory(name, files, subdirs) + merge        (:123-316)
  FileInfo(name, size, mtime, id)                (:321-344) — id excluded from eq
  CoveringIndex(indexed, included, schema, numBuckets, properties) (:347-360)
  Signature / LogicalPlanFingerprint             (:363-371)
  Update(appended, deleted), Relation, Source    (:379-430)
  IndexLogEntry                                  (:433-603)
  FileIdTracker                                  (:617-686)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import PurePosixPath
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..exceptions import HyperspaceException

LOG_ENTRY_VERSION = "0.1"


# ---------------------------------------------------------------------------
# FileInfo
# ---------------------------------------------------------------------------
@dataclass
class FileInfo:
    """A leaf data file: (name, size, mtime, id).

    ``name`` is the file name when the FileInfo lives inside a Directory
    tree, or a full path when used standalone (set-diff computations).
    Equality and hashing exclude ``id``, exactly as the reference overrides
    equals/hashCode (IndexLogEntry.scala:321-344): ids are assigned by a
    FileIdTracker and must not affect change detection.
    """

    name: str
    size: int
    modified_time: int
    id: int

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, FileInfo)
            and self.name == other.name
            and self.size == other.size
            and self.modified_time == other.modified_time
        )

    def __hash__(self) -> int:
        return hash((self.name, self.size, self.modified_time))

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "size": self.size,
            "modifiedTime": self.modified_time,
            "id": self.id,
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "FileInfo":
        return FileInfo(d["name"], d["size"], d["modifiedTime"], d["id"])


# ---------------------------------------------------------------------------
# Directory / Content
# ---------------------------------------------------------------------------
@dataclass
class Directory:
    """A node of the file tree: directory name, leaf files, subdirectories.

    Reference: IndexLogEntry.scala:123-316 (incl. ``merge`` and the
    ``fromDirectory``/``fromLeafFiles`` builders).
    """

    name: str
    files: List[FileInfo] = field(default_factory=list)
    subdirs: List["Directory"] = field(default_factory=list)

    def merge(self, other: "Directory") -> "Directory":
        """Merge two trees rooted at the same directory name
        (IndexLogEntry.scala:144-172). Files are concatenated; same-named
        subdirectories merge recursively."""
        if self.name != other.name:
            raise HyperspaceException(
                f"Merging directories with names {self.name} and {other.name} failed."
            )
        files = list(self.files) + list(other.files)
        by_name = {d.name: d for d in self.subdirs}
        merged: List[Directory] = []
        other_names = {d.name for d in other.subdirs}
        for od in other.subdirs:
            if od.name in by_name:
                merged.append(by_name[od.name].merge(od))
            else:
                merged.append(od)
        merged.extend(d for d in self.subdirs if d.name not in other_names)
        return Directory(self.name, files, sorted(merged, key=lambda d: d.name))

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "files": [f.to_json_dict() for f in self.files],
            "subDirs": [d.to_json_dict() for d in self.subdirs],
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Directory":
        return Directory(
            d["name"],
            [FileInfo.from_json_dict(f) for f in d["files"]],
            [Directory.from_json_dict(s) for s in d["subDirs"]],
        )

    # -- builders ------------------------------------------------------------
    @staticmethod
    def from_leaf_files(
        paths: Iterable[str],
        tracker: "FileIdTracker",
        stats: Optional[Dict[str, Tuple[int, int]]] = None,
    ) -> Optional["Directory"]:
        """Build a rooted tree from absolute leaf-file paths, assigning file
        ids via ``tracker`` (IndexLogEntry.scala:238-316). Returns None for
        an empty input. Paths must be absolute; the root of the returned
        tree is the filesystem root ("/"). ``stats`` (path -> (size,
        mtime_ms)) lets a caller that already statted the tree (one
        scandir pass) avoid a second stat per file."""
        paths = sorted(str(p) for p in paths)
        if not paths:
            return None
        root = Directory("/")
        for p in paths:
            pp = PurePosixPath(p)
            if not pp.is_absolute():
                raise HyperspaceException(f"from_leaf_files requires absolute paths: {p}")
            pre = stats.get(p) if stats is not None else None
            if pre is not None:
                size, mtime = pre
            else:
                st = os.stat(p)
                # ns-derived ms, NOT int(st_mtime * 1000): the float form
                # rounds differently by up to 1ms, and a grain mismatch
                # between stat sites would read as a phantom modification
                size, mtime = st.st_size, st.st_mtime_ns // 1_000_000
            fid = tracker.add_file(p, size, mtime)
            node = root
            for part in pp.parts[1:-1]:
                nxt = next((d for d in node.subdirs if d.name == part), None)
                if nxt is None:
                    nxt = Directory(part)
                    node.subdirs.append(nxt)
                    node.subdirs.sort(key=lambda d: d.name)
                node = nxt
            node.files.append(FileInfo(pp.name, size, mtime, fid))
        return root


@dataclass
class Content:
    """Root of a file tree plus lazy flattened views
    (IndexLogEntry.scala:43-113)."""

    root: Directory

    def files(self) -> List[str]:
        """All leaf-file full paths, depth-first (IndexLogEntry.scala:56-70)."""
        out: List[str] = []

        def walk(node: Directory, prefix: str) -> None:
            base = prefix if node.name == "/" else prefix + node.name + "/"
            for f in node.files:
                out.append(base + f.name)
            for d in node.subdirs:
                walk(d, base)

        walk(self.root, "/" if self.root.name == "/" else "")
        return out

    def file_infos(self) -> List[FileInfo]:
        """FileInfos with full-path names (IndexLogEntry.scala:72-87)."""
        out: List[FileInfo] = []

        def walk(node: Directory, prefix: str) -> None:
            base = prefix if node.name == "/" else prefix + node.name + "/"
            for f in node.files:
                out.append(FileInfo(base + f.name, f.size, f.modified_time, f.id))
            for d in node.subdirs:
                walk(d, base)

        walk(self.root, "/" if self.root.name == "/" else "")
        return out

    def total_size(self) -> int:
        def walk(node: Directory) -> int:
            return sum(f.size for f in node.files) + sum(
                walk(d) for d in node.subdirs
            )

        return walk(self.root)

    def merge(self, other: "Content") -> "Content":
        return Content(self.root.merge(other.root))

    def to_json_dict(self) -> Dict[str, Any]:
        return {"root": self.root.to_json_dict()}

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Content":
        return Content(Directory.from_json_dict(d["root"]))

    @staticmethod
    def from_leaf_files(
        paths: Iterable[str],
        tracker: "FileIdTracker",
        stats: Optional[Dict[str, Tuple[int, int]]] = None,
    ) -> Optional["Content"]:
        root = Directory.from_leaf_files(paths, tracker, stats)
        return Content(root) if root is not None else None


# ---------------------------------------------------------------------------
# FileIdTracker
# ---------------------------------------------------------------------------
class FileIdTracker:
    """Assigns stable integer ids per (path, size, mtime) key
    (IndexLogEntry.scala:617-686). Used for the lineage column and for
    consistent ids across refreshes."""

    def __init__(self) -> None:
        self._ids: Dict[Tuple[str, int, int], int] = {}
        self._max_id: int = -1  # UNKNOWN_FILE_ID

    @property
    def max_id(self) -> int:
        return self._max_id

    def file_to_id_map(self) -> Dict[Tuple[str, int, int], int]:
        return dict(self._ids)

    def add_file(self, path: str, size: int, mtime: int) -> int:
        key = (str(path), size, mtime)
        if key in self._ids:
            return self._ids[key]
        self._max_id += 1
        self._ids[key] = self._max_id
        return self._max_id

    def add_file_info(self, info: FileInfo) -> None:
        """Register a FileInfo carrying a pre-assigned id, asserting
        consistency (IndexLogEntry.scala:647-668)."""
        if info.id < 0:
            raise HyperspaceException(f"Cannot add file with unknown id: {info.name}")
        key = (info.name, info.size, info.modified_time)
        existing = self._ids.get(key)
        if existing is not None:
            if existing != info.id:
                raise HyperspaceException(
                    f"Adding file {info.name} with id {info.id} conflicts with "
                    f"existing id {existing}."
                )
            return
        self._ids[key] = info.id
        self._max_id = max(self._max_id, info.id)

    def get_file_id(self, path: str, size: int, mtime: int) -> Optional[int]:
        return self._ids.get((str(path), size, mtime))


# ---------------------------------------------------------------------------
# Covering index spec
# ---------------------------------------------------------------------------
@dataclass
class CoveringIndex:
    """The derived-dataset spec: indexed/included columns, schema, buckets
    (IndexLogEntry.scala:347-360). ``schema`` maps column name -> dtype
    string (our columnar dtypes, not Spark's DDL JSON). ``properties``
    carries lineage and storage-format flags."""

    indexed_columns: List[str]
    included_columns: List[str]
    schema: Dict[str, str]
    num_buckets: int
    properties: Dict[str, str] = field(default_factory=dict)

    kind: str = "CoveringIndex"

    def all_columns(self) -> List[str]:
        return list(self.indexed_columns) + list(self.included_columns)

    def has_lineage(self) -> bool:
        # Reference: IndexLogEntry.hasLineageColumn (:538-547)
        return self.properties.get("lineage", "false").lower() == "true"

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "properties": {
                "columns": {
                    "indexed": list(self.indexed_columns),
                    "included": list(self.included_columns),
                },
                "schema": dict(self.schema),
                "numBuckets": self.num_buckets,
                "properties": dict(self.properties),
            },
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "CoveringIndex":
        p = d["properties"]
        return CoveringIndex(
            indexed_columns=list(p["columns"]["indexed"]),
            included_columns=list(p["columns"]["included"]),
            schema=dict(p["schema"]),
            num_buckets=p["numBuckets"],
            properties=dict(p.get("properties", {})),
            kind=d.get("kind", "CoveringIndex"),
        )


@dataclass
class DataSkippingIndex:
    """Derived-dataset spec for a data-skipping (sketch) index — the
    BASELINE.md config-5 index kind. No data copy exists; the index's
    content is one sketch table (sketches.json) summarizing every source
    file per sketched column. Duck-types CoveringIndex's accessor surface
    so IndexLogEntry stays kind-agnostic."""

    sketches: List[Dict[str, Any]]  # serialized SketchSpecs (index/sketches.py)
    schema: Dict[str, str]  # sketched column -> dtype
    properties: Dict[str, str] = field(default_factory=dict)

    kind: str = "DataSkippingIndex"

    @property
    def indexed_columns(self) -> List[str]:
        # preserve sketch order, dedupe repeated columns
        return list(dict.fromkeys(s["column"] for s in self.sketches))

    @property
    def included_columns(self) -> List[str]:
        return []

    @property
    def num_buckets(self) -> int:
        return 1  # no bucketing: the index is a metadata table

    def all_columns(self) -> List[str]:
        return self.indexed_columns

    def has_lineage(self) -> bool:
        return False

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "properties": {
                "sketches": [dict(s) for s in self.sketches],
                "schema": dict(self.schema),
                "properties": dict(self.properties),
            },
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "DataSkippingIndex":
        p = d["properties"]
        return DataSkippingIndex(
            sketches=[dict(s) for s in p["sketches"]],
            schema=dict(p["schema"]),
            properties=dict(p.get("properties", {})),
        )


def derived_dataset_from_json_dict(d: Dict[str, Any]):
    """Kind dispatch for the derivedDataset field (the reference's Jackson
    polymorphic deserialization of CoveringIndex, IndexLogEntry.scala:347)."""
    kind = d.get("kind", "CoveringIndex")
    if kind == "DataSkippingIndex":
        return DataSkippingIndex.from_json_dict(d)
    return CoveringIndex.from_json_dict(d)


# ---------------------------------------------------------------------------
# Signature / fingerprint
# ---------------------------------------------------------------------------
@dataclass
class Signature:
    """(provider, value) pair (IndexLogEntry.scala:363-366)."""

    provider: str
    value: str

    def to_json_dict(self) -> Dict[str, Any]:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclass
class LogicalPlanFingerprint:
    """Fingerprint of the source logical plan: kind + signatures
    (IndexLogEntry.scala:368-376)."""

    signatures: List[Signature]
    kind: str = "LogicalPlan"

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "properties": {"signatures": [s.to_json_dict() for s in self.signatures]},
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "LogicalPlanFingerprint":
        return LogicalPlanFingerprint(
            [Signature.from_json_dict(s) for s in d["properties"]["signatures"]],
            kind=d.get("kind", "LogicalPlan"),
        )


# ---------------------------------------------------------------------------
# Source relation description
# ---------------------------------------------------------------------------
@dataclass
class Update:
    """Quick-refresh delta: appended/deleted source files recorded in the
    log for query-time Hybrid Scan handling (IndexLogEntry.scala:379-388,
    RefreshQuickAction.scala:70-79)."""

    appended_files: Optional[Content] = None
    deleted_files: Optional[Content] = None

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "appendedFiles": self.appended_files.to_json_dict()
            if self.appended_files
            else None,
            "deletedFiles": self.deleted_files.to_json_dict()
            if self.deleted_files
            else None,
        }

    @staticmethod
    def from_json_dict(d: Optional[Dict[str, Any]]) -> Optional["Update"]:
        if d is None:
            return None
        return Update(
            Content.from_json_dict(d["appendedFiles"]) if d.get("appendedFiles") else None,
            Content.from_json_dict(d["deletedFiles"]) if d.get("deletedFiles") else None,
        )


@dataclass
class Relation:
    """A file-based source relation: root paths, the file tree snapshot at
    index time, schema, format, options (IndexLogEntry.scala:390-418)."""

    root_paths: List[str]
    data: Content
    schema: Dict[str, str]
    file_format: str
    options: Dict[str, str] = field(default_factory=dict)
    update: Optional[Update] = None

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "rootPaths": list(self.root_paths),
            "data": self.data.to_json_dict(),
            "schema": dict(self.schema),
            "fileFormat": self.file_format,
            "options": dict(self.options),
            "update": self.update.to_json_dict() if self.update else None,
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Relation":
        return Relation(
            list(d["rootPaths"]),
            Content.from_json_dict(d["data"]),
            dict(d["schema"]),
            d["fileFormat"],
            dict(d.get("options", {})),
            Update.from_json_dict(d.get("update")),
        )


@dataclass
class Source:
    """Source side of the entry: relations + plan fingerprint
    (IndexLogEntry.scala:420-430)."""

    relations: List[Relation]
    fingerprint: LogicalPlanFingerprint

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "plan": {
                "kind": "Source",
                "properties": {
                    "relations": [r.to_json_dict() for r in self.relations],
                    "fingerprint": self.fingerprint.to_json_dict(),
                },
            }
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Source":
        p = d["plan"]["properties"]
        return Source(
            [Relation.from_json_dict(r) for r in p["relations"]],
            LogicalPlanFingerprint.from_json_dict(p["fingerprint"]),
        )


# ---------------------------------------------------------------------------
# LogEntry base + IndexLogEntry
# ---------------------------------------------------------------------------
class LogEntry:
    """Abstract log entry with mutable id/state/timestamp/enabled
    (LogEntry.scala:22-30)."""

    def __init__(self, version: str = LOG_ENTRY_VERSION):
        self.version = version
        self.id: int = 0
        self.state: str = ""
        self.timestamp: int = 0
        self.enabled: bool = True


class IndexLogEntry(LogEntry):
    """One committed state of one index (IndexLogEntry.scala:433-603).

    Also carries the mutable *tag* scratch space used by rewrite rules to
    memoize per-(plan, tag) computations during optimization
    (IndexLogEntry.scala:560-602). Tags are never serialized.
    """

    def __init__(
        self,
        name: str,
        derived_dataset: CoveringIndex,
        content: Content,
        source: Source,
        properties: Optional[Dict[str, str]] = None,
    ):
        super().__init__()
        self.name = name
        self.derived_dataset = derived_dataset
        self.content = content
        self.source = source
        self.properties: Dict[str, str] = dict(properties or {})
        self._tags: Dict[Tuple[int, str], Any] = {}

    # -- convenience accessors ----------------------------------------------
    @property
    def indexed_columns(self) -> List[str]:
        return self.derived_dataset.indexed_columns

    @property
    def included_columns(self) -> List[str]:
        return self.derived_dataset.included_columns

    @property
    def num_buckets(self) -> int:
        return self.derived_dataset.num_buckets

    @property
    def schema(self) -> Dict[str, str]:
        return self.derived_dataset.schema

    def relations(self) -> List[Relation]:
        return self.source.relations

    @property
    def relation(self) -> Relation:
        # Reference supports exactly one relation per index
        # (CreateAction.scala:44-64 validate()).
        if len(self.source.relations) != 1:
            raise HyperspaceException(
                f"Index {self.name} has {len(self.source.relations)} relations; expected 1."
            )
        return self.source.relations[0]

    def signature(self) -> Signature:
        sigs = self.source.fingerprint.signatures
        if len(sigs) != 1:
            raise HyperspaceException("Expected exactly one signature.")
        return sigs[0]

    def has_lineage_column(self) -> bool:
        return self.derived_dataset.has_lineage()

    def source_files_size(self) -> int:
        return self.relation.data.total_size()

    def source_file_infos(self) -> List[FileInfo]:
        return self.relation.data.file_infos()

    def source_update(self) -> Optional[Update]:
        return self.relation.update

    def with_cleared_update(self) -> None:
        self.relation.update = None

    def copy_with_update(
        self,
        fingerprint: LogicalPlanFingerprint,
        appended: Optional[Content],
        deleted: Optional[Content],
    ) -> "IndexLogEntry":
        """Quick-refresh copy recording the source delta
        (IndexLogEntry.scala:483-505)."""
        rel = self.relation
        new_rel = Relation(
            list(rel.root_paths),
            rel.data,
            dict(rel.schema),
            rel.file_format,
            dict(rel.options),
            Update(appended, deleted),
        )
        entry = IndexLogEntry(
            self.name,
            self.derived_dataset,
            self.content,
            Source([new_rel], fingerprint),
            dict(self.properties),
        )
        return entry

    # -- tag system (IndexLogEntry.scala:560-602) ----------------------------
    # Values are stored as (plan, value): keeping a strong reference to the
    # plan pins it so CPython id() reuse cannot alias a dead plan's memo to
    # a new object (the reference keys a Map by the plan object itself).
    def set_tag_value(self, plan: Any, tag: str, value: Any) -> None:
        self._tags[(id(plan), tag)] = (plan, value)

    def get_tag_value(self, plan: Any, tag: str) -> Any:
        hit = self._tags.get((id(plan), tag))
        return hit[1] if hit is not None else None

    def unset_tag_value(self, plan: Any, tag: str) -> None:
        self._tags.pop((id(plan), tag), None)

    def with_cached_tag(self, plan: Any, tag: str, compute) -> Any:
        key = (id(plan), tag)
        if key not in self._tags:
            self._tags[key] = (plan, compute())
        return self._tags[key][1]

    # -- serde ---------------------------------------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "id": self.id,
            "state": self.state,
            "timestamp": self.timestamp,
            "enabled": self.enabled,
            "name": self.name,
            "derivedDataset": self.derived_dataset.to_json_dict(),
            "content": self.content.to_json_dict(),
            "source": self.source.to_json_dict(),
            "properties": dict(self.properties),
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "IndexLogEntry":
        # Version dispatch mirrors LogEntry.fromJson (LogEntry.scala:33-46).
        version = d.get("version", LOG_ENTRY_VERSION)
        if version != LOG_ENTRY_VERSION:
            raise HyperspaceException(f"Unsupported log entry version: {version}")
        e = IndexLogEntry(
            d["name"],
            derived_dataset_from_json_dict(d["derivedDataset"]),
            Content.from_json_dict(d["content"]),
            Source.from_json_dict(d["source"]),
            dict(d.get("properties", {})),
        )
        e.id = d["id"]
        e.state = d["state"]
        e.timestamp = d["timestamp"]
        e.enabled = d.get("enabled", True)
        return e
