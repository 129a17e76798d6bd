"""Versioned-lake source: a transaction-logged parquet table with time
travel — the framework's analog of the reference's Delta Lake support.

Parity: ``hyperspace_tpu.sources.versioned_lake`` (DeltaLakeFileBasedSource.
scala). Its files are parquet, so it needs ``pyarrow``, imported only on
its reads and writes:

* ``create_relation`` pins the resolved table version into the relation's
  options as ``versionAsOf`` (:55-97), so index metadata records exactly
  which snapshot was indexed;
* ``refresh_relation`` drops the pin and re-snapshots at latest (:106-112);
* the physical file format is parquet regardless of the logical format
  (``internalFileFormatName``, :120-126).

The table format itself is owned here (no external engine): a
``_vlt_log/`` directory of JSON commits, one per version, committed with
the same atomic-create OCC primitive as the index operation log — two
concurrent writers race for the next version file and one loses
(IndexLogManager.scala:149-165 applies the identical protocol).
"""

from __future__ import annotations

import json
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..exceptions import ConcurrentModificationException, HyperspaceException
from ..index.log_entry import FileIdTracker, FileInfo, Relation
from ..utils import file_utils
from .interfaces import FileBasedSourceProvider
from .relation import FileRelation

VLT_FORMAT = "vlt"
VLT_LOG_DIR = "_vlt_log"
VERSION_AS_OF = "versionAsOf"


def _parse_version(value) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        raise HyperspaceException(
            f"Invalid {VERSION_AS_OF} value: {value!r} (expected an integer)."
        )


class VersionedLakeTable:
    """A directory of parquet files whose membership is defined by a JSON
    transaction log (the data-lake-table half of the Delta analogy)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.log_dir = self.path / VLT_LOG_DIR

    # -- log protocol --------------------------------------------------------
    @staticmethod
    def create(path: str | Path) -> "VersionedLakeTable":
        t = VersionedLakeTable(path)
        t.path.mkdir(parents=True, exist_ok=True)
        t.log_dir.mkdir(parents=True, exist_ok=True)
        if t.latest_version() is None:
            t._commit(0, [], [])
        return t

    def _commit_path(self, version: int) -> Path:
        return self.log_dir / f"{version:08d}.json"

    def latest_version(self) -> Optional[int]:
        if not self.log_dir.is_dir():
            return None
        versions = [
            int(p.stem) for p in self.log_dir.iterdir() if p.stem.isdigit()
        ]
        return max(versions) if versions else None

    def _commit(self, version: int, adds: List[Dict], removes: List[str]) -> None:
        entry = {
            "version": version,
            "timestamp": int(time.time() * 1000),
            "add": adds,
            "remove": removes,
        }
        # atomic-create = OCC commit point: losing a version race raises
        if not file_utils.atomic_create(
            self._commit_path(version), json.dumps(entry, indent=2)
        ):
            raise ConcurrentModificationException(
                f"Version {version} of {self.path} was committed concurrently."
            )

    def commit(self, adds: List[Dict], removes: List[str]) -> int:
        latest = self.latest_version()
        version = 0 if latest is None else latest + 1
        self._commit(version, adds, removes)
        return version

    # -- write API -----------------------------------------------------------
    def write(self, batch) -> int:
        """Append one parquet data file holding ``batch``; returns the new
        table version."""
        from ..storage import parquet_io

        name = f"part-{uuid.uuid4().hex[:12]}.parquet"
        p = self.path / name
        parquet_io.write_parquet(p, batch)
        st = p.stat()
        return self.commit(
            [{"path": name, "size": st.st_size, "mtime": st.st_mtime_ns // 1_000_000}],
            [],
        )

    def remove_files(self, names: List[str]) -> int:
        """Commit removal of data files from the table (files stay on disk;
        the log is the source of truth, as with Delta tombstones)."""
        current = {f["path"] for f in self._replay(self.latest_version())}
        unknown = [n for n in names if n not in current]
        if unknown:
            raise HyperspaceException(
                f"Cannot remove files not in the table: {unknown}."
            )
        return self.commit([], list(names))

    # -- snapshots -----------------------------------------------------------
    def _replay(self, version: Optional[int]) -> List[Dict]:
        """Active add-entries at ``version`` (defaults to latest)."""
        latest = self.latest_version()
        if latest is None:
            raise HyperspaceException(f"Not a versioned-lake table: {self.path}.")
        v = latest if version is None else int(version)
        if v > latest or v < 0:
            raise HyperspaceException(
                f"Version {v} does not exist for table {self.path} "
                f"(latest is {latest})."
            )
        active: Dict[str, Dict] = {}
        for k in range(v + 1):
            cp = self._commit_path(k)
            if not cp.exists():
                continue
            entry = json.loads(cp.read_text())
            for add in entry.get("add", []):
                active[add["path"]] = add
            for rem in entry.get("remove", []):
                active.pop(rem, None)
        return sorted(active.values(), key=lambda a: a["path"])

    def snapshot(self, version: Optional[int] = None) -> List[FileInfo]:
        # Transient ids from a fresh tracker, as DefaultFileBasedSource's
        # snapshot does — lineage-stable ids come from the *seeded* tracker
        # each action builds from its logged entry.
        tracker = FileIdTracker()
        return [
            FileInfo(
                str(self.path / a["path"]),
                int(a["size"]),
                int(a["mtime"]),
                tracker.add_file(str(self.path / a["path"]), int(a["size"]), int(a["mtime"])),
            )
            for a in self._replay(version)
        ]

    def is_vlt_table(self) -> bool:
        return self.latest_version() is not None


class VersionedLakeSource(FileBasedSourceProvider):
    """Source provider for ``vlt`` tables (DeltaLakeFileBasedSource
    analog)."""

    def supports_format(self, file_format: str) -> bool:
        return file_format.lower() == VLT_FORMAT

    def create_relation(
        self,
        root_paths: List[str],
        file_format: str,
        options: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
    ) -> Optional[FileRelation]:
        if not self.supports_format(file_format):
            return None
        if len(root_paths) != 1:
            raise HyperspaceException(
                "A versioned-lake relation has exactly one table root; got "
                f"{root_paths}."
            )
        table = VersionedLakeTable(root_paths[0])
        opts = dict(options or {})
        # resolve + pin the version (DeltaLakeFileBasedSource.scala:83-84)
        version = (
            _parse_version(opts[VERSION_AS_OF])
            if VERSION_AS_OF in opts
            else table.latest_version()
        )
        if version is None:
            raise HyperspaceException(
                f"Not a versioned-lake table: {root_paths[0]}."
            )
        files = table.snapshot(version)
        opts[VERSION_AS_OF] = str(version)
        if schema is None:
            if not files:
                raise HyperspaceException(
                    f"Cannot infer schema: table {root_paths[0]} is empty at "
                    f"version {version}."
                )
            from .default import _infer_schema

            schema = _infer_schema("parquet", files[0].name)
        return FileRelation(
            root_paths=[str(Path(root_paths[0]).absolute())],
            file_format=VLT_FORMAT,
            schema=schema,
            files=files,
            options=opts,
            internal_format="parquet",
        )

    def refresh_relation(self, relation: Relation) -> Optional[FileRelation]:
        """Drop the version pin and re-snapshot at latest
        (DeltaLakeFileBasedSource.scala:106-112)."""
        if not self.supports_format(relation.file_format):
            return None
        opts = {k: v for k, v in relation.options.items() if k != VERSION_AS_OF}
        return self.create_relation(
            list(relation.root_paths), VLT_FORMAT, opts, dict(relation.schema)
        )

    def all_files(self, relation: FileRelation) -> Optional[List[FileInfo]]:
        """Files at the relation's pinned version — a pinned snapshot is
        immutable, so no re-listing is needed."""
        if not self.supports_format(relation.file_format):
            return None
        version = relation.options.get(VERSION_AS_OF)
        table = VersionedLakeTable(relation.root_paths[0])
        return table.snapshot(None if version is None else _parse_version(version))

    def lineage_pairs(
        self, relation: FileRelation, tracker: FileIdTracker
    ) -> Optional[List[Tuple[str, int]]]:
        if not self.supports_format(relation.file_format):
            return None
        out = []
        for f in relation.files:
            fid = tracker.add_file(f.name, f.size, f.modified_time)
            out.append((f.name, fid))
        return out
