"""Create action for data-skipping (sketch) indexes.

The covering-index actions materialize a bucketed data copy; a skipping
index instead writes one ``sketches.json`` per version directory mapping
every source file to its per-column sketches (index/sketches.py). The
Action begin/op/end protocol, versioned data dirs, and signature
fingerprinting are shared with the covering path (Action.scala:34-104,
CreateActionBase.scala:50-95). Parity: ``hyperspace_tpu.actions.
create_skipping`` (create, and refresh full or incremental).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from ..exceptions import HyperspaceException, NoChangesException
from ..index.data_manager import IndexDataManager
from ..index.index_config import DataSkippingIndexConfig
from ..index.log_entry import (
    Content,
    DataSkippingIndex,
    Directory,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
)
from ..index.log_manager import IndexLogManager
from ..index.signatures import create_signature_provider
from ..index.sketches import (
    SKETCH_FILE_NAME,
    SketchSpec,
    load_sketch_table,
    sketch_from_json_dict,
    sketch_key,
)
from ..plan.ir import Scan
from ..sources.relation import FileRelation
from ..storage import parquet_io
from ..telemetry import CreateActionEvent, RefreshActionEvent
from ..utils import resolver
from . import states
from .base import Action, MaintenanceActionBase
from .create import CreateActionBase


def build_sketch_table(
    relation: FileRelation,
    sketches: List[SketchSpec],
    files: Optional[List[FileInfo]] = None,
) -> Dict[str, Dict[str, Dict]]:
    """{file path: {sketch key: sketch data}} for ``files`` (default: the
    relation's snapshot). One columnar read per file, only the sketched
    columns."""
    cols = list(dict.fromkeys(s.column for s in sketches))
    table: Dict[str, Dict[str, Dict]] = {}
    for f in files if files is not None else relation.files:
        batch = parquet_io.read_relation(relation, paths=[f.name], columns=cols)
        per_file: Dict[str, Dict] = {}
        for spec in sketches:
            per_file[sketch_key(spec.to_json_dict())] = spec.build(
                batch.columns[spec.column]
            )
        table[f.name] = per_file
    return table


def _resolve_sketch_columns(
    relation: FileRelation, sketches: List[SketchSpec]
) -> List[SketchSpec]:
    """Case-insensitive column resolution against the source schema
    (CreateActionBase.resolveConfig semantics)."""
    import dataclasses

    out: List[SketchSpec] = []
    schema_cols = relation.column_names
    for s in sketches:
        resolved = resolver.resolve(s.column, schema_cols)
        if resolved is None:
            raise HyperspaceException(
                f"Sketch column {s.column!r} could not be resolved against "
                f"source schema {schema_cols}."
            )
        out.append(dataclasses.replace(s, column=resolved))
    return out


class SkippingActionBase:
    """Shared sketch build + log-entry assembly."""

    def write_sketches(
        self,
        sketches: List[SketchSpec],
        version_dir: Path,
        table: Dict[str, Dict[str, Dict]],
    ) -> Path:
        version_dir.mkdir(parents=True, exist_ok=True)
        p = version_dir / SKETCH_FILE_NAME
        p.write_text(
            json.dumps(
                {
                    "sketches": [s.to_json_dict() for s in sketches],
                    "files": table,
                },
                indent=2,
            ),
            encoding="utf-8",
        )
        return p

    def build_skipping_entry(
        self,
        name: str,
        relation: FileRelation,
        plan,
        sketches: List[SketchSpec],
        sketch_file: Optional[Path],
        conf,
    ) -> IndexLogEntry:
        provider = create_signature_provider(conf.signature_provider())
        sig = provider.signature(plan)
        if sig is None:
            raise HyperspaceException("Cannot fingerprint the source plan.")
        if sketch_file is not None:
            tracker = FileIdTracker()
            content = Content.from_leaf_files([str(sketch_file)], tracker)
        else:
            content = Content(Directory("/"))
        schema = {s.column: relation.schema[s.column] for s in sketches}
        src_root = CreateActionBase.source_content(relation, FileIdTracker())
        return IndexLogEntry(
            name,
            DataSkippingIndex([s.to_json_dict() for s in sketches], schema),
            content,
            Source(
                [
                    Relation(
                        list(relation.root_paths),
                        src_root,
                        dict(relation.schema),
                        relation.file_format,
                        dict(relation.options),
                    )
                ],
                LogicalPlanFingerprint([Signature(provider.name, sig)]),
            ),
        )


class DataSkippingCreateAction(Action, CreateActionBase, SkippingActionBase):
    transient_state = states.CREATING
    final_state = states.ACTIVE

    def __init__(
        self,
        session,
        df,
        config: DataSkippingIndexConfig,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
    ):
        Action.__init__(self, log_manager)
        CreateActionBase.__init__(self, session)
        self.df = df
        self.config = config
        self.data_manager = data_manager
        self._entry: Optional[IndexLogEntry] = None

    @property
    def relation(self) -> FileRelation:
        scans = self.df.plan.collect(lambda n: isinstance(n, Scan))
        if len(scans) != 1:
            raise HyperspaceException(
                "Only creating an index over a single file-based relation is "
                "supported (CreateAction.scala:44-56)."
            )
        return scans[0].relation

    def validate(self) -> None:
        _resolve_sketch_columns(self.relation, self.config.sketches)
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != states.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.config.index_name} already exists."
            )

    def op(self) -> None:
        rel = self.relation
        sketches = _resolve_sketch_columns(rel, self.config.sketches)
        table = build_sketch_table(rel, sketches)
        sketch_file = self.write_sketches(
            sketches, self.data_manager.get_path(0), table
        )
        # Fingerprint the bare relation Scan — the rules re-derive it from
        # the query's scan node, never from the creating DataFrame's full
        # plan (same contract as the covering CreateAction).
        self._entry = self.build_skipping_entry(
            self.config.index_name, rel, Scan(rel), sketches, sketch_file, self.conf
        )

    def log_entry(self) -> LogEntry:
        if self._entry is not None:
            return self._entry
        rel = self.relation
        sketches = _resolve_sketch_columns(rel, self.config.sketches)
        return self.build_skipping_entry(
            self.config.index_name, rel, Scan(rel), sketches, None, self.conf
        )

    def event(self, message: str):
        return CreateActionEvent(
            index=self.config.index_name, state=self.final_state, message=message
        )


class DataSkippingRefreshAction(
    Action, CreateActionBase, SkippingActionBase, MaintenanceActionBase
):
    """Refresh for sketch indexes. ``full`` resketches every current file;
    ``incremental`` carries unchanged files' sketches over and sketches
    only appended files (deleted files simply drop out of the table)."""

    transient_state = states.REFRESHING
    final_state = states.ACTIVE

    def __init__(
        self,
        session,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        incremental: bool,
    ):
        Action.__init__(self, log_manager)
        CreateActionBase.__init__(self, session)
        self.data_manager = data_manager
        self.incremental = incremental
        self._previous: Optional[IndexLogEntry] = None
        self._relation: Optional[FileRelation] = None
        self._entry: Optional[IndexLogEntry] = None

    @property
    def relation(self) -> FileRelation:
        if self._relation is None:
            self._relation = self.session.sources.refresh_relation(
                self.previous_entry.relation
            )
        return self._relation

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceException(
                "Refresh is only supported in ACTIVE state; current is "
                f"{self.previous_entry.state}."
            )
        if set(self.relation.files) == set(self.previous_entry.source_file_infos()):
            raise NoChangesException("Source data did not change; refresh is a no-op.")

    def op(self) -> None:
        prev = self.previous_entry
        rel = self.relation
        sketches = [sketch_from_json_dict(s) for s in prev.derived_dataset.sketches]
        if self.incremental:
            old = load_sketch_table(prev.content.files()) or {}
            # diff on full FileInfo identity (name, size, mtime): a file
            # modified in place is re-sketched, as the covering refresh
            # treats it as deleted + appended (RefreshActionBase.scala:112-147)
            logged = set(prev.source_file_infos())
            current = list(rel.files)
            changed = [f for f in current if f not in logged]
            table = {
                f.name: old[f.name]
                for f in current
                if f in logged and f.name in old
            }
            table.update(build_sketch_table(rel, sketches, changed))
        else:
            table = build_sketch_table(rel, sketches)
        sketch_file = self.write_sketches(
            sketches, self.next_version_dir(), table
        )
        self._entry = self.build_skipping_entry(
            prev.name, rel, Scan(rel), sketches, sketch_file, self.conf
        )

    def log_entry(self) -> LogEntry:
        return self._entry if self._entry is not None else self.previous_entry

    def event(self, message: str):
        return RefreshActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )
