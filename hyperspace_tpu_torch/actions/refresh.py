"""The refresh family: full rebuild, incremental, and quick (metadata-only).

Parity: ``hyperspace_tpu.actions.refresh``:
  RefreshActionBase.scala:57-147 — source reconstruction from the logged
    Relation via the provider, appended/deleted set-diff, inherited
    numBuckets/lineage;
  RefreshAction.scala:41-53 — full rebuild, no-op when unchanged;
  RefreshIncrementalAction.scala:58-144 — index only appended files; on
    deletes rewrite the index dropping lineage ids; merge Content trees;
  RefreshQuickAction.scala:37-79 — metadata-only copyWithUpdate delta for
    query-time Hybrid Scan.
The builds run on the session's device, as create's does.
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from .. import constants as C
from ..exceptions import HyperspaceException, NoChangesException
from ..index.data_manager import IndexDataManager
from ..index.index_config import IndexConfig
from ..index.log_entry import (
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogEntry,
    LogicalPlanFingerprint,
    Signature,
)
from ..index.log_manager import IndexLogManager
from ..index.signatures import create_signature_provider
from ..plan.ir import Scan
from ..sources.relation import FileRelation
from ..storage import layout
from ..telemetry import (
    RefreshActionEvent,
    RefreshIncrementalActionEvent,
    RefreshQuickActionEvent,
)
from . import states
from .base import Action, MaintenanceActionBase
from .create import CreateActionBase, _content_from_file_infos


class RefreshActionBase(Action, CreateActionBase, MaintenanceActionBase):
    transient_state = states.REFRESHING
    final_state = states.ACTIVE

    def __init__(
        self,
        session,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
    ):
        Action.__init__(self, log_manager)
        CreateActionBase.__init__(self, session)
        self.data_manager = data_manager
        self._previous: Optional[IndexLogEntry] = None
        self._relation: Optional[FileRelation] = None
        self._entry: Optional[IndexLogEntry] = None

    @property
    def index_config(self) -> IndexConfig:
        prev = self.previous_entry
        return IndexConfig(prev.name, prev.indexed_columns, prev.included_columns)

    @property
    def num_buckets(self) -> int:
        # inherited from the previous version (RefreshActionBase.scala:57-65)
        return self.previous_entry.num_buckets

    @property
    def lineage(self) -> bool:
        return self.previous_entry.has_lineage_column()

    # -- current source snapshot (RefreshActionBase.scala:68-86) -------------
    @property
    def relation(self) -> FileRelation:
        if self._relation is None:
            self._relation = self.session.sources.refresh_relation(
                self.previous_entry.relation
            )
        return self._relation

    # -- set-diff (RefreshActionBase.scala:112-147) --------------------------
    @property
    def current_files(self) -> Set[FileInfo]:
        return set(self.relation.files)

    @property
    def logged_files(self) -> Set[FileInfo]:
        return set(self.previous_entry.source_file_infos())

    @property
    def appended_files(self) -> List[FileInfo]:
        return sorted(self.current_files - self.logged_files, key=lambda f: f.name)

    @property
    def deleted_files(self) -> List[FileInfo]:
        return sorted(self.logged_files - self.current_files, key=lambda f: f.name)

    def validate(self) -> None:
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceException(
                f"Refresh is only supported in ACTIVE state; current is "
                f"{self.previous_entry.state}."
            )
        if not self.appended_files and not self.deleted_files:
            raise NoChangesException("Source data did not change; refresh is a no-op.")

    def _seeded_tracker(self) -> FileIdTracker:
        """Tracker seeded with the previous snapshot's ids, so existing
        files keep their lineage ids across refreshes."""
        tracker = FileIdTracker()
        for fi in self.previous_entry.source_file_infos():
            tracker.add_file_info(fi)
        return tracker

    def _fingerprint(self) -> LogicalPlanFingerprint:
        provider = create_signature_provider(self.conf.signature_provider())
        sig = provider.signature(Scan(self.relation))
        return LogicalPlanFingerprint([Signature(provider.name, sig)])

    def log_entry(self) -> LogEntry:
        return self._entry if self._entry is not None else self.previous_entry


class RefreshAction(RefreshActionBase):
    """Full rebuild from the current snapshot (RefreshAction.scala:41-53)."""

    def op(self) -> None:
        rel = self.relation
        tracker = self._seeded_tracker()
        files = self.write(
            rel,
            self.index_config,
            self.next_version_dir(),
            self.num_buckets,
            self.lineage,
            tracker,
        )
        indexed, included = self.resolved_columns(rel, self.index_config)
        self._entry = self.build_log_entry(
            self.previous_entry.name,
            rel,
            Scan(rel),
            indexed,
            included,
            self.num_buckets,
            self.lineage,
            files,
            tracker,
        )

    def event(self, message: str):
        return RefreshActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )


class RefreshIncrementalAction(RefreshActionBase):
    """(RefreshIncrementalAction.scala:58-144)."""

    def validate(self) -> None:
        super().validate()
        if self.deleted_files and not self.lineage:
            raise HyperspaceException(
                "Index refresh to handle deleted source files requires lineage "
                "(RefreshIncrementalAction.scala:110-114)."
            )

    def op(self) -> None:
        prev = self.previous_entry
        version_dir = self.next_version_dir()
        tracker = self._seeded_tracker()
        deleted_ids = {
            tracker.get_file_id(f.name, f.size, f.modified_time)
            for f in self.deleted_files
        }
        new_files: List = []
        indexed, included = self.resolved_columns(self.relation, self.index_config)

        if self.appended_files:
            # index only the appended files (:58-71), a fresh bucketed write
            appended_rel = FileRelation(
                self.relation.root_paths,
                self.relation.file_format,
                self.relation.schema,
                self.appended_files,
                self.relation.options,
                internal_format=self.relation.internal_format,
                partition_spec=self.relation.partition_spec,
            )
            new_files.extend(
                self.write(
                    appended_rel,
                    self.index_config,
                    version_dir,
                    self.num_buckets,
                    self.lineage,
                    tracker,
                )
            )

        if self.deleted_files:
            # rewrite existing data without the deleted lineage ids (:73-95);
            # filtering file by file keeps each file's bucket and order. A
            # multi-bucket run file is read through the segment planner and
            # rewritten as a run file: the keep mask keeps row order, so only
            # its bucketCounts shrink
            del_arr = np.array(sorted(deleted_ids), dtype=np.int64)
            for i, f in enumerate(prev.content.files()):
                run = layout.is_run_file(f)
                batch = layout.read_run_coalesced(f) if run else layout.read_batch(f)
                ids = batch.columns[C.DATA_FILE_NAME_ID].data
                keep = ~np.isin(ids, del_arr)
                kept = batch.take(np.flatnonzero(keep))
                if kept.num_rows == 0:
                    continue
                if run:
                    offs = layout.run_offsets_checked(f)
                    counts = [
                        int(keep[int(offs[b]) : int(offs[b + 1])].sum())
                        for b in range(len(offs) - 1)
                    ]
                    # the source run's other footer extras (the index-level
                    # metadata the build puts in every run) carry over
                    extra = {
                        k: v
                        for k, v in layout.cached_reader(f).footer.get("extra", {}).items()
                        if k != "bucketCounts"
                    }
                    p = version_dir / layout.run_file_name(i)
                    layout.write_batch(
                        p, kept, sorted_by=indexed, extra={**extra, "bucketCounts": counts}
                    )
                else:
                    b = layout.bucket_of_file(f)
                    p = version_dir / layout.bucket_file_name(b)
                    layout.write_batch(p, kept, sorted_by=indexed, bucket=b)
                new_files.append(p)

        self._entry = self.build_log_entry(
            prev.name,
            self.relation,
            Scan(self.relation),
            indexed,
            included,
            self.num_buckets,
            self.lineage,
            new_files,
            tracker,
        )
        if not self.deleted_files:
            # appended only: the new content merges with the previous tree
            # (:129-144)
            self._entry.content = prev.content.merge(self._entry.content)

    def event(self, message: str):
        return RefreshIncrementalActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )


class RefreshQuickAction(RefreshActionBase):
    """Metadata-only refresh (RefreshQuickAction.scala:37-79): record the
    appended/deleted delta in the log for query-time Hybrid Scan: the
    rules serve such an entry through the hybrid transformation even with
    hybrid scan off (plan/rules/rule_utils.py)."""

    def validate(self) -> None:
        super().validate()
        if self.deleted_files and not self.lineage:
            raise HyperspaceException(
                "Quick refresh with deleted files requires lineage."
            )

    def op(self) -> None:
        prev = self.previous_entry
        appended = (
            _content_from_file_infos(self.appended_files)
            if self.appended_files
            else None
        )
        deleted = (
            _content_from_file_infos(self.deleted_files)
            if self.deleted_files
            else None
        )
        self._entry = prev.copy_with_update(self._fingerprint(), appended, deleted)

    def event(self, message: str):
        return RefreshQuickActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )
