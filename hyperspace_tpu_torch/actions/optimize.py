"""OptimizeAction: bucket-wise compaction of small index files.

Parity: ``hyperspace_tpu.actions.optimize`` (OptimizeAction.scala).
Incremental refreshes append one file per bucket per refresh; optimize
merges each bucket's small files into one, writing a new version dir.
``quick`` mode compacts only files under the size threshold (256 MB
default); ``full`` compacts every bucket with more than one file.
Single-file buckets are skipped (:126-131); untouched files carry over
into the new Content (:135-155). Multi-bucket run files (the streaming
build's finalizeMode=runs) are always compacted, whatever their size or
the mode. The merge is host numpy, as in the reference, spread over the
build pipeline's merge pool.
"""

from __future__ import annotations

from typing import List, Optional

from .. import constants as C
from ..exceptions import HyperspaceException, NoChangesException
from ..index.data_manager import IndexDataManager
from ..index.log_entry import Content, FileIdTracker, IndexLogEntry, LogEntry
from ..index.log_manager import IndexLogManager
from ..telemetry import OptimizeActionEvent
from . import states
from .base import Action, MaintenanceActionBase
from .create import CreateActionBase, _content_from_file_infos

# host bytes of run-segment rows one compaction group may materialize at
# once (the group's coalesced segment map): the host-memory peak of
# optimize over run files
_GROUP_READ_BUDGET_BYTES = 1 << 30


class OptimizeAction(Action, CreateActionBase, MaintenanceActionBase):
    transient_state = states.OPTIMIZING
    final_state = states.ACTIVE

    def __init__(
        self,
        session,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        mode: str = C.OPTIMIZE_MODE_QUICK,
    ):
        Action.__init__(self, log_manager)
        CreateActionBase.__init__(self, session)
        self.data_manager = data_manager
        self.mode = mode.lower()
        self._previous: Optional[IndexLogEntry] = None
        self._entry: Optional[IndexLogEntry] = None
        self._partition = None

    def _partition_files(self):
        """(files to optimize, run files, run buckets, untouched files) by
        bucket and threshold (OptimizeAction.scala:115-133), cached so
        validate() and op() share one content-tree walk."""
        if self._partition is None:
            from ..index.compactor import partition_compactable

            self._partition = partition_compactable(
                self.previous_entry.content.file_infos(),
                self.conf.optimize_file_size_threshold(),
                quick=self.mode == C.OPTIMIZE_MODE_QUICK,
            )
        return self._partition

    def validate(self) -> None:
        if self.mode not in C.OPTIMIZE_MODES:
            raise HyperspaceException(
                f"Unsupported optimize mode {self.mode!r}; supported modes "
                f"are {C.OPTIMIZE_MODES}."
            )
        if self.previous_entry.state != states.ACTIVE:
            raise HyperspaceException(
                "Optimize is only supported in ACTIVE state."
            )
        to_optimize, run_files, _, _ = self._partition_files()
        if not to_optimize and not run_files:
            raise NoChangesException(
                "No index files eligible for compaction "
                f"(mode={self.mode})."
            )

    def op(self) -> None:
        from ..index.compactor import compact_bucket_group

        prev = self.previous_entry
        to_optimize, run_files, run_buckets, untouched = self._partition_files()
        version_dir = self.next_version_dir()
        indexed = list(prev.indexed_columns)
        new_paths: List[str] = []
        run_paths = [fi.name for fi in run_files]
        small = {b: [f.name for f in fis] for b, fis in to_optimize.items()}
        all_buckets = sorted(set(to_optimize) | run_buckets)
        pipe = self.conf.build_pipeline()
        workers = pipe.merge_workers if pipe.enabled else 1
        # buckets go in groups sized by a read-bytes budget over the logged
        # run sizes: a group's segment map holds its buckets' run rows at
        # once, while every group pays one sweep per run file
        run_bytes = sum(fi.size for fi in run_files)
        est_bucket_bytes = max(run_bytes // max(len(run_buckets), 1), 1)
        group = int(
            min(
                max(workers, _GROUP_READ_BUDGET_BYTES // est_bucket_bytes),
                max(len(all_buckets), 1),
            )
        )
        for i in range(0, len(all_buckets), group):
            merged = compact_bucket_group(
                all_buckets[i : i + group],
                small,
                run_paths,
                version_dir,
                indexed,
                workers,
            )
            new_paths.extend(p for p in merged.values() if p is not None)

        new_content = Content.from_leaf_files(new_paths, FileIdTracker())
        entry = IndexLogEntry(
            prev.name,
            prev.derived_dataset,
            new_content,
            prev.source,
            dict(prev.properties),
        )
        if untouched:
            entry.content = entry.content.merge(_content_from_file_infos(untouched))
        self._entry = entry

    def log_entry(self) -> LogEntry:
        return self._entry if self._entry is not None else self.previous_entry

    def event(self, message: str):
        return OptimizeActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )
