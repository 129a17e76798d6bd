"""CreateAction: build a covering index from a DataFrame.

Parity: com/microsoft/hyperspace/actions/CreateActionBase.scala and
CreateAction.scala, as ``hyperspace_tpu.actions.create`` carries them.
The build engine is index.builder.write_index_data (torch on the session's
device), or index.stream_builder for a source over the streaming
threshold; this module supplies the metadata, lineage and protocol glue:

  * resolveConfig — case-insensitive column resolution;
  * prepareIndexDataFrame — project + optional lineage column;
  * getIndexLogEntry — signature, source snapshot, schema;
  * CreateAction.validate — single file-based relation, resolvable
    schema, no live index under the same name.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .. import constants as C
from ..config import HyperspaceConf
from ..exceptions import HyperspaceException
from ..index.builder import resolve_index_columns, write_index_data
from ..index.data_manager import IndexDataManager
from ..index.index_config import IndexConfig
from ..index.log_entry import (
    Content,
    CoveringIndex,
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
from ..plan.ir import Scan
from ..sources.relation import FileRelation
from ..storage import parquet_io
from ..storage.columnar import Column, ColumnarBatch
from ..telemetry import CreateActionEvent
from . import states
from .base import Action


class CreateActionBase:
    """Shared by create and the refresh family."""

    def __init__(self, session, conf: Optional[HyperspaceConf] = None):
        self.session = session
        self.conf = conf or session.conf

    @staticmethod
    def source_content(relation: FileRelation, tracker: FileIdTracker) -> Content:
        """The logged source-file tree. Ids MUST be the lineage tracker's
        ids, not the snapshot's transient ids: Hybrid Scan's delete filter
        resolves deleted files to ids through this tree, and index rows
        carry the tracker's ids (IndexLogEntry.scala:617-686)."""
        return _content_from_file_infos(
            [
                FileInfo(
                    f.name,
                    f.size,
                    f.modified_time,
                    tracker.add_file(f.name, f.size, f.modified_time),
                )
                for f in relation.files
            ]
        )

    # -- column resolution (CreateActionBase.scala:142-162) ------------------
    def resolved_columns(
        self, relation: FileRelation, config: IndexConfig
    ) -> Tuple[List[str], List[str]]:
        return resolve_index_columns(
            relation.column_names, config.indexed_columns, config.included_columns
        )

    # -- data preparation (CreateActionBase.scala:164-208) -------------------
    def prepare_index_batch(
        self,
        relation: FileRelation,
        indexed: List[str],
        included: List[str],
        lineage: bool,
        tracker: FileIdTracker,
    ) -> ColumnarBatch:
        cols = list(indexed) + list(included)
        if not lineage:
            return parquet_io.read_relation(relation, columns=cols)
        pairs = self.session.sources.lineage_pairs(relation, tracker)
        parts = []
        for path, fid in pairs:
            part = parquet_io.read_relation(relation, paths=[path], columns=cols)
            part = part.with_column(
                C.DATA_FILE_NAME_ID,
                Column("int64", np.full(part.num_rows, fid, dtype=np.int64)),
            )
            parts.append(part)
        return ColumnarBatch.concat(parts)

    # -- streamed data preparation (out-of-core path) ------------------------
    def prepare_index_chunks(
        self,
        relation: FileRelation,
        indexed: List[str],
        included: List[str],
        lineage: bool,
        tracker: FileIdTracker,
        chunk_rows: int,
    ):
        """Generator twin of prepare_index_batch: yields chunks of at most
        ``chunk_rows`` rows so the build never materializes the source.
        Lineage stays per file (each file's rows get its id); chunks never
        span files."""
        cols = list(indexed) + list(included)
        if not lineage:
            for f in relation.files:
                yield from parquet_io.iter_relation_file_batches(
                    relation, f.name, columns=cols, chunk_rows=chunk_rows
                )
            return
        pairs = self.session.sources.lineage_pairs(relation, tracker)
        for path, fid in pairs:
            for chunk in parquet_io.iter_relation_file_batches(
                relation, path, columns=cols, chunk_rows=chunk_rows
            ):
                yield chunk.with_column(
                    C.DATA_FILE_NAME_ID,
                    Column("int64", np.full(chunk.num_rows, fid, dtype=np.int64)),
                )

    def prepare_index_chunk_tasks(
        self,
        relation: FileRelation,
        indexed: List[str],
        included: List[str],
        lineage: bool,
        tracker: FileIdTracker,
        chunk_rows: int,
    ):
        """Parallel-ingest twin of prepare_index_chunks: zero-arg decode
        tasks (each returning a list of chunks) the pipelined build spreads
        over its ingest workers IN ORDER — the same rows in the same order,
        the same bytes. None for shapes the task split cannot express
        (partitioned relations; formats other than parquet, which alone has
        row-group random access): the caller then ingests serially."""
        if relation.partition_spec is not None:
            return None
        if relation.read_format != "parquet":
            return None
        cols = list(indexed) + list(included)
        pairs = (
            self.session.sources.lineage_pairs(relation, tracker)
            if lineage
            else [(f.name, None) for f in relation.files]
        )
        tasks = []
        for path, fid in pairs:
            for t in parquet_io.file_chunk_tasks(
                "parquet", path, columns=cols, chunk_rows=chunk_rows
            ):
                if fid is None:
                    tasks.append(t)
                else:

                    def with_lineage(t=t, fid=fid):
                        return [
                            chunk.with_column(
                                C.DATA_FILE_NAME_ID,
                                Column(
                                    "int64",
                                    np.full(chunk.num_rows, fid, dtype=np.int64),
                                ),
                            )
                            for chunk in t()
                        ]

                    tasks.append(with_lineage)
        return tasks

    def _streaming_build(self, relation: FileRelation) -> bool:
        """Build-mode policy: 'streaming' forces the out-of-core path,
        'inmemory' the materialized one, 'auto' streams when the source's
        bytes exceed the threshold."""
        mode = self.conf.build_mode()
        if mode == C.BUILD_MODE_STREAMING:
            return True
        if mode == C.BUILD_MODE_INMEMORY:
            return False
        total = sum(f.size for f in relation.files)
        return total > self.conf.build_streaming_threshold_bytes()

    # -- build (CreateActionBase.scala:122-140) ------------------------------
    def write(
        self,
        relation: FileRelation,
        config: IndexConfig,
        version_dir: Path,
        num_buckets: int,
        lineage: bool,
        tracker: FileIdTracker,
    ) -> List[Path]:
        """Build the index data of ``relation`` into ``version_dir`` on the
        session's device: streamed when the build mode says so, in memory
        otherwise."""
        indexed, included = self.resolved_columns(relation, config)
        extra_meta = {"indexName": config.index_name}
        pipeline = self.conf.build_pipeline()
        if self._streaming_build(relation):
            from ..index.stream_builder import write_index_data_streaming

            chunk_rows = self.conf.build_chunk_rows()
            chunk_tasks = self.prepare_index_chunk_tasks(
                relation, indexed, included, lineage, tracker, chunk_rows
            )
            chunks = (
                None
                if chunk_tasks is not None
                else self.prepare_index_chunks(
                    relation, indexed, included, lineage, tracker, chunk_rows
                )
            )
            return write_index_data_streaming(
                chunks,
                indexed,
                num_buckets,
                version_dir,
                chunk_rows,
                extra_meta=extra_meta,
                engine=self.conf.build_engine(),
                finalize_mode=self.conf.build_finalize_mode(),
                chunk_tasks=chunk_tasks,
                pipeline=pipeline,
                device_build=self.conf.build_device(),
                device=self.conf.torch_device(),
            )
        batch = self.prepare_index_batch(relation, indexed, included, lineage, tracker)
        return write_index_data(
            batch,
            indexed,
            num_buckets,
            version_dir,
            extra_meta=extra_meta,
            device=self.conf.torch_device(),
            engine=self.conf.build_engine(),
            host_workers=pipeline.host_width(),
        )

    # -- metadata (CreateActionBase.scala:50-95) -----------------------------
    def build_log_entry(
        self,
        name: str,
        relation: FileRelation,
        plan,
        indexed: List[str],
        included: List[str],
        num_buckets: int,
        lineage: bool,
        index_files: List[Path],
        tracker: FileIdTracker,
    ) -> IndexLogEntry:
        provider = create_signature_provider(self.conf.signature_provider())
        sig = provider.signature(plan)
        if sig is None:
            raise HyperspaceException("Cannot fingerprint the source plan.")
        from ..index.log_entry import Directory

        content_tracker = FileIdTracker()
        content = Content.from_leaf_files([str(f) for f in index_files], content_tracker)
        if content is None:
            content = Content(Directory("/"))  # begin() entry: no data yet
        src_root = self.source_content(relation, tracker)
        schema = {c: relation.schema[c] for c in indexed + included}
        props = {}
        if lineage:
            props["lineage"] = "true"
            schema[C.DATA_FILE_NAME_ID] = "int64"
        return IndexLogEntry(
            name,
            CoveringIndex(list(indexed), list(included), schema, num_buckets, props),
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


def _content_from_file_infos(files) -> Content:
    """Build a Content tree from FileInfos with full-path names (no disk
    stat — the snapshot already happened)."""
    from ..index.log_entry import Directory

    root = Directory("/")
    for fi in sorted(files, key=lambda f: f.name):
        parts = fi.name.strip("/").split("/")
        node = root
        for p in parts[:-1]:
            nxt = next((d for d in node.subdirs if d.name == p), None)
            if nxt is None:
                nxt = Directory(p)
                node.subdirs.append(nxt)
                node.subdirs.sort(key=lambda d: d.name)
            node = nxt
        from ..index.log_entry import FileInfo

        node.files.append(FileInfo(parts[-1], fi.size, fi.modified_time, fi.id))
    return Content(root)


class CreateAction(Action, CreateActionBase):
    transient_state = states.CREATING
    final_state = states.ACTIVE

    def __init__(
        self,
        session,
        df,
        config: IndexConfig,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
    ):
        Action.__init__(self, log_manager)
        CreateActionBase.__init__(self, session)
        self.df = df
        self.config = config
        self.data_manager = data_manager
        self._entry: Optional[IndexLogEntry] = None
        self._tracker = FileIdTracker()

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
        rel = self.relation
        self.conf.build_mode()  # an unknown mode raises before begin()
        self.resolved_columns(rel, self.config)  # raises on unresolvable
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != states.DOESNOTEXIST:
            raise HyperspaceException(
                f"Another index with name {self.config.index_name} already exists."
            )

    def op(self) -> None:
        rel = self.relation
        num_buckets = self.conf.num_buckets()
        lineage = self.conf.lineage_enabled()
        version_dir = self.data_manager.get_path(0)
        files = self.write(
            rel, self.config, version_dir, num_buckets, lineage, self._tracker
        )
        indexed, included = self.resolved_columns(rel, self.config)
        self._entry = self.build_log_entry(
            self.config.index_name,
            rel,
            Scan(rel),  # fingerprint the relation, as the rules re-derive it
            indexed,
            included,
            num_buckets,
            lineage,
            files,
            self._tracker,
        )

    def log_entry(self) -> LogEntry:
        if self._entry is not None:
            return self._entry
        # transient (begin) entry: metadata without index content yet
        rel = self.relation
        indexed, included = self.resolved_columns(rel, self.config)
        entry = self.build_log_entry(
            self.config.index_name,
            rel,
            Scan(rel),
            indexed,
            included,
            self.conf.num_buckets(),
            self.conf.lineage_enabled(),
            [],
            self._tracker,
        )
        return entry

    def event(self, message: str):
        return CreateActionEvent(
            index=self.config.index_name,
            state=self.final_state,
            message=message,
            original_plan=self.df.plan.tree_string(),
        )
