"""Default file-based source provider: avro, csv, json, orc, parquet and
text directories, hive-partitioned or flat.

Parity: com/microsoft/hyperspace/index/sources/default/
DefaultFileBasedSource.scala, as ``hyperspace_tpu.sources.default``
carries it. Schema inference reads one file's header (avro), footer
(parquet, through pyarrow) or contents (the other formats).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import constants as C
from ..exceptions import HyperspaceException
from ..index.log_entry import Content, FileIdTracker, FileInfo, Relation
from ..utils import file_utils
from ..utils.memo import bounded_memo_put
from .interfaces import FileBasedSourceProvider
from .relation import FileRelation


def _infer_schema(file_format: str, sample_path: str) -> Dict[str, str]:
    from ..storage import parquet_io
    from ..storage.columnar import ColumnarBatch

    if file_format.lower() == "parquet":
        # footer-only read: no row data is decoded just to learn the schema
        import pyarrow.parquet as pq

        arrow_schema = pq.ParquetFile(sample_path).schema_arrow
        return ColumnarBatch.from_arrow(arrow_schema.empty_table()).schema()
    if file_format.lower() == "avro":
        # header-only: the OCF carries its schema before any data block
        from ..storage.avro_io import infer_schema

        return infer_schema(sample_path)
    return parquet_io.read_files(file_format, [sample_path]).schema()


# Per-file-signature snapshot memo: every DataFrame construction
# re-lists its source (fresh-snapshot semantics), and at 64-file sources
# the FileInfo/content-tree construction plus downstream per-call work
# dominates sub-5ms indexed queries. The listing + one stat per file
# ALWAYS happen (so in-place rewrites, appends, and deletes are all
# seen — the signature staleness detection the hybrid scan rests on is
# unaffected); only the derived construction is memoized, keyed by the
# exact (path, size, mtime_ns) tuple it is a pure function of. Opt out
# with HYPERSPACE_TPU_SNAPSHOT_MEMO=off.
_SNAPSHOT_MEMO: dict = {}
_SNAPSHOT_MEMO_MAX = 64


def _walk_stats(root_paths: List[str]):
    """One scandir pass collecting (path, size, mtime_ns) for every leaf
    file, with the same hidden/underscore skip rules and global path sort
    as file_utils.list_leaf_files (DirEntry stats ride the directory read
    — one syscall pass instead of walk + stat-per-file)."""
    import os as _os

    out = []
    for p in file_utils.expand_globs(root_paths):
        if p.is_file():
            st = p.stat()
            out.append((str(p), st.st_size, st.st_mtime_ns))
            continue
        stack = [str(p)]
        while stack:
            d = stack.pop()
            with _os.scandir(d) as entries:
                for e in entries:
                    if e.name.startswith((".", "_")):
                        continue
                    if e.is_dir(follow_symlinks=False):
                        stack.append(e.path)
                    elif e.is_file():
                        st = e.stat()
                        out.append((e.path, st.st_size, st.st_mtime_ns))
    out.sort()
    return out


def _snapshot_files(root_paths: List[str]) -> List[FileInfo]:
    import os as _os

    try:
        stats = _walk_stats(root_paths)
    except OSError:
        stats = None
    if stats is None:  # unstatable mid-walk: the slow exact path decides
        paths = [str(p) for p in file_utils.list_leaf_files(root_paths)]
        sig = None
        pre = None
    else:
        paths = [p for p, _, _ in stats]
        sig = tuple(stats)
        # mtime in ms: the FileInfo identity grain (the memo signature
        # keeps full ns precision)
        pre = {p: (size, mt_ns // 1_000_000) for p, size, mt_ns in stats}
    if (
        sig is not None
        and _os.environ.get("HYPERSPACE_TPU_SNAPSHOT_MEMO", "on").lower()
        != "off"
    ):
        key = tuple(str(p) for p in root_paths)
        hit = _SNAPSHOT_MEMO.get(key)
        if hit is not None and hit[0] == sig:
            return list(hit[1])  # defensive copy: callers own their list
    else:
        key = None
    tracker = FileIdTracker()
    content = Content.from_leaf_files(paths, tracker, pre)
    files = content.file_infos() if content else []
    if key is not None:
        bounded_memo_put(_SNAPSHOT_MEMO, key, (sig, files), _SNAPSHOT_MEMO_MAX)
    return list(files) if key is not None else files


# schema inference reads a sample file (parquet footer / avro header) —
# per-call it was the bulk of sub-5ms indexed queries' fixed cost. The
# result is a pure function of the sample file's exact identity.
_SCHEMA_MEMO: dict = {}


def _infer_schema_memoized(file_format: str, sample: FileInfo):
    key = (file_format, sample.name, sample.size, sample.modified_time)
    hit = _SCHEMA_MEMO.get(key)
    if hit is not None:
        return dict(hit)
    schema = _infer_schema(file_format, sample.name)
    bounded_memo_put(_SCHEMA_MEMO, key, dict(schema), _SNAPSHOT_MEMO_MAX)
    return schema


def _concrete_bases(root_paths) -> List[str]:
    """Root paths with glob patterns expanded to the concrete directories
    they currently match — partition components are resolved below these.
    expand_globs passes non-pattern paths through unchanged, so it is the
    single glob-detection policy."""
    return [str(p.absolute()) for p in file_utils.expand_globs(root_paths)]


def _discover_spec(files, root_paths, options, declared):
    """Hive partition discovery over a snapshot (storage.partitions), off
    when the ``partitionInference`` option is "false"."""
    if (options or {}).get(C.PARTITION_INFERENCE_KEY, "true").lower() == "false":
        return None
    from ..storage.partitions import discover_partition_spec

    return discover_partition_spec(
        [f.name for f in files], _concrete_bases(root_paths), declared_schema=declared
    )


def _logged_spec(relation: Relation):
    """The create-time PartitionSpec, reconstructed from the logged
    relation (names from PARTITION_COLUMNS_META, dtypes from the schema;
    bases re-expanded from the logged roots — new directories matched by a
    logged glob pattern resolve against their own expansion)."""
    raw = (relation.options or {}).get(C.PARTITION_COLUMNS_META, "")
    names = json.loads(raw) if raw else []
    if not names:
        return None
    from ..storage.partitions import PartitionSpec

    missing = [n for n in names if n not in relation.schema]
    if missing:
        raise HyperspaceException(
            f"Logged partition columns {missing} absent from the logged "
            "relation schema — corrupt metadata."
        )
    return PartitionSpec(
        tuple((n, relation.schema[n]) for n in names),
        tuple(_concrete_bases(relation.root_paths)),
    )


class DefaultFileBasedSource(FileBasedSourceProvider):
    """Formats in the allowlist (DefaultFileBasedSource.scala:42-48;
    constants.DEFAULT_SUPPORTED_FORMATS)."""

    def supports_format(self, file_format: str) -> bool:
        return file_format.lower() in C.DEFAULT_SUPPORTED_FORMATS

    def create_relation(
        self,
        root_paths: List[str],
        file_format: str,
        options: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
    ) -> Optional[FileRelation]:
        if not self.supports_format(file_format):
            return None
        logged_roots = [str(Path(p).absolute()) for p in root_paths]
        pattern = (options or {}).get(C.GLOBBING_PATTERN_KEY)
        if pattern:
            # Validate the pattern covers every actual root path, then log
            # the *pattern* as the relation's roots so later snapshots pick
            # up new matches (DefaultFileBasedSource.scala:90-118).
            patterns = [p.strip() for p in pattern.split(",") if p.strip()]
            expanded = {
                str(p.absolute()) for p in file_utils.expand_globs(patterns)
            }
            unmatched = [r for r in logged_roots if r not in expanded]
            if unmatched:
                raise HyperspaceException(
                    "Some glob patterns do not match with available root "
                    f"paths of the source data. Please check if {pattern} "
                    f"matches all of {unmatched}."
                )
            logged_roots = patterns
        files = _snapshot_files(root_paths)
        # a user-declared schema may already include the partition columns
        # (the standard way to pin their dtypes) — discovery treats it as
        # authoritative for dtype, and such names are NOT collisions
        spec = _discover_spec(files, root_paths, options, declared=schema)
        if schema is None:
            if not files:
                raise HyperspaceException(
                    f"Cannot infer schema: no files under {root_paths}."
                )
            schema = _infer_schema_memoized(file_format, files[0])
            if spec is not None:
                clash = [n for n in spec.names if n in schema]
                if clash:
                    raise HyperspaceException(
                        f"Partition columns {clash} collide with data columns "
                        f"of the same name under {root_paths}."
                    )
        if spec is not None:
            # Spark's ordering: file columns first, partition columns after
            # (already-declared partition columns keep their declared spot)
            schema = {**schema, **{n: d for n, d in spec.columns if n not in schema}}
        out_options = dict(options or {})
        if spec is not None:
            # JSON list, not comma-joined: a partition column named "a,b"
            # must round-trip through the log intact
            out_options[C.PARTITION_COLUMNS_META] = json.dumps(spec.names)
        return FileRelation(
            root_paths=logged_roots,
            file_format=file_format,
            schema=schema,
            files=files,
            options=out_options,
            partition_spec=spec,
        )

    def refresh_relation(self, relation: Relation) -> Optional[FileRelation]:
        """(DefaultFileBasedSource.scala:156-163): re-list the logged root
        paths with the logged schema/options."""
        if not self.supports_format(relation.file_format):
            return None
        files = _snapshot_files(relation.root_paths)
        return FileRelation(
            root_paths=list(relation.root_paths),
            file_format=relation.file_format,
            schema=dict(relation.schema),
            files=files,
            options=dict(relation.options),
            # the spec is REBUILT from what create-time discovery logged
            # (names in options, dtypes in the schema) — never re-guessed
            # from the new snapshot, so a re-layout that grows partition-
            # looking directories around a data column stays inert, while
            # files that stop matching the logged layout fail loudly at
            # read time (partition_values_for)
            partition_spec=_logged_spec(relation),
        )

    def all_files(self, relation: FileRelation) -> Optional[List[FileInfo]]:
        if not self.supports_format(relation.file_format):
            return None
        return _snapshot_files(relation.root_paths)

    def lineage_pairs(
        self, relation: FileRelation, tracker: FileIdTracker
    ) -> Optional[List[Tuple[str, int]]]:
        """(DefaultFileBasedSource.scala:263-275): ids from the shared
        FileIdTracker, one per current leaf file."""
        if not self.supports_format(relation.file_format):
            return None
        out = []
        for f in relation.files:
            fid = tracker.add_file(f.name, f.size, f.modified_time)
            out.append((f.name, fid))
        return out
