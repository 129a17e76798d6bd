"""Source ingest: avro, parquet, csv, json, orc and text files into
ColumnarBatches, with hive partition columns materialized from directory
names (storage.partitions).

Avro is read through this package's own OCF reader (storage.avro_io) and
text through plain file reads, both needing nothing but numpy; parquet,
csv, json and orc through pyarrow, each imported only on its own path.
Index *data* is never parquet — it lives in the TCB layout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from ..exceptions import HyperspaceException
from ..utils.memo import bounded_memo_put
from .columnar import ColumnarBatch


def _read_with(
    table_reader, fmt: str, paths: Iterable[str | Path], columns: Optional[List[str]]
) -> ColumnarBatch:
    """Shared multi-file read: per-file table read, uniform projection
    semantics (``columns=None`` means all; an explicit list — including
    ``[]`` — selects exactly those), concat at the end."""
    from ..reliability.retry import call_with_retries

    paths = [str(p) for p in paths]
    if not paths:
        raise HyperspaceException(f"read_{fmt}: no paths.")
    batches = []
    for p in paths:
        # per-file retry (reliability/retry.py): a transient OSError backs
        # off and re-reads; FileNotFound and parse errors stay immediate
        table = call_with_retries(
            lambda: table_reader(p), op=f"{fmt}.read", key=p
        )
        if columns is not None:
            table = table.select(columns)
        batches.append(ColumnarBatch.from_arrow(table))
    return ColumnarBatch.concat(batches)


# Parquet FOOTER memo (metadata parse only — row data is re-decoded every
# read, so repeat-query timings stay honest), keyed by (path, size,
# mtime_ns) and revalidated by stat on every hit. FileMetaData is
# immutable, so each read constructs a fresh ParquetFile around the cached
# footer (no shared file handle → concurrent union sides stay safe). The
# open + footer parse was ~20% of a pruned single-file read on sub-3ms
# queries.
_PQ_META_MEMO: dict = {}
_PQ_META_MEMO_MAX = 128


def _parquet_file(path: str):
    import os

    import pyarrow.parquet as pq

    # str/Path callers must share one slot: the annotation does not stop a
    # Path from arriving, and a raw-argument key halves effective capacity
    path = str(path)
    st = os.stat(path)
    key = (path, st.st_size, st.st_mtime_ns)
    meta = _PQ_META_MEMO.get(key)
    pf = pq.ParquetFile(path, metadata=meta)
    if meta is None:
        bounded_memo_put(_PQ_META_MEMO, key, pf.metadata, _PQ_META_MEMO_MAX)
    return pf


def read_parquet(
    paths: Iterable[str | Path],
    columns: Optional[List[str]] = None,
    arrow_filter=None,
) -> ColumnarBatch:
    """Read one or more parquet files into a single ColumnarBatch.

    ``arrow_filter`` (a pyarrow compute Expression) pushes the predicate
    into the reader — row-group statistics pruning and page skipping
    happen inside parquet instead of materializing rows to mask later.
    Callers must re-apply their own predicate after the read: the filter
    is best-effort (a type-mismatched expression falls back to an
    unfiltered read rather than failing the scan)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    def reader(p):
        if arrow_filter is not None:
            try:
                return pq.read_table(p, columns=columns, filters=arrow_filter)
            except pa.lib.ArrowException:  # pushdown is an optimization
                # count the declined pushdown: it costs a full-file decode
                # per read with nothing else visible
                from ..telemetry.metrics import metrics

                metrics.incr("scan.arrow_pushdown_fallback")
        return _parquet_file(p).read(columns=columns)

    # column pushdown at the parquet reader; projection re-applied uniformly
    return _read_with(reader, "parquet", paths, columns)


def read_csv(paths: Iterable[str | Path], columns: Optional[List[str]] = None) -> ColumnarBatch:
    import pyarrow.csv as pacsv

    return _read_with(lambda p: pacsv.read_csv(p), "csv", paths, columns)


def read_json(paths: Iterable[str | Path], columns: Optional[List[str]] = None) -> ColumnarBatch:
    import pyarrow.json as pajson

    return _read_with(lambda p: pajson.read_json(p), "json", paths, columns)


def read_orc(paths: Iterable[str | Path], columns: Optional[List[str]] = None) -> ColumnarBatch:
    """ORC ingest via pyarrow.orc (the reference's allowlist includes orc,
    HyperspaceConf.scala:85-90)."""
    from pyarrow import orc as paorc

    return _read_with(
        lambda p: paorc.ORCFile(p).read(columns=columns), "orc", paths, columns
    )


def read_text(paths: Iterable[str | Path], columns: Optional[List[str]] = None) -> ColumnarBatch:
    """Text ingest: one ``value`` string column per line — Spark's text
    source schema. Lines split on ``\\n`` only (with ``\\r`` stripped
    before it), matching Spark's record delimiter — NOT Python's
    splitlines(), whose extra separators (\\f, U+2028, ...) would change
    row counts. Bytes stay bytes end to end, so non-UTF-8 content indexes
    fine (the dictionary vocab is byte-typed)."""
    from .columnar import Column

    paths = [str(p) for p in paths]
    if not paths:
        raise HyperspaceException("read_text: no paths.")
    batches = []
    for p in paths:
        data = Path(p).read_bytes()
        if data.endswith(b"\n"):
            data = data[:-1]
        raw_lines = data.split(b"\n") if data else []
        lines = [ln[:-1] if ln.endswith(b"\r") else ln for ln in raw_lines]
        col = (
            Column.from_values(np.array(lines, dtype=object), "string")
            if lines
            else Column("string", np.empty(0, dtype=np.int32), np.array([], dtype=object))
        )
        b = ColumnarBatch({"value": col})
        if columns is not None:
            b = b.select(columns)
        batches.append(b)
    return ColumnarBatch.concat(batches)


def write_parquet(path: str | Path, batch: ColumnarBatch) -> None:
    """Write a batch as parquet (test-data generation and oracles)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    arrays = {}
    for name, col in batch.columns.items():
        vals = col.to_values()
        if col.dtype_str == "date32":
            arrays[name] = pa.array(vals.astype("datetime64[D]"))
        elif vals.dtype == object:
            arrays[name] = pa.array([None if v is None else str(v) for v in vals])
        else:
            arrays[name] = pa.array(np.asarray(vals))
    table = pa.table(arrays)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(table, str(path))


def read_avro(paths: Iterable[str | Path], columns: Optional[List[str]] = None) -> ColumnarBatch:
    from .avro_io import read_avro as _ra

    return _ra(paths, columns)


READERS = {
    "avro": read_avro,
    "parquet": read_parquet,
    "csv": read_csv,
    "json": read_json,
    "orc": read_orc,
    "text": read_text,
}


def read_files(
    file_format: str,
    paths: Iterable[str | Path],
    columns=None,
    arrow_filter=None,
) -> ColumnarBatch:
    try:
        reader = READERS[file_format]
    except KeyError:
        raise HyperspaceException(f"Unsupported source format: {file_format}")
    if file_format == "parquet":
        return reader(paths, columns, arrow_filter=arrow_filter)
    return reader(paths, columns)


def _split_partition_columns(relation, columns):
    """(file columns to read, partition columns to append) for a requested
    projection against a possibly-partitioned relation. ``columns=None``
    means all of each."""
    spec = relation.partition_spec
    if spec is None:
        return columns, []
    part_names = spec.names
    if columns is None:
        file_cols = [c for c in relation.schema if c not in part_names]
        return file_cols, list(part_names)
    return (
        [c for c in columns if c not in part_names],
        [c for c in columns if c in part_names],
    )


def _file_row_count(relation, path: str) -> int:
    """Row count of one source file for a partition-only projection.
    Parquet answers from the footer (no data decoded); other formats read
    one file-borne column solely for its length."""
    if relation.read_format == "parquet":
        return _parquet_file(path).metadata.num_rows
    spec_names = set(relation.partition_spec.names)
    for c in relation.schema:
        if c not in spec_names:
            return read_files(relation.read_format, [path], columns=[c]).num_rows
    raise HyperspaceException(
        "Relation has no file-borne columns to derive row counts from."
    )


def _partition_file_batches(
    relation, path: str, columns, arrow_filter, chunk_rows: Optional[int]
):
    """Yield one file's batches with hive partition columns materialized —
    the shared core of read_relation (chunk_rows=None: the whole file) and
    iter_relation_file_batches (streamed chunks)."""
    from . import partitions as P

    spec = relation.partition_spec
    file_cols, part_cols = _split_partition_columns(relation, columns)
    values = P.partition_values_for(path, spec)
    if not file_cols and part_cols:
        # partition-only projection: no file bytes needed beyond the count
        # (still emitted in chunk_rows pieces, so the streaming build's
        # memory bound holds even for constant columns)
        n = _file_row_count(relation, path)
        step = n if chunk_rows is None else max(int(chunk_rows), 1)
        starts = range(0, n, step) if n else [0]  # 0-row files still yield
        for start in starts:
            m = min(step, n - start)
            consts = P.constant_columns(spec, values, m)
            yield ColumnarBatch({name: consts[name] for name in part_cols})
        return
    if chunk_rows is None:
        chunks = [
            read_files(
                relation.read_format,
                [path],
                columns=file_cols,
                arrow_filter=arrow_filter,
            )
        ]
    else:
        chunks = iter_file_batches(
            relation.read_format, path, columns=file_cols, chunk_rows=chunk_rows
        )
    for chunk in chunks:
        consts = P.constant_columns(spec, values, chunk.num_rows)
        for name in part_cols:
            chunk = chunk.with_column(name, consts[name])
        yield chunk


def read_relation(
    relation,
    paths: Optional[Iterable[str | Path]] = None,
    columns: Optional[List[str]] = None,
    arrow_filter=None,
) -> ColumnarBatch:
    """Read files of a FileRelation (all of them when ``paths`` is None),
    materializing hive partition columns from the directory names
    (storage.partitions). The one ingest entry point call sites should use
    when they hold a relation — plain ``read_files`` knows nothing about
    partition layout."""
    paths = (
        [f.name for f in relation.files] if paths is None else [str(p) for p in paths]
    )
    if relation.partition_spec is None:
        return read_files(
            relation.read_format, paths, columns=columns, arrow_filter=arrow_filter
        )
    parts = []
    for p in paths:
        parts.extend(
            _partition_file_batches(relation, p, columns, arrow_filter, None)
        )
    out = ColumnarBatch.concat(parts)
    return out.select(columns) if columns is not None else out


def iter_relation_file_batches(
    relation,
    path: str | Path,
    columns: Optional[List[str]] = None,
    chunk_rows: int = 1 << 21,
):
    """Streaming twin of read_relation for one file (the out-of-core build
    ingest): yields chunks with partition columns materialized."""
    if relation.partition_spec is None:
        yield from iter_file_batches(
            relation.read_format, path, columns=columns, chunk_rows=chunk_rows
        )
        return
    for chunk in _partition_file_batches(
        relation, str(path), columns, None, chunk_rows
    ):
        yield chunk.select(columns) if columns is not None else chunk


def file_chunk_tasks(
    file_format: str,
    path: str | Path,
    columns: Optional[List[str]] = None,
    chunk_rows: int = 1 << 21,
) -> List:
    """The parallel-ingest twin of ``iter_file_batches``: zero-arg
    callables, each decoding one contiguous slice of the file into a LIST
    of batches. Running them in order and concatenating their outputs
    gives the serial iterator's rows in its order, so the pipelined build
    can spread decode over host cores without changing the index bytes.

    Parquet slices at row-group granularity (the footer names the
    boundaries), packed greedily to ~``chunk_rows`` per task; each task
    re-slices its span to ``chunk_rows`` pieces. Formats without random
    access get one task for the whole file."""
    path = str(path)
    if file_format != "parquet":
        return [
            lambda: list(iter_file_batches(file_format, path, columns, chunk_rows))
        ]
    md = _parquet_file(path).metadata
    spans: List[List[int]] = []
    cur: List[int] = []
    cur_rows = 0
    for rg in range(md.num_row_groups):
        cur.append(rg)
        cur_rows += md.row_group(rg).num_rows
        if cur_rows >= chunk_rows:
            spans.append(cur)
            cur, cur_rows = [], 0
    if cur:
        spans.append(cur)

    def read_span(span: List[int]) -> List[ColumnarBatch]:
        # a fresh ParquetFile per task around the memoized footer: pyarrow
        # readers are not thread-safe, file metadata is
        pf = _parquet_file(path)
        t = pf.read_row_groups(span, columns=columns)
        n = t.num_rows
        return [
            ColumnarBatch.from_arrow(t.slice(s, min(chunk_rows, n - s)))
            for s in range(0, n, chunk_rows)
            if n
        ]

    return [lambda sp=sp: read_span(sp) for sp in spans]


def iter_file_batches(
    file_format: str,
    path: str | Path,
    columns: Optional[List[str]] = None,
    chunk_rows: int = 1 << 21,
):
    """Yield batches of at most ``chunk_rows`` rows from one source file —
    the streamed ingest of the out-of-core build. Parquet streams
    row-group batches through pyarrow's iterator; the other formats are
    read whole (avro through this package's OCF reader, which needs no
    pyarrow) and re-sliced, which bounds memory at file granularity."""
    path = str(path)
    if file_format == "parquet":
        import pyarrow as pa

        pf = _parquet_file(path)
        for rb in pf.iter_batches(batch_size=chunk_rows, columns=columns):
            if rb.num_rows == 0:
                continue
            yield ColumnarBatch.from_arrow(pa.Table.from_batches([rb]))
        return
    whole = read_files(file_format, [path], columns=columns)
    n = whole.num_rows
    if n == 0:
        return
    for s in range(0, n, chunk_rows):
        yield whole.take(np.arange(s, min(s + chunk_rows, n)))
