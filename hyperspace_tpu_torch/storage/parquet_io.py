"""Source ingest: parquet and avro files into ColumnarBatches.

Parquet is read through pyarrow, imported only on that path; avro through
this package's own OCF reader (storage.avro_io), which needs nothing but
numpy. Index *data* is never parquet — it lives in the TCB layout.
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
    paths = [str(p) for p in paths]
    if not paths:
        raise HyperspaceException(f"read_{fmt}: no paths.")
    batches = []
    for p in paths:
        table = table_reader(p)
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
) -> ColumnarBatch:
    """Read one or more parquet files into a single ColumnarBatch."""

    def reader(p):
        return _parquet_file(p).read(columns=columns)

    # column pushdown at the parquet reader; projection re-applied uniformly
    return _read_with(reader, "parquet", paths, columns)


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
}


def read_files(
    file_format: str,
    paths: Iterable[str | Path],
    columns=None,
) -> ColumnarBatch:
    try:
        reader = READERS[file_format]
    except KeyError:
        raise HyperspaceException(f"Unsupported source format: {file_format}")
    return reader(paths, columns)


def read_relation(
    relation,
    paths: Optional[Iterable[str | Path]] = None,
    columns: Optional[List[str]] = None,
) -> ColumnarBatch:
    """Read files of a FileRelation (all of them when ``paths`` is None)."""
    paths = (
        [f.name for f in relation.files] if paths is None else [str(p) for p in paths]
    )
    return read_files(relation.read_format, paths, columns=columns)
