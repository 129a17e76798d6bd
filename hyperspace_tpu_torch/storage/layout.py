"""The on-disk index layout: TCB (tensor columnar batch) files.

A copy of ``hyperspace_tpu.storage.layout`` (per-bucket files only): the
bytes this module writes for a batch are exactly the reference's, so both
packages read each other's index data.

* one file per bucket, named ``b<bucket>-<uuid>.tcb``;
* raw little-endian fixed-width column buffers, each aligned to 128 bytes,
  so a read is an ``np.memmap`` view with no decode step;
* a JSON footer (schema, row count, per-column offset/nbytes, per-column
  min/max for numeric pruning, string vocabs, sort/bucket info) followed by
  an 8-byte little-endian footer length and the magic ``TCB1`` — parquet-
  style trailer so readers seek from the end.
"""

from __future__ import annotations

import json
import os
import re
import uuid
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .. import constants as C
from ..exceptions import HyperspaceException
from .columnar import CODE_DTYPE, Column, ColumnarBatch, is_string, numpy_dtype

MAGIC = b"TCB1"
ALIGN = C.STORAGE_BLOCK_ALIGN


def _pad(n: int) -> int:
    return (ALIGN - n % ALIGN) % ALIGN


def bucket_file_name(bucket: int) -> str:
    return f"b{bucket:05d}-{uuid.uuid4().hex[:12]}.tcb"


_RUN_FILE_RE = re.compile(r"^r\d{5,}-[0-9a-f]{12}\.tcb$")


def is_run_file(path: str | Path) -> bool:
    """A multi-bucket run file (``r<seq>-<uuid>.tcb``), written by the
    reference's streaming build with finalizeMode=runs. This package
    writes none and reads none yet."""
    return bool(_RUN_FILE_RE.match(os.path.basename(str(path))))


def bucket_of_file(path: str | Path) -> int:
    """Parse the bucket id back out of a data file name (the analog of
    Spark's BucketingUtils.getBucketId used by OptimizeAction.scala:120).
    Multi-bucket run files (``r``-prefixed, written by the reference's
    streaming build with finalizeMode=runs) are not read by this package
    and raise here."""
    name = os.path.basename(str(path))
    if not (name.startswith("b") and name.endswith(".tcb")):
        raise HyperspaceException(f"Not an index data file: {name}")
    try:
        return int(name[1:].split("-", 1)[0])
    except ValueError:
        raise HyperspaceException(f"Not an index data file: {name}")


def write_batch(
    path: str | Path,
    batch: ColumnarBatch,
    sorted_by: Optional[List[str]] = None,
    bucket: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
    fs=None,
) -> None:
    """Write one batch as a TCB file. ``fs=None`` streams buffers to local
    disk (temp file + atomic replace); any other FileSystem gets one
    atomic whole-object write — object-store PUTs are atomic by nature, so
    the layout needs no rename there (storage.filesystem seam)."""
    path = Path(path)
    columns_meta: List[Dict[str, Any]] = []
    offset = 0
    # (contiguous array, pad bytes) per column: the arrays are handed to
    # write() as memoryviews — a .tobytes() here would memcpy the whole
    # batch through user space first, and on this class of host the write
    # path is the compaction bottleneck (~150 MB/s syscall ceiling;
    # optimize() at 60M spent 15.5s of 18.2s writing)
    buffers: List[Tuple[np.ndarray, int]] = []
    for name, col in batch.columns.items():
        data = np.ascontiguousarray(col.data)
        nbytes = data.nbytes
        pad = _pad(nbytes)
        meta: Dict[str, Any] = {
            "name": name,
            "dtype": col.dtype_str,
            "offset": offset,
            "nbytes": nbytes,
        }
        mm = col.min_max()
        if mm is not None:
            meta["min"], meta["max"] = mm
        if is_string(col.dtype_str):
            meta["vocab"] = [v.decode("utf-8", "surrogateescape") for v in col.vocab]
        columns_meta.append(meta)
        buffers.append((data, pad))
        offset += nbytes + pad
    footer = {
        "version": 1,
        "numRows": batch.num_rows,
        "columns": columns_meta,
        "sortedBy": sorted_by or [],
        "bucket": bucket,
        "extra": extra or {},
    }
    footer_bytes = json.dumps(footer).encode("utf-8")
    trailer = footer_bytes + len(footer_bytes).to_bytes(8, "little") + MAGIC
    if fs is not None:
        fs.write(
            str(path),
            b"".join(
                a.tobytes() + b"\0" * pad for a, pad in buffers
            )
            + trailer,
        )
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp"
    with open(tmp, "wb") as f:
        for a, pad in buffers:
            f.write(memoryview(a).cast("B"))
            if pad:
                f.write(b"\0" * pad)
        f.write(trailer)
    os.replace(tmp, path)


def read_footer(path: str | Path, fs=None) -> Dict[str, Any]:
    if fs is not None:
        size = fs.size(str(path))
        if size < 12:
            raise HyperspaceException(f"Truncated TCB file: {path}")
        trailer = fs.read(str(path), size - 12, 12)
        if trailer[8:] != MAGIC:
            raise HyperspaceException(f"Bad magic in {path}; not a TCB file.")
        flen = int.from_bytes(trailer[:8], "little")
        if flen <= 0 or flen > size - 12:
            raise HyperspaceException(f"Corrupt TCB footer length in {path}.")
        try:
            return json.loads(fs.read(str(path), size - 12 - flen, flen))
        except json.JSONDecodeError as e:
            raise HyperspaceException(f"Corrupt TCB footer in {path}: {e}")
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise HyperspaceException(f"Truncated TCB file: {path}")
        f.seek(size - 12)
        trailer = f.read(12)
        if trailer[8:] != MAGIC:
            raise HyperspaceException(f"Bad magic in {path}; not a TCB file.")
        flen = int.from_bytes(trailer[:8], "little")
        if flen <= 0 or flen > size - 12:
            raise HyperspaceException(f"Corrupt TCB footer length in {path}.")
        f.seek(size - 12 - flen)
        try:
            return json.loads(f.read(flen))
        except json.JSONDecodeError as e:
            raise HyperspaceException(f"Corrupt TCB footer in {path}: {e}")


def _resolve_names(
    footer: Dict[str, Any], columns: Optional[Iterable[str]], path
) -> List[str]:
    want = list(columns) if columns is not None else None
    by_name = {m["name"]: m for m in footer["columns"]}
    if want is not None:
        missing = [c for c in want if c not in by_name]
        if missing:
            raise HyperspaceException(f"Columns {missing} not in {path}.")
    return want if want is not None else [m["name"] for m in footer["columns"]]


class TcbReader:
    """A handle over one TCB file: footer parsed once, buffer mapped once,
    string vocabs decoded once — then any number of (projection, row-range)
    reads. The streaming build's finalize step does num_buckets reads per
    spill run; without this handle each read would re-parse the JSON footer
    (which embeds the full vocab for string columns) per (bucket, run)."""

    def __init__(self, path: str | Path, mmap: bool = True, fs=None):
        self.path = Path(path)
        self.footer = read_footer(path, fs=fs)
        self._by_name = {m["name"]: m for m in self.footer["columns"]}
        self._fs = fs
        if fs is not None:
            self._raw = None  # ranged fs reads per column
        elif mmap:
            self._raw = np.memmap(self.path, dtype=np.uint8, mode="r")
        else:
            self._raw = np.fromfile(self.path, dtype=np.uint8)
        self._vocabs: Dict[str, np.ndarray] = {}
        # one reader is shared by the build's parallel bucket merges and
        # by concurrent query threads: range reads over the mmap are
        # naturally safe, the vocab decode memo needs the lock
        self._vocab_lock = Lock()

    @property
    def num_rows(self) -> int:
        return self.footer["numRows"]

    def _vocab(self, name: str) -> np.ndarray:
        with self._vocab_lock:
            v = self._vocabs.get(name)
        if v is None:
            # decode outside the lock (hslint HS002: the encode loop over
            # a big vocab is real work); a racing double-decode is benign
            # — identical arrays, last write wins
            v = np.array(
                [
                    x.encode("utf-8", "surrogateescape")
                    for x in self._by_name[name]["vocab"]
                ],
                dtype=object,
            )
            with self._vocab_lock:
                self._vocabs[name] = v
        return v

    def read(
        self,
        columns: Optional[Iterable[str]] = None,
        row_range: Optional[tuple] = None,
    ) -> ColumnarBatch:
        names = _resolve_names(self.footer, columns, self.path)
        n = self.num_rows
        s, e = (0, n) if row_range is None else row_range
        if not (0 <= s <= e <= n):
            raise HyperspaceException(
                f"row_range {row_range} out of [0, {n}] in {self.path}."
            )
        cols: Dict[str, Column] = {}
        for name in names:
            m = self._by_name[name]
            dt = CODE_DTYPE if is_string(m["dtype"]) else numpy_dtype(m["dtype"])
            lo = m["offset"] + s * dt.itemsize
            hi = m["offset"] + e * dt.itemsize
            if self._raw is not None:
                data = self._raw[lo:hi].view(dt)
            else:
                data = np.frombuffer(
                    self._fs.read(str(self.path), lo, hi - lo), dtype=dt
                )
            vocab = self._vocab(name) if is_string(m["dtype"]) else None
            cols[name] = Column(m["dtype"], data, vocab)
        return ColumnarBatch(cols)


from collections import OrderedDict  # noqa: E402 (kept near its user)
from threading import Lock  # noqa: E402

_READER_CACHE: "OrderedDict[tuple, TcbReader]" = OrderedDict()
_READER_CACHE_CAP = 256
_READER_CACHE_LOCK = Lock()  # union sides execute concurrently


def cached_reader(path: str | Path) -> TcbReader:
    """Shared mmap/footer handle per TCB file, LRU-capped.

    TCB index files are IMMUTABLE once written (every version is a new
    ``v__=k`` directory and every file name embeds a uuid), so a handle
    keyed by (path, size, mtime) can be reused across queries: the
    per-query JSON-footer re-parse and mmap setup were ~20ms of a 90ms
    Q17 (64 buckets × 2 sides = 128 opens). mtime/size stay in the key
    purely as a safety net for hand-edited files."""
    p = Path(path)
    st = p.stat()
    key = (str(p), st.st_size, st.st_mtime_ns)
    with _READER_CACHE_LOCK:
        r = _READER_CACHE.get(key)
        if r is not None:
            _READER_CACHE.move_to_end(key)
            return r
    r = TcbReader(p)  # footer parse outside the lock
    with _READER_CACHE_LOCK:
        existing = _READER_CACHE.get(key)
        if existing is not None:
            return existing
        _READER_CACHE[key] = r
        while len(_READER_CACHE) > _READER_CACHE_CAP:
            _READER_CACHE.popitem(last=False)
    return r


def read_batch(
    path: str | Path,
    columns: Optional[Iterable[str]] = None,
    mmap: bool = True,
    row_range: Optional[tuple] = None,
) -> ColumnarBatch:
    """Read (a projection of) a TCB file. With ``mmap=True`` column buffers
    are memory-mapped views: no copy happens until the array is handed to
    the device.

    ``row_range=(start, stop)`` reads only that row slice of each column —
    columns are fixed-width raw buffers, so a row slice is a byte-range per
    column (mmap makes it page-granular IO). For repeated range reads of
    the same file use ``TcbReader`` directly."""
    if mmap:
        return cached_reader(path).read(columns, row_range)
    return TcbReader(path, mmap=mmap).read(columns, row_range)


def read_batches(
    paths: List[str | Path],
    columns: Optional[Iterable[str]] = None,
) -> List[ColumnarBatch]:
    """Read (projections of) many TCB files as mmap views, one file after
    another (pages fault in when the data is first touched)."""
    return [read_batch(p, columns) for p in paths]


def prune_by_min_max(
    paths: Iterable[str | Path],
    column: str,
    lo: Optional[float],
    hi: Optional[float],
) -> List[Path]:
    """Data-skipping: keep only files whose footer [min,max] range for
    ``column`` intersects [lo, hi] (BASELINE.md config 5 — sketch-based
    skipping; min/max zone maps are the first sketch type)."""
    out: List[Path] = []
    for p in paths:
        footer = cached_reader(p).footer
        meta = next((m for m in footer["columns"] if m["name"] == column), None)
        if meta is None or "min" not in meta:
            out.append(Path(p))  # cannot prune
            continue
        if lo is not None and meta["max"] < lo:
            continue
        if hi is not None and meta["min"] > hi:
            continue
        out.append(Path(p))
    return out
