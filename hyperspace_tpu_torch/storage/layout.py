"""The on-disk index layout: TCB (tensor columnar batch) files.

A copy of ``hyperspace_tpu.storage.layout``: the bytes this module writes
for a batch are exactly the reference's, so both packages read each
other's index data.

* one file per bucket, named ``b<bucket>-<uuid>.tcb``, or (the streaming
  build's ``finalizeMode=runs``) multi-bucket run files named
  ``r<seq>-<uuid>.tcb``, bucket-grouped and key-sorted, whose footer
  ``bucketCounts`` give each bucket's row range;
* raw little-endian fixed-width column buffers, each aligned to 128 bytes,
  so a read is an ``np.memmap`` view, or (``read_batches`` over files not
  in the page cache) one ``pread`` into a fresh buffer, with no decode
  step;
* a JSON footer (schema, row count, per-column offset/nbytes, per-column
  min/max for numeric pruning, string vocabs, sort/bucket info) followed by
  an 8-byte little-endian footer length and the magic ``TCB1`` — parquet-
  style trailer so readers seek from the end.
"""

from __future__ import annotations

import ctypes
import functools
import json
import mmap
import os
import re
import uuid
from pathlib import Path
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .. import constants as C
from .. import native
from ..exceptions import HyperspaceException
from ..telemetry.trace import span as _span
from .columnar import CODE_DTYPE, Column, ColumnarBatch, is_string, numpy_dtype

MAGIC = b"TCB1"
ALIGN = C.STORAGE_BLOCK_ALIGN


def _pad(n: int) -> int:
    return (ALIGN - n % ALIGN) % ALIGN


def bucket_file_name(bucket: int) -> str:
    return f"b{bucket:05d}-{uuid.uuid4().hex[:12]}.tcb"


def run_file_name(seq: int) -> str:
    """A multi-bucket RUN file: one key-sorted, bucket-grouped spill run
    promoted to a final data file (build finalizeMode=runs). Rows of every
    bucket live in one file at the row ranges its footer's
    ``bucketCounts`` describe; optimize or the compactor later rewrite
    runs as per-bucket ``b``-files."""
    return f"r{seq:05d}-{uuid.uuid4().hex[:12]}.tcb"


_RUN_FILE_RE = re.compile(r"^r\d{5,}-[0-9a-f]{12}\.tcb$")  # {5,}: seq >= 100000 widens the field


def is_run_file(path: str | Path) -> bool:
    """Matches exactly the names ``run_file_name`` generates (not the
    build's ``run-*.tcb`` spill scratch)."""
    return bool(_RUN_FILE_RE.match(os.path.basename(str(path))))


def run_bucket_offsets(footer: Dict[str, Any]) -> Optional[np.ndarray]:
    """Per-bucket cumulative row offsets of a run file (len num_buckets+1),
    or None when the footer carries no bucket layout. Bucket b's rows are
    ``[offsets[b], offsets[b+1])``."""
    counts = footer.get("extra", {}).get("bucketCounts")
    if counts is None:
        return None
    return np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))])


def run_offsets_checked(path: str | Path) -> np.ndarray:
    """``run_bucket_offsets`` through the shared reader cache, raising when
    the footer carries no bucket layout — the one copy of that check every
    run-segment reader shares (a whole-file fallback would put the file's
    rows into every bucket's group)."""
    offs = run_bucket_offsets(cached_reader(path).footer)
    if offs is None:
        raise HyperspaceException(
            f"Run file {path} carries no bucketCounts footer."
        )
    return offs


def index_root_of(path: str | Path) -> Optional[str]:
    """The index directory a data file lives under (the parent of its
    ``v__=k`` version dir), or None for paths outside the versioned
    layout."""
    p = Path(path)
    for parent in p.parents:
        if parent.name.startswith(C.INDEX_VERSION_DIRECTORY_PREFIX + "="):
            return str(parent.parent)
    return None


def bucket_of_file(path: str | Path) -> int:
    """Parse the bucket id back out of a data file name (the analog of
    Spark's BucketingUtils.getBucketId used by OptimizeAction.scala:120).
    Run files (``r``-prefixed) hold ALL buckets and raise here — callers
    check ``is_run_file`` first and use ``run_bucket_offsets`` instead."""
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


def _column_from_buffer(meta: Dict[str, Any], buf: np.ndarray, n: int,
                        vocab: Optional[np.ndarray]) -> Column:
    """A column over a loaded buffer of its raw bytes (the reference's
    ``_column_from_buffer``; a string column's vocab comes decoded from
    the file's reader)."""
    dt = CODE_DTYPE if is_string(meta["dtype"]) else numpy_dtype(meta["dtype"])
    return Column(meta["dtype"], buf.view(dt)[:n], vocab)


def pages_cached(mm: np.ndarray, start: int, stop: int) -> bool:
    """Whether every page of bytes ``[start, stop)`` of the file that the
    map ``mm`` (an ``np.memmap`` from offset 0) views is in the page cache
    (``mincore``; mapping a file touches none of its pages). False where
    the call fails."""
    if stop <= start:
        return True
    page = mmap.PAGESIZE
    lo = start - start % page
    vec = np.empty((stop - lo + page - 1) // page, dtype=np.uint8)
    rc = _libc().mincore(ctypes.c_void_p(mm.ctypes.data + lo), ctypes.c_size_t(stop - lo),
                         vec.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return rc == 0 and bool((vec & 1).all())


@functools.lru_cache(maxsize=1)
def _libc() -> ctypes.CDLL:
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_ubyte)]
    libc.mincore.restype = ctypes.c_int
    return libc


def read_plan(paths: List[str | Path],
              columns: Optional[Iterable[str]] = None) -> List[tuple]:
    """``(shared reader, column names, column metas)`` per file: what
    ``read_batches`` reads, before any column byte is touched."""
    want = list(columns) if columns is not None else None
    plan = []
    for p in paths:
        rd = cached_reader(p)
        names = _resolve_names(rd.footer, want, rd.path)
        plan.append((rd, names, [rd._by_name[nm] for nm in names]))
    return plan


def read_batches(
    paths: List[str | Path],
    columns: Optional[Iterable[str]] = None,
) -> List[ColumnarBatch]:
    """Read (projections of) many TCB files. Where the wanted columns of
    every file are in the page cache, or only one file or one CPU is at
    hand, they are mmap views, one file after another: a view of cached
    pages costs no copy, which a read into a fresh buffer cannot beat.
    Otherwise every column buffer of every file loads at once through the
    native runtime's parallel ``pread`` (``load_buffers``), so the disk
    reads overlap."""
    plan = read_plan(paths, columns)
    if len(plan) > 1 and (os.cpu_count() or 1) > 1 and not all(
            pages_cached(rd._raw, min((m["offset"] for m in metas), default=0),
                         max((m["offset"] + m["nbytes"] for m in metas), default=0))
            for rd, _names, metas in plan):
        return load_buffers(plan)
    return [rd.read(names) for rd, names, _metas in plan]


def load_buffers(plan) -> List[ColumnarBatch]:
    """``read_batches``' parallel arm over its plan, ``(reader, names,
    column metas)`` per file: every column buffer into a fresh array
    through one ``native.load_columns`` call."""
    specs = [(str(rd.path), [(m["offset"], m["nbytes"]) for m in metas])
             for rd, _names, metas in plan]
    return [ColumnarBatch({
                nm: _column_from_buffer(m, buf, rd.num_rows,
                                        rd._vocab(nm) if is_string(m["dtype"]) else None)
                for nm, m, buf in zip(names, metas, bufs)})
            for (rd, names, metas), bufs in zip(plan, native.load_columns(specs))]


# --- coalesced run-segment IO (the segment-read planner) ---------------------
# A scan or join side over a runs-layout index needs (run file, bucket) row
# segments. The planner takes the whole segment set a side needs, groups it
# per run file, merges adjacent and near-adjacent row ranges, and executes
# ONE ordered sweep per file through the shared TcbReader handles, fanned
# across the host worker pool. The ``io.segment.*`` counters make the plan
# observable; ``naive`` mode (one read per segment) is the A/B lever.

# merge ranges whose gap is at most this many rows: reading a small gap
# through is cheaper than a second ranged read, and the slice step drops
# the gap rows without copying them
SEGMENT_COALESCE_GAP_ROWS = 8192

_SEGMENT_IO_DEFAULT = C.STORAGE_SEGMENT_IO_DEFAULT  # a session conf adopts


def set_segment_io_default(mode: str) -> None:
    """Adopt a session conf's ``hyperspace.storage.segmentIo`` value as the
    process default (the planner is consulted from process-global read
    paths, so the last session's conf wins;
    HYPERSPACE_TPU_TORCH_SEGMENT_IO overrides both)."""
    global _SEGMENT_IO_DEFAULT
    if mode in C.STORAGE_SEGMENT_IO_MODES:
        _SEGMENT_IO_DEFAULT = mode


def segment_io_coalesced() -> bool:
    v = os.environ.get("HYPERSPACE_TPU_TORCH_SEGMENT_IO", "").strip().lower()
    if v in C.STORAGE_SEGMENT_IO_MODES:
        return v == C.STORAGE_SEGMENT_IO_PLANNED
    return _SEGMENT_IO_DEFAULT == C.STORAGE_SEGMENT_IO_PLANNED


@dataclass
class SegmentSweep:
    """One run file's planned read: ``segments`` are the (bucket, row_lo,
    row_hi) slices the caller needs, lo-ascending (runs are bucket-grouped,
    so bucket order IS row order); ``ranges`` are the merged [lo, hi) row
    ranges one ordered sweep reads to cover them."""

    path: str
    segments: List[Tuple[int, int, int]]
    ranges: List[Tuple[int, int]]


def plan_segment_reads(
    files: Iterable[str | Path],
    buckets: Optional[Set[int]] = None,
    gap_rows: int = SEGMENT_COALESCE_GAP_ROWS,
) -> List[SegmentSweep]:
    """Plan the (run file, bucket) segment reads ``buckets`` (None = every
    bucket) need over the RUN files in ``files`` — other files are skipped
    (callers read those whole). Adjacent and near-adjacent segments merge
    into one range; a bucket with no rows in a file plans nothing there."""
    sweeps: List[SegmentSweep] = []
    for f in files:
        if not is_run_file(f):
            continue
        offs = run_offsets_checked(f)
        want = (
            range(len(offs) - 1)
            if buckets is None
            else sorted(b for b in buckets if 0 <= b < len(offs) - 1)
        )
        segs: List[Tuple[int, int, int]] = []
        for b in want:
            lo, hi = int(offs[b]), int(offs[b + 1])
            if hi > lo:
                segs.append((b, lo, hi))
        if not segs:
            continue
        ranges: List[List[int]] = []
        for _b, lo, hi in segs:  # lo-ascending by construction
            if ranges and lo - ranges[-1][1] <= gap_rows:
                ranges[-1][1] = hi
            else:
                ranges.append([lo, hi])
        sweeps.append(SegmentSweep(str(f), segs, [(a, b) for a, b in ranges]))
    return sweeps


def _slice_batch(batch: ColumnarBatch, lo: int, hi: int) -> ColumnarBatch:
    """A zero-copy row-slice view of ``batch`` (columns stay views over the
    sweep's buffers; vocabs are shared)."""
    return ColumnarBatch(
        {
            name: Column(c.dtype_str, c.data[lo:hi], c.vocab)
            for name, c in batch.columns.items()
        }
    )


def _segment_row_bytes(reader: TcbReader, names: List[str]) -> int:
    total = 0
    for m in reader.footer["columns"]:
        if m["name"] not in names:
            continue
        dt = CODE_DTYPE if is_string(m["dtype"]) else numpy_dtype(m["dtype"])
        total += dt.itemsize
    return total


def execute_segment_reads(
    sweeps: List[SegmentSweep],
    columns: Optional[Iterable[str]] = None,
    workers: Optional[int] = None,
    coalesce: Optional[bool] = None,
) -> Dict[Tuple[str, int], ColumnarBatch]:
    """Execute a segment-read plan: one ordered sweep per run file (the
    merged ranges read front to back through the shared reader handles),
    fanned across the host worker pool, returning the per-(path, bucket)
    batches. ``coalesce=False`` (or segment IO mode ``naive``) issues one
    ranged read per segment instead."""
    if not sweeps:
        return {}
    if coalesce is None:
        coalesce = segment_io_coalesced()
    from ..telemetry.metrics import metrics

    names = list(columns) if columns is not None else None

    def sweep_one(sw: SegmentSweep) -> Dict[Tuple[str, int], ColumnarBatch]:
        reader = cached_reader(sw.path)
        got: Dict[Tuple[str, int], ColumnarBatch] = {}
        want = names if names is not None else [
            m["name"] for m in reader.footer["columns"]
        ]
        row_bytes = _segment_row_bytes(reader, want)
        n_reads = 0
        nbytes = 0
        with _span("io.segment_sweep", file=os.path.basename(sw.path),
                   segments=len(sw.segments), planned_ranges=len(sw.ranges),
                   coalesced=bool(coalesce)):
            if coalesce:
                seg_i = 0
                for lo, hi in sw.ranges:
                    block = reader.read(want, row_range=(lo, hi))
                    n_reads += 1
                    nbytes += (hi - lo) * row_bytes
                    while seg_i < len(sw.segments) and sw.segments[seg_i][2] <= hi:
                        b, slo, shi = sw.segments[seg_i]
                        got[(sw.path, b)] = _slice_batch(block, slo - lo, shi - lo)
                        seg_i += 1
            else:
                for b, lo, hi in sw.segments:
                    got[(sw.path, b)] = reader.read(want, row_range=(lo, hi))
                    n_reads += 1
                    nbytes += (hi - lo) * row_bytes
        metrics.incr("io.segment.ranges", n_reads)
        metrics.incr("io.segment.coalesced", len(sw.segments) - n_reads)
        metrics.incr("io.segment.bytes", nbytes)
        return got

    metrics.incr("io.segment.sweeps", len(sweeps))
    with metrics.timer("io.segment.sweep_wall"), _span("io.segment_io", sweeps=len(sweeps)):
        if workers is None:
            workers = min(len(sweeps), os.cpu_count() or 1)
        if workers <= 1 or len(sweeps) == 1:
            results = [sweep_one(sw) for sw in sweeps]
        else:
            from ..parallel.pool import run_parallel

            results = run_parallel(
                [lambda sw=sw: sweep_one(sw) for sw in sweeps],
                workers,
                name="segment-io",
            )
    out: Dict[Tuple[str, int], ColumnarBatch] = {}
    for r in results:
        out.update(r)
    return out


def read_run_coalesced(
    path: str | Path, columns: Optional[Iterable[str]] = None
) -> ColumnarBatch:
    """Read one run file whole through the segment planner (one sweep, one
    merged range): bucket segments concatenate in bucket order, which is
    the file's row order — the same rows as ``read_batch``, with the sweep
    counted. The refresh rewrite reads run files this way."""
    sweeps = plan_segment_reads([path])
    if not sweeps:
        return read_batch(path, columns=columns)
    got = execute_segment_reads(sweeps, columns=columns)
    parts = [got[(sweeps[0].path, b)] for b, _lo, _hi in sweeps[0].segments]
    if len(parts) == 1:
        return parts[0]
    # bucket segments of one run share the file's vocab objects, so the
    # concat's re-encode changes no code; order == row order
    return ColumnarBatch.concat(parts)


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
