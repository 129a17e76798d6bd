"""HBM-resident index columns: pay the upload once, answer every filter
with one fused pass over the device.

Counterpart of the plain tier of ``hyperspace_tpu.exec.hbm_cache``. Index
files are immutable (every version is a new ``v__=k`` directory and every
file name embeds a uuid), so uploading an index version's predicate
columns is a once-per-version cost. The per-file scan pays per query: a
``stat``/``open`` per file, and two small host→device copies plus the
columns' upload per mask launch. The resident query protocol instead:

1. keeps the predicate columns on the device as flat int32 planes,
   concatenated across the version's files in path order and zero-padded
   to a multiple of ``BLOCK_ROWS`` (int64 range-narrowed, float32 through
   the order-preserving int32 encoding, float64 as two planes —
   ``ops/floatbits.py`` — and strings as codes into ONE sorted
   table-global vocab that stays on the host for literal binding);
2. evaluates the predicate over the whole table with K1c
   (``ops/kernels.py:predicate_block_counts_tensor``), which writes one
   int32 match count per 8192-row block — the only device→host copy;
3. reads on the host only the blocks that hold matches, re-evaluates the
   predicate there exactly and gathers the output columns
   (``exec/scan.py:_resident_parts``).

Correctness does not rest on the device count: the encodings are
order-preserving and range-checked, so device and host agree on which
blocks hold matches, and the host leg is exact. Pad rows may count (a
zero satisfies ``v <= 10``), exactly as in the reference; the host leg
reads real rows only.

Tables are populated synchronously (``prefetch``) or on first touch
(``note_touch``, a background thread), and LRU-evicted against a byte
budget. The knobs are session conf (``config.ResidencyConf``): ``mode``
auto | off | force, ``budgetMB``, ``minRows``, ``maxBlockFrac``.

Where the reference recovers quietly, this port raises: a CUDA or torch
error on the background thread is kept and raised by the next
``wait_background()`` or ``resident_for()`` on the query thread. A file
that vanished before population is a skip, as in the reference.

Not ported yet: the compressed (bit-packed) and streaming tiers — a table
whose raw planes exceed the budget is refused (``hbm.over_budget_refused``),
as the reference does with its tier ladder closed — delta and join
residency, and the batched and hybrid count programs.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ResidencyConf
from ..exceptions import HyperspaceException
from ..ops import DeviceLike, resolve_device
from ..ops import kernels as K
from ..plan.expr import Expr
from ..storage.columnar import Column, ColumnarBatch, is_string
from ..telemetry.metrics import metrics

BLOCK_ROWS = K.BLOCK_ROWS  # count granularity: 4 B D2H per 8192 rows

_MAX_FAILED_MEMO = 1024  # per-file-version keys; bounded paranoia
# string columns with more combined dictionary entries than this never
# become resident: they are id-like, their global vocab would pin
# unbounded host memory, and dictionary compares stop paying anyway
_MAX_VOCAB = 1 << 22


def vocab_heap_bytes(vocab) -> int:
    """Host-heap estimate of one string dictionary (bytes objects + ~50 B
    of Python overhead per entry); None counts as zero."""
    if vocab is None:
        return 0
    return sum(len(v) + 50 for v in vocab)


def _device(device: DeviceLike) -> torch.device:
    """``resolve_device`` with the card's index made explicit, so tables
    and lookups compare devices exactly and a background thread can
    select the card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _auto_enabled(conf: ResidencyConf, device: torch.device) -> bool:
    """First-touch population: ``force`` on any device, ``auto`` on the
    card only (the reference: on a TPU only), ``off`` never."""
    if conf.mode == "off":
        return False
    return conf.mode == "force" or device.type == "cuda"


@dataclass
class ResidentColumn:
    data: torch.Tensor  # flat int32 (n_pad,) on the table's device
    dtype_str: str  # source dtype
    # 'int' | 'float32' (ordered-i32) | 'string' (global codes) |
    # 'f64' (two-plane ordered-i64: ``data`` = high plane, ``data2`` = low)
    enc: str
    nbytes: int
    # string columns only: the table-GLOBAL sorted vocab the device codes
    # index into (host-side: literals bind against it, it never uploads)
    vocab: Optional[np.ndarray] = None
    data2: Optional[torch.Tensor] = None  # f64 low plane


@dataclass
class ResidentTable:
    """One index version's predicate columns, concatenated across its
    data files in path-sorted order and zero-padded to ``BLOCK_ROWS``."""

    key: tuple  # ((path, size, mtime_ns), ...) sorted by path
    files: List[Tuple[str, int, int]]  # (path, start_row, n_rows)
    n_rows: int
    n_pad: int
    columns: Dict[str, ResidentColumn]
    nbytes: int
    device: torch.device
    # per-BLOCK_ROWS (space_tag, min_vec, max_vec) zone vectors of the
    # numeric columns ("value" = original ints, "f64ord" = ordered-i64):
    # the selectivity gate reads them before any device work
    zones: Dict[str, Tuple[str, np.ndarray, np.ndarray]] = field(
        default_factory=dict
    )
    last_used: float = field(default_factory=time.monotonic)

    def file_span(self, path: str) -> Optional[Tuple[int, int]]:
        for p, start, n in self.files:
            if p == path:
                return start, start + n
        return None


def _file_identity(path: str | Path) -> tuple:
    # os.stat on the string: this runs per file per query from note_touch
    # and resident_for
    p = str(path)
    st = os.stat(p)
    return (p, st.st_size, st.st_mtime_ns)


def _encode_column(col: Column) -> Optional[Tuple[np.ndarray, str]]:
    """(int32 array, encoding) for a resident predicate column, or None
    when the dtype cannot ride the device exactly (strings take the
    global-vocab path, float64 the two-plane path; out-of-range int64 and
    NaN float32 refuse). The narrowing is ``ops.kernels``'s, so there is
    one narrowing contract for literals and data."""
    a = col.data
    if is_string(col.dtype_str) or col.dtype_str == "float64":
        return None
    narrowed = K.narrow_arrays_to_i32({"c": a})
    if narrowed is None:
        return None
    return narrowed["c"], ("float32" if a.dtype == np.float32 else "int")


def _block_zones(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-BLOCK_ROWS (min, max) vectors of ``a``."""
    idx = np.arange(0, len(a), BLOCK_ROWS)
    return np.minimum.reduceat(a, idx), np.maximum.reduceat(a, idx)


def zone_block_fraction(
    table: ResidentTable, predicate: Expr
) -> Optional[float]:
    """Upper bound on the fraction of blocks the predicate can match, from
    the zone vectors and the predicate's per-column bounds — or None when
    no bounded column carries zones (no information; caller dispatches).
    Exact-conservative: a block is excluded only when NO row in it can
    satisfy the AND of the bounds."""
    import math

    from ..ops.floatbits import f64_to_ordered_i64
    from ..plan.expr import bounds_for_column

    cand: Optional[np.ndarray] = None
    for c in sorted(predicate.columns()):
        z = table.zones.get(c)
        if z is None:
            continue
        space, zlo, zhi = z
        lo, hi = bounds_for_column(predicate, c)
        if lo is None and hi is None:
            continue
        # NaN bounds carry no information (NaN never compares true)
        if (lo is not None and math.isnan(lo)) or (
            hi is not None and math.isnan(hi)
        ):
            continue
        if space == "f64ord":

            def enc(v, toward):
                f = np.float64(v)
                # a rounded literal rounds OUTWARD so the bound stays
                # conservative (int literals beyond 2^53)
                if (toward < 0 and f > v) or (toward > 0 and f < v):
                    f = np.nextafter(f, toward * np.inf)
                return int(f64_to_ordered_i64(np.array([f]))[0])

            lo = enc(lo, -1) if lo is not None else None
            hi = enc(hi, +1) if hi is not None else None
        else:  # integer value space: round finite float bounds inward
            if lo is not None and math.isfinite(lo):
                lo = math.ceil(lo)
            if hi is not None and math.isfinite(hi):
                hi = math.floor(hi)
        ok = np.ones(len(zlo), dtype=bool)
        if lo is not None:
            ok &= zhi >= lo
        if hi is not None:
            ok &= zlo <= hi
        cand = ok if cand is None else (cand & ok)
    if cand is None:
        return None
    return float(np.count_nonzero(cand)) / max(len(cand), 1)


def _encode_f64(a: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(hi, lo) int32 planes of a float64 column through the
    order-preserving i64 encoding, or None for NaN data (encoded NaN would
    order above +inf instead of comparing false)."""
    from ..ops.floatbits import f64_to_ordered_i64, ordered_i64_planes

    a = np.asarray(a)
    if a.dtype != np.float64 or (a.size and np.isnan(a).any()):
        return None
    return ordered_i64_planes(f64_to_ordered_i64(a))


def prepare_resident_predicate(
    columns: Dict[str, ResidentColumn], predicate: Expr
) -> Optional[Tuple[Expr, Tuple[str, ...]]]:
    """Bind string literals against the table-global vocabs, expand f64
    comparisons into two-plane int32 expressions, and narrow every literal
    to int32. Returns (narrowed expr, names) — ``names`` may hold f64
    plane names — or None when the predicate cannot ride the resident
    encodings (the caller routes host)."""
    names = tuple(sorted(predicate.columns()))
    if any(n not in columns for n in names):
        return None
    str_cols = {n: columns[n] for n in names if columns[n].enc == "string"}
    if str_cols:
        from ..plan.expr import bind_string_literals

        shim = ColumnarBatch(
            {
                n: Column(rc.dtype_str, np.empty(0, dtype=np.int32), rc.vocab)
                for n, rc in str_cols.items()
            }
        )
        try:
            predicate = bind_string_literals(predicate, shim)
        except HyperspaceException:  # unbindable shape: route host
            metrics.incr("hbm.predicate_unbindable")
            return None
    f64_cols = {n for n in names if columns[n].enc == "f64"}
    if f64_cols:
        from ..ops.floatbits import expand_f64_predicate

        predicate = expand_f64_predicate(predicate, f64_cols)
        if predicate is None:
            return None
    f32 = {n: "float32" for n in names if columns[n].enc == "float32"}
    narrowed = K.narrow_expr_to_i32(predicate, f32 or None)
    if narrowed is None:
        return None
    return narrowed, tuple(sorted(narrowed.columns()))


def resident_arrays_for(
    columns: Dict[str, ResidentColumn], names: Tuple[str, ...]
) -> List[torch.Tensor]:
    """Device planes for (possibly plane-suffixed) resident names, in
    ``names`` order."""
    out = []
    for n in names:
        if "\x00" in n:
            base, plane = n.split("\x00", 1)
            rc = columns[base]
            out.append(rc.data if plane == "hi" else rc.data2)
        else:
            out.append(columns[n].data)
    return out


def _upload_planes(
    planes: List[np.ndarray], n_pad: int, dev: torch.device
) -> List[torch.Tensor]:
    """Zero-padded int32 device planes of ``planes``. On the card the
    copies leave pinned host memory on a side stream that first waits for
    the current stream (the new planes' memory may have been freed by
    work still queued there), and the side stream is synchronized before
    returning: a registered table never holds a half-written plane."""
    if dev.type == "cpu":
        out = []
        for a in planes:
            t = torch.zeros(n_pad, dtype=torch.int32)
            t[: len(a)] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            out.append(t)
        return out
    side = torch.cuda.Stream(dev)
    outs = [torch.empty(n_pad, dtype=torch.int32, device=dev) for _ in planes]
    side.wait_stream(torch.cuda.current_stream(dev))
    staged = []
    with torch.cuda.stream(side):
        for a, dst in zip(planes, outs):
            host = torch.zeros(n_pad, dtype=torch.int32, pin_memory=True)
            host[: len(a)] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            dst.copy_(host, non_blocking=True)
            staged.append(host)
    side.synchronize()
    return outs


class ResidentCacheBase:
    """Table registry with LRU eviction against the byte budget, the
    pending/failed population memos, the reset epoch, and the background
    threads (joined at exit; their device errors kept for the query
    thread)."""

    def __init__(self) -> None:
        self._tables: List[ResidentTable] = []
        self._pending: set = set()
        # (file-set key, frozenset(columns)) that can never materialize
        # (nothing encodable, too small): without this memo every query
        # over such a set would re-pay a background build's disk IO.
        # File-version identity is in the key, so a new version retries.
        self._failed: set = set()
        self._lock = threading.Lock()
        # bumped by reset(): a background population scheduled before a
        # reset must not register into the fresh registry
        self._epoch = 0
        self._bg_threads: List[threading.Thread] = []
        self._bg_error: Optional[Exception] = None
        self._atexit = False

    def auto_enabled(self, conf: ResidencyConf, device: DeviceLike = None) -> bool:
        """Whether first-touch population is on for ``conf`` on ``device``."""
        return _auto_enabled(conf, _device(device))

    def drop(self, table: ResidentTable) -> None:
        """Unregister a table."""
        with self._lock:
            self._tables = [t for t in self._tables if t is not table]

    def _raise_background_error(self) -> None:
        with self._lock:
            err, self._bg_error = self._bg_error, None
        if err is not None:
            raise err

    def wait_background(self, timeout_s: float = 30.0) -> None:
        """Join in-flight background populations, then raise the first
        device error one of them hit (if any)."""
        with self._lock:
            threads = [t for t in self._bg_threads if t.is_alive()]
        for t in threads:
            t.join(timeout_s)
        self._raise_background_error()

    def _register(
        self, table: ResidentTable, budget: int, epoch: Optional[int] = None
    ) -> None:
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return  # reset() since this build was scheduled
            # replace any table over the same file set (e.g. a widened
            # column set); then evict LRU tables until the budget fits
            self._tables = [t for t in self._tables if t.key != table.key]
            self._tables.append(table)
            while sum(t.nbytes for t in self._tables) > budget and len(self._tables) > 1:
                victim = min(
                    (t for t in self._tables if t is not table),
                    key=lambda t: t.last_used,
                )
                self._tables.remove(victim)
                metrics.incr("hbm.evicted")
            metrics.incr("hbm.tables_registered")

    def _track_for_exit(self, t: threading.Thread) -> None:
        """Join live uploads at interpreter exit, so a daemon thread is
        never cut mid-copy by the runtime's teardown."""
        with self._lock:
            if not self._atexit:
                import atexit

                atexit.register(self._join_bg)
                self._atexit = True
            self._bg_threads[:] = [x for x in self._bg_threads if x.is_alive()]
            self._bg_threads.append(t)

    def _join_bg(self) -> None:
        with self._lock:
            threads = list(self._bg_threads)
        for t in threads:
            t.join(30.0)

    def reset(self) -> None:
        with self._lock:
            self._tables.clear()
            self._pending.clear()
            self._failed.clear()
            self._bg_error = None
            self._epoch += 1

    def snapshot_residency(self) -> dict:
        """Per-table tier, rows, columns and MB (every table is on the raw
        "resident" tier: the compressed and streaming tiers are not
        ported)."""
        with self._lock:
            per = [
                {
                    "tier": "resident",
                    "rows": t.n_rows,
                    "columns": sorted(t.columns),
                    "mb": round(t.nbytes / 1e6, 1),
                    "device": str(t.device),
                }
                for t in self._tables
            ]
        return {"tables": per, "by_tier": {"resident": len(per)} if per else {}}


class HbmIndexCache(ResidentCacheBase):
    """Device-side predicate-column cache over immutable TCB index files,
    LRU-bounded by a byte budget."""

    # -- population ----------------------------------------------------------
    def prefetch(
        self,
        files: List[str | Path],
        columns: List[str],
        device: DeviceLike = None,
        conf: ResidencyConf = ResidencyConf(),
    ) -> Optional[ResidentTable]:
        """Synchronously build and register a resident table for ``files``
        × ``columns`` on ``device``. Returns the table, or None when no
        column is encodable or the planes exceed the budget. Idempotent:
        an existing covering table is returned untouched."""
        dev = _device(device)
        paths = sorted(str(p) for p in files)
        if not paths:
            return None
        try:
            key = tuple(_file_identity(p) for p in paths)
        except OSError:
            return None
        with self._lock:
            existing = self._covering_locked(
                {k[0]: k for k in key}, set(columns), dev
            )
            if existing is not None:
                return existing
        try:
            table, _ = self._build(paths, key, columns, dev, conf)
        except OSError:  # a file vanished: no residency
            metrics.incr("hbm.prefetch_read_error")
            return None
        if table is None:
            return None
        self._register(table, conf.budget_bytes)
        return table

    def note_touch(
        self,
        files: List[str | Path],
        columns: List[str],
        device: DeviceLike = None,
        conf: ResidencyConf = ResidencyConf(),
        n_rows_hint: Optional[int] = None,
    ) -> None:
        """First-touch population, called by the scan on the per-file
        path: schedules a background upload of this file set's predicate
        columns so repeat queries take the resident path. Never blocks;
        no-ops when population is off for ``conf`` on ``device``, the set
        is too small, already resident or pending, or a previous attempt
        proved it can never materialize. With ``n_rows_hint=None`` the
        row-count floor is checked on the background thread."""
        dev = _device(device)
        if not _auto_enabled(conf, dev) or not files or not columns:
            return
        if n_rows_hint is not None and n_rows_hint < conf.min_rows:
            return
        paths = sorted(str(p) for p in files)
        try:
            key = tuple(_file_identity(p) for p in paths)
        except OSError:
            return
        memo = (key, frozenset(columns))
        with self._lock:
            if key in self._pending or memo in self._failed:
                return
            if self._covering_locked({k[0]: k for k in key}, set(columns), dev):
                return
            self._pending.add(key)
            epoch = self._epoch

        def bg():
            failed = False  # PERMANENT failure only (memoized per version)
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                if n_rows_hint is None:
                    from ..storage import layout

                    total = sum(layout.cached_reader(p).num_rows for p in paths)
                    if total < conf.min_rows:
                        failed = True
                        return
                # widen rather than replace: a table already resident for
                # this file set keeps its columns, so predicates over
                # alternating column sets converge on one union table
                with self._lock:
                    prior = next((t for t in self._tables if t.key == key), None)
                build_cols = list(
                    dict.fromkeys(
                        list(columns) + (sorted(prior.columns) if prior else [])
                    )
                )
                table, permanent = self._build(paths, key, build_cols, dev, conf)
                if table is not None and set(columns) <= set(table.columns):
                    self._register(table, conf.budget_bytes, epoch=epoch)
                elif table is not None or permanent:
                    # a partly encodable table could never serve this
                    # predicate; budget and IO refusals stay retryable
                    failed = True
            except OSError:  # a file vanished mid-population: skip
                metrics.incr("hbm.prefetch_read_error")
            except Exception as e:  # noqa: BLE001 - kept, raised on the query thread
                metrics.incr("hbm.populate_failed")
                with self._lock:
                    if epoch == self._epoch and self._bg_error is None:
                        self._bg_error = e
            finally:
                with self._lock:
                    self._pending.discard(key)
                    if failed:
                        if len(self._failed) >= _MAX_FAILED_MEMO:
                            self._failed.clear()
                        self._failed.add(memo)

        t = threading.Thread(target=bg, daemon=True, name="hbm-cache-populate")
        self._track_for_exit(t)
        t.start()

    def _build(
        self,
        paths: List[str],
        key: tuple,
        columns: List[str],
        dev: torch.device,
        conf: ResidencyConf,
    ) -> Tuple[Optional[ResidentTable], bool]:
        """(table, permanent_refusal). ``permanent_refusal`` marks
        structural conditions of this file version (nothing encodable,
        empty); budget refusals are not permanent (the budget is a knob).
        An OSError (a vanished file) propagates to the caller."""
        from ..storage import layout
        from ..storage.columnar import unify_dictionaries

        t0 = time.perf_counter()
        readers = [layout.cached_reader(p) for p in paths]
        spans: List[Tuple[str, int, int]] = []
        start = 0
        for p, r in zip(paths, readers):
            spans.append((str(p), start, r.num_rows))
            start += r.num_rows
        n_rows = start
        if n_rows == 0:
            return None, True
        n_pad = -(-n_rows // BLOCK_ROWS) * BLOCK_ROWS
        dtype_of = {m["name"]: m["dtype"] for m in readers[0].footer["columns"]}
        encodable = [c for c in columns if c in dtype_of]
        if not encodable:
            return None, True
        # budget pre-check BEFORE any read or upload: every resident plane
        # costs n_pad * 4 device bytes (float64 two planes); string columns
        # add their host vocab heap, bounded by the per-file footers
        vocab_est = 0
        for c in encodable:
            if is_string(dtype_of[c]):
                for r in readers:
                    m = next((x for x in r.footer["columns"] if x["name"] == c), None)
                    if m is not None:
                        vocab_est += vocab_heap_bytes(m.get("vocab", ()))
        planes = sum(2 if dtype_of[c] == "float64" else 1 for c in encodable)
        if planes * n_pad * 4 + vocab_est > conf.budget_bytes:
            metrics.incr("hbm.over_budget_refused")
            return None, False

        # --- encode: host planes only, no uploads yet ----------------------
        # name -> (dtype_str, enc, vocab, [plane arrays of n_rows values])
        host_planes: Dict[str, tuple] = {}
        zones: Dict[str, Tuple[str, np.ndarray, np.ndarray]] = {}
        for name in encodable:
            metas = [
                next((m for m in r.footer["columns"] if m["name"] == name), None)
                for r in readers
            ]
            if any(m is None for m in metas):
                continue
            if is_string(dtype_of[name]):
                # per-file dictionaries would collide across the
                # concatenated table: re-encode every file onto ONE sorted
                # global vocab (order-preserving; NULL -1 survives)
                if not all(is_string(m["dtype"]) for m in metas):
                    continue  # mixed dtypes across files: refuse
                if sum(len(m.get("vocab", ())) for m in metas) > _MAX_VOCAB:
                    metrics.incr("hbm.vocab_too_large_refused")
                    continue
                raw = [r.read([name]).columns[name] for r in readers]
                unified = unify_dictionaries(raw)
                vocab = next((u.vocab for u in unified if u.vocab is not None), None)
                if vocab is None:
                    continue
                flat = np.concatenate([u.data.astype(np.int32, copy=False) for u in unified])
                host_planes[name] = (dtype_of[name], "string", vocab, [flat])
            elif dtype_of[name] == "float64":
                encs = [_encode_f64(r.read([name]).columns[name].data) for r in readers]
                if any(e is None for e in encs):
                    continue  # NaN data (or dtype drift): refuse
                flat_hi = np.concatenate([e[0] for e in encs])
                flat_lo = np.concatenate([e[1] for e in encs])
                # zone vectors in ordered-i64 space (monotone with the
                # float order, so bound compares are exact-conservative)
                ordered = (flat_hi.astype(np.int64) << 32) | (
                    np.bitwise_xor(flat_lo.view(np.uint32), np.uint32(0x80000000))
                    .astype(np.int64)
                )
                zones[name] = ("f64ord", *_block_zones(ordered))
                host_planes[name] = ("float64", "f64", None, [flat_hi, flat_lo])
            else:
                encs = [_encode_column(r.read([name]).columns[name]) for r in readers]
                if any(e is None for e in encs) or len({e[1] for e in encs}) != 1:
                    continue  # unencodable, or mixed encodings across files
                flat = np.concatenate([e[0] for e in encs])
                enc = encs[0][1]
                if enc == "int":
                    # int narrowing is value-preserving: the i32 plane IS
                    # the original value space for zone compares
                    zones[name] = ("value", *_block_zones(flat))
                host_planes[name] = (dtype_of[name], enc, None, [flat])
        if not host_planes:
            return None, True  # nothing encoded (e.g. NaN float32 data)

        # --- upload ---------------------------------------------------------
        order = list(host_planes)
        device_planes = iter(
            _upload_planes(
                [a for n in order for a in host_planes[n][3]], n_pad, dev
            )
        )
        cols: Dict[str, ResidentColumn] = {}
        nbytes = 0
        for name in order:
            dts, enc, vocab, arrs = host_planes[name]
            data = next(device_planes)
            data2 = next(device_planes) if len(arrs) == 2 else None
            col_bytes = len(arrs) * n_pad * 4 + vocab_heap_bytes(vocab)
            cols[name] = ResidentColumn(data, dts, enc, col_bytes, vocab, data2)
            nbytes += col_bytes
        if nbytes > conf.budget_bytes:
            metrics.incr("hbm.over_budget_refused")
            return None, False
        metrics.record_time("hbm.prefetch", time.perf_counter() - t0)
        return ResidentTable(key, spans, n_rows, n_pad, cols, nbytes, dev, zones), False

    # -- lookup --------------------------------------------------------------
    def _covering_locked(
        self, want_files: dict, want_cols: set, dev: torch.device
    ) -> Optional[ResidentTable]:
        for t in reversed(self._tables):
            if t.device != dev:
                continue
            have = {k[0]: k for k in t.key}
            if all(
                p in have and have[p] == ident for p, ident in want_files.items()
            ) and want_cols <= set(t.columns):
                return t
        return None

    def resident_for(
        self,
        files: List[str | Path],
        columns: List[str],
        device: DeviceLike = None,
        conf: ResidencyConf = ResidencyConf(),
    ) -> Optional[ResidentTable]:
        """A registered table on ``device`` covering every file in
        ``files`` (by path + size + mtime identity — stale versions never
        match) with every column in ``columns``, else None. Mode "off"
        disables serving too, not only population. Raises a device error
        a background population hit."""
        self._raise_background_error()
        if not files or conf.mode == "off":
            return None
        dev = _device(device)
        with self._lock:
            if not self._tables:
                return None  # nothing resident: skip the per-file stats
        try:
            want = {str(p): _file_identity(p) for p in files}
        except OSError:
            return None
        with self._lock:
            t = self._covering_locked(want, set(columns), dev)
            if t is not None:
                t.last_used = time.monotonic()
            return t

    # -- the resident query --------------------------------------------------
    def block_counts(
        self, table: ResidentTable, predicate: Expr
    ) -> Optional[np.ndarray]:
        """Per-BLOCK_ROWS match counts of ``predicate`` over the resident
        table: K1c on the card (its plain version on the CPU), one
        count-vector-sized copy home. None when the predicate does not
        narrow to the resident encodings (the caller routes host)."""
        prepared = prepare_resident_predicate(table.columns, predicate)
        if prepared is None:
            return None
        narrowed, names = prepared
        cols = resident_arrays_for(table.columns, names)
        t0 = time.perf_counter()
        counts = K.predicate_block_counts_tensor(narrowed, names, cols).cpu().numpy()
        metrics.record_time("scan.resident.device", time.perf_counter() - t0)
        n_blocks = -(-table.n_rows // BLOCK_ROWS)
        metrics.incr("scan.resident.d2h_bytes", int(counts.nbytes))
        return counts[:n_blocks]


hbm_cache = HbmIndexCache()
