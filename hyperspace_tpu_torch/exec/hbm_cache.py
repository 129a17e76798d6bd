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

A table whose raw planes exceed the budget goes down the tier ladder
(``residency/tiers.py:plan_tier``): ``compressed`` keeps plain-packed
words on the device (``ops/bitpack.py``; pad rows encode ``ref0``) and
counts through K1p, which decodes in registers; ``streaming`` keeps the
planes in pinned host memory and counts window by window through a pair
of device slabs (``residency/streaming.py``); ``host`` refuses
(``hbm.over_budget_refused``). ``block_counts`` dispatches on the tier.

Delta residency serves Hybrid Scan between refreshes: a ``DeltaRegion``
holds the appended source files' predicate columns on the device, encoded
under the resident base's contracts (``exec/delta.py``), their rows on
the host (decoded once), and a deletion mask of one bit per base row
from the lineage column. ``hybrid_block_counts`` counts base and delta in
one K1h launch; ``delta_parts`` is the delta's exact host leg. Under
budget pressure deltas go before tables; dropping a base drops its
deltas; a refresh or optimize of the index invalidates them
(``invalidate_deltas``).

Tables and deltas are populated synchronously (``prefetch``,
``prefetch_delta``) or on first touch (``note_touch``,
``note_touch_delta``, background threads), and LRU-evicted against a byte
budget. The knobs are session conf (``config.ResidencyConf``): ``mode``
auto | off | force, ``budgetMB``, ``minRows``, ``maxBlockFrac``, and the
ladder's ``compression``, ``streaming`` and ``window_rows``.

Where the reference recovers quietly, this port raises: a CUDA or torch
error on a background thread is kept and raised by the next
``wait_background()`` or ``resident_for()`` on the query thread, and one
in a window loop or a hybrid launch raises on the query thread. A file
that vanished before population is a skip, as in the reference.

Not ported yet: join residency, and the batched count programs of the
serving layer.
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
from ..ops.bitpack import PackSpec
from ..plan.expr import Expr, eval_mask
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


def _budget_bytes(conf: ResidencyConf) -> int:
    """The residency budget less what streaming builds hold for their
    staged runs (residency.slabs) and what budget claimants hold
    (residency.tiers): every budget site sees the true headroom. Builds
    hold at most half, so this stays positive."""
    from ..residency.slabs import held_bytes
    from ..residency.tiers import claimant_bytes

    return conf.budget_bytes - held_bytes() - claimant_bytes()


def batch_nbytes(batch: ColumnarBatch) -> int:
    """Host bytes of a batch, its string dictionaries included."""
    return sum(c.data.nbytes + vocab_heap_bytes(c.vocab) for c in batch.columns.values())


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
    # compressed tier only: ``data`` holds plain-packed int32 words under
    # this spec, and the budget is charged the packed bytes
    pack: Optional[PackSpec] = None


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
    # the ladder's rung: "resident" (raw planes) or "compressed" (packed
    # planes); the streaming tier has a table type of its own
    # (residency/streaming.py)
    tier: str = "resident"
    raw_nbytes: int = 0  # what the planes would cost raw

    def file_span(self, path: str) -> Optional[Tuple[int, int]]:
        for p, start, n in self.files:
            if p == path:
                return start, start + n
        return None


@dataclass
class DeltaRegion:
    """Appended-source residency for one (index version, source snapshot):
    the appended files' predicate columns as device int32 planes encoded
    under the base table's contracts (``exec/delta.py``), their rows on
    the host (decoded once, so a query's host leg reads memory), the
    string columns' out-of-vocabulary side tables, the deletion mask over
    the base rows (``ops/kernels.py:pack_row_bitmask`` words, one bit a
    row; None without deletes), and per-block zone vectors for the
    delta-aware selectivity gate."""

    key: tuple  # ((name, size, mtime), ...) of the appended files, sorted
    base_key: tuple  # the ResidentTable.key this delta extends
    deleted_ids: tuple  # sorted lineage ids of the deleted source files
    n_rows: int
    n_pad: int
    columns: Dict[str, ResidentColumn]
    oov: Dict[str, np.ndarray]  # per string column: sorted OOV values
    host_batch: ColumnarBatch  # the appended rows (user columns)
    del_mask: Optional[torch.Tensor]  # int32 words over the base's n_pad rows
    zones: Dict[str, Tuple[str, np.ndarray, np.ndarray]] = field(default_factory=dict)
    nbytes: int = 0
    last_used: float = field(default_factory=time.monotonic)


def delta_snapshot_key(appended) -> tuple:
    """The source-snapshot half of a delta's key, from the appended
    FileInfos of the hybrid plan: a file appended or replaced since gives
    another key, and the stale delta never serves."""
    return tuple(sorted((f.name, int(f.size), int(f.modified_time)) for f in appended))


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


def resident_specs_for(
    columns: Dict[str, ResidentColumn], names: Tuple[str, ...]
) -> List[Optional[PackSpec]]:
    """Per-name PackSpec (None for a raw plane), aligned with
    ``resident_arrays_for`` (f64 planes always ride raw)."""
    return [None if "\x00" in n else columns[n].pack for n in names]


def _upload_planes(
    planes: List[np.ndarray], lengths: List[int], dev: torch.device
) -> List[torch.Tensor]:
    """Zero-padded int32 device planes of ``planes``, plane i ``lengths[i]``
    long. On the card the copies leave pinned host memory on a side stream
    that first waits for the current stream (the new planes' memory may
    have been freed by work still queued there), and the side stream is
    synchronized before returning: a registered table never holds a
    half-written plane."""
    if dev.type == "cpu":
        out = []
        for a, n in zip(planes, lengths):
            t = torch.zeros(n, dtype=torch.int32)
            t[: len(a)] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            out.append(t)
        return out
    side = torch.cuda.Stream(dev)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for n in lengths]
    side.wait_stream(torch.cuda.current_stream(dev))
    staged = []
    with torch.cuda.stream(side):
        for a, n, dst in zip(planes, lengths, outs):
            host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
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
        # delta regions, one per base at most (the hybrid scan's appended
        # side); under budget pressure they go before any table
        self._deltas: List[DeltaRegion] = []
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

    def empty(self) -> bool:
        """True when no table is resident: callers skip pruning and stat
        work that could only reach a lookup miss."""
        with self._lock:
            return not self._tables

    def drop(self, table: ResidentTable) -> None:
        """Unregister a table; the deltas built over it go with it (no
        query could reach them without their base)."""
        with self._lock:
            self._tables = [t for t in self._tables if t is not table]
            self._deltas = [d for d in self._deltas if d.base_key != table.key]

    def invalidate_deltas(self, index_root: Optional[str] = None) -> None:
        """Drop the delta regions whose base files lie under ``index_root``
        (None: all). The refresh and optimize hook: a new index version
        changes the base's file identities, so those deltas could never
        serve again. A quick refresh changes no index file and keeps
        them."""
        prefix = None if index_root is None else str(index_root).rstrip("/") + "/"
        with self._lock:
            keep = [
                d for d in self._deltas
                if prefix is not None
                and not any(str(p).startswith(prefix) for p, _sz, _mt in d.base_key)
            ]
            n = len(self._deltas) - len(keep)
            self._deltas[:] = keep
        if n:
            metrics.incr("hbm.delta.invalidated", n)

    def _total_locked(self) -> int:
        return sum(t.nbytes for t in self._tables) + sum(d.nbytes for d in self._deltas)

    def _register_delta(self, delta: DeltaRegion, budget: int,
                        epoch: Optional[int] = None) -> bool:
        """Register a delta under the shared budget: it supersedes any
        other delta of its base, evicts other bases' deltas if it must,
        and is refused rather than evict a table."""
        from ..residency.tiers import shed_claimants

        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return False  # reset() since this build was scheduled
            if not any(t.key == delta.base_key for t in self._tables):
                # the base went while this build ran: unreachable
                metrics.incr("hbm.delta.base_gone")
                return False
            for d in self._deltas:
                if d.base_key == delta.base_key and (
                    d.key != delta.key or d.deleted_ids != delta.deleted_ids
                ):
                    metrics.incr("hbm.delta.superseded")
            self._deltas = [d for d in self._deltas if d.base_key != delta.base_key]
            self._deltas.append(delta)
            if self._total_locked() > budget:
                budget += shed_claimants(self._total_locked() - budget)
            while self._total_locked() > budget and len(self._deltas) > 1:
                victim = min((d for d in self._deltas if d is not delta),
                             key=lambda d: d.last_used)
                self._deltas.remove(victim)
                metrics.incr("hbm.delta.evicted")
            if self._total_locked() > budget:
                self._deltas.remove(delta)
                metrics.incr("hbm.delta.over_budget_refused")
                return False
            metrics.incr("hbm.delta.registered")
            return True

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
        from ..residency.tiers import shed_claimants

        with self._lock:
            if epoch is not None and epoch != self._epoch:
                return  # reset() since this build was scheduled
            # replace any table over the same file set (e.g. a widened
            # column set); then claimants shed, deltas go, and LRU tables
            # (each with its deltas) until the budget fits
            self._tables = [t for t in self._tables if t.key != table.key]
            self._tables.append(table)
            if self._total_locked() > budget:
                budget += shed_claimants(self._total_locked() - budget)
            while self._total_locked() > budget and self._deltas:
                self._deltas.remove(min(self._deltas, key=lambda d: d.last_used))
                metrics.incr("hbm.delta.evicted")
            while self._total_locked() > budget and len(self._tables) > 1:
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
            self._deltas.clear()
            self._pending.clear()
            self._failed.clear()
            self._bg_error = None
            self._epoch += 1

    def snapshot_residency(self) -> dict:
        """The tier ladder's surface: each table's tier, rows, columns,
        budget-charged MB beside its raw MB, and a streaming table's
        windows; and the count of tables by tier."""
        with self._lock:
            per = []
            for t in self._tables:
                row = {
                    "tier": t.tier,
                    "rows": t.n_rows,
                    "columns": sorted(t.columns),
                    "mb": round(t.nbytes / 1e6, 1),
                    "device": str(t.device),
                }
                if t.raw_nbytes:
                    row["raw_mb"] = round(t.raw_nbytes / 1e6, 1)
                if t.tier == "streaming":
                    row.update(windows=t.n_windows, window_rows=t.window_rows,
                               host_mb=round(t.host_bytes / 1e6, 1))
                per.append(row)
        tiers: Dict[str, int] = {}
        for row in per:
            tiers[row["tier"]] = tiers.get(row["tier"], 0) + 1
        return {"tables": per, "by_tier": tiers}

    def snapshot(self) -> dict:
        """Tables and deltas held, and their MB."""
        with self._lock:
            return {
                "tables": len(self._tables),
                "deltas": len(self._deltas),
                "resident_mb": round(self._total_locked() / 1e6, 1),
                "per_table": [
                    {"files": len(t.files), "rows": t.n_rows, "columns": sorted(t.columns),
                     "mb": round(t.nbytes / 1e6, 1), "tier": t.tier}
                    for t in self._tables
                ],
                "per_delta": [
                    {"rows": d.n_rows, "columns": sorted(d.columns),
                     "deleted_ids": len(d.deleted_ids),
                     "oov": {k: int(len(v)) for k, v in d.oov.items() if len(v)},
                     "mb": round(d.nbytes / 1e6, 1)}
                    for d in self._deltas
                ],
            }


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
        self._register(table, _budget_bytes(conf))
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
                    self._register(table, _budget_bytes(conf), epoch=epoch)
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
        # budget pre-check BEFORE any read or upload: every raw plane costs
        # n_pad * 4 device bytes (float64 two planes); string columns add
        # their host vocab heap, bounded by the per-file footers. Over the
        # budget it refuses here only when the tier ladder is closed
        vocab_est = 0
        for c in encodable:
            if is_string(dtype_of[c]):
                for r in readers:
                    m = next((x for x in r.footer["columns"] if x["name"] == c), None)
                    if m is not None:
                        vocab_est += vocab_heap_bytes(m.get("vocab", ()))
        planes = sum(2 if dtype_of[c] == "float64" else 1 for c in encodable)
        ladder_open = conf.compression != "off" or conf.streaming != "off"
        if planes * n_pad * 4 + vocab_est > _budget_bytes(conf) and not ladder_open:
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

        # --- tier plan: the one ladder procedure (residency/tiers.py) -------
        from ..ops import bitpack
        from ..residency import plan_tier

        pack_specs: Dict[str, PackSpec] = {}
        raw_plane_bytes = unpacked_bytes = side_bytes = 0
        for name, (_dts, _enc, vocab, arrs) in host_planes.items():
            side_bytes += vocab_heap_bytes(vocab)
            raw_plane_bytes += len(arrs) * n_pad * 4
            spec = None
            if len(arrs) == 1 and arrs[0].size:
                spec = bitpack.pack_spec(int(arrs[0].min()), int(arrs[0].max()), n_pad)
            if spec is not None:
                pack_specs[name] = spec
            else:
                unpacked_bytes += len(arrs) * n_pad * 4
        plan = plan_tier(raw_plane_bytes, _budget_bytes(conf), pack_specs, unpacked_bytes,
                         side_bytes, streaming_ok=True, conf=conf)
        if plan.tier == "host":
            metrics.incr("hbm.over_budget_refused")
            return None, False
        if plan.tier == "streaming":
            from ..residency.streaming import build_streaming_table

            table = build_streaming_table(key, spans, n_rows, host_planes, zones, plan.specs,
                                          plan.window_rows, dev)
            if table.nbytes > _budget_bytes(conf):
                # even the slab pair does not fit: no device tier
                metrics.incr("hbm.over_budget_refused")
                return None, False
            metrics.incr("residency.tier.streaming_built")
            metrics.record_time("hbm.prefetch", time.perf_counter() - t0)
            return table, False

        # --- upload: raw planes, or packed words (pad rows encode ref0) -----
        order = list(host_planes)
        uploads: List[np.ndarray] = []
        lengths: List[int] = []
        for name in order:
            spec = plan.specs.get(name)
            if spec is not None:
                padded = np.full(n_pad, spec.ref0, dtype=np.int64)
                padded[:n_rows] = host_planes[name][3][0]
                uploads.append(bitpack.pack_plain(padded, spec))
                lengths.append(spec.n_words)
            else:
                uploads.extend(host_planes[name][3])
                lengths.extend([n_pad] * len(host_planes[name][3]))
        device_planes = iter(_upload_planes(uploads, lengths, dev))
        cols: Dict[str, ResidentColumn] = {}
        nbytes = 0
        for name in order:
            dts, enc, vocab, arrs = host_planes[name]
            spec = plan.specs.get(name)
            data = next(device_planes)
            data2 = next(device_planes) if len(arrs) == 2 else None
            plane_bytes = 4 * spec.n_words if spec is not None else len(arrs) * n_pad * 4
            col_bytes = plane_bytes + vocab_heap_bytes(vocab)
            cols[name] = ResidentColumn(data, dts, enc, col_bytes, vocab, data2, spec)
            nbytes += col_bytes
        if nbytes > _budget_bytes(conf):
            metrics.incr("hbm.over_budget_refused")
            return None, False
        raw_nbytes = raw_plane_bytes + side_bytes
        if plan.tier == "compressed":
            metrics.incr("residency.tier.compressed_built")
            metrics.incr("residency.compressed.packed_bytes", nbytes)
            metrics.incr("residency.compressed.raw_bytes", raw_nbytes)
        metrics.record_time("hbm.prefetch", time.perf_counter() - t0)
        return ResidentTable(key, spans, n_rows, n_pad, cols, nbytes, dev, zones,
                             tier=plan.tier, raw_nbytes=raw_nbytes), False

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
        table, one count-vector-sized copy home: K1c over raw planes, K1p
        where a plane the predicate reads is packed (their plain versions
        on the CPU), and a streaming table's window loop. None when the
        predicate does not narrow to the resident encodings (the caller
        routes host)."""
        if table.tier == "streaming":
            from ..residency.streaming import stream_block_counts

            return stream_block_counts(table, predicate)
        prepared = prepare_resident_predicate(table.columns, predicate)
        if prepared is None:
            return None
        narrowed, names = prepared
        cols = resident_arrays_for(table.columns, names)
        specs = resident_specs_for(table.columns, names)
        t0 = time.perf_counter()
        if any(s is not None for s in specs):
            counts = K.predicate_block_counts_packed_tensor(
                narrowed, names, cols, specs, table.n_pad
            )
        else:
            counts = K.predicate_block_counts_tensor(narrowed, names, cols)
        counts = counts.cpu().numpy()
        metrics.record_time("scan.resident.device", time.perf_counter() - t0)
        n_blocks = -(-table.n_rows // BLOCK_ROWS)
        metrics.incr("scan.resident.d2h_bytes", int(counts.nbytes))
        return counts[:n_blocks]

    # -- delta residency (the hybrid scan's appended side) --------------------
    def delta_for(
        self, table: ResidentTable, appended, columns, deleted_ids,
        conf: ResidencyConf = ResidencyConf(),
    ) -> Optional[DeltaRegion]:
        """The registered delta extending ``table`` for exactly this
        (appended snapshot, deleted ids) with every column of ``columns``,
        else None. Mode "off" disables serving here too."""
        if conf.mode == "off":
            return None
        dkey = delta_snapshot_key(appended)
        dels = tuple(sorted(int(i) for i in deleted_ids))
        with self._lock:
            for d in reversed(self._deltas):
                if (d.base_key == table.key and d.key == dkey and d.deleted_ids == dels
                        and set(columns) <= set(d.columns)):
                    d.last_used = time.monotonic()
                    return d
        return None

    def prefetch_delta(
        self, table: ResidentTable, appended, relation, host_columns, deleted_ids,
        conf: ResidencyConf = ResidencyConf(),
    ) -> Optional[DeltaRegion]:
        """Synchronously build and register a delta region. Idempotent; a
        delta built against a narrower base is rebuilt with the wider
        column set."""
        want = [c for c in host_columns if c in table.columns]
        existing = self.delta_for(table, appended, want, deleted_ids, conf)
        if existing is not None:
            return existing
        delta, _ = self._build_delta(table, appended, relation, host_columns, deleted_ids,
                                     conf)
        if delta is None or not self._register_delta(delta, _budget_bytes(conf)):
            return None
        return delta

    def note_touch_delta(
        self, table: ResidentTable, appended, relation, host_columns, deleted_ids,
        conf: ResidencyConf = ResidencyConf(),
    ) -> None:
        """First-touch delta population: a background upload of the
        appended files' predicate columns and the deletion mask, so repeat
        hybrid queries take the K1h path. Never blocks; no row floor (a
        delta is small, and its base being resident shows the table is
        worth the device). A device error is kept for the query thread."""
        if not _auto_enabled(conf, table.device) or not appended:
            return
        dkey = delta_snapshot_key(appended)
        dels = tuple(sorted(int(i) for i in deleted_ids))
        want = {c for c in host_columns if c in table.columns}
        memo = ("delta", table.key, dkey, dels)
        with self._lock:
            if memo in self._pending or memo in self._failed:
                return
            if any(d.base_key == table.key and d.key == dkey and d.deleted_ids == dels
                   and want <= set(d.columns) for d in self._deltas):
                return
            self._pending.add(memo)
            epoch = self._epoch

        def bg():
            failed = False
            try:
                if table.device.type == "cuda":
                    torch.cuda.set_device(table.device)
                delta, permanent = self._build_delta(
                    table, appended, relation, host_columns, deleted_ids, conf
                )
                if delta is not None:
                    self._register_delta(delta, _budget_bytes(conf), epoch=epoch)
                    # a delta that could not encode part of ``want`` never
                    # will for this epoch: no rebuild on every query
                    failed = not want <= set(delta.columns)
                else:
                    failed = permanent
            except OSError:  # an appended file vanished: skip
                metrics.incr("hbm.delta.read_error")
            except Exception as e:  # noqa: BLE001 - kept, raised on the query thread
                metrics.incr("hbm.delta.populate_failed")
                with self._lock:
                    if epoch == self._epoch and self._bg_error is None:
                        self._bg_error = e
            finally:
                with self._lock:
                    self._pending.discard(memo)
                    if failed:
                        if len(self._failed) >= _MAX_FAILED_MEMO:
                            self._failed.clear()
                        self._failed.add(memo)

        t = threading.Thread(target=bg, daemon=True, name="hbm-delta-populate")
        self._track_for_exit(t)
        t.start()

    def _build_delta(
        self, table: ResidentTable, appended, relation, host_columns, deleted_ids,
        conf: ResidencyConf,
    ) -> Tuple[Optional[DeltaRegion], bool]:
        """(delta, permanent_refusal): one decode of the appended files
        (what the host union pays per query), the base-covered predicate
        columns encoded under the base's contracts and uploaded, and the
        deletion mask from the base files' lineage column."""
        from .. import constants as C
        from ..storage import layout, parquet_io
        from .delta import encode_delta_columns

        if table.tier != "resident":
            # K1h reads the base's raw planes: a compressed or streaming
            # base cannot anchor a delta
            metrics.incr("hbm.delta.declined.tier")
            return None, True
        t0 = time.perf_counter()
        dels = tuple(sorted(int(i) for i in deleted_ids))
        with self._lock:
            headroom = _budget_bytes(conf) - sum(t.nbytes for t in self._tables)
        # the appended files' sizes bound the decoded batch from below: with
        # no headroom the build refuses before paying the decode
        if sum(int(f.size) for f in appended) > headroom:
            metrics.incr("hbm.delta.over_budget_refused")
            return None, False
        host_batch = parquet_io.read_relation(
            relation, paths=[f.name for f in appended], columns=list(host_columns)
        )
        n_rows = host_batch.num_rows
        if n_rows == 0:
            return None, True
        n_pad = -(-n_rows // BLOCK_ROWS) * BLOCK_ROWS
        if dels:
            # deletes without a readable lineage column can never serve
            for path, _start, _n in table.files:
                names = {m["name"] for m in layout.cached_reader(path).footer["columns"]}
                if C.DATA_FILE_NAME_ID not in names:
                    metrics.incr("hbm.delta.no_lineage_refused")
                    return None, True
        flats, encs, oov, planes, zones = encode_delta_columns(
            host_batch, table.columns, with_zones=True
        )
        if not flats:
            return None, True
        host_bytes = batch_nbytes(host_batch)
        oov_bytes = sum(vocab_heap_bytes(side) for side in oov.values())
        mask_bytes = table.n_pad // 8 if dels else 0
        dev_bytes = planes * n_pad * 4 + mask_bytes
        with self._lock:
            headroom = _budget_bytes(conf) - sum(t.nbytes for t in self._tables)
        if dev_bytes + host_bytes + oov_bytes > headroom:
            metrics.incr("hbm.delta.over_budget_refused")
            return None, False
        order = list(flats)
        uploads: List[np.ndarray] = []
        for name in order:
            uploads.extend(flats[name] if encs[name][1] == "f64" else [flats[name]])
        lengths = [n_pad] * len(uploads)
        if dels:
            t_mask = time.perf_counter()
            uploads.append(K.pack_row_bitmask(self._lineage_mask(table, dels)))
            lengths.append(table.n_pad // 32)
            metrics.record_time("hbm.delta.lineage_mask", time.perf_counter() - t_mask)
        device_planes = iter(_upload_planes(uploads, lengths, table.device))
        cols: Dict[str, ResidentColumn] = {}
        for name in order:
            dtype_str, enc = encs[name]
            data = next(device_planes)
            data2 = next(device_planes) if enc == "f64" else None
            vocab = table.columns[name].vocab if enc == "string" else None
            cols[name] = ResidentColumn(data, dtype_str, enc,
                                        n_pad * 4 * (2 if enc == "f64" else 1), vocab, data2)
        del_mask = next(device_planes) if dels else None
        metrics.incr("hbm.delta.h2d_bytes", dev_bytes)
        metrics.record_time("hbm.delta.prefetch", time.perf_counter() - t0)
        return DeltaRegion(delta_snapshot_key(appended), table.key, dels, n_rows, n_pad, cols,
                           oov, host_batch, del_mask, zones,
                           dev_bytes + host_bytes + oov_bytes), False

    @staticmethod
    def _lineage_mask(table: ResidentTable, dels: tuple) -> np.ndarray:
        """bool over the base table's padded rows: True where the row's
        lineage id is deleted (pad rows False; the host leg clips them
        like every tail block). Reads ``_data_file_id`` of every base file
        through the reader cache (timed as ``hbm.delta.lineage_mask``)."""
        from .. import constants as C
        from ..storage import layout

        flat = np.zeros(table.n_pad, dtype=bool)
        dels_arr = np.asarray(dels, dtype=np.int64)
        for path, start, n in table.files:
            vals = layout.cached_reader(path).read([C.DATA_FILE_NAME_ID]).columns[
                C.DATA_FILE_NAME_ID].data
            flat[start : start + n] = np.isin(np.asarray(vals, dtype=np.int64), dels_arr)
        return flat

    def hybrid_block_counts(
        self, table: ResidentTable, delta: DeltaRegion, predicate: Expr
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(base per-block counts, delta per-block counts) of ``predicate``
        in one K1h launch (its plain version on the CPU), the deleted base
        rows masked out on the device and one count vector copied home.
        None when the predicate cannot ride the shared encodings (the
        caller routes the host union)."""
        from .delta import prepare_hybrid_predicate

        prepared = prepare_hybrid_predicate(table.columns, delta.oov, predicate)
        if prepared is None:
            return None
        narrowed, names = prepared
        if any(n.split("\x00", 1)[0] not in delta.columns for n in names):
            return None
        bcols = resident_arrays_for(table.columns, names)
        dcols = resident_arrays_for(delta.columns, names)
        t0 = time.perf_counter()
        counts = K.hybrid_block_counts_tensor(narrowed, names, bcols, dcols,
                                              delta.del_mask).cpu().numpy()
        metrics.record_time("scan.resident_hybrid.device", time.perf_counter() - t0)
        metrics.incr("scan.resident.d2h_bytes", int(counts.nbytes))
        nb_pad = table.n_pad // BLOCK_ROWS
        nb = -(-table.n_rows // BLOCK_ROWS)
        nd = -(-delta.n_rows // BLOCK_ROWS)
        return counts[:nb], counts[nb_pad : nb_pad + nd]

    def delta_parts(
        self, delta: DeltaRegion, predicate: Expr, output_columns, counts: np.ndarray
    ) -> List[ColumnarBatch]:
        """The delta's exact host leg: only the blocks the device counted
        matches in, sliced out of the decoded appended rows, the predicate
        re-evaluated there, projected. No source file is read."""
        from .delta import blocks_to_runs

        cand = np.flatnonzero(counts)
        metrics.incr("scan.resident.delta_blocks_touched", int(cand.size))
        metrics.incr("scan.resident.delta_blocks_total", int(len(counts)))
        parts = []
        for lo, hi in blocks_to_runs(cand, BLOCK_ROWS, delta.n_rows):
            sub = delta.host_batch.take(np.arange(lo, hi))
            idx = np.flatnonzero(eval_mask(predicate, sub))
            if idx.size:
                parts.append(sub.take(idx).select(list(output_columns)))
        return parts


hbm_cache = HbmIndexCache()
