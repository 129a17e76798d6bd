"""Mesh-sharded residency: an index version's predicate columns uploaded
once into the shards of the bucket mesh, so a mesh session's filters,
aggregates, hybrid scans, aggregate-joins and served bursts ship no rows.

Counterpart of ``hyperspace_tpu.exec.mesh_cache``. Without it a mesh
session uploads each query's rows to its shards (``exec/distributed.py``);
with residency on (conf ``hyperspace.torch.hbm.mode``) the columns stay on
the shards' devices and a query sends nothing up:

* **layout**: bucket b lives on shard ``owner_of_bucket(b, D) = b % D``
  (``parallel/mesh.py``), the rule the sharded build writes with, so the
  bucketed operators stay collective-free. A shard holds its owned buckets
  ascending, segments in path order inside each bucket, zero-padded to
  one capacity for the table: ``max(next_pow2(max shard rows), 8192)``
  (K1c counts 8,192-row blocks; the reference takes ``block = cap`` where
  a shard holds fewer, so there the port pads more). Planes are int32
  under the one narrowing contract (``ops/kernels.py:
  narrow_arrays_to_i32``), strings as codes into one table-global sorted
  vocab that never uploads, float64 as two planes. Each shard's planes
  are allocated on that shard's device;
* **the query**: K1c once a shard (K1p over a compressed table's packed
  planes, K1b for a batch of N > 1), each shard's launch issued with its
  device current (``Mesh.scope``) before any is waited on; the
  ``(D, n_blocks)`` count matrix comes home through pinned, non-blocking
  copies (``ops/build.py:DeviceFetch``), and the host reads only the
  counted blocks, re-evaluating the predicate exactly there
  (``collect_parts``). ``dist.h2d_bytes``, which meters the per-query
  route, stays flat;
* **the ladder**: resident -> compressed -> streaming -> host through
  ``residency/tiers.py:plan_tier``; the compressed tier packs every shard
  under one global ``PackSpec``; the streaming tier is
  ``residency/streaming.py``'s mesh twin (a slab pair on every shard's
  device);
* **delta regions** (``MeshDeltaRegion``): a hybrid scan's appended rows
  hash-bucketized on the index's key columns and placed by the same
  ``b % D`` rule, the base's deletion mask one bit a row per shard; K1h
  counts base and delta once a shard (``hybrid_block_counts``). A
  compressed or streaming base declines (``hbm.mesh.delta.declined.tier``).
  The mesh path has no selectivity gate: its fallback ships every row;
* **join regions** (``exec/join_residency.py:MeshJoinRegion``) and the
  device aggregate (``agg_scan``, ``exec/scan_agg.py:mesh_scan_agg_outputs``):
  per-shard partials merged with ``parallel/mesh.py:all_reduce``, one
  group table home.

A device error (a ``RuntimeError``) out of a shard's launch raises to the
executor's arm, which drops the table or region and answers on the
per-query mesh route; ``KernelBuildError`` propagates. A first device
touch the probe finds hung or failing raises ``DeviceUnavailableError``
at a build, after counting ``hbm.mesh.device_unreachable``; each distinct
device of the mesh is probed. The knobs are the single-device cache's
(``config.ResidencyConf``): a session feeds one of the two caches, and the
one budget bounds it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ResidencyConf
from ..exceptions import HyperspaceException
from ..ops import kernels as K
from ..ops.bitpack import PackSpec
from ..ops.build import DeviceFetch
from ..plan.expr import Expr, eval_mask
from ..storage import layout
from ..storage.columnar import ColumnarBatch, is_string
from ..telemetry.metrics import metrics
from ..telemetry.trace import add_bytes as _trace_bytes
from ..telemetry.trace import span as _trace_span
from ..utils.intmath import next_pow2
from .bytecache import batch_nbytes, vocab_heap_bytes
from .hbm_cache import (
    BLOCK_ROWS,
    _MAX_FAILED_MEMO,
    _MAX_VOCAB,
    _auto_enabled,
    _budget_bytes,
    _encode_column,
    _encode_f64,
    _file_identity,
    _upload_planes,
    ResidentCacheBase,
    delta_snapshot_key,
    prepare_resident_predicate,
    resident_arrays_for,
    resident_specs_for,
)


@dataclass
class MeshResidentColumn:
    """One column over the mesh: ``data[d]`` is shard d's plane on its
    device (``cap`` int32 values, or the packed words under ``pack``, one
    spec for every shard), ``data2[d]`` an f64 column's low plane.
    Duck-typed against ``ResidentColumn`` (enc, dtype_str, vocab, pack)."""

    data: List[torch.Tensor]
    dtype_str: str
    enc: str  # 'int' | 'float32' | 'string' | 'f64'
    nbytes: int
    vocab: Optional[np.ndarray] = None
    data2: Optional[List[torch.Tensor]] = None
    pack: Optional[PackSpec] = None
    # int-encoded columns: value bounds over the real rows (the shards
    # build no zone vectors; exec/scan_agg.py's dense-key planner reads these)
    vmin: Optional[int] = None
    vmax: Optional[int] = None


# one shard's slice of one file: rows [file_lo, file_hi) of ``path`` live
# at shard-local rows [dev_off, dev_off + (file_hi - file_lo))
Segment = Tuple[str, int, int, int]


@dataclass
class MeshResidentTable:
    key: tuple  # ((path, size, mtime_ns), ...) sorted by path
    mesh: object
    n_devices: int
    cap: int  # padded rows a shard (a power of two, >= BLOCK_ROWS)
    dev_rows: List[int]  # real rows a shard
    segments: List[List[Segment]]  # a shard's, dev_off ascending
    columns: Dict[str, MeshResidentColumn]
    n_rows: int
    nbytes: int
    last_used: float = field(default_factory=time.monotonic)
    tier: str = "resident"  # or "compressed"; streaming: residency/streaming.py
    raw_nbytes: int = 0

    @property
    def n_blocks(self) -> int:
        return self.cap // BLOCK_ROWS

    @property
    def device(self):
        """The mesh (the residency snapshot prints it)."""
        return self.mesh


@dataclass
class MeshDeltaRegion:
    """A hybrid scan's appended side for one mesh base table: the appended
    rows bucketized on the index's key columns and placed by the build's
    ``b % D`` rule, ``dev_idx[d]`` mapping shard d's rows to rows of the
    decoded ``host_batch`` (the exact host leg reads memory), and the
    base's deletion mask, one bit a base row, per shard (None without
    deletes)."""

    key: tuple  # the appended snapshot ((name, size, mtime), ...) sorted
    base_key: tuple
    deleted_ids: tuple
    mesh: object
    n_devices: int
    cap: int
    dev_rows: List[int]
    dev_idx: List[np.ndarray]
    columns: Dict[str, MeshResidentColumn]
    oov: Dict[str, np.ndarray]
    host_batch: ColumnarBatch
    del_mask: Optional[List[torch.Tensor]]
    n_rows: int = 0
    nbytes: int = 0
    last_used: float = field(default_factory=time.monotonic)

    @property
    def n_blocks(self) -> int:
        return self.cap // BLOCK_ROWS


def shard_arrays(columns, names, d: int) -> List[torch.Tensor]:
    """Shard ``d``'s planes of (possibly plane-suffixed) ``names``."""
    return [a[d] for a in resident_arrays_for(columns, names)]


def shard_capacity(dev_rows: List[int]) -> int:
    return max(next_pow2(max(max(dev_rows), 1)), BLOCK_ROWS)


def fetch_shards(mesh, issue: Callable[[int, torch.device], List[torch.Tensor]]
                 ) -> List[List[np.ndarray]]:
    """``issue(d, dev)`` queues shard d's work with its device current and
    returns its output tensors, whose copies home are queued at once
    (pinned, non-blocking); every shard is issued before any is waited on.
    Returns each shard's outputs as numpy arrays."""
    fetches = []
    for d, dev in enumerate(mesh.devices):
        with mesh.scope(dev):
            fetches.append(DeviceFetch(issue(d, dev)))
    return [f.wait() for f in fetches]


def fetch_shards_home(mesh, merged: List[torch.Tensor]) -> List[np.ndarray]:
    """The merged outputs of an ``all_reduce`` (on the first shard's
    device) home through one pinned, non-blocking fetch."""
    with mesh.scope(mesh.devices[0]):
        return DeviceFetch(merged).wait()


def require_mesh(mesh) -> None:
    """Probe each distinct device of the mesh once: an unreachable one
    counts ``hbm.mesh.device_unreachable`` and raises
    ``DeviceUnavailableError`` (``utils/deviceprobe.py:require_device``)."""
    from ..utils.deviceprobe import first_device_touch_ok, require_device

    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda" and not first_device_touch_ok(device=str(dev)):
            metrics.incr("hbm.mesh.device_unreachable")
        require_device(dev)


def _bucket_segments(paths: List[str]) -> Dict[int, List[Tuple[str, int, int]]]:
    """bucket -> [(path, file_row_lo, file_row_hi), ...] in path order,
    from per-bucket file names and run-file footers (the executor's
    grouping rule)."""
    out: Dict[int, List[Tuple[str, int, int]]] = {}
    for p in paths:  # the caller sorts
        if layout.is_run_file(p):
            offs = layout.run_offsets_checked(p)
            for b in range(len(offs) - 1):
                s, e = int(offs[b]), int(offs[b + 1])
                if e > s:
                    out.setdefault(b, []).append((str(p), s, e))
        else:
            n = layout.cached_reader(p).num_rows
            if n:
                out.setdefault(layout.bucket_of_file(p), []).append((str(p), 0, n))
    return out


def _upload_shards(mesh, per_shard: List[List[np.ndarray]], lengths: List[int]
                   ) -> List[List[torch.Tensor]]:
    """Each shard's host planes onto its device (``_upload_planes``: zero
    padded to ``lengths``, complete before it returns)."""
    out = []
    for dev, planes in zip(mesh.devices, per_shard):
        with mesh.scope(dev):
            out.append(_upload_planes(planes, lengths, dev))
    return out


class MeshHbmCache(ResidentCacheBase):
    """Mesh-sharded resident tables, delta regions and join regions over
    immutable index files, LRU-bounded by the residency budget (the
    registry, eviction and background plumbing of ``ResidentCacheBase``)."""

    _metric_prefix = "hbm.mesh"

    def auto_enabled(self, conf: ResidencyConf, mesh) -> bool:
        """Whether first-touch population is on for ``conf`` on ``mesh``'s
        devices."""
        return _auto_enabled(conf, mesh.devices[0])

    # -- population ----------------------------------------------------------
    def prefetch(self, files, columns: List[str], mesh,
                 conf: ResidencyConf = ResidencyConf()) -> Optional[MeshResidentTable]:
        """Build and register a mesh table for ``files`` x ``columns``
        now. Idempotent; None when nothing encodes or the budget refuses."""
        paths = sorted(str(p) for p in files)
        if not paths:
            return None
        try:
            key = tuple(_file_identity(p) for p in paths)
        except OSError:
            return None
        with self._lock:
            existing = self._covering_locked({k[0]: k for k in key}, set(columns), mesh)
            if existing is not None:
                return existing
        try:
            table, _ = self._build(paths, key, columns, mesh, conf)
        except OSError:  # a file vanished: no residency
            metrics.incr("hbm.mesh.prefetch_read_error")
            return None
        if table is None:
            return None
        self._register(table, _budget_bytes(conf))
        return table

    def note_touch(self, files, columns: List[str], mesh,
                   conf: ResidencyConf = ResidencyConf(),
                   n_rows_hint: Optional[int] = None) -> None:
        """First-touch population: a background build of this file set's
        mesh table so repeat queries go resident. Never blocks; a device
        error is kept for the query thread (``HbmIndexCache.note_touch``'s
        contract)."""
        if not _auto_enabled(conf, mesh.devices[0]) or not files or not columns:
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
            if self._covering_locked({k[0]: k for k in key}, set(columns), mesh):
                return
            self._pending.add(key)
            epoch = self._epoch

        def work() -> bool:
            if n_rows_hint is None and sum(
                    layout.cached_reader(p).num_rows for p in paths) < conf.min_rows:
                return True
            # widen rather than replace: alternating column sets converge
            with self._lock:
                prior = next((t for t in self._tables if t.key == key), None)
            build_cols = list(dict.fromkeys(
                list(columns) + (sorted(prior.columns) if prior else [])))
            table, permanent = self._build(paths, key, build_cols, mesh, conf)
            if table is not None and set(columns) <= set(table.columns):
                self._register(table, _budget_bytes(conf), epoch=epoch)
                return False
            return table is not None or permanent

        self._in_background(key, memo, epoch, work, "hbm.mesh.prefetch_read_error",
                            "hbm.mesh.populate_failed", "hbm-mesh-populate")

    def _in_background(self, pending, memo, epoch: int, work: Callable[[], bool],
                       read_metric: str, fail_metric: str, name: str) -> None:
        """Run a population's ``work`` on a tracked daemon thread, holding
        ``pending`` until it ends. ``work`` returns True when ``memo`` can
        never materialize for this file version (memoized, no retry). A
        file vanished meanwhile counts ``read_metric`` and skips; any other
        error counts ``fail_metric`` and is kept for the query thread."""

        def bg():
            failed = False
            try:
                failed = work()
            except OSError:
                metrics.incr(read_metric)
            except Exception as e:  # noqa: BLE001 - kept for the query thread
                metrics.incr(fail_metric)
                self._keep_background_error(e, epoch)
            finally:
                with self._lock:
                    self._pending.discard(pending)
                    if failed:
                        if len(self._failed) >= _MAX_FAILED_MEMO:
                            self._failed.clear()
                        self._failed.add(memo)

        t = threading.Thread(target=bg, daemon=True, name=name)
        self._track_for_exit(t)
        t.start()

    def _build(self, paths: List[str], key: tuple, columns: List[str], mesh,
               conf: ResidencyConf) -> Tuple[Optional[object], bool]:
        """(table, permanent_refusal): ``HbmIndexCache._build``'s semantics
        with the bucket-per-shard layout."""
        from ..ops import bitpack
        from ..parallel.mesh import owner_of_bucket
        from ..residency import plan_tier
        from ..storage.columnar import unify_dictionaries

        require_mesh(mesh)
        t0 = time.perf_counter()
        try:
            by_bucket = _bucket_segments(paths)
        except HyperspaceException:
            return None, True
        if not by_bucket:
            return None, True
        D = mesh.size
        dev_segs: List[List[Segment]] = [[] for _ in range(D)]
        dev_rows = [0] * D
        for b in sorted(by_bucket):
            d = owner_of_bucket(b, D)
            for path, lo, hi in by_bucket[b]:
                dev_segs[d].append((path, lo, hi, dev_rows[d]))
                dev_rows[d] += hi - lo
        n_rows = sum(dev_rows)
        if n_rows == 0:
            return None, True
        cap = shard_capacity(dev_rows)
        readers = {p: layout.cached_reader(p) for p in paths}
        dtype_of = {m["name"]: m["dtype"] for m in readers[paths[0]].footer["columns"]}
        encodable = [c for c in columns if c in dtype_of]
        if not encodable:
            return None, True
        # budget pre-check before any read or upload; over the budget it
        # refuses here only when the ladder below the raw planes is closed
        vocab_est = 0
        for c in encodable:
            if is_string(dtype_of[c]):
                for r in readers.values():
                    m = next((x for x in r.footer["columns"] if x["name"] == c), None)
                    if m is not None:
                        vocab_est += vocab_heap_bytes(m.get("vocab", ()))
        planes = sum(2 if dtype_of[c] == "float64" else 1 for c in encodable)
        ladder_open = conf.compression != "off" or conf.streaming != "off"
        if planes * D * cap * 4 + vocab_est > _budget_bytes(conf) and not ladder_open:
            metrics.incr("hbm.mesh.over_budget_refused")
            return None, False
        # the columns every file carries, footer refusals applied before
        # the reads: one ordered sweep a run file for all of them
        readable = []
        for c in encodable:
            metas = [next((m for m in r.footer["columns"] if m["name"] == c), None)
                     for r in readers.values()]
            if any(m is None for m in metas):
                continue
            if is_string(dtype_of[c]):
                if not all(is_string(m["dtype"]) for m in metas):
                    continue
                if sum(len(m.get("vocab", ())) for m in metas) > _MAX_VOCAB:
                    metrics.incr("hbm.mesh.vocab_too_large_refused")
                    continue
            readable.append(c)
        if not readable:
            return None, True
        run_paths = [p for p in paths if layout.is_run_file(p)]
        seg_map = (layout.execute_segment_reads(layout.plan_segment_reads(run_paths),
                                                columns=readable) if run_paths else {})
        seg_batch: Dict[Tuple[str, int, int], ColumnarBatch] = {}
        for b, segs in by_bucket.items():
            for path, lo, hi in segs:
                seg_batch[(path, lo, hi)] = (seg_map[(path, b)] if layout.is_run_file(path)
                                             else readers[path].read(readable, row_range=(lo, hi)))

        def read_seg(path, lo, hi, name):
            return seg_batch[(path, lo, hi)].columns[name]

        # --- encode: host (D, cap) matrices, no uploads yet ----------------
        # name -> (dtype_str, enc, vocab, {plane key: (D, cap) int32})
        host_mats: Dict[str, tuple] = {}
        for name in readable:
            if is_string(dtype_of[name]):
                flat = [(d, seg) for d in range(D) for seg in dev_segs[d]]
                unified = unify_dictionaries([read_seg(p, lo, hi, name)
                                              for _, (p, lo, hi, _o) in flat])
                vocab = next((u.vocab for u in unified if u.vocab is not None), None)
                if vocab is None:
                    continue
                mat = np.zeros((D, cap), dtype=np.int32)
                for (d, (_p, lo, hi, off)), u in zip(flat, unified):
                    mat[d, off:off + (hi - lo)] = u.data.astype(np.int32, copy=False)
                host_mats[name] = (dtype_of[name], "string", vocab, {"": mat})
            elif dtype_of[name] == "float64":
                hi_m = np.zeros((D, cap), dtype=np.int32)
                lo_m = np.zeros((D, cap), dtype=np.int32)
                ok = True
                for d in range(D):
                    for path, lo, hi, off in dev_segs[d]:
                        e = _encode_f64(read_seg(path, lo, hi, name).data)
                        if e is None:  # NaN data: refuse the column
                            ok = False
                            break
                        hi_m[d, off:off + (hi - lo)], lo_m[d, off:off + (hi - lo)] = e
                    if not ok:
                        break
                if ok:
                    host_mats[name] = ("float64", "f64", None, {"hi": hi_m, "lo": lo_m})
            else:
                mat = np.zeros((D, cap), dtype=np.int32)
                enc = None
                for d in range(D):
                    for path, lo, hi, off in dev_segs[d]:
                        e = _encode_column(read_seg(path, lo, hi, name))
                        if e is None or (enc is not None and e[1] != enc):
                            enc = "refused"
                            break
                        enc = e[1]
                        mat[d, off:off + (hi - lo)] = e[0]
                    if enc == "refused":
                        break
                if enc is not None and enc != "refused":
                    host_mats[name] = (dtype_of[name], enc, None, {"": mat})
        if not host_mats:
            return None, True

        # --- tier plan: one global PackSpec a packable column ---------------
        pack_specs: Dict[str, PackSpec] = {}
        col_bounds: Dict[str, Tuple[int, int]] = {}
        raw_plane_bytes = unpacked_bytes = side_bytes = 0
        for name, (_dts, enc, vocab, mats) in host_mats.items():
            side_bytes += vocab_heap_bytes(vocab)
            raw_plane_bytes += len(mats) * D * cap * 4
            spec = None
            if len(mats) == 1:
                # bounds over the REAL rows: a zero pad would stretch an
                # offset domain's span past the pack budget
                real = [mats[""][d, :dev_rows[d]] for d in range(D) if dev_rows[d]]
                vmin = min(int(r.min()) for r in real)
                vmax = max(int(r.max()) for r in real)
                if enc == "int":
                    col_bounds[name] = (vmin, vmax)
                spec = bitpack.pack_spec(vmin, vmax, cap)
            if spec is not None:
                pack_specs[name] = spec
            else:
                unpacked_bytes += len(mats) * D * cap * 4
        plan = plan_tier(raw_plane_bytes, _budget_bytes(conf), pack_specs, unpacked_bytes,
                         side_bytes, streaming_ok=True, shard_count=D, conf=conf)
        if plan.tier == "host":
            metrics.incr("hbm.mesh.over_budget_refused")
            return None, False
        if plan.tier == "streaming":
            from ..residency.streaming import build_mesh_streaming_table

            table = build_mesh_streaming_table(key, mesh, dev_segs, dev_rows, n_rows, host_mats,
                                               plan.specs, plan.window_rows)
            if table.nbytes > _budget_bytes(conf):
                # even the slab pairs do not fit: the one genuine decline
                metrics.incr("hbm.mesh.residency.streaming_declined")
                metrics.incr("hbm.mesh.over_budget_refused")
                return None, False
            metrics.incr("residency.tier.streaming_built")
            metrics.record_time("hbm.mesh.prefetch", time.perf_counter() - t0)
            return table, False

        # --- upload: raw planes, or packed words (pads encode ref0) --------
        order = list(host_mats)
        lengths: List[int] = []
        per_shard: List[List[np.ndarray]] = [[] for _ in range(D)]
        for name in order:
            mats = host_mats[name][3]
            spec = plan.specs.get(name)
            if spec is not None:
                mat = mats[""]
                for d in range(D):
                    mat[d, dev_rows[d]:] = spec.ref0
                    per_shard[d].append(bitpack.pack_plain(mat[d], spec))
                lengths.append(spec.n_words)
            else:
                for m in mats.values():
                    for d in range(D):
                        per_shard[d].append(m[d])
                    lengths.append(cap)
        shards = _upload_shards(mesh, per_shard, lengths)
        _trace_bytes("h2d_bytes", 4 * D * sum(lengths))
        cols: Dict[str, MeshResidentColumn] = {}
        nbytes = 0
        i = 0
        for name in order:
            dts, enc, vocab, mats = host_mats[name]
            spec = plan.specs.get(name)
            data = [s[i] for s in shards]
            data2 = [s[i + 1] for s in shards] if len(mats) == 2 else None
            i += len(mats)
            plane_bytes = 4 * D * (spec.n_words if spec is not None else len(mats) * cap)
            col_bytes = plane_bytes + vocab_heap_bytes(vocab)
            vmin, vmax = col_bounds.get(name, (None, None))
            cols[name] = MeshResidentColumn(data, dts, enc, col_bytes, vocab, data2, spec,
                                            vmin, vmax)
            nbytes += col_bytes
        if nbytes > _budget_bytes(conf):
            metrics.incr("hbm.mesh.over_budget_refused")
            return None, False
        raw_nbytes = raw_plane_bytes + side_bytes
        if plan.tier == "compressed":
            metrics.incr("residency.tier.compressed_built")
            metrics.incr("residency.compressed.packed_bytes", nbytes)
            metrics.incr("residency.compressed.raw_bytes", raw_nbytes)
        metrics.record_time("hbm.mesh.prefetch", time.perf_counter() - t0)
        return MeshResidentTable(key, mesh, D, cap, dev_rows, dev_segs, cols, n_rows, nbytes,
                                 tier=plan.tier, raw_nbytes=raw_nbytes), False

    # -- lookup --------------------------------------------------------------
    def _covering_locked(self, want_files: dict, want_cols: set, mesh):
        for t in reversed(self._tables):
            if t.mesh is not mesh:
                continue
            have = {k[0]: k for k in t.key}
            if all(p in have and have[p] == ident for p, ident in want_files.items()) \
                    and want_cols <= set(t.columns):
                return t
        return None

    def resident_for(self, files, columns: List[str], mesh,
                     conf: ResidencyConf = ResidencyConf()):
        """A registered table on ``mesh`` covering every file of ``files``
        (by identity: stale versions never match) with every column, else
        None. Mode "off" disables serving too. Raises a device error a
        background population hit."""
        self._raise_background_error()
        if not files or conf.mode == "off":
            return None
        with self._lock:
            if not self._tables:
                return None
        try:
            want = {str(p): _file_identity(p) for p in files}
        except OSError:
            return None
        with self._lock:
            t = self._covering_locked(want, set(columns), mesh)
            if t is not None:
                t.last_used = time.monotonic()
            return t

    def tier_of(self, files, columns, mesh) -> Optional[str]:
        """The tier of the table that would serve ``files`` x ``columns``
        on ``mesh``, or None: a label lookup (explain) that neither raises
        nor counts as a use."""
        try:
            want = {str(p): _file_identity(p) for p in files}
        except OSError:
            return None
        with self._lock:
            t = self._covering_locked(want, set(columns), mesh) if self._tables else None
        return None if t is None else t.tier

    # -- the resident query --------------------------------------------------
    def _shard_counts(self, table, prepared: list) -> np.ndarray:
        """``(D, N, n_blocks)`` counts of N prepared predicates: one launch
        a shard over the union of their planes (K1c or K1p for N = 1, K1b
        for more; plain versions on the CPU)."""
        union = tuple(dict.fromkeys(n for _, names in prepared for n in names))
        specs = resident_specs_for(table.columns, union)
        outs = fetch_shards(table.mesh, lambda d, _dev: [K.resident_counts_tensor(
            prepared, union, shard_arrays(table.columns, union, d), specs, table.cap)])
        return np.stack([o[0] for o in outs])

    def block_counts(self, table, predicate: Expr) -> Optional[np.ndarray]:
        """``(D, n_blocks)`` per-block match counts of ``predicate``; None
        when it does not narrow to the resident encodings (the caller takes
        the per-query route). A streaming table runs its window loop."""
        if table.tier == "streaming":
            from ..residency.streaming import mesh_stream_block_counts

            return mesh_stream_block_counts(table, predicate)
        prepared = prepare_resident_predicate(table.columns, predicate)
        if prepared is None:
            return None
        t0 = time.perf_counter()
        counts = self._shard_counts(table, [prepared])[:, 0]
        metrics.record_time("scan.resident_mesh.device", time.perf_counter() - t0)
        metrics.incr("scan.resident_mesh.d2h_bytes", int(counts.nbytes))
        _trace_bytes("d2h_bytes", int(counts.nbytes))
        return counts

    def block_counts_batch(self, table, predicates: List[Expr], prepared: Optional[list] = None,
                           metric_ns: str = "serve.batch") -> Optional[np.ndarray]:
        """``(N, D, n_blocks)`` counts of N predicates: K1b once a shard for
        N > 1, the single entries for N = 1 (the compiled pipelines'
        singles, ``metric_ns`` "compile.fused"). None when any predicate
        does not narrow (the caller serves query by query)."""
        if table.tier == "streaming":
            from ..residency.streaming import mesh_stream_block_counts_batch

            return mesh_stream_block_counts_batch(table, predicates, prepared, metric_ns)
        if prepared is None:
            prepared = [prepare_resident_predicate(table.columns, p) for p in predicates]
        if any(p is None for p in prepared):
            return None
        t0 = time.perf_counter()
        counts = self._shard_counts(table, prepared)
        metrics.record_time(f"{metric_ns}.mesh_device", time.perf_counter() - t0)
        metrics.incr(f"{metric_ns}.dispatches")
        metrics.incr(f"{metric_ns}.queries", len(prepared))
        metrics.incr("scan.resident_mesh.d2h_bytes", int(counts.nbytes))
        _trace_bytes("d2h_bytes", int(counts.nbytes))
        return np.swapaxes(counts, 0, 1)

    # -- host-side collection ------------------------------------------------
    def collect_parts(self, table, files, output_columns: List[str], predicate: Expr,
                      counts: np.ndarray,
                      path_metric: Optional[str] = "scan.path.resident_device_mesh"
                      ) -> List[ColumnarBatch]:
        """Read ONLY the blocks the shards counted matches in, restricted
        to the query's (pruned) ``files``, re-evaluate the predicate
        exactly there and gather the output columns; parts in (path, row)
        order. ``path_metric`` None: the hybrid path counts its own."""
        wanted = {str(Path(f)) for f in files}
        if path_metric is not None:
            metrics.incr(path_metric)
        metrics.incr("scan.resident_mesh.blocks_touched", int(np.count_nonzero(counts)))
        metrics.incr("scan.resident_mesh.blocks_total", int(counts.size))
        need = list(dict.fromkeys(list(output_columns) + sorted(predicate.columns())))
        from .delta import blocks_to_runs

        keyed: List[Tuple[Tuple[str, int], ColumnarBatch]] = []
        for d in range(table.n_devices):
            cand = np.flatnonzero(counts[d])
            for lo, hi in blocks_to_runs(cand, BLOCK_ROWS, table.dev_rows[d]):
                for path, flo, fhi, off in table.segments[d]:
                    a, b = max(lo, off), min(hi, off + (fhi - flo))
                    if a >= b or path not in wanted:
                        continue
                    r_lo, r_hi = flo + (a - off), flo + (b - off)
                    batch = layout.cached_reader(path).read(need, row_range=(r_lo, r_hi))
                    idx = np.flatnonzero(np.asarray(eval_mask(predicate, batch)))
                    if idx.size:
                        keyed.append(((path, r_lo), batch.take(idx).select(output_columns)))
        keyed.sort(key=lambda kv: kv[0])
        return [b for _, b in keyed]

    # -- delta regions (the hybrid scan's appended side) ---------------------
    def _delta_match(self, d, table, dkey, dels, cols) -> bool:
        return (d.base_key == table.key and d.mesh is table.mesh and d.key == dkey
                and d.deleted_ids == dels and set(cols) <= set(d.columns))

    def delta_for(self, table, appended, columns, deleted_ids,
                  conf: ResidencyConf = ResidencyConf()) -> Optional[MeshDeltaRegion]:
        if conf.mode == "off":
            return None
        dkey = delta_snapshot_key(appended)
        dels = tuple(sorted(int(i) for i in deleted_ids))
        with self._lock:
            for d in reversed(self._deltas):
                if self._delta_match(d, table, dkey, dels, columns):
                    d.last_used = time.monotonic()
                    return d
        return None

    def prefetch_delta(self, table, appended, relation, host_columns, deleted_ids,
                       indexed_columns, num_buckets: int,
                       conf: ResidencyConf = ResidencyConf()) -> Optional[MeshDeltaRegion]:
        """Build and register a mesh delta now (idempotent; one built over
        a narrower base is rebuilt)."""
        want = [c for c in host_columns if c in table.columns]
        existing = self.delta_for(table, appended, want, deleted_ids, conf)
        if existing is not None:
            return existing
        delta, _ = self._build_delta(table, appended, relation, host_columns, deleted_ids,
                                     indexed_columns, num_buckets, conf)
        if delta is None or not self._register_delta(delta, _budget_bytes(conf)):
            return None
        return delta

    def note_touch_delta(self, table, appended, relation, host_columns, deleted_ids,
                         indexed_columns, num_buckets: int,
                         conf: ResidencyConf = ResidencyConf()) -> None:
        """Background mesh delta population (``HbmIndexCache.
        note_touch_delta``'s contract: never blocks, no row floor)."""
        if not _auto_enabled(conf, table.mesh.devices[0]) or not appended:
            return
        dkey = delta_snapshot_key(appended)
        dels = tuple(sorted(int(i) for i in deleted_ids))
        want = {c for c in host_columns if c in table.columns}
        memo = ("delta", table.key, dkey, dels)
        with self._lock:
            if memo in self._pending or memo in self._failed:
                return
            if any(self._delta_match(d, table, dkey, dels, want) for d in self._deltas):
                return
            self._pending.add(memo)
            epoch = self._epoch

        def work() -> bool:
            delta, permanent = self._build_delta(table, appended, relation, host_columns,
                                                 deleted_ids, indexed_columns, num_buckets, conf)
            if delta is None:
                return permanent
            self._register_delta(delta, _budget_bytes(conf), epoch=epoch)
            # a column that could not encode never will for this epoch
            return not want <= set(delta.columns)

        self._in_background(memo, memo, epoch, work, "hbm.mesh.delta.read_error",
                            "hbm.mesh.delta.populate_failed", "hbm-mesh-delta-populate")

    def _build_delta(self, table, appended, relation, host_columns, deleted_ids,
                     indexed_columns, num_buckets: int, conf: ResidencyConf
                     ) -> Tuple[Optional[MeshDeltaRegion], bool]:
        """(delta, permanent_refusal): decode the appended files once,
        bucketize their rows to the build's ``b % D`` placement, and upload
        each shard's delta planes and the base's deletion mask."""
        from .. import constants as C
        from ..ops.hashing import bucket_ids_host, key_repr
        from ..parallel.mesh import owner_of_bucket
        from ..storage import parquet_io
        from .delta import encode_delta_columns

        if table.tier != "resident":
            # K1h reads the base's raw planes: a compressed or streaming
            # base cannot anchor a delta
            metrics.incr("hbm.mesh.delta.declined.tier")
            return None, True
        mesh, D = table.mesh, table.n_devices
        require_mesh(mesh)
        t0 = time.perf_counter()
        dels = tuple(sorted(int(i) for i in deleted_ids))
        with self._lock:
            headroom = _budget_bytes(conf) - sum(t.nbytes for t in self._tables)
        if sum(int(f.size) for f in appended) > headroom:
            metrics.incr("hbm.mesh.delta.over_budget_refused")
            return None, False
        host_batch = parquet_io.read_relation(relation, paths=[f.name for f in appended],
                                              columns=list(host_columns))
        n_rows = host_batch.num_rows
        if n_rows == 0 or any(c not in host_batch.columns for c in indexed_columns):
            return None, True
        if dels:
            for segs in table.segments:
                for path, _lo, _hi, _off in segs:
                    names = {m["name"] for m in layout.cached_reader(path).footer["columns"]}
                    if C.DATA_FILE_NAME_ID not in names:
                        metrics.incr("hbm.mesh.delta.no_lineage_refused")
                        return None, True
        buckets = bucket_ids_host([key_repr(host_batch.columns[c]) for c in indexed_columns],
                                  num_buckets)
        per_dev: List[List[np.ndarray]] = [[] for _ in range(D)]
        for b in np.unique(buckets):
            per_dev[owner_of_bucket(int(b), D)].append(np.flatnonzero(buckets == b))
        dev_idx = [np.concatenate(p) if p else np.empty(0, dtype=np.int64) for p in per_dev]
        dev_rows = [int(len(ix)) for ix in dev_idx]
        cap = shard_capacity(dev_rows)
        flats, encs, oov, planes, _zones = encode_delta_columns(host_batch, table.columns)
        if not flats:
            return None, True
        host_bytes = batch_nbytes(host_batch)
        oov_bytes = sum(vocab_heap_bytes(side) for side in oov.values())
        mask_bytes = D * table.cap // 8 if dels else 0
        dev_bytes = planes * D * cap * 4 + mask_bytes
        with self._lock:
            headroom = _budget_bytes(conf) - sum(t.nbytes for t in self._tables)
        if dev_bytes + host_bytes + oov_bytes > headroom:
            metrics.incr("hbm.mesh.delta.over_budget_refused")
            return None, False
        order = list(flats)
        per_shard: List[List[np.ndarray]] = [[] for _ in range(D)]
        lengths: List[int] = []
        for name in order:
            for flat in (flats[name] if encs[name][1] == "f64" else [flats[name]]):
                for d in range(D):
                    per_shard[d].append(flat[dev_idx[d]])
                lengths.append(cap)
        if dels:
            mask = self._lineage_mask(table, dels)
            for d in range(D):
                per_shard[d].append(K.pack_row_bitmask(mask[d]))
            lengths.append(table.cap // 32)
        shards = _upload_shards(mesh, per_shard, lengths)
        cols: Dict[str, MeshResidentColumn] = {}
        i = 0
        for name in order:
            dtype_str, enc = encs[name]
            data = [s[i] for s in shards]
            data2 = [s[i + 1] for s in shards] if enc == "f64" else None
            i += 2 if enc == "f64" else 1
            vocab = table.columns[name].vocab if enc == "string" else None
            cols[name] = MeshResidentColumn(data, dtype_str, enc,
                                            D * cap * 4 * (2 if enc == "f64" else 1), vocab,
                                            data2)
        del_mask = [s[i] for s in shards] if dels else None
        metrics.incr("hbm.mesh.delta.h2d_bytes", dev_bytes)
        _trace_bytes("h2d_bytes", dev_bytes)
        metrics.record_time("hbm.mesh.delta.prefetch", time.perf_counter() - t0)
        return MeshDeltaRegion(delta_snapshot_key(appended), table.key, dels, mesh, D, cap,
                               dev_rows, dev_idx, cols, oov, host_batch, del_mask, n_rows,
                               dev_bytes + host_bytes + oov_bytes), False

    @staticmethod
    def _lineage_mask(table, dels: tuple) -> np.ndarray:
        """bool ``(D, cap)``: True where a base row's lineage id is deleted
        (pad rows False), read at the shard segments' row ranges."""
        from .. import constants as C

        mask = np.zeros((table.n_devices, table.cap), dtype=bool)
        dels_arr = np.asarray(dels, dtype=np.int64)
        for d in range(table.n_devices):
            for path, flo, fhi, off in table.segments[d]:
                vals = layout.cached_reader(path).read(
                    [C.DATA_FILE_NAME_ID], row_range=(flo, fhi)).columns[C.DATA_FILE_NAME_ID].data
                mask[d, off:off + (fhi - flo)] = np.isin(np.asarray(vals, dtype=np.int64),
                                                          dels_arr)
        return mask

    def hybrid_block_counts(self, table, delta: MeshDeltaRegion, predicate: Expr
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """((D, base blocks), (D, delta blocks)) counts: K1h once a shard
        over the base shard AND NOT its deletion mask, plus the delta
        shard. None when the predicate cannot ride the shared encodings
        (the caller routes the host union)."""
        from .delta import prepare_hybrid_predicate

        prepared = prepare_hybrid_predicate(table.columns, delta.oov, predicate)
        if prepared is None:
            return None
        names = prepared[1]
        if any(n.split("\x00", 1)[0] not in delta.columns for n in names):
            return None
        t0 = time.perf_counter()
        outs = fetch_shards(table.mesh, lambda d, _dev: [K.hybrid_counts_tensor(
            [prepared], names, shard_arrays(table.columns, names, d),
            shard_arrays(delta.columns, names, d),
            None if delta.del_mask is None else delta.del_mask[d])[0]])
        counts = np.stack([o[0] for o in outs])
        metrics.record_time("scan.resident_hybrid.mesh_device", time.perf_counter() - t0)
        metrics.incr("scan.resident_mesh.d2h_bytes", int(counts.nbytes))
        _trace_bytes("d2h_bytes", int(counts.nbytes))
        nb = table.n_blocks
        return counts[:, :nb], counts[:, nb:]

    def delta_parts(self, delta: MeshDeltaRegion, predicate: Expr, output_columns,
                    counts: np.ndarray) -> List[ColumnarBatch]:
        """The mesh delta's exact host leg: per shard, the counted blocks'
        rows sliced out of the decoded appended batch, re-evaluated,
        projected. No source file is read."""
        from .delta import blocks_to_runs

        metrics.incr("scan.resident.delta_blocks_touched", int(np.count_nonzero(counts)))
        metrics.incr("scan.resident.delta_blocks_total", int(counts.size))
        parts: List[ColumnarBatch] = []
        for d in range(delta.n_devices):
            for lo, hi in blocks_to_runs(np.flatnonzero(counts[d]), BLOCK_ROWS,
                                         delta.dev_rows[d]):
                sub = delta.host_batch.take(delta.dev_idx[d][lo:hi])
                idx = np.flatnonzero(np.asarray(eval_mask(predicate, sub)))
                if idx.size:
                    parts.append(sub.take(idx).select(list(output_columns)))
        return parts

    # -- join regions --------------------------------------------------------
    def _join_covers(self, j, key, mesh, columns) -> bool:
        return j.key == key and j.mesh is mesh and all(
            c in j.l_cols or c in j.r_cols for c in columns)

    def join_for(self, l_files, r_files, l_keys, r_keys, columns, mesh,
                 conf: ResidencyConf = ResidencyConf()):
        """The registered mesh join region for exactly this (left version,
        right version, keys) on ``mesh`` with every column of ``columns``,
        else None. Raises a device error a background population hit."""
        from .join_residency import join_region_key

        self._raise_background_error()
        if conf.mode == "off":
            return None
        with self._lock:
            if not self._joins:
                return None
        try:
            key = join_region_key(l_files, r_files, l_keys, r_keys)
        except OSError:
            return None
        with self._lock:
            for j in reversed(self._joins):
                if self._join_covers(j, key, mesh, columns):
                    j.last_used = time.monotonic()
                    return j
        return None

    def note_touch_join(self, l_files, r_files, l_keys, r_keys, payload_columns, loader, mesh,
                        conf: ResidencyConf = ResidencyConf()) -> None:
        """Background mesh join-region population (``HbmIndexCache.
        note_touch_join``'s contract)."""
        from .join_residency import build_mesh_join_region, join_region_key

        if not _auto_enabled(conf, mesh.devices[0]):
            return
        try:
            key = join_region_key(l_files, r_files, l_keys, r_keys)
        except OSError:
            return
        want = frozenset(payload_columns)
        memo, pending = ("join", key, want), ("join", key)
        with self._lock:
            if pending in self._pending or memo in self._failed:
                return
            if any(self._join_covers(j, key, mesh, want) for j in self._joins):
                return
            self._pending.add(pending)
            epoch = self._epoch

        def work() -> bool:
            groups = loader()
            if groups is None:
                return False
            with self._lock:
                prior = next((j for j in self._joins if j.key == key), None)
            cols = list(dict.fromkeys(list(payload_columns) + (
                sorted(set(prior.l_cols) | set(prior.r_cols)) if prior else [])))
            region, permanent = build_mesh_join_region(
                self, groups[0], groups[1], key[2], key[3], key, cols, mesh, conf)
            if region is None:
                return permanent
            self._register_join(region, _budget_bytes(conf), epoch=epoch)
            # a payload column that can never encode for this version pair
            return not all(c in region.l_cols or c in region.r_cols for c in want)

        self._in_background(pending, memo, epoch, work, "hbm.mesh.prefetch_read_error",
                            "hbm.mesh.join.populate_failed", "hbm-mesh-join-populate")

    def prefetch_join(self, l_by_bucket, r_by_bucket, l_files, r_files, l_keys, r_keys,
                      payload_columns, mesh, conf: ResidencyConf = ResidencyConf()):
        """Build and register a mesh join region now (idempotent; a region
        with a narrower payload is rebuilt widened)."""
        from .join_residency import build_mesh_join_region, join_region_key

        try:
            key = join_region_key(l_files, r_files, l_keys, r_keys)
        except OSError:
            return None
        existing = self.join_for(l_files, r_files, l_keys, r_keys, payload_columns, mesh, conf)
        if existing is not None:
            return existing
        region, _ = build_mesh_join_region(self, l_by_bucket, r_by_bucket, list(l_keys),
                                           list(r_keys), key, list(payload_columns), mesh, conf)
        if region is None:
            return None
        return region if self._register_join(region, _budget_bytes(conf)) else None

    def join_agg(self, region, group_by, aggs):
        """The two-phase mesh aggregate-join: per shard K2 or K2p and the
        segment epilogue over the shard's owned buckets, the partials
        merged by ``all_reduce`` into one group table, one copy home. None
        when the spec cannot ride the card exactly (the caller routes the
        per-query mesh route); device errors raise."""
        from .join_residency import finish_join_agg, mesh_join_agg_outputs, region_agg_plan

        plan = region_agg_plan(region, list(group_by), list(aggs))
        if plan is None:
            metrics.incr("hbm.mesh.join.declined.dtype")
            return None
        t0 = time.perf_counter()
        outs = fetch_shards_home(region.mesh, mesh_join_agg_outputs(region, plan))
        metrics.record_time("scan.resident_join_agg.mesh_device", time.perf_counter() - t0)
        d2h = sum(int(o.nbytes) for o in outs)
        metrics.incr("scan.resident_join.d2h_bytes", d2h)
        _trace_bytes("d2h_bytes", d2h)
        return finish_join_agg(region, plan, list(group_by), list(aggs), outs)

    # -- the device aggregate ------------------------------------------------
    def agg_scan(self, table, predicate: Expr, group_by, aggs):
        """The mesh device aggregate of an ``agg_scan`` pipeline: K1's mask
        once a shard, the dense-key segment partials over the full slot
        space, ``all_reduce`` into one group table, one copy home.
        ``(batch, "ok")`` or ``(None, reason)`` as the single-device twin;
        device errors raise."""
        from .scan_agg import finish_scan_agg, mesh_scan_agg_outputs, scan_agg_plan

        plan, reason = scan_agg_plan(table, list(group_by), list(aggs))
        if plan is None:
            return None, reason
        prepared = prepare_resident_predicate(table.columns, predicate)
        if prepared is None:
            return None, "predicate"
        t0 = time.perf_counter()
        with _trace_span("scan.agg_dispatch", tier=table.tier,
                         agg="segment_" + ",".join(sorted({a.fn for a in aggs})),
                         span_slots=plan.span, mesh=table.n_devices):
            outs = fetch_shards_home(table.mesh, mesh_scan_agg_outputs(table, prepared, plan))
        metrics.record_time("scan.resident_agg.mesh_device", time.perf_counter() - t0)
        d2h = sum(int(o.nbytes) for o in outs)
        metrics.incr("scan.resident_mesh.d2h_bytes", d2h)
        _trace_bytes("d2h_bytes", d2h)
        batch = finish_scan_agg(table, plan, list(group_by), list(aggs), outs)
        metrics.incr("scan.path.resident_agg_mesh")
        return batch, "ok"

    # -- observability -------------------------------------------------------
    def snapshot_joins(self) -> dict:
        """Mesh join regions held: count, MB, generation, and per region
        its rows, keys, payload, each shard's route and MB."""
        with self._lock:
            return {
                "regions": len(self._joins),
                "mb": round(sum(j.nbytes for j in self._joins) / 1e6, 1),
                "version": self._join_version,
                "per_region": [
                    {"rows_l": j.n_l, "rows_r": j.n_r, "keys": list(j.key[2]),
                     "payload": sorted(j.l_cols) + sorted(j.r_cols), "routes": j.routes,
                     "dev_rows_l": list(j.dev_rows_l), "dev_rows_r": list(j.dev_rows_r),
                     "mb": round(j.nbytes / 1e6, 3)}
                    for j in self._joins
                ],
            }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tables": len(self._tables),
                "deltas": len(self._deltas),
                "joins": len(self._joins),
                "resident_mb": round(self._total_locked() / 1e6, 1),
                "per_table": [
                    {"devices": t.n_devices, "rows": t.n_rows, "dev_rows": list(t.dev_rows),
                     "cap": t.cap, "columns": sorted(t.columns),
                     "mb": round(t.nbytes / 1e6, 1), "tier": t.tier}
                    for t in self._tables
                ],
                "per_delta": [
                    {"devices": d.n_devices, "rows": d.n_rows, "cap": d.cap,
                     "columns": sorted(d.columns), "deleted_ids": len(d.deleted_ids),
                     "mb": round(d.nbytes / 1e6, 1)}
                    for d in self._deltas
                ],
            }


mesh_cache = MeshHbmCache()
