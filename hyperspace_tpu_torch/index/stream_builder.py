"""Out-of-core streaming index build: chunk → device bucketize+sort → spill
→ per-bucket merge (or run files).

Counterpart of ``hyperspace_tpu.index.stream_builder``. The reference
builds indexes over sources of any size because Spark streams splits
through executors (CreateActionBase.scala:122-140); this is the explicit
pipeline with the same bounded-memory property:

* **chunk**: source rows arrive in fixed-capacity chunks
  (``parquet_io.iter_relation_file_batches``); small batches coalesce and
  large ones split, so every chunk but the tail is full;
* **device**: each full chunk's key columns go to the card, which computes
  bucket ids, packs (bucket, keys...) into one int64 and sorts it stably.
  With ``runChunks`` R > 1 the sorted composites stay on the card until R
  have landed, then one on-card merge orders the whole run and ONE D2H
  brings back its int32 order (``ops.build.stage_chunk_packed`` /
  ``merge_staged_chunks``); otherwise each chunk makes its own round trip;
* **spill**: each sorted run lands in one spill TCB whose footer carries
  ``bucketCounts`` — rows are grouped by bucket, so a bucket's rows in a
  run are one contiguous row range;
* **finalize**: ``merge`` mode merges each bucket's runs on the host (the
  stable searchsorted tournament) into one file per bucket; ``runs`` mode
  renames the spills into multi-bucket run files.

Every stage runs on the ``parallel.pool`` worker layer with bounded queues:
ingest decode (ordered) → dispatch (main thread: H2D + device work, or the
host sort closure) → spill compute (the D2H wait + host gather, or the host
sort) → spill write → the per-bucket merges. Chunk ORDER is kept end to end
(ordered ingest, sequence-numbered runs, run-ordered stable merges), so the
built index bytes are a serial build's, and the JAX package's: the
``pipeline=off`` serial mode runs the same code inline. A failure in any
stage latches a shared ``FirstError``; every stage drains, teardown joins
every worker, and the first error re-raises on the main thread.

Device work and its copies are ordered explicitly: all of a writer's device
work is queued by the main thread on the writer's own CUDA stream; the
double-buffered host slabs are pinned, and a slot is refilled only after
the event recorded behind its upload has completed; a D2H goes into pinned
memory with ``non_blocking=True`` and the spill worker waits on the event
recorded after it (``ops.build.DeviceFetch``) before it reads.

The auto probe's first device touch runs under the reachability watchdog
(``utils/deviceprobe``): an unreachable card raises
``DeviceUnavailableError``. A writer given a mesh of more than one shard
runs each chunk through the sharded build instead (``build_partition_
sharded``) and spills each shard's rows as a run of its own, behind the
same watchdog on a CUDA mesh (the reference's multi-device arm).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..exceptions import HyperspaceException
from ..ops import DeviceLike, resolve_device
from ..parallel.pool import BoundedSlots, FirstError, WorkerPool, ordered_map, run_parallel
from ..residency import slabs as slab_budget
from ..storage import layout
from ..storage.columnar import Column, ColumnarBatch, is_string
from ..telemetry.metrics import metrics
from ..telemetry.trace import add_bytes as _trace_bytes
from ..telemetry.trace import span as _span
from ..utils.memo import bounded_memo_put

SPILL_DIR_NAME = ".spill"

# the device engine's cap on chunks dispatched but not yet fetched (device
# memory high-water), independent of the spill-compute pool width
DEVICE_INFLIGHT_CHUNKS = 3


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclass(frozen=True)
class BuildPipelineConfig:
    """Worker counts and queue depths of the pipelined build — the
    ``hyperspace.index.build.*`` knobs. ``enabled=False`` is the serial
    mode: every stage runs inline on the caller's thread with no
    background thread."""

    enabled: bool = True
    ingest_workers: int = 1
    spill_compute_workers: int = 1
    spill_write_workers: int = 1
    merge_workers: int = 1
    queue_depth: int = 2

    @staticmethod
    def default() -> "BuildPipelineConfig":
        ncpu = os.cpu_count() or 1
        return BuildPipelineConfig(
            enabled=True,
            ingest_workers=max(1, min(4, ncpu)),
            spill_compute_workers=max(1, ncpu),
            spill_write_workers=max(1, min(2, ncpu)),
            merge_workers=max(1, ncpu),
            queue_depth=2,
        )

    @staticmethod
    def serial() -> "BuildPipelineConfig":
        return BuildPipelineConfig(
            enabled=False,
            ingest_workers=1,
            spill_compute_workers=1,
            spill_write_workers=1,
            merge_workers=1,
            queue_depth=1,
        )

    def host_width(self) -> int:
        """How many spill-compute workers can run host sorts side by side;
        part of the engine-probe cache key."""
        if not self.enabled:
            return 1
        return max(1, min(self.spill_compute_workers, os.cpu_count() or 1))


@dataclass(frozen=True)
class DeviceBuildConfig:
    """The device engine's streaming knobs (``hyperspace.index.build.
    device.*``): ``double_buffer`` rotates a fixed pair of pinned host
    staging slabs under the H2D copy; ``run_chunks`` (R) keeps R sorted
    chunks on the card and merges them there into one spill run
    (``run_chunks=1``: the per-chunk round trip). ``hbm_budget_bytes`` is
    the residency budget the staged runs borrow from (at most half)."""

    double_buffer: bool = True
    run_chunks: int = 4
    hbm_budget_bytes: int = 4096 << 20

    @staticmethod
    def default() -> "DeviceBuildConfig":
        return DeviceBuildConfig()

    @staticmethod
    def per_chunk() -> "DeviceBuildConfig":
        return DeviceBuildConfig(double_buffer=False, run_chunks=1)

    def mode_token(self) -> str:
        return f"db{int(bool(self.double_buffer))}-r{int(self.run_chunks)}"


# Per-process memo of the auto engine probe's winner ("device" | "host"),
# keyed by (device type, chunk capacity, host width, device mode): the
# probe measures the machine's link and cores as much as the programs.
_ENGINE_CACHE: Dict[tuple, str] = {}
_ENGINE_CACHE_MAX = 64


def _engine_cache_key(
    chunk_capacity: int,
    host_width: Optional[int] = None,
    device_mode: Optional[str] = None,
    platform: str = "cuda",
) -> tuple:
    """(platform, capacity, host width, device mode): a verdict measured
    with one host width or one device mode must not bind another."""
    if host_width is None:
        host_width = BuildPipelineConfig.default().host_width()
    if device_mode is None:
        device_mode = DeviceBuildConfig.default().mode_token()
    return (str(platform), chunk_capacity, int(host_width), str(device_mode))


def _probe_cache_path() -> Optional[Path]:
    """Cross-process home of the probe memo, this package's own (the JAX
    package keeps another; neither reads the other's verdict).
    ``HYPERSPACE_TPU_TORCH_PROBE_CACHE`` overrides it; the empty string
    disables it (the tests do)."""
    env = os.environ.get("HYPERSPACE_TPU_TORCH_PROBE_CACHE")
    if env is not None:
        return Path(env) if env else None
    return Path(os.path.expanduser("~/.cache/hyperspace_tpu_torch/engine_probe.json"))


# one day: a verdict from a congested session must not rule an engine out
# for good
PROBE_CACHE_TTL_S = 24 * 3600.0


def _load_persisted_winner(key: tuple) -> Optional[str]:
    p = _probe_cache_path()
    if p is None:
        return None
    try:
        text = p.read_text()
    except OSError:  # absent or unreadable: no verdict
        return None
    try:
        data = json.loads(text)
    except ValueError:
        metrics.incr("build.engine.probe_cache_corrupt")
        return None
    if not isinstance(data, dict):
        metrics.incr("build.engine.probe_cache_corrupt")
        return None
    v = data.get(":".join(str(p) for p in key))
    if not isinstance(v, dict) or v.get("winner") not in ("device", "host"):
        return None
    try:
        if time.time() - float(v["ts"]) > PROBE_CACHE_TTL_S:
            return None
    except (KeyError, TypeError, ValueError):  # missing or bad ts: stale
        return None
    return v["winner"]


def _persist_winner(key: tuple, choice: str) -> None:
    p = _probe_cache_path()
    if p is None:
        return
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        try:
            data = json.loads(p.read_text())
        except (OSError, ValueError):  # fresh or corrupt file: start over
            data = {}
        data[":".join(str(p) for p in key)] = {"winner": choice, "ts": time.time()}
        tmp = p.with_name(p.name + f".tmp-{uuid.uuid4().hex[:8]}")
        tmp.write_text(json.dumps(data, indent=0))
        os.replace(tmp, p)  # atomic: concurrent writers, last write wins
    except Exception:  # noqa: BLE001 - caching must never fail a build
        metrics.incr("build.engine.probe_cache_write_error")


def sort_encoding(col: Column) -> np.ndarray:
    """An integer array whose ascending order equals the index sort order
    of the column: strings by dictionary code (order-preserving within a
    shared vocab), float64 by the ordered-int64 encoding, float32 by the
    same bit trick in 32 bits (-0.0 and NaN included), everything else by
    raw value."""
    if is_string(col.dtype_str):
        return col.data
    d = col.data
    if d.dtype == np.float64:
        from ..ops.floatbits import f64_to_ordered_i64

        return f64_to_ordered_i64(d)
    if d.dtype == np.float32:
        from ..ops.floatbits import f32_to_ordered_i32

        return f32_to_ordered_i32(d)
    return d


def merge_sorted_runs(runs: List[ColumnarBatch], key_names: List[str]) -> ColumnarBatch:
    """Merge key-sorted batches into one key-sorted batch.
    ``ColumnarBatch.concat`` re-encodes string columns onto a shared sorted
    vocab (order-preserving, so each run stays sorted); the runs then merge
    by the stable searchsorted tournament (ops.build.merge_sorted_orders).
    Ties keep run order. Key shapes the int64 composite cannot express
    (63-bit overflow) take a stable lexsort instead."""
    if len(runs) == 1:
        return runs[0]
    merged = ColumnarBatch.concat(runs)
    if merged.num_rows <= 1:
        return merged
    keys = [sort_encoding(merged.columns[k]) for k in key_names]
    if len(keys) == 1:
        comp = keys[0]  # one key: its encoding is directly comparable
    else:
        from ..ops.build import _pack_sort_keys

        comp = _pack_sort_keys(keys, None, 0)
    if comp is None:
        order = np.lexsort(list(reversed(keys)))  # last key is primary
    else:
        from ..ops.build import merge_sorted_orders

        slices = []
        lo = 0
        for r in runs:
            hi = lo + r.num_rows
            slices.append((comp[lo:hi], np.arange(lo, hi, dtype=np.int64)))
            lo = hi
        order = merge_sorted_orders(slices)
    return merged.take(order)


class _HostSlabPair:
    """The fixed pair of host staging buffers under the device engine's H2D
    (the ``doubleBuffer`` knob): the dispatch loop rotates slots instead of
    allocating per chunk. On the card the buffers are pinned, so the upload
    is asynchronous; before a slot is refilled the loop waits on the event
    recorded after that slot's last upload (two chunks back: in steady
    state it has long completed)."""

    def __init__(self, pinned: bool) -> None:
        self._pinned = pinned
        self._bufs: List[Optional[Dict[str, object]]] = [None, None]
        self._fences: List[Optional[object]] = [None, None]
        self._turn = 0

    def stage(self, encoded: Dict[str, np.ndarray]) -> Dict[str, object]:
        import torch

        i = self._turn
        self._turn = 1 - i
        if self._fences[i] is not None:
            self._fences[i].synchronize()
            self._fences[i] = None
        bufs = self._bufs[i]
        if bufs is None:
            bufs = {
                k: torch.empty(
                    a.shape,
                    dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                    pin_memory=self._pinned,
                )
                for k, a in encoded.items()
            }
            self._bufs[i] = bufs
        for k, a in encoded.items():
            np.copyto(bufs[k].numpy(), a)
        metrics.incr("build.device.slab_rotations")
        return bufs

    def fence(self, stream) -> None:
        """Arm the just-filled slot's reuse fence: an event recorded on the
        writer's stream after the slot's upload (no-op off the card)."""
        if stream is None:
            return
        import torch

        ev = torch.cuda.Event()
        ev.record(stream)
        self._fences[1 - self._turn] = ev

    def drop(self) -> None:
        self._bufs = [None, None]
        self._fences = [None, None]


class _DeviceRunStager:
    """Accumulates device-sorted chunks into runs held on the card: chunk
    k's sorted composite and permutation stay on the device until
    ``run_chunks`` chunks have landed — or the run's 63-bit pack budget
    would overflow, or finalize arrives — then ONE on-card merge orders the
    run and ONE non-blocking D2H ships its order to the spill stages. Runs
    never interleave with per-chunk spills: a chunk that cannot stage
    flushes the pending run first, so run sequence numbers (hence merge tie
    order, hence the index bytes) are exactly the serial build's.

    Device memory: the worst-case footprint is reserved against the shared
    residency budget (residency.slabs) before the first chunk stages; a
    refusal means the build runs the per-chunk device path (counted
    ``build.device.staging_declined.budget``), never the CPU. An in-flight
    merge also holds a device slot (BoundedSlots), the per-chunk
    dispatch's high-water rule."""

    # the reservation rule: staged planes (the sorted int64 composite and
    # int64 permutation, 16 B a row) plus the merge's working set (the
    # re-packed composites and int32 orders, each tournament round's
    # merged pair and its searchsorted positions) — 80 B a row of the run
    STAGED_BYTES_PER_ROW = 80

    def __init__(self, writer: "StreamingIndexWriter", device: DeviceBuildConfig):
        self.w = writer
        self.device = device
        self.slab = (
            _HostSlabPair(writer.dev.type == "cuda") if device.double_buffer else None
        )
        self.pending: List = []  # ops.build.StagedChunk
        self.batches: List[ColumnarBatch] = []
        self.union: Optional[List[tuple]] = None
        self.seq: Optional[int] = None
        self._reserved: Optional[bool] = None
        self._budget_tag = f"build-stager-{id(writer)}-{uuid.uuid4().hex[:6]}"

    def ensure_reserved(self, encoded: Dict[str, np.ndarray]) -> bool:
        """One all-or-nothing reservation per build, sized from the first
        eligible chunk's transport widths."""
        if self._reserved is not None:
            return self._reserved
        cap = self.w.chunk_capacity
        slab_bytes = 2 * sum(int(a.nbytes) for a in encoded.values())
        staged = self.STAGED_BYTES_PER_ROW * cap * self.device.run_chunks
        self._reserved = slab_budget.try_reserve(
            self._budget_tag, slab_bytes + staged, self.device.hbm_budget_bytes
        )
        return self._reserved

    def reserve_refused(self) -> bool:
        return self._reserved is False

    def add(self, batch: ColumnarBatch, encoded: Dict[str, np.ndarray],
            bounds: List[tuple], plan: List[tuple]) -> None:
        from ..ops.build import run_pack_plan, stage_chunk_packed

        if self.pending:
            union = [
                (min(a, mn), max(b, mx))
                for (a, b), (mn, mx) in zip(self.union, bounds)
            ]
            if run_pack_plan(union, self.w.num_buckets) is None:
                # the union span overflows 63 bits: flush this run and
                # start a fresh one
                metrics.incr("build.device.run_flush_overflow")
                self.flush()
                union = list(bounds)
        else:
            union = list(bounds)
        if not self.pending:
            # the run's on-disk order slot is its FIRST chunk's ingest
            # position, reserved now so later per-chunk spills order after
            self.seq = self.w._next_seq()
        stream = self.w._stream()
        bufs = self.slab.stage(encoded) if self.slab is not None else encoded
        staged, h2d_bytes = stage_chunk_packed(
            bufs, batch.schema(), self.w.indexed_cols, self.w.num_buckets, plan,
            device=self.w.dev, stream=stream,
        )
        if self.slab is not None:
            self.slab.fence(stream)
        metrics.incr("build.stream.h2d_bytes", h2d_bytes)
        metrics.incr("build.device.staged_chunks")
        _trace_bytes("h2d_bytes", h2d_bytes)
        self.union = union
        self.pending.append(staged)
        self.batches.append(batch)
        if len(self.pending) >= self.device.run_chunks:
            self.flush()

    def flush(self) -> None:
        """Merge the pending chunks into one sorted run on the card and hand
        its in-flight D2H to the spill stages; the next chunk's work
        overlaps the copy. No-op when nothing pends."""
        r = len(self.pending)
        if r == 0:
            return
        from ..ops.build import merge_staged_chunks, run_pack_plan

        w = self.w
        run_plan = run_pack_plan(self.union, w.num_buckets)
        if run_plan is None:  # add() flushes before an overflow
            raise HyperspaceException("Staged run pack plan overflowed 63 bits.")
        staged, batches, seq = self.pending, self.batches, self.seq
        self.pending, self.batches, self.union, self.seq = [], [], None, None
        # a merged run not yet fetched pins device memory like a chunk not
        # yet fetched: the same in-flight slot rule
        w._device_slots.acquire()
        try:
            t0 = time.perf_counter()
            fetch = merge_staged_chunks(
                staged, run_plan, w.num_buckets, stream=w._stream()
            )
            metrics.record_time("build.stream.device_merge", time.perf_counter() - t0)
        except BaseException:
            w._device_slots.release()
            raise
        del staged  # the fetch keeps what the copies still read
        d2h_bytes = 4 * r * w.chunk_capacity + 8 * w.num_buckets
        metrics.incr("build.device.staged_runs")
        _trace_bytes("d2h_bytes", d2h_bytes)

        def finish(fetch=fetch, batches=batches, d2h_bytes=d2h_bytes):
            from ..ops.build import _canonicalize_f64

            try:
                order, counts = fetch.wait()
                order = order.astype(np.int64, copy=False)
                counts = counts[: w.num_buckets].astype(np.int64, copy=False)
                metrics.incr("build.stream.d2h_calls")
                metrics.incr("build.stream.d2h_bytes", d2h_bytes)
                # gather the rows straight from the R source chunks in
                # merged order: no concatenated copy
                out = ColumnarBatch.gather_concat(batches, order)
                _canonicalize_f64(out)
                return out, counts
            finally:
                w._device_slots.release()

        w._enqueue_spill(finish, seq=seq)

    def drop(self) -> None:
        """Abort-path teardown: device references released, the budget
        uncharged. Idempotent."""
        self.pending = []
        self.batches = []
        self.union = None
        self.seq = None
        if self.slab is not None:
            self.slab.drop()
        slab_budget.release(self._budget_tag)
        self._reserved = None


class StreamingIndexWriter:
    """Accumulates chunks into spilled sorted runs; ``finalize()`` merges
    them into the final per-bucket TCB files (or promotes them to run
    files).

    ``chunk_capacity`` (rounded up to a power of two, as in the reference)
    is the chunk size every full chunk has. ``add_chunk`` accepts batches
    of any size: small ones are buffered and coalesced, large ones split.
    ``device`` is the torch device the device engine runs on."""

    def __init__(
        self,
        indexed_cols: List[str],
        num_buckets: int,
        out_dir: str | Path,
        chunk_capacity: int,
        extra_meta: Optional[dict] = None,
        engine: str = "auto",
        finalize_mode: str = "merge",
        pipeline: Optional[BuildPipelineConfig] = None,
        device_build: Optional[DeviceBuildConfig] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        if chunk_capacity < 1:
            raise HyperspaceException("chunk_capacity must be positive.")
        if finalize_mode not in ("merge", "runs"):
            raise HyperspaceException(f"Unsupported finalize_mode {finalize_mode!r}.")
        self.indexed_cols = list(indexed_cols)
        self.num_buckets = num_buckets
        self.finalize_mode = finalize_mode
        self.out_dir = Path(out_dir)
        self.chunk_capacity = _next_pow2(chunk_capacity)
        self.extra_meta = extra_meta
        self.pipeline = pipeline if pipeline is not None else BuildPipelineConfig.default()
        self.device = (
            device_build if device_build is not None else DeviceBuildConfig.default()
        )
        self.dev = resolve_device(device)
        self.mesh = mesh
        # chunk engine: device | host | auto (host probe on chunk 0, link
        # check, device on chunk 1, timed device probe on chunk 2, then the
        # measured winner — see _route_engine)
        self._engine = engine
        self._probe: Dict[str, float] = {}
        self._spill_dir = self.out_dir / SPILL_DIR_NAME
        self._spills: List[Path] = []
        self._spill_counts: List[np.ndarray] = []
        self._pending: List[ColumnarBatch] = []
        self._pending_rows = 0
        self._rows = 0
        self._chunk_times: List[float] = []
        self._finalized = False
        # spill stages: the compute pool runs the D2H wait + host gather
        # (device engine) or the host partition+sort; each finished run
        # goes to the write pool (file IO). Runs carry their chunk's
        # SEQUENCE number, so completion order never changes the on-disk
        # run order (merge stability).
        self._err = FirstError()
        self._compute_pool: Optional[WorkerPool] = None
        self._write_pool: Optional[WorkerPool] = None
        self._spill_lock = threading.Lock()
        self._spill_by_seq: Dict[int, tuple] = {}
        self._chunk_seq = 0
        self._device_slots = BoundedSlots(DEVICE_INFLIGHT_CHUNKS, self._err)
        # the writer's own CUDA stream, made on first device use
        self._cuda_stream = None
        self._stager: Optional[_DeviceRunStager] = None
        self._t_first_add: Optional[float] = None
        self._t_pipeline_done: Optional[float] = None

    def _stream(self):
        """The CUDA stream all of this writer's device work is queued on
        (None off the card)."""
        if self.dev.type != "cuda":
            return None
        if self._cuda_stream is None:
            import torch

            self._cuda_stream = torch.cuda.Stream(device=self.dev)
        return self._cuda_stream

    def _route_engine(self, batch_rows: int) -> str:
        """Which engine runs THIS chunk. Fixed engines pass through. Auto
        probes the host first (chunk 0), then checks the raw link: when
        moving one chunk's key bytes up and its order back already takes
        longer than the whole host sort, the device cannot win. Otherwise
        chunk 1 runs on the device, chunk 2 is the timed device round trip,
        and the measured winner takes the rest. Probes run only on full
        chunks; a partial chunk without a verdict takes the in-memory
        build's engine, the device."""
        if self._engine in ("device", "host"):
            return self._engine
        key = self._cache_key()
        cached = _ENGINE_CACHE.get(key)
        if cached is not None:
            return cached
        persisted = _load_persisted_winner(key)
        if persisted is not None and (
            persisted == "host" or batch_rows >= self.chunk_capacity
        ):
            bounded_memo_put(_ENGINE_CACHE, key, persisted, _ENGINE_CACHE_MAX)
            metrics.incr("build.engine.winner_from_disk_cache")
            return persisted
        if batch_rows < self.chunk_capacity:
            return "device"
        ci = len(self._chunk_times)
        if ci == 0:
            return "probe-host"
        if ci == 1:
            return "device"
        if ci == 2:
            return "probe-device"
        return self._decide_winner()

    def _cache_key(self) -> tuple:
        return _engine_cache_key(
            self.chunk_capacity,
            self.pipeline.host_width(),
            self.device.mode_token(),
            self.dev.type,
        )

    def _host_scale(self) -> float:
        """How much faster than the one-thread probe the host engine runs
        under this pipeline (spill-compute workers sort side by side)."""
        return float(self.pipeline.host_width())

    def _link_rules_out_device(self, sample: ColumnarBatch) -> bool:
        """True when a timed round trip of the device path's unavoidable
        transfer — the key columns up, a permutation down — already exceeds
        the host sort's effective time: the device engine cannot win."""
        host_s = self._probe.get("host_s")
        if host_s is None:
            return False
        # the process's first device touch pays backend init, and on a
        # wedged card blocks: the watchdog bounds it (and serves as the
        # untimed warmup, so init is never timed as link bandwidth)
        from ..utils.deviceprobe import require_device

        require_device(self.dev)
        try:
            import torch

            from ..ops import fence

            # staged outside the timed window: only its readback counts
            perm_back = torch.zeros(sample.num_rows, dtype=torch.int64, device=self.dev)
            fence(self.dev)
            t0 = time.perf_counter()
            total = 0
            for name in self.indexed_cols:
                data = np.require(sample.columns[name].data, requirements=["C", "W"])
                torch.from_numpy(data).to(self.dev)
                total += data.nbytes
            fence(self.dev)
            perm_back.cpu()
            total += sample.num_rows * 8
            link_s = time.perf_counter() - t0
        except Exception:  # noqa: BLE001 - probing must never fail a build
            metrics.incr("build.engine.probe_link_error")
            return False
        metrics.record_time("build.engine.probe_link", link_s)
        return total > 0 and link_s > host_s / self._host_scale()

    def _publish_winner(self, choice: str, by_link: bool = False) -> None:
        """The one place the probe's verdict is recorded: probe state, the
        per-process memo, the machine's cache file and the counters."""
        self._probe["winner"] = 1.0 if choice == "host" else 0.0
        key = self._cache_key()
        bounded_memo_put(_ENGINE_CACHE, key, choice, _ENGINE_CACHE_MAX)
        _persist_winner(key, choice)
        metrics.incr(f"build.engine.auto_chose_{choice}")
        if by_link:
            metrics.incr("build.engine.auto_chose_host_by_link")

    def _decide_winner(self) -> str:
        """Pick (and memoize) the probed winner; finalize() also calls it,
        so a 3-chunk build publishes its measurement."""
        if "winner" not in self._probe:
            dev = self._probe.get("device_s")
            host = self._probe.get("host_s")
            host_eff = None if host is None else host / self._host_scale()
            self._publish_winner(
                "host"
                if host_eff is not None and (dev is None or host_eff < dev)
                else "device"
            )
        return "host" if self._probe["winner"] else "device"

    def _try_stage_chunk(self, batch: ColumnarBatch) -> bool:
        """Route one chunk into the run stager if eligible. An ineligible
        chunk FLUSHES any pending run first — runs never interleave with
        per-chunk spills, because stable tie order IS the on-disk run order
        — then returns False for the per-chunk path. Every decline is
        counted."""
        if self.device.run_chunks < 2:
            metrics.incr("build.device.staging_declined.disabled")
            return False
        if self.device.run_chunks * self.chunk_capacity > (1 << 31) - 1:
            # the merged order ships as int32: runs beyond 2^31 rows cannot
            metrics.incr("build.device.staging_declined.width")
            return False
        if batch.num_rows != self.chunk_capacity:
            # the partial tail routes per chunk; it arrives last, so
            # flushing first keeps run order
            metrics.incr("build.device.staging_declined.tail")
            self._flush_staged()
            return False
        if self._engine != "device" and _ENGINE_CACHE.get(self._cache_key()) != "device":
            # auto mode mid-probe: chunk 1's device dispatch stays the
            # per-chunk one the probe times
            metrics.incr("build.device.staging_declined.probe")
            return False
        dtypes = batch.schema()
        if any(is_string(dtypes[k]) for k in self.indexed_cols):
            # per-chunk vocab codes are not comparable across chunks: the
            # host merge re-encodes onto a union vocab, the device
            # composite cannot
            metrics.incr("build.device.staging_declined.string_key")
            self._flush_staged()
            return False
        if any(dtypes[k] == "float32" for k in self.indexed_cols):
            # float keys never pack (their sort operand is a bit transform)
            metrics.incr("build.device.staging_declined.pack")
            self._flush_staged()
            return False
        if self._stager is not None and self._stager.reserve_refused():
            metrics.incr("build.device.staging_declined.budget")
            return False
        from ..ops.build import run_pack_plan, stage_encode

        encoded, bounds = stage_encode(batch, self.indexed_cols)
        plan = None if bounds is None else run_pack_plan(bounds, self.num_buckets)
        if plan is None:
            # this chunk cannot pack to 63 bits (the per-chunk path runs
            # the successive-sort program instead)
            metrics.incr("build.device.staging_declined.pack")
            self._flush_staged()
            return False
        if self._stager is None:
            self._stager = _DeviceRunStager(self, self.device)
        if not self._stager.ensure_reserved(encoded):
            metrics.incr("build.device.staging_declined.budget")
            self._flush_staged()
            return False
        self._stager.add(batch, encoded, bounds, plan)
        return True

    def _flush_staged(self) -> None:
        if self._stager is not None:
            self._stager.flush()

    def _next_seq(self) -> int:
        seq = self._chunk_seq  # main thread only: add_chunk/finalize
        self._chunk_seq += 1
        return seq

    def _spill_run_at(
        self, seq: int, sorted_batch: ColumnarBatch, counts: np.ndarray
    ) -> None:
        """Persist one bucket-grouped, key-sorted run under its chunk
        sequence number. The index-level extra_meta rides every spill
        footer so runs-mode finalize can promote the file as it is."""
        self._spill_dir.mkdir(parents=True, exist_ok=True)
        p = self._spill_dir / f"run-{seq:05d}-{uuid.uuid4().hex[:8]}.tcb"
        layout.write_batch(
            p,
            sorted_batch,
            sorted_by=self.indexed_cols,
            extra={
                **(self.extra_meta or {}),
                "bucketCounts": [int(c) for c in counts],
            },
        )
        with self._spill_lock:
            self._spill_by_seq[seq] = (p, np.asarray(counts, dtype=np.int64))

    # -- spill pipeline -------------------------------------------------------
    def _ensure_pools(self) -> None:
        if self._compute_pool is not None:
            return
        pipe = self.pipeline
        self._compute_pool = WorkerPool(
            pipe.spill_compute_workers,
            "spill-compute",
            queue_depth=pipe.queue_depth,
            failure=self._err,
        )
        self._write_pool = WorkerPool(
            pipe.spill_write_workers,
            "spill-write",
            queue_depth=pipe.queue_depth,
            failure=self._err,
        )
        metrics.gauge("build.stream.workers.spill_compute", pipe.spill_compute_workers)
        metrics.gauge("build.stream.workers.spill_write", pipe.spill_write_workers)

    def _enqueue_spill(self, finish, seq: Optional[int] = None) -> None:
        """Route one dispatched chunk (or one staged run) through the spill
        stages: compute = the D2H wait + host gather (device engine) or the
        host partition+sort (host engine); write = the spill file. The
        stage timers sum worker busy time: under the pipeline their sum
        above wall time is the overlap working. ``seq`` pins an order slot
        reserved earlier (a staged run reserves its first chunk's)."""
        if seq is None:
            seq = self._next_seq()
        if not self.pipeline.enabled:
            t0 = time.perf_counter()
            batch, counts = finish()
            t1 = time.perf_counter()
            self._spill_run_at(seq, batch, counts)
            metrics.record_time("build.stream.spill_compute", t1 - t0)
            metrics.record_time("build.stream.spill_write", time.perf_counter() - t1)
            return
        self._ensure_pools()

        def compute_task(seq=seq, finish=finish) -> None:
            t0 = time.perf_counter()
            batch, counts = finish()
            metrics.record_time("build.stream.spill_compute", time.perf_counter() - t0)

            def write_task(seq=seq, batch=batch, counts=counts) -> None:
                t0 = time.perf_counter()
                self._spill_run_at(seq, batch, counts)
                metrics.record_time("build.stream.spill_write", time.perf_counter() - t0)

            # bounded submit: a full write queue backpressures the compute
            # workers, which backpressure the dispatch loop — the memory
            # bound. False means the pipeline already failed.
            self._write_pool.submit(write_task)

        self._compute_pool.submit(compute_task)
        self._err.check()

    def _drain_spills(self) -> None:
        if self._compute_pool is not None:
            self._compute_pool.close()  # flushes its write_pool submits
        if self._write_pool is not None:
            self._write_pool.close()
        self._compute_pool = None
        self._write_pool = None
        self._err.check()
        with self._spill_lock:
            items = sorted(self._spill_by_seq.items())
        self._spills = [p for _, (p, _c) in items]
        self._spill_counts = [c for _, (_p, c) in items]

    def abort(self) -> None:
        """Best-effort teardown after a failed build: drain and join every
        pool worker, release staged device memory and the budget charge,
        remove the spill files. Safe to call repeatedly or after
        finalize()."""
        if self._compute_pool is not None:
            self._compute_pool.abort()
        if self._write_pool is not None:
            self._write_pool.abort()
        self._compute_pool = None
        self._write_pool = None
        if self._stager is not None:
            self._stager.drop()
            self._stager = None
        self._err = FirstError()  # a reused writer must not re-raise
        shutil.rmtree(self._spill_dir, ignore_errors=True)
        self._finalized = True

    # -- ingest ---------------------------------------------------------------
    def add_chunk(self, batch: ColumnarBatch) -> None:
        """Buffer rows and run capacity-sized chunks. Coalescing across calls
        keeps the cost proportional to rows, not files; oversized batches
        are split."""
        if self._finalized:
            raise HyperspaceException("Writer already finalized.")
        if batch.num_rows == 0:
            return
        self._pending.append(batch)
        self._pending_rows += batch.num_rows
        while self._pending_rows >= self.chunk_capacity:
            merged = (
                self._pending[0]
                if len(self._pending) == 1
                else ColumnarBatch.concat(self._pending)
            )
            emit = merged.take(np.arange(self.chunk_capacity))
            rest = merged.take(np.arange(self.chunk_capacity, merged.num_rows))
            self._pending = [rest] if rest.num_rows else []
            self._pending_rows = rest.num_rows
            self._process_chunk(emit)

    def _process_chunk(self, batch: ColumnarBatch) -> None:
        if self._t_first_add is None:
            self._t_first_add = time.perf_counter()
        t0 = time.perf_counter()
        if self.mesh is not None and self.mesh.size > 1 and self._mesh_touch_ok():
            self._process_chunk_sharded(batch, t0)
            return
        engine = self._route_engine(batch.num_rows)
        if engine == "device" and self._try_stage_chunk(batch):
            # the chunk's sorted composite stays on the card awaiting its
            # run merge; the stager enqueues one spill per R chunks
            metrics.incr("build.engine.device")
            self._chunk_times.append(time.perf_counter() - t0)
            metrics.record_time("build.stream.dispatch", self._chunk_times[-1])
            self._err.check()
            self._rows += batch.num_rows
            metrics.incr("build.stream.chunks")
            metrics.incr("build.stream.rows", batch.num_rows)
            return
        if engine in ("host", "probe-host"):
            from ..ops.build import build_partition_host

            self._flush_staged()
            metrics.incr("build.engine.host")
            if engine == "probe-host":
                t1 = time.perf_counter()
                result = build_partition_host(batch, self.indexed_cols, self.num_buckets)
                self._probe["host_s"] = time.perf_counter() - t1
                metrics.record_time("build.engine.probe_host", self._probe["host_s"])
                if self._link_rules_out_device(result[0]):
                    self._publish_winner("host", by_link=True)
                finish = lambda r=result: r  # noqa: E731
            else:
                # the host sort runs on a spill thread, overlapping the
                # next chunk's decode
                finish = lambda b=batch: build_partition_host(  # noqa: E731
                    b, self.indexed_cols, self.num_buckets
                )
        else:
            from ..ops.build import build_partition_single

            # dispatch H2D + device work on the writer's stream with the
            # D2H in flight; a spill worker waits for the copy and gathers,
            # overlapping the next chunk. The slot blocks dispatch while
            # DEVICE_INFLIGHT_CHUNKS results await their fetch.
            self._flush_staged()
            metrics.incr("build.engine.device")
            self._device_slots.acquire()
            try:
                inner = build_partition_single(
                    batch,
                    self.indexed_cols,
                    self.num_buckets,
                    device=self.dev,
                    defer=True,
                    stream=self._stream(),
                )
            except BaseException:
                self._device_slots.release()
                raise

            def finish(inner=inner):
                try:
                    return inner()
                finally:
                    self._device_slots.release()

            if engine == "probe-device":
                # the probe waits here on the main thread, so its time
                # covers the whole device round trip
                t1 = time.perf_counter()
                result = finish()
                self._probe["device_s"] = time.perf_counter() - t1
                metrics.record_time("build.engine.probe_device", self._probe["device_s"])
                finish = lambda r=result: r  # noqa: E731
        self._chunk_times.append(time.perf_counter() - t0)
        metrics.record_time("build.stream.dispatch", self._chunk_times[-1])
        self._enqueue_spill(finish)
        self._rows += batch.num_rows
        metrics.incr("build.stream.chunks")
        metrics.incr("build.stream.rows", batch.num_rows)

    def _mesh_touch_ok(self) -> bool:
        """The reference's guard on the mesh arm: its first device touch
        runs under the reachability watchdog (a CPU mesh touches no card)."""
        if self.mesh.device_type != "cuda":
            return True
        from ..utils.deviceprobe import first_device_touch_ok

        return first_device_touch_ok()

    def _process_chunk_sharded(self, batch: ColumnarBatch, t0: float) -> None:
        """The mesh arm: the chunk through ``build_partition_sharded`` (one
        all_to_all exchange), then each shard's bucket-grouped rows spilled
        as their own run, synchronously (the shards' rows come back
        materialized). A chunk's runs hold disjoint buckets, so the
        finalize merge gives each bucket the single-device order."""
        from ..ops.build import build_partition_sharded

        self._flush_staged()
        per_shard, _ = build_partition_sharded(
            batch, self.indexed_cols, self.num_buckets, self.mesh
        )
        self._chunk_times.append(time.perf_counter() - t0)
        metrics.record_time("build.stream.dispatch", self._chunk_times[-1])
        for shard_batch, bucket_ids in per_shard:
            if shard_batch.num_rows == 0:
                continue
            counts = np.bincount(bucket_ids, minlength=self.num_buckets)
            self._spill_run_at(self._next_seq(), shard_batch, counts)
        self._rows += batch.num_rows
        metrics.incr("build.stream.chunks")
        metrics.incr("build.stream.rows", batch.num_rows)

    # -- finalize -------------------------------------------------------------
    def finalize(self) -> List[Path]:
        """Merge spilled runs bucket at a time and write the final index
        files (or promote the runs). Returns the written paths, sorted."""
        if self._finalized:
            raise HyperspaceException("Writer already finalized.")
        if self._pending:
            tail = (
                self._pending[0]
                if len(self._pending) == 1
                else ColumnarBatch.concat(self._pending)
            )
            self._pending = []
            self._pending_rows = 0
            self._process_chunk(tail)
        # a staged run may still pend when the source was an exact multiple
        # of the chunk capacity (no tail to force the flush)
        self._flush_staged()
        self._drain_spills()
        if self._stager is not None:
            self._stager.drop()  # releases the slab pair and the reservation
            self._stager = None
        if self._engine == "auto" and "device_s" in self._probe and "host_s" in self._probe:
            # a 3-chunk build completes both probes without reaching the
            # deciding chunk: publish the measurement for the next build
            self._decide_winner()
        if self._t_first_add is not None:
            self._t_pipeline_done = time.perf_counter()
            metrics.record_time(
                "build.stream.pipeline_wall", self._t_pipeline_done - self._t_first_add
            )
        self._finalized = True
        t0 = time.perf_counter()
        written: List[Path] = []
        if self._spills and self.finalize_mode == "runs":
            # promote the spilled runs to final multi-bucket data files: a
            # rename, not a rewrite; queries read per-bucket row ranges
            # through the footer's bucketCounts
            self.out_dir.mkdir(parents=True, exist_ok=True)
            for i, sp in enumerate(self._spills):
                p = self.out_dir / layout.run_file_name(i)
                os.replace(sp, p)
                written.append(p)
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            metrics.record_time("build.stream.finalize", time.perf_counter() - t0)
            metrics.incr("build.stream.run_files", len(written))
            self._record_split()
            return sorted(written)
        if self._spills:
            # per-spill cumulative row offsets of each bucket segment; one
            # reader per spill, shared by the merge workers (mmap range
            # reads are thread-safe; the vocab memo is locked)
            offsets = [np.concatenate([[0], np.cumsum(c)]) for c in self._spill_counts]
            readers = [layout.TcbReader(p) for p in self._spills]
            totals = np.sum(self._spill_counts, axis=0)
            self.out_dir.mkdir(parents=True, exist_ok=True)

            def merge_bucket(b: int):
                t_r = time.perf_counter()
                runs = []
                for reader, off in zip(readers, offsets):
                    s, e = int(off[b]), int(off[b + 1])
                    if e > s:
                        runs.append(reader.read(row_range=(s, e)))
                t_m = time.perf_counter()
                merged = merge_sorted_runs(runs, self.indexed_cols)
                t_w = time.perf_counter()
                p = self.out_dir / layout.bucket_file_name(b)
                layout.write_batch(
                    p, merged, sorted_by=self.indexed_cols, bucket=b, extra=self.extra_meta
                )
                return p, t_m - t_r, t_w - t_m, time.perf_counter() - t_w

            # buckets are independent (disjoint row ranges in, distinct
            # files out): the merges fan out across the pool
            buckets = [b for b in range(self.num_buckets) if totals[b] > 0]
            workers = self.pipeline.merge_workers if self.pipeline.enabled else 1
            results = run_parallel(
                [lambda b=b: merge_bucket(b) for b in buckets],
                workers,
                name="bucket-merge",
            )
            read_s = merge_s = write_s = 0.0
            for p, r_s, m_s, w_s in results:
                written.append(p)
                read_s += r_s
                merge_s += m_s
                write_s += w_s
            metrics.record_time("build.stream.merge_read", read_s)
            metrics.record_time("build.stream.merge_sort", merge_s)
            metrics.record_time("build.stream.merge_write", write_s)
            shutil.rmtree(self._spill_dir, ignore_errors=True)
        metrics.record_time("build.stream.finalize", time.perf_counter() - t0)
        self._record_split()
        return sorted(written)

    def _record_split(self) -> None:
        st = self.stats
        if "first_chunk_s" in st:
            metrics.record_time("build.stream.first_chunk", st["first_chunk_s"])
        if "steady_total_s" in st:
            metrics.record_time("build.stream.steady", st["steady_total_s"])
            metrics.incr("build.stream.steady_rows", int(st["steady_rows"]))

    # -- stats ----------------------------------------------------------------
    @property
    def stats(self) -> Dict[str, float]:
        """The first-chunk/steady split: the first chunk (in auto mode the
        slowest of the probe window) bears the one-off costs; steady time
        is the pipeline's wall time from the first chunk to the drain,
        less that chunk's dispatch."""
        out: Dict[str, float] = {
            "rows": float(self._rows),
            "chunks": float(len(self._chunk_times)),
            "chunk_capacity": float(self.chunk_capacity),
        }
        if self._chunk_times:
            probe_window = 3 if self._engine == "auto" else 1
            bearer = max(self._chunk_times[:probe_window])
            out["first_chunk_s"] = bearer
            if (
                len(self._chunk_times) > 1
                and self._t_first_add is not None
                and self._t_pipeline_done is not None
            ):
                pipeline_s = self._t_pipeline_done - self._t_first_add
                steady_s = max(pipeline_s - bearer, 0.0)
                steady_rows = self._rows - min(self._rows, self.chunk_capacity)
                out["steady_total_s"] = steady_s
                out["steady_rows"] = float(steady_rows)
                out["steady_chunk_s_avg"] = steady_s / (len(self._chunk_times) - 1)
                if steady_rows > 0 and steady_s > 0:
                    out["steady_rows_per_s"] = steady_rows / steady_s
        return out


def prefetch_chunks(
    chunks: Iterable[ColumnarBatch], depth: int = 1
) -> Iterator[ColumnarBatch]:
    """Run the chunk producer (source decode) on a background thread so
    ingest overlaps the device work and the spill writes. ``depth`` bounds
    the chunks in flight. Producer exceptions re-raise at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    failure: List[BaseException] = []

    def put_unless_stopped(item) -> bool:
        """A bounded put with a shutdown check: if the consumer dies mid
        build, the producer exits instead of blocking on the full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in chunks:
                if not put_unless_stopped(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            failure.append(e)
        finally:
            put_unless_stopped(sentinel)

    t = threading.Thread(target=produce, daemon=True, name="chunk-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                t.join()
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def write_index_data_streaming(
    chunks: Optional[Iterable[ColumnarBatch]],
    indexed_cols: List[str],
    num_buckets: int,
    out_dir: str | Path,
    chunk_capacity: int,
    extra_meta: Optional[dict] = None,
    engine: str = "auto",
    finalize_mode: str = "merge",
    chunk_tasks: Optional[Iterable] = None,
    pipeline: Optional[BuildPipelineConfig] = None,
    device_build: Optional[DeviceBuildConfig] = None,
    device: DeviceLike = None,
    mesh=None,
) -> List[Path]:
    """Drive a StreamingIndexWriter over source chunks. A failure anywhere
    tears the pipeline down (no parked workers, no spill files left) before
    the first error re-raises on this thread.

    Ingest comes in two shapes: ``chunks``, a sequential iterator
    (prefetched one chunk ahead under the pipelined mode), or
    ``chunk_tasks``, zero-arg callables each decoding one source slice into
    a list of batches (parquet_io.file_chunk_tasks), spread over
    ``pipeline.ingest_workers`` with results consumed in task order, so the
    built bytes never depend on decode parallelism.
    ``build.stream.ingest_wait`` records the main thread's time blocked on
    ingest."""
    pipe = pipeline if pipeline is not None else BuildPipelineConfig.default()
    writer = StreamingIndexWriter(
        indexed_cols,
        num_buckets,
        out_dir,
        chunk_capacity,
        extra_meta=extra_meta,
        engine=engine,
        finalize_mode=finalize_mode,
        pipeline=pipe,
        device_build=device_build,
        device=device,
        mesh=mesh,
    )
    if chunks is None and chunk_tasks is None:
        raise HyperspaceException("write_index_data_streaming needs chunks or chunk_tasks.")
    ingest_parallel = chunk_tasks is not None and pipe.enabled and pipe.ingest_workers > 1
    it = None
    try:
        if ingest_parallel:

            def decode(task):
                t0 = time.perf_counter()
                out = task()
                metrics.record_time("build.stream.ingest_decode", time.perf_counter() - t0)
                return out

            metrics.gauge("build.stream.workers.ingest", pipe.ingest_workers)
            it = ordered_map(
                decode,
                chunk_tasks,
                pipe.ingest_workers,
                window=pipe.ingest_workers + pipe.queue_depth,
                name="ingest",
                failure=writer._err,
            )
        elif chunk_tasks is not None and chunks is None:
            # the decode tasks inline, in order
            chunks = (c for task in chunk_tasks for c in task())
        if it is None:
            it = iter(prefetch_chunks(chunks)) if pipe.enabled else iter(chunks)
            batched = False
        else:
            batched = True
        wait_s = 0.0
        # the build loop's stages as spans (under a trace the caller opened):
        # the ingest + dispatch loop, with its ingest wait, then finalize
        with _span("build.ingest_dispatch") as ingest_span:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                wait_s += time.perf_counter() - t0
                if batched:
                    for chunk in item:
                        writer.add_chunk(chunk)
                else:
                    writer.add_chunk(item)
            if ingest_span is not None:
                ingest_span.labels["ingest_wait_s"] = round(wait_s, 4)
        metrics.record_time("build.stream.ingest_wait", wait_s)
        with _span("build.finalize"):
            return writer.finalize()
    except BaseException:
        if it is not None and hasattr(it, "close"):
            it.close()  # join the ingest workers before the spill teardown
        writer.abort()
        raise
