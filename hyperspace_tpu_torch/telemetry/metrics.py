"""Engine path counters and timers: which arm of a routing decision ran,
and how long a named step took.

A process-global registry of named integer counters (``scan.path.*``,
``join.path.*``, ``build.engine.*``), the same names the reference
package counts, so a test or ``chip_smoke.py`` can show which path a
query took; of named host-clock timers (``hbm.prefetch``,
``scan.resident.device``, ``compaction.*``), each a total of seconds and
a count; of gauges (levels: ``incr`` accumulates, ``gauge`` sets); and of
fixed-bucket histograms (``serve.latency_seconds``).

Concurrent serving adds a second axis: with many queries in flight the
global totals cannot say which query paid which cost. ``scoped()`` binds
a CHILD registry to the current ``contextvars`` context: everything
recorded on this thread, and on contexts copied from it (the union's
sides, ``parallel/pool.py``'s workers), also lands in the child, while
the global totals stay as they were. Scopes nest: a recording lands once
in every enclosing scope. Unrelated threads never see the scope, so two
concurrent queries' counters never mix.
"""

from __future__ import annotations

import bisect
import contextvars
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

# the child registry active in this context (None: global only)
_SCOPE: "contextvars.ContextVar[Optional[Metrics]]" = contextvars.ContextVar(
    "hyperspace_tpu_torch_metrics_scope", default=None
)

# histogram bucket ladders: seconds for latencies, bytes for transfers (a
# name ending in ``_bytes`` takes the byte ladder)
TIME_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
BYTE_BUCKETS: Tuple[float, ...] = (
    1024.0, 8192.0, 65536.0, 524288.0, 4194304.0,
    33554432.0, 268435456.0, 1073741824.0,
)


def default_buckets(name: str) -> Tuple[float, ...]:
    return BYTE_BUCKETS if name.endswith("_bytes") else TIME_BUCKETS_S


class _Histogram:
    """Fixed-bucket cell: per-bucket counts (the last past the top bound),
    their sum and count."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += value
        self.count += 1

    def snapshot(self) -> Dict[str, object]:
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": round(self.total, 6), "count": self.count}


class Metrics:
    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._times: Dict[str, Tuple[float, int]] = {}
        self._gauge_names: set = set()
        self._hists: Dict[str, _Histogram] = {}
        self._lock = threading.Lock()
        # the scope enclosing this one when it was opened (scoped())
        self._parent: Optional["Metrics"] = None

    def _each_scope(self):
        """The scopes a recording on this registry also lands in: the
        active one and every one around it, this registry left out."""
        node = _SCOPE.get()
        while node is not None:
            if node is not self:
                yield node
            node = node._parent

    def incr(self, name: str, n: int = 1) -> None:
        for r in (self, *self._each_scope()):
            with r._lock:
                r._counts[name] = r._counts.get(name, 0) + int(n)

    def gauge(self, name: str, value: int) -> None:
        """SET a counter to a level (worker counts, reserved bytes): unlike
        ``incr``, repeated recordings do not accumulate across builds."""
        for r in (self, *self._each_scope()):
            with r._lock:
                r._counts[name] = int(value)
                r._gauge_names.add(name)

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None) -> None:
        """Record ``value`` into histogram ``name``. Its bounds are fixed
        at the first recording."""
        bounds = None
        for r in (self, *self._each_scope()):
            with r._lock:
                h = r._hists.get(name)
                if h is None:
                    bounds = bounds or (tuple(buckets) if buckets else default_buckets(name))
                    h = r._hists[name] = _Histogram(bounds)
                bounds = h.bounds
                h.observe(float(value))

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def record_time(self, name: str, seconds: float) -> None:
        for r in (self, *self._each_scope()):
            with r._lock:
                total, n = r._times.get(name, (0.0, 0))
                r._times[name] = (total + seconds, n + 1)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_time(name, time.perf_counter() - t0)

    def timings(self) -> Dict[str, Tuple[float, int]]:
        """name -> (total seconds, count)."""
        with self._lock:
            return dict(self._times)

    def report(self) -> Dict[str, object]:
        """Every family at once, in the reference's snapshot layout
        (``counters``, ``timers_s``, ``timer_counts``, ``gauges``,
        ``histograms``): what a query's trace and the exporters carry."""
        with self._lock:
            return {
                "counters": dict(self._counts),
                "timers_s": {k: round(v[0], 6) for k, v in self._times.items()},
                "timer_counts": {k: v[1] for k, v in self._times.items()},
                "gauges": {k: self._counts[k] for k in self._gauge_names if k in self._counts},
                "histograms": {k: h.snapshot() for k, h in self._hists.items()},
            }

    @contextmanager
    def scoped(self):
        """Bind a fresh child registry to the current context until exit:
        everything recorded here, and in contexts copied from here, also
        lands in the child (and in every scope around it, once)."""
        child = Metrics()
        child._parent = _SCOPE.get()
        token = _SCOPE.set(child)
        try:
            yield child
        finally:
            _SCOPE.reset(token)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._times.clear()
            self._gauge_names.clear()
            self._hists.clear()


metrics = Metrics()


def residency_snapshot(registry: Optional[Metrics] = None) -> Dict[str, object]:
    """The tier ladder's counters in one dict: which tier served scans,
    what bit-packing bought (packed against raw bytes), and the streaming
    loop's windows, window failures, uploads, prefetch hits and stalls
    (the mesh's streaming tables count there too; the mesh's tables by
    tier are the server's ``"mesh"`` entry)."""
    r = registry if registry is not None else metrics
    raw = r.get("residency.compressed.raw_bytes")
    packed = r.get("residency.compressed.packed_bytes")
    out: Dict[str, object] = {
        "scans_resident": r.get("scan.path.resident_device"),
        "scans_compressed": r.get("scan.path.resident_compressed"),
        "scans_streaming": r.get("scan.path.resident_streaming"),
        "compressed_tables_built": r.get("residency.tier.compressed_built"),
        "streaming_tables_built": r.get("residency.tier.streaming_built"),
        "compressed_raw_bytes": raw,
        "compressed_packed_bytes": packed,
        "stream_windows": r.get("residency.stream.windows"),
        "stream_window_failures": r.get("residency.stream.window_failed"),
        "stream_prefetch_hit": r.get("residency.stream.prefetch_hit"),
        "stream_prefetch_stall": r.get("residency.stream.prefetch_stall"),
        "stream_h2d_bytes": r.get("residency.stream.h2d_bytes"),
    }
    if packed:
        out["effective_capacity_x"] = round(raw / packed, 2)
    return out


def reliability_snapshot(registry: Optional[Metrics] = None) -> Dict[str, int]:
    """The crash-consistency counters in one dict: what the reliability
    layer absorbed (storage retries), refused (fenced writers) and healed
    (auto-rollbacks, swept crash litter), plus the device-loss degrades.
    ``QueryServer.stats()["reliability"]`` reads it."""
    r = registry if registry is not None else metrics
    return {
        "storage_retry_attempts": r.get("storage.retry.attempts"),
        "storage_retry_exhausted": r.get("storage.retry.exhausted"),
        "claim_self_wins": r.get("storage.retry.claim_self_win"),
        "auto_rollbacks": r.get("recovery.auto_rollback"),
        "recovery_sweeps": r.get("recovery.sweep"),
        "orphan_tmp_swept": r.get("recovery.orphan_tmp_swept"),
        "fenced_writers": r.get("lease.fenced_writer_refused"),
        "lease_heartbeat_errors": r.get("lease.heartbeat_error"),
        "doctor_issues_found": r.get("doctor.issues_found"),
        "doctor_issues_repaired": r.get("doctor.issues_repaired"),
        "resident_device_failed": r.get("scan.resident.device_failed"),
        "resident_join_device_failed": r.get("scan.resident_join.device_failed"),
        "stream_window_failed": r.get("residency.stream.window_failed"),
    }


def compile_snapshot(registry: Optional[Metrics] = None) -> Dict[str, object]:
    """The compiler's counters in one dict: lowerings against pipeline
    cache hits (a burst of one structure keeps ``pipelines_lowered`` flat
    while ``cache_hits`` climbs), the fused arms' dispatches, the result
    cache's hits, and the router's warm-compile hints (offered, adopted by
    a host that lowered, declined)."""
    r = registry if registry is not None else metrics
    out: Dict[str, object] = {
        "pipelines_lowered": r.get("compile.lowered"),
        "lower_errors": r.get("compile.lower_error"),
        "cache_hits": r.get("compile.cache.hit"),
        "cache_misses": r.get("compile.cache.miss"),
        "cache_evicted": r.get("compile.cache.evicted"),
        "cache_invalidated": r.get("compile.cache.invalidated"),
        "fused_dispatches": r.get("compile.fused.dispatches"),
        "fused_queries": r.get("compile.fused.queries"),
        "result_hits": r.get("compile.result_cache.hit"),
        "result_misses": r.get("compile.result_cache.miss"),
        "result_admitted": r.get("compile.result_cache.admitted"),
        "result_invalidated": r.get("compile.result_cache.invalidated"),
        "warm_hints_offered": r.get("compile.warm_hint.offered"),
        "warm_hints_adopted": r.get("compile.warm_hint.adopted"),
        "warm_hints_declined": r.get("compile.warm_hint.declined"),
    }
    runs = {kind: r.get(f"compile.run.{kind}")
            for kind in ("scan", "agg_scan", "hybrid", "join_agg", "interpret")}
    out["runs"] = {k: v for k, v in runs.items() if v}
    return out


def result_cache_snapshot(registry: Optional[Metrics] = None) -> Dict[str, object]:
    """The result caches' counters, per level (``serve``:
    ``compile.result_cache.*``, ``router``: ``router.result_cache.*``):
    what admission took or declined (cold structure, byte economics), what
    eviction shed, hits, misses, and misses that were only stale by
    version token."""
    r = registry if registry is not None else metrics
    out: Dict[str, object] = {}
    for level, p in (("serve", "compile.result_cache"), ("router", "router.result_cache")):
        out[level + "_counters"] = {
            "hits": r.get(p + ".hit"),
            "misses": r.get(p + ".miss"),
            "stale_misses": r.get(p + ".stale_miss"),
            "admitted": r.get(p + ".admitted"),
            "declined_cold": r.get(p + ".declined_cold"),
            "declined_bytes": r.get(p + ".declined_bytes"),
            "evicted": r.get(p + ".evicted"),
            "invalidated": r.get(p + ".invalidated"),
        }
    return out


def serve_snapshot(registry: Optional[Metrics] = None) -> Dict[str, int]:
    """The serve tier's counters in one dict: what admission let in, shed
    or breaker-rejected, what the batch path dispatched or declined, and
    what the degradation paths absorbed (worker kills, device-loss
    latches)."""
    r = registry if registry is not None else metrics
    return {
        "submitted": r.get("serve.submitted"),
        "completed": r.get("serve.completed"),
        "shed": r.get("serve.shed"),
        "shed_lowweight": r.get("serve.shed.lowweight"),
        "cancelled": r.get("serve.cancelled"),
        "deadline_missed": r.get("serve.deadline_missed"),
        "plan_errors": r.get("serve.plan_error"),
        "breaker_rejected": r.get("serve.breaker.rejected"),
        "breaker_opened": r.get("serve.breaker.opened"),
        "breaker_probes": r.get("serve.breaker.probe"),
        "breaker_closed": r.get("serve.breaker.closed"),
        "batch_dispatches": r.get("serve.batch.dispatches"),
        "batch_declined": r.get("serve.batch.declined"),
        "batch_errors": r.get("serve.batch.error"),
        "degraded_latches": r.get("serve.degraded"),
        "workers_killed": r.get("serve.worker_killed"),
        "client_retries": r.get("serve.client.retry"),
        "client_retries_exhausted": r.get("serve.client.exhausted"),
    }
