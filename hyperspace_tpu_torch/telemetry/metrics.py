"""Engine path counters and timers: which arm of a routing decision ran,
and how long a named step took.

A process-global registry of named integer counters (``scan.path.*``,
``join.path.*``, ``build.engine.*``), the same names the reference
package counts, so a test or ``chip_smoke.py`` can show which path a
query took; and of named host-clock timers (``hbm.prefetch``,
``scan.resident.device``, ``compaction.*``), each a total of seconds and a count.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple


class Metrics:
    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._times: Dict[str, Tuple[float, int]] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def gauge(self, name: str, value: int) -> None:
        """SET a counter to a level (worker counts, reserved bytes): unlike
        ``incr``, repeated recordings do not accumulate across builds."""
        with self._lock:
            self._counts[name] = int(value)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def record_time(self, name: str, seconds: float) -> None:
        with self._lock:
            total, n = self._times.get(name, (0.0, 0))
            self._times[name] = (total + seconds, n + 1)

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

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._times.clear()


metrics = Metrics()


def residency_snapshot(registry: Optional[Metrics] = None) -> Dict[str, object]:
    """The tier ladder's counters in one dict: which tier served scans,
    what bit-packing bought (packed against raw bytes), and the streaming
    loop's windows, uploads, prefetch hits and stalls. The reference's
    mesh keys are left out with the mesh, and its window-failure count
    with its host recovery (a failed window raises here)."""
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
        "stream_prefetch_hit": r.get("residency.stream.prefetch_hit"),
        "stream_prefetch_stall": r.get("residency.stream.prefetch_stall"),
        "stream_h2d_bytes": r.get("residency.stream.h2d_bytes"),
    }
    if packed:
        out["effective_capacity_x"] = round(raw / packed, 2)
    return out
