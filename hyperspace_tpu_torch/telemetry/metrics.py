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
from typing import Dict, Tuple


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
