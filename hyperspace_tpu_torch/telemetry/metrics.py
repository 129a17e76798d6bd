"""Engine path counters: which arm of a routing decision ran.

A process-global registry of named integer counters (``scan.path.*``,
``join.path.*``, ``build.engine.*``), the same names the reference
package counts, so a test or ``chip_smoke.py`` can show which path a
query took.
"""

from __future__ import annotations

import threading
from typing import Dict


class Metrics:
    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


metrics = Metrics()
