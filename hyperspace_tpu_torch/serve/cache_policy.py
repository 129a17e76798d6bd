"""Telemetry-driven admission policy for the result cache.

Counterpart of ``hyperspace_tpu.serve.cache_policy``. A query's trace
already records what a result cache needs to decide whether memoizing is
worth the bytes: the observed recompute cost (the wall inside
``compile.pipeline_run`` / ``query.interpret``) and the structural
``batch_fingerprint``, whose repeat rate predicts whether the same shape
of work comes back. The rule:

    admit  iff  cost_s * repeats * byte_rate >= nbytes

A cached byte pays for itself when the seconds it saves, scaled by how
often its fingerprint was seen lately, exceed its storage cost at the
configured exchange rate. A fingerprint seen for the first time in the
window declines (``declined_cold``). ``AdmissionWindow`` keys on the
structure, not on the value-level result key: literals vary, shapes
repeat.
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Optional


class AdmissionWindow:
    """Sliding window of fingerprints observed at admission decisions.

    ``observe(fp)`` records one sighting and returns how many times
    ``fp`` now appears in the window INCLUDING this sighting — so the
    first-ever sighting returns 1 (cold), the second returns 2, etc.
    """

    def __init__(self, size: int = 512):
        self._lock = threading.Lock()
        self._size = max(int(size), 1)
        self._order: "deque[object]" = deque()
        self._counts: "Counter[object]" = Counter()

    def observe(self, fingerprint: object, size: Optional[int] = None) -> int:
        with self._lock:
            if size is not None and int(size) >= 1:
                self._size = int(size)
            self._order.append(fingerprint)
            self._counts[fingerprint] += 1
            while len(self._order) > self._size:
                old = self._order.popleft()
                self._counts[old] -= 1
                if self._counts[old] <= 0:
                    del self._counts[old]
            return self._counts[fingerprint]

    def repeats(self, fingerprint: object) -> int:
        with self._lock:
            return self._counts.get(fingerprint, 0)

    def reset(self) -> None:
        with self._lock:
            self._order.clear()
            self._counts.clear()


def should_admit(
    nbytes: int,
    cost_s: float,
    repeats: int,
    byte_rate: int,
    max_bytes: int,
) -> str:
    """Classify one admission decision.

    Returns ``"admit"``, ``"declined_cold"`` (first sighting in the
    window), or ``"declined_bytes"`` (over the per-entry ceiling, or the
    cost×repeat-rate value does not cover the byte cost).
    """
    if nbytes > max_bytes:
        return "declined_bytes"
    if repeats < 2:
        return "declined_cold"
    if float(cost_s) * repeats * max(int(byte_rate), 1) < nbytes:
        return "declined_bytes"
    return "admit"


def recompute_cost_s(trace, fallback_s: float) -> float:
    """Observed recompute cost of one query: the summed wall of its
    device/interpreter execution spans (``compile.pipeline_run`` wraps
    dispatch + D2H; ``query.interpret`` is the fallback leg). Children
    like ``scan.device_dispatch`` nest INSIDE these, so summing only the
    top execution spans never double-counts. When tracing is off (the
    spans are conf-gated) the caller's direct wall measurement wins."""
    if trace is None:
        return max(float(fallback_s), 0.0)
    total = 0.0
    try:
        for s in trace.root.walk():
            if s.name in ("compile.pipeline_run", "query.interpret"):
                d = s.duration_s
                if d is not None:
                    total += d
    except Exception:  # noqa: BLE001 - a malformed trace must not fail a store
        from ..telemetry.metrics import metrics

        metrics.incr("serve.cache_policy.trace_error")
        return max(float(fallback_s), 0.0)
    return total if total > 0.0 else max(float(fallback_s), 0.0)
