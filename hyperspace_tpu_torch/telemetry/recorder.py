"""Flight recorder: a bounded ring of the last N completed query traces.

Counterpart of ``hyperspace_tpu.telemetry.recorder``. Post-mortems need
the queries around a failure, not just the failure: when a batch fails
on the card, a breaker opens, or the shed ladder starts rejecting, the
evidence is what the serve tier did in the seconds before. The recorder
keeps:

* a **ring** of the last N completed ``QueryTrace``s (every collect()
  and every served ticket records here when tracing is on);
* **snapshots**: on a batch's device error, a breaker opening or a shed,
  the serve tier freezes the ring (plus the failing dispatch's in-flight
  traces) under a reason tag, at most once per reason a second; capture
  is a deque copy and traces render when read.

Conf ``hyperspace.telemetry.recorder.entries`` / ``.snapshots`` bound
the rings (process-global; the last session constructed wins). Surfaces:
``session.last_traces()`` and ``QueryServer.stats()``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from .metrics import metrics
from .trace import QueryTrace

DEFAULT_ENTRIES = 64
DEFAULT_SNAPSHOTS = 8
# one picture per reason per interval: failure events arrive in storms
SNAPSHOT_MIN_INTERVAL_S = 1.0


class FlightRecorder:
    def __init__(
        self,
        entries: int = DEFAULT_ENTRIES,
        snapshots: int = DEFAULT_SNAPSHOTS,
    ):
        self._lock = threading.Lock()
        self._ring: "deque[QueryTrace]" = deque(maxlen=max(int(entries), 1))
        self._snapshots: "deque[dict]" = deque(maxlen=max(int(snapshots), 1))
        self._last_snapshot_at: Dict[str, float] = {}

    def configure(
        self,
        entries: Optional[int] = None,
        snapshots: Optional[int] = None,
    ) -> None:
        """Re-bound the rings, preserving the newest contents (process-
        global singleton: the last-constructed session's conf wins — the
        residency-knob semantics)."""
        with self._lock:
            if entries is not None and int(entries) != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(int(entries), 1))
            if (
                snapshots is not None
                and int(snapshots) != self._snapshots.maxlen
            ):
                self._snapshots = deque(
                    self._snapshots, maxlen=max(int(snapshots), 1)
                )

    # -- recording -----------------------------------------------------------
    def record(self, trace: QueryTrace) -> None:
        with self._lock:
            self._ring.append(trace)

    def snapshot(
        self,
        reason: str,
        extra_traces: Sequence[Optional[QueryTrace]] = (),
    ) -> Optional[dict]:
        """Freeze the ring under ``reason``; ``extra_traces`` are the
        failing dispatch's in-flight traces (may be unfinished — their
        open spans render with duration None). Returns the snapshot, or
        None when rate-limited. O(ring) deque copy — safe to call under
        the server lock; rendering happens at read time."""
        now = time.monotonic()
        with self._lock:
            last = self._last_snapshot_at.get(reason)
            if last is not None and now - last < SNAPSHOT_MIN_INTERVAL_S:
                return None
            self._last_snapshot_at[reason] = now
            snap = {
                "reason": reason,
                "at_monotonic": round(now, 3),
                "traces": list(self._ring),
                "inflight": [t for t in extra_traces if t is not None],
            }
            self._snapshots.append(snap)
        metrics.incr("telemetry.recorder.snapshots")
        return snap

    # -- reading -------------------------------------------------------------
    def last(self, n: Optional[int] = None) -> List[QueryTrace]:
        """The most recent completed traces, newest first."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out if n is None else out[: max(int(n), 0)]

    def snapshots(self) -> List[dict]:
        """Snapshot dicts (newest last), traces rendered to plain dicts."""
        with self._lock:
            raw = list(self._snapshots)
        return [_render_snapshot(s) for s in raw]

    def dump(self) -> dict:
        """The whole recorder as JSON-ready dicts, to save next to a
        post-mortem."""
        with self._lock:
            ring = list(self._ring)
            raw = list(self._snapshots)
        return {
            "entries": len(ring),
            "traces": [t.to_dict() for t in ring],
            "snapshots": [_render_snapshot(s) for s in raw],
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._snapshots.clear()
            self._last_snapshot_at.clear()


def _render_snapshot(snap: dict) -> dict:
    return {
        "reason": snap["reason"],
        "at_monotonic": snap["at_monotonic"],
        "traces": [t.to_dict() for t in snap["traces"]],
        "inflight": [t.to_dict() for t in snap["inflight"]],
    }


flight_recorder = FlightRecorder()


def adopt_conf(conf) -> None:
    """Adopt the session conf's recorder bounds (HyperspaceSession
    construction calls this — the residency adopt_conf pattern)."""
    flight_recorder.configure(
        entries=conf.telemetry_recorder_entries(),
        snapshots=conf.telemetry_recorder_snapshots(),
    )
