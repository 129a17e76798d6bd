"""Host health director: the per-host failure-lifecycle state machine
the query router dispatches against.

Counterpart of ``hyperspace_tpu.distributed.health`` (host code, the same
states, thresholds, counters and flight-recorder snapshots). Two host
states, ``closed`` or not, would be a one-way door: a host that crashes
and comes back would never be used again, and a host that is merely
*slow* would look healthy until it had held a whole fan-out hostage.
This module gives every host the full lifecycle::

    healthy ──failures──▶ suspect ──more──▶ dead
       ▲                                      │ cooldown
       │         probe leg succeeds           ▼
       └───────── (readmitted) ◀────────── probation

* **healthy / suspect** — serving normally; ``suspect`` marks a host
  whose legs keep losing hedges or erroring but has not yet crossed the
  death threshold (consecutive-failure counting, reset on any success).
* **dead** — an observed ``ServerClosed`` (unambiguous) or the failure
  streak crossing ``dead_after``. Dead hosts take no legs; their
  partitions fail over to survivors.
* **probation** — after ``probation_cooldown_s`` the next leg routed at
  the host IS the probe, exactly one in flight at a time — the tenancy
  ``CircuitBreaker`` half-open discipline (serve/tenancy.py) applied at
  host granularity. A clean probe readmits the host
  (``router.health.readmitted``); a failed probe sends it back to dead
  with a fresh cooldown, so a flapping host converges to serving only
  while it actually serves.

The director also owns the per-host **latency reservoir** that derives
the hedge delay: ``hedge_delay_s(host)`` is the host's own
``hedge_quantile`` latency (clamped), i.e. "hedge once this leg is
slower than 95% of this host's history" — the classic tail-tolerant
request hedge, per host rather than per fleet so one slow host does not
inflate everyone's trigger.

Lock discipline: the director's lock is a LEAF — no router or server
code runs under it. Transitions are decided under the lock and the
resulting events (metrics, trace spans, flight-recorder snapshots) are
emitted after release, so the recorder's own locking can never invert.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..telemetry.metrics import metrics
from ..telemetry.recorder import flight_recorder
from ..telemetry.trace import span

__all__ = ["HEALTHY", "SUSPECT", "DEAD", "PROBATION", "HealthPolicy", "HealthDirector"]

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
PROBATION = "probation"


@dataclass(frozen=True)
class HealthPolicy:
    """Knobs for the host state machine and the hedge trigger. Counts
    are CONSECUTIVE failures (any success resets); times are seconds."""

    suspect_after: int = 1  # failures before healthy -> suspect
    dead_after: int = 3  # failures before suspect -> dead
    probation_cooldown_s: float = 0.25  # dead -> probation eligibility
    hedge_quantile: float = 0.95  # per-host latency quantile = hedge delay
    hedge_min_delay_s: float = 0.02  # never hedge faster than this
    hedge_max_delay_s: float = 2.0  # never wait longer than this to hedge
    hedge_min_samples: int = 8  # no hedging until the reservoir has data
    latency_window: int = 512  # per-host reservoir size


class _HostHealth:
    """One host's record. Mutated only under the director's lock."""

    __slots__ = (
        "name",
        "state",
        "consecutive_failures",
        "dead_since",
        "probe_inflight",
        "latencies",
        "deaths",
        "readmissions",
        "probes",
        "probe_failures",
    )

    def __init__(self, name: str, window: int):
        self.name = name
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.dead_since = 0.0
        self.probe_inflight = False
        self.latencies: "deque[float]" = deque(maxlen=window)
        self.deaths = 0
        self.readmissions = 0
        self.probes = 0
        self.probe_failures = 0


# (metric suffix, snapshot?) per transition kind — every transition is
# counted; the terminal/recovery ones also freeze the flight recorder
_EVENT_METRIC = {
    "suspect": ("router.health.suspect", False),
    "dead": ("router.health.dead", True),
    "probation": ("router.health.probation", True),
    "readmitted": ("router.health.readmitted", True),
    "recovered": ("router.health.recovered", False),
    "probe": ("router.health.probe", False),
    "probe_failed": ("router.health.probe_failed", False),
}


class HealthDirector:
    """Per-host health state machine + latency reservoirs. Thread-safe;
    ``clock`` flows in so tests drive time deterministically."""

    def __init__(
        self,
        hosts: Iterable[str],
        policy: Optional[HealthPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or HealthPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._hosts: Dict[str, _HostHealth] = {
            name: _HostHealth(name, self.policy.latency_window) for name in hosts
        }

    def _host_locked(self, name: str) -> _HostHealth:
        h = self._hosts.get(name)
        if h is None:
            h = _HostHealth(name, self.policy.latency_window)
            self._hosts[name] = h
        return h

    # -- event emission (outside the lock) -----------------------------------
    def _emit(self, events: List[Tuple[str, str, str]]) -> None:
        """events: (kind, host, detail). Metrics + trace span per event;
        flight-recorder snapshots for the lifecycle-defining ones. Runs
        with NO director lock held — the recorder copies its ring under
        its own lock and must never nest inside ours."""
        for kind, host, detail in events:
            metric, snap = _EVENT_METRIC[kind]
            with span("router.health.transition", host=host, to=kind):
                metrics.incr(metric)
                if snap:
                    reason = f"router_host_{kind}: {host}"
                    if detail:
                        reason += f" ({detail})"
                    flight_recorder.snapshot(reason)

    # -- queries --------------------------------------------------------------
    def state(self, host: str) -> str:
        with self._lock:
            return self._host_locked(host).state

    def usable(self, host: str) -> bool:
        """May this host take a (non-probe) leg right now? Dead hosts may
        not; probation hosts may — their legs double as probe evidence."""
        with self._lock:
            return self._host_locked(host).state != DEAD

    def admit_leg(self, host: str) -> Tuple[bool, bool]:
        """Gate one leg at dispatch: ``(admit, is_probe)``. Healthy and
        suspect hosts admit normally. A dead host past its cooldown
        transitions to probation and admits this ONE leg as the probe
        (the half-open discipline); before the cooldown, or while a
        probe is already in flight, the leg is declined and the caller
        routes it to a survivor."""
        events: List[Tuple[str, str, str]] = []
        with self._lock:
            h = self._host_locked(host)
            if h.state in (HEALTHY, SUSPECT):
                return True, False
            now = self._clock()
            if h.state == DEAD:
                if now < h.dead_since + self.policy.probation_cooldown_s:
                    return False, False
                h.state = PROBATION
                h.probe_inflight = True
                h.probes += 1
                events.append(("probation", host, ""))
                events.append(("probe", host, ""))
            elif h.probe_inflight:
                return False, False
            else:
                h.probe_inflight = True
                h.probes += 1
                events.append(("probe", host, ""))
        self._emit(events)
        return True, True

    # -- outcomes -------------------------------------------------------------
    def note_success(self, host: str, latency_s: float, probe: bool = False) -> None:
        """A leg served by ``host`` finished cleanly in ``latency_s``.
        Resets the failure streak, feeds the hedge reservoir, closes
        probation (readmission) or suspicion."""
        events: List[Tuple[str, str, str]] = []
        with self._lock:
            h = self._host_locked(host)
            h.consecutive_failures = 0
            h.latencies.append(float(latency_s))
            if h.state == PROBATION:
                h.state = HEALTHY
                h.probe_inflight = False
                h.readmissions += 1
                events.append(("readmitted", host, f"latency={latency_s:.4f}s"))
            elif h.state == SUSPECT:
                h.state = HEALTHY
                events.append(("recovered", host, ""))
        self._emit(events)

    def note_failure(self, host: str, why: str, probe: bool = False) -> None:
        """A leg served by ``host`` failed softly (lost its hedge, timed
        out, errored without an unambiguous close). Escalates along the
        consecutive-failure thresholds; a probation PROBE's failure goes
        straight back to dead with a fresh cooldown."""
        events: List[Tuple[str, str, str]] = []
        with self._lock:
            h = self._host_locked(host)
            h.consecutive_failures += 1
            if h.state == PROBATION:
                if probe or h.probe_inflight:
                    self._to_dead_locked(h, events, f"probe_failed:{why}")
                    h.probe_failures += 1
                    events.append(("probe_failed", host, why))
            elif h.state == HEALTHY and (
                h.consecutive_failures >= self.policy.suspect_after
            ):
                h.state = SUSPECT
                events.append(("suspect", host, why))
            if h.state == SUSPECT and (
                h.consecutive_failures >= self.policy.dead_after
            ):
                self._to_dead_locked(h, events, why)
        self._emit(events)

    def mark_dead(self, host: str, why: str) -> None:
        """An unambiguous death (observed ServerClosed). Idempotent —
        re-marking a dead host does not restart its cooldown; the first
        death timestamp decides when probation opens."""
        events: List[Tuple[str, str, str]] = []
        with self._lock:
            h = self._host_locked(host)
            if h.state == PROBATION:
                h.probe_failures += 1
                events.append(("probe_failed", host, why))
            if h.state != DEAD:
                h.consecutive_failures += 1
                self._to_dead_locked(h, events, why)
        self._emit(events)

    def note_revived(self, host: str) -> None:
        """An operator (or chaos plan) says the host is back: make its
        probation due IMMEDIATELY — the next leg routed at it is the
        probe. Readmission still requires that probe to succeed."""
        with self._lock:
            h = self._host_locked(host)
            if h.state == DEAD:
                h.dead_since = self._clock() - self.policy.probation_cooldown_s

    def _to_dead_locked(self, h: _HostHealth, events, why: str) -> None:
        h.state = DEAD
        h.dead_since = self._clock()
        h.probe_inflight = False
        h.deaths += 1
        events.append(("dead", h.name, why))

    # -- hedging --------------------------------------------------------------
    def hedge_delay_s(self, host: str) -> Optional[float]:
        """How long to wait on ``host`` before hedging its leg to a
        survivor: the host's own ``hedge_quantile`` latency, clamped to
        [hedge_min_delay_s, hedge_max_delay_s]. None until the reservoir
        has ``hedge_min_samples`` points — hedging on no evidence would
        just double-issue every cold query."""
        p = self.policy
        with self._lock:
            h = self._host_locked(host)
            if len(h.latencies) < max(p.hedge_min_samples, 1):
                return None
            lat = sorted(h.latencies)
        q = lat[min(len(lat) - 1, int(len(lat) * p.hedge_quantile))]
        return min(max(q, p.hedge_min_delay_s), p.hedge_max_delay_s)

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                name: {
                    "state": h.state,
                    "consecutive_failures": h.consecutive_failures,
                    "deaths": h.deaths,
                    "readmissions": h.readmissions,
                    "probes": h.probes,
                    "probe_failures": h.probe_failures,
                    "latency_samples": len(h.latencies),
                }
                for name, h in self._hosts.items()
            }
