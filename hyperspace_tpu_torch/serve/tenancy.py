"""Multi-tenant serving state: per-tenant quotas, weighted-fair
scheduling, circuit breakers, and drain-rate-derived retry-after.

Counterpart of ``hyperspace_tpu.serve.tenancy``. One QueryServer fronts
many tenants; a single FIFO would let one tenant's burst take the whole
admission budget and every worker. This module holds the per-tenant
state the server schedules over:

* **TenantPolicy / TenantState**: quotas (queue-depth and in-flight caps)
  and weight from the ``hyperspace.serve.tenant.*`` conf family, and the
  tenant's queue, counters and latency reservoir;
* **weighted-fair dispatch** (``pick_tenant_locked``): smooth weighted
  round-robin over the tenants with queued work and in-flight headroom,
  so each tenant's share of dispatches converges to weight / sum(weights);
* **CircuitBreaker**: opened by consecutive deadline misses; while open,
  submissions are rejected for a cooldown, then HALF-OPEN admits one
  probe, whose clean finish closes the circuit;
* **drain rate**: completions per second over a sliding window, so
  ``AdmissionRejected.retry_after_s`` follows the tenant's observed
  throughput.

Every mutating method is called with the server's ``_cond`` lock held
(the ``_locked`` suffix): one lock orders admission, dispatch and breaker
transitions.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..telemetry.metrics import metrics

DEFAULT_TENANT = "default"

# breaker states (stats() strings)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def _snapshot_recorder(reason: str) -> None:
    """Freeze the flight recorder around a breaker transition — the
    post-mortem wants the queries that led to the open (rate-limited
    per reason; an O(ring) copy, safe under the server lock)."""
    from ..telemetry.recorder import flight_recorder

    flight_recorder.snapshot(reason)


def latency_percentiles_ms(latencies) -> dict:
    """``{"latency_p50_ms", "latency_p99_ms"}`` from a latency-seconds
    reservoir (empty dict when empty) — the ONE percentile formula both
    the per-tenant and the global stats() report."""
    lat = sorted(latencies)
    if not lat:
        return {}
    return {
        "latency_p50_ms": round(1e3 * lat[len(lat) // 2], 3),
        "latency_p99_ms": round(
            1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3
        ),
    }


@dataclass(frozen=True)
class TenantPolicy:
    """Quotas + weight for one tenant (conf.serve_tenant_policy)."""

    weight: float = 1.0
    max_queue: int = 32
    max_inflight: int = 0  # <= 0: no per-tenant in-flight cap

    def inflight_cap(self) -> Optional[int]:
        return self.max_inflight if self.max_inflight > 0 else None


class CircuitBreaker:
    """Per-tenant deadline-miss breaker. All transitions run under the
    server lock; ``time`` flows in as an argument so tests drive the
    clock deterministically."""

    def __init__(self, miss_threshold: int, open_s: float):
        self.miss_threshold = max(int(miss_threshold), 1)
        self.open_s = float(open_s)
        self.state = CLOSED
        self.consecutive_misses = 0
        self.open_until = 0.0
        self.probe_inflight = False
        self.opens = 0
        self.probes = 0
        self.closes = 0

    def admit_locked(self, now: float) -> "tuple[bool, Optional[float]]":
        """(admitted, retry_after_s). HALF-OPEN admits exactly one probe
        at a time; OPEN transitions to HALF-OPEN once the cooldown
        lapses (the next submission IS the probe)."""
        if self.state == CLOSED:
            return True, None
        if self.state == OPEN:
            if now < self.open_until:
                return False, max(self.open_until - now, 0.001)
            self.state = HALF_OPEN
            self.probe_inflight = True
            return True, None
        # HALF_OPEN: one probe in flight decides the verdict; everyone
        # else waits for it rather than stampeding a maybe-sick tenant
        if self.probe_inflight:
            return False, max(self.open_s / 4, 0.001)
        self.probe_inflight = True
        return True, None

    def note_probe_admitted_locked(self) -> None:
        """Count the probe once it SURVIVES every admission gate — a
        probe slot granted here but rejected by a later quota gate never
        ran, and counting it would grow probes unboundedly under
        sustained overload."""
        self.probes += 1
        metrics.incr("serve.breaker.probe")

    def record_miss_locked(self, now: float, probe: bool = False) -> None:
        """A deadline miss. CLOSED opens after ``miss_threshold``
        consecutive misses. In HALF-OPEN only the PROBE's miss re-opens:
        leftover pre-open queries draining their doomed deadlines must
        neither free the probe slot nor flap the state under the probe
        that is deciding (their misses still count toward the streak)."""
        self.consecutive_misses += 1
        if self.state == HALF_OPEN:
            if probe:
                self.state = OPEN
                self.open_until = now + self.open_s
                self.probe_inflight = False
                self.opens += 1
                metrics.incr("serve.breaker.opened")
                _snapshot_recorder("breaker_open")
            return
        if (
            self.state == CLOSED
            and self.consecutive_misses >= self.miss_threshold
        ):
            self.state = OPEN
            self.open_until = now + self.open_s
            self.probe_inflight = False
            self.opens += 1
            metrics.incr("serve.breaker.opened")
            _snapshot_recorder("breaker_open")

    def record_success_locked(self) -> None:
        self.consecutive_misses = 0
        self.probe_inflight = False
        if self.state != CLOSED:
            self.state = CLOSED
            self.closes += 1
            metrics.incr("serve.breaker.closed")

    def snapshot_locked(self) -> dict:
        return {
            "state": self.state,
            "consecutive_misses": self.consecutive_misses,
            "opens": self.opens,
            "probes": self.probes,
            "closes": self.closes,
        }


class TenantState:
    """One tenant's queue, quotas, counters, and breaker. Mutated only
    under the server lock."""

    def __init__(
        self,
        name: str,
        policy: TenantPolicy,
        breaker: CircuitBreaker,
        drain_window_s: float,
    ):
        self.name = name
        self.policy = policy
        self.breaker = breaker
        self.drain_window_s = float(drain_window_s)
        self.queue: "deque" = deque()  # _Request entries, FIFO per tenant
        self.inflight = 0
        self.deficit = 0.0  # smooth-WRR credit
        # counters (mirrored into stats()["tenants"][name])
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.rejected_breaker = 0
        self.deadline_missed = 0
        self.cancelled = 0
        self.batched_queries = 0
        self.latencies: "deque[float]" = deque(maxlen=2048)
        # completion timestamps (monotonic) for the drain-rate window
        self.completions: "deque[float]" = deque(maxlen=1024)

    # -- drain rate ----------------------------------------------------------
    def drain_rate_locked(self, now: Optional[float] = None) -> Optional[float]:
        """Completions per second over the sliding window; None until the
        tenant has at least one windowed completion (callers fall back
        to the service-time estimate)."""
        now = time.monotonic() if now is None else now
        cutoff = now - self.drain_window_s
        while self.completions and self.completions[0] < cutoff:
            self.completions.popleft()
        if not self.completions:
            return None
        # rate over the window actually covered, not the full window: a
        # tenant that completed 5 queries in the last 0.2s drains at
        # 25/s, and telling its clients to wait depth/0.5 would be a lie
        span = max(now - self.completions[0], 1e-3)
        return len(self.completions) / span

    def retry_after_locked(
        self, fallback_s: float, now: Optional[float] = None
    ) -> float:
        """Seconds until this tenant's backlog plausibly has room:
        (depth+1)/drain-rate, clamped; the EWMA-derived fallback serves
        tenants with no completions in the window yet."""
        rate = self.drain_rate_locked(now)
        if rate is None or rate <= 0:
            return max(fallback_s, 0.001)
        return min(max((len(self.queue) + 1) / rate, 0.001), 300.0)

    def note_completion_locked(self, now: float, latency_s: Optional[float]) -> None:
        self.completed += 1
        self.completions.append(now)
        if latency_s is not None:
            self.latencies.append(latency_s)

    def snapshot_locked(self) -> dict:
        """Counters only — O(1), safe under the server lock. The caller
        adds percentiles from a latency copy AFTER releasing the lock
        (sorting reservoirs under _cond would stall dispatch)."""
        return {
            "weight": self.policy.weight,
            "max_queue": self.policy.max_queue,
            "max_inflight": self.policy.max_inflight,
            "queue_depth": len(self.queue),
            "inflight": self.inflight,
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "rejected_breaker": self.rejected_breaker,
            "deadline_missed": self.deadline_missed,
            "cancelled": self.cancelled,
            "batched_queries": self.batched_queries,
            "breaker": self.breaker.snapshot_locked(),
        }


def pick_tenant_locked(
    tenants: Dict[str, TenantState],
) -> Optional[TenantState]:
    """The next tenant to dispatch from — smooth weighted round-robin
    over tenants with queued work and in-flight headroom. Returns None
    when no tenant is eligible (empty queues, or every backlogged
    tenant is at its in-flight cap — the caller waits on the cond).

    The recurrence: every eligible tenant gains ``weight`` credit, the
    highest-credit tenant is picked and pays the eligible total. Over N
    picks with stable eligibility each tenant is picked ~N*w/W times
    with bounded burstiness (never more than one extra turn ahead of
    its entitlement)."""
    eligible: List[TenantState] = []
    for t in tenants.values():
        if not t.queue:
            continue
        cap = t.policy.inflight_cap()
        if cap is not None and t.inflight >= cap:
            continue
        eligible.append(t)
    if not eligible:
        return None
    total = 0.0
    best: Optional[TenantState] = None
    for t in eligible:
        total += t.policy.weight
        t.deficit += t.policy.weight
        if best is None or t.deficit > best.deficit:
            best = t
    best.deficit -= total
    return best
