"""Deterministic host-tier chaos: scheduled crash / stall / flap / slow
faults injected at the serve boundary.

Counterpart of ``hyperspace_tpu.reliability.chaos`` (host code).
``reliability/faults.py`` kills *storage calls* on schedule; this module
applies the same replayable-schedule discipline one tier up, to whole
hosts behind the query router. A ``FaultPlan`` is an explicit list of
``HostFault`` rules evaluated against each host's own submission
counter — run the same plan against the same query sequence and the
same submissions are hit, which is what lets a run hard-gate "zero
failed tickets under chaos" instead of eyeballing flaky runs.

* ``crash`` — at the host's N-th submission, close the underlying
  server for good: every in-flight leg fails with ``ServerClosed``, the
  canonical dead host.
* ``flap`` — crash, but the host comes back after ``duration_s``: the
  proxy lazily constructs a FRESH server from its factory (a real
  ``QueryServer.close()`` is terminal, exactly like a dead process — a
  revived host is a new process over the same shared storage). The
  router must readmit it through a probation probe, not assume it back.
* ``stall`` — at the N-th submission the host freezes for
  ``duration_s``: every submission in the window returns a ticket that
  withholds its (real) result until the stall lapses. Results are
  delayed, never corrupted — the slow-host case hedging must beat.
* ``slow`` — per-query latency injection: ``times`` submissions (0 =
  all) from the N-th onward each complete ``delay_s`` late.

``ChaosHostProxy`` duck-types the ``QueryServer`` surface the router
uses (``session`` / ``closed`` / ``submit`` / ``start`` / ``close``),
so chaos wraps hosts without the router knowing; ``FaultPlan.wrap``
builds the proxy map for a router from per-host server factories.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..telemetry.metrics import metrics

__all__ = ["HostFault", "FaultPlan", "ChaosHostProxy"]

KINDS = ("crash", "stall", "flap", "slow")


@dataclass
class HostFault:
    """One scheduled host fault. ``at_query`` is the 0-based index of
    the triggering submission among the host's own submissions (the
    deterministic clock of the schedule); ``duration_s`` is the outage
    (flap) or freeze (stall) length; ``delay_s``/``times`` shape the
    ``slow`` injection (``times=0`` = every submission from the trigger
    on)."""

    kind: str  # "crash" | "stall" | "flap" | "slow"
    host: str
    at_query: int = 0
    duration_s: float = 0.0
    delay_s: float = 0.0
    times: int = 1

    _fired: bool = field(default=False, repr=False)
    _slow_applied: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"Unknown host-fault kind {self.kind!r}.")


@dataclass
class FaultPlan:
    """An explicit, replayable host-fault schedule."""

    rules: List[HostFault] = field(default_factory=list)

    def for_host(self, host: str) -> List[HostFault]:
        return [r for r in self.rules if r.host == host]

    def wrap(
        self, factories: Dict[str, Callable[[], object]]
    ) -> Dict[str, "ChaosHostProxy"]:
        """Proxy map for a router: ``{host: ChaosHostProxy}`` from
        per-host SERVER FACTORIES (not servers — flap revival needs to
        construct a fresh one, the way a restarted process would)."""
        return {
            name: ChaosHostProxy(name, factory, self.for_host(name))
            for name, factory in factories.items()
        }


class _DelayedTicket:
    """A real ticket whose completion is withheld until ``ready_at`` —
    the result underneath is genuine; only its *timing* is injected.
    Mirrors the QueryTicket surface the router touches (``done`` /
    ``result`` / ``cancel`` / ``latency_s``)."""

    def __init__(self, inner, ready_at: float, clock: Callable[[], float]):
        self._inner = inner
        self._ready_at = ready_at
        self._clock = clock

    def done(self) -> bool:
        return self._clock() >= self._ready_at and self._inner.done()

    def result(self, timeout: Optional[float] = None):
        now = self._clock()
        hold = max(self._ready_at - now, 0.0)
        if timeout is not None and timeout < hold:
            time.sleep(timeout)
            raise TimeoutError("query still in flight (injected latency)")
        if hold > 0:
            time.sleep(hold)
        return self._inner.result(
            None if timeout is None else max(timeout - hold, 0.001)
        )

    def cancel(self) -> bool:
        return self._inner.cancel()

    @property
    def latency_s(self):
        return self._inner.latency_s

    @property
    def tenant(self):
        return self._inner.tenant


class ChaosHostProxy:
    """One chaos-wrapped host. Holds the live server plus the schedule
    state: its own submission counter (the deterministic trigger), the
    flap outage window, and the stall window. Revival is LAZY — the
    next ``closed``/``submit`` observation past the outage constructs
    the replacement server — so no background thread is needed and the
    schedule replays identically under any poll timing."""

    def __init__(
        self,
        name: str,
        factory: Callable[[], object],
        rules: List[HostFault],
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self._factory = factory
        self.rules = list(rules)
        self._clock = clock
        self._lock = threading.Lock()
        self._server = factory()
        self._queries = 0
        self._down_until: Optional[float] = None  # flap outage end; None = up
        self._stall_until = 0.0
        self.crashes = 0
        self.revivals = 0
        self.delayed = 0

    # -- QueryServer surface ---------------------------------------------------
    @property
    def session(self):
        return self._server.session

    @property
    def closed(self) -> bool:
        self._maybe_revive()
        return self._server.closed

    def start(self):
        self._maybe_revive()
        if not self._server.closed:
            self._server.start()
        return self

    def close(self, timeout_s: float = 10.0) -> None:
        with self._lock:
            self._down_until = None  # a real close is not an injected outage
        self._server.close(timeout_s)

    def stats(self) -> dict:
        return self._server.stats()

    def ping(self) -> dict:
        self._maybe_revive()
        return self._server.ping()

    def submit(self, df, deadline_s=None, tenant=None, **kw):
        """Apply the schedule at this host's n-th submission, then
        delegate. A crash/flap trigger closes the underlying server
        FIRST so this submission (and every in-flight leg) observes the
        death exactly the way a process exit delivers it."""
        self._maybe_revive()
        delay = 0.0
        with self._lock:
            n = self._queries
            self._queries += 1
            for rule in self.rules:
                if rule.kind == "slow":
                    live = (
                        n >= rule.at_query
                        and (rule.times <= 0 or rule._slow_applied < rule.times)
                    )
                    if live:
                        rule._slow_applied += 1
                        delay = max(delay, rule.delay_s)
                    continue
                if rule._fired or n != rule.at_query:
                    continue
                rule._fired = True
                if rule.kind == "crash":
                    self._kill_locked(revive_after=None)
                elif rule.kind == "flap":
                    self._kill_locked(revive_after=rule.duration_s)
                elif rule.kind == "stall":
                    self._stall_until = self._clock() + rule.duration_s
                    metrics.incr("serve.chaos.stalled")
            stall_left = self._stall_until - self._clock()
        if tenant is None:
            ticket = self._server.submit(df, deadline_s=deadline_s, **kw)
        else:
            ticket = self._server.submit(
                df, deadline_s=deadline_s, tenant=tenant, **kw
            )
        hold = max(delay, stall_left if stall_left > 0 else 0.0)
        if hold > 0:
            self.delayed += 1
            metrics.incr("serve.chaos.delayed")
            return _DelayedTicket(ticket, self._clock() + hold, self._clock)
        return ticket

    # -- schedule internals ----------------------------------------------------
    def _kill_locked(self, revive_after: Optional[float]) -> None:
        self.crashes += 1
        self._down_until = (
            self._clock() + revive_after if revive_after is not None else None
        )
        metrics.incr("serve.chaos.crashed")
        server = self._server
        # close outside our lock would be nicer, but close() only takes
        # the server's own cond and never calls back into the proxy —
        # the order proxy-lock -> server-cond is the only one used here
        server.close(timeout_s=0.0)

    def _maybe_revive(self) -> None:
        with self._lock:
            due = (
                self._down_until is not None
                and self._clock() >= self._down_until
                and self._server.closed
            )
            if not due:
                return
            self._down_until = None
            self.revivals += 1
        # construct the replacement OUTSIDE the lock: a server factory
        # builds sessions/threads and must not serialize the data path
        fresh = self._factory()
        with self._lock:
            self._server = fresh
        metrics.incr("serve.chaos.revived")
