"""QueryServer: multi-tenant concurrent query serving over one session.

Counterpart of ``hyperspace_tpu.serve.server`` (single device). The
session API executes one query per ``collect()`` on the calling thread;
this server puts per-tenant admission queues, a weighted-fair
dispatcher and a worker pool between callers and the executor:

* **per-tenant admission control**: ``submit(df, tenant=...)`` passes
  per-tenant quotas (queue depth, in-flight, weight: the
  ``hyperspace.serve.tenant.*`` conf family) before the global bound;
  ``AdmissionRejected`` carries the tenant, its depth and a retry-after
  from the tenant's observed drain rate;
* **weighted-fair dispatch**: workers take the next query by smooth
  weighted round-robin over the backlogged tenants (``serve/tenancy.py``);
* **snapshot-pinned reads**: each admitted query pins the index-log
  version it was admitted under (the plan cache's version token), so a
  concurrent refresh or optimize never tears it across two generations;
* **per-query deadlines**: a query whose deadline passes while queued
  fails without running; repeated misses open the tenant's circuit
  breaker;
* **micro-batching**: a worker that takes a batchable resident scan
  drains every compatible queued request (across tenants) and serves them
  with ONE launch (``serve/batcher.py``); the shed ladder turns widening
  off under load.

A device error (a ``RuntimeError``) in a batch latches the server
``degraded`` with its reason, drops the table, freezes the flight recorder
(``device_loss``), counts ``serve.degraded`` once and re-serves that batch
query by query. While latched the server neither batches nor routes
resident: each query runs through an executor with residency off, on the
card's per-file route (the reference's host engine). A device probe
verdict of False (``utils/deviceprobe.py``) latches the same way, and
tickets submitted then fail with ``DeviceUnavailableError``. A kernel
that cannot build fails the batch's tickets with its error, unlatched. A
batch the launch declines (not an error) is served query by query. The
submit path hosts two throttled background sweeps: crash recovery
(abandoned writers rolled back) and compaction.

Tickets: ``submit()`` returns a QueryTicket at once; ``result()`` blocks
for that query, ``cancel()`` withdraws it while queued. Workers run each
query under a scoped metrics registry, so a ticket carries its own
counters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..exceptions import HyperspaceException
from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics, reliability_snapshot, serve_snapshot
from ..telemetry.recorder import flight_recorder
from ..telemetry.trace import QueryTrace, span
from . import batcher, tenancy
from .plan_cache import PlanCache
from .tenancy import DEFAULT_TENANT, CircuitBreaker, TenantState


class AdmissionRejected(HyperspaceException):
    """Admission refused. ``reason`` says which gate fired (queue_full /
    tenant_queue_full / shed_lowweight / breaker_open); ``retry_after_s``
    is derived from the tenant's observed drain rate where one exists."""

    def __init__(
        self,
        queue_depth: int,
        retry_after_s: float,
        tenant: Optional[str] = None,
        tenant_depth: Optional[int] = None,
        reason: str = "queue_full",
    ):
        super().__init__(
            f"admission rejected ({reason}): queue depth {queue_depth}"
            + (
                f", tenant {tenant!r} depth {tenant_depth}"
                if tenant is not None
                else ""
            )
            + f"; retry after ~{retry_after_s:.3f}s"
        )
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        self.tenant_depth = tenant_depth
        self.reason = reason


class DeadlineExceeded(HyperspaceException):
    pass


class QueryCancelled(HyperspaceException):
    """The ticket was withdrawn via cancel() before dispatch."""


class ServerClosed(HyperspaceException):
    pass


@dataclass
class ServeConfig:
    max_workers: int = 4
    # GLOBAL queue bound (sum across tenants); per-tenant caps come from
    # the hyperspace.serve.tenant.* conf family
    max_queue: int = 64
    # applied when submit() passes no deadline; None = no deadline
    default_deadline_s: Optional[float] = None
    # largest number of compatible queries one dispatch coalesces;
    # 1 disables micro-batch widening outright
    batch_max: int = 64
    plan_cache_entries: int = 256
    # tests construct paused servers (submit a burst, then start()) to
    # make coalescing deterministic; production keeps the default
    autostart: bool = True
    # how often the submit path may start a background COMPACTION sweep
    # (index/compactor.py: runs-layout indexes converge toward per-bucket
    # files while the server serves snapshot-pinned reads). None: conf
    # hyperspace.index.compaction.intervalSeconds; <= 0 disables. Sweeps
    # run only when hyperspace.index.compaction.enabled is "auto".
    compaction_sweep_interval_s: Optional[float] = None
    # how often the submit path consults crash recovery: at most one
    # background sweep per interval rolls back abandoned writers
    # (transient log head + expired lease). <= 0 disables.
    recovery_sweep_interval_s: float = 60.0


class QueryTicket:
    """Handle for one submitted query. ``result()`` blocks until the
    server finishes it (or ``timeout`` passes — TimeoutError), then
    returns the ColumnarBatch or raises what execution raised.
    ``cancel()`` withdraws the query if it is still queued."""

    def __init__(self, deadline_at: Optional[float], tenant: str = DEFAULT_TENANT):
        self._done = threading.Event()
        self._result: Optional[ColumnarBatch] = None
        self._error: Optional[BaseException] = None
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.deadline_at = deadline_at
        self.tenant = tenant
        # the index-log snapshot this query admitted under — the sorted
        # (name, id, state) tuple of ACTIVE indexes from the plan-cache
        # version token; the optimized plan serves exactly this snapshot
        self.pinned_log_version: Optional[tuple] = None
        self.batch_size = 1  # queries sharing this one's device dispatch
        self.metrics: Optional[dict] = None  # per-query scoped snapshot
        # per-query span trace (telemetry.trace.QueryTrace; None when
        # hyperspace.telemetry.tracing=off): admission -> queue-wait ->
        # dispatch -> D2H stage boundaries, finished and rung into the
        # flight recorder by _finish
        self.trace: Optional[QueryTrace] = None
        # server-side backrefs for cancel(); None once no longer queued
        self._server: Optional["QueryServer"] = None
        self._request: Optional["_Request"] = None
        self._tenant_state: Optional[TenantState] = None
        self._is_probe = False  # this submission is a breaker half-open probe

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Withdraw the query if it is still QUEUED: True when this call
        removed it (result() then raises QueryCancelled), False when it
        already dispatched, finished, or was never enqueued — dispatch
        and cancel race under the server lock, exactly one wins."""
        server = self._server
        if server is None or self._done.is_set():
            return False
        return server._cancel(self)

    def result(self, timeout: Optional[float] = None) -> ColumnarBatch:
        if not self._done.wait(timeout):
            raise TimeoutError("query still in flight")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def wait_s(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


class _Request:
    __slots__ = (
        "df",
        "plan",
        "resident",
        "ticket",
        "tenant",
        "inflight_charged",
        "result_key",
    )

    def __init__(self, df, plan, resident, ticket, tenant, result_key=None):
        self.df = df
        self.plan = plan
        self.resident = resident  # Optional[batcher.ResidentScanRequest]
        self.ticket = ticket
        self.tenant = tenant  # TenantState
        # True once this request holds an in-flight slot; the worker's
        # finally decrements only charged requests, so a kill landing
        # between batch registration and the charge cannot corrupt the
        # tenant's in-flight accounting in either direction
        self.inflight_charged = False
        # RESULT-cache memo key (compile.result_cache) when the conf
        # enables it — a successful single execution stores under it
        self.result_key = result_key


class QueryServer:
    def __init__(self, session, config: Optional[ServeConfig] = None):
        self.session = session
        self.config = config or ServeConfig()
        self.plan_cache = PlanCache(self.config.plan_cache_entries)
        self._cond = threading.Condition()
        self._tenants: Dict[str, TenantState] = {}
        # O(1)/O(backlogged) admission bookkeeping (all under _cond): a
        # running global depth, the registered-weight summary, and the
        # set of tenants with queued work — admission and dispatch run
        # per query under the one lock, so O(all-tenants-ever-seen)
        # rescans there would serialize the serve tier at fleet scale
        # (tenants never deregister; idle ones must cost nothing)
        self._backlogged: Dict[str, TenantState] = {}
        self._depth = 0
        self._weight_set: set = set()
        self._min_weight: Optional[float] = None
        self._workers: List[threading.Thread] = []
        self._closed = False
        # conf-driven tenancy knobs, resolved once at construction (the
        # per-tenant policy itself resolves lazily at first submit so
        # conf edits before a tenant's first query apply to it)
        conf = session.conf
        self._breaker_miss_threshold = conf.serve_breaker_miss_threshold()
        self._breaker_open_s = conf.serve_breaker_open_seconds()
        self._shed_highwater = conf.serve_shed_highwater_fraction()
        self._shed_batch_off = conf.serve_shed_batch_off_fraction()
        self._drain_window_s = conf.serve_drain_rate_window_seconds()
        # the card the workers launch on, with its index made explicit on
        # this thread: each worker selects it (a new thread starts on card 0)
        from ..exec.hbm_cache import _device

        self._device = _device(session.device)
        # result-cache admission window: fingerprints seen at admission
        # decisions, sized by conf (serve/cache_policy — the repeat-rate
        # signal of the telemetry-driven admission rule)
        from .cache_policy import AdmissionWindow

        self._rc_window = AdmissionWindow(conf.compile_result_cache_window())
        # serving stats (guarded by _cond's lock)
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._shed = 0
        self._rejected_breaker = 0
        self._cancelled = 0
        self._deadline_missed = 0
        self._dispatches = 0  # device dispatches for batched queries
        self._batched_queries = 0
        self._batch_sizes: Dict[int, int] = {}
        self._latencies: "deque[float]" = deque(maxlen=4096)
        self._waits: "deque[float]" = deque(maxlen=4096)
        self._ewma_service_s = 0.01
        # scheduler-turn log: which tenant each dispatch slot went to —
        # the fairness evidence stats() reports
        self._dispatch_order: "deque[str]" = deque(maxlen=4096)
        self._workers_killed = 0
        self._compaction_sweeps = 0
        self._compaction_steps = 0
        self._next_compaction_sweep = 0.0
        self._compaction_running = False  # one sweep in flight at a time
        # the device-loss latch and its first reason; unavailable is a
        # probe verdict (tickets fail), not a launch error (queries degrade)
        self._degraded_latch = threading.Event()
        self._degraded_reason: Optional[str] = None
        self._unavailable = False
        self._recovery_sweeps = 0
        self._recovered_indexes = 0
        self._next_recovery_sweep = 0.0  # monotonic; 0 = sweep on first submit
        if self.config.autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def start(self) -> "QueryServer":
        """Spawn the worker pool (idempotent)."""
        with self._cond:
            if self._closed:
                raise ServerClosed("query server is closed.")
            missing = self.config.max_workers - len(self._workers)
            for i in range(missing):
                t = threading.Thread(
                    target=self._worker_loop,
                    daemon=True,
                    name=f"hyperspace-serve-{len(self._workers)}",
                )
                self._workers.append(t)
                t.start()
        return self

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting work, fail queued queries with ServerClosed,
        and join the workers (in-flight queries finish)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending: List[_Request] = []
            for t in self._tenants.values():
                pending.extend(t.queue)
                t.queue.clear()
            self._backlogged.clear()
            self._depth = 0
            self._cond.notify_all()
            workers = list(self._workers)
        for req in pending:
            self._finish(req.ticket, error=ServerClosed("server closed."))
        for t in workers:
            t.join(timeout_s)

    def ping(self) -> dict:
        """Lightweight liveness probe (the router's health director calls
        it before spending a real query on a probation probe): no queue, no
        planning, the closed flag and pool size under the lock. Raises
        ServerClosed on a closed server, so a probe observes death the way
        a query leg does."""
        with self._cond:
            if self._closed:
                raise ServerClosed("query server is closed.")
            return {"workers": len(self._workers), "queue_depth": self._depth}

    # -- tenancy -------------------------------------------------------------
    def _tenant_locked(self, name: str) -> TenantState:
        t = self._tenants.get(name)
        if t is None:
            t = TenantState(
                name,
                self.session.conf.serve_tenant_policy(name),
                CircuitBreaker(
                    self._breaker_miss_threshold, self._breaker_open_s
                ),
                self._drain_window_s,
            )
            self._tenants[name] = t
            # tenants never deregister, so the weight summary only grows
            self._weight_set.add(t.policy.weight)
            if self._min_weight is None or t.policy.weight < self._min_weight:
                self._min_weight = t.policy.weight
        return t

    def _global_depth_locked(self) -> int:
        return self._depth

    def _shed_stage_locked(self) -> int:
        depth = self._global_depth_locked()
        cap = max(self.config.max_queue, 1)
        if depth >= self._shed_batch_off * cap:
            return 2
        if depth >= self._shed_highwater * cap:
            return 1
        return 0

    def _reject_locked(
        self, tenant: TenantState, reason: str, retry_after: Optional[float] = None
    ) -> AdmissionRejected:
        """Build (not raise) the rejection, with counters. Retry-after
        comes from the tenant's observed drain rate unless the gate
        supplies its own (breaker cooldown). Breaker rejections count
        as rejected_breaker, NOT shed — stats()["shed"] stays equal to
        the serve.shed counter and the per-tenant shed sum."""
        if reason == "breaker_open":
            self._rejected_breaker += 1
            tenant.rejected_breaker += 1
            metrics.incr("serve.breaker.rejected")
        else:
            self._shed += 1
            tenant.shed += 1
            metrics.incr("serve.shed")
            if reason == "shed_lowweight":
                metrics.incr("serve.shed.lowweight")
            # post-mortem: the FIRST shed of a storm freezes the flight
            # recorder (rate-limited per reason inside; capture is an
            # O(ring) deque copy, safe under _cond)
            flight_recorder.snapshot("shed")
        if retry_after is None:
            retry_after = tenant.retry_after_locked(self._ewma_retry_locked())
        return AdmissionRejected(
            self._global_depth_locked(),
            retry_after,
            tenant=tenant.name,
            tenant_depth=len(tenant.queue),
            reason=reason,
        )

    def _ewma_retry_locked(self) -> float:
        """Service-time fallback estimate for tenants with no windowed
        completions yet: backlog drained at EWMA service time across the
        worker pool."""
        backlog = self._global_depth_locked() / max(self.config.max_workers, 1)
        return max(backlog * self._ewma_service_s, 0.001)

    def _admit_locked(self, tenant: TenantState, ticket: QueryTicket) -> None:
        """Every admission gate, cheapest-rejection-first, called BEFORE
        plan optimization so an overloaded server sheds without paying
        the planner. Raises AdmissionRejected; marks probe tickets."""
        now = time.monotonic()
        admitted, retry_after = tenant.breaker.admit_locked(now)
        if not admitted:
            raise self._reject_locked(tenant, "breaker_open", retry_after)
        if tenant.breaker.probe_inflight and tenant.breaker.state == tenancy.HALF_OPEN:
            # admit_locked flipped probe_inflight for THIS submission
            # exactly when it returned the probe slot
            ticket._is_probe = True
        try:
            # load-shed ladder stage 1: lowest-weight tenant class first
            # — only meaningful when registered weights actually differ
            if (
                self._shed_stage_locked() >= 1
                and len(self._weight_set) > 1
                and tenant.policy.weight == self._min_weight
            ):
                raise self._reject_locked(tenant, "shed_lowweight")
            if len(tenant.queue) >= max(tenant.policy.max_queue, 1):
                raise self._reject_locked(tenant, "tenant_queue_full")
            if self._global_depth_locked() >= self.config.max_queue:
                raise self._reject_locked(tenant, "queue_full")
        except AdmissionRejected:
            # a probe that a LATER gate rejected never ran: free the
            # half-open slot so the next submission can probe
            if ticket._is_probe:
                tenant.breaker.probe_inflight = False
            raise
        if ticket._is_probe:
            tenant.breaker.note_probe_admitted_locked()

    # -- admission -----------------------------------------------------------
    def submit(
        self,
        df,
        deadline_s: Optional[float] = None,
        tenant: str = DEFAULT_TENANT,
    ) -> QueryTicket:
        """Enqueue a DataFrame for execution under ``tenant``'s quotas.
        Raises AdmissionRejected when a quota, the shed ladder, or the
        tenant's circuit breaker refuses (backpressure — the caller
        decides whether to retry, degrade, or shed; serve.client has the
        jittered-backoff helper), ServerClosed after close()."""
        if df.session is not self.session:
            raise HyperspaceException(
                "Cannot serve a DataFrame from a different session."
            )
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline_at = (
            time.monotonic() + deadline_s if deadline_s is not None else None
        )
        # crash recovery, hosted on submit: a throttled background sweep
        # heals indexes whose writer died (the serving process is often
        # the only long-lived process around to notice)
        self._maybe_recovery_sweep()
        # background compaction, hosted the same way: runs-layout indexes
        # converge toward per-bucket files while admitted queries keep
        # serving their pinned snapshots wholesale
        self._maybe_compaction_sweep()
        ticket = QueryTicket(deadline_at, tenant)
        ticket._server = self
        if self.session.conf.telemetry_tracing_enabled():
            ticket.trace = QueryTrace("serve.query", tenant=tenant)
        import contextlib

        tcm = (
            ticket.trace.activate()
            if ticket.trace is not None
            else contextlib.nullcontext()
        )
        with tcm:
            return self._submit_traced(df, ticket, tenant)

    def _submit_traced(self, df, ticket: QueryTicket, tenant: str) -> QueryTicket:
        # all admission gates run BEFORE planning: an overloaded or
        # breaker-open tenant is rejected for two dict probes, not a
        # full optimizer pass
        with span("serve.admission"):
            with self._cond:
                if self._closed:
                    raise ServerClosed("query server is closed.")
                tstate = self._tenant_locked(tenant)
                ticket._tenant_state = tstate
                self._admit_locked(tstate, ticket)
                # queue depth is a LEVEL (gauge), sampled per admission —
                # the load evidence next to the shed ladder's counters
                metrics.gauge("serve.queue_depth", self._depth)
        # plan + batchability resolved at submit time: the plan cache
        # makes repeats ~two dict probes, and classified requests let the
        # worker's coalescing scan stay a pure queue walk under the lock.
        # The version token PINS the index-log snapshot: the optimized
        # plan bakes this snapshot's files, so the query serves it
        # wholesale across any concurrent refresh/optimize.
        latched = self._consult_device_latch()
        if latched and self._unavailable:
            # the probe found the card unreachable: every engine path runs
            # on it, so the ticket fails (the reference serves its host)
            from ..exceptions import DeviceUnavailableError

            metrics.incr("serve.submitted")
            with self._cond:
                self._submitted += 1
                tstate.submitted += 1
            self._finish(ticket, error=DeviceUnavailableError(self._degraded_reason))
            return ticket
        try:
            # the result-cache path shares ONE plan_signature walk with
            # the plan cache — the tree string + leaf snapshots must not
            # be computed twice per submission
            signature = None
            rc_enabled = self.session.conf.compile_result_cache_enabled()
            if rc_enabled:
                from .plan_cache import plan_signature

                signature = plan_signature(df.plan)
            with span("serve.plan"):
                plan, token = self.plan_cache.optimized_plan_with_token(
                    df, signature=signature
                )
            ticket.pinned_log_version = token[1]
            # RESULT cache (compile.result_cache, off by default): a
            # value-level hit under the SAME pinned token serves the
            # memoized table without a worker: sound because the key
            # carries literals, file snapshots, index generation and conf.
            # A snapshot-pinned reader hits entries of ITS pinned token.
            # The device-loss latch bypasses the cache (no lookup, no
            # store) but leaves its entries.
            rc_key = None
            if rc_enabled and latched:
                metrics.incr("compile.result_cache.bypass_latched")
            elif rc_enabled:
                from ..compile.result_cache import result_cache, result_key

                rc_key = result_key(df.plan, token, signature=signature)
                with span("result_cache.lookup"):
                    cached = result_cache.get(rc_key)
                if cached is not None:
                    metrics.incr("serve.submitted")
                    with self._cond:
                        self._submitted += 1
                        tstate.submitted += 1
                    if ticket.trace is not None:
                        ticket.trace.root.labels["result_cache"] = "hit"
                    self._finish(ticket, result=cached)
                    return ticket
            resident = None if latched else batcher.classify(self.session, plan)
        except Exception as e:  # noqa: BLE001 - planning failure = query failure
            # planning failures (unknown columns, vanished files) belong
            # to the QUERY, not the server: the ticket carries them and
            # admission still succeeds (and counts as a submission, so
            # stats() can never report failed > submitted)
            metrics.incr("serve.plan_error")
            metrics.incr("serve.submitted")
            with self._cond:
                self._submitted += 1
                tstate.submitted += 1
            self._finish(ticket, error=e)
            return ticket
        req = _Request(df, plan, resident, ticket, tstate, rc_key)
        ticket._request = req
        with self._cond:
            if self._closed:
                raise ServerClosed("query server is closed.")
            # caps re-checked: concurrent submits may have filled the
            # queue while this one was planning
            try:
                if len(tstate.queue) >= max(tstate.policy.max_queue, 1):
                    raise self._reject_locked(tstate, "tenant_queue_full")
                if self._global_depth_locked() >= self.config.max_queue:
                    raise self._reject_locked(tstate, "queue_full")
            except AdmissionRejected:
                if ticket._is_probe:
                    # the already-counted probe lost the enqueue race:
                    # un-count it with the slot — it never ran
                    tstate.breaker.probe_inflight = False
                    tstate.breaker.probes -= 1
                    metrics.incr("serve.breaker.probe", -1)
                raise
            self._submitted += 1
            tstate.submitted += 1
            tstate.queue.append(req)
            self._backlogged[tenant] = tstate
            self._depth += 1
            self._cond.notify()
        metrics.incr("serve.submitted")
        return ticket

    def _cancel(self, ticket: QueryTicket) -> bool:
        """Remove ``ticket``'s request from its tenant queue if still
        queued; dispatch and cancel race under _cond, one wins."""
        with self._cond:
            req = ticket._request
            tstate = ticket._tenant_state
            if req is None or tstate is None or ticket._done.is_set():
                return False
            try:
                tstate.queue.remove(req)
            except ValueError:
                return False  # already dispatched (or close() drained it)
            self._depth -= 1
            if not tstate.queue:
                self._backlogged.pop(tstate.name, None)
        metrics.incr("serve.cancelled")
        self._finish(ticket, error=QueryCancelled("cancelled before dispatch."))
        return True

    def _maybe_recovery_sweep(self) -> None:
        interval = self.config.recovery_sweep_interval_s
        if interval is None or interval <= 0:
            return
        now = time.monotonic()
        with self._cond:
            if now < self._next_recovery_sweep:
                return
            self._next_recovery_sweep = now + interval
        threading.Thread(
            target=self._recovery_sweep, daemon=True, name="hyperspace-serve-recovery"
        ).start()

    def _recovery_sweep(self) -> None:
        from ..reliability.recovery import recover_abandoned_indexes

        try:
            n = recover_abandoned_indexes(
                self.session.conf.system_path(), self.session.conf
            )
        except Exception:  # noqa: BLE001
            # counted, not raised: a failed sweep must never take down
            # serving; the next interval retries
            metrics.incr("serve.recovery_sweep_error")
            return
        metrics.incr("serve.recovery_sweep")
        with self._cond:
            self._recovery_sweeps += 1
            self._recovered_indexes += n
        if n:
            # recovered indexes changed the log: the TTL catalog cache may
            # hold the transient view
            self.session.collection_manager.clear_cache()

    def _maybe_compaction_sweep(self) -> None:
        if not self.session.conf.compaction_enabled():
            return
        interval = self.config.compaction_sweep_interval_s
        if interval is None:
            interval = self.session.conf.compaction_interval_seconds()
        if interval is None or interval <= 0:
            return
        now = time.monotonic()
        with self._cond:
            if now < self._next_compaction_sweep or self._compaction_running:
                return
            self._next_compaction_sweep = now + interval
            self._compaction_running = True
        threading.Thread(
            target=self._compaction_sweep,
            daemon=True,
            name="hyperspace-serve-compaction",
        ).start()

    def _compaction_sweep(self) -> None:
        from ..index.compactor import IndexCompactor

        try:
            results = IndexCompactor(self.session).sweep()
        except Exception:  # noqa: BLE001
            # counted, not raised: a failed sweep must never take down
            # serving — the next interval retries
            metrics.incr("serve.compaction_sweep_error")
            results = {}
        finally:
            with self._cond:
                self._compaction_running = False
        metrics.incr("serve.compaction_sweep")
        steps = sum(r.get("steps", 0) for r in results.values())
        with self._cond:
            self._compaction_sweeps += 1
            self._compaction_steps += steps

    # -- worker --------------------------------------------------------------
    def _worker_loop(self) -> None:
        try:
            self._worker_loop_inner()
        except BaseException:  # noqa: BLE001 - worker killed mid-query
            # a BaseException (injected crash, interpreter teardown)
            # killed this worker; its in-flight tickets were already
            # failed by the execute paths' guards. Replace the worker so
            # the pool keeps serving, then die visibly.
            with self._cond:
                me = threading.current_thread()
                if me in self._workers:
                    self._workers.remove(me)
                self._workers_killed += 1
                closed = self._closed
            metrics.incr("serve.worker_killed")
            if not closed:
                try:
                    self.start()
                except ServerClosed:
                    # close() won the race since the snapshot above: no
                    # replacement needed, and the ORIGINAL kill cause
                    # must stay the exception this thread dies with
                    metrics.incr("serve.worker.respawn_declined")
            raise

    def _worker_loop_inner(self) -> None:
        if self._device.type == "cuda":
            import torch

            torch.cuda.set_device(self._device)
        while True:
            # batch accumulates INSIDE the guarded region: a kill landing
            # anywhere after a request is popped (even mid-drain, before
            # execution starts) must still resolve every popped ticket
            # and return its in-flight slot — popped requests have no
            # other owner who could ever pick them up again
            batch: List[_Request] = []
            try:
                with self._cond:
                    while not self._closed:
                        if self._next_request_locked(batch):
                            break
                        self._cond.wait()
                    if not batch:  # closed and drained
                        return
                    head = batch[0]
                    if (
                        head.resident is not None
                        and self.config.batch_max > 1
                        and not self._degraded_latch.is_set()
                        and self._shed_stage_locked() < 2
                    ):
                        self._drain_compatible_locked(head, batch)
                now = time.monotonic()
                live: List[_Request] = []
                for r in batch:
                    if (
                        r.ticket.deadline_at is not None
                        and now > r.ticket.deadline_at
                    ):
                        self._miss_deadline(r)
                    else:
                        live.append(r)
                if live:
                    if (len(live) == 1 or live[0].resident is None
                            or self._degraded_latch.is_set()):
                        for r in live:
                            self._execute_single(r)
                    else:
                        self._execute_batch(live)
            except BaseException as e:  # worker killed: resolve the batch
                for r in batch:
                    if not r.ticket.done():
                        self._finish(r.ticket, error=e)
                raise
            finally:
                if batch:
                    with self._cond:
                        capped = False
                        for r in batch:
                            if r.inflight_charged:
                                r.inflight_charged = False
                                r.tenant.inflight -= 1
                                if r.tenant.policy.inflight_cap() is not None:
                                    capped = True
                        # wake workers ONLY when headroom was actually
                        # freed under a finite cap — with no caps,
                        # completions never unblock anyone, and a
                        # broadcast per dispatch would cost O(workers)
                        # spurious round-trips on the serializing lock
                        if capped:
                            self._cond.notify_all()

    def _next_request_locked(self, batch: List[_Request]) -> bool:
        """The weighted-fair pick: next backlogged tenant with in-flight
        headroom via smooth WRR, then ITS oldest request (FIFO within a
        tenant preserves per-client ordering). The popped request is
        registered in ``batch`` BEFORE its in-flight slot is charged, so
        the worker's resolve-all/decharge guards stay consistent no
        matter where a kill lands. True when a request was taken."""
        t = tenancy.pick_tenant_locked(self._backlogged)
        if t is None:
            return False
        req = t.queue.popleft()
        batch.append(req)
        self._depth -= 1
        if not t.queue:
            del self._backlogged[t.name]
        t.inflight += 1
        req.inflight_charged = True
        self._dispatch_order.append(t.name)
        return True

    def _drain_compatible_locked(
        self, head: _Request, batch: List[_Request]
    ) -> None:
        """Pull every queued request sharing ``head``'s batch key (same
        resident table identity + resident column set) ACROSS backlogged
        tenants into ``batch`` — coalesced queries ride one dispatch, so
        widening the batch costs the batch nothing and saves each rider
        a round trip. Per-tenant queue order is preserved; per-tenant
        in-flight caps are honored. Called with the lock held."""
        key = head.resident.batch_key
        budget = self.config.batch_max - len(batch)
        # head's tenant first (its own burst is the common case), then
        # the other backlogged tenants in registration order —
        # deterministic for tests; idle tenants cost nothing
        tenants = [head.tenant] + [
            t for t in self._backlogged.values() if t is not head.tenant
        ]
        for t in tenants:
            if budget <= 0:
                break
            cap = t.policy.inflight_cap()
            if (cap is not None and t.inflight >= cap) or not t.queue:
                continue  # nothing takable: skip the O(queue) walk
            keep: "deque[_Request]" = deque()
            while t.queue and budget > 0:
                r = t.queue.popleft()
                if (
                    r.resident is not None
                    and r.resident.batch_key == key
                    and (cap is None or t.inflight < cap)
                ):
                    batch.append(r)
                    self._depth -= 1
                    t.inflight += 1
                    r.inflight_charged = True
                    budget -= 1
                else:
                    keep.append(r)
            keep.extend(t.queue)
            t.queue.clear()
            t.queue.extend(keep)
            if not t.queue:
                self._backlogged.pop(t.name, None)

    # -- execution -----------------------------------------------------------
    def _execute_single(self, req: _Request) -> None:
        import contextlib

        req.ticket.started_at = time.monotonic()
        tr = req.ticket.trace
        if tr is not None and tr.find("serve.queue_wait") is None:
            # the ticket's wait, as a span with explicit monotonic ends
            # (submit and dispatch run on different threads by design);
            # skipped when the batch path already recorded it — declined
            # or failed batches fall back through here per rider
            tr.add_span(
                "serve.queue_wait",
                req.ticket.submitted_at,
                req.ticket.started_at,
            )
        tcm = tr.activate() if tr is not None else contextlib.nullcontext()
        try:
            t0 = time.monotonic()
            with tcm, span("serve.execute", tenant=req.ticket.tenant):
                with metrics.scoped() as qm:
                    result = self._run_plan(req)
            wall_s = time.monotonic() - t0
            req.ticket.metrics = qm.report()
            if req.result_key is not None:
                # the memo is best-effort: a store failure (bad conf
                # value, exotic batch) must NEVER convert an already-
                # successful query into a caller-visible error
                try:
                    self._store_result(req, result, wall_s)
                except Exception:  # noqa: BLE001 - memo only, counted
                    metrics.incr("compile.result_cache.store_error")
            self._finish(req.ticket, result=result)
        except Exception as e:  # noqa: BLE001 - one query's failure is its own
            self._finish(req.ticket, error=e)
        except BaseException as e:  # worker being killed: resolve the ticket
            self._finish(req.ticket, error=e)
            raise

    def _store_result(self, req: _Request, result, wall_s: float) -> None:
        """Telemetry-driven admission: observe the query's
        structural fingerprint in the sliding window, price its observed
        recompute cost (trace spans when tracing is on, the direct
        dispatch wall otherwise), and let the cache decide."""
        from ..compile.fingerprint import batch_fingerprint
        from ..compile.result_cache import (
            budget_share_bytes,
            result_cache,
            result_roots,
        )
        from .cache_policy import recompute_cost_s

        conf = self.session.conf
        repeats = self._rc_window.observe(
            batch_fingerprint(req.plan), conf.compile_result_cache_window()
        )
        result_cache.put(
            req.result_key,
            result,
            result_roots(req.plan),
            conf.compile_result_cache_entries(),
            conf.compile_result_cache_max_bytes(),
            cost_s=recompute_cost_s(req.ticket.trace, wall_s),
            repeats=repeats,
            byte_rate=conf.compile_result_cache_byte_rate(),
            total_max_bytes=budget_share_bytes(
                conf.compile_result_cache_budget_share(), conf.residency().budget_bytes
            ),
        )

    def _run_plan(self, req: _Request) -> ColumnarBatch:
        from ..exec.executor import Executor

        conf = self.session.conf
        residency = conf.residency()
        mesh = self.session.mesh
        if self._degraded_latch.is_set():
            # degraded: no resident route and no mesh (the reference's host
            # executor); the per-file route still masks and joins on the card
            import dataclasses

            residency = dataclasses.replace(residency, mode="off")
            mesh = None
        executor = Executor(self.session.device, residency, conf, mesh=mesh)
        # the ticket's pinned index-log snapshot folds into the compiled-
        # pipeline cache key: a query admitted under version V serves V's
        # whole compiled pipeline across any concurrent refresh/optimize
        out = executor.execute(
            req.plan, version_token=req.ticket.pinned_log_version
        )
        tr = req.ticket.trace
        if tr is not None:
            p = executor.last_pipeline
            tr.meta["pipeline"] = p.describe() if p is not None else None
        return out

    def _execute_batch(self, live: List[_Request]) -> None:
        import contextlib

        now = time.monotonic()
        for r in live:
            r.ticket.started_at = now
            if r.ticket.trace is not None:
                r.ticket.trace.add_span(
                    "serve.queue_wait", r.ticket.submitted_at, now
                )
        residents = [r.resident for r in live]
        # the coalesced dispatch records under the HEAD ticket's trace;
        # riders adopt the shared span subtree afterwards (a per-rider
        # split of one stacked launch would be fiction — the batched-
        # metrics rule applied to spans)
        head_tr = live[0].ticket.trace
        tcm = (
            head_tr.activate() if head_tr is not None else contextlib.nullcontext()
        )
        batch_span = None
        try:
            # one scope for the whole coalesced dispatch + host legs:
            # batched tickets share their batch's metrics snapshot (a
            # per-query split of one stacked launch would be fiction)
            with tcm, span(
                "serve.batch_dispatch", batch=len(live)
            ) as batch_span:
                with metrics.scoped() as bm:
                    results = batcher.execute_batch(residents)
        except RuntimeError as e:  # device loss mid-serve
            # latch degraded, drop the table so no later query retries it,
            # and re-serve THIS batch query by query on the per-file route
            # (same rows; the error reaches no caller). The failing span
            # is already marked in the head trace.
            self._latch_degraded(
                repr(e), residents[0], traces=[r.ticket.trace for r in live]
            )
            results = None
        except Exception as e:  # noqa: BLE001 - not a device error: fail the batch
            # a kernel that cannot build (or any other fault of the
            # program) is never degraded: every ticket carries the error
            metrics.incr("serve.batch.error")
            flight_recorder.snapshot("batch_error", extra_traces=[r.ticket.trace for r in live])
            for r in live:
                self._finish(r.ticket, error=e)
            return
        except BaseException as e:  # worker being killed: resolve every ticket
            for r in live:
                if not r.ticket.done():
                    self._finish(r.ticket, error=e)
            raise
        if results is None:
            if not self._degraded_latch.is_set():
                # the batched launch declined (not an error): query by query
                metrics.incr("serve.batch.declined")
            try:
                for r in live:
                    self._execute_single(r)
            except BaseException as e:  # worker killed mid-fallback: the
                # remaining riders were already popped from their queues
                # and no worker can re-pick them — resolve every one
                for r in live:
                    if not r.ticket.done():
                        self._finish(r.ticket, error=e)
                raise
            return
        with self._cond:
            self._dispatches += 1
            self._batched_queries += len(live)
            # per-tenant twin counted HERE, over the same post-filter
            # batch the global counter sees, so the per-tenant sum
            # always reconciles with stats()["batched_queries"]
            for r in live:
                r.tenant.batched_queries += 1
            n = len(live)
            self._batch_sizes[n] = self._batch_sizes.get(n, 0) + 1
        snap = bm.report()
        for r, result in zip(live, results):
            r.ticket.batch_size = len(live)
            r.ticket.metrics = snap
            tr = r.ticket.trace
            if tr is not None and tr is not head_tr and batch_span is not None:
                tr.adopt(batch_span)
            self._finish(r.ticket, result=result)

    def _latch_degraded(self, reason: str, resident, traces=None) -> None:
        from ..exec.hbm_cache import hbm_cache
        from ..exec.mesh_cache import mesh_cache

        with self._cond:
            already = self._degraded_latch.is_set()
            self._degraded_latch.set()
            self._degraded_reason = self._degraded_reason or reason
        # post-mortem: freeze the flight recorder around the loss, with
        # the failing dispatch's in-flight traces attached
        flight_recorder.snapshot("device_loss", extra_traces=traces or ())
        if not already:
            metrics.incr("serve.degraded")
            (mesh_cache if resident.mesh is not None else hbm_cache).drop(resident.table)

    def _miss_deadline(self, req: _Request) -> None:
        metrics.incr("serve.deadline_missed")
        self._finish(
            req.ticket,
            error=DeadlineExceeded(
                "deadline expired while queued "
                f"(waited {time.monotonic() - req.ticket.submitted_at:.3f}s)."
            ),
        )

    def _finish(self, ticket: QueryTicket, result=None, error=None) -> None:
        ticket.finished_at = time.monotonic()
        ticket._result = result
        ticket._error = error
        ticket._request = None  # no longer cancellable
        tstate = ticket._tenant_state
        with self._cond:
            if ticket.started_at is not None:
                service = ticket.finished_at - ticket.started_at
                self._ewma_service_s = (
                    0.8 * self._ewma_service_s + 0.2 * service
                )
                self._waits.append(ticket.wait_s or 0.0)
            now = time.monotonic()
            if error is None:
                self._completed += 1
                if tstate is not None:
                    tstate.note_completion_locked(
                        now,
                        ticket.latency_s if ticket.started_at is not None else None,
                    )
                    # breaker: a probe success closes the circuit; a
                    # success while OPEN (admitted pre-open) only clears
                    # the consecutive-miss streak — the cooldown stands
                    if ticket._is_probe or tstate.breaker.state == tenancy.CLOSED:
                        tstate.breaker.record_success_locked()
                    else:
                        tstate.breaker.consecutive_misses = 0
            elif isinstance(error, QueryCancelled):
                self._cancelled += 1
                if tstate is not None:
                    tstate.cancelled += 1
                    if ticket._is_probe:
                        # a cancelled probe never decided anything: free
                        # the half-open slot or the breaker wedges —
                        # every later submission rejected forever
                        tstate.breaker.probe_inflight = False
            else:
                self._failed += 1
                if tstate is not None:
                    tstate.failed += 1
                    if isinstance(error, DeadlineExceeded):
                        self._deadline_missed += 1
                        tstate.deadline_missed += 1
                        tstate.breaker.record_miss_locked(
                            now, probe=ticket._is_probe
                        )
                    elif ticket._is_probe:
                        # probe died of an execution error, not a miss:
                        # inconclusive — free the probe slot for the next
                        tstate.breaker.probe_inflight = False
            # latency percentiles describe SERVED queries: tickets that
            # never started (deadline-missed, plan-error, close()-shed)
            # would pollute p50/p99 with pure queue wait
            if ticket.started_at is not None and ticket.latency_s is not None:
                self._latencies.append(ticket.latency_s)
        if error is None:
            metrics.incr("serve.completed")
        # latency/wait histograms describe SERVED queries, same rule as
        # the percentile reservoirs above
        if ticket.started_at is not None and ticket.latency_s is not None:
            metrics.observe("serve.latency_seconds", ticket.latency_s)
            metrics.observe("serve.wait_seconds", ticket.wait_s or 0.0)
        tr = ticket.trace
        if tr is not None:
            # the ticket's trace is the one attribution record: serve
            # identity, scoped metrics, and (set by _run_plan) the
            # compiled pipeline — explain(verbose) renders from it
            tr.meta["serve"] = {
                "tenant": ticket.tenant,
                "pinned_log_version": ticket.pinned_log_version,
            }
            if ticket.metrics is not None:
                tr.meta["metrics"] = ticket.metrics
            tr.finish(error)
            flight_recorder.record(tr)
            if error is None:
                self.session.last_trace = tr
        elif error is None:
            # tracing off: clear the attribution rather than let
            # explain(verbose) describe a previous query as this one
            self.session.last_trace = None
        ticket._done.set()

    # -- observability -------------------------------------------------------
    # -- degradation surface -------------------------------------------------
    def _consult_device_latch(self) -> bool:
        """True when serving is latched degraded, consulting the process's
        device-probe verdict first: a card any component found unreachable
        latches the server (unavailable) without waiting for a serve-path
        failure. One dict probe per submit."""
        from ..utils.deviceprobe import latched_verdict, unavailable_reason

        if latched_verdict() is False and not self._unavailable:
            with self._cond:
                newly = not self._degraded_latch.is_set()
                self._degraded_latch.set()
                self._unavailable = True
                self._degraded_reason = self._degraded_reason or unavailable_reason()
            if newly:
                metrics.incr("serve.degraded")
        return self._degraded_latch.is_set()

    @property
    def degraded(self) -> bool:
        """True once the server latched degraded (a device error in a batch,
        or the device probe's verdict)."""
        return self._consult_device_latch()

    def stats(self) -> dict:
        import statistics

        # copy raw reservoirs and scalars under the lock; sort/aggregate
        # AFTER releasing it — a telemetry loop polling stats() must not
        # stall admission and dispatch, which serialize on this lock
        with self._cond:
            lats = list(self._latencies)
            waits = list(self._waits)
            order = list(self._dispatch_order)
            tenants_raw = {
                name: (t.snapshot_locked(), list(t.latencies))
                for name, t in sorted(self._tenants.items())
            }
            shed_stage = self._shed_stage_locked()
            compaction_sweeps = self._compaction_sweeps
            compaction_steps = self._compaction_steps
            sweeps = self._recovery_sweeps
            recovered = self._recovered_indexes
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "shed": self._shed,
                "rejected_breaker": self._rejected_breaker,
                "cancelled": self._cancelled,
                "deadline_missed": self._deadline_missed,
                "queue_depth": self._global_depth_locked(),
                "workers": len(self._workers),
                "workers_killed": self._workers_killed,
                "degraded": self._degraded_latch.is_set(),
                "degraded_reason": self._degraded_reason,
                "batch_dispatches": self._dispatches,
                "batched_queries": self._batched_queries,
                "batch_size_hist": dict(sorted(self._batch_sizes.items())),
                "mean_batch_size": round(
                    self._batched_queries / self._dispatches, 2
                )
                if self._dispatches
                else None,
            }
        # the multi-tenant surface: per-tenant quotas, depths, p50/p99,
        # shed/rejected counters, breaker states — what an operator
        # reads to see WHO is loading the server and who is being
        # protected from whom
        tenants = {}
        for name, (snap, tl) in tenants_raw.items():
            snap.update(tenancy.latency_percentiles_ms(tl))
            tenants[name] = snap
        out["tenants"] = tenants
        dispatch_share: Dict[str, int] = {}
        for name in order:
            dispatch_share[name] = dispatch_share.get(name, 0) + 1
        # load-shed ladder position + the scheduler-turn shares behind
        # the fairness bound (window: last 4096 turns); widening is off
        # under the device-loss latch too
        out["overload"] = {
            "shed_stage": shed_stage,
            "batch_widening": shed_stage < 2 and self.config.batch_max > 1
            and not self._degraded_latch.is_set(),
            "dispatch_share": dispatch_share,
        }
        # process-wide serve counter family (telemetry.metrics)
        out["serve_counters"] = serve_snapshot()
        out["plan_cache"] = self.plan_cache.snapshot()
        # whole-plan compilation surface: the compiled-pipeline cache,
        # the result cache, and the compile.* counter family — whether
        # bursts are reusing pipelines or re-lowering per query
        # (compile/)
        out["compile"] = _compile_stats()
        # result-cache surface: occupancy + bytes + the admission/
        # eviction counter family (telemetry.result_cache_snapshot) —
        # what the admission policy admitted, declined, and shed
        out["result_cache"] = _result_cache_stats()
        # join-region surface: what the resident join pipeline holds
        # (regions, bytes, generation) — operators read this next to the
        # serve counters to see whether aggregate-joins are being served
        # fused or host-side
        out["join_regions"] = _join_region_stats()
        # residency tier surface: per-table tier ladder state (which
        # rung each table landed on, compression ratio, window counters)
        out["residency"] = _residency_stats()
        # reliability surface: what the lifecycle layer absorbed (retries)
        # and healed (rollbacks) while this server ran: THIS server's
        # sweeps plus the process-wide counters
        out["reliability"] = {
            "server_recovery_sweeps": sweeps,
            "recovered_indexes": recovered,
            **reliability_snapshot(),
        }
        # background-compaction surface: THIS server's hosted sweeps and
        # the steps they committed (the process-wide compaction.* counter
        # family rides the registry export below)
        out["compaction"] = {
            "server_compaction_sweeps": compaction_sweeps,
            "compaction_steps": compaction_steps,
        }
        out.update(tenancy.latency_percentiles_ms(lats))
        if waits:
            out["mean_wait_ms"] = round(1e3 * statistics.fmean(waits), 3)
        # exporter surface (telemetry/export.py): the WHOLE registry as
        # Prometheus text + JSON-lines, for scrapes that read stats()
        # over an RPC shim; with hyperspace.telemetry.export.dir set,
        # each stats() call also appends a rotated on-disk snapshot
        # (failures counted, never raised — telemetry must not take
        # down serving)
        from ..telemetry import export as texport

        exp = {
            "prometheus": texport.render_prometheus(),
            "jsonl": texport.render_jsonl(),
            "recorder": {
                "traces": len(flight_recorder.last()),
                "snapshots": len(flight_recorder.snapshots()),
            },
            "written_to": None,
        }
        exp_dir = self.session.conf.telemetry_export_dir()
        if exp_dir:
            try:
                exp["written_to"] = str(
                    texport.export_to_dir(
                        exp_dir,
                        self.session.conf.telemetry_export_rotate_bytes(),
                        self.session.conf.telemetry_export_keep(),
                    )
                )
            except OSError:
                metrics.incr("telemetry.export.write_error")
        out["export"] = exp
        return out


def _compile_stats() -> dict:
    """Whole-plan-compilation snapshot for stats(): pipeline/result cache
    occupancy plus the process-wide compile.* counter family
    (telemetry.compile_snapshot)."""
    from ..compile.cache import pipeline_cache
    from ..compile.result_cache import result_cache
    from ..telemetry.metrics import compile_snapshot

    return {
        "pipelines": pipeline_cache.snapshot(),
        "results": result_cache.snapshot(),
        **compile_snapshot(),
    }


def _result_cache_stats() -> dict:
    """Result-cache snapshot for stats(): the serve-level and router-level
    caches' occupancy and their admission and eviction counters
    (telemetry.result_cache_snapshot)."""
    from ..compile.result_cache import result_cache, router_result_cache
    from ..telemetry.metrics import result_cache_snapshot

    return {"serve": result_cache.snapshot(), "router": router_result_cache.snapshot(),
            **result_cache_snapshot()}


def _residency_stats() -> dict:
    """Tier-ladder snapshot for stats(): each cache's table tiers (the
    single-device cache's and the mesh's) and the residency counters
    (telemetry.residency_snapshot)."""
    from ..exec.hbm_cache import hbm_cache
    from ..exec.mesh_cache import mesh_cache
    from ..telemetry.metrics import residency_snapshot

    return {"hbm": hbm_cache.snapshot_residency(), "mesh": mesh_cache.snapshot_residency(),
            **residency_snapshot()}


def _join_region_stats() -> dict:
    """Join regions held in each cache: count, MB and generation (the
    per-region detail stays on the caches' ``snapshot_joins``)."""
    from ..exec.hbm_cache import hbm_cache
    from ..exec.mesh_cache import mesh_cache

    out = {}
    for name, cache in (("hbm", hbm_cache), ("mesh", mesh_cache)):
        snap = cache.snapshot_joins()
        out[name] = {"regions": snap["regions"], "mb": snap["mb"], "version": snap["version"]}
    return out
