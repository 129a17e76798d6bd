"""The multi-host serve front: a query router over per-host servers.

Counterpart of ``hyperspace_tpu.distributed.router`` (host code). One
``QueryServer`` (serve/server.py) serves one host's devices; a job of
several hosts needs a front tier. ``QueryRouter`` speaks the servers'
tenant protocol (tenant tag, deadline, ticket), fans one logical query
out as per-host sub-queries, and merges their partials the way the
mesh's two-phase aggregate merges per-shard partials (exec/distributed.py:
count and sum re-merge by summation, min and max by re-reduction, avg
from sum and count), through the same ``hash_aggregate``, so integer
aggregates re-merge exactly. Each host's leg runs on its own server, and
so on its own card: resident filters through K1c, the device aggregate
through K1's mask, a batched burst through K1b.

Partitioning is the caller's vocabulary: ``submit`` takes a *builder*
``build(session, part_index, n_parts) -> DataFrame`` and the router
instantiates it once per host against that host's session.
``partition_map()`` derives the canonical host to bucket assignment from
the op log's ACTIVE index metadata through the one shared placement rule
(``parallel.mesh.owner_of_bucket`` applied at host granularity) for
callers that partition by bucket.

Routing key: the batch fingerprint of every sub-plan (literals masked:
the burst-shape identity) folded with the exact plan repr and tenant.
Identical in-flight bursts coalesce onto one fan-out per host
(``router.coalesced``); distinct literals never share a ticket because
the exact repr takes part.

Failure domains: dispatch runs against the ``HealthDirector``
(distributed/health.py) state machine, not the one-way ``closed`` flag:

* a **dead** host's legs are deferred at fan-out and re-issued against
  survivors (shared storage makes every partition readable from any
  host's session), at ZERO failed tickets while any host survives;
* failover runs under the reliability ``RetryPolicy`` deterministic-
  jitter backoff, every re-submission carries only the REMAINING
  deadline budget (never the original deadline), and a survivor's
  ``AdmissionRejected`` is honoured for its ``retry_after_s`` instead of
  stampeding the next host (``router.retry.*``);
* a **slow** host is hedged: once a leg outlives its host's own tail
  quantile (``HealthDirector.hedge_delay_s``), the same partition is
  re-issued on a survivor and the first result wins, the loser's ticket
  cancelled (``router.hedge.{issued,won,cancelled}``);
* a **recovered** host is readmitted only through a probation probe leg
  (the tenancy breaker's half-open discipline at host granularity):
  ``router.health.readmitted`` plus a flight-recorder snapshot are the
  evidence, and ``revive_host`` lets an operator swap a restarted
  server in for its dead predecessor.

Every lost host freezes a flight-recorder snapshot tagged with the dead
host AND the surviving placement, so the post-mortem shows where its
partitions went. The fleet result cache (``router_result_cache``) and
the warm-compile hint book ride the same machine-portable fingerprints.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from ..parallel.mesh import owner_of_bucket
from ..plan.aggregates import AggSpec
from ..plan.ir import Aggregate, LogicalPlan
from ..reliability.retry import RetryPolicy
from ..serve.server import (
    DEFAULT_TENANT,
    AdmissionRejected,
    DeadlineExceeded,
    QueryServer,
    ServerClosed,
)
from ..storage.columnar import Column, ColumnarBatch
from ..telemetry.metrics import metrics
from ..telemetry.recorder import flight_recorder
from ..telemetry.trace import span
from .health import HealthDirector, HealthPolicy

__all__ = ["QueryRouter", "RouterTicket"]

Builder = Callable[..., "object"]  # build(session, part_index, n_parts) -> DataFrame

# the failover backoff: quick first retry, bounded tail. Leg failover
# shares the storage tier's deterministic-jitter discipline, so a chaos
# replay reproduces the exact same sleep sequence
DEFAULT_ROUTER_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=0.02, max_delay_s=0.5
)

_RACE_POLL_S = 0.02  # hedge race poll granularity


def _partial_specs(aggs: List[AggSpec]) -> List[AggSpec]:
    """The per-host partial aggregates for a final spec list. count/sum
    carry a sum partial (plus a non-NULL count so float NULL re-merges),
    min/max carry themselves, avg decomposes into sum+count — the same
    decomposition the mesh partial-merge uses."""
    out: List[AggSpec] = []
    for a in aggs:
        if a.fn == "count":
            out.append(AggSpec("count", a.column, f"__pc_{a.name}"))
        elif a.fn in ("sum", "avg"):
            out.append(AggSpec("sum", a.column, f"__ps_{a.name}"))
            out.append(AggSpec("count", a.column, f"__pn_{a.name}"))
        elif a.fn in ("min", "max"):
            tag = "m" if a.fn == "min" else "M"
            out.append(AggSpec(a.fn, a.column, f"__p{tag}_{a.name}"))
        else:
            raise HyperspaceException(f"Unsupported router aggregate {a.fn}.")
    return out


def _merge_partials(
    partials: List[ColumnarBatch],
    group_by: List[str],
    aggs: List[AggSpec],
) -> ColumnarBatch:
    """Re-merge per-host partial aggregates into finals. Runs through
    hash_aggregate — sums of int64 partials are exact (the partial sums
    themselves already widened), min/max re-reduce, NULL partials (NaN)
    are skipped by the standard valid mask and resurface only when the
    merged non-NULL count is zero. Output rows are canonically ordered
    by group key so the merged result is deterministic regardless of
    which host answered first."""
    from ..exec.aggregate import hash_aggregate

    whole = ColumnarBatch.concat(partials)
    merge_specs: List[AggSpec] = []
    for a in aggs:
        if a.fn == "count":
            merge_specs.append(AggSpec("sum", f"__pc_{a.name}", f"__pc_{a.name}"))
        elif a.fn in ("sum", "avg"):
            merge_specs.append(AggSpec("sum", f"__ps_{a.name}", f"__ps_{a.name}"))
            merge_specs.append(AggSpec("sum", f"__pn_{a.name}", f"__pn_{a.name}"))
        else:
            tag = "m" if a.fn == "min" else "M"
            merge_specs.append(
                AggSpec(a.fn, f"__p{tag}_{a.name}", f"__p{tag}_{a.name}")
            )
    merged = hash_aggregate(whole, group_by, merge_specs)

    out: Dict[str, Column] = {}
    for g in group_by:
        out[g] = merged.columns[g]
    for a in aggs:
        if a.fn == "count":
            out[a.name] = Column(
                "int64", merged.columns[f"__pc_{a.name}"].data.astype(np.int64)
            )
        elif a.fn == "sum":
            col = merged.columns[f"__ps_{a.name}"]
            s = col.data
            if col.dtype_str.startswith("float"):
                nn = merged.columns[f"__pn_{a.name}"].data
                s = np.where(nn == 0, np.nan, s)
            out[a.name] = Column(col.dtype_str, s)
        elif a.fn == "avg":
            s = merged.columns[f"__ps_{a.name}"].data
            nn = merged.columns[f"__pn_{a.name}"].data
            with np.errstate(invalid="ignore", divide="ignore"):
                out[a.name] = Column(
                    "float64", s.astype(np.float64) / nn
                )
        else:
            tag = "m" if a.fn == "min" else "M"
            col = merged.columns[f"__p{tag}_{a.name}"]
            out[a.name] = Column(col.dtype_str, col.data, col.vocab)
    result = ColumnarBatch(out)
    if group_by:
        order = np.lexsort(
            [_sort_key(result.columns[g]) for g in reversed(group_by)]
        )
        result = result.take(order)
    metrics.incr("router.merge.agg")
    return result


def _sort_key(col: Column) -> np.ndarray:
    """int64 ordering key for the canonical group sort (codes are
    order-preserving for strings; floats ride the ordered-i64 encoding)."""
    if col.vocab is not None:
        return col.data.astype(np.int64)
    if col.data.dtype.kind == "f":
        from ..ops.floatbits import f64_to_ordered_i64

        return f64_to_ordered_i64(col.data.astype(np.float64))
    return col.data.astype(np.int64)


class RouterTicket:
    """Handle for one routed query: resolves every host leg, degrades
    lost hosts, merges partials once, caches the result. The same
    result()/cancel() surface as the servers' QueryTicket."""

    def __init__(self, router: "QueryRouter", legs, merge):
        self._router = router
        self._legs = legs  # [(host, ticket-or-None, part_index, is_probe)]
        self._merge = merge  # callable(partials) -> ColumnarBatch
        self._lock = threading.Lock()
        self._result: Optional[ColumnarBatch] = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._t0 = time.monotonic()  # deadline budget anchors here

    def result(self, timeout: Optional[float] = None) -> ColumnarBatch:
        with self._lock:
            if not self._done:
                try:
                    partials = [
                        self._router._resolve_leg(
                            host, ticket, part, timeout, self, probe
                        )
                        for host, ticket, part, probe in self._legs
                    ]
                    self._result = self._merge(partials)
                    # fleet-level memo (router.result_cache): best-effort
                    # admission of the MERGED result — a store failure
                    # must never fail an already-served query
                    try:
                        self._router._store_cached(self, self._result)
                    except Exception:  # noqa: BLE001 - memo only, counted
                        metrics.incr("router.result_cache.store_error")
                except BaseException as e:
                    self._error = e
                self._done = True
                self._router._retire(self)
            if self._error is not None:
                raise self._error
            return self._result

    def cancel(self) -> bool:
        ok = True
        for _, ticket, _, _ in self._legs:
            if ticket is not None:
                ok = bool(ticket.cancel()) and ok
        return ok


class QueryRouter:
    """Front router over named per-host QueryServers (insertion order is
    the partition order: host i executes part_index i of n_parts).

    ``health_policy`` shapes the failure-domain state machine,
    ``retry_policy`` the failover backoff; ``hedging=False`` disables
    tail hedges."""

    def __init__(
        self,
        hosts: Dict[str, QueryServer],
        health_policy: Optional[HealthPolicy] = None,
        retry_policy: Optional[RetryPolicy] = None,
        hedging: bool = True,
    ):
        if not hosts:
            raise HyperspaceException("QueryRouter needs at least one host.")
        self.hosts: Dict[str, QueryServer] = dict(hosts)
        self.health = HealthDirector(list(self.hosts), policy=health_policy)
        self._retry_policy = retry_policy or DEFAULT_ROUTER_RETRY
        self._hedging = bool(hedging)
        self._lock = threading.Lock()
        self._inflight: Dict[tuple, RouterTicket] = {}
        self._tickets: Dict[int, tuple] = {}
        self._submitted = 0
        self._coalesced = 0
        self._hosts_lost = 0
        self._hedges_issued = 0
        self._hedges_won = 0
        # fleet result cache admission window + warm-compile hint book
        # (structural fingerprint digest -> builder): both keyed by the
        # machine-portable fingerprints, sized by the first host's conf
        # (hosts of one fleet share conf by construction)
        from ..serve.cache_policy import AdmissionWindow

        conf = next(iter(self.hosts.values())).session.conf
        self._rc_window = AdmissionWindow(conf.compile_result_cache_window())
        self._warm_hints: "OrderedDict[str, tuple]" = OrderedDict()
        self._warm_hints_max = 64

    # -- partitioning ---------------------------------------------------------
    def partition_map(self, index_name: Optional[str] = None) -> Dict[str, List[int]]:
        """host → owned buckets, from the op log's ACTIVE index metadata
        and the shared placement rule applied at host granularity. With
        no ``index_name`` the widest (most buckets) ACTIVE index keys the
        map — the same tie-break the planner's movement target uses."""
        from ..actions import states

        first = next(iter(self.hosts.values()))
        entries = first.session.collection_manager.get_indexes(
            [states.ACTIVE], prefer_stable=True
        )
        if index_name is not None:
            entries = [e for e in entries if e.name == index_name]
        if not entries:
            raise HyperspaceException(
                "No ACTIVE bucketed index to derive a partition map from."
            )
        entry = max(entries, key=lambda e: (e.num_buckets, e.name))
        names = list(self.hosts)
        owned: Dict[str, List[int]] = {h: [] for h in names}
        for b in range(entry.num_buckets):
            owned[names[owner_of_bucket(b, len(names))]].append(b)
        return owned

    # -- submission -----------------------------------------------------------
    def submit(
        self,
        build: Builder,
        deadline_s: Optional[float] = None,
        tenant: str = DEFAULT_TENANT,
    ) -> RouterTicket:
        """Fan ``build(session, part_index, n_parts)`` out across every
        host under ``tenant``'s quotas (the per-host servers enforce
        admission exactly as if the client had walked up to them). The
        builder returns each host's FINAL query; an Aggregate top is
        rewritten to its partial form at dispatch (rewrite_partial) so
        hosts compute partials and the merge produces the finals.

        Dispatch is health-gated: a known-dead host's leg is deferred to
        failover without touching it; a dead host whose probation is due
        gets exactly one leg AS the readmission probe."""
        from ..compile.fingerprint import batch_fingerprint

        names = list(self.hosts)
        n_parts = len(names)
        sub_plans: List[Tuple[str, object]] = []
        for i, host in enumerate(names):
            server = self.hosts[host]
            df = build(server.session, i, n_parts)
            sub_plans.append((host, df))

        digest = hashlib.blake2s()
        fp_digest = hashlib.blake2s()
        for _, df in sub_plans:
            fp_digest.update(repr(batch_fingerprint(df.plan)).encode())
            digest.update(repr(df.plan).encode())
        digest.update(fp_digest.digest())
        key = (tenant, digest.hexdigest())
        with self._lock:
            live = self._inflight.get(key)
            if live is not None:
                self._coalesced += 1
                metrics.incr("router.coalesced")
                return live

        # warm-compile hint book: remember how to rebuild this structural
        # shape so sibling/revived hosts can pre-lower it off the hot
        # path (offer_warm_hints / revive_host)
        fp_key = fp_digest.hexdigest()
        with self._lock:
            self._warm_hints[fp_key] = (build, tenant)
            self._warm_hints.move_to_end(fp_key)
            while len(self._warm_hints) > self._warm_hints_max:
                self._warm_hints.popitem(last=False)

        # fleet result cache: keyed (every host's value-level plan
        # signature, every host's FULL version token) — a hit is sound
        # fleet-wide by the same construction as the serve-level cache,
        # and repeats cost ZERO fan-out legs. Key computation failing
        # (e.g. a host mid-restart) just skips caching for this query.
        rc_key = None
        rc_roots: Tuple[str, ...] = ()
        conf0 = next(iter(self.hosts.values())).session.conf
        if conf0.compile_result_cache_enabled():
            try:
                rc_key, rc_roots = self._result_cache_key(sub_plans)
            except Exception:  # noqa: BLE001 - cache is optional, query is not
                metrics.incr("router.result_cache.key_error")
                rc_key = None
            if rc_key is not None:
                from ..compile.result_cache import router_result_cache

                with span("result_cache.lookup", level="router"):
                    cached = router_result_cache.get(rc_key)
                if cached is not None:
                    rt = RouterTicket(self, [], lambda _p, _c=cached: _c)
                    rt._build = build
                    rt._tenant = tenant
                    rt._deadline_s = deadline_s
                    rt._rc_key = None  # already cached: no re-store
                    with self._lock:
                        self._submitted += 1
                    return rt

        merge = self._merge_fn([df.plan for _, df in sub_plans])
        legs = []
        with span("router.fanout", hosts=n_parts, tenant=tenant):
            for i, (host, df) in enumerate(sub_plans):
                server = self.hosts[host]
                admitted, is_probe = self.health.admit_leg(host)
                if not admitted:
                    # known-dead, probation not due: defer straight to
                    # failover — don't poke a corpse per query
                    metrics.incr("router.health.deferred")
                    legs.append((host, None, i, False))
                    continue
                if server.closed:
                    # fenced before dispatch: leg resolves via a surviving
                    # host later — no failed ticket
                    self._host_failed(host, "closed_at_submit", probe=is_probe)
                    legs.append((host, None, i, False))
                    continue
                if is_probe and not self._ping_ok(host, server):
                    legs.append((host, None, i, False))
                    continue
                if getattr(df, "session", None) is not server.session:
                    # the host revived between plan build and dispatch (a
                    # restarted server is a NEW session): rebuild this
                    # leg's plan against the session actually serving it
                    df = build(server.session, i, n_parts)
                try:
                    ticket = server.submit(
                        self.rewrite_partial(df), deadline_s=deadline_s,
                        tenant=tenant,
                    )
                    metrics.incr("router.subqueries")
                    legs.append((host, ticket, i, is_probe))
                except ServerClosed:
                    self._host_failed(host, "closed_at_submit", probe=is_probe)
                    legs.append((host, None, i, False))
                except AdmissionRejected:
                    if is_probe:
                        # backpressure propagates to the caller by design,
                        # but the probe slot must not leak with it
                        self.health.note_failure(
                            host, "admission_rejected", probe=True
                        )
                    raise
                except Exception:  # noqa: BLE001 - leg must fail over, not fan-out
                    # an unexpected submit error is leg-local: count it,
                    # feed the health machine (freeing any probe slot),
                    # and let the leg re-issue on a survivor
                    metrics.incr("router.leg.submit_failed")
                    self.health.note_failure(host, "submit_error", probe=is_probe)
                    legs.append((host, None, i, False))

        rt = RouterTicket(
            self,
            legs,
            merge,
        )
        rt._build = build  # the degraded path re-instantiates partitions
        rt._tenant = tenant
        rt._deadline_s = deadline_s
        rt._rc_key = rc_key
        rt._rc_roots = rc_roots
        rt._rc_fp = fp_key
        with self._lock:
            self._inflight[key] = rt
            self._tickets[id(rt)] = key
            self._submitted += 1
        metrics.incr("router.fanout")
        return rt

    # -- merging --------------------------------------------------------------
    def _merge_fn(self, plans: List[LogicalPlan]):
        top = plans[0]
        if isinstance(top, Aggregate):
            group_by = list(top.group_by)
            aggs = list(top.aggs)

            def merge(partials: List[ColumnarBatch]) -> ColumnarBatch:
                return _merge_partials(partials, group_by, aggs)

            return merge

        def merge(partials: List[ColumnarBatch]) -> ColumnarBatch:
            metrics.incr("router.merge.concat")
            return ColumnarBatch.concat(partials)

        return merge

    def rewrite_partial(self, df):
        """Rewrite a top-level Aggregate DataFrame to its per-host partial
        form. ``submit``/``_resolve_leg`` apply this at dispatch —
        builders return the final query and never see partial specs."""
        plan = df.plan
        if not isinstance(plan, Aggregate):
            return df
        partial = Aggregate(
            tuple(plan.group_by), tuple(_partial_specs(list(plan.aggs))), plan.child
        )
        return type(df)(df.session, partial)

    # -- fleet result cache ---------------------------------------------------
    def _result_cache_key(self, sub_plans) -> Tuple[tuple, Tuple[str, ...]]:
        """The fleet-level memo key: every host's value-level plan
        signature (literals + leaf file snapshots) plus every host's
        FULL multi-host version token (index generation + conf + join
        region versions) — any side's refresh/optimize/delete moves some
        host's token and the old entry can only stale_miss. The
        optimizer pass this runs is the same memoized plan-cache walk
        the per-host submit would do anyway."""
        from ..compile.result_cache import result_roots
        from ..serve.plan_cache import plan_signature

        sigs, toks, roots = [], [], []
        for host, df in sub_plans:
            server = self.hosts[host]
            sig = plan_signature(df.plan)
            plan, token = server.plan_cache.optimized_plan_with_token(
                df, signature=sig
            )
            sigs.append(sig)
            toks.append(token)
            roots.extend(result_roots(plan))
        return (tuple(sigs), tuple(toks)), tuple(dict.fromkeys(roots))

    def _store_cached(self, rt: RouterTicket, result) -> None:
        """Telemetry-driven admission of one merged result into the
        fleet cache: repeat rate from the router's own fingerprint
        window, recompute cost = the whole fan-out + merge wall (what a
        future hit actually saves the fleet)."""
        rc_key = getattr(rt, "_rc_key", None)
        if rc_key is None:
            return
        from ..compile.result_cache import (
            budget_share_bytes,
            router_result_cache,
        )

        conf = next(iter(self.hosts.values())).session.conf
        repeats = self._rc_window.observe(
            rt._rc_fp, conf.compile_result_cache_window()
        )
        router_result_cache.put(
            rc_key,
            result,
            rt._rc_roots,
            conf.compile_result_cache_entries(),
            conf.compile_result_cache_max_bytes(),
            cost_s=time.monotonic() - rt._t0,
            repeats=repeats,
            byte_rate=conf.compile_result_cache_byte_rate(),
            total_max_bytes=budget_share_bytes(
                conf.compile_result_cache_budget_share(), conf.residency().budget_bytes
            ),
        )

    # -- warm-compile hints ---------------------------------------------------
    def offer_warm_hints(self, host: Optional[str] = None) -> Dict[str, int]:
        """Offer every remembered structural fingerprint to ``host`` (or
        all hosts): the target rebuilds its partition's plan for the
        shape and pre-lowers the pipeline through its own compiled-
        pipeline cache, OFF the query hot path — the next real query of
        that shape starts from a warm executable. Adoption is honest:
        ``adopted`` only when a lowering actually ran (an already-warm,
        latched, or closed host declines)."""
        with self._lock:
            hints = list(self._warm_hints.items())
        names = list(self.hosts)
        targets = [host] if host is not None else names
        out = {"offered": 0, "adopted": 0, "declined": 0}
        for name in targets:
            server = self.hosts.get(name)
            if server is None:
                continue
            part_index = names.index(name)
            for _fp, (build, _tenant) in hints:
                metrics.incr("compile.warm_hint.offered")
                out["offered"] += 1
                if self._adopt_warm_hint(server, build, part_index, len(names)):
                    metrics.incr("compile.warm_hint.adopted")
                    out["adopted"] += 1
                else:
                    metrics.incr("compile.warm_hint.declined")
                    out["declined"] += 1
        return out

    def _adopt_warm_hint(self, server, build, part_index, n_parts) -> bool:
        """One host's pre-lower of one hinted shape. True only when the
        pipeline cache actually lowered (compile.lowered fired inside
        the scoped registry) — a cache hit means the host was already
        warm and the hint declines."""
        try:
            if server.closed or server.degraded:
                return False
            from ..compile.cache import pipeline_cache
            from ..exec.executor import Executor

            session = server.session
            df = self.rewrite_partial(build(session, part_index, n_parts))
            plan, token = server.plan_cache.optimized_plan_with_token(df)
            executor = Executor(session.device, session.conf.residency(), session.conf,
                                mesh=session.mesh)
            with metrics.scoped() as m:
                pipeline_cache.get_or_lower(
                    plan, executor, version_token=token
                )
                return m.get("compile.lowered") > 0
        except Exception:  # noqa: BLE001 - a hint is advice, never an error
            metrics.incr("compile.warm_hint.adopt_error")
            return False

    def _ping_ok(self, host: str, server) -> bool:
        """The lightweight pre-probe: before spending a real query leg
        on a probation host, ask its cheap liveness endpoint. A failed
        ping sends the host straight back to dead without burning
        anyone's query (hosts without ping — bare duck-typed stand-ins —
        are probed by the leg itself)."""
        ping = getattr(server, "ping", None)
        if ping is None:
            return True
        try:
            ping()
            return True
        except ServerClosed:
            self._host_failed(host, "probe_ping_failed", probe=True)
            return False

    # -- degradation ----------------------------------------------------------
    def _host_failed(self, host: str, why: str, probe: bool = False) -> None:
        """An unambiguous host death observed (ServerClosed): record the
        loss evidence and feed the health state machine."""
        self._note_host_lost(host, why)
        self.health.mark_dead(host, why)

    def _note_host_lost(self, host: str, why: str) -> None:
        with self._lock:
            self._hosts_lost += 1
        survivors = self._survivors(host)
        metrics.incr("router.host_lost")
        flight_recorder.snapshot(
            f"router_host_lost: {host} ({why}) survivors={','.join(survivors) or 'none'}"
        )

    def _survivors(self, dead: str) -> List[str]:
        """Hosts eligible to absorb ``dead``'s partitions: open AND not
        health-dead (a probation host may serve — its leg doubles as the
        probe)."""
        return [
            h
            for h, s in self.hosts.items()
            if h != dead and not s.closed and self.health.usable(h)
        ]

    def revive_host(self, name: str, server: Optional[QueryServer] = None) -> None:
        """Swap a restarted server in for a dead host (or re-arm the
        existing entry, e.g. a chaos proxy that revives in place) and
        make its probation due immediately. The host serves again only
        after its probe leg succeeds — readmission is earned, not
        declared."""
        with self._lock:
            if server is not None:
                if name not in self.hosts:
                    raise HyperspaceException(f"Unknown router host {name!r}.")
                self.hosts[name] = server
        metrics.incr("router.health.revive_offered")
        self.health.note_revived(name)
        # warm the newcomer OFF the hot path: a restarted server is a
        # new session with a cold pipeline cache — offer it every
        # remembered shape so its probe (and the queries after) start
        # from warm executables
        threading.Thread(
            target=lambda: self.offer_warm_hints(name), daemon=True
        ).start()

    def _remaining_s(self, rt: RouterTicket) -> Optional[float]:
        """The deadline budget LEFT for re-issuing rt's legs: deadline -
        elapsed, never the original deadline (a retried leg overshooting
        the caller's deadline would be a bug). None without a
        deadline; raises once the budget is spent."""
        if rt._deadline_s is None:
            return None
        rem = rt._deadline_s - (time.monotonic() - rt._t0)
        if rem <= 0:
            metrics.incr("router.retry.budget_exhausted")
            raise DeadlineExceeded(
                f"retry budget exhausted (deadline {rt._deadline_s:.3f}s spent)."
            )
        return rem

    def _leg_wait_s(
        self, timeout: Optional[float], rt: RouterTicket
    ) -> Optional[float]:
        """The tighter of the caller's result() timeout and the remaining
        deadline budget (None = unbounded). Non-raising: an exhausted
        budget here surfaces as the server's own DeadlineExceeded."""
        rem = (
            None
            if rt._deadline_s is None
            else max(rt._deadline_s - (time.monotonic() - rt._t0), 0.001)
        )
        if timeout is None:
            return rem
        return timeout if rem is None else min(timeout, rem)

    def _sleep_budgeted(self, delay_s: float, rt: RouterTicket) -> None:
        """Sleep at most ``delay_s``, bounded by the remaining deadline
        budget and the retry policy's max delay — honoring a survivor's
        retry_after_s must never itself blow the caller's deadline."""
        cap = self._retry_policy.max_delay_s
        rem = (
            None
            if rt._deadline_s is None
            else rt._deadline_s - (time.monotonic() - rt._t0)
        )
        d = min(float(delay_s), cap if rem is None else min(rem, cap))
        if d > 0:
            time.sleep(d)

    def _resolve_leg(
        self,
        host: str,
        ticket,
        part_index: int,
        timeout: Optional[float],
        rt: RouterTicket,
        is_probe: bool = False,
    ) -> ColumnarBatch:
        """One host leg's partial — from its ticket (hedged once the
        host outlives its own tail quantile), or re-issued on a
        surviving host when the home host is gone (shared storage makes
        the partition readable from any host's session)."""
        if ticket is not None:
            out = self._await_primary(host, ticket, part_index, timeout, rt, is_probe)
            if out is not None:
                return out
        return self._failover_leg(host, part_index, timeout, rt)

    def _await_primary(
        self, host, ticket, part_index, timeout, rt, is_probe
    ) -> Optional[ColumnarBatch]:
        """Wait on the home host's leg; once its hedge delay lapses,
        race a duplicate leg on a survivor. Returns None when the leg is
        LOST (host closed) — the caller then fails over."""
        t0 = time.monotonic()
        hedge_delay = self.health.hedge_delay_s(host) if self._hedging else None
        budget = self._leg_wait_s(timeout, rt)
        first = hedge_delay if budget is None else (
            budget if hedge_delay is None else min(hedge_delay, budget)
        )
        try:
            out = ticket.result(first)
            self.health.note_success(host, time.monotonic() - t0, probe=is_probe)
            return out
        except TimeoutError:
            if hedge_delay is None or (budget is not None and budget <= hedge_delay):
                raise  # the caller's own wait bound lapsed — not a hedge window
        except ServerClosed:
            self._host_failed(host, "closed_in_flight", probe=is_probe)
            return None
        return self._race_hedge(host, ticket, part_index, timeout, rt, is_probe, t0)

    def _issue_hedge(self, host, part_index, rt):
        """The duplicate leg on the first usable survivor. Returns
        (alt_host, ticket) or (None, None) when nobody can take it —
        hedging is opportunistic; declining it costs only latency."""
        for alt in self._survivors(host):
            server = self.hosts[alt]
            try:
                remaining = self._remaining_s(rt)
                df = self.rewrite_partial(
                    rt._build(server.session, part_index, len(self.hosts))
                )
                with span("router.hedge", host=host, alt=alt, part=part_index):
                    hedge_ticket = server.submit(
                        df, deadline_s=remaining, tenant=rt._tenant
                    )
                with self._lock:
                    self._hedges_issued += 1
                metrics.incr("router.hedge.issued")
                metrics.incr("router.subqueries")
                return alt, hedge_ticket
            except ServerClosed:
                self._host_failed(alt, "closed_at_hedge")
            except AdmissionRejected:
                # survivor is loaded: a hedge is optional work, never
                # worth waiting for — decline and keep the primary
                metrics.incr("router.hedge.declined")
        return None, None

    def _race_hedge(
        self, host, primary, part_index, timeout, rt, is_probe, t0
    ) -> Optional[ColumnarBatch]:
        """First result between the slow primary and its hedge wins; the
        loser is cancelled. A primary that loses its hedge counts as a
        soft health failure (that's how a merely-slow host drifts to
        suspect). Returns None only when every racer died (→ failover)."""
        alt, hedge_ticket = self._issue_hedge(host, part_index, rt)
        budget = self._leg_wait_s(timeout, rt)
        deadline_at = None if budget is None else t0 + budget
        # [host, ticket, is_probe, is_primary]
        entries = [[host, primary, is_probe, True]]
        if hedge_ticket is not None:
            entries.append([alt, hedge_ticket, False, False])
        while entries:
            for ent in list(entries):
                h, t, probe, is_primary = ent
                try:
                    out = t.result(_RACE_POLL_S)
                except TimeoutError:
                    if (
                        deadline_at is not None
                        and time.monotonic() > deadline_at
                    ):
                        raise TimeoutError("query still in flight")
                    continue
                except ServerClosed:
                    self._host_failed(h, "closed_in_flight", probe=probe)
                    entries.remove(ent)
                    continue
                except BaseException:
                    # a genuine QUERY failure: the same plan would fail
                    # anywhere — cancel the other racer and propagate
                    for other in entries:
                        if other is not ent:
                            other[1].cancel()
                    raise
                for other in entries:
                    if other is not ent:
                        other[1].cancel()
                        metrics.incr("router.hedge.cancelled")
                if not is_primary:
                    with self._lock:
                        self._hedges_won += 1
                    metrics.incr("router.hedge.won")
                    # the primary lost its own hedge: a soft strike —
                    # consistently slow hosts drift to suspect/dead
                    self.health.note_failure(host, "lost_hedge", probe=is_probe)
                self.health.note_success(h, time.monotonic() - t0, probe=probe)
                return out
        return None  # every racer died mid-flight

    def _failover_leg(
        self, host, part_index, timeout, rt
    ) -> ColumnarBatch:
        """Re-issue a lost leg on survivors under the RETRY BUDGET:
        deterministic-jitter backoff between sweeps (seeded by host and
        partition, so a chaos replay sleeps identically), each
        re-submission carrying only the remaining deadline, and a
        survivor's AdmissionRejected honored for its retry_after_s
        instead of stampeding the next host."""
        policy = self._retry_policy
        attempts = max(policy.max_attempts, 1)
        last_err: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            for alt in self._survivors(host):
                server = self.hosts[alt]
                try:
                    remaining = self._remaining_s(rt)
                    df = self.rewrite_partial(
                        rt._build(server.session, part_index, len(self.hosts))
                    )
                    t0 = time.monotonic()
                    with span(
                        "router.failover", host=host, alt=alt, part=part_index
                    ):
                        alt_ticket = server.submit(
                            df, deadline_s=remaining, tenant=rt._tenant
                        )
                        metrics.incr("router.retried")
                        metrics.incr("router.subqueries")
                        out = alt_ticket.result(self._leg_wait_s(timeout, rt))
                    self.health.note_success(alt, time.monotonic() - t0)
                    return out
                except ServerClosed as e:
                    self._host_failed(alt, "closed_in_flight")
                    last_err = e
                except AdmissionRejected as e:
                    # the survivor said WHEN it has room — wait that out
                    # (budget-bounded) rather than hammering the next
                    # host with the same burst
                    last_err = e
                    metrics.incr("router.retry.admission_wait")
                    self._sleep_budgeted(e.retry_after_s, rt)
            if attempt >= attempts:
                break
            metrics.incr("router.retry.backoff")
            self._sleep_budgeted(
                policy.delay_for(attempt, seed_key=f"{host}:{part_index}"), rt
            )
        metrics.incr("router.retry.exhausted")
        raise last_err or ServerClosed(
            f"no surviving host to serve partition {part_index}."
        )

    def _retire(self, rt: RouterTicket) -> None:
        with self._lock:
            key = self._tickets.pop(id(rt), None)
            if key is not None and self._inflight.get(key) is rt:
                del self._inflight[key]

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "QueryRouter":
        for s in self.hosts.values():
            if not s.closed:
                s.start()
        return self

    def close(self, timeout_s: float = 10.0) -> None:
        for s in self.hosts.values():
            s.close(timeout_s)

    def stats(self) -> dict:
        from ..compile.result_cache import router_result_cache

        with self._lock:
            return {
                "hosts": {h: (not s.closed) for h, s in self.hosts.items()},
                "submitted": self._submitted,
                "coalesced": self._coalesced,
                "hosts_lost": self._hosts_lost,
                "hedges_issued": self._hedges_issued,
                "hedges_won": self._hedges_won,
                "inflight": len(self._inflight),
                "health": self.health.stats(),
                "result_cache": router_result_cache.snapshot(),
                "warm_hints": len(self._warm_hints),
            }
