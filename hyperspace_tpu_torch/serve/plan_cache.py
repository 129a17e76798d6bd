"""Cross-query plan cache: repeat queries skip rewrite and ranking.

Counterpart of ``hyperspace_tpu.serve.plan_cache``. The rewrite is a pure
function of

* the user plan, with every literal, projection and each leaf relation's
  file snapshot (name, size, mtime) in its signature, so a source that
  gained or lost files never collides with a cached entry;
* the session's rewrite state: Hyperspace on or off, and the whole conf;
* the index collection's LOG VERSION: (name, log id, state) of every
  ACTIVE index, so a create, refresh, optimize or delete misses;
* the join regions' generation (batch classification reads it).

The cache stores the OPTIMIZED plan (plan nodes are frozen dataclasses),
LRU-bounded.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Tuple

from ..plan.ir import LogicalPlan, Scan
from ..telemetry import trace
from ..telemetry.metrics import metrics


def plan_signature(plan: LogicalPlan) -> Tuple:
    """Value-based signature of a user plan: the tree string (operators,
    expressions, literals, projections) plus every leaf relation's file
    identity snapshot — tree_string alone shows only file COUNTS, which
    two different snapshots can share."""
    leaves = []
    for node in plan.collect(lambda n: isinstance(n, Scan)):
        rel = node.relation
        leaves.append(
            (
                rel.file_format,
                tuple(rel.root_paths),
                tuple(sorted(rel.options.items())),
                tuple(
                    (f.name, f.size, f.modified_time) for f in rel.files
                ),
            )
        )
    return (plan.tree_string(), tuple(leaves))


class PlanCache:
    """Bounded LRU over (plan signature, session rewrite state, index log
    version) -> optimized plan."""

    def __init__(self, max_entries: int = 256):
        self._max = max(int(max_entries), 1)
        self._lock = threading.Lock()
        self._plans: "OrderedDict[tuple, LogicalPlan]" = OrderedDict()

    def _version_token(self, session) -> Tuple:
        from ..actions import states
        from ..exec.hbm_cache import hbm_cache
        from ..exec.mesh_cache import mesh_cache

        entries = session.collection_manager.get_indexes([states.ACTIVE], prefer_stable=True)
        return (
            session.is_hyperspace_enabled(),
            tuple(sorted((e.name, e.id, e.state) for e in entries)),
            tuple(sorted((k, str(v)) for k, v in session.conf.as_dict().items())),
            # a cached plan must not outlive the join-region generation its
            # batch classification saw
            (hbm_cache.join_region_version(), mesh_cache.join_region_version()),
        )

    def optimized_plan(self, df) -> LogicalPlan:
        """The optimized plan for ``df`` — cached when this exact plan was
        optimized under the same index-log version and session state.
        Cache hits skip rewrite AND usage-event telemetry (the event
        already fired when the plan was first optimized; serving metrics
        count executions)."""
        return self.optimized_plan_with_token(df)[0]

    def optimized_plan_with_token(
        self, df, signature: "Tuple" = None
    ) -> "Tuple[LogicalPlan, Tuple]":
        """``(optimized plan, version token)`` — the token is the exact
        index-log/session snapshot the plan was resolved under; the
        server pins it on the ticket so a query admitted under version V
        serves V wholesale across any concurrent refresh/optimize
        (token[1] is the sorted (name, id, state) tuple of ACTIVE
        indexes — the human-readable log version).

        Token and optimization are NOT naturally atomic: a refresh
        committing between the token read and the rewrite would bake the
        NEW generation's files into a plan pinned (and cached) under the
        OLD token — the pin would lie and the cache would serve the
        wrong generation to same-token callers. So the token is re-read
        after optimizing and the pair is only trusted (and cached) when
        both reads agree; a mismatch re-resolves under the new version.

        ``signature``: a caller-precomputed ``plan_signature(df.plan)``
        (the server's result-cache path already built one — the tree
        walk must not run twice per submission)."""
        if signature is None:
            signature = plan_signature(df.plan)
        token = self._version_token(df.session)
        for _attempt in range(4):
            key = (signature, token)
            with self._lock:
                hit = self._plans.get(key)
                if hit is not None:
                    self._plans.move_to_end(key)
            if hit is not None:
                metrics.incr("serve.plan_cache.hit")
                trace.annotate(plan_cache="hit")
                return hit, token
            metrics.incr("serve.plan_cache.miss")
            trace.annotate(plan_cache="miss")
            plan = df.optimized_plan(log_usage=True)
            token_after = self._version_token(df.session)
            if token_after == token:
                with self._lock:
                    self._plans[key] = plan
                    while len(self._plans) > self._max:
                        self._plans.popitem(last=False)
                return plan, token
            metrics.incr("serve.plan_cache.version_race")
            token = token_after
        # index log churning faster than we can replan (pathological):
        # REFUSE rather than pin a generation the double-read never
        # confirmed — a lying pin would serve torn snapshots silently.
        # The error rides the ticket as a plan failure; the client
        # retries into a (momentarily) quieter log.
        from ..exceptions import HyperspaceException

        raise HyperspaceException(
            "index log version changed on every replan attempt; could "
            "not resolve a stable snapshot to pin."
        )

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._plans), "max_entries": self._max}

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
