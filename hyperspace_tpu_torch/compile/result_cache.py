"""RESULT cache riding the pipeline fingerprint machinery: finished
result tables keyed on (value-level plan signature, index-log version
token).

Counterpart of the serve-level half of ``hyperspace_tpu.compile.
result_cache``. Results depend on literal values, so the key is the serve
plan cache's ``plan_signature`` (tree string with literals, every leaf's
file snapshot) plus the full version token: a hit is sound by
construction (same literals, same source snapshot, same index
generation, same conf). ``invalidate_all(index_root)`` drops a rewritten
index's entries eagerly from both levels (the collection manager's hook).
Two instances: ``result_cache``, the serve-level one (``compile.
result_cache.*``), and ``router_result_cache``, the fleet-level one the
query router (``distributed/router.py``) keys on every host's plan
signature and version token (``router.result_cache.*``).

* Admission (``serve/cache_policy.py``): a result enters only when its
  observed recompute cost times its fingerprint's repeat rate beats its
  byte cost; a structure seen once declines.
* GDSF eviction: priority = clock + (1 + hits) x recompute cost / bytes,
  the clock set to each victim's priority, so stale expensive entries
  cannot squat and cheap bulky ones go first.

The caches' bytes charge against the residency budget: each registers
as a ``residency/tiers.py`` claimant, and the caches' eviction ladder
sheds them before deltas. Entries under an older token are never dropped on a token
change: a snapshot-pinned reader presenting its token still hits them
(a reader on the new token misses, counted ``stale_miss``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..telemetry.metrics import metrics


class ResultCache:
    """Cost-aware result memo: (plan signature, version token) ->
    finished batch, GDSF-evicted, byte-budgeted. ``prefix`` names the
    counter family (``compile.result_cache.*``, ``router.result_cache.*``)."""

    def __init__(self, prefix: str = "compile.result_cache"):
        self._prefix = prefix
        self._lock = threading.Lock()
        # key -> mutable entry dict {batch, roots, nbytes, hits, cost_s,
        # pri}; plain dict (insertion order only matters for tie-breaks)
        self._results: Dict[tuple, dict] = {}
        # signature -> set of full keys (stale_miss detection: same
        # signature alive under a DIFFERENT token)
        self._by_sig: Dict[object, set] = {}
        self._bytes = 0
        self._clock = 0.0

    # -- internals (call with lock held) -------------------------------------
    def _priority_locked(self, e: dict) -> float:
        return self._clock + (1 + e["hits"]) * e["cost_s"] / max(
            e["nbytes"], 1
        )

    def _drop_locked(self, key: tuple) -> dict:
        e = self._results.pop(key)
        self._bytes -= e["nbytes"]
        sigs = self._by_sig.get(key[0])
        if sigs is not None:
            sigs.discard(key)
            if not sigs:
                del self._by_sig[key[0]]
        return e

    def _evict_one_locked(self) -> bool:
        if not self._results:
            return False
        victim = min(self._results, key=lambda k: self._results[k]["pri"])
        self._clock = self._results[victim]["pri"]
        self._drop_locked(victim)
        return True

    # -- lookup ---------------------------------------------------------------
    def get(self, key: tuple) -> Optional[object]:
        stale = False
        with self._lock:
            e = self._results.get(key)
            if e is not None:
                e["hits"] += 1
                e["pri"] = self._priority_locked(e)
                batch = e["batch"]
            else:
                sigs = self._by_sig.get(key[0])
                stale = bool(sigs)
        if e is None:
            metrics.incr(self._prefix + ".miss")
            if stale:
                metrics.incr(self._prefix + ".stale_miss")
            return None
        metrics.incr(self._prefix + ".hit")
        return batch

    # -- admission ------------------------------------------------------------
    def put(
        self,
        key: tuple,
        batch,
        index_roots: Tuple[str, ...],
        max_entries: int,
        max_bytes: int,
        cost_s: float = 0.0,
        repeats: int = 0,
        byte_rate: int = 1,
        total_max_bytes: Optional[int] = None,
        nbytes: Optional[int] = None,
    ) -> str:
        """Admission decision for ``batch``: returns ``"admitted"``,
        ``"declined_cold"`` or ``"declined_bytes"``. ``cost_s`` is the
        observed recompute wall, ``repeats`` the fingerprint's sightings in
        the admission window (``serve/cache_policy.AdmissionWindow``),
        ``total_max_bytes`` the cache-wide budget share."""
        from ..serve.cache_policy import should_admit

        if nbytes is None:
            from ..exec.bytecache import batch_nbytes

            nbytes = batch_nbytes(batch)
        cap = total_max_bytes if total_max_bytes is not None else max_bytes
        verdict = should_admit(
            nbytes, cost_s, repeats, byte_rate, min(max_bytes, cap)
        )
        if verdict != "admit":
            metrics.incr(self._prefix + "." + verdict)
            return verdict
        with self._lock:
            old = self._results.get(key)
            if old is not None:
                self._drop_locked(key)
            e = {
                "batch": batch,
                "roots": tuple(index_roots),
                "nbytes": int(nbytes),
                "hits": 0 if old is None else old["hits"],
                "cost_s": max(float(cost_s), 0.0),
            }
            e["pri"] = self._priority_locked(e)
            self._results[key] = e
            self._by_sig.setdefault(key[0], set()).add(key)
            self._bytes += e["nbytes"]
            evicted = 0
            while len(self._results) > max(int(max_entries), 1) or (
                self._bytes > cap and len(self._results) > 1
            ):
                if not self._evict_one_locked():
                    break
                evicted += 1
        if evicted:
            metrics.incr(self._prefix + ".evicted", evicted)
        metrics.incr(self._prefix + ".admitted")
        return "admitted"

    # -- budget claimant protocol (residency.tiers) ---------------------------
    def held_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def shed(self, nbytes: int) -> int:
        """Free at least ``nbytes`` by GDSF eviction (the residency
        ladder's first rung: cached results drop BEFORE deltas). Returns
        bytes actually freed."""
        freed = 0
        evicted = 0
        with self._lock:
            while freed < nbytes and self._results:
                before = self._bytes
                if not self._evict_one_locked():
                    break
                freed += before - self._bytes
                evicted += 1
        if evicted:
            metrics.incr(self._prefix + ".evicted", evicted)
        return freed

    # -- invalidation ----------------------------------------------------------
    def invalidate(self, index_root: Optional[str] = None) -> int:
        prefix = None
        if index_root is not None:
            prefix = str(index_root).rstrip("/") + "/"
        with self._lock:
            if prefix is None:
                doomed = list(self._results)
            else:
                doomed = [
                    k
                    for k, e in self._results.items()
                    if any(p.startswith(prefix) for p in e["roots"])
                ]
            for k in doomed:
                self._drop_locked(k)
            n = len(doomed)
        if n:
            metrics.incr(self._prefix + ".invalidated", n)
        return n

    def reset(self) -> None:
        with self._lock:
            self._results.clear()
            self._by_sig.clear()
            self._bytes = 0
            self._clock = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._results),
                "bytes": self._bytes,
                "clock": round(self._clock, 9),
            }


result_cache = ResultCache()
router_result_cache = ResultCache(prefix="router.result_cache")


def invalidate_all(index_root: Optional[str] = None) -> int:
    """Scoped invalidation across both levels: a refresh, optimize or
    delete of an index drops its serve-level entries and every router-level
    entry whose fan-out read it (either side of a join)."""
    return result_cache.invalidate(index_root) + router_result_cache.invalidate(index_root)


def budget_share_bytes(share: float, budget_bytes: int) -> int:
    """The cache-wide byte cap: ``share`` (clamped by conf to [0, 0.5]) of
    the residency budget ``budget_bytes``."""
    return max(int(budget_bytes * float(share)), 1)


def result_key(plan, version_token: tuple, signature: Optional[tuple] = None) -> tuple:
    """The memo key: the serve plan cache's value-level signature plus the
    full version token. ``signature`` takes a caller's precomputed
    ``plan_signature(plan)`` (the server shares one tree walk)."""
    if signature is None:
        from ..serve.plan_cache import plan_signature

        signature = plan_signature(plan)
    return (signature, version_token)


def result_roots(optimized_plan) -> Tuple[str, ...]:
    """Scoped-invalidation anchors of the optimized plan: the pipeline
    cache's convention (``fingerprint.index_roots``)."""
    from .fingerprint import index_roots

    return index_roots(optimized_plan)


# the caches' bytes charge against the one residency budget and shed first
from ..residency import tiers as _tiers  # noqa: E402

_tiers.register_claimant("result_cache", result_cache)
_tiers.register_claimant("router_result_cache", router_result_cache)
