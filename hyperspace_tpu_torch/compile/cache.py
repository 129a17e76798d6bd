"""The compiled-pipeline cache: (fingerprint, version token, conf) ->
CompiledPipeline.

Counterpart of ``hyperspace_tpu.compile.cache``. The serve plan cache
memoizes plan optimization; this cache memoizes the lowering and routing
above execution. Invalidation rides the same tokens:

* the FINGERPRINT carries every index leaf's (name, log id) and every
  source leaf's file snapshot, so a refresh, optimize, create or delete
  that touches a leaf re-keys on its own;
* the VERSION TOKEN (the server passes the ticket's pinned index-log
  snapshot) keeps two pinned generations of one structure apart during a
  concurrent refresh;
* ``invalidate(index_root)`` drops the entries scoped to a rewritten
  index's directory (a join pipeline carries both sides' roots); the
  collection manager calls it from refresh, optimize and delete.

Every mutation of ``_pipelines`` happens under ``_lock``; a miss lowers
outside the lock and re-checks under it before registering (entries hold
routing, no device memory, so a racing registration is harmless).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

from ..telemetry.metrics import metrics
from ..telemetry.trace import annotate, span
from .pipeline import CompiledPipeline

# per-conf memo of the serialized conf token, keyed on the conf's mutation
# generation: the token is needed on every execute, hits included
_conf_token_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_conf_token_lock = threading.Lock()


def _conf_token(conf) -> tuple:
    gen = conf.generation
    with _conf_token_lock:
        hit = _conf_token_memo.get(conf)
        if hit is not None and hit[0] == gen:
            return hit[1]
    token = tuple(sorted((k, str(v)) for k, v in conf.as_dict().items()))
    with _conf_token_lock:
        _conf_token_memo[conf] = (gen, token)
    return token


class PipelineCache:
    """Bounded LRU of compiled pipelines (module note)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pipelines: "OrderedDict[tuple, CompiledPipeline]" = OrderedDict()

    def get_or_lower(self, plan, executor,
                     version_token: Optional[tuple] = None) -> Optional[CompiledPipeline]:
        """The pipeline for ``plan`` under ``executor``'s conf, cached by
        structural fingerprint, lowered on a miss. None when the
        fingerprint cannot be computed (the caller interprets)."""
        from .fingerprint import plan_fingerprint
        from .lowering import lower

        conf = executor.conf
        try:
            fp = plan_fingerprint(plan)
        except Exception:  # noqa: BLE001 - a fingerprint error interprets
            metrics.incr("compile.fingerprint_error")
            return None
        key = (fp, version_token, _conf_token(conf))
        with self._lock:
            hit = self._pipelines.get(key)
            if hit is not None:
                self._pipelines.move_to_end(key)
        if hit is not None:
            metrics.incr("compile.cache.hit")
            annotate(compile_cache="hit")
            return hit
        metrics.incr("compile.cache.miss")
        annotate(compile_cache="miss")
        with span("compile.lower"):
            pipeline = lower(plan, executor, fingerprint=fp)
        max_entries = max(int(conf.compile_cache_entries()), 1)
        with self._lock:
            racer = self._pipelines.get(key)
            if racer is not None:
                return racer  # a concurrent miss lowered first: share it
            pipeline.cache = self
            pipeline.cache_key = key
            self._pipelines[key] = pipeline
            while len(self._pipelines) > max_entries:
                self._pipelines.popitem(last=False)
                metrics.incr("compile.cache.evicted")
        return pipeline

    def forget(self, pipeline: CompiledPipeline) -> None:
        """Evict exactly ``pipeline``'s entry (device loss mid-dispatch):
        the rest of the cache keeps serving."""
        key = pipeline.cache_key
        if key is None:
            return
        with self._lock:
            if self._pipelines.get(key) is pipeline:
                del self._pipelines[key]

    def invalidate(self, index_root: Optional[str] = None) -> int:
        """Drop the pipelines whose index leaves live under ``index_root``
        (None: all). Returns how many went."""
        prefix = None if index_root is None else str(index_root).rstrip("/") + "/"
        with self._lock:
            if prefix is None:
                n = len(self._pipelines)
                self._pipelines.clear()
            else:
                doomed = [k for k, p in self._pipelines.items() if p.matches_root(prefix)]
                for k in doomed:
                    del self._pipelines[k]
                n = len(doomed)
        if n:
            metrics.incr("compile.cache.invalidated", n)
        return n

    def reset(self) -> None:
        with self._lock:
            self._pipelines.clear()

    def snapshot(self) -> dict:
        with self._lock:
            entries = list(self._pipelines.values())
        kinds: dict = {}
        for p in entries:
            kinds[p.kind] = kinds.get(p.kind, 0) + 1
        return {"entries": len(entries), "kinds": kinds}


pipeline_cache = PipelineCache()
