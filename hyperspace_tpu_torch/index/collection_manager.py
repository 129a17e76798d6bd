"""IndexCollectionManager: dispatches the management verbs to their
actions with per-index log/data managers, and enumerates indexes.

Parity: com/microsoft/hyperspace/index/IndexCollectionManager.scala:36-152
and CachingIndexCollectionManager.scala:38-106 (a TTL cache over the
index listing that every mutating verb clears), plus ``prefetch`` (HBM
residency, a verb the reference package added).

A full or incremental refresh and an optimize drop this index's resident
deltas and join regions (``_invalidate_resident_deltas``): the new
version's file identities change their keys, so they could never serve
again; they drop the compiled pipelines and memoized results scoped to
the index too (``_invalidate_compiled``), as a delete does. A quick
refresh changes no index file and keeps them all. The resident tables
are keyed by file identity, so a new version never reads an old one's
planes. On a mesh session (a mesh of more than one shard) ``prefetch``
fills the mesh cache (``exec/mesh_cache.py``), the tables the executor's
mesh arms consult.
"""

from __future__ import annotations

from typing import List, Optional

from .. import constants as C
from ..actions import states
from ..actions.create import CreateAction
from ..actions.metadata_actions import (
    CancelAction,
    DeleteAction,
    RestoreAction,
    VacuumAction,
)
from ..actions.optimize import OptimizeAction
from ..actions.refresh import (
    RefreshAction,
    RefreshIncrementalAction,
    RefreshQuickAction,
)
from ..exceptions import HyperspaceException
from ..index.log_entry import IndexLogEntry
from .cache import CreationTimeBasedCache
from .data_manager import IndexDataManagerImpl
from .log_manager import IndexLogManagerImpl
from .path_resolver import PathResolver
from .stats import IndexStatistics


def _invalidate_resident_deltas(index_root) -> None:
    """Drop the resident delta regions whose base lies under this index's
    directory, and the join regions that read it on either side, in both
    caches (one device's and the mesh's), after a verb that rewrote its
    data (the other indexes' stay)."""
    from ..exec.hbm_cache import hbm_cache
    from ..exec.mesh_cache import mesh_cache

    for cache in (hbm_cache, mesh_cache):
        cache.invalidate_deltas(str(index_root))
        cache.invalidate_joins(str(index_root))
    _invalidate_compiled(index_root)


def _invalidate_compiled(index_root) -> None:
    """Drop the compiled pipelines and memoized results scoped to this
    index's directory (a join pipeline carries both sides' roots, so
    either side's change drops it). Their keys would miss on their own;
    the eager drop keeps the bounded caches from pinning dead routing
    state."""
    from ..compile.cache import pipeline_cache
    from ..compile.result_cache import result_cache

    pipeline_cache.invalidate(str(index_root))
    result_cache.invalidate(str(index_root))


class IndexCollectionManager:
    def __init__(self, session):
        self.session = session
        self.conf = session.conf
        self.path_resolver = PathResolver(self.conf)
        # session-attach recovery: the first enumeration through this
        # manager rolls back abandoned writers (transient head + expired
        # lease), so a process that died mid-action heals on the next
        # session that looks at the indexes, listings and queries included
        self._attach_recovery_done = False

    def _attach_recovery(self) -> None:
        if self._attach_recovery_done:
            return
        self._attach_recovery_done = True
        from ..reliability.recovery import recover_abandoned_indexes

        recover_abandoned_indexes(self.path_resolver.system_path, self.conf)

    def _log_manager(self, name: str) -> IndexLogManagerImpl:
        return IndexLogManagerImpl(
            self.path_resolver.get_index_path(name),
            retry_policy=self.conf.retry_policy(),
        )

    def _data_manager(self, name: str) -> IndexDataManagerImpl:
        return IndexDataManagerImpl(self.path_resolver.get_index_path(name))

    def _existing_log_manager(self, name: str) -> IndexLogManagerImpl:
        mgr = self._log_manager(name)
        if mgr.get_latest_id() is None:
            raise HyperspaceException(f"Index with name {name} could not be found.")
        return mgr

    def create(self, df, config) -> None:
        from ..index.index_config import DataSkippingIndexConfig

        if isinstance(config, DataSkippingIndexConfig):
            from ..actions.create_skipping import DataSkippingCreateAction

            DataSkippingCreateAction(
                self.session,
                df,
                config,
                self._log_manager(config.index_name),
                self._data_manager(config.index_name),
            ).run()
            return
        CreateAction(
            self.session,
            df,
            config,
            self._log_manager(config.index_name),
            self._data_manager(config.index_name),
        ).run()

    def delete(self, name: str) -> None:
        DeleteAction(self._existing_log_manager(name), self.conf).run()
        # pipelines over a deleted index could serve only until their keys
        # missed: drop them, and their memoized results, now
        _invalidate_compiled(self.path_resolver.get_index_path(name))

    def restore(self, name: str) -> None:
        RestoreAction(self._existing_log_manager(name), self.conf).run()

    def vacuum(self, name: str) -> None:
        VacuumAction(
            self._existing_log_manager(name), self._data_manager(name), self.conf
        ).run()

    def refresh(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        mgr = self._existing_log_manager(name)
        data = self._data_manager(name)
        mode = mode.lower()
        latest = mgr.get_latest_stable_log()
        if latest is not None and latest.derived_dataset.kind == "DataSkippingIndex":
            from ..actions.create_skipping import DataSkippingRefreshAction

            if mode == C.REFRESH_MODE_QUICK:
                raise HyperspaceException(
                    "Quick refresh is not supported for data-skipping indexes "
                    "(no hybrid-scan path exists for sketch tables)."
                )
            if mode not in C.REFRESH_MODES:
                raise HyperspaceException(
                    f"Unsupported refresh mode {mode!r}; supported modes are "
                    f"{C.REFRESH_MODES}."
                )
            DataSkippingRefreshAction(
                self.session, mgr, data, incremental=mode == C.REFRESH_MODE_INCREMENTAL
            ).run()
            return
        if mode == C.REFRESH_MODE_FULL:
            RefreshAction(self.session, mgr, data).run()
            _invalidate_resident_deltas(self.path_resolver.get_index_path(name))
        elif mode == C.REFRESH_MODE_INCREMENTAL:
            RefreshIncrementalAction(self.session, mgr, data).run()
            _invalidate_resident_deltas(self.path_resolver.get_index_path(name))
        elif mode == C.REFRESH_MODE_QUICK:
            # no invalidation: a quick refresh records the source delta in
            # the log and changes no index file, so the resident delta's
            # (base key, appended snapshot) still matches and keeps serving
            RefreshQuickAction(self.session, mgr, data).run()
        else:
            raise HyperspaceException(
                f"Unsupported refresh mode {mode!r}; supported modes are "
                f"{C.REFRESH_MODES}."
            )

    def optimize(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        latest = self._existing_log_manager(name).get_latest_stable_log()
        if latest is not None and latest.derived_dataset.kind == "DataSkippingIndex":
            raise HyperspaceException(
                "Optimize is not supported for data-skipping indexes (the "
                "sketch table is a single metadata file, nothing to compact)."
            )
        OptimizeAction(
            self.session, self._existing_log_manager(name), self._data_manager(name), mode
        ).run()
        _invalidate_resident_deltas(self.path_resolver.get_index_path(name))

    def cancel(self, name: str) -> None:
        CancelAction(
            self._existing_log_manager(name),
            self.conf,
            data_manager=self._data_manager(name),
        ).run()

    def _enumerate(self):
        """(latest entry, stable entry or None) per index directory."""
        self._attach_recovery()
        out = []
        root = self.path_resolver.system_path
        if not root.is_dir():
            return out
        for d in sorted(root.iterdir()):
            if not d.is_dir():
                continue
            mgr = IndexLogManagerImpl(d)
            latest = mgr.get_latest_log()
            if latest is None:
                continue
            stable = (
                latest
                if latest.state in states.STABLE_STATES
                else mgr.get_latest_stable_log()
            )
            out.append((latest, stable))
        return out

    def get_indexes(
        self,
        states_filter: Optional[List[str]] = None,
        prefer_stable: bool = False,
    ) -> List[IndexLogEntry]:
        """``prefer_stable=True`` is the query view: an in-flight writer is
        invisible and readers get the previous stable snapshot."""
        out: List[IndexLogEntry] = []
        for latest, stable in self._enumerate():
            entry = stable if prefer_stable else latest
            if entry is None:
                continue
            if states_filter is None or entry.state in states_filter:
                out.append(entry)
        return out

    def indexes(self) -> List[IndexStatistics]:
        return [
            IndexStatistics.from_entry(e)
            for e in self.get_indexes()
            if e.state != states.DOESNOTEXIST
        ]

    def index(self, name: str) -> IndexStatistics:
        entry = self._existing_log_manager(name).get_latest_log()
        return IndexStatistics.from_entry(entry, extended=True)

    def prefetch(self, name: str, columns: Optional[List[str]] = None) -> bool:
        """Upload the index's predicate columns to the session's device
        (exec.hbm_cache), or as mesh shards on a mesh session
        (exec.mesh_cache: bucket b on shard b % D, the build's placement),
        under the session's residency policy: only an ACTIVE covering index
        qualifies — a DELETED index's files still exist on disk but no
        query is rewritten to them. ``columns`` defaults to the indexed
        columns; their case resolves against the index schema, as DataFrame
        filters do."""
        from ..exec.hbm_cache import hbm_cache
        from ..utils import resolver

        entry = self._existing_log_manager(name).get_latest_stable_log()
        if entry is None or entry.state != states.ACTIVE:
            return False
        if entry.derived_dataset.kind != "CoveringIndex":
            return False
        if columns is None:
            cols = list(entry.indexed_columns)
        else:
            schema_cols = list(entry.schema)
            cols = [resolver.resolve(c, schema_cols) or c for c in columns]
        mesh = self.session.mesh
        if mesh is not None and mesh.size > 1:
            # the executor's own gate: a mesh of one shard runs single-device
            from ..exec.mesh_cache import mesh_cache

            return mesh_cache.prefetch(entry.content.files(), cols, mesh,
                                       self.conf.residency()) is not None
        return (
            hbm_cache.prefetch(
                entry.content.files(), cols, self.session.device,
                self.conf.residency(),
            )
            is not None
        )


class CachingIndexCollectionManager(IndexCollectionManager):
    """TTL cache over the index listing; every mutating verb clears it
    before and after (CachingIndexCollectionManager.scala:38-106)."""

    def __init__(self, session):
        super().__init__(session)
        self._cache: CreationTimeBasedCache[list] = CreationTimeBasedCache(
            self.conf.cache_expiry_seconds
        )

    def clear_cache(self) -> None:
        self._cache.clear()

    def _enumerate(self):
        cached = self._cache.get()
        if cached is None:
            cached = super()._enumerate()
            self._cache.set(cached)
        return cached

    def create(self, df, config):
        self.clear_cache()
        super().create(df, config)
        self.clear_cache()

    def delete(self, name):
        self.clear_cache()
        super().delete(name)
        self.clear_cache()

    def restore(self, name):
        self.clear_cache()
        super().restore(name)
        self.clear_cache()

    def vacuum(self, name):
        self.clear_cache()
        super().vacuum(name)
        self.clear_cache()

    def refresh(self, name, mode=C.REFRESH_MODE_FULL):
        self.clear_cache()
        super().refresh(name, mode)
        self.clear_cache()

    def optimize(self, name, mode=C.OPTIMIZE_MODE_QUICK):
        self.clear_cache()
        super().optimize(name, mode)
        self.clear_cache()

    def cancel(self, name):
        self.clear_cache()
        super().cancel(name)
        self.clear_cache()
