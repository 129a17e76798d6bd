"""IndexCollectionManager: dispatches the management verbs to their
actions with per-index log/data managers, and enumerates indexes.

Parity: com/microsoft/hyperspace/index/IndexCollectionManager.scala —
create (covering and data-skipping) and the read-only verbs, plus
``prefetch`` (HBM residency, a verb the reference package added). The
other lifecycle actions (delete, restore, vacuum, refresh, optimize,
cancel) are not yet ported: refresh and optimize raise, after the checks
the reference makes first for a data-skipping index.
"""

from __future__ import annotations

from typing import List, Optional

from .. import constants as C
from ..actions import states
from ..actions.create import CreateAction
from ..exceptions import HyperspaceException
from ..index.log_entry import IndexLogEntry
from .data_manager import IndexDataManagerImpl
from .log_manager import IndexLogManagerImpl
from .path_resolver import PathResolver
from .stats import IndexStatistics


class IndexCollectionManager:
    def __init__(self, session):
        self.session = session
        self.conf = session.conf
        self.path_resolver = PathResolver(self.conf)

    def _log_manager(self, name: str) -> IndexLogManagerImpl:
        return IndexLogManagerImpl(self.path_resolver.get_index_path(name))

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

    def _is_skipping(self, name: str) -> bool:
        latest = self._existing_log_manager(name).get_latest_stable_log()
        return (
            latest is not None
            and latest.derived_dataset.kind == "DataSkippingIndex"
        )

    def refresh(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        mode = mode.lower()
        if self._is_skipping(name):
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
                self.session, incremental=mode == C.REFRESH_MODE_INCREMENTAL
            )
        raise HyperspaceException(
            "Refreshing a covering index is not yet ported to hyperspace_tpu_torch."
        )

    def optimize(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        if self._is_skipping(name):
            raise HyperspaceException(
                "Optimize is not supported for data-skipping indexes (the "
                "sketch table is a single metadata file, nothing to compact)."
            )
        raise HyperspaceException(
            "Optimizing an index is not yet ported to hyperspace_tpu_torch."
        )

    def _enumerate(self):
        """(latest entry, stable entry or None) per index directory."""
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
        (exec.hbm_cache) under the session's residency policy: only an
        ACTIVE covering index qualifies — a DELETED index's files still
        exist on disk but no query is rewritten to them. ``columns``
        defaults to the indexed columns; their case resolves against the
        index schema, as DataFrame filters do."""
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
        return (
            hbm_cache.prefetch(
                entry.content.files(), cols, self.session.device,
                self.conf.residency(),
            )
            is not None
        )
