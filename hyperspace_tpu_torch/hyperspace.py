"""The Hyperspace facade: index management verbs bound to a session.

Parity: com/microsoft/hyperspace/Hyperspace.scala:34-165 — the lifecycle
verbs (create, delete, restore, vacuum, refresh, optimize, cancel), list,
describe and explain, and the reference package's ``prefetch_index`` and
``compact_index`` (the background compactor's verb) and ``doctor`` (fsck
of the index tree, reliability/doctor.py), and ``serve``, the session's
query server.
"""

from __future__ import annotations

from typing import List, Optional

from . import constants as C
from .dataframe import DataFrame
from .index.index_config import IndexConfig
from .index.stats import IndexStatistics
from .session import HyperspaceSession


class Hyperspace:
    def __init__(self, session: HyperspaceSession):
        self.session = session
        self._manager = session.collection_manager

    def indexes(self) -> List[IndexStatistics]:
        return self._manager.indexes()

    def indexes_df(self):
        """The summary as a pandas DataFrame — the reference's
        ``hyperspace.indexes`` IS a Spark DataFrame with these summary
        columns (IndexStatistics.scala:64-71). Needs ``pandas``, imported
        here only."""
        import pandas as pd

        rows = [s.to_row() for s in self.indexes()]
        return pd.DataFrame(
            rows,
            columns=[
                "name", "indexedColumns", "includedColumns", "numBuckets",
                "schema", "indexLocation", "state",
            ],
        )

    def create_index(self, df: DataFrame, config: IndexConfig) -> None:
        self._manager.create(df, config)

    def index(self, name: str) -> IndexStatistics:
        return self._manager.index(name)

    def delete_index(self, name: str) -> None:
        self._manager.delete(name)

    def restore_index(self, name: str) -> None:
        self._manager.restore(name)

    def vacuum_index(self, name: str) -> None:
        self._manager.vacuum(name)

    def refresh_index(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        self._manager.refresh(name, mode)

    def optimize_index(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        self._manager.optimize(name, mode)

    def compact_index(self, name: str, max_steps: Optional[int] = None) -> dict:
        """Step ``name`` toward the per-bucket layout now, one committed
        increment at a time (index/compactor.py): each step compacts
        ``hyperspace.index.compaction.bucketsPerStep`` run-held buckets
        into per-bucket files; convergence gives exactly
        ``optimize(quick)``'s layout. Returns {"steps": committed count,
        "converged": bool}. Unlike ``optimize_index``, a reader of the
        previous version keeps its files between steps."""
        from .index.compactor import IndexCompactor

        return IndexCompactor(self.session).compact_index(name, max_steps=max_steps)

    def cancel(self, name: str) -> None:
        self._manager.cancel(name)

    def doctor(self, repair: bool = False):
        """fsck the index system path (reliability.doctor): log-chain
        integrity, data-file presence against the log, crash litter.
        ``repair=True`` rolls back abandoned writers and vacuums orphaned
        artifacts. Returns a DoctorReport whose ``ok`` is the
        no-inconsistencies verdict."""
        return self.session.doctor(repair=repair)

    def serve(self, **options):
        """The session's query server (``serve.QueryServer``, through
        ``session.serve``): per-tenant admission with weighted-fair
        scheduling, per-query deadlines, micro-batched resident scans and
        plan caching over this session's indexes. ``options`` are
        ServeConfig fields and apply only when the server is created; a
        closed server is replaced on the next call."""
        return self.session.serve(**options)

    def explain(self, df: DataFrame, verbose: bool = False) -> str:
        from .plananalysis.plan_analyzer import explain_string

        return explain_string(df, verbose=verbose)

    def prefetch_index(self, name: str, columns: Optional[List[str]] = None) -> bool:
        """Upload an index's predicate columns to the session's device (on
        a mesh session: as mesh shards, one a device of the mesh) NOW
        (the once-per-version cost first-touch population pays lazily), so
        the next query already runs the resident scan. ``columns``
        defaults to the indexed (key) columns; include covered columns you
        filter on. True when the table is resident afterwards; False when
        the index is not an ACTIVE covering index, nothing was encodable,
        or the planes exceed the budget (conf
        ``hyperspace.torch.hbm.budgetMB``)."""
        return self._manager.prefetch(name, columns)

    # camelCase aliases for reference-API parity
    prefetchIndex = prefetch_index
    createIndex = create_index
    deleteIndex = delete_index
    restoreIndex = restore_index
    vacuumIndex = vacuum_index
    refreshIndex = refresh_index
    optimizeIndex = optimize_index
    compactIndex = compact_index
