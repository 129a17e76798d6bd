"""The Hyperspace facade: index management verbs bound to a session.

Parity: com/microsoft/hyperspace/Hyperspace.scala — the create, list and
describe verbs, and the reference package's ``prefetch_index``; the other
lifecycle verbs are not yet ported.
"""

from __future__ import annotations

from typing import List, Optional

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

    def create_index(self, df: DataFrame, config: IndexConfig) -> None:
        self._manager.create(df, config)

    def index(self, name: str) -> IndexStatistics:
        return self._manager.index(name)

    def explain(self, df: DataFrame) -> str:
        return df.explain()

    def prefetch_index(self, name: str, columns: Optional[List[str]] = None) -> bool:
        """Upload an index's predicate columns to the session's device NOW
        (the once-per-version cost first-touch population pays lazily), so
        the next query already runs the resident scan. ``columns``
        defaults to the indexed (key) columns; include covered columns you
        filter on. True when the table is resident afterwards; False when
        the index is not an ACTIVE covering index, nothing was encodable,
        or the planes exceed the budget (conf
        ``hyperspace.torch.hbm.budgetMB``)."""
        return self._manager.prefetch(name, columns)

    # camelCase alias for reference-API parity
    createIndex = create_index
