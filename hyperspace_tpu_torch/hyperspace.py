"""The Hyperspace facade: index management verbs bound to a session.

Parity: com/microsoft/hyperspace/Hyperspace.scala — the create, list and
describe verbs; the other lifecycle verbs are not yet ported.
"""

from __future__ import annotations

from typing import List

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

    # camelCase alias for reference-API parity
    createIndex = create_index
