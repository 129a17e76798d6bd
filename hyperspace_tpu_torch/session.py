"""HyperspaceSession: the framework's session object (the SparkSession
analog) — holds config, the source providers and the index-collection
manager. ``session.read`` builds DataFrames; the Hyperspace facade
(hyperspace.py) manages indexes against this session.

The session's device comes from conf ``hyperspace.torch.device``
(default ``cuda``); constructing a session with cuda requested on a
machine without it raises, as every engine entry point does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .config import HyperspaceConf
from .ops import resolve_device
from .sources.manager import FileBasedSourceProviderManager


class HyperspaceSession:
    def __init__(self, conf: Optional[HyperspaceConf] = None):
        self.conf = conf or HyperspaceConf()
        self.device = resolve_device(self.conf.torch_device())
        self.sources = FileBasedSourceProviderManager(self.conf)
        self._hyperspace_enabled = False
        self._collection_manager = None  # lazy (circular import)

    # -- rewrite toggle (package.scala:47-79) --------------------------------
    def enable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    # -- managers ------------------------------------------------------------
    @property
    def collection_manager(self):
        if self._collection_manager is None:
            from .index.collection_manager import IndexCollectionManager

            self._collection_manager = IndexCollectionManager(self)
        return self._collection_manager

    # -- IO ------------------------------------------------------------------
    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)


class DataFrameReader:
    def __init__(self, session: HyperspaceSession):
        self._session = session
        self._options: Dict[str, str] = {}
        self._schema: Optional[Dict[str, str]] = None

    def option(self, key: str, value: str) -> "DataFrameReader":
        self._options[key] = value
        return self

    def schema(self, schema: Dict[str, str]) -> "DataFrameReader":
        self._schema = schema
        return self

    def _load(self, file_format: str, paths: List[str]):
        from .dataframe import DataFrame
        from .plan.ir import Scan

        rel = self._session.sources.create_relation(
            list(paths), file_format, self._options, self._schema
        )
        return DataFrame(self._session, Scan(rel))

    def parquet(self, *paths: str):
        return self._load("parquet", list(paths))

    def avro(self, *paths: str):
        return self._load("avro", list(paths))
