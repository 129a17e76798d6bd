"""Provider manager: loads providers (config-pluggable) and routes each SPI
call, enforcing exactly-one-provider-answers.

Parity: com/microsoft/hyperspace/index/sources/
FileBasedSourceProviderManager.scala:39-200 — builders come from conf
(``hyperspace.index.sources.fileBasedBuilders``), cached via
CacheWithTransform so a conf change reloads them.
"""

from __future__ import annotations

import importlib
from typing import List, Optional

from ..config import HyperspaceConf
from ..exceptions import HyperspaceException
from ..utils.cache_with_transform import CacheWithTransform
from .default import DefaultFileBasedSource
from .interfaces import FileBasedSourceProvider


def _load_provider(spec: str) -> FileBasedSourceProvider:
    if ":" in spec:
        mod_name, _, attr = spec.partition(":")
    elif "." in spec:
        mod_name, _, attr = spec.rpartition(".")
    else:
        raise HyperspaceException(f"Invalid source provider spec: {spec!r}.")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)()


class FileBasedSourceProviderManager:
    def __init__(self, conf: HyperspaceConf):
        self._conf = conf
        self._providers: CacheWithTransform[Optional[str], List[FileBasedSourceProvider]] = CacheWithTransform(
            lambda: conf.file_based_source_builders(),
            self._build,
        )

    @staticmethod
    def _build(spec: Optional[str]) -> List[FileBasedSourceProvider]:
        from .versioned_lake import VersionedLakeSource

        providers: List[FileBasedSourceProvider] = []
        if spec:
            for s in spec.split(","):
                providers.append(_load_provider(s.strip()))
        providers.append(DefaultFileBasedSource())
        providers.append(VersionedLakeSource())
        return providers

    def providers(self) -> List[FileBasedSourceProvider]:
        return self._providers.load()

    def _run(self, call):
        """Exactly-one-Some routing
        (FileBasedSourceProviderManager.scala:153-182)."""
        results = [r for r in (call(p) for p in self.providers()) if r is not None]
        if len(results) != 1:
            raise HyperspaceException(
                f"Expected exactly one source provider to answer; got "
                f"{len(results)}."
            )
        return results[0]

    def create_relation(self, root_paths, file_format, options=None, schema=None):
        return self._run(
            lambda p: p.create_relation(root_paths, file_format, options, schema)
        )

    def refresh_relation(self, relation):
        return self._run(lambda p: p.refresh_relation(relation))

    def all_files(self, relation):
        return self._run(lambda p: p.all_files(relation))

    def lineage_pairs(self, relation, tracker):
        return self._run(lambda p: p.lineage_pairs(relation, tracker))
