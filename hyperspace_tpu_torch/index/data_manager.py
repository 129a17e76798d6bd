"""Versioned index-data directories: ``<index>/v__=<id>/``.

Parity: com/microsoft/hyperspace/index/IndexDataManager.scala:26-74. Every
refresh/optimize writes a fresh immutable version directory; the log
entry's Content may span several versions (incremental refresh merges
trees).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional

from .. import constants as C
from ..utils import file_utils

_VERSION_RE = re.compile(re.escape(C.INDEX_VERSION_DIRECTORY_PREFIX) + r"=(\d+)$")


class IndexDataManager:
    def get_latest_version_id(self) -> Optional[int]:
        raise NotImplementedError

    def get_path(self, id: int) -> Path:
        raise NotImplementedError

    def delete(self, id: int) -> None:
        raise NotImplementedError


class IndexDataManagerImpl(IndexDataManager):
    def __init__(self, index_path: str | Path):
        self._index_path = Path(index_path)

    def _version_dirs(self) -> List[Path]:
        if not self._index_path.is_dir():
            return []
        return [
            p
            for p in self._index_path.iterdir()
            if p.is_dir() and _VERSION_RE.search(p.name)
        ]

    def get_latest_version_id(self) -> Optional[int]:
        """Highest v__=k (IndexDataManager.scala:56-67)."""
        ids = [
            int(_VERSION_RE.search(p.name).group(1)) for p in self._version_dirs()
        ]
        return max(ids) if ids else None

    def get_all_version_ids(self) -> List[int]:
        return sorted(
            int(_VERSION_RE.search(p.name).group(1)) for p in self._version_dirs()
        )

    def get_path(self, id: int) -> Path:
        """Path of version dir ``id`` (IndexDataManager.scala:69-71)."""
        return self._index_path / f"{C.INDEX_VERSION_DIRECTORY_PREFIX}={id}"

    def delete(self, id: int) -> None:
        """Remove one version dir (IndexDataManager.scala:73)."""
        file_utils.delete(self.get_path(id))
